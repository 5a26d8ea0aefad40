#!/usr/bin/env python3
"""Time the gradient accumulator's two kernels (``mtl_grad`` and
``prox_step``) of one checkout of the port on one NVIDIA card, at the
solver paths' shapes, beside the library call that computes the same
function.

    python3 grad_ab.py [--root DIR] [--tag NAME] [--sweep]
                       [--solve [--only TEXT] [--save FILE]
                                [--against FILE]]

``--root`` is the root of the checkout whose ``src_torch/`` is timed
(default: this script's own), so two versions compare in one machine:
unpack the other with ``git archive`` into a git-ignored directory and
run ``root A, root B, root B, root A``, one process each.  The helpers
(timers, inputs, the library yardsticks and the bounds) are this
checkout's ``chip_smoke.py``.  Each shape is first held to the plain
version (``chip_smoke.GRAD_RTOL`` / ``PROX_RTOL``), launched twice
(bitwise equal), then timed: device time (one CUDA graph of 10 calls,
median of 20 replays), per call (CUDA events around Python calls), and
the library's device time.  ``--sweep`` times instead the accumulator
at FULL2D logistic (and FULL's and path D's shapes) under forced plans
(split, tile rows, stages), each held bitwise to the default plan's
output where the split is the same.  ``--solve`` times instead whole
solves on the simulated cluster, as ``chip_smoke.py`` runs them: path
A's lazy ProxGD (FULLSP squared raw, 50 rounds, the lazy spectral
master, raw gradients through ``mtl_grad``), path B's DGSP (FULL
logistic, through ``mtl_grad``) and path D's stochastic ProxGD (FULL2D
squared raw, B=500, L=4, through ``prox_step``), the last two 10 rounds
each, ``SOLVE_REPS`` solves after a warm-up, each solve's seconds a
round and its launches; ``--save`` writes each W, ``--against`` prints
each W's largest difference from another run's saved W and whether the
two are bitwise equal; ``--only`` keeps the solves whose name holds the
text (e.g. ``"path A"``).  The last line is one JSON object.  Without a card it exits 1.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

# name, m (or L), n (or B), p, loss; the kernel's main shapes
GRAD_SHAPES = (("FULLSP squared", 768, 64, 2048, "squared"),
               ("FULL logistic", 32, 2000, 200, "logistic"),
               ("FULL2D logistic", 32, 20000, 200, "logistic"))
PROX_SHAPES = (("path D squared", 32, 500, 200, "squared"),
               ("path D logistic", 32, 500, 200, "logistic"),
               ("FULLSP-stochastic", 768, 32, 2048, "squared"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--solve", action="store_true")
    ap.add_argument("--only", default="")
    ap.add_argument("--save", default="")
    ap.add_argument("--against", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("grad_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src_torch"))
    from repro_torch.kernels.mtl_grad import kernel as gk
    from repro_torch.kernels.mtl_grad import ops as gops
    from repro_torch.kernels.mtl_grad.ref import task_gradients_ref
    from repro_torch.kernels.prox_step import ops as pops
    from repro_torch.kernels.prox_step.ref import prox_step_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    gk.build()
    print(f"[build] {root.name or root}: {time.perf_counter() - t0:.2f} s",
          flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    if args.sweep:
        return sweep(gk, gen, card, args.tag)
    if args.solve:
        return solve_times(root, card, args)
    D = cs.PROX_DESCENT
    rows = []
    for name, m, n, p, loss in GRAD_SHAPES:
        X, y, W = cs.grad_inputs(gen, m, n, p, loss, torch.float32)

        def kern():
            return gops.task_gradients(X, y, W, loss=loss)

        G, G2 = kern(), kern()
        ref = task_gradients_ref(X, y, W, loss=loss)
        err = float((G - ref).abs().max())
        scale = float(ref.abs().max())
        cs.check(torch.equal(G, G2) and err <= cs.GRAD_RTOL * scale,
                 f"mtl_grad {name}: err {err} of {scale}, or relaunch differs")
        g_ms = cs.graph_ms(kern, reps=20, inner=10)
        k_ms = cs.time_ms(kern, reps=20, inner=10)
        lib_ms = cs.graph_ms(lambda: cs.grad_library(X, y, W, loss),
                             reps=20, inner=10)
        b_ms, _ = cs.grad_bound_ms(m, n, p, 4)
        rows.append({"kernel": "mtl_grad", "shape": name, "graph_ms": g_ms,
                     "call_ms": k_ms, "library_graph_ms": lib_ms,
                     "bound_ms": b_ms, "err_over_scale": err / scale})
        del X, y, W, G, G2, ref
    for name, L, n, p, loss in PROX_SHAPES:
        X, y, W, Z, Q = cs.prox_inputs(gen, L, n, p, loss, torch.float32)

        def kern():
            return pops.prox_step(X, y, W, Z, Q, loss=loss, **D)

        out, out2 = kern(), kern()
        ref = prox_step_ref(X, y, W, Z, Q, loss=loss, **D)
        err, scale, _ = cs.prox_error(out, ref, W)
        cs.check(torch.equal(out, out2) and err <= cs.PROX_RTOL * scale,
                 f"prox_step {name}: err {err} of {scale}, or relaunch differs")
        g_ms = cs.graph_ms(kern, reps=20, inner=10)
        k_ms = cs.time_ms(kern, reps=20, inner=10)
        lib_ms = cs.graph_ms(lambda: cs.prox_library(X, y, W, Z, Q, loss=loss,
                                                     **D), reps=20, inner=10)
        b_ms, _ = cs.prox_bound_ms(L, n, p, 4)
        rows.append({"kernel": "prox_step", "shape": name, "graph_ms": g_ms,
                     "call_ms": k_ms, "library_graph_ms": lib_ms,
                     "bound_ms": b_ms, "err_over_scale": err / scale})
        del X, y, W, Z, Q, out, out2, ref
    torch.cuda.synchronize()
    for r in rows:
        print(f"[time] {args.tag} {r['kernel']:9s} {r['shape']:18s} device "
              f"{r['graph_ms'] * 1e3:9.2f} us  per call {r['call_ms'] * 1e3:9.2f}"
              f" us  library device {r['library_graph_ms'] * 1e3:9.2f} us  "
              f"bound {r['bound_ms'] * 1e3:8.3f} us", flush=True)
    print(json.dumps({"root": str(root), "tag": args.tag, "card": card,
                      "rows": rows}))
    return 0


# shape, m, n, p; (split, tile rows, stages) to force
SWEEP = (("FULL2D logistic", 32, 20000, 200,
          ((4, 32, 2), (4, 32, 3), (4, 64, 2), (8, 32, 2), (8, 32, 3))),
         ("FULL logistic", 32, 2000, 200, ((4, 32, 2), (4, 32, 3), (8, 32, 2))),
         ("path D", 32, 500, 200, ((4, 32, 2), (4, 32, 3), (8, 32, 2))))


def sweep(gk, gen, card, tag) -> int:
    rows = []
    for name, m, n, p, plans in SWEEP:
        X, y, W = cs.grad_inputs(gen, m, n, p, "logistic", torch.float32)
        default = gk.plan_for(X)
        ref = gk.launch(X, y, W, "logistic")
        for split, tile, stages in plans:
            pl = gk.Plan(split, tile, stages, m * split,
                         gk.smem_bytes(p, tile, stages, 4))
            G = gk.launch(X, y, W, "logistic", plan=pl)
            if split == default.split and tile == default.tile_rows:
                cs.check(torch.equal(G, ref), f"{name} {pl}: bytes moved")
            ms = cs.graph_ms(lambda: gk.launch(X, y, W, "logistic", plan=pl),
                             reps=20, inner=10)
            rows.append({"shape": name, "plan": pl._asdict(), "graph_ms": ms})
            print(f"[sweep] {tag} {name:15s} S={split} tile {tile:3d} stages "
                  f"{stages} ({pl.smem_bytes} B): device {ms * 1e3:8.2f} us, "
                  f"{m * n * p * 4 / (ms * 1e-3) / 1e12:.2f} TB/s of X"
                  f"{' (default plan)' if pl == default else ''}", flush=True)
        del X, y, W
    print(json.dumps({"tag": tag, "card": card, "sweep": rows}))
    return 0


SOLVE_ROUNDS = 10
SOLVE_REPS = 7


def solve_times(root, card, args) -> int:
    import statistics
    import repro_torch
    from repro_torch.core import prng
    from repro_torch.core.methods import MTLProblem
    from repro_torch.core.methods.convex import data_smoothness
    from repro_torch.data.synthetic import SimSpec, generate
    from repro_torch.kernels.mtl_grad import ops as gops
    from repro_torch.kernels.prox_step import ops as pops
    def path_a():
        sa = cs.FULLSP
        Xa, ya, _, _ = cs.sim_data(sa["p"], sa["m"], sa["r"], sa["n"],
                                   cs.SEED, "cuda", noise=sa["noise"])
        prob = MTLProblem.make(Xa, ya, "squared", gram=False, A=2.0,
                               r=sa["r"])
        return prob, sa["rounds"], dict(
            method="proxgd", lam=sa["lam"], eta=1.0 / data_smoothness(prob),
            init="zeros", sv_rank=sa["sv_rank"], sv_engine="lazy")

    def path_b():
        Xs, ys, _, _ = cs.sim_data(**cs.FULL, seed=cs.SEED, device="cuda",
                                   task="classification")
        return (MTLProblem.make(Xs, ys, "logistic", A=2.0, r=cs.FULL["r"]),
                SOLVE_ROUNDS, dict(method="dgsp"))

    def path_d():
        sp = cs.FULL2D
        Xd, yd, _, _ = generate(prng.PRNGKey(sp["key"]),
                                SimSpec(p=sp["p"], m=sp["m"], r=sp["r"],
                                        n=sp["n"], task="regression"),
                                sample_chunks=sp["chunks"])
        return (MTLProblem.make(Xd, yd, "squared", gram=False, A=2.0,
                                r=sp["r"]),
                SOLVE_ROUNDS, dict(method="proxgd", lam=0.01,
                                   batch_size=cs.D_BATCH, local_steps=4,
                                   batch_seed=0))

    cases = (("path A proxgd lazy/squared", gops.task_gradients, path_a),
             ("path B dgsp/logistic", gops.task_gradients, path_b),
             (f"path D proxgd/squared B={cs.D_BATCH} L=4", pops.prox_step,
              path_d))
    other = torch.load(args.against) if args.against else {}
    rows, saved = [], {}
    for name, kernel, make in cases:
        if args.only not in name:
            continue
        prob, rounds, kw = make()
        cs.timed_solve(repro_torch.solve, prob, rounds=1, **kw)
        per_round, launches, W = [], set(), None
        for _ in range(SOLVE_REPS):
            n0 = kernel.launches
            res, secs = cs.timed_solve(repro_torch.solve, prob,
                                       rounds=rounds, **kw)
            launches.add(kernel.launches - n0)
            cs.check(W is None or torch.equal(res.W, W),
                     f"{name}: a repeated solve gave other bytes")
            W = res.W
            per_round.append(secs / rounds)
        saved[name] = W.cpu()
        diff = bitwise = None
        if name in other:
            diff = float((saved[name] - other[name]).abs().max())
            bitwise = bool(torch.equal(saved[name], other[name]))
        rows.append({"solve": name, "rounds": rounds, "round_s": per_round,
                     "launches": sorted(launches), "max_abs_diff": diff,
                     "bitwise_equal": bitwise})
        print(f"[solve] {args.tag} {name}: a round "
              f"{statistics.median(per_round) * 1e3:.3f} ms "
              f"({min(per_round) * 1e3:.3f}-{max(per_round) * 1e3:.3f}, "
              f"{SOLVE_REPS} solves of {rounds} rounds), "
              f"{sorted(launches)} {kernel.__name__} launches a solve"
              + ("" if diff is None else
                 f", max|W - W_against| {diff:.3e} (bitwise {bitwise})"),
              flush=True)
    if args.save:
        torch.save(saved, args.save)
    print(json.dumps({"root": str(root), "tag": args.tag, "card": card,
                      "solves": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
