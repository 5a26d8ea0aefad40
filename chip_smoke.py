#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src_torch/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failed check
raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of every kernel of the serving path from the sources in
   this checkout (``nvcc`` into ``src_torch/repro_torch/_build/``);
3. each kernel against its plain PyTorch version on the card, on the
   same inputs, at the serving point and at edge shapes, then its time
   beside the plain version, one PyTorch expression for the same
   function, and the least time the card could take;
4. the serving path at full width (p=2048, m=4096, r=4, the acceptance
   point of the reference's serve benchmark): factorize a seeded rank-4
   W plus noise on the card, publish it to a store, load it, serve 1024
   mixed-task requests in waves of 256, predict, route by key, onboard
   an unseen task from 8 shots, serve from an int8 table, swap, and
   hot-reload a newer store step — with the launch counters set to 0
   just before and read just after;
5. the end-to-end latency of one 1024-request ``score`` call, as a
   client sees it, over 50 calls in steady state, and the device kernels
   ``torch.profiler`` records over 10 such calls.

It prints a ``{"kernels": [...]}`` line and, last, the contract line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 0
P, M, R = 2048, 4096, 4          # BENCH_serve.json acceptance point
WAVE = 256                       # MTLServer batch_size of the README
N_REQUESTS = 1024                # 4 waves
NOISE = 0.01                     # off-subspace noise in W
BATCHES = (64, 256, 4096)        # kernel timing points
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
# kernel vs plain: both sides multiply the same f32 values; only the
# order of the f32 sums differs (warp shuffles vs cuBLAS), which moves a
# p=2048 sum by ~1e-7 of its scale
KERNEL_RTOL = 1e-5
# the served scores against the factored model's own dense predictor:
# the same f32 math through a dense gemm
SERVE_RTOL = 1e-5
INT8_REL_RMS = 5e-2              # the reference's documented int8 bound
ONBOARD_REL = 1e-2               # 8 noise-free shots in a rank-4 subspace

REPO = pathlib.Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3 helpers
# ---------------------------------------------------------------------------
def make_inputs(gen, B, p, m, r, code_dtype, x_dtype, quantize_codes,
                bad_ids=False):
    dev = "cuda"
    U = (torch.randn(p, r, generator=gen, device=dev) / math.sqrt(p)).to(x_dtype)
    C, S = quantize_codes(torch.randn(m, r, generator=gen, device=dev),
                          code_dtype)
    ids = torch.randint(0, m, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    if bad_ids:                  # out of range on both sides, every 4th row
        bad = torch.tensor([-7, m, m + 100, -1], dtype=torch.int32, device=dev)
        ids[::4] = bad.repeat((B + 15) // 16)[: ids[::4].shape[0]]
    X = torch.randn(B, p, generator=gen, device=dev).to(x_dtype)
    return U, C, S, ids, X


def time_ms(fn, reps=50, inner=20) -> float:
    """Median over ``reps`` samples of CUDA-event time per call, each
    sample a back-to-back run of ``inner`` calls (what a caller pays,
    host launch overhead included)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def graph_ms(fn, reps=50, inner=20) -> float:
    """Device time per call: ``inner`` calls captured in one CUDA graph,
    the graph replayed ``reps`` times, median of the replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def least_ms(B, p, r, n_unique, x_bytes, u_bytes, code_bytes):
    """Least time for one call: each input byte read once (only the
    code rows and scales these ids touch), each output byte written
    once, against the f32 FMAs of the projection and the dot."""
    nbytes = (B * p * x_bytes + p * r * u_bytes + B * 8
              + n_unique * (r * code_bytes + 4))
    flops = 2 * B * p * r + 3 * B * r
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO / "src_torch"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.mtl_score import kernel as score_kernel
    from repro_torch.kernels.mtl_score import ops as score_ops
    from repro_torch.kernels.mtl_score.ref import (dequantize_codes,
                                                   mtl_score_ref,
                                                   quantize_codes)
    from repro_torch.obs.tracing import TORCH_TRACE_JSON, profiler_session
    from repro_torch.serve.mtl import FactoredModel, MTLServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. the card ----------------------------------------------------
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    score_kernel.build()
    t_build = time.perf_counter() - t0
    lib = _build.library_path("mtl_score", score_kernel.SOURCE)
    ptxas = lib.with_suffix(".log").read_text()
    regs = sorted({int(v) for v in re.findall(r"Used (\d+) registers", ptxas)})
    spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", ptxas))
    log(f"[build] mtl_score: {lib.relative_to(REPO)} in {t_build:.2f} s; "
        f"{len(re.findall('Used', ptxas))} instantiations, registers "
        f"{regs[0]}-{regs[-1]}, {spills} bytes spilled")
    torch.cuda.synchronize()

    # -- 3. kernel vs plain ------------------------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f"serve B={B} {cd}", B, P, M, R, cd, f32, False)
             for B in BATCHES for cd in ("f32", "int8", "fp8")]
    cases += [
        ("bf16 X,U f32 table", 256, P, M, R, "f32", bf16, False),
        ("bf16 X,U int8 table", 256, P, M, R, "int8", bf16, False),
        ("ragged B=77 p=2047 f32", 77, 2047, 50, 3, "f32", f32, False),
        ("ragged B=77 p=2047 fp8 bf16", 77, 2047, 50, 3, "fp8", bf16, False),
        ("r=8 B=33 p=520 int8", 33, 520, 9, 8, "int8", f32, False),
        ("clamp B=64 f32", 64, P, M, R, "f32", f32, True),
        ("clamp B=64 fp8", 64, P, M, R, "fp8", f32, True),
    ]
    max_abs_err = 0.0
    for name, B, p, m, r, cd, xdt, bad in cases:
        U, C, S, ids, X = make_inputs(gen, B, p, m, r, cd, xdt,
                                      quantize_codes, bad_ids=bad)
        out = score_ops.mtl_score(U, C, S, ids, X)
        ref = mtl_score_ref(U, C, S, ids, X)
        torch.cuda.synchronize()
        check(out.shape == (B,) and out.dtype == f32 and
              bool(torch.isfinite(out).all()), f"{name}: bad output")
        scale = float(ref.abs().max())
        err = float((out - ref).abs().max())
        line = f"[kernel] {name:30s} max|err| {err:.3e} / max|score| {scale:.3e}"
        if bad:                  # the clamp oracle, written out
            idx = ids.long().clamp(0, m - 1)
            oracle = ((X.float() @ U.float())
                      * dequantize_codes(C, S).index_select(0, idx)).sum(1)
            err_o = float((out - oracle).abs().max())
            line += f", vs clamp oracle {err_o:.3e}"
            check(err_o <= KERNEL_RTOL * scale,
                  f"{name}: kernel disagrees with the clamp oracle")
        log(line + f" (tol {KERNEL_RTOL:g} x max|score|)")
        check(err <= KERNEL_RTOL * scale, f"{name}: kernel disagrees with "
              f"the plain version: {err} > {KERNEL_RTOL} * {scale}")
        if not bad and p == P:
            max_abs_err = max(max_abs_err, err)
    torch.cuda.synchronize()

    sizes = {"f32": 4, "int8": 1, "fp8": 1}
    by_batch = []
    for B in BATCHES:
        for cd in ("f32", "int8", "fp8"):
            U, C, S, ids, X = make_inputs(gen, B, P, M, R, cd, f32,
                                          quantize_codes)
            k_ms = time_ms(lambda: score_ops.mtl_score(U, C, S, ids, X))
            g_ms = graph_ms(lambda: score_ops.mtl_score(U, C, S, ids, X))
            p_ms = time_ms(lambda: mtl_score_ref(U, C, S, ids, X))
            lib_ms = None
            if cd != "fp8":      # float8 takes no part in type promotion
                ids_l = ids.long()
                lib_ms = time_ms(lambda: (X @ U * C[ids_l]
                                                 * S[ids_l]).sum(1))
            n_unique = int(torch.unique(ids).numel())
            b_ms, b_by = least_ms(B, P, R, n_unique, 4, 4, sizes[cd])
            row = {"B": B, "code_dtype": cd, "kernel_ms": k_ms,
                   "kernel_graph_ms": g_ms, "plain_ms": p_ms,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "distinct_ids": n_unique}
            by_batch.append(row)
            log(f"[time] B={B:5d} {cd:4s} kernel {k_ms * 1e3:8.2f} us "
                f"(graph {g_ms * 1e3:7.2f} us)  plain {p_ms * 1e3:8.2f} us  "
                f"library {'-' if lib_ms is None else f'{lib_ms * 1e3:8.2f}'} us"
                f"  bound {b_ms * 1e3:7.3f} us ({b_by})")
    torch.cuda.synchronize()

    # -- 4. the serving path at full width --------------------------------
    rng = np.random.default_rng(SEED)
    A = rng.standard_normal((P, R))
    W = (A @ rng.standard_normal((M, R)).T
         + NOISE * rng.standard_normal((P, M))).astype(np.float32)
    keys = [f"task-{j}" for j in range(M)]
    ids_np = rng.integers(0, M, N_REQUESTS).astype(np.int32)
    X_np = rng.standard_normal((N_REQUESTS, P)).astype(np.float32)
    shots_X = rng.standard_normal((8, P)).astype(np.float32)
    w_new = A @ rng.standard_normal(R)
    hold_X = rng.standard_normal((WAVE, P)).astype(np.float32)
    W1 = W + (0.1 * A @ rng.standard_normal((M, R)).T).astype(np.float32)
    store = tempfile.mkdtemp(prefix="mtl_store_")
    try:
        score_ops.mtl_score.launches = 0       # count the main path only
        t0 = time.perf_counter()
        model = FactoredModel.from_W(W, R, task_keys=keys)
        check(model.device.type == "cuda", "from_W did not land on the card")
        step = model.save(store)
        step, loaded = FactoredModel.load(store)
        check(loaded.version == model.version and loaded.device.type == "cuda",
              "store round trip changed the model")
        t_publish = time.perf_counter() - t0
        log(f"[serve] factorized {P}x{M} at rank {R}, published and loaded "
            f"step {step} (version {loaded.version}) in {t_publish:.2f} s; "
            f"s = {[round(float(v), 2) for v in loaded.s]}")

        server = MTLServer(loaded, batch_size=WAVE)
        ids = torch.from_numpy(ids_np).cuda()
        X = torch.from_numpy(X_np).cuda()
        n0 = score_ops.mtl_score.launches
        t0 = time.perf_counter()
        scores, ver = server.score(ids, X)
        torch.cuda.synchronize()
        t_score = time.perf_counter() - t0
        waves = score_ops.mtl_score.launches - n0
        check(waves == N_REQUESTS // WAVE, f"{N_REQUESTS} requests took "
              f"{waves} kernel launches, want {N_REQUESTS // WAVE}")
        check(scores.shape == (N_REQUESTS,) and
              bool(torch.isfinite(scores).all()), "bad served scores")
        dense = loaded.dense()
        own = (X * dense.index_select(1, ids.long()).T).sum(1)
        err_own = float((scores - own).abs().max())
        scale = float(own.abs().max())
        check(err_own <= SERVE_RTOL * scale, f"served scores disagree with "
              f"the model's dense predictor: {err_own} > {SERVE_RTOL} * {scale}")
        Wd = torch.from_numpy(W).cuda()
        truth = (X * Wd.index_select(1, ids.long()).T).sum(1)
        rank_err = float(torch.linalg.norm(scores - truth)
                         / torch.linalg.norm(truth))
        w_err = float(torch.linalg.norm(Wd - dense) / torch.linalg.norm(Wd))
        check(rank_err <= 1.5 * w_err + 1e-6, f"rank-{R} score error "
              f"{rank_err} is not explained by the truncation ({w_err})")
        log(f"[serve] {N_REQUESTS} requests in {waves} launches, "
            f"{t_score * 1e3:.2f} ms; vs dense predictor max|err| "
            f"{err_own:.3e} (tol {SERVE_RTOL:g} x {scale:.3e}); rank-{R} error "
            f"vs X W: rel {rank_err:.3e} (||W - W_{R}||/||W|| = {w_err:.3e})")

        preds, _ = server.predict(ids, X)
        check(torch.equal(preds, scores), "predict != score for squared loss")
        keyed, kver = server.score_keyed([keys[i] for i in ids_np[:300]],
                                         X[:300])
        check(kver == ver and torch.equal(keyed, scores[:300]),
              "score_keyed disagrees with score")

        tid = server.onboard("task-new", shots_X, shots_X @ w_new)
        hold = torch.from_numpy(hold_X).cuda()
        new_scores, _ = server.score(torch.full((WAVE,), tid), hold)
        want = torch.from_numpy((hold_X @ w_new).astype(np.float32)).cuda()
        on_err = float(torch.linalg.norm(new_scores - want)
                       / torch.linalg.norm(want))
        check(tid == M and on_err <= ONBOARD_REL,
              f"onboarded task {tid}: rel error {on_err}")
        log(f"[serve] predict and score_keyed agree bitwise; onboarded "
            f"task {tid} from 8 shots: held-out rel error {on_err:.3e}")

        int8 = MTLServer(loaded, batch_size=WAVE, code_dtype="int8")
        q_scores, _ = int8.score(ids, X)
        q_err = float(torch.linalg.norm(q_scores - scores)
                      / torch.linalg.norm(scores))
        int8.swap(server.model)
        q_new, q_ver = int8.score(torch.full((WAVE,), tid), hold)
        q_new_err = float(torch.linalg.norm(q_new - new_scores)
                          / torch.linalg.norm(new_scores))
        check(q_ver == server.version and q_err <= INT8_REL_RMS and
              q_new_err <= INT8_REL_RMS,
              f"int8 table: rel error {q_err}, after swap {q_new_err}")
        log(f"[serve] int8 table: rel error {q_err:.3e} vs f32; swapped to "
            f"{q_ver} and served the onboarded task at {q_new_err:.3e}")

        v1 = FactoredModel.from_W(W1, R, task_keys=keys)
        step1 = v1.save(store)
        check(server.maybe_reload(store) and server.version == v1.version,
              "maybe_reload did not pick up the newer store step")
        r_scores, r_ver = server.score(ids, X)
        r_own = (X * v1.dense().index_select(1, ids.long()).T).sum(1)
        r_err = float((r_scores - r_own).abs().max())
        check(r_ver == v1.version and
              r_err <= SERVE_RTOL * float(r_own.abs().max()),
              f"reloaded model serves wrong scores: {r_err}")
        torch.cuda.synchronize()
        main_launches = score_ops.mtl_score.launches
        log(f"[serve] maybe_reload picked up step {step1} (version "
            f"{r_ver}); main path launched mtl_score {main_launches} times")
        check(main_launches > 0, "the main path never launched mtl_score")

        # end to end: one call of 1024 requests as a client sees it (the
        # launches plus the one validity sync), steady state
        lat = []
        for _ in range(55):
            t0 = time.perf_counter()
            server.score(ids, X)
            lat.append(time.perf_counter() - t0)
        lat = sorted(lat[5:])
        p50, worst = lat[len(lat) // 2], lat[-1]
        log(f"[e2e] score({N_REQUESTS}) over 50 calls: p50 "
            f"{p50 * 1e6:.1f} us, max {worst * 1e6:.1f} us, "
            f"{N_REQUESTS / p50:.0f} requests/s at p50; first call "
            f"{t_score * 1e6:.1f} us")

        # where a call's time goes: the device kernels torch.profiler saw
        # over 10 calls, against the wall time of the profiled window
        # (the profiler's per-op cost is inside that window, its start and
        # its export are not)
        with tempfile.TemporaryDirectory() as tdir:
            with profiler_session(tdir):
                t0 = time.perf_counter()
                for _ in range(10):
                    server.score(ids, X)
                torch.cuda.synchronize()
                window_us = (time.perf_counter() - t0) * 1e6
            events = json.loads(
                (pathlib.Path(tdir) / TORCH_TRACE_JSON).read_text())
        kernels = {}
        for ev in events.get("traceEvents", []):
            if ev.get("cat") == "kernel":
                kernels[ev["name"]] = kernels.get(ev["name"], 0.0) + ev["dur"]
        busy_us = sum(kernels.values())
        busy = busy_us / window_us
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:5]
        log(f"[e2e] profiled 10 calls: device busy {busy_us:.1f} us of "
            f"{window_us:.1f} us wall ({100 * busy:.2f} %); by kernel: "
            + ("; ".join(f"{name[:60]} {us:.1f} us" for name, us in top)
               if top else "no device kernels recorded (not measured)"))
    finally:
        shutil.rmtree(store, ignore_errors=True)

    # -- results -----------------------------------------------------------
    main_row = next(b for b in by_batch
                    if b["B"] == WAVE and b["code_dtype"] == "f32")
    result = {"kernels": [{
        "name": "mtl_score",
        "route": "cuda",
        "source": "src_torch/repro_torch/kernels/mtl_score/csrc/mtl_score.cu",
        "replaces": "src/repro/kernels/mtl_score/kernel.py:57",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": main_row["kernel_ms"],
        "kernel_ms": main_row["kernel_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": {"B": WAVE, "p": P, "m": M, "r": R, "code_dtype": "f32"},
        "by_batch": by_batch,
    }], "serve": {"requests_per_call": N_REQUESTS, "wave": WAVE,
                  "first_call_s": t_score, "p50_call_s": p50,
                  "max_call_s": worst, "requests_per_s_p50": N_REQUESTS / p50,
                  "profiled_device_busy_share": busy if kernels else None,
                  "profiled_kernel_us": kernels}}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
