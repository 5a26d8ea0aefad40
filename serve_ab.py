#!/usr/bin/env python3
"""Time the port's two serving kernels that decode and score, of one
checkout, on one NVIDIA card: ``flash_attention``'s decode calls (the
gemma2-2b served wave's global and local layers) and ``mtl_score`` (the
factored server's waves), and, with ``--wave``, the served gemma2 wave
they run in.

    python3 serve_ab.py [--root DIR] [--tag NAME] [--wave] [--sweep]

``--root`` is the root of the checkout whose ``src_torch/`` is timed
(default: this script's own), so two versions compare in one machine:
unpack the other with ``git archive`` into a git-ignored directory and
run ``root A, root B, root B, root A``, one process each.  The helpers
(inputs, checks, timers, bounds) are this checkout's ``chip_smoke.py``.

Each shape is first held to the plain version with ``chip_smoke``'s
check (phase 10's per-row attention check; phase 3's ``KERNEL_RTOL``)
and launched twice (bitwise equal), then timed: device time (one CUDA
graph, median of its replays), per call (CUDA events around Python
calls) and the bound; an empty kernel in the same graph harness gives
the floor of a launch.  ``--wave`` times the served gemma2-2b bf16 wave
(phase 10's 4 prompts, 32 new tokens, random weights from the seed):
prefill (three runs), each decode step with the engine's one read-back,
a ``torch.profiler`` window over the decode steps (device time a step,
and the attention kernels' share), and a greedy ``ServeEngine.generate``
(tokens/s).  ``--sweep`` (this checkout's kernels only) times forced
launch plans: the decode kernel's tiles per split and ``mtl_score``'s
warps a row and rows a warp.  The last line is one JSON object.  Without a card it
exits 1.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import chip_smoke as cs  # noqa: E402

SCORE_BATCHES = (64, 256, 4096)


def attention_rows(fops, tag):
    from repro_torch.kernels.flash_attention.ref import attention_ref
    rows = []
    for case in cs.FA_MAIN[2:]:
        name = case[0]
        q, k, v, q_pos, k_pos = cs.fa_inputs(case)
        kw = dict(q_pos=q_pos, k_pos=k_pos, causal=True, window=case[9],
                  softcap=case[10])

        def call():
            return fops.flash_attention(q, k, v, **kw)

        got, again = call(), call()
        ref = attention_ref(q, k, v, **kw)
        ref_abs = attention_ref(q, k, v.abs(), **kw)
        torch.cuda.synchronize()
        cs.check(torch.equal(got, again), f"{name}: two launches gave other "
                 f"bytes")
        err = cs.fa_error(got, ref, ref_abs, case[7])
        cs.check(cs.fa_passes(*err, case[7]), f"{name}: disagrees with the "
                 f"plain version: {err}")
        g_ms = cs.graph_ms(call, reps=20, inner=10)
        k_ms = cs.time_ms(call, reps=20, inner=10)
        (b_ms, b_by), *_ = cs.fa_bound_ms(case, q, k, q_pos, k_pos)
        rows.append({"kernel": "flash_attention", "shape": name,
                     "graph_ms": g_ms, "call_ms": k_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "worst_row_ratio": err[2]})
        print(f"[time] {tag} flash_attention {name:20s}: device "
              f"{g_ms * 1e3:8.2f} us  per call {k_ms * 1e3:8.2f} us  bound "
              f"{b_ms * 1e3:7.3f} us ({b_by}, {b_ms / g_ms:.3f} of the "
              f"device time); worst row {err[2]:.3f} of its limit, relaunch "
              f"bitwise", flush=True)
        del q, k, v, got, again, ref, ref_abs
    return rows


def score_rows(sops, tag):
    from repro_torch.kernels.mtl_score.ref import mtl_score_ref, quantize_codes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    rows = []
    for B in SCORE_BATCHES:
        U, C, S, ids, X = cs.make_inputs(gen, B, cs.P, cs.M, cs.R, "f32",
                                         torch.float32, quantize_codes)

        def call():
            return sops.mtl_score(U, C, S, ids, X)

        got, again = call(), call()
        ref = mtl_score_ref(U, C, S, ids, X)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max())
        cs.check(torch.equal(got, again), f"mtl_score B={B}: two launches "
                 f"gave other bytes")
        cs.check(err <= cs.KERNEL_RTOL * scale, f"mtl_score B={B}: "
                 f"disagrees with the plain version: {err}")
        g_ms = cs.graph_ms(call)
        k_ms = cs.time_ms(call)
        b_ms, b_by = cs.least_ms(B, cs.P, cs.R, int(torch.unique(ids).numel()),
                                 4, 4, 4)
        rows.append({"kernel": "mtl_score", "shape": f"B={B}",
                     "graph_ms": g_ms, "call_ms": k_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err_over_scale": err / scale})
        print(f"[time] {tag} mtl_score B={B:5d} p={cs.P} r={cs.R} f32: device "
              f"{g_ms * 1e3:8.2f} us  per call {k_ms * 1e3:8.2f} us  bound "
              f"{b_ms * 1e3:7.3f} us ({b_by}); max|err| {err / scale:.2e} of "
              f"max|score|, relaunch bitwise", flush=True)
    floor = cs.graph_ms(lambda: torch.cuda._sleep(0))
    rows.append({"kernel": "empty", "shape": "torch.cuda._sleep(0)",
                 "graph_ms": floor})
    print(f"[time] {tag} empty kernel: device {floor * 1e3:8.2f} us (the "
          f"floor of a launch)", flush=True)
    return rows


def sweep(tag):
    """Forced plans of this checkout's two kernels, device time each."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mtl_score import kernel as sk
    from repro_torch.kernels.mtl_score.ref import quantize_codes
    out = []
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for case in cs.FA_MAIN[2:]:
        name, B, Sq, Sk, H, Hkv, hd, dtype, _, window, softcap = case
        q, k, v, q_pos, k_pos = cs.fa_inputs(case)
        qp, kp = q_pos.int().contiguous(), k_pos.int().contiguous()
        best = fk.plan(B, Sq, Sk, H, Hkv, hd, dtype, n_sm)
        tile = fk.decode_tile_keys(hd, dtype)
        n_tiles = -(-Sk // tile)
        for per in (6, 8, 11, 16, 21, 32):
            how = fk.Plan("decode", best.rows, best.ctas, -(-n_tiles // per),
                          per)
            plan, fk.plan = fk.plan, lambda *_: how    # this sweep's plan
            try:
                g_ms = cs.graph_ms(lambda: fk.launch(
                    q, k, v, qp, kp, True, window, softcap, hd ** -0.5),
                    reps=20, inner=10)
            finally:
                fk.plan = plan
            out.append({"kernel": "flash_attention", "shape": name,
                        "plan": how._asdict(), "graph_ms": g_ms})
            print(f"[sweep] {tag} decode {name}: {how.n_split} splits of "
                  f"{per} tiles ({how.n_split * how.ctas} CTAs) device "
                  f"{g_ms * 1e3:8.2f} us{'  (plan)' if how == best else ''}",
                  flush=True)
        del q, k, v
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cs.SEED)
    for B in SCORE_BATCHES:
        U, C, S, ids, X = cs.make_inputs(gen, B, cs.P, cs.M, cs.R, "f32",
                                         torch.float32, quantize_codes)
        best = sk.plan(B, n_sm)
        for rw in sk.ROWS_PER_WARP:
            for spr in sk.WARPS_PER_ROW:
                rows = sk.WARPS // spr * rw
                pl = sk.Plan(spr, rw, rows, -(-B // rows))
                g_ms = cs.graph_ms(lambda: sk.launch(U, C, S, ids, X, pl))
                out.append({"kernel": "mtl_score", "shape": f"B={B}",
                            "plan": pl._asdict(), "graph_ms": g_ms})
                print(f"[sweep] {tag} mtl_score B={B}: {spr} warps a row, "
                      f"{rw} rows a warp ({pl.ctas} CTAs) device "
                      f"{g_ms * 1e3:8.2f} us{'  (plan)' if pl == best else ''}",
                      flush=True)
    return out


def wave(tag):
    """The served gemma2 wave's prefill, decode steps (their device time
    and the attention kernels' share) and greedy tokens/s."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(cs.LM_ARCH)
    model = model_mod.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(cs.SEED))
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in cs.SERVE_PROMPTS]
    B, S, new = len(prompts), max(cs.SERVE_PROMPTS), cs.SERVE_NEW
    batch = np.zeros((B, S), np.int64)
    for i, p in enumerate(prompts):
        batch[i, S - len(p):] = p
    batch = {"tokens": torch.from_numpy(batch).cuda()}

    def prefill():
        cache = model_mod.init_cache(cfg, B, cs.SERVE_MAX_LEN)
        logits, cache = model_mod.prefill(model, batch, cache)
        return torch.argmax(logits, -1), cache

    def decode(cur, cache, times):
        pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
        for _ in range(new - 1):
            t0 = time.perf_counter()
            logits, cache = model_mod.decode_step(model, cur, pos, cache)
            cur = torch.argmax(logits, -1)
            cur.cpu()                               # the engine's one sync
            times.append((time.perf_counter() - t0) * 1e3)
            pos = pos + 1

    pre_ms, dec_ms = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur, cache = prefill()
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    decode(cur, cache, dec_ms)
    cur, cache = prefill()
    kernels, window_us = cs.profile_kernels(lambda: decode(cur, cache, []))
    del cache
    device_us = sum(kernels.values())
    attn_us = sum(us for name, us in kernels.items() if "flash" in name)
    engine = ServeEngine(model, cfg, batch_size=B, max_len=cs.SERVE_MAX_LEN)
    waves = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate([Request(p, max_new_tokens=new) for p in prompts])
        torch.cuda.synchronize()
        waves.append(time.perf_counter() - t0)
    out = {"prefill_ms_all": pre_ms, "prefill_ms": statistics.median(pre_ms),
           "decode_step_ms_all": dec_ms,
           "decode_step_ms_median": statistics.median(dec_ms),
           "decode_step_device_ms": device_us / (new - 1) / 1e3,
           "decode_step_attention_ms": attn_us / (new - 1) / 1e3,
           "decode_busy_share": device_us / window_us,
           "wave_s_all": waves, "tokens_per_s": B * new / min(waves)}
    print(f"[wave] {tag} prefill {out['prefill_ms']:.2f} ms (of "
          f"{[round(v, 2) for v in pre_ms]}); decode step median "
          f"{out['decode_step_ms_median']:.3f} ms (min {min(dec_ms):.3f}, "
          f"max {max(dec_ms):.3f}); profiled decode steps: device "
          f"{out['decode_step_device_ms']:.3f} ms a step, attention "
          f"{out['decode_step_attention_ms']:.3f} ms a step, "
          f"{100 * out['decode_busy_share']:.2f} % busy; greedy waves "
          f"{[round(v, 3) for v in waves]} s, {out['tokens_per_s']:.1f} "
          f"tokens/s at the faster", flush=True)
    del model, engine
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--wave", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src_torch"))
    from repro_torch.kernels.flash_attention import kernel as fkernel
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.mtl_score import kernel as skernel
    from repro_torch.kernels.mtl_score import ops as sops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    fkernel.build()
    skernel.build()
    print(f"[build] {args.tag} {root}: {time.perf_counter() - t0:.2f} s",
          flush=True)
    result = {"root": str(root), "tag": args.tag, "card": card,
              "rows": attention_rows(fops, args.tag)
              + score_rows(sops, args.tag)}
    if args.sweep:
        result["sweep"] = sweep(args.tag)
    if args.wave:
        result["wave"] = wave(args.tag)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
