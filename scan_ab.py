#!/usr/bin/env python3
"""Time the selective scan (``ssm_scan``) of one checkout of the port on
one NVIDIA card, at the falcon-mamba serving path's shapes, and the
served wave it runs in.

    python3 scan_ab.py [--root DIR] [--tag NAME] [--wave]

``--root`` is the root of the checkout whose ``src_torch/`` is timed
(default: this script's own), so two versions compare in one machine:
unpack the other with ``git archive`` into a git-ignored directory and
run ``root A, root B, root B, root A``, one process each.  The helpers
(timers, inputs, checks, bounds) are this checkout's ``chip_smoke.py``.

Each main shape of phase 11 (``SSM_MAIN``: the bare scan's served
prefill and decode; ``SSM_FUSED_MAIN``: the same through the fused
mixer entry, where the checkout has one) is first held to the plain
version with phase 11's check and launched twice (bitwise equal), then
timed: device time (one CUDA graph, median of its replays), per call
(CUDA events around Python calls) and the bound.  ``--wave`` times the
served falcon-mamba-7b bf16 wave (phase 11's 8 prompts, 32 new tokens,
random weights from the seed) through the checkout's model: prefill
(three runs), each decode step with the engine's one read-back, and a
greedy ``ServeEngine.generate`` (tokens/s).  The last line is one JSON
object.  Without a card it exits 1.
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


def shapes(sops):
    """(entry, case, call, plain, check, bound) for each main shape."""
    from repro_torch.kernels.ssm_scan import ref
    out = []
    for case in cs.SSM_MAIN:
        kw = cs.ssm_inputs(case)
        out.append(("selective_scan", case,
                    lambda kw=kw: sops.selective_scan(**kw),
                    lambda kw=kw: ref.selective_scan_ref(**kw),
                    lambda o, r: cs.ssm_passes(*cs.ssm_error(*o, *r)),
                    cs.ssm_bound_ms(kw)[0]))
    for case in cs.SSM_FUSED_MAIN if hasattr(sops, "mamba_scan") else ():
        kw = cs.ssm_fused_inputs(case)
        out.append(("mamba_scan", case,
                    lambda kw=kw: sops.mamba_scan(**kw),
                    lambda kw=kw: cs.ssm_fused_reference(kw),
                    lambda o, r: cs.ssm_fused_passes(
                        *cs.ssm_fused_error(*o, r)),
                    cs.ssm_fused_bound_ms(kw)[0]))
    return out


def kernel_rows(sops, tag):
    rows = []
    for entry, case, call, plain, passes, (b_ms, b_by) in shapes(sops):
        name, S = case[0], case[2]
        want = plain()
        got, again = call(), call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got[0], again[0])
                 and torch.equal(got[1], again[1]),
                 f"{entry} {name}: two launches gave other bytes")
        cs.check(passes(got, want), f"{entry} {name}: disagrees with the "
                 f"plain version")
        reps, inner = (5, 5) if S > 1 else (20, 20)
        g_ms = cs.graph_ms(call, reps=reps, inner=inner)
        k_ms = cs.time_ms(call, reps=reps, inner=inner)
        rows.append({"entry": entry, "shape": name, "graph_ms": g_ms,
                     "call_ms": k_ms, "bound_ms": b_ms, "bound_by": b_by})
        print(f"[time] {tag} {entry:14s} {name:30s}: device "
              f"{g_ms * 1e3:9.2f} us  per call {k_ms * 1e3:9.2f} us  bound "
              f"{b_ms * 1e3:8.3f} us ({b_by}); checked, relaunch bitwise",
              flush=True)
        del got, again, want
        torch.cuda.empty_cache()
    return rows


def wave(tag):
    """The served wave's prefill, decode steps and greedy tokens/s."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = get_config(cs.SSM_ARCH)
    model = model_mod.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(cs.SEED))
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in cs.SSM_PROMPTS]
    B, S, new = len(prompts), max(cs.SSM_PROMPTS), cs.SSM_NEW
    batch = np.zeros((B, S), np.int64)
    for i, p in enumerate(prompts):
        batch[i, S - len(p):] = p
    batch = {"tokens": torch.from_numpy(batch).cuda()}
    pre_ms, dec_ms = [], []
    for _ in range(3):
        cache = model_mod.init_cache(cfg, B, cs.SSM_MAX_LEN)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model_mod.prefill(model, batch, cache)
        cur = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        pre_ms.append((time.perf_counter() - t0) * 1e3)
    pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for _ in range(new - 1):
        t0 = time.perf_counter()
        logits, cache = model_mod.decode_step(model, cur, pos, cache)
        cur = torch.argmax(logits, -1)
        cur.cpu()                                   # the engine's one sync
        dec_ms.append((time.perf_counter() - t0) * 1e3)
        pos = pos + 1
    del cache
    engine = ServeEngine(model, cfg, batch_size=B, max_len=cs.SSM_MAX_LEN)
    waves = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate([Request(p, max_new_tokens=new) for p in prompts])
        torch.cuda.synchronize()
        waves.append(time.perf_counter() - t0)
    out = {"prefill_ms_all": pre_ms,
           "prefill_ms": statistics.median(pre_ms),
           "decode_step_ms_all": dec_ms,
           "decode_step_ms_median": statistics.median(dec_ms),
           "wave_s_all": waves, "tokens_per_s": B * new / min(waves)}
    print(f"[wave] {tag} prefill {out['prefill_ms']:.2f} ms (of "
          f"{[round(v, 2) for v in pre_ms]}); decode step median "
          f"{out['decode_step_ms_median']:.3f} ms (min {min(dec_ms):.3f}, "
          f"max {max(dec_ms):.3f}); greedy waves {[round(v, 3) for v in waves]}"
          f" s, {out['tokens_per_s']:.1f} tokens/s at the faster", flush=True)
    del model, engine
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--wave", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scan_ab: torch sees no CUDA device", file=sys.stderr)
        return 1
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root / "src_torch"))
    from repro_torch.kernels.ssm_scan import kernel as kmod
    from repro_torch.kernels.ssm_scan import ops as sops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    kmod.build()
    print(f"[build] {args.tag} {root}: {time.perf_counter() - t0:.2f} s",
          flush=True)
    rows = kernel_rows(sops, args.tag)
    result = {"root": str(root), "tag": args.tag, "card": card, "rows": rows}
    if args.wave:
        result["wave"] = wave(args.tag)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
