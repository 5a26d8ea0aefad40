#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src_torch/repro_torch``) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failed check
raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the versions;
2. the build of every kernel from the sources in this checkout, one
   ``nvcc`` per source, all started together (into
   ``src_torch/repro_torch/_build/``), with each build's ``ptxas`` lines
   (``flash_attention`` has three sources, one per route);
3. each kernel against its plain PyTorch version on the card, on the
   same inputs, at the main paths' shapes and at edge shapes (for
   ``mtl_score`` also p inside one warp's first copy, every rank 1..8,
   unaligned rows, and those cases again at 4 rows a warp; each launched
   twice: the bytes must not move), then
   its time beside the plain version, one PyTorch expression for the
   same function, the least time the card could take and (``mtl_score``)
   an empty kernel's time in the same graph harness, the floor;
4. the serving path at full width (p=2048, m=4096, r=4, the acceptance
   point of the reference's serve benchmark): factorize a seeded rank-4
   W plus noise on the card, publish it to a store, load it, serve 1024
   mixed-task requests in waves of 256, predict, route by key, onboard
   an unseen task from 8 shots, serve from an int8 table, swap, and
   hot-reload a newer store step;
5. the end-to-end latency of one 1024-request ``score`` call, as a
   client sees it, over 50 calls in steady state, and the device kernels
   ``torch.profiler`` records over 10 such calls;
6. solver path A, the squared raw path at the reference's largest solver
   spec (``benchmarks/solver_bench.py`` FULLSP: p=2048, m=768, n=64,
   r=4, gram=False): ProxGD for 50 and 25 rounds with the lazy and the
   exact spectral master, then ``factorize(4)`` -> ``MTLServer`` -> one
   wave of 256 requests, and a ``torch.profiler`` window over one lazy
   solve;
7. solver path B, the logistic path at the reference's headline solver
   spec (FULL: p=200, m=32, n=2000, r=5): DGSP for 10 rounds and ProxGD
   for 50, on the card and through the port on the CPU, same data;
8. solver path C, the paper's Fig-1 claims at its base spec (p=100,
   m=30, r=5, n=50) with the ten methods of
   ``benchmarks/fig1_regression.py``;
9. solver path D, stochastic rounds at the reference's large-n spec
   (``solver_bench.py`` FULL2D: p=200, m=32, n=20000, r=5, one data
   shard; phase 9b runs it at four): the §5 data drawn on the card by the port's threefry
   generator, the five stochastic solvers (mini-batches of 500 rows,
   local steps through the ``prox_step`` kernel) and AltMin on the
   logistic copy, each held to its full-batch ledger, to the bitwise
   ``B=n, L=1`` anchor, to the port's CPU solve on the same draws
   and (squared loss, and AltMin) to ``W=0``'s excess risk;
9b. the mesh runtime: ``init_cluster`` brings up a 1-rank NCCL group on a
   file store in a temporary directory and ``task_mesh`` a mesh over it;
   path B's DGSP (10 rounds) and path D's stochastic ProxGD (10 rounds,
   B=500, L=4) on ``backend="mesh"``, each bitwise equal to the sim's W
   with the same ledger, ``collective_floats_per_chip`` equal to the
   ledger's worker->master floats times m, and as many ``mtl_grad`` /
   ``prox_step`` launches as the sim's, each solve's time a round on the
   mesh beside the sim's; path D at four data shards through the sim's
   2-D emulation (``solver_bench.py`` bench_2d: ProxGD 10 rounds and
   DGSP 6 on the Gram path within 1e-4 of one shard with the same
   ledger and no data floats, and the stochastic ProxGD at B=500, L=4
   below ``W=0``'s excess risk); the sharded code table on the serve
   configuration, bitwise equal to the unsharded server, through
   ``mtl_score``; the group is torn down at the end;
9c. recovery, device metrics and streaming: through the fault harness
   (``repro_torch.faults``), child processes on the card run path B's
   DGSP (10 rounds, a checkpoint every 3) SIGKILLed after segment 2, and
   path D's stochastic ProxGD (B=500, L=4) killed after segment 3 with
   that segment corrupted, at one and at four data shards; one
   ``resume`` in a fresh child finishes each, bitwise equal to an
   uninterrupted child's W, iterates, ledger and counters, launching
   ``mtl_grad`` / ``prox_step`` for the rounds it ran; ``metrics=True``
   on path A's lazy ProxGD and path B's DGSP leaves W bitwise unchanged,
   the objective (and DGSP's step norm) held to a recomputation, the
   round time with and without metrics in paired solves; three
   streaming refreshes of stochastic ProxGD on path B's spec, each
   published to a live ``MTLServer`` whose wave of 256 scores is held to
   ``X W_r`` of the new model, with the store step, the swap log and
   the staleness gauges;
9d. the static checks and the Fig-4 surrogates: ``solve(...,
   verify="static")`` on path B's DGSP, path D's stochastic ProxGD, the
   same on a 1-rank NCCL mesh and at four data shards through the sim's
   2-D emulation, each "ok" with W, ledger and the real solve's kernel
   launches bitwise an unverified solve's (the twin's launches counted
   apart), and a runtime whose gather also moves an uncharged
   all-reduce on the mesh refused with COMM001; the six App. H
   surrogates drawn on the card from ``PRNGKey(300 + i)`` as
   ``benchmarks/fig4_real.py`` draws them, held to the port's CPU draws
   (labels equal but at near-ties), every fig4 method on each with the
   App. H claim (the best sharing method within 1.02 x ``local``'s test
   error), and DGSP and ProxGD on school and landmine card vs CPU;
10. the LM serving path of gemma2-2b at full width: (a) the
   ``flash_attention`` kernels against their plain version at the served
   shapes (prefill B=4 S=5120 global and with the 4096 window binding,
   decode against a ring buffer of wrapped and empty slots), f32 and
   bf16, softcap on and off, edge shapes (S=6..300, hd 64/128/256,
   group 1/2/9/12, ragged edges, a block longer than Sq and Sk, 96
   queries against a wrapped ring, decode at every (dtype, hd, rows)
   the decode kernel builds, with rings of slots that are no multiple of
   its tile and splits in which no key counts, and calls of 10 and 16
   query rows on the CUDA cores whose keys split),
   each case on the route it is meant to take (bf16 with at least 64
   query rows on the tensor cores, at most 8 query rows on the decode
   kernel, the rest on the CUDA cores),
   relaunches bitwise, each output row held to its own scale, calls that
   must fail (the window dropped, the softcap dropped, ``k_pos`` ignored,
   the causal mask dropped), then the times beside the plain version,
   FlexAttention, SDPA and the bound; (b) the f32 anchor (gemma2-2b
   FULL in float32, B=2, a 4608-token prompt, 4 teacher-forced
   tokens): ``forward`` == ``prefill`` + ``decode_step`` and kernel
   ``forward`` == plain ``forward``, to 2e-3, forward and prefill on the
   CUDA cores, the decode steps on the decode kernel;
   (c) the served bf16 wave through
   ``ServeEngine`` (prompts of 5120, 4096, 1024 and 17 tokens, 32 new
   each): 832 kernel launches (the 26 prefill layers on the tensor
   cores, 806 decode calls on the decode kernel), greedy and
   seeded-temperature runs
   repeatable, the logits of prefill and the teacher-forced decode
   steps within ``SERVE_LOGIT_TOL`` of those through the plain version
   and its greedy tokens equal, two wrong decode attentions outside that
   limit, prefill and decode times, and a
   ``torch.profiler`` window over one wave;
11. falcon-mamba-7b served at full width: (a) the ``ssm_scan`` kernel
   against its plain version at the served shapes (prefill B=8 S=2048
   I=8192 N=16 bf16 from a zero and a random state, a 4096-token
   forward without one, a decode step from a random state), at larger
   dt, and at edge shapes (I=100, N 4/8/16, S 1/33, f32), relaunches
   bitwise, y and h_final held per row to ``SSM_TOL``, scans that must
   fail (the state ignored, C_t from step t-1, the last step dropped),
   then its times beside the plain version and the bound; the same for
   the fused mixer entry ``mamba_scan`` (softplus prologue, D-skip and
   SiLU-gate epilogue) at the served shapes, above softplus's threshold
   and at edge shapes, its output held per element to ``SSM_TOL`` of its
   row plus the two roundings' ulps, with its own wrong scans (the D
   skip, the gate, ``dt_bias``, the softplus or the state dropped); (b) the f32
   anchor (falcon-mamba-7b FULL in float32, B=2, a 1024-token prompt, 4
   teacher-forced tokens): ``forward`` == ``prefill`` + ``decode_step``
   and kernel ``forward`` == plain ``forward``, to 2e-3; (c) the served
   bf16 wave through ``ServeEngine`` (8 prompts of 2048 down to 17
   tokens, 32 new each): 2048 kernel launches, greedy and
   seeded-temperature runs repeatable, the logits of prefill and the
   teacher-forced decode steps within ``SSM_SERVE_TOL`` of those through
   the plain version, two wrong decode scans outside it, prefill and
   decode times, and a ``torch.profiler`` window over one wave;
12. LM training at full width, gradients through both LM kernels (the
   kernel forward, the reference route's twin differentiated in
   backward): (a) gemma2-2b FULL, B=1, S=4608 (the 4096 window binds),
   in float32 and in bfloat16 (the training steps' model, batch and
   tensor-core route): one ``lm_loss`` backward through the kernels and
   one with the plain attention forced on the card, every gradient leaf
   present and nonzero, the loss and each leaf within
   ``TRAIN_GRAD_TOL`` (relative L2) of the plain run's, 26 launches in
   the forward and 26 in the remat recompute; the kernel or its twin
   with the window dropped must each fail the check; (b) 10 bf16 steps
   of ``make_train_step`` on gemma2-2b FULL at B=1, S=4608 on the
   seeded token stream: the loss finite and falling, every launch on
   the tensor-core route, step time, tokens/s, MFU (6·N·D over the
   bf16 peak), peak memory, then a ``torch.profiler`` window over an
   11th step; (c) falcon-mamba-7b at full width cut to 8 of its 64
   layers: (a) at S=2048 (the chunked twin) against the plain scan,
   the D skip dropped in the kernel or the twin failing it, and 10 bf16
   steps as in (b); (d) ``MTLHead`` on mean-pooled features
   (``extract_features`` over ``hidden_states``) of (b)'s model after
   its 11 steps: DGSP (U orthonormal, ``as_low_rank``) and a logistic
   ProxGD head that launches ``mtl_grad``, card W against the port's
   CPU W.

Phase 3 also checks the seeded sampler on the card against the CPU,
bit for bit, and times a draw.  Phases 4, 6-9d, the served waves and
f32 anchors of 10 and 11 and the runs of 12 each set the launch counters
to 0 just before they run and read them just after.  It prints a ``{"kernels": [...]}`` line and,
last, the contract line ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or without the package beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src_torch"))
# the H100 machine model (data-sheet rates) of the port's roofline
from repro_torch.launch.roofline import (  # noqa: E402
    F32_FLOPS as F32_FLOPS_PER_S, HBM_BW as HBM_BYTES_PER_S,
    PEAK_FLOPS as BF16_FLOPS_PER_S, SFU_PER_S)

SEED = 0
P, M, R = 2048, 4096, 4          # BENCH_serve.json acceptance point
WAVE = 256                       # MTLServer batch_size of the README
N_REQUESTS = 1024                # 4 waves
NOISE = 0.01                     # off-subspace noise in W
BATCHES = (64, 256, 4096)        # kernel timing points
# kernel vs plain: both sides multiply the same f32 values; only the
# order of the f32 sums differs (warp shuffles vs cuBLAS), which moves a
# p=2048 sum by ~1e-7 of its scale
KERNEL_RTOL = 1e-5
# the served scores against the factored model's own dense predictor:
# the same f32 math through a dense gemm
SERVE_RTOL = 1e-5
INT8_REL_RMS = 5e-2              # the reference's documented int8 bound
ONBOARD_REL = 1e-2               # 8 noise-free shots in a rank-4 subspace
# mtl_grad vs plain: the same f32 products, summed in another order
# (each CTA of a task's cluster walks its rows in order, the partials
# are added in rank order, vs cuBLAS), ~1e-7 of the scale
GRAD_RTOL = 1e-5
# solver path A: the reference's spectral spec (solver_bench.py:66) and
# its documented lazy-vs-exact bound (solver_bench.py:70)
FULLSP = dict(p=2048, m=768, n=64, r=4, rounds=50, lam=0.0013, sv_rank=8,
              noise=0.05)
SPECTRAL_W_TOL = 1e-5
# solver path B: the reference's headline solver spec (solver_bench.py:48)
# with classification labels; card vs CPU within the solver bound
FULL = dict(p=200, m=32, n=2000, r=5)
FULL_METHODS = (("dgsp", {"rounds": 10}), ("proxgd", {"rounds": 50, "lam": 0.02}))
SOLVER_W_RTOL = 1e-4
# prox_step vs plain: the same f32 products and step, the sums in
# another order, ~1e-7 of the scale
PROX_RTOL = 1e-5
# solver path D: the reference's large-n spec (solver_bench.py:55), its
# data key and chunking (solver_bench.py:139-142), on one data shard
FULL2D = dict(p=200, m=32, n=20000, r=5, chunks=10, key=3)
D_BATCH = 500
D_SOLVES = (            # method, loss, hyper-parameters, local steps
    ("proxgd", "squared", {"rounds": 10, "lam": 0.01}, 4),
    ("accproxgd", "squared", {"rounds": 10, "lam": 0.01}, 4),
    ("admm", "squared", {"rounds": 10, "lam": 0.01}, 4),
    ("dgsp", "squared", {"rounds": 6}, 2),
    ("dnsp", "squared", {"rounds": 6}, 2),
    ("proxgd", "logistic", {"rounds": 10, "lam": 0.01}, 4),
)
D_ALTMIN = {"rounds": 10, "u_grad_steps": 20}  # logistic: U-step via mtl_grad
# the prox_step kernel's two main shapes: path D's local step, and the
# FULLSP spec (solver_bench.py:66) with 32-row mini-batches
PROX_MAIN = (("path D squared", 32, D_BATCH, 200, "squared"),
             ("FULLSP-stochastic", 768, 32, 2048, "squared"))
# the step's scalars in the check: eta*inv_m = 1 and l2 = 0.1, so the
# kernel's own terms (the gradient, l2*w, q, rho*(w - z)) are as large as
# W_new and the tolerance is <= 1e-4 of the step: a dropped term or X read
# at bf16 precision fails it (tests/test_torch_prox_step.py shows both)
PROX_DESCENT = dict(eta=2.0, rho=0.0, inv_m=0.5, l2=0.1)
PROX_ADMM = dict(eta=2.0, rho=0.25, inv_m=0.5, l2=0.1)
_F32, _BF16 = torch.float32, torch.bfloat16
# name, L, B, p, loss, X dtype, W scale, ADMM form (random Z, Q)
PROX_CASES = (
    ("path D squared", 32, D_BATCH, 200, "squared", _F32, 1.0, False),
    ("path D logistic", 32, D_BATCH, 200, "logistic", _F32, 1.0, False),
    ("FULLSP-stochastic", 768, 32, 2048, "squared", _F32, 1.0, False),
    ("FULLSP-stochastic bf16 X", 768, 32, 2048, "squared", _BF16, 1.0, False),
    ("path D ADMM rho Z,Q", 32, D_BATCH, 200, "squared", _F32, 1.0, True),
    ("path D ADMM logistic", 32, D_BATCH, 200, "logistic", _F32, 1.0, True),
    ("ragged L=3 B=300 p=37", 3, 300, 37, "squared", _F32, 1.0, True),
    ("ragged L=5 B=77 p=2047 bf16 log", 5, 77, 2047, "logistic", _BF16, 1.0,
     True),
    ("L=1 B=500 p=200", 1, D_BATCH, 200, "squared", _F32, 1.0, False),
    ("B=1 L=4 p=130 logistic", 4, 1, 130, "logistic", _F32, 1.0, True),
    ("B=33 p=4101 ADMM", 2, 33, 4101, "squared", _F32, 1.0, True),
    ("logistic |pred|~1e3", 4, 257, 130, "logistic", _F32, 1e3, True),
    # the row split: a ragged last range, more ranks than tiles, and
    # 74-byte bf16 rows (not 16-byte aligned) at S=8
    ("split ragged L=2 B=2001 p=200 log", 2, 2001, 200, "logistic", _F32, 1.0,
     True),
    ("split S=8 > tiles L=1 B=70", 1, 70, 200, "squared", _F32, 1.0,
     True),
    ("split unaligned L=1 B=20000 p=37", 1, 20000, 37, "squared", _BF16, 1.0,
     False))
# cases launched with a split the plan would not pick (more ranks than
# tiles), by name
PROX_SPLIT = {"split S=8 > tiles L=1 B=70": 8}

# phase 3's edge cases of mtl_score: name, B, p, m, r, code dtype, X and
# U dtype, ids out of range.  p inside one warp's first copy; rows
# 16-byte aligned or not (p=1001 bf16: every eighth row; p=2047 bf16:
# none); every rank the kernel takes; B=77 and 33 leave a warp part of
# its rows at 4 rows a warp
SCORE_EDGES = (
    ("bf16 X,U f32 table", 256, P, M, R, "f32", _BF16, False),
    ("bf16 X,U int8 table", 256, P, M, R, "int8", _BF16, False),
    ("ragged B=77 p=2047 f32", 77, 2047, 50, 3, "f32", _F32, False),
    ("ragged B=77 p=2047 fp8 bf16", 77, 2047, 50, 3, "fp8", _BF16, False),
    ("r=8 B=33 p=520 int8", 33, 520, 9, 8, "int8", _F32, False),
    ("clamp B=64 f32", 64, P, M, R, "f32", _F32, True),
    ("clamp B=64 fp8", 64, P, M, R, "fp8", _F32, True),
    ("p=100 B=64 f32", 64, 100, 9, 4, "f32", _F32, False),
    ("p=5 B=300 bf16 int8", 300, 5, 9, 4, "int8", _BF16, False),
    ("unaligned B=40 p=1001 bf16", 40, 1001, 20, 4, "int8", _BF16, False),
) + tuple((f"r={r} B=100 p=300", 100, 300, 9, r, ("f32", "int8", "fp8")[r % 3],
           _F32 if r % 2 else _BF16, False) for r in range(1, 9))


def score_rw4_plan(score_kernel, B):
    """The launch of B rows at 4 rows a warp and 2 warps a row (16 rows a
    CTA), the plan of the served waves of 528 rows or more, forced at
    phase 3's edge shapes, which the plan gives one row a warp."""
    rows = score_kernel.WARPS // 2 * 4
    return score_kernel.Plan(2, 4, rows, -(-B // rows))


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
    return bound_ms(nbytes, flops)


def bound_ms(nbytes, flops):
    """The larger of bytes over the memory rate and flops over the f32
    rate, in ms, with the one that bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def grad_bound_ms(m, n, p, x_bytes):
    """Least time for one ``task_gradients`` call: X, y and W read once,
    G written once, against a dot and an axpy per element of X."""
    return bound_ms(m * n * p * x_bytes + 4 * m * n + 8 * m * p,
                    4 * m * n * p)


# ---------------------------------------------------------------------------
# §5 simulation data (the reference's data/synthetic.py construction),
# drawn with a seeded numpy generator on the host so that the CPU tests
# rebuild the same draw; the products run on ``device``
# ---------------------------------------------------------------------------
def sim_data(p, m, r, n, seed, device, task="regression", noise=1.0,
             corr_decay=1.0):
    """(Xs (m,n,p), ys (m,n), W* (p,m), Sigma (p,p)) f32 tensors on
    ``device``: W* = U diag(1.5^-i) Vᵀ from the port's top-r factors of
    A Bᵀ (A, B standard normal), x ~ N(0, Sigma) with
    Sigma_ab = 2^(-c|a-b|), y = <w*_j, x> + noise·N(0,1) (regression) or
    ±1 with P(+1) = sigmoid(<w*_j, x>) (classification)."""
    from repro_torch.core.spectral import truncate_factors
    rng = np.random.default_rng(seed)
    f32 = np.float32
    A = rng.standard_normal((p, r), dtype=f32)
    B = rng.standard_normal((m, r), dtype=f32)
    Z = rng.standard_normal((m, n, p), dtype=f32)
    if task == "regression":
        eps = rng.standard_normal((m, n), dtype=f32)
    elif task == "classification":
        eps = rng.random((m, n), dtype=f32)
    else:
        raise ValueError(task)
    idx = np.arange(p)
    Sigma = (2.0 ** (-corr_decay * np.abs(idx[:, None] - idx[None, :])))
    chol = np.linalg.cholesky(Sigma + 1e-9 * np.eye(p)).astype(f32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    U, _, V = truncate_factors(dev(A) @ dev(B).T, r)
    s = (1.0 / 1.5) ** torch.arange(r, dtype=torch.float32, device=U.device)
    Wstar = (U * s[None, :]) @ V.T
    Xs = dev(Z) @ dev(chol).T
    del Z
    margins = torch.einsum("mnp,pm->mn", Xs, Wstar)
    if task == "regression":
        ys = margins + noise * dev(eps)
    else:
        ys = torch.where(dev(eps) < torch.sigmoid(margins), 1.0, -1.0)
    return Xs, ys, Wstar, dev(Sigma.astype(f32))


def excess_risk(W, Wstar, Sigma) -> float:
    """E L(W) - E L(W*) = (1/2m) sum_j (w_j - w*_j)ᵀ Sigma (w_j - w*_j)."""
    D = W - Wstar
    return float(0.5 * torch.mean(torch.einsum("pm,pq,qm->m", D, Sigma, D)))


# The reference's Fig-1 methods and hyper-parameters
# (benchmarks/fig1_regression.py METHODS), and its claims check.
FIG1 = dict(p=100, m=30, r=5, n=50)
FIG1_SEED = 0
FIG1_METHODS = [
    ("local", {}),
    ("centralize", {"lam": 0.02}),
    ("bestrep", {}),
    ("proxgd", {"lam": 0.02, "rounds": 80, "record_every": 2}),
    ("accproxgd", {"lam": 0.02, "rounds": 80, "record_every": 2}),
    ("admm", {"lam": 0.02, "rho": 0.5, "rounds": 80, "record_every": 2}),
    ("dfw", {"rounds": 80, "record_every": 2}),
    ("dgsp", {"rounds": 10}),
    ("dnsp", {"rounds": 10, "damping": 0.5, "l2": 1e-3}),
    ("svd_trunc", {}),
]


def rounds_to_target(curve, target: float) -> int:
    for rnd, e in curve:
        if e <= target:
            return rnd
    return 10 ** 9


def check_claims(curves, label: str) -> None:
    """The paper's Fig-1 claims on the validation-selected (best-on-curve)
    point of each method: nuclear-norm centralize and DNSP beat Local,
    and DNSP reaches 1.5x centralize's error in no more rounds than
    ProxGD or DFW."""
    best = {k: min(e for _, e in v) for k, v in curves.items()}
    check(best["centralize"] < best["local"],
          f"{label}: nuclear norm should beat Local")
    check(best["dnsp"] < best["local"], f"{label}: DNSP should beat Local")
    target = 1.5 * best["centralize"]
    r_dnsp = rounds_to_target(curves["dnsp"], target)
    r_proxgd = rounds_to_target(curves["proxgd"], target)
    r_dfw = rounds_to_target(curves["dfw"], target)
    check(r_dnsp <= r_proxgd, f"{label}: DNSP ({r_dnsp}) should need <= "
          f"rounds than ProxGD ({r_proxgd})")
    check(r_dnsp <= r_dfw, f"{label}: DNSP vs DFW ({r_dnsp} vs {r_dfw})")


def fig1_curves(solve, prob, Wstar, Sigma, U_star):
    """Excess-risk curves of the ten Fig-1 methods through ``solve``."""
    curves = {}
    for name, kw in FIG1_METHODS:
        extra = {"U_star": U_star} if name == "bestrep" else {}
        res = solve(prob, method=name, **kw, **extra)
        curves[name] = [(rnd, excess_risk(W, Wstar, Sigma))
                        for rnd, W in zip(res.rounds_axis, res.iterates)]
    return curves


def profile_kernels(fn):
    """Device kernel time by name that ``torch.profiler`` records while
    ``fn()`` runs, and the wall time of that window in µs (the
    profiler's per-op cost is inside the window, its start and its
    export are not)."""
    from repro_torch.obs.tracing import TORCH_TRACE_JSON, profiler_session
    with tempfile.TemporaryDirectory() as tdir:
        with profiler_session(tdir):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        events = json.loads((pathlib.Path(tdir) / TORCH_TRACE_JSON).read_text())
    kernels = {}
    for ev in events.get("traceEvents", []):
        if ev.get("cat") == "kernel":
            kernels[ev["name"]] = kernels.get(ev["name"], 0.0) + ev["dur"]
    return kernels, window_us


def describe_profile(kernels, window_us, top=5) -> str:
    busy_us = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return (f"device busy {busy_us:.1f} us of {window_us:.1f} us wall "
            f"({100 * busy_us / window_us:.2f} %); by kernel: "
            + ("; ".join(f"{name[:60]} {us:.1f} us" for name, us in ranked)
               if ranked else "no device kernels recorded (not measured)"))


def build_all(kernels) -> dict:
    """One ``nvcc`` per source (a kernel module's ``SOURCES``, else its
    ``SOURCE``), all started together; log each build's time and
    ``ptxas`` summary, and return it by library."""
    from repro_torch.kernels import _build
    libs = {lib: src for name, k in kernels.items()
            for lib, src in getattr(k, "SOURCES", {name: k.SOURCE}).items()}

    def one(lib):
        t0 = time.perf_counter()
        _build.build(lib, libs[lib])
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        secs = dict(zip(libs, pool.map(one, libs)))
    info = {}
    for lib, src in libs.items():
        path = _build.library_path(lib, src)
        ptxas = path.with_suffix(".log").read_text()
        regs = sorted({int(v) for v in re.findall(r"Used (\d+) registers", ptxas)})
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores", ptxas))
        info[lib] = {"build_s": secs[lib], "registers": regs,
                     "spill_store_bytes": spills}
        log(f"[build] {lib}: {path.relative_to(REPO)} in {secs[lib]:.2f} s; "
            f"{len(re.findall('Used', ptxas))} instantiations, registers "
            f"{regs[0]}-{regs[-1]}, {spills} bytes spilled")
        for line in ptxas.splitlines():
            if "Used" in line or "Potential Performance Loss" in line:
                log(f"[ptxas] {lib}: {line.strip()}")
    return info


# ---------------------------------------------------------------------------
# phase 3, mtl_grad
# ---------------------------------------------------------------------------
def grad_inputs(gen, m, n, p, loss, x_dtype, w_scale=1.0, dev="cuda"):
    X = torch.randn(m, n, p, generator=gen, device=dev).to(x_dtype)
    y = torch.randn(m, n, generator=gen, device=dev)
    if loss == "logistic":
        y = torch.where(y >= 0, 1.0, -1.0)
    W = w_scale * torch.randn(m, p, generator=gen, device=dev) / math.sqrt(p)
    return X, y, W


def grad_library(X, y, W, loss):
    """The library yardstick: two batched gemms around the loss
    derivative (reads X twice).  The port never calls it."""
    pred = torch.bmm(X, W.unsqueeze(2)).squeeze(2)
    r = pred - y if loss == "squared" else -y * torch.sigmoid(-y * pred)
    return torch.bmm(r.unsqueeze(1), X).squeeze(1) / X.shape[1]


GRAD_MAIN = (("FULLSP squared", FULLSP["m"], FULLSP["n"], FULLSP["p"], "squared"),
             ("FULL logistic", FULL["m"], FULL["n"], FULL["p"], "logistic"),
             ("FULL2D logistic", FULL2D["m"], FULL2D["n"], FULL2D["p"],
              "logistic"))
# name, m, n, p, loss, X dtype, W scale: the edge shapes, the row
# split's (a ragged last range, more ranks than tiles, 74-byte bf16 rows
# at S=8) and the widest rows (a ring of one stage)
GRAD_EDGES = (
    ("ragged m=3 n=300 p=37 squared", 3, 300, 37, "squared", _F32, 1.0),
    ("ragged m=3 n=300 p=37 logistic", 3, 300, 37, "logistic", _F32, 1.0),
    ("m=1 n=1 p=5 logistic", 1, 1, 5, "logistic", _F32, 1.0),
    ("n=513 p=2047 bf16 squared", 2, 513, 2047, "squared", _BF16, 1.0),
    ("n=33 p=4101 logistic", 2, 33, 4101, "logistic", _F32, 1.0),
    ("logistic |pred|~1e3", 4, 257, 130, "logistic", _F32, 1e3),
    ("split ragged m=2 n=2001 p=200 log", 2, 2001, 200, "logistic", _F32, 1.0),
    ("split S=8 > tiles m=1 n=70", 1, 70, 200, "squared", _F32, 1.0),
    ("split unaligned m=1 n=20000 p=37", 1, 20000, 37, "squared", _BF16, 1.0),
    ("p=16384 (one stage) m=2 n=5", 2, 5, 16384, "logistic", _F32, 1.0))
GRAD_SPLIT = {"split S=8 > tiles m=1 n=70": 8}


def forced_plan(kernel_mod, X, split):
    """The plan for X with ``split`` ranks a task, whatever the plan picks."""
    pl = kernel_mod.plan_for(X)
    return pl._replace(split=split, ctas=X.shape[0] * split)


def plan_line(pl) -> str:
    return (f"S={pl.split}, {pl.ctas} CTAs, tile {pl.tile_rows} rows, "
            f"{pl.stages} stages, {pl.smem_bytes} B shared")


def grad_kernel_phase(gen):
    """mtl_grad against its plain version at the solver paths' shapes and
    at edge shapes (each launched twice: the bytes must not move; the
    split's cases must run at S > 1), then its times at the main shapes
    beside the library's, each with its plan."""
    from repro_torch.kernels.mtl_grad import kernel as grad_kernel
    from repro_torch.kernels.mtl_grad import ops as grad_ops
    from repro_torch.kernels.mtl_grad.ref import task_gradients_ref
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(name, m, n, p, loss, f32, 1.0) for name, m, n, p, loss in GRAD_MAIN]
    cases += [(name + " bf16 X", m, n, p, loss, bf16, 1.0)
              for name, m, n, p, loss in GRAD_MAIN]
    cases += list(GRAD_EDGES)
    max_abs_err = 0.0
    for name, m, n, p, loss, xdt, ws in cases:
        X, y, W = grad_inputs(gen, m, n, p, loss, xdt, ws)
        if name in GRAD_SPLIT:
            pl = forced_plan(grad_kernel, X, GRAD_SPLIT[name])
            G = grad_kernel.launch(X, y, W, loss, plan=pl)
            G2 = grad_kernel.launch(X, y, W, loss, plan=pl)
        else:
            pl = grad_kernel.plan_for(X)
            G = grad_ops.task_gradients(X, y, W, loss=loss)
            G2 = grad_ops.task_gradients(X, y, W, loss=loss)
        ref = task_gradients_ref(X, y, W, loss=loss)
        torch.cuda.synchronize()
        check(G.shape == (m, p) and G.dtype == f32 and
              bool(torch.isfinite(G).all()), f"{name}: bad output")
        check(torch.equal(G, G2), f"{name}: two launches gave different bytes")
        check(pl.split > 1 or not name.startswith("split"),
              f"{name}: ran at S=1, not split")
        scale = float(ref.abs().max())
        err = float((G - ref).abs().max())
        log(f"[kernel] mtl_grad {name:34s} S={pl.split} max|err| {err:.3e} / "
            f"max|G| {scale:.3e} (tol {GRAD_RTOL:g} x max|G|); relaunch "
            f"bitwise equal")
        check(err <= GRAD_RTOL * scale, f"{name}: kernel disagrees with the "
              f"plain version: {err} > {GRAD_RTOL} * {scale}")
        if xdt == f32 and (m, n, p) in {(c[1], c[2], c[3]) for c in GRAD_MAIN}:
            max_abs_err = max(max_abs_err, err)
        del X, y, W, G, G2, ref
    rows = []
    for name, m, n, p, loss in GRAD_MAIN:
        X, y, W = grad_inputs(gen, m, n, p, loss, f32)
        pl = grad_kernel.plan_for(X)
        log(f"[plan] mtl_grad {name}: {plan_line(pl)}")

        def kern():
            return grad_ops.task_gradients(X, y, W, loss=loss)

        k_ms = time_ms(kern, reps=20, inner=10)
        g_ms = graph_ms(kern, reps=20, inner=10)
        p_ms = time_ms(lambda: task_gradients_ref(X, y, W, loss=loss),
                       reps=20, inner=10)
        lib_ms = time_ms(lambda: grad_library(X, y, W, loss), reps=20, inner=10)
        lib_g_ms = graph_ms(lambda: grad_library(X, y, W, loss), reps=20,
                            inner=10)
        b_ms, b_by = grad_bound_ms(m, n, p, 4)
        rows.append({"shape": {"m": m, "n": n, "p": p, "loss": loss,
                               "x_dtype": "f32"},
                     "plan": pl._asdict(),
                     "kernel_ms": k_ms, "kernel_graph_ms": g_ms,
                     "plain_ms": p_ms, "library_ms": lib_ms,
                     "library_graph_ms": lib_g_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
        log(f"[time] mtl_grad {name:15s} kernel {k_ms * 1e3:9.2f} us (graph "
            f"{g_ms * 1e3:9.2f} us)  plain {p_ms * 1e3:9.2f} us  library "
            f"{lib_ms * 1e3:9.2f} us (graph {lib_g_ms * 1e3:9.2f} us)  bound "
            f"{b_ms * 1e3:8.3f} us ({b_by}); "
            f"{m * n * p * 4 / (g_ms * 1e-3) / 1e12:.2f} TB/s of X; device "
            f"{g_ms / lib_g_ms:.3f}x the library's")
        del X, y, W
    torch.cuda.synchronize()
    return rows, max_abs_err


# ---------------------------------------------------------------------------
# phase 3, prox_step and the sampler
# ---------------------------------------------------------------------------
def prox_inputs(gen, L, n, p, loss, x_dtype, w_scale=1.0, admm=False,
                dev="cuda"):
    """X, y, W as for mtl_grad; Z, Q random for the ADMM form, else the
    ProxGD form's Z = W, Q = 0."""
    X, y, W = grad_inputs(gen, L, n, p, loss, x_dtype, w_scale, dev)
    if admm:
        Z = torch.randn(L, p, generator=gen, device=dev) / math.sqrt(p)
        Q = 0.1 * torch.randn(L, p, generator=gen, device=dev)
    else:
        Z, Q = W, torch.zeros_like(W)
    return X, y, W, Z, Q


def prox_error(out, ref, W):
    """``out`` against the plain version's ``ref``: the largest error,
    the scale it is held to (max(1, max|W_new|)) and the step's own
    largest entry max|W - W_new| (how large the kernel's terms are)."""
    err = float((out - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    step = float((W.float() - ref).abs().max())
    return err, scale, step


def prox_library(X, y, W, Z, Q, eta, rho, inv_m, l2, loss):
    """The library yardstick: two batched gemms around the loss
    derivative, then the step (reads X twice, writes the gradient).  The
    port never calls it."""
    pred = torch.bmm(X, W.unsqueeze(2)).squeeze(2)
    r = pred - y if loss == "squared" else -y * torch.sigmoid(-y * pred)
    g = torch.bmm(r.unsqueeze(1), X).squeeze(1) / X.shape[1] + l2 * W
    return W - eta * (g * inv_m + Q + rho * (W - Z))


def prox_bound_ms(L, n, p, x_bytes):
    """Least time for one ``prox_step`` call: X, y, W, Z, Q read once,
    the stepped W written once, against a dot and an axpy per element of
    X plus the step."""
    return bound_ms(L * n * p * x_bytes + 4 * L * n + 4 * L * p * 4,
                    4 * L * n * p + 8 * L * p)


def prox_kernel_phase(gen):
    """prox_step against its plain version at path D's and FULLSP-
    stochastic's shapes and at edge shapes (each launched twice: the
    bytes must not move), then its times at the two main shapes."""
    from repro_torch.kernels.mtl_grad import kernel as grad_kernel
    from repro_torch.kernels.prox_step import kernel as prox_kernel
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.prox_step.ref import prox_step_ref
    f32 = torch.float32
    D = PROX_DESCENT
    max_abs_err = 0.0
    for name, L, n, p, loss, xdt, ws, admm in PROX_CASES:
        X, y, W, Z, Q = prox_inputs(gen, L, n, p, loss, xdt, ws, admm)
        args = PROX_ADMM if admm else D
        if name in PROX_SPLIT:
            pl = forced_plan(grad_kernel, X, PROX_SPLIT[name])
            scalars = [args[k] for k in ("eta", "rho", "inv_m", "l2")]
            out = prox_kernel.launch(X, y, W, Z, Q, *scalars, loss, plan=pl)
            out2 = prox_kernel.launch(X, y, W, Z, Q, *scalars, loss, plan=pl)
        else:
            pl = grad_kernel.plan_for(X)
            out = prox_ops.prox_step(X, y, W, Z, Q, loss=loss, **args)
            out2 = prox_ops.prox_step(X, y, W, Z, Q, loss=loss, **args)
        ref = prox_step_ref(X, y, W, Z, Q, loss=loss, **args)
        torch.cuda.synchronize()
        check(out.shape == (L, p) and out.dtype == f32 and
              bool(torch.isfinite(out).all()), f"{name}: bad output")
        check(torch.equal(out, out2), f"{name}: two launches gave different "
              f"bytes")
        check(pl.split > 1 or not name.startswith("split"),
              f"{name}: ran at S=1, not split")
        err, scale, step = prox_error(out, ref, W)
        log(f"[kernel] prox_step {name:32s} S={pl.split} max|err| {err:.3e} / "
            f"max(1, max|W_new|) {scale:.3e} (tol {PROX_RTOL:g} x that = "
            f"{PROX_RTOL * scale / step:.1e} of max|W - W_new| {step:.3e}); "
            f"relaunch bitwise equal")
        check(err <= PROX_RTOL * scale, f"{name}: kernel disagrees with the "
              f"plain version: {err} > {PROX_RTOL} * {scale}")
        if name in ("path D squared", "path D logistic", "FULLSP-stochastic"):
            max_abs_err = max(max_abs_err, err)
        del X, y, W, Z, Q, out, out2, ref
    rows = []
    for name, L, n, p, loss in PROX_MAIN:
        X, y, W, Z, Q = prox_inputs(gen, L, n, p, loss, f32)
        pl = grad_kernel.plan_for(X)
        log(f"[plan] prox_step {name}: {plan_line(pl)}")

        def kern():
            return prox_ops.prox_step(X, y, W, Z, Q, loss=loss, **D)

        k_ms = time_ms(kern, reps=20, inner=10)
        g_ms = graph_ms(kern, reps=20, inner=10)
        p_ms = time_ms(lambda: prox_step_ref(X, y, W, Z, Q, loss=loss, **D),
                       reps=20, inner=10)
        lib_ms = time_ms(lambda: prox_library(X, y, W, Z, Q, loss=loss, **D),
                         reps=20, inner=10)
        lib_g_ms = graph_ms(lambda: prox_library(X, y, W, Z, Q, loss=loss,
                                                 **D), reps=20, inner=10)
        b_ms, b_by = prox_bound_ms(L, n, p, 4)
        rows.append({"shape": {"L": L, "B": n, "p": p, "loss": loss,
                               "x_dtype": "f32"},
                     "plan": pl._asdict(),
                     "kernel_ms": k_ms, "kernel_graph_ms": g_ms,
                     "plain_ms": p_ms, "library_ms": lib_ms,
                     "library_graph_ms": lib_g_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
        log(f"[time] prox_step {name:17s} kernel {k_ms * 1e3:9.2f} us (graph "
            f"{g_ms * 1e3:9.2f} us)  plain {p_ms * 1e3:9.2f} us  library "
            f"{lib_ms * 1e3:9.2f} us (graph {lib_g_ms * 1e3:9.2f} us)  bound "
            f"{b_ms * 1e3:8.3f} us ({b_by}); "
            f"{L * n * p * 4 / (g_ms * 1e-3) / 1e12:.2f} TB/s of X; device "
            f"{g_ms / lib_g_ms:.3f}x the library's")
        del X, y, W, Z, Q
    torch.cuda.synchronize()
    return rows, max_abs_err


def sampler_phase():
    """``batch_indices`` on the card against the CPU, bit for bit, at path
    D's draws (rounds {0, 7} x local steps {0, 3}), and the host time of
    one draw on the card at path D's and FULLSP-stochastic's shapes."""
    from repro_torch.core.worker_ops import batch_indices
    m, n = FULL2D["m"], FULL2D["n"]
    ids = torch.arange(m, dtype=torch.int32)
    for k in (0, 7):
        for step in (0, 3):
            card = batch_indices(0, ids.cuda(), k, step, D_BATCH, n)
            host = batch_indices(0, ids, k, step, D_BATCH, n)
            check(card.device.type == "cuda" and
                  torch.equal(card.cpu(), host),
                  f"sampler: card and CPU rows differ at round {k}, step {step}")
    out = {}
    for label, tasks, B, n_rows in (("path D", m, D_BATCH, n),
                                    ("FULLSP-stochastic", 768, 32, 64)):
        tid = torch.arange(tasks, dtype=torch.int32, device="cuda")
        for i in range(3):
            batch_indices(0, tid, i, 0, B, n_rows)
        torch.cuda.synchronize()
        reps = 30
        t0 = time.perf_counter()
        for i in range(reps):
            batch_indices(0, tid, i, 1, B, n_rows)
        torch.cuda.synchronize()
        out[label] = {"tasks": tasks, "B": B,
                      "draw_ms": (time.perf_counter() - t0) / reps * 1e3}
    log(f"[sampler] card == CPU bitwise at path D's draws (rounds 0, 7 x steps "
        f"0, 3; m={m}, B={D_BATCH}, n={n}); one draw on the card: "
        + ", ".join(f"{k} (m={v['tasks']}, B={v['B']}) {v['draw_ms']:.3f} ms"
                    for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# phases 6-9, the solver paths
# ---------------------------------------------------------------------------
def timed_solve(solve, prob, **kw):
    t0 = time.perf_counter()
    res = solve(prob, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def path_a(score_ops, grad_ops):
    """The squared raw path at FULLSP: lazy and exact ProxGD, 50 and 25
    rounds, then the solve feeds the slice-1 server on the card."""
    import repro_torch
    from repro_torch.core.methods import MTLProblem
    from repro_torch.core.methods.convex import data_smoothness
    from repro_torch.serve.mtl import MTLServer
    sp = FULLSP
    p, m, n, r, rounds = sp["p"], sp["m"], sp["n"], sp["r"], sp["rounds"]
    half = rounds // 2
    t0 = time.perf_counter()
    Xs, ys, _, _ = sim_data(p, m, r, n, SEED, "cuda", noise=sp["noise"])
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    grad_ops.task_gradients.launches = 0       # count this path only
    score_ops.mtl_score.launches = 0
    prob = MTLProblem.make(Xs, ys, "squared", gram=False, A=2.0, r=r)
    eta = 1.0 / data_smoothness(prob)          # once, shared by both engines
    log(f"[path A] FULLSP p={p} m={m} n={n} r={r}: data {t_data:.2f} s on "
        f"the host and the card, {Xs.numel() * 4 / 1e6:.1f} MB of designs; "
        f"eta {eta:.6g}")
    out, res = {"t_data_s": t_data, "eta": eta}, {}
    kw = dict(method="proxgd", lam=sp["lam"], eta=eta, init="zeros",
              sv_rank=sp["sv_rank"])
    for engine in ("lazy", "exact"):
        secs = {}
        for R_ in (rounds, half):
            n0 = grad_ops.task_gradients.launches
            res[engine, R_], secs[R_] = timed_solve(
                repro_torch.solve, prob, rounds=R_, sv_engine=engine, **kw)
            got = grad_ops.task_gradients.launches - n0
            check(got == R_, f"path A {engine} {R_} rounds launched mtl_grad "
                  f"{got} times, want {R_}")
        per_round = (secs[rounds] - secs[half]) / (rounds - half)
        out[engine] = {"solve_s": secs[rounds], "half_s": secs[half],
                       "round_s": per_round, "rounds_per_s": 1.0 / per_round,
                       "sv_exact_rounds":
                           res[engine, rounds].extras.get("sv_exact_rounds")}
        log(f"[path A] proxgd {engine:5s}: {rounds} rounds {secs[rounds]:.3f} s, "
            f"{half} rounds {secs[half]:.3f} s -> {per_round * 1e3:.3f} ms per "
            f"round ({1.0 / per_round:.1f} rounds/s); exact-SVD rounds "
            f"{out[engine]['sv_exact_rounds']}; mtl_grad launches = rounds")
    lazy, exact = res["lazy", rounds], res["exact", rounds]
    diff = float((lazy.W - exact.W).abs().max())
    check(diff <= SPECTRAL_W_TOL, f"path A: lazy W drifted from exact by {diff}")
    want = [e for k in range(1, rounds + 1)
            for e in ((k, "worker->master", 1, p, "gradient column"),
                      (k, "master->worker", 1, p, "updated predictor"))]
    check(lazy.comm.ledger() == exact.comm.ledger() == want,
          "path A: ledger is not 50 x (1 p-vector up, 1 down)")
    check(bool(torch.isfinite(lazy.W).all()) and lazy.W.shape == (p, m),
          "path A: bad W")
    out["lazy_vs_exact_max_abs"] = diff
    log(f"[path A] lazy vs exact max|dW| {diff:.3e} (tol {SPECTRAL_W_TOL:g}); "
        f"ledgers equal, {rounds} x (1 p-vector up, 1 down)")

    # the solve feeds the slice-1 server on the card
    model = lazy.factorize(r)
    check(model.device.type == "cuda", "path A: factorize left the card")
    server = MTLServer(model, batch_size=WAVE)
    rng = np.random.default_rng(SEED + 1)
    ids = torch.from_numpy(rng.integers(0, m, WAVE).astype(np.int32)).cuda()
    X = torch.from_numpy(rng.standard_normal((WAVE, p), dtype=np.float32)).cuda()
    n0 = score_ops.mtl_score.launches
    scores, _ = server.score(ids, X)
    torch.cuda.synchronize()
    own = (X * model.dense().index_select(1, ids.long()).T).sum(1)
    err = float((scores - own).abs().max())
    scale = float(own.abs().max())
    check(score_ops.mtl_score.launches - n0 == 1 and
          err <= SERVE_RTOL * scale, f"path A: served wave {err} > "
          f"{SERVE_RTOL} * {scale}")
    out["launches"] = {"mtl_grad": grad_ops.task_gradients.launches,
                       "mtl_score": score_ops.mtl_score.launches}
    log(f"[path A] factorize({r}) -> MTLServer -> {WAVE} requests in one "
        f"launch: vs dense predictor max|err| {err:.3e} (tol {SERVE_RTOL:g} x "
        f"{scale:.3e}); path launches {out['launches']}")

    kernels, window_us = profile_kernels(lambda: repro_torch.solve(
        prob, rounds=rounds, sv_engine="lazy", **kw))
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    out["profile"] = {"window_us": window_us, "kernel_us_top": top,
                      "device_busy_us": sum(kernels.values()),
                      "device_busy_share": sum(kernels.values()) / window_us
                      if kernels else None}
    log(f"[path A] profiled one lazy {rounds}-round solve: "
        + describe_profile(kernels, window_us, top=8))
    return out, {"prob": prob, "kw": dict(kw, rounds=rounds,
                                          sv_engine="lazy")}


def path_b(grad_ops):
    """The logistic path at FULL: DGSP and ProxGD on the card (raw
    gradients through mtl_grad) and through the port on the CPU."""
    import repro_torch
    from repro_torch.core.methods import MTLProblem
    Xs, ys, _, _ = sim_data(**FULL, seed=SEED, device="cuda",
                            task="classification")
    grad_ops.task_gradients.launches = 0
    prob = MTLProblem.make(Xs, ys, "logistic", A=2.0, r=FULL["r"])
    host = MTLProblem.make(Xs.cpu(), ys.cpu(), "logistic", A=2.0, r=FULL["r"],
                           device="cpu")
    out = {}
    for method, kw in FULL_METHODS:
        n0 = grad_ops.task_gradients.launches
        card, t_card = timed_solve(repro_torch.solve, prob, method=method, **kw)
        launched = grad_ops.task_gradients.launches - n0
        check(launched == kw["rounds"], f"path B {method}: {launched} mtl_grad "
              f"launches for {kw['rounds']} rounds")
        t0 = time.perf_counter()
        cpu = repro_torch.solve(host, method=method, device="cpu", **kw)
        t_cpu = time.perf_counter() - t0
        Wc = card.W.cpu()
        err = float((Wc - cpu.W).abs().max())
        tol = SOLVER_W_RTOL * max(1.0, float(cpu.W.abs().max()))
        check(bool(torch.isfinite(Wc).all()) and err <= tol,
              f"path B {method}: card W differs from the CPU's by {err} > {tol}")
        check(card.comm.ledger() == cpu.comm.ledger(),
              f"path B {method}: ledgers differ")
        out[method] = {"card_s": t_card, "cpu_s": t_cpu, "max_abs_err": err,
                       "tol": tol, "mtl_grad_launches": launched,
                       "sv_exact_rounds": [card.extras.get("sv_exact_rounds"),
                                           cpu.extras.get("sv_exact_rounds")]}
        log(f"[path B] {method:6s} {kw}: card {t_card:.3f} s, CPU {t_cpu:.3f} s;"
            f" max|W_card - W_cpu| {err:.3e} (tol {tol:.3e}); ledgers equal; "
            f"{launched} mtl_grad launches")
    out["launches"] = {"mtl_grad": grad_ops.task_gradients.launches}
    return out


def path_c(grad_ops):
    """The paper's Fig-1 claims at its base spec, on the card."""
    import repro_torch
    from repro_torch.core.methods import MTLProblem
    from repro_torch.serve.mtl import FactoredModel
    Xs, ys, Wstar, Sigma = sim_data(**FIG1, seed=FIG1_SEED, device="cuda")
    grad_ops.task_gradients.launches = 0
    t0 = time.perf_counter()
    prob = MTLProblem.make(Xs, ys, "squared", A=2.0, r=FIG1["r"])
    U_star = FactoredModel.from_W(Wstar, FIG1["r"]).U
    curves = fig1_curves(repro_torch.solve, prob, Wstar, Sigma, U_star)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check_claims(curves, "fig1/base on the card")
    best = {k: min(e for _, e in v) for k, v in curves.items()}
    log(f"[path C] Fig-1 base spec, ten methods in {secs:.2f} s; claims hold; "
        f"best excess risk " + ", ".join(f"{k} {v:.4f}" for k, v in best.items()))
    return {"s": secs, "best_excess_risk": best,
            "launches": {"mtl_grad": grad_ops.task_gradients.launches}}


def path_d(grad_ops, prox_ops):
    """Stochastic rounds at FULL2D on the card: data from the port's
    generator, the five stochastic solvers and AltMin, each held to its
    full-batch twin and to the port on the CPU."""
    import repro_torch
    from repro_torch.core import prng
    from repro_torch.core.linear_model import global_loss
    from repro_torch.core.methods import MTLProblem
    from repro_torch.data.synthetic import (SimSpec, excess_risk_classification,
                                            excess_risk_regression, generate)
    sp = FULL2D
    p, m, n, r = sp["p"], sp["m"], sp["n"], sp["r"]
    t0 = time.perf_counter()
    data = {}
    for loss, task in (("squared", "regression"),
                       ("logistic", "classification")):
        data[loss] = generate(prng.PRNGKey(sp["key"]),
                              SimSpec(p=p, m=m, r=r, n=n, task=task),
                              sample_chunks=sp["chunks"])
    torch.cuda.synchronize()
    t_data = time.perf_counter() - t0
    Xs, ys, Wstar, Sigma = data["squared"]
    Xc, yc, Wstar_c, _ = data["logistic"]
    check(Xs.device.type == "cuda" and bool(torch.isfinite(Xs).all()) and
          set(torch.unique(yc).tolist()) == {-1.0, 1.0}, "path D: bad data")
    grad_ops.task_gradients.launches = 0       # count this path only
    prox_ops.prox_step.launches = 0
    probs = {"squared": MTLProblem.make(Xs, ys, "squared", gram=False, A=2.0,
                                        r=r),
             "logistic": MTLProblem.make(Xc, yc, "logistic", A=2.0, r=r)}
    log(f"[path D] FULL2D p={p} m={m} n={n} r={r}: data (regression and "
        f"classification, {sp['chunks']} chunks each, PRNGKey({sp['key']})) "
        f"{t_data:.2f} s on the card, {Xs.numel() * 4 / 1e6:.1f} MB of "
        f"designs each")

    def risk(loss, W):
        if loss == "squared":
            return float(excess_risk_regression(W, Wstar, Sigma))
        return float(excess_risk_classification(prng.PRNGKey(11), W,
                                                Wstar_c, Sigma))

    def objective(prob, W, lam):
        """What ProxGD minimises: the mean task loss + lam * ||W||_*."""
        return float(global_loss(prob.loss, W, prob.Xs, prob.ys, prob.l2)
                     + lam * torch.linalg.svdvals(W).sum())

    zero = torch.zeros((p, m), device="cuda")
    out, solved = {}, []
    for method, loss, kw, L in D_SOLVES:
        prob, label = probs[loss], f"{method}/{loss}"
        R_ = kw["rounds"]
        sgd = dict(batch_size=D_BATCH, local_steps=L, batch_seed=0)
        full = repro_torch.solve(prob, method=method, **kw)
        if not solved:
            # B=n, L=1 folds to the full-batch program (stochastic_config);
            # once on the card, for the first solve
            degen = repro_torch.solve(prob, method=method, batch_size=n,
                                      local_steps=1, **kw)
            check(torch.equal(full.W, degen.W) and
                  full.comm.ledger() == degen.comm.ledger(),
                  f"path D {label}: B=n, L=1 is not the full-batch solve")
        n0 = prox_ops.prox_step.launches
        res, secs = timed_solve(repro_torch.solve, prob, method=method,
                                **sgd, **kw)
        launched = prox_ops.prox_step.launches - n0
        want = R_ * L if method in ("proxgd", "accproxgd", "admm") else 0
        check(launched == want, f"path D {label}: {launched} prox_step "
              f"launches, want {want}")
        check([e[:4] for e in res.comm.ledger()] ==
              [e[:4] for e in full.comm.ledger()] and
              res.extras["local_steps"] == L,
              f"path D {label}: ledger differs from the full-batch ledger")
        check(bool(torch.isfinite(res.W).all()), f"path D {label}: bad W")
        e_sgd, e_full, e_zero = (risk(loss, W) for W in (res.W, full.W, zero))
        if loss == "squared":
            check(e_sgd < e_zero, f"path D {label}: excess risk {e_sgd} is "
                  f"not below W=0's {e_zero}")
            progress = ""
        else:
            # constant-step stochastic logistic ProxGD ends above W=0's
            # risk, the reference's too (tests/test_torch_stochastic.py::
            # test_logistic_stochastic_proxgd_ends_above_zero_risk); it is
            # held to lowering its own objective from its start instead
            f0, f1 = (objective(prob, W, kw["lam"])
                      for W in (res.iterates[0], res.W))
            check(f1 < f0, f"path D {label}: objective {f1} is not below "
                  f"its start's {f0}")
            progress = f"; objective {f0:.4f} -> {f1:.4f}"
        half = R_ // 2
        _, secs_half = timed_solve(repro_torch.solve, prob, method=method,
                                   **sgd, **dict(kw, rounds=half))
        per_round = (secs - secs_half) / (R_ - half)
        out[label] = {"rounds": R_, "batch_size": D_BATCH, "local_steps": L,
                      "solve_s": secs, "half_s": secs_half,
                      "round_s": per_round, "rounds_per_s": 1.0 / per_round,
                      "prox_step_launches": launched,
                      "excess_risk": {"stochastic": e_sgd,
                                      "full_batch": e_full, "zero": e_zero}}
        log(f"[path D] {label:17s} B={D_BATCH} L={L} {R_} rounds {secs:.3f} s "
            f"({per_round * 1e3:.2f} ms per round, {1 / per_round:.1f} "
            f"rounds/s); {launched} prox_step launches; ledger = full batch"
            f"{'; B=n,L=1 bitwise full batch' if not solved else ''}; "
            f"excess risk {e_sgd:.4f} (full batch {e_full:.4f}, W=0 "
            f"{e_zero:.4f}){progress}")
        solved.append((label, method, loss, res, kw, L))

    # AltMin on the logistic copy: its U-step goes through mtl_grad
    g0 = grad_ops.task_gradients.launches
    alt, secs = timed_solve(repro_torch.solve, probs["logistic"],
                            method="altmin", **D_ALTMIN)
    launched = grad_ops.task_gradients.launches - g0
    e_alt, e_zero = risk("logistic", alt.W), risk("logistic", zero)
    want = D_ALTMIN["rounds"] * D_ALTMIN["u_grad_steps"]
    check(launched == want and e_alt < e_zero and
          bool(torch.isfinite(alt.W).all()),
          f"path D altmin: {launched} mtl_grad launches, excess risk {e_alt} "
          f"vs W=0's {e_zero}")
    out["altmin/logistic"] = {"rounds": D_ALTMIN["rounds"], "solve_s": secs,
                              "mtl_grad_launches": launched,
                              "excess_risk": {"altmin": e_alt, "zero": e_zero}}
    log(f"[path D] altmin/logistic {D_ALTMIN['rounds']} rounds {secs:.3f} s; "
        f"{launched} mtl_grad launches; excess risk {e_alt:.4f} (W=0 "
        f"{e_zero:.4f})")
    out["launches"] = {"prox_step": prox_ops.prox_step.launches,
                       "mtl_grad": grad_ops.task_gradients.launches}
    check(out["launches"]["prox_step"] > 0 and out["launches"]["mtl_grad"] > 0,
          "path D never launched prox_step or mtl_grad")

    kernels, window_us = profile_kernels(lambda: repro_torch.solve(
        probs["squared"], method="proxgd", batch_size=D_BATCH, local_steps=4,
        batch_seed=0, rounds=10, lam=0.01))
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:12])
    out["profile"] = {"window_us": window_us, "kernel_us_top": top,
                      "device_busy_us": sum(kernels.values()),
                      "device_busy_share": sum(kernels.values()) / window_us
                      if kernels else None}
    log("[path D] profiled one stochastic proxgd solve (10 rounds x 4 local "
        "steps): " + describe_profile(kernels, window_us, top=8))
    # the same stochastic solves through the port on the CPU: the draws
    # are integer-identical, so only the f32 sum order differs
    hosts = {loss: MTLProblem.make(prob.Xs.cpu(), prob.ys.cpu(), loss,
                                   gram=False, A=2.0, r=r, device="cpu")
             for loss, prob in probs.items()}
    out["cpu_check"] = {}
    for label, method, loss, res, kw, L in solved:
        t0 = time.perf_counter()
        cpu = repro_torch.solve(hosts[loss], method=method,
                                batch_size=D_BATCH, local_steps=L,
                                batch_seed=0, device="cpu", **kw)
        t_cpu = time.perf_counter() - t0
        err = float((res.W.cpu() - cpu.W).abs().max())
        tol = SOLVER_W_RTOL * max(1.0, float(cpu.W.abs().max()))
        check(err <= tol and res.comm.ledger() == cpu.comm.ledger(),
              f"path D {label}: card W differs from the CPU's by {err} > {tol}")
        out["cpu_check"][label] = {"max_abs_err": err, "tol": tol,
                                   "cpu_s": t_cpu}
        log(f"[path D] {label} card vs CPU: max|dW| {err:.3e} (tol "
            f"{tol:.3e}); ledgers equal; CPU {t_cpu:.2f} s")
    out["t_data_s"] = t_data
    return out, {"probs": probs, "Wstar": Wstar, "Sigma": Sigma}


# ---------------------------------------------------------------------------
# phase 9b, the mesh runtime on a 1-rank NCCL group
# ---------------------------------------------------------------------------
MESH_D = 4                       # path D's data shards (solver_bench.py:133)
D2_SOLVES = (("proxgd", {"rounds": 10, "lam": 0.01}),   # bench_2d's pair
             ("dgsp", {"rounds": 6}))
D2_W_TOL = 1e-4                  # bench_2d's bound (solver_bench.py:160)


MESH_REPS = 3                    # timed solves of each configuration


def alternating_solves(solve, prob, rounds, configs, kernel):
    """Time solves of ``rounds`` rounds under each configuration (a dict
    of ``solve`` arguments by name), after a 1-round warm-up of each,
    the configurations taking turns, in alternating order, ``MESH_REPS``
    times.  Returns ``{name: (result, seconds a round of each solve,
    kernel launches a solve)}``; every solve of a configuration must give
    the same W bit for bit and launch the kernel as often."""
    for kw in configs.values():
        timed_solve(solve, prob, rounds=1, **kw)
    out = {name: [None, [], set()] for name in configs}
    for rep in range(MESH_REPS):
        for name in (list(configs) if rep % 2 == 0
                     else list(reversed(configs))):
            n0 = kernel.launches
            res, secs = timed_solve(solve, prob, rounds=rounds,
                                    **configs[name])
            row = out[name]
            row[2].add(kernel.launches - n0)
            if row[0] is None:
                row[0] = res
            check(torch.equal(res.W, row[0].W) and len(row[2]) == 1,
                  f"{name}: a repeated solve gave other bytes or launches")
            row[1].append(secs / rounds)
    return {name: (res, per_round, launches.pop())
            for name, (res, per_round, launches) in out.items()}


def round_line(per_round) -> str:
    """'median ms (min-max)' of seconds a round."""
    return (f"{statistics.median(per_round) * 1e3:.3f} ms "
            f"({min(per_round) * 1e3:.3f}-{max(per_round) * 1e3:.3f})")


def mesh_phase(grad_ops, prox_ops, score_ops, path_d_data):
    """The mesh runtime on the card: a 1-rank NCCL group on a file store
    (``init_cluster``) and a ``task_mesh`` over it, path B's DGSP and
    path D's stochastic ProxGD on ``backend="mesh"`` against the sim,
    path D at D=4 through the sim's 2-D emulation against D=1, and the
    sharded code table against the unsharded server."""
    import torch.distributed as dist
    import repro_torch
    from repro_torch.core.methods import MTLProblem
    from repro_torch.data.synthetic import excess_risk_regression
    from repro_torch.runtime import init_cluster, task_mesh
    from repro_torch.serve.mtl import FactoredModel, MTLServer
    out = {}
    store = tempfile.mkdtemp(prefix="mesh_store_")
    try:
        t0 = time.perf_counter()
        init_cluster(f"file://{store}/store", 1, 0, timeout_s=120)
        mesh = task_mesh()
        check(str(dist.get_backend()) == "nccl" and
              mesh.device_type == "cuda" and dist.get_world_size() == 1,
              f"mesh: want a 1-rank NCCL group, got {dist.get_backend()}")
        log(f"[mesh] 1-rank {dist.get_backend()} group on a file store, "
            f"mesh {tuple(mesh.mesh_dim_names)} of {mesh.size()} device(s), "
            f"up in {time.perf_counter() - t0:.2f} s")
        grad_ops.task_gradients.launches = 0      # count this path only
        prox_ops.prox_step.launches = 0
        score_ops.mtl_score.launches = 0

        def on_both(label, prob, method, rounds, kernel, kw):
            """The same solve on the sim and on the mesh: W bitwise, the
            same ledger, the mesh's counter by the rule, the same
            kernel launches (above 0); each one's time a round."""
            runs = alternating_solves(
                repro_torch.solve, prob, rounds,
                {"sim": dict(method=method, **kw),
                 "mesh": dict(method=method, backend="mesh", mesh=mesh,
                              **kw)}, kernel)
            (sim, r_sim, k_sim), (msh, r_msh, k_msh) = \
                runs["sim"], runs["mesh"]
            want = msh.comm.floats_by_direction("worker->master") * prob.m
            check(torch.equal(msh.W, sim.W) and
                  msh.comm.ledger() == sim.comm.ledger(),
                  f"mesh {label}: W or ledger differs from the sim's")
            check(msh.extras["collective_floats_per_chip"] == want > 0 and
                  msh.extras["data_collective_floats_per_chip"] == 0,
                  f"mesh {label}: collective floats "
                  f"{msh.extras['collective_floats_per_chip']}, want {want}")
            check(k_msh == k_sim > 0, f"mesh {label}: {k_msh} kernel "
                  f"launches a solve on the mesh, {k_sim} on the sim")
            log(f"[mesh] {label}: W bitwise the sim's, ledgers equal, "
                f"{want} collective floats; {k_msh} {kernel.__name__} "
                f"launches a solve on each; a round {round_line(r_msh)} on "
                f"the mesh, {round_line(r_sim)} on the sim (median and "
                f"range of {MESH_REPS} {rounds}-round solves each, in "
                f"turns)")
            return {"rounds": rounds, "launches_a_solve": k_msh,
                    "collective_floats_per_chip": want,
                    "mesh_round_s": r_msh, "sim_round_s": r_sim}

        # path B: FULL logistic, DGSP, raw gradients through mtl_grad
        Xs, ys, _, _ = sim_data(**FULL, seed=SEED, device="cuda",
                                task="classification")
        prob_b = MTLProblem.make(Xs, ys, "logistic", A=2.0, r=FULL["r"])
        out["B dgsp"] = on_both("path B dgsp/logistic", prob_b, "dgsp", 10,
                                grad_ops.task_gradients, {})
        # path D: FULL2D squared raw, stochastic ProxGD through prox_step
        probs = path_d_data["probs"]
        sgd = dict(lam=0.01, batch_size=D_BATCH, local_steps=4, batch_seed=0)
        out["D proxgd"] = on_both(
            f"path D proxgd/squared B={D_BATCH} L=4", probs["squared"],
            "proxgd", 10, prox_ops.prox_step, sgd)

        # path D at D=4 through the sim's 2-D emulation, as bench_2d runs
        # it (the Gram path); and the stochastic ProxGD there, each shard
        # drawing its own 125 rows through prox_step
        sq = probs["squared"]
        gram = MTLProblem.make(sq.Xs, sq.ys, "squared", A=2.0, r=sq.r)
        for method, kw in D2_SOLVES:
            kw = dict(kw)
            rounds = kw.pop("rounds")
            runs = alternating_solves(
                repro_torch.solve, gram, rounds,
                {"D=1": dict(method=method, **kw),
                 f"D={MESH_D}": dict(method=method, data_shards=MESH_D,
                                     **kw)}, grad_ops.task_gradients)
            (one, r1, _), (four, r4, _) = runs["D=1"], runs[f"D={MESH_D}"]
            err = float((one.W - four.W).abs().max())
            check(err < D2_W_TOL and one.comm.ledger() == four.comm.ledger()
                  and four.extras["data_shards"] == MESH_D and
                  four.extras["data_collective_floats_per_chip"] == 0 and
                  four.extras["collective_floats_per_chip"] == 0,
                  f"path D {method} at D={MESH_D}: max|dW| {err} vs D=1")
            out[f"D{MESH_D} {method}"] = {
                "rounds": rounds, "max_abs_diff_vs_d1": err,
                "d1_round_s": r1, "d4_round_s": r4}
            log(f"[mesh] path D {method}/squared (Gram) at D={MESH_D} on "
                f"the sim's emulation: max|W - W_D1| {err:.3e} (tol "
                f"{D2_W_TOL:g}), ledger = D=1's, 0 data floats; a round "
                f"{round_line(r4)} at D={MESH_D}, {round_line(r1)} at D=1")
        runs = alternating_solves(
            repro_torch.solve, sq, 10,
            {"D=1": dict(method="proxgd", **sgd),
             f"D={MESH_D}": dict(method="proxgd", data_shards=MESH_D,
                                 **sgd)}, prox_ops.prox_step)
        (one, r1, k1), (four, r4, k4) = runs["D=1"], runs[f"D={MESH_D}"]
        e4, e0 = (float(excess_risk_regression(W, path_d_data["Wstar"],
                                               path_d_data["Sigma"]))
                  for W in (four.W, torch.zeros_like(four.W)))
        check(four.comm.ledger() == one.comm.ledger() and k1 == 10 * 4 and
              k4 == 10 * 4 * MESH_D and bool(torch.isfinite(four.W).all())
              and e4 < e0,
              f"path D stochastic proxgd at D={MESH_D}: {k4} prox_step "
              f"launches a solve, excess risk {e4} vs W=0's {e0}")
        out[f"D{MESH_D} proxgd B={D_BATCH} L=4"] = {
            "d1_round_s": r1, "d4_round_s": r4, "excess_risk": e4,
            "zero_risk": e0, "prox_step_launches_a_solve": k4}
        log(f"[mesh] path D proxgd/squared B={D_BATCH} L=4 at D={MESH_D} on "
            f"the emulation: ledger = D=1's, {k4} prox_step launches a "
            f"solve ({k1} at D=1), excess risk {e4:.4f} (W=0 {e0:.4f}); a "
            f"round {round_line(r4)} at D={MESH_D}, {round_line(r1)} at D=1")

        # the sharded code table on the serve configuration
        rng = np.random.default_rng(SEED)
        A = rng.standard_normal((P, R))
        W = (A @ rng.standard_normal((M, R)).T
             + NOISE * rng.standard_normal((P, M))).astype(np.float32)
        ids = torch.from_numpy(rng.integers(0, M, N_REQUESTS)
                               .astype(np.int32)).cuda()
        X = torch.from_numpy(rng.standard_normal((N_REQUESTS, P))
                             .astype(np.float32)).cuda()
        model = FactoredModel.from_W(W, R)
        plain_scores, v1 = MTLServer(model, batch_size=WAVE).score(ids, X)
        n0 = score_ops.mtl_score.launches
        sharded = MTLServer(model, batch_size=WAVE, mesh=mesh)
        scores, v2 = sharded.score(ids, X)
        torch.cuda.synchronize()
        waves = score_ops.mtl_score.launches - n0
        check(torch.equal(scores, plain_scores) and v1 == v2 and
              waves == N_REQUESTS // WAVE,
              f"sharded table: scores differ from the unsharded server's "
              f"or {waves} launches")
        out["sharded table"] = {"requests": N_REQUESTS, "waves": waves}
        log(f"[mesh] sharded code table (p={P} m={M} r={R}, waves of "
            f"{WAVE}): {N_REQUESTS} scores bitwise the unsharded server's, "
            f"version {v2}, {waves} mtl_score launches")
        out["launches"] = {"mtl_grad": grad_ops.task_gradients.launches,
                           "prox_step": prox_ops.prox_step.launches,
                           "mtl_score": score_ops.mtl_score.launches}
        check(all(v > 0 for v in out["launches"].values()),
              f"the mesh phase left a kernel unlaunched: {out['launches']}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 9c, preemption-safe solves, device round metrics, streaming
# ---------------------------------------------------------------------------
REC_EVERY = 3                    # segments end at rounds 3, 6, 9, 10
# the killed solves, each resumed once through the fault harness:
# (name, fault kind, path, solve arguments, data shards)
REC_CASES = (
    ("B dgsp sigkill", "sigkill", "B", {"method": "dgsp", "rounds": 10}, 1),
    ("D proxgd corrupt", "corrupt", "D",
     {"method": "proxgd", "rounds": 10, "lam": 0.01, "batch_size": D_BATCH,
      "local_steps": 4, "batch_seed": 0}, 1),
    (f"D proxgd corrupt D={MESH_D}", "corrupt", "D",
     {"method": "proxgd", "rounds": 10, "lam": 0.01, "batch_size": D_BATCH,
      "local_steps": 4, "batch_seed": 0}, MESH_D),
)
METRICS_RTOL = 1e-5              # objective vs lam * ||W_k||_*, recomputed
STREAM = dict(rounds=5, lam=0.02, local_steps=4, refreshes=3)
REC_TARGET_S = 60.0              # the phase's time budget (reported)


def _sync(dev) -> None:
    if str(dev).startswith("cuda"):
        torch.cuda.synchronize()


def recovery_phase(grad_ops, prox_ops, score_ops, a_data, d_data,
                   dev="cuda"):
    """Phase 9c: (1) path B's DGSP SIGKILLed after segment 2 in a child
    process on the card, path D's stochastic ProxGD killed and its newest
    segment corrupted, at D=1 and at D=4 on the sim's 2-D emulation, each
    finished by one ``resume`` in a fresh child and held bitwise to an
    uninterrupted child run (``repro_torch.faults``, the children started
    together); (2) ``metrics=True`` on path A's lazy ProxGD and path B's
    DGSP, W bitwise the ``metrics=False`` solve's, the objective against
    a recomputation, the round time with and without metrics in paired
    solves; (3) three streaming refreshes of stochastic ProxGD on path
    B's spec, each published to a live ``MTLServer`` whose scores are
    held to ``X W_r`` of the new model."""
    import repro_torch
    from repro_torch import faults
    from repro_torch.core.methods import MTLProblem
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.serve.mtl import MTLServer
    from repro_torch.train.streaming import SampleStream, StreamingResolver
    t_phase = time.perf_counter()
    out = {"faults": {}, "metrics": {}, "streaming": {}}
    work = tempfile.mkdtemp(prefix="recovery_")
    try:
        grad_ops.task_gradients.launches = 0       # count this phase only
        prox_ops.prox_step.launches = 0
        score_ops.mtl_score.launches = 0
        Xb, yb, Wstar_b, Sigma_b = sim_data(**FULL, seed=SEED, device=dev,
                                            task="classification")
        prob_b = MTLProblem.make(Xb, yb, "logistic", A=2.0, r=FULL["r"],
                                 device=dev)

        # (1) the killed solves, through the harness, on the card
        t0 = time.perf_counter()
        files = {"B": os.path.join(work, "path_b.npz"),
                 "D": os.path.join(work, "path_d.npz")}
        faults.save_problem(files["B"], prob_b)
        faults.save_problem(files["D"], d_data["probs"]["squared"])
        cases = [{"kind": kind, "problem": files[path], "solve": kw,
                  "every": REC_EVERY, "data_shards": ds,
                  "dir": f"case{i}"}
                 for i, (_, kind, path, kw, ds) in enumerate(REC_CASES)]
        reports = faults.run_cases(cases, os.path.join(work, "faults"),
                                   device=dev.split(":")[0], parallel=True)
        t_faults = time.perf_counter() - t0
        child = {"mtl_grad": 0, "prox_step": 0}
        for (name, kind, path, kw, ds), rep in zip(REC_CASES, reports):
            kernel = "mtl_grad" if path == "B" else "prox_step"
            base_n = rep["launches"]["baseline"][kernel]
            res_n = rep["launches"]["resumed"][kernel]
            rounds = kw["rounds"]
            left = rounds - rep["resumed_from"]
            check(rep["killed"] and rep["bit_identical"] and rep["recovered"],
                  f"recovery {name}: {rep}")
            check(base_n > 0 and base_n % rounds == 0 and
                  res_n == base_n // rounds * left,
                  f"recovery {name}: {res_n} {kernel} launches in the resume "
                  f"of {left} rounds, {base_n} in the uninterrupted "
                  f"{rounds}")
            for side in ("baseline", "resumed"):
                for k in child:
                    child[k] += rep["launches"][side][k]
            out["faults"][name] = {
                "kind": kind, "data_shards": ds, "exit_code": rep["exit_code"],
                "resumed_from": rep["resumed_from"], "kernel": kernel,
                "launches_baseline": base_n, "launches_resumed": res_n,
                "baseline_s": rep["seconds"]["baseline"],
                "resumed_s": rep["seconds"]["resumed"]}
            log(f"[recovery] {name}: child killed (exit {rep['exit_code']}),"
                f" resumed from round {rep['resumed_from']} of {rounds} by "
                f"one resume: W, iterates, ledger and counters bitwise the "
                f"uninterrupted card run's; {kernel} launches {res_n} in the "
                f"resume = {base_n}/{rounds} x {left} rounds; solve "
                f"{rep['seconds']['baseline']:.3f} s uninterrupted, "
                f"{rep['seconds']['resumed']:.3f} s resumed")
        out["faults_s"] = t_faults
        log(f"[recovery] {len(reports)} fault cases (baselines and faulted "
            f"children together, then the resumes) in {t_faults:.1f} s")

        # (2) device round metrics, paired with metrics off
        pa = a_data["prob"]
        for label, prob, kw, kernel in (
                ("A proxgd lazy", pa, a_data["kw"], grad_ops.task_gradients),
                ("B dgsp", prob_b, {"method": "dgsp", "rounds": 10},
                 grad_ops.task_gradients)):
            kw = dict(kw, device=dev)
            rounds = kw.pop("rounds")
            runs = alternating_solves(
                repro_torch.solve, prob, rounds,
                {"off": dict(kw), "on": dict(kw, metrics=True)}, kernel)
            (off, r_off, k_off), (on, r_on, k_on) = runs["off"], runs["on"]
            mtr = on.extras["metrics"]
            check(torch.equal(on.W, off.W) and
                  on.comm.ledger() == off.comm.ledger() and k_on == k_off,
                  f"metrics {label}: W, ledger or launches moved")
            check(mtr["round"].tolist() == list(range(1, rounds + 1)) and
                  all(np.all(np.isfinite(mtr[f])) for f in
                      ("objective", "grad_norm", "step_norm")),
                  f"metrics {label}: bad per-round arrays")
            if kw["method"] == "proxgd":
                # the objective is lam * ||W_k||_* of the round's iterate
                idx = sorted({*range(rounds // 5 - 1, rounds, rounds // 5),
                              rounds - 1})
                errs = []
                for k in idx:
                    want = kw["lam"] * float(torch.linalg.svdvals(
                        on.iterates[k + 1].double()).sum())
                    errs.append(abs(float(mtr["objective"][k]) - want)
                                / want)
                what = f"objective vs lam*||W_k||_* at {len(idx)} rounds"
            else:
                # no shrink: the objective term is 0; step_norm is the
                # appended basis column's norm, recomputed from U
                col = torch.linalg.vector_norm(on.extras["U"].double(), dim=0)
                errs = [abs(float(mtr["step_norm"][k]) - float(col[k]))
                        / float(col[k]) for k in range(rounds)]
                errs.append(float(np.abs(mtr["objective"]).max()))
                what = "step_norm vs ||U[:, k]||, objective 0"
            err = max(errs)
            check(err <= METRICS_RTOL, f"metrics {label}: {what} off by "
                  f"{err} relative")
            out["metrics"][label] = {
                "rounds": rounds, "max_rel_err": err, "launches_a_solve": k_on,
                "round_s_off": r_off, "round_s_on": r_on,
                "sv_exact_last": int(mtr["sv_exact"][-1])}
            log(f"[metrics] {label}: W and ledger bitwise metrics=False's, "
                f"{k_on} {kernel.__name__} launches a solve on both; {what}: "
                f"max rel err {err:.3e} (tol {METRICS_RTOL:g}); a round "
                f"{round_line(r_on)} with metrics, {round_line(r_off)} without"
                f" (median and range of {MESH_REPS} {rounds}-round solves "
                f"each, in turns)")

        # (3) the streaming re-solver on path B's spec
        store = os.path.join(work, "models")
        reg = MetricsRegistry()
        res0 = repro_torch.solve(prob_b, method="proxgd",
                                 rounds=STREAM["rounds"], lam=STREAM["lam"],
                                 keep_sv_carry=True, device=dev)
        model0 = res0.factorize(FULL["r"])
        model0.save(store)
        server = MTLServer(model0, batch_size=WAVE, registry=reg)
        stream = SampleStream(Wstar_b, Sigma_b, task="classification",
                              seed=SEED, device=dev)
        resolver = StreamingResolver(
            prob_b, server, store, method="proxgd", rank=FULL["r"],
            rounds=STREAM["rounds"], batch_size=D_BATCH,
            local_steps=STREAM["local_steps"], warm_from=res0,
            solver_hp={"lam": STREAM["lam"]}, registry=reg)
        rng = np.random.default_rng(SEED + 2)
        ids = torch.from_numpy(rng.integers(0, FULL["m"], WAVE)
                               .astype(np.int32)).to(dev)
        X = torch.from_numpy(rng.standard_normal((WAVE, FULL["p"]))
                             .astype(np.float32)).to(dev)
        refreshes = []
        for i in range(STREAM["refreshes"]):
            swaps, steps0 = len(server.swap_log), i + 1
            p0 = prox_ops.prox_step.launches
            t0 = time.perf_counter()
            rep = resolver.step(stream, D_BATCH)
            _sync(dev)
            secs = time.perf_counter() - t0
            n0 = score_ops.mtl_score.launches
            scores, ver = server.score(ids, X)
            want = (X * server.model.dense().index_select(1, ids.long()).T
                    ).sum(1)
            _sync(dev)
            err = float((scores - want).abs().max())
            scale = float(want.abs().max())
            snap = reg.snapshot()["metrics"]
            stale = (snap["streaming_staleness_oldest_seconds"]["value"],
                     snap["streaming_staleness_newest_seconds"]["value"])
            check(rep["reloaded"] and rep["store_step"] == steps0 and
                  len(server.swap_log) == swaps + 1 and
                  ver == rep["served_version"] and
                  ver not in [r["version"] for r in refreshes] and
                  score_ops.mtl_score.launches - n0 == 1 and
                  err <= SERVE_RTOL * scale and min(stale) > 0 and
                  prox_ops.prox_step.launches - p0 ==
                  STREAM["rounds"] * STREAM["local_steps"],
                  f"streaming refresh {i}: {rep}, served error {err} vs "
                  f"{SERVE_RTOL} x {scale}, staleness {stale}")
            refreshes.append({"store_step": rep["store_step"], "version": ver,
                              "refresh_s": secs, "solve_s": rep["solve_s"],
                              "staleness_oldest_s": stale[0],
                              "staleness_newest_s": stale[1],
                              "served_max_abs_err": err,
                              "served_scale": scale})
            log(f"[stream] refresh {i}: {D_BATCH} new rows a task ingested, "
                f"stochastic ProxGD {STREAM['rounds']} rounds x "
                f"{STREAM['local_steps']} local steps ("
                f"{STREAM['rounds'] * STREAM['local_steps']} prox_step "
                f"launches), published store step {rep['store_step']}, the "
                f"live server swapped to {ver}; {WAVE} requests vs X W_r "
                f"max|err| {err:.3e} (tol {SERVE_RTOL:g} x {scale:.3e}); "
                f"refresh {secs:.3f} s (solve, factorize, publish "
                f"{rep['solve_s']:.3f} s); staleness oldest "
                f"{stale[0] * 1e3:.1f} ms, newest {stale[1] * 1e3:.1f} ms")
        out["streaming"] = {"refreshes": refreshes,
                            "swap_log": len(server.swap_log)}
        out["launches"] = {"mtl_grad": grad_ops.task_gradients.launches,
                           "prox_step": prox_ops.prox_step.launches,
                           "mtl_score": score_ops.mtl_score.launches}
        out["child_launches"] = child
        check(all(v > 0 for v in out["launches"].values()) and
              all(v > 0 for v in child.values()),
              f"phase 9c left a kernel unlaunched: {out['launches']}, "
              f"children {child}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[recovery] phase 9c in {out['phase_s']:.1f} s (target "
        f"{REC_TARGET_S:.0f} s); launches in this process "
        f"{out['launches']}, in its children {child}")
    return out


# ---------------------------------------------------------------------------
# phase 9d, the static checks on the card and the Fig-4 surrogates
# ---------------------------------------------------------------------------
# benchmarks/fig4_real.py's METHODS (that script imports JAX, so its list
# is copied here), each spec drawn from PRNGKey(300 + i) as it draws them
FIG4_METHODS = (
    ("local", {"l2": 1e-2}),
    ("centralize", {"lam": 0.02}),
    ("proxgd", {"lam": 0.02, "rounds": 60, "record_every": 2}),
    ("accproxgd", {"lam": 0.02, "rounds": 60, "record_every": 2}),
    ("admm", {"lam": 0.02, "rho": 0.5, "rounds": 60, "record_every": 2}),
    ("dfw", {"rounds": 60, "record_every": 2}),
    ("dgsp", {"rounds": 8, "l2": 1e-2}),
    ("dnsp", {"rounds": 8, "damping": 0.5, "l2": 1e-2}),
    ("altmin", {"rounds": 10}),
)
FIG4_KEY0 = 300
FIG4_SLACK = 1.02                # App. H: best sharing <= 1.02 x local
# the card's surrogate draws against the port's CPU draws, of the
# largest magnitude (the same threefry integers; f32 sums in another
# order); a label may differ only where its coin lies this near
# sigmoid(margin)
SURROGATE_RTOL = 1e-5
SURROGATE_TIE = 1e-5
# one regression and one classification surrogate solved on the card
# and on the CPU from the same arrays, with the solver bound
SURROGATE_CPU = ("school", "landmine")
SURROGATE_CPU_METHODS = ("dgsp", "proxgd")
VERIFY_TARGET_S = 60.0           # the phase's time budget (reported)


def verify_phase(grad_ops, prox_ops, d_data, dev="cuda"):
    """Phase 9d: (a) ``solve(..., verify="static")`` on path B's DGSP,
    path D's stochastic ProxGD, the same on a 1-rank NCCL mesh and at
    D=4 through the sim's 2-D emulation, each "ok" with W, ledger and
    kernel launches of the real solve bitwise an unverified solve's, and
    a runtime that moves one uncharged all-reduce on the mesh refused
    with COMM001; (b) the six Fig-4 surrogates at their App. H shapes,
    the card's draws against the CPU's, every fig4 method on the card
    with the App. H claim per dataset, and two surrogates' W card vs
    CPU."""
    import torch.distributed as dist
    import repro_torch
    from repro_torch.analysis import AnalysisError, verify_static
    from repro_torch.core import prng
    from repro_torch.core.methods import MTLProblem
    from repro_torch.data import realworld as rw
    from repro_torch.runtime import MeshRuntime, init_cluster, task_mesh
    t_phase = time.perf_counter()
    out = {"verify": {}, "surrogates": {}}
    grad_ops.task_gradients.launches = 0       # count this phase only
    prox_ops.prox_step.launches = 0

    def verified(label, prob, kernel, method, **kw):
        """The twin alone, an unverified solve and a verified one: the
        verified solve's launches are the twin's plus the unverified
        solve's, its W and ledger the unverified solve's bitwise."""
        runs = {}
        for name, call in (
                ("twin", lambda: verify_static(prob, method, **kw)),
                ("plain", lambda: repro_torch.solve(prob, method=method,
                                                    **kw)),
                ("verified", lambda: repro_torch.solve(
                    prob, method=method, verify="static", **kw))):
            n0 = kernel.launches
            t0 = time.perf_counter()
            res = call()
            _sync(dev)
            runs[name] = (res, kernel.launches - n0,
                          time.perf_counter() - t0)
        (rep, n_twin, t_twin), (plain, n_plain, t_plain), \
            (ver, n_ver, t_ver) = runs["twin"], runs["plain"], runs["verified"]
        check(rep.ok and ver.extras["static_verify"] == "ok" and
              torch.equal(ver.W, plain.W) and
              ver.comm.ledger() == plain.comm.ledger() and n_twin > 0 and
              n_ver - n_twin == n_plain > 0,
              f"verify {label}: W, ledger or launches differ from the "
              f"unverified solve's (twin {n_twin}, verified {n_ver}, "
              f"unverified {n_plain})")
        log(f"[verify] {label}: ok; a twin of {rep.rounds} rounds, "
            f"{rep.collective_eqns} c10d op(s) a round, "
            f"{rep.measured_task_floats_per_chip} tasks-axis floats "
            f"moved, {rep.charged_floats_per_machine} charged per machine; "
            f"W and ledger bitwise the unverified solve's; "
            f"{kernel.__name__} launches twin {n_twin} + solve "
            f"{n_ver - n_twin} (unverified {n_plain}); twin {t_twin:.3f} s, "
            f"solve {t_plain:.3f} s, verified solve {t_ver:.3f} s")
        return {"twin_rounds": rep.rounds, "c10d_ops_a_round":
                rep.collective_eqns,
                "measured_task_floats": rep.measured_task_floats_per_chip,
                "charged_floats_per_machine": rep.charged_floats_per_machine,
                "launches": {"twin": n_twin, "solve": n_ver - n_twin,
                             "unverified": n_plain},
                "seconds": {"twin": t_twin, "unverified": t_plain,
                            "verified": t_ver}}

    # (a) verify="static" on the card
    Xb, yb, _, _ = sim_data(**FULL, seed=SEED, device=dev,
                            task="classification")
    prob_b = MTLProblem.make(Xb, yb, "logistic", A=2.0, r=FULL["r"],
                             device=dev)
    sq = d_data["probs"]["squared"]
    sgd = dict(rounds=10, lam=0.01, batch_size=D_BATCH, local_steps=4,
               batch_seed=0)
    out["verify"]["B dgsp"] = verified("path B dgsp/logistic", prob_b,
                                       grad_ops.task_gradients, "dgsp",
                                       rounds=10)
    out["verify"]["D proxgd"] = verified(
        f"path D proxgd/squared B={D_BATCH} L=4", sq, prox_ops.prox_step,
        "proxgd", **sgd)
    out["verify"][f"D{MESH_D} proxgd"] = verified(
        f"path D proxgd/squared B={D_BATCH} L=4 at D={MESH_D} (emulation)",
        sq, prox_ops.prox_step, "proxgd", data_shards=MESH_D, **sgd)
    store = tempfile.mkdtemp(prefix="verify_store_")
    try:
        init_cluster(f"file://{store}/store", 1, 0, device=dev,
                     timeout_s=120)
        mesh = task_mesh(device=dev)
        out["verify"]["D proxgd mesh"] = verified(
            f"path D proxgd/squared B={D_BATCH} L=4 on the 1-rank "
            f"{dist.get_backend()} mesh", sq, prox_ops.prox_step, "proxgd",
            backend="mesh", mesh=mesh, **sgd)
        real = MeshRuntime.gather_columns

        def rogue(self, x, note=""):
            s = x.sum(dim=0)
            dist.all_reduce(s, group=self._tasks_group)   # never charged
            return real(self, x, note)

        MeshRuntime.gather_columns = rogue
        refused = ""
        try:
            repro_torch.solve(sq, method="proxgd", backend="mesh",
                              mesh=mesh, verify="static", **sgd)
        except AnalysisError as e:
            refused = str(e)
        finally:
            MeshRuntime.gather_columns = real
        first = next((ln.strip() for ln in refused.splitlines()
                      if "COMM001" in ln), "")
        check("c10d.allreduce_" in first and "'tasks'" in first,
              f"a runtime moving an uncharged all-reduce was not refused "
              f"with COMM001: {refused!r}")
        out["verify"]["uncharged all_reduce"] = first
        log(f"[verify] a gather that also moves an uncharged all-reduce on "
            f"the mesh is refused: {first}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)

    # (b) the Fig-4 surrogates at their App. H shapes
    for i, (name, spec) in enumerate(rw.REAL_SPECS.items()):
        t0 = time.perf_counter()
        key = prng.PRNGKey(FIG4_KEY0 + i, device=dev)
        card = rw.generate_surrogate(key, spec, device=dev)
        _sync(dev)
        t_draw = time.perf_counter() - t0
        host = rw.generate_surrogate(prng.PRNGKey(FIG4_KEY0 + i,
                                                  device="cpu"), spec,
                                     device="cpu")
        errs, flips = [], 0
        for j, (a, b) in enumerate(zip(card, host)):
            a = a.cpu()
            if spec.task == "classification" and j % 2:
                # labels: equal but where the coin is a near-tie
                u = prng.uniform(rw.surrogate_keys(key)[4 + 2 * (j // 2)],
                                 tuple(a.shape))
                pr = torch.sigmoid(torch.einsum(
                    "mnp,pm->mn", card[j - 1], rw.surrogate_predictor(
                        key, spec)))
                gap = (u - pr).abs().cpu()[a != b]
                flips += int(gap.numel())
                check(bool((gap <= SURROGATE_TIE).all()),
                      f"surrogate {name}: a label flipped away from a tie")
                continue
            errs.append(float((a - b).abs().max()) / float(b.abs().max()))
        check(max(errs) <= SURROGATE_RTOL,
              f"surrogate {name}: card draws differ from the CPU's by "
              f"{max(errs)} of their scale")
        Xs, ys, Xt, yt = card
        loss = "squared" if spec.task == "regression" else "logistic"
        prob = MTLProblem.make(Xs, ys, loss, A=3.0, r=spec.r, device=dev)
        finals, t_solve = {}, time.perf_counter()
        g0 = grad_ops.task_gradients.launches
        for method, kw in FIG4_METHODS:
            res = repro_torch.solve(prob, method=method, **kw)
            finals[method] = min(float(rw.test_metric(spec.task, W, Xt, yt))
                                 for W in (res.iterates or [res.W]))
            if name in SURROGATE_CPU and method in SURROGATE_CPU_METHODS:
                cpu = repro_torch.solve(MTLProblem.make(
                    Xs.cpu(), ys.cpu(), loss, A=3.0, r=spec.r,
                    device="cpu"), method=method, device="cpu", **kw)
                err = float((res.W.cpu() - cpu.W).abs().max())
                tol = SOLVER_W_RTOL * max(1.0, float(cpu.W.abs().max()))
                check(err <= tol and res.comm.ledger() == cpu.comm.ledger(),
                      f"surrogate {name} {method}: card W differs from the "
                      f"CPU's by {err} > {tol}")
                out["surrogates"].setdefault(name, {})[
                    f"{method} card vs CPU"] = {"max_abs_err": err,
                                                "tol": tol}
                log(f"[fig4] {name} {method}: card vs CPU max|dW| "
                    f"{err:.3e} (tol {tol:.3e}); ledgers equal")
        t_solve = time.perf_counter() - t_solve
        grad_n = grad_ops.task_gradients.launches - g0
        best, best_name = min((v, k) for k, v in finals.items()
                              if k != "local")
        check(best <= FIG4_SLACK * finals["local"],
              f"surrogate {name}: the best sharing method's test error "
              f"{best} is above {FIG4_SLACK} x local's {finals['local']}")
        check(loss == "squared" or grad_n > 0,
              f"surrogate {name}: the logistic solves never launched "
              f"mtl_grad")
        out["surrogates"].setdefault(name, {}).update({
            "test_error": finals, "draw_s": t_draw, "solve_s": t_solve,
            "mtl_grad_launches": grad_n, "max_rel_draw_err": max(errs),
            "label_flips": flips})
        metric = "RMSE" if loss == "squared" else "1-AUC"
        log(f"[fig4] {name} (surrogate) m={spec.m} p={spec.p} n={spec.n} "
            f"{spec.task}: draw {t_draw * 1e3:.1f} ms on the card, vs CPU "
            f"{max(errs):.2e} of scale, {flips} label flips; test {metric} "
            f"(surrogate): local {finals['local']:.4f}, best sharing "
            f"{best:.4f} ({best_name}); "
            f"{len(FIG4_METHODS)} methods in {t_solve:.2f} s, {grad_n} "
            f"mtl_grad launches")
    out["launches"] = {"mtl_grad": grad_ops.task_gradients.launches,
                       "prox_step": prox_ops.prox_step.launches}
    check(all(v > 0 for v in out["launches"].values()),
          f"phase 9d left a kernel unlaunched: {out['launches']}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[verify] phase 9d in {out['phase_s']:.1f} s (target "
        f"{VERIFY_TARGET_S:.0f} s); launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 10, the LM serving path (gemma2-2b FULL) and flash_attention
# ---------------------------------------------------------------------------
LM_ARCH = "gemma2-2b"
# kernel vs plain: the reference's own kernel tolerances
# (tests/test_kernels.py:18-19), times max|out| and times each output
# row's own scale (``fa_error``)
FA_TOL = {_F32: 2e-5, _BF16: 3e-2}
EMPTY_POS = -10 ** 9
# q is drawn at this std (k and v at 1), so the scores q·k·hd^-1/2 have
# std 4 and the largest over thousands of keys reach ~15 of gemma2's cap
# of 50, where the cap moves them by ~0.5: a dropped softcap shows in
# bf16 as well as in f32
FA_Q_STD = 4.0
# name, B, Sq, Sk, H, Hkv, hd, dtype, mode, window, softcap.  "prefill":
# positions 0..S-1 on both sides (fresh keys); "ring": Sq queries ending
# at each row's last position against a ring buffer of Sk slots holding
# wrapped positions (odd rows also empty slots).  The first four are the
# served wave's shapes (gemma2-2b FULL: 8 heads over 4 KV heads, hd 256,
# window 4096, softcap 50; B=4 prompts padded to 5120, cache 5152 slots
# global, 4096 local)
FA_CASES = (
    ("prefill global bf16", 4, 5120, 5120, 8, 4, 256, _BF16, "prefill", None, 50.0),
    ("prefill local bf16", 4, 5120, 5120, 8, 4, 256, _BF16, "prefill", 4096, 50.0),
    ("decode global bf16", 4, 1, 5152, 8, 4, 256, _BF16, "ring", None, 50.0),
    ("decode local bf16", 4, 1, 4096, 8, 4, 256, _BF16, "ring", 4096, 50.0),
    ("prefill global f32", 4, 5120, 5120, 8, 4, 256, _F32, "prefill", None, 50.0),
    ("prefill local f32 no softcap", 4, 5120, 5120, 8, 4, 256, _F32, "prefill",
     4096, None),
    ("decode local f32", 4, 1, 4096, 8, 4, 256, _F32, "ring", 4096, 50.0),
    ("decode global f32 no softcap", 4, 1, 5152, 8, 4, 256, _F32, "ring", None,
     None),
    ("S=130 hd=64 group 2", 1, 130, 130, 8, 4, 64, _F32, "prefill", 100, 50.0),
    ("S=130 hd=64 group 1", 2, 130, 130, 4, 4, 64, _F32, "prefill", 100, None),
    ("S=130 hd=128 group 12", 1, 130, 130, 24, 2, 128, _F32, "prefill", 64, 30.0),
    ("S=130 hd=256 group 2 bf16", 3, 130, 130, 8, 4, 256, _BF16, "prefill", 64,
     20.0),
    ("S=300 hd=256 window 64", 2, 300, 300, 8, 4, 256, _F32, "prefill", 64, 50.0),
    ("ring 256 slots group 12", 3, 1, 256, 24, 2, 128, _F32, "ring", 200, 50.0),
    ("ring 200 slots hd=64 bf16", 2, 1, 200, 4, 2, 64, _BF16, "ring", 150, 30.0),
    ("ring 3 queries hd=256", 2, 3, 256, 8, 4, 256, _F32, "ring", 128, None),
    ("S=300 hd=64 group 1 bf16", 2, 300, 300, 4, 4, 64, _BF16, "prefill", 100,
     50.0),
    ("S=130 hd=128 group 12 bf16", 1, 130, 130, 24, 2, 128, _BF16, "prefill",
     64, 30.0),
    ("S=257 hd=128 group 9 bf16", 2, 257, 257, 18, 2, 128, _BF16, "prefill",
     None, None),
    ("ring 96 queries hd=256 bf16", 2, 96, 512, 8, 4, 256, _BF16, "ring", 128,
     50.0),
    ("S=6 hd=64 group 12 bf16", 2, 6, 6, 24, 2, 64, _BF16, "prefill", None,
     10.0),
    # the decode kernel's other instantiations (dtype x hd x 2 or 8 rows),
    # each against a ring of Sk slots that is no multiple of its tile; the
    # windows leave whole splits with no key that counts
    ("decode hd=64 f32 group 1", 3, 1, 333, 4, 4, 64, _F32, "ring", 100, 30.0),
    ("decode hd=128 f32 group 2", 2, 1, 777, 8, 4, 128, _F32, "ring", None,
     50.0),
    ("decode hd=128 bf16 group 2", 2, 1, 1000, 8, 4, 128, _BF16, "ring", 300,
     50.0),
    ("decode 8 rows hd=64 bf16", 2, 1, 500, 16, 2, 64, _BF16, "ring", 200,
     30.0),
    ("decode 8 rows hd=128 bf16", 1, 2, 700, 8, 2, 128, _BF16, "ring", None,
     50.0),
    ("decode 8 rows hd=256 bf16", 2, 4, 600, 4, 2, 256, _BF16, "ring", 128,
     None),
    ("decode 8 rows hd=64 f32", 2, 1, 300, 8, 1, 64, _F32, "ring", 64, 20.0),
    ("decode 8 rows hd=128 f32", 1, 2, 450, 12, 3, 128, _F32, "ring", None,
     30.0),
    # 9 to 63 query rows against a long ring stay on the CUDA cores, with
    # the keys split over CTAs and the splits merged by the combine pass;
    # the window leaves whole splits with no key that counts
    ("ring 4 queries group 4 bf16 split", 1, 4, 4096, 8, 2, 128, _BF16,
     "ring", 300, 50.0),
    ("ring 5 queries hd=64 f32 split", 2, 5, 3000, 4, 2, 64, _F32, "ring",
     None, 30.0),
    # the training steps' calls (phase 12): B=1, S=4608, on the tensor cores
    ("train global bf16", 1, 4608, 4608, 8, 4, 256, _BF16, "prefill", None,
     50.0),
    ("train local bf16", 1, 4608, 4608, 8, 4, 256, _BF16, "prefill", 4096,
     50.0),
)
FA_MAIN = FA_CASES[:4]
# the cases meant for the tensor-core route (bf16, at least 64 query rows:
# ``kernel.route``; "S=6 hd=64 group 12 bf16"'s TMA boxes of 10 queries
# and 64 keys overhang its 6 of each), and those meant for the decode
# route (at most 8 query rows, Sq * group); every other case runs on the
# CUDA cores
FA_WGMMA = ("prefill global bf16", "prefill local bf16",
            "S=130 hd=256 group 2 bf16", "S=300 hd=64 group 1 bf16",
            "S=130 hd=128 group 12 bf16", "S=257 hd=128 group 9 bf16",
            "ring 96 queries hd=256 bf16", "S=6 hd=64 group 12 bf16",
            "train global bf16", "train local bf16")
FA_DECODE = ("decode global bf16", "decode local bf16", "decode local f32",
             "decode global f32 no softcap", "ring 200 slots hd=64 bf16",
             "ring 3 queries hd=256", "decode hd=64 f32 group 1",
             "decode hd=128 f32 group 2", "decode hd=128 bf16 group 2",
             "decode 8 rows hd=64 bf16", "decode 8 rows hd=128 bf16",
             "decode 8 rows hd=256 bf16", "decode 8 rows hd=64 f32",
             "decode 8 rows hd=128 f32")
# the CUDA-core cases whose keys the plan splits (``fa_split``)
FA_SPLIT = ("ring 4 queries group 4 bf16 split",
            "ring 5 queries hd=64 f32 split")
# the served wave: 4 prompts (5120 tokens, past the window, down to 17)
# left-padded to 5120, 32 new tokens each, greedy; cache 5120 + 32
SERVE_PROMPTS = (5120, 4096, 1024, 17)
SERVE_NEW = 32
SERVE_MAX_LEN = 5152
SERVE_TEMPERATURE = 0.8
# the served wave's logits (prefill and 31 teacher-forced decode steps,
# bf16, max|logit| 30) through the kernel against through the plain
# version: max|diff| limit, about twice the 0.53 read on an H100 80GB
# HBM3; and the decode attentions that must fail it (changed keyword
# arguments of the decode calls), which read 18.1 and 4.3 there:
# positions ignored, as the reference's pallas decode does, and ring
# slots taken for positions
SERVE_LOGIT_TOL = 1.0
SERVE_CONTROLS = {
    "positions ignored": lambda kw: dict(
        kw, q_pos=torch.zeros_like(kw["q_pos"]),
        k_pos=torch.arange(kw["k_pos"].shape[1], device=kw["k_pos"].device
                           ).expand_as(kw["k_pos"])),
    "slots for positions": lambda kw: dict(
        kw, k_pos=torch.arange(kw["k_pos"].shape[1], device=kw["k_pos"].device
                               ).expand_as(kw["k_pos"])),
}
# the full-width f32 anchor: teacher-forced prefill + decode = forward,
# the reference's own check and tolerance (tests/test_decode_consistency.py
# :20-41), with a prompt past the 4096-token window
ANCHOR = dict(B=2, S=4608, T=4)
ANCHOR_TOL = 2e-3


def reset_counts() -> None:
    """Every kernel's launch count to 0."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mtl_grad import ops as grad_ops
    from repro_torch.kernels.mtl_score import ops as score_ops
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    for fn in (score_ops.mtl_score, grad_ops.task_gradients,
               prox_ops.prox_step, fa_ops.flash_attention,
               ssm_ops.selective_scan):
        fn.launches = 0
    by_route = fa_ops.flash_attention.launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))


def fa_inputs(case, dev="cuda"):
    """q (normal at std ``FA_Q_STD``), k, v (standard normal), in the
    case's dtype, and int32 positions for one ``FA_CASES`` entry, drawn
    on the CPU from a generator seeded with the case's index (the same
    bytes on every device) and moved to ``dev``.  Ring rows: even rows
    fill every slot with wrapped positions, odd rows about half of them
    (the rest empty, at ``EMPTY_POS``)."""
    _, B, Sq, Sk, H, Hkv, hd, dtype, mode, _, _ = case
    gen = torch.Generator().manual_seed(SEED + FA_CASES.index(case))
    q = (FA_Q_STD * torch.randn(B, Sq, H, hd, generator=gen)).to(dtype)
    k = torch.randn(B, Sk, Hkv, hd, generator=gen).to(dtype)
    v = torch.randn(B, Sk, Hkv, hd, generator=gen).to(dtype)
    q, k, v = q.to(dev), k.to(dev), v.to(dev)
    if mode == "prefill":
        pos = torch.arange(Sq, dtype=torch.int32, device=dev)[None].repeat(B, 1)
        return q, k, v, pos, pos.clone()
    k_pos = np.full((B, Sk), EMPTY_POS, np.int32)
    q_pos = np.zeros((B, Sq), np.int32)
    for b in range(B):
        last = Sk + 16 + 37 * b
        written = Sk if b % 2 == 0 else Sk // 2 - b
        p = np.arange(last - written + 1, last + 1)
        k_pos[b, p % Sk] = p
        q_pos[b] = np.arange(last - Sq + 1, last + 1)
    return (q, k, v, torch.from_numpy(q_pos).to(dev),
            torch.from_numpy(k_pos).to(dev))


def fa_error(out, ref, ref_abs, dtype):
    """The attention check of ``out`` against the plain version ``ref``
    on the same inputs, and ``ref_abs``, the plain version with |v| (the
    sum over keys of p·|v|, the scale of the f32 accumulation's
    rounding).  Returns max|out - ref|, max|ref| and the worst output
    row's (one query, one head) ratio of max|out - ref| over its limit
    ``FA_TOL[dtype]`` · max|ref row| + ``FA_TOL[f32]`` · max|ref_abs row|.
    The check passes when max|out - ref| <= ``FA_TOL[dtype]`` · max|ref|
    (the reference's tolerance) and the ratio is at most 1.  The row
    limit keeps the check tight where a row averages thousands of keys
    and its output is ~50 times smaller than the first rows' (which
    attend to a few keys and set max|ref|)."""
    out, ref, ref_abs = out.float(), ref.float(), ref_abs.float()
    diff = (out - ref).abs().amax(-1)
    mag = ref.abs().amax(-1)
    limit = FA_TOL[dtype] * mag + FA_TOL[_F32] * ref_abs.abs().amax(-1)
    ratio = torch.where(diff > 0, diff / limit, torch.zeros_like(diff))
    return float(diff.max()), float(mag.max()), float(ratio.max())


def fa_passes(err, scale, ratio, dtype) -> bool:
    """Whether ``fa_error``'s numbers pass the check."""
    return err <= FA_TOL[dtype] * scale and ratio <= 1.0


def fa_controls(case, kw):
    """The attentions that miss a feature the case exercises, as changed
    keyword arguments of the call: the window dropped (where it binds),
    the softcap dropped, ``k_pos`` taken as 0..Sk-1 (ring cases), and, in
    a prefill case with none of these, the causal mask dropped.  The
    check must fail each."""
    from repro_torch.kernels.flash_attention.ref import key_mask
    mode, window, softcap = case[8:]
    q_pos, k_pos = kw["q_pos"], kw["k_pos"]
    out = {}
    if window is not None and not torch.equal(
            key_mask(q_pos, k_pos, True, window),
            key_mask(q_pos, k_pos, True, None)):
        out["window dropped"] = dict(kw, window=None)
    if softcap:
        out["softcap dropped"] = dict(kw, softcap=None)
    if mode == "ring":
        Sk = k_pos.shape[1]
        out["k_pos ignored"] = dict(kw, k_pos=torch.arange(
            Sk, dtype=k_pos.dtype, device=k_pos.device).expand_as(k_pos))
    if not out and mode == "prefill":
        out["causal dropped"] = dict(kw, causal=False)
    return out


def fa_route(case) -> str:
    """The route a case is meant to take on the card."""
    return ("wgmma" if case[0] in FA_WGMMA else
            "decode" if case[0] in FA_DECODE else "cuda_cores")


def fa_decode_shape(fa_kernel, case, n_sm):
    """The decode kernel's instantiation a case reaches on a card of
    ``n_sm`` SMs, (dtype, hd, rows), and the splits (CTAs of one batch
    row and KV head) in which no key counts for any of its rows."""
    from repro_torch.kernels.flash_attention.ref import key_mask
    _, B, Sq, Sk, H, Hkv, hd, dtype, _, window, _ = case
    pl = fa_kernel.plan(B, Sq, Sk, H, Hkv, hd, dtype, n_sm)
    _, _, q_pos, k_pos = fa_inputs(case, dev="cpu")[1:]
    per = pl.tiles_per_split * fa_kernel.decode_tile_keys(hd, dtype)
    ok = key_mask(q_pos, k_pos, True, window).any(1)          # (B, Sk)
    empty = sum(not bool(ok[b, z * per:(z + 1) * per].any())
                for b in range(B) for z in range(pl.n_split))
    return (str(dtype).split(".")[-1], hd, pl.rows), empty


def fa_split(fa_kernel, case, n_sm):
    """The key splits of a case's launch on a card of ``n_sm`` SMs, and
    those of them in which no key counts for any of its rows."""
    from repro_torch.kernels.flash_attention.ref import key_mask
    _, B, Sq, Sk, H, Hkv, hd, dtype, _, window, _ = case
    pl = fa_kernel.plan(B, Sq, Sk, H, Hkv, hd, dtype, n_sm)
    _, _, q_pos, k_pos = fa_inputs(case, dev="cpu")[1:]
    per = pl.tiles_per_split * fa_kernel.TILE_K
    ok = key_mask(q_pos, k_pos, True, window).any(1)          # (B, Sk)
    empty = sum(not bool(ok[b, z * per:(z + 1) * per].any())
                for b in range(B) for z in range(pl.n_split))
    return pl.n_split, empty


def fa_bound_ms(case, q, k, q_pos, k_pos):
    """Least time for one call: Q, K, V and the positions read once, the
    output written once, against a q·k dot and a p·v axpy per query head
    for each (query, key) pair the mask lets through (this input's pairs),
    at the peak rate of the inputs' type (bf16 tensor cores, or f32 CUDA
    cores); also the bound at the f32 CUDA-core rate."""
    from repro_torch.kernels.flash_attention.ref import key_mask
    _, _, _, _, H, _, hd, dtype, _, window, _ = case
    pairs = int(key_mask(q_pos, k_pos, True, window).sum())
    flops = 4.0 * hd * H * pairs
    nbytes = (2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()
              + 4 * (q_pos.numel() + k_pos.numel()))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rate = BF16_FLOPS_PER_S if dtype == _BF16 else F32_FLOPS_PER_S
    t_ops = flops / rate * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, max(t_bytes, flops / F32_FLOPS_PER_S * 1e3), flops, nbytes


def fa_library(case, q, k, v, q_pos, k_pos):
    """The same function as one PyTorch call: FlexAttention compiled by
    PyTorch, with the softcap as a ``score_mod`` and the position mask as
    a block mask (never called by the port); and SDPA with the same mask
    and no softcap, a lower reference."""
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from repro_torch.kernels.flash_attention.ref import key_mask
    _, B, Sq, Sk, H, Hkv, hd, _, _, window, softcap = case
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qp, kp = q_pos.long(), k_pos.long()

    def mask_mod(b, h, qi, ki):
        ok = (kp[b, ki] >= 0) & (kp[b, ki] <= qp[b, qi])
        if window is not None:
            ok = ok & (kp[b, ki] > qp[b, qi] - window)
        return ok

    def score_mod(s, b, h, qi, ki):
        return softcap * torch.tanh(s / softcap)

    block_mask = create_block_mask(mask_mod, B, None, Sq, Sk, device="cuda")
    flex = torch.compile(flex_attention)

    def flex_call():
        return flex(qt, kt, vt, score_mod=score_mod if softcap else None,
                    block_mask=block_mask, scale=hd ** -0.5, enable_gqa=True)

    mask = key_mask(q_pos, k_pos, True, window)[:, None]

    def sdpa_call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=hd ** -0.5,
                                              enable_gqa=True)

    return flex_call, sdpa_call


def fa_kernel_phase():
    """flash_attention against its plain version at the served shapes and
    at edge shapes (each launched twice, on the route the case is meant
    to take: the bytes must not move), the calls that must fail
    (``fa_controls``: the window dropped, the softcap dropped, ``k_pos``
    ignored, the causal mask dropped), then the times at the four served
    shapes."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    by_route = fa_ops.flash_attention.launches_by_route
    max_abs_err, by_case = 0.0, []

    # the decode cases reach every instantiation of the decode source, and
    # some split of theirs holds no key that counts
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    reached, empty = set(), 0
    for case in FA_CASES:
        if fa_route(case) == "decode":
            shape, n_empty = fa_decode_shape(fa_kernel, case, n_sm)
            reached.add(shape)
            empty += n_empty
    want = {(d, hd, rows) for d in ("float32", "bfloat16")
            for hd in fa_kernel.HEAD_DIMS for rows in fa_kernel.DECODE_ROWS}
    log(f"[kernel] flash_attention decode cases reach {len(reached)} of the "
        f"{len(want)} (dtype, hd, rows) instantiations; {empty} of their "
        f"splits hold no key that counts")
    check(reached == want, f"decode cases miss the instantiations "
          f"{sorted(want - reached)}")
    check(empty > 0, "no decode case has a split in which no key counts")
    # the CUDA-core route's split pass: its split cases split there, and
    # some of their splits hold no key that counts
    splits = {}
    for case in FA_CASES:
        if case[0] in FA_SPLIT:
            splits[case[0]] = dict(zip(("n_split", "empty_splits"),
                                       fa_split(fa_kernel, case, n_sm)))
    log(f"[kernel] flash_attention CUDA-core split cases: {splits}")
    check(len(splits) == len(FA_SPLIT) and
          all(s["n_split"] > 1 for s in splits.values()),
          f"a CUDA-core split case does not split: {splits}")
    check(any(s["empty_splits"] > 0 for s in splits.values()),
          "no CUDA-core split case has a split in which no key counts")
    decode = {"instantiations": sorted(reached), "empty_splits": empty,
              "cuda_core_splits": splits}
    for case in FA_CASES:
        name, B, Sq, Sk, H, Hkv, hd, dtype, mode, window, softcap = case
        q, k, v, q_pos, k_pos = fa_inputs(case)
        kw = dict(q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
                  softcap=softcap)
        before = dict(by_route)
        out = fa_ops.flash_attention(q, k, v, **kw)
        out2 = fa_ops.flash_attention(q, k, v, **kw)
        took = {r: n - before[r] for r, n in by_route.items()}
        route = fa_route(case)
        check(took == {r: 2 * (r == route) for r in by_route}, f"{name}: "
              f"launches by route {took}, want both on {route}")
        ref = attention_ref(q, k, v, **kw)
        ref_abs = attention_ref(q, k, v.abs(), **kw)
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == dtype and
              bool(torch.isfinite(out).all()), f"{name}: bad output")
        check(torch.equal(out, out2), f"{name}: two launches gave different "
              f"bytes")
        err, scale, ratio = fa_error(out, ref, ref_abs, dtype)
        tol = FA_TOL[dtype]
        log(f"[kernel] flash_attention {name:30s} route {route}: max|err| "
            f"{err:.3e} / max|out| {scale:.3e} (tol {tol:g} x max|out|); "
            f"worst row {ratio:.3f} of its limit; relaunch bitwise equal")
        check(fa_passes(err, scale, ratio, dtype), f"{name}: kernel "
              f"disagrees with the plain version: max|err| {err} (limit "
              f"{tol * scale}), worst row {ratio} of its limit")
        controls = {}
        check(bool(fa_controls(case, kw)), f"{name}: the case exercises "
              f"none of the checked features")
        for what, wrong_kw in fa_controls(case, kw).items():
            wrong = fa_ops.flash_attention(q, k, v, **wrong_kw)
            w_err, _, w_ratio = fa_error(wrong, ref, ref_abs, dtype)
            controls[what] = {"max_abs_err": w_err, "worst_row_ratio": w_ratio}
            check(not fa_passes(w_err, scale, w_ratio, dtype),
                  f"{name}: a kernel call with the {what} passed the check")
            del wrong
        log(f"[kernel] flash_attention {name:30s} must fail and does: "
            + "; ".join(f"{what} max|err| {c['max_abs_err']:.3e}, worst row "
                        f"{c['worst_row_ratio']:.1f} of its limit"
                        for what, c in controls.items()))
        by_case.append({"name": name, "route": route, "max_abs_err": err,
                        "max_abs_out": scale, "worst_row_ratio": ratio,
                        "controls": controls})
        if case in FA_MAIN:
            max_abs_err = max(max_abs_err, err)
        del q, k, v, out, out2, ref, ref_abs
    torch.cuda.synchronize()

    rows = []
    for case in FA_MAIN:
        name, B, Sq, Sk, H, Hkv, hd, dtype, mode, window, softcap = case
        q, k, v, q_pos, k_pos = fa_inputs(case)
        kw = dict(q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
                  softcap=softcap)

        def kern():
            return fa_ops.flash_attention(q, k, v, **kw)

        reps, inner = (5, 2) if Sq > 1 else (20, 10)
        k_ms = time_ms(kern, reps=reps, inner=inner)
        g_ms = graph_ms(kern, reps=reps, inner=inner)
        p_ms = time_ms(lambda: attention_ref(q, k, v, **kw), reps=reps,
                       inner=inner)
        lib_ms = sdpa_ms = None
        try:
            flex_call, sdpa_call = fa_library(case, q, k, v, q_pos, k_pos)
            lib_err = float((flex_call().transpose(1, 2).float()
                             - attention_ref(q, k, v, **kw).float()).abs().max())
            lib_ms = time_ms(flex_call, reps=reps, inner=inner)
            sdpa_ms = time_ms(sdpa_call, reps=reps, inner=inner)
            lib_note = f"FlexAttention max|err| vs plain {lib_err:.3e}"
        except Exception as exc:     # a comparison only, not the port
            lib_note = f"FlexAttention not measured: {type(exc).__name__}: {exc}"
        (b_ms, b_by), f32_ms, flops, nbytes = fa_bound_ms(case, q, k, q_pos,
                                                          k_pos)
        rows.append({"shape": {"name": name, "B": B, "Sq": Sq, "Sk": Sk,
                               "H": H, "Hkv": Hkv, "hd": hd,
                               "dtype": "bf16", "window": window,
                               "softcap": softcap},
                     "route": fa_route(case),
                     "kernel_ms": k_ms, "kernel_graph_ms": g_ms,
                     "plain_ms": p_ms, "library_ms": lib_ms,
                     "sdpa_no_softcap_ms": sdpa_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "bound_f32_cores_ms": f32_ms,
                     "flops": flops, "bytes": nbytes})
        fmt = lambda t: "-" if t is None else f"{t * 1e3:10.2f}"  # noqa: E731
        log(f"[time] flash_attention {name:20s} ({fa_route(case)}) kernel "
            f"{fmt(k_ms)} us (graph {fmt(g_ms)} us)  plain {fmt(p_ms)} us  "
            f"flex {fmt(lib_ms)} us  sdpa(no softcap) {fmt(sdpa_ms)} us  "
            f"bound {b_ms * 1e3:9.3f} us ({b_by}, {b_ms / g_ms:.3f} of the "
            f"graph time; f32 cores {f32_ms * 1e3:9.3f} us); "
            f"{flops / (g_ms * 1e-3) / 1e12:.2f} TFLOP/s, "
            f"{nbytes / (g_ms * 1e-3) / 1e12:.3f} TB/s; {lib_note}")
        del q, k, v
    torch.cuda.synchronize()
    return rows, max_abs_err, by_case, decode


@contextlib.contextmanager
def plain_attention(attn_mod, decode_change=None):
    """Send the model's attention through the plain version on the card,
    for the comparison only: the port itself has no such switch.  Under
    autograd the plain version is differentiated as it stands (the
    kernel's ``twin`` is dropped).  ``decode_change`` (keyword arguments
    -> keyword arguments), if given, alters the decode calls (one query),
    to make a wrong attention."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def plain(q, k, v, twin=None, **kw):
        if decode_change is not None and q.shape[1] == 1:
            kw = decode_change(kw)
        return attention_ref(q, k, v, **kw)

    kernel_ops = attn_mod.fa_ops
    attn_mod.fa_ops = types.SimpleNamespace(flash_attention=plain)
    try:
        yield
    finally:
        attn_mod.fa_ops = kernel_ops


def close_excess(a, b, tol, chunk=512):
    """max over elements of |a - b| - tol·|b| (<= tol passes
    ``assert_allclose(a, b, atol=tol, rtol=tol)``) and max|a - b|, over
    the sequence axis in chunks."""
    excess = worst = 0.0
    for s in range(0, a.shape[1], chunk):
        d = (a[:, s:s + chunk] - b[:, s:s + chunk]).abs()
        worst = max(worst, float(d.max()))
        excess = max(excess, float((d - tol * b[:, s:s + chunk].abs()).max()))
    return excess, worst


def served_logits(model_mod, model, batch, toks, max_len):
    """float32 logits (B, T, V) of prefill over ``batch`` and of a decode
    step on each of ``toks[:, :-1]`` (B, T), teacher-forced, as the
    engine runs a wave."""
    B, S = batch["tokens"].shape
    cache = model_mod.init_cache(model.cfg, B, max_len, model.device)
    logits, cache = model_mod.prefill(model, batch, cache)
    out = [logits.float()]
    pos = torch.full((B,), S, dtype=torch.int32, device=model.device)
    for t in range(toks.shape[1] - 1):
        logits, cache = model_mod.decode_step(model, toks[:, t], pos, cache)
        out.append(logits.float())
        pos = pos + 1
    return torch.stack(out, 1)


def lm_anchor(tag, model_mod, cfg, anchor, rng, count, plain_ctx):
    """The full-width f32 anchor of an LM serving phase (the one deviation
    from FULL): ``cfg`` in float32 with seeded weights, B × (S + T)
    tokens from ``rng``; ``forward`` == ``prefill`` + T teacher-forced
    ``decode_step``s, and ``forward`` through the kernel == through the
    plain version (inside ``plain_ctx()``), to ``ANCHOR_TOL``.
    ``count()`` reads the kernel's launches, n_layers · (2 + T) here."""
    cfg32 = cfg.replace(dtype="float32")
    V, L = cfg.vocab_size, cfg.n_layers
    B, S, T = anchor["B"], anchor["S"], anchor["T"]
    t0 = time.perf_counter()
    model = model_mod.init_params(
        cfg32, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    toks = torch.from_numpy(rng.integers(0, V, (B, S + T))).cuda()
    reset_counts()
    full = model_mod.forward(model, {"tokens": toks})
    torch.cuda.synchronize()
    check(full.shape == (B, S + T, V) and bool(torch.isfinite(full).all()),
          f"{tag} anchor: bad forward logits")
    cache = model_mod.init_cache(cfg32, B, S + T)
    first, cache = model_mod.prefill(model, {"tokens": toks[:, :S]}, cache)
    steps = [first]
    for t in range(T):
        pos = torch.full((B,), S + t, dtype=torch.int32, device="cuda")
        logits, cache = model_mod.decode_step(model, toks[:, S + t], pos, cache)
        steps.append(logits)
    torch.cuda.synchronize()
    launches = count()
    check(launches == L * (2 + T), f"{tag} anchor: {launches} kernel "
          f"launches, want {L * (2 + T)}")
    dec = torch.stack(steps, 1)                       # (B, T+1, V)
    dec_excess, dec_err = close_excess(dec, full[:, S - 1:], ANCHOR_TOL)
    log(f"[{tag}] anchor {cfg.arch_id} f32 ({n_params / 1e9:.3f}e9 params) "
        f"B={B} S={S} T={T}: prefill + {T} decode steps vs forward max|err| "
        f"{dec_err:.3e} (max|logit| {float(full.abs().max()):.2f}; "
        f"tol {ANCHOR_TOL:g} abs + {ANCHOR_TOL:g} rel)")
    check(dec_excess <= ANCHOR_TOL, f"{tag} anchor: teacher-forced decode "
          f"disagrees with forward (excess {dec_excess})")
    del cache, steps, dec
    with plain_ctx():
        plain = model_mod.forward(model, {"tokens": toks})
        check(count() == launches, "the plain forward launched the kernel")
    torch.cuda.synchronize()
    fwd_excess, fwd_err = close_excess(full, plain, ANCHOR_TOL)
    log(f"[{tag}] anchor forward through the kernel vs through the plain "
        f"version: max|err| {fwd_err:.3e} (tol {ANCHOR_TOL:g} abs + "
        f"{ANCHOR_TOL:g} rel); {time.perf_counter() - t0:.1f} s")
    check(fwd_excess <= ANCHOR_TOL, f"{tag} anchor: kernel forward disagrees "
          f"with the plain forward (excess {fwd_excess})")
    del model, full, plain
    torch.cuda.empty_cache()
    return {"B": B, "S": S, "T": T, "dtype": "float32", "params": n_params,
            "decode_vs_forward_max_abs_err": dec_err,
            "kernel_vs_plain_forward_max_abs_err": fwd_err,
            "launches": launches}


def lm_wave(tag, model_mod, model, cfg, prompts, new, max_len, count,
            by_route=None):
    """The served bf16 wave through ``ServeEngine``: the prompts in one
    wave, ``new`` tokens each, greedy; ``count()`` (the launches of the
    first wave, counted from 0) must be n_layers · ``new``; a second
    greedy wave and two seeded temperature waves must repeat their
    tokens.  ``by_route()``, if given, reads the first wave's launches by
    route.  Returns the engine, the requests' maker, the greedy tokens,
    the left-padded batch and the wave's numbers."""
    from repro_torch.serve.engine import Request, ServeEngine
    V = cfg.vocab_size

    def requests():
        return [Request(p, max_new_tokens=new) for p in prompts]

    B = len(prompts)
    engine = ServeEngine(model, cfg, batch_size=B, max_len=max_len)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = engine.generate(requests())
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = count()
    routes = None if by_route is None else by_route()
    want = cfg.n_layers * new
    log(f"[{tag}] served wave ({B} prompts of {[len(p) for p in prompts]} "
        f"tokens, {new} new each, greedy) in {t_first:.2f} s; the kernel "
        f"launched {launches} times (want {want})")
    check(launches == want, f"{tag} served wave: {launches} kernel "
          f"launches, want {want}")
    toks = [r.out_tokens for r in first]
    check(all(len(t) == new and all(0 <= x < V for x in t) for t in toks),
          f"{tag} served wave: wrong token counts or ids")
    t0 = time.perf_counter()
    toks_2 = [r.out_tokens for r in engine.generate(requests())]
    torch.cuda.synchronize()
    t_wave = time.perf_counter() - t0
    check(toks_2 == toks, f"{tag} served wave: a second greedy run gave "
          f"other tokens")
    sampled = []
    for _ in range(2):
        hot = ServeEngine(model, cfg, batch_size=B, max_len=max_len,
                          temperature=SERVE_TEMPERATURE, seed=0)
        sampled.append([r.out_tokens for r in hot.generate(requests())])
    check(sampled[0] == sampled[1] and all(
        len(t) == new and all(0 <= x < V for x in t) for t in sampled[0]),
        f"{tag}, temperature {SERVE_TEMPERATURE}, seed 0: runs differ")
    log(f"[{tag}] second greedy wave: same tokens, {t_wave:.3f} s "
        f"({B * new / t_wave:.1f} tokens/s); temperature "
        f"{SERVE_TEMPERATURE} seed 0 twice: same tokens "
        f"({sum(a != b for x, y in zip(sampled[0], toks) for a, b in zip(x, y))}"
        f" of {B * new} differ from greedy); first tokens "
        f"{[t[:4] for t in toks]}")
    S = max(len(p) for p in prompts)
    batch = np.zeros((B, S), np.int64)
    for i, p in enumerate(prompts):
        batch[i, S - len(p):] = p
    batch = {"tokens": torch.from_numpy(batch).cuda()}
    return engine, requests, toks, batch, {
        "arch": cfg.arch_id, "dtype": cfg.dtype, "batch": B,
        "prompts": [len(p) for p in prompts], "new_tokens": new,
        "max_len": max_len, "launches": launches,
        "launches_by_route": routes, "first_wave_s": t_first,
        "wave_s": t_wave, "tokens_per_s": B * new / t_wave}


def wave_times(tag, model_mod, model, engine, requests, batch, new, max_len,
               kernel, match=None):
    """Where a served wave's time goes: prefill (three runs, each synced),
    each decode step with the engine's one read-back, and
    ``torch.profiler`` windows over the decode steps and over one whole
    wave; ``kernel`` names the port's kernel, and a profiled kernel whose
    name holds one of ``match`` (default: ``kernel``) is counted as its."""
    match = (kernel,) if match is None else match
    B, S = batch["tokens"].shape

    def prefill():
        cache = model_mod.init_cache(model.cfg, B, max_len)
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
    dec_kernels, dec_us = profile_kernels(lambda: decode(cur, cache, []))
    del cache
    kernels, window_us = profile_kernels(lambda: engine.generate(requests()))
    k_us = sum(us for name, us in kernels.items()
               if any(m in name for m in match))
    dec_k_us = sum(us for name, us in dec_kernels.items()
                   if any(m in name for m in match))
    log(f"[{tag}] prefill {statistics.median(pre_ms):.2f} ms (of {pre_ms}); "
        f"decode step median {statistics.median(dec_ms):.3f} ms (min "
        f"{min(dec_ms):.3f}, max {max(dec_ms):.3f})")
    log(f"[{tag}] profiled {new - 1} decode steps: device "
        f"{sum(dec_kernels.values()) / (new - 1) / 1e3:.3f} ms a step, "
        f"{kernel} {dec_k_us / (new - 1) / 1e3:.3f} ms a step; "
        + describe_profile(dec_kernels, dec_us, top=6))
    log(f"[{tag}] profiled one wave: {kernel} kernels {k_us:.1f} us; "
        + describe_profile(kernels, window_us, top=8))
    return {
        "prefill_ms": statistics.median(pre_ms), "prefill_ms_all": pre_ms,
        "decode_step_ms_median": statistics.median(dec_ms),
        "decode_step_ms_all": dec_ms,
        "profiled_wave_us": window_us,
        "profiled_device_busy_share": sum(kernels.values()) / window_us,
        f"profiled_{kernel}_us": k_us,
        "profiled_decode_us": dec_us,
        "profiled_decode_busy_share": sum(dec_kernels.values()) / dec_us,
        "profiled_decode_device_us": sum(dec_kernels.values()),
        f"profiled_decode_{kernel}_us": dec_k_us,
        "profiled_kernel_us": dict(sorted(kernels.items(),
                                          key=lambda kv: -kv[1])[:12])}


def lm_phase(fa_ops):
    """The LM serving path of gemma2-2b at full width: the f32 anchor
    (forward == teacher-forced prefill + decode, kernel == plain), then
    the served bf16 wave through ``ServeEngine``."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import model as model_mod
    cfg = get_config(LM_ARCH)
    rng = np.random.default_rng(SEED)
    count = lambda: fa_ops.flash_attention.launches  # noqa: E731
    by_route = lambda: dict(fa_ops.flash_attention.launches_by_route)  # noqa: E731
    out = {"anchor": lm_anchor("lm", model_mod, cfg, ANCHOR, rng, count,
                               lambda: plain_attention(attn_mod))}
    # the f32 anchor: forward and prefill on the CUDA cores (TF32 stays
    # off), its T decode steps on the decode kernel
    out["anchor"]["launches_by_route"] = routes = by_route()
    want = {"wgmma": 0, "decode": cfg.n_layers * ANCHOR["T"],
            "cuda_cores": 2 * cfg.n_layers}
    log(f"[lm] anchor launches by route {routes} (want {want})")
    check(routes == want, f"f32 anchor: launches by route {routes}, want "
          f"{want}")

    model = model_mod.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_PROMPTS]
    engine, requests, toks, batch, serve = lm_wave(
        "lm", model_mod, model, cfg, prompts, SERVE_NEW, SERVE_MAX_LEN, count,
        by_route)
    # every prefill layer on the tensor cores, every decode step on the
    # decode kernel
    routes = serve["launches_by_route"]
    want = {"wgmma": cfg.n_layers, "decode": cfg.n_layers * (SERVE_NEW - 1),
            "cuda_cores": 0}
    log(f"[lm] served wave launches by route {routes} (want {want})")
    check(routes == want, f"served wave: launches by route {routes}, want "
          f"{want}")

    # the served wave held to the plain version: the logits of prefill
    # and of the decode steps teacher-forced on the greedy tokens, and
    # the greedy tokens; wrong decode attentions must fail the logits
    # check
    toks_t = torch.tensor(toks, device="cuda")
    logits_k = served_logits(model_mod, model, batch, toks_t, SERVE_MAX_LEN)
    n0 = count()
    with plain_attention(attn_mod):
        logits_p = served_logits(model_mod, model, batch, toks_t,
                                 SERVE_MAX_LEN)
    check(count() == n0, "the plain served wave launched the kernel")
    check(torch.equal(logits_k.argmax(-1), toks_t), "served wave: the "
          "teacher-forced kernel logits do not give the engine's tokens")
    top2 = logits_p.topk(2, -1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    same = logits_p.argmax(-1) == toks_t
    n_same, n_steps = int(same.sum()), same.numel()
    serve_err = float((logits_k - logits_p).abs().max())
    log(f"[lm] served wave through the kernel vs through the plain version "
        f"(bf16): logits of prefill + {SERVE_NEW - 1} decode steps max|err| "
        f"{serve_err:.3e} (limit {SERVE_LOGIT_TOL:g}; max|logit| "
        f"{float(logits_p.abs().max()):.2f}); greedy tokens equal at "
        f"{n_same} of {n_steps} steps (least plain top-2 "
        f"margin {margin:.3e})")
    check(serve_err <= SERVE_LOGIT_TOL, f"served wave: kernel logits "
          f"disagree with the plain version's: {serve_err}")
    check(n_same == n_steps, "served wave: the plain version picks other "
          "greedy tokens")
    serve_controls = {}
    for what, change in SERVE_CONTROLS.items():
        with plain_attention(attn_mod, change):
            wrong = served_logits(model_mod, model, batch, toks_t,
                                  SERVE_MAX_LEN)
        serve_controls[what] = float((wrong - logits_p).abs().max())
        check(serve_controls[what] > SERVE_LOGIT_TOL, f"served wave: a "
              f"decode attention with {what} passed the logits check")
        del wrong
    log("[lm] served wave, wrong decode attentions must fail the logits "
        "check and do: " + "; ".join(f"{what} max|err| {e:.3e}" for what, e
                                     in serve_controls.items()))
    del logits_k, logits_p, top2, same
    torch.cuda.empty_cache()
    serve.update({
        "kernel_vs_plain_logits_max_abs_err": serve_err,
        "plain_greedy_equal": [n_same, n_steps],
        "plain_top2_margin_min": margin,
        "wrong_decode_logits_max_abs_err": serve_controls})
    serve.update(wave_times("lm", model_mod, model, engine, requests, batch,
                            SERVE_NEW, SERVE_MAX_LEN, "flash_attention",
                            match=("flash_attention", "flash_decode")))
    out["serve"] = serve
    del model, engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11, falcon-mamba-7b served at full width, and ssm_scan
# ---------------------------------------------------------------------------
SSM_ARCH = "falcon-mamba-7b"
# kernel vs plain: the reference's f32 tolerance (tests/test_kernels.py:
# 18-19) for every input dtype, times max|y| and times each output row's
# max (``ssm_error``).  Both sides convert the same bf16 values exactly
# to f32 and do all their work in f32, so the reference's bf16 tolerance
# (3e-2, for its bf16 kernel against an f32 oracle) covers nothing here
SSM_TOL = 2e-5
SSM_RANK = 256                   # falcon-mamba's dt_rank: B_t, C_t sit at
#                                  stride R + 2N in the x_proj output
# name, B, S, I, N, dtype of x/B_t/C_t, h0 (None: absent, as in the
# cache-free forward; "zero": the engine's fresh cache; "random"), dt
# ("model": softplus of the init's dt_bias, log-uniform dt in [1e-3,
# 1e-1], plus a normal at 0.5; "large": softplus of a standard normal,
# mean ~0.8, decays far from 1), A ("model": -(1..N) on every channel,
# as the init's A_log = log(1..N); "random": -exp(normal)).  The first
# four are the served shapes (falcon-mamba-7b FULL: I=8192, N=16; B=8
# prompts padded to 2048, decode one step, a 4096-token forward).  The
# last two fill the card's grid (1024 blocks), so the kernel's plan
# takes P = 8 states a lane at N = 8 and in f32 (``ssm_lanes``)
SSM_CASES = (
    ("prefill bf16 h0 zero", 8, 2048, 8192, 16, _BF16, "zero", "model", "model"),
    ("decode bf16", 8, 1, 8192, 16, _BF16, "random", "model", "model"),
    ("prefill bf16 h0 random", 8, 2048, 8192, 16, _BF16, "random", "model",
     "model"),
    ("forward B=4 S=4096 bf16", 4, 4096, 8192, 16, _BF16, None, "model",
     "model"),
    ("prefill bf16 large dt", 8, 2048, 8192, 16, _BF16, "random", "large",
     "random"),
    ("I=100 N=4 S=33 f32", 1, 33, 100, 4, _F32, "random", "model", "random"),
    ("I=100 N=8 S=33 f32 large dt", 1, 33, 100, 8, _F32, "random", "large",
     "model"),
    ("I=100 N=16 S=33 f32 no h0", 1, 33, 100, 16, _F32, None, "model", "model"),
    ("I=100 N=16 S=33 f32 large dt", 1, 33, 100, 16, _F32, "zero", "large",
     "random"),
    ("I=100 N=4 S=1 f32", 1, 1, 100, 4, _F32, "random", "large", "random"),
    ("I=100 N=8 S=1 f32", 1, 1, 100, 8, _F32, "random", "model", "model"),
    ("I=100 N=16 S=1 f32", 1, 1, 100, 16, _F32, "random", "model", "model"),
    ("I=100 N=4 S=33 bf16", 2, 33, 100, 4, _BF16, "random", "model",
     "random"),
    ("I=100 N=8 S=33 bf16 large dt", 2, 33, 100, 8, _BF16, "random", "large",
     "model"),
    ("N=8 S=33 bf16 full grid", 8, 33, 8192, 8, _BF16, "random", "model",
     "model"),
    ("N=16 S=33 f32 full grid", 8, 33, 8192, 16, _F32, "random", "model",
     "random"),
)
SSM_MAIN = SSM_CASES[:2]
# phase 11 runs every case of at most this many steps under every states
# a lane P the source builds (``kernel.LANE_STATES``, P <= N), not only
# the one the kernel's plan picks, so each (N, P) and dtype of each entry
# is held to the plain version on the card
SSM_LANE_STEPS = 33
# the plan's two sides, timed at P = 4 and P = 8 for both entries (N = 16
# bf16, I = 8192): prefill of 2048 steps at B = 2 (256 blocks, P = 4 by
# the plan) and at the served B = 8 (1024 blocks, P = 8), decode at B = 1
# and 8
SSM_LANE_SHAPES = ((2, 2048), (8, 2048), (1, 1), (8, 1))
# the served wave: 8 short-chat prompts left-padded to 2048, 32 new
# tokens each (greedy, and T=0.8 seed 0); the state cache does not grow
SSM_PROMPTS = (2048, 1536, 1024, 768, 512, 256, 64, 17)
SSM_NEW = 32
SSM_MAX_LEN = 2048 + 32
# the served wave's logits (prefill and 31 teacher-forced decode steps,
# bf16) through the kernel against through the plain version: the worst
# (request, step) relative L2 distance |l - l_plain| / |l_plain|.  Set
# before any chip reading at ~4x what the CPU shows when every scan's y
# and h_final of the same model are moved by 1e-6 relative noise: the
# kernel's scans sit ~1e-6 from the plain ones, and bf16 rounding flips
# grow with depth (64 bf16 layers at d_model 256, prompts of 2048, 1024,
# 64 and 17 tokens, 8 decode steps: 0.037; 0.034-0.038 at d_model 256
# and 1024 over 256 tokens).  The decode scans that must fail it, which
# read 0.40 and 0.58 in that CPU setting: the carried state ignored, and
# another request's state
SSM_SERVE_TOL = 0.15
SSM_SERVE_CONTROLS = {
    "state ignored": lambda kw: dict(kw, h0=None),
    "another request's state": lambda kw: dict(kw, h0=kw["h0"].roll(1, 0)),
}
# the full-width f32 anchor: teacher-forced prefill + decode = forward,
# the reference's own check and tolerance (tests/test_decode_consistency.py
# :20-41)
SSM_ANCHOR = dict(B=2, S=1024, T=4)
# the fused mixer entry (``ops.mamba_scan``), as ``SSM_CASES`` but with
# dt_lin and dt_bias in place of dt ("model": dt_bias the init's inverse
# softplus of a log-uniform dt in [1e-3, 1e-1], dt_lin 0.5 x normal;
# "large": dt_bias 0.5 x normal, dt_lin normal; "above 20": dt_bias 0.5 x
# normal, dt_lin 12 x normal, so ~10 % of dt_lin + dt_bias pass
# softplus's threshold 20), A_log in place of A ("model": log(1..N);
# "random": normal), D = 1 + 0.25 x normal, z a strided half of a (B, S,
# 2I) tensor as ``in_proj``'s output.  The first two are the served
# prefill and decode shapes; the last two fill the grid, as in
# ``SSM_CASES``
SSM_FUSED_CASES = (
    ("fused prefill bf16 h0 zero", 8, 2048, 8192, 16, _BF16, "zero", "model",
     "model"),
    ("fused decode bf16", 8, 1, 8192, 16, _BF16, "random", "model", "model"),
    ("fused prefill bf16 h0 random", 8, 2048, 8192, 16, _BF16, "random",
     "model", "model"),
    ("fused forward B=4 S=4096 bf16", 4, 4096, 8192, 16, _BF16, None,
     "model", "model"),
    ("fused prefill bf16 large dt", 8, 2048, 8192, 16, _BF16, "random",
     "large", "random"),
    ("fused prefill bf16 dt above 20", 8, 2048, 8192, 16, _BF16, "random",
     "above 20", "model"),
    ("fused I=100 N=16 S=33 bf16", 2, 33, 100, 16, _BF16, "random", "model",
     "random"),
    ("fused I=100 N=4 S=33 f32", 1, 33, 100, 4, _F32, "random", "model",
     "random"),
    ("fused I=100 N=8 S=33 f32 large dt", 1, 33, 100, 8, _F32, "random",
     "large", "model"),
    ("fused I=100 N=16 S=33 f32 no h0", 1, 33, 100, 16, _F32, None, "model",
     "model"),
    ("fused I=100 N=16 S=33 f32 dt above 20", 1, 33, 100, 16, _F32, "zero",
     "above 20", "random"),
    ("fused I=100 N=4 S=1 f32", 1, 1, 100, 4, _F32, "random", "large",
     "random"),
    ("fused I=100 N=8 S=1 f32", 1, 1, 100, 8, _F32, "random", "model",
     "model"),
    ("fused I=100 N=16 S=1 f32 dt above 20", 1, 1, 100, 16, _F32, "random",
     "above 20", "model"),
    ("fused I=100 N=4 S=33 bf16", 2, 33, 100, 4, _BF16, "random", "model",
     "random"),
    ("fused I=100 N=8 S=33 bf16 large dt", 2, 33, 100, 8, _BF16, "zero",
     "large", "model"),
    ("fused N=8 S=33 bf16 full grid", 8, 33, 8192, 8, _BF16, "random",
     "model", "model"),
    ("fused N=16 S=33 f32 full grid", 8, 33, 8192, 16, _F32, "random",
     "model", "random"),
    # the training steps' calls (phase 12): B=1, S=2048, no state
    ("fused train B=1 S=2048 bf16", 1, 2048, 8192, 16, _BF16, None, "model",
     "model"),
)
SSM_FUSED_MAIN = SSM_FUSED_CASES[:2]


def ssm_inputs(case, dev="cuda"):
    """Keyword arguments of one ``SSM_CASES`` scan, drawn on ``dev`` from a
    generator seeded with the case's place in ``SSM_CASES`` (by name, so a
    case cut to fewer channels draws from the same seed).  B_t and C_t
    are slices of one (B, S, R + 2N) tensor, as the model passes them."""
    name, B, S, I, N, dtype, h0, dt_kind, a_kind = case
    seed = SEED + [c[0] for c in SSM_CASES].index(name)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(B, S, I).to(dtype)
    if dt_kind == "model":
        u = torch.rand(I, generator=gen, device=dev)
        dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        dt = F.softplus(torch.log(torch.expm1(dt0)) + 0.5 * normal(B, S, I))
    else:
        dt = F.softplus(normal(B, S, I))
    xdb = normal(B, S, SSM_RANK + 2 * N).to(dtype)
    if a_kind == "model":
        A = -torch.arange(1, N + 1, dtype=_F32, device=dev).expand(I, N)
    else:
        A = -torch.exp(normal(I, N))
    return {"x": x, "dt": dt, "Bc": xdb[..., SSM_RANK:SSM_RANK + N],
            "Cc": xdb[..., SSM_RANK + N:], "A": A.contiguous(),
            "h0": None if h0 is None else (
                torch.zeros(B, I, N, device=dev) if h0 == "zero"
                else normal(B, I, N))}


def ssm_error(y, h, y_ref, h_ref):
    """The scan check of (y, h_final) against the plain version's: max|y -
    y_ref|, max|y_ref|, max|h - h_ref|, max|h_ref| and the worst row's
    ratio of its max|diff| over ``SSM_TOL`` times its own max|ref|, over
    the rows of y (one step of one sequence, all channels) and of h_final
    (one sequence).  The check passes when both maxima are within
    ``SSM_TOL`` of max|ref| and the ratio is at most 1."""
    dy, my = (y - y_ref).abs().amax(-1), y_ref.abs().amax(-1)
    dh = (h - h_ref).abs().flatten(1).amax(-1)
    mh = h_ref.abs().flatten(1).amax(-1)
    ratio = max(float(torch.where(d > 0, d / (SSM_TOL * m),
                                  torch.zeros_like(d)).max())
                for d, m in ((dy, my), (dh, mh)))
    return (float(dy.max()), float(my.max()), float(dh.max()),
            float(mh.max()), ratio)


def ssm_passes(err_y, scale_y, err_h, scale_h, ratio) -> bool:
    """Whether ``ssm_error``'s numbers pass the check."""
    return (err_y <= SSM_TOL * scale_y and err_h <= SSM_TOL * scale_h
            and ratio <= 1.0)


def ssm_controls(kw):
    """The scans that miss what the check must see, as changed keyword
    arguments: the carried state ignored (where there is one), C_t taken
    from step t-1 (zeros at step 0), the last step dropped (dt = 0 there:
    the state stays, no input).  The check must fail each."""
    out = {}
    if kw["h0"] is not None and bool(kw["h0"].any()):
        out["h0 ignored"] = dict(kw, h0=None)
    prev = torch.zeros_like(kw["Cc"])
    prev[:, 1:] = kw["Cc"][:, :-1]
    out["C_t from step t-1"] = dict(kw, Cc=prev)
    dt = kw["dt"].clone()
    dt[:, -1] = 0.0
    out["last step dropped"] = dict(kw, dt=dt)
    return out


def ssm_bound_ms(kw):
    """Least time for one call: x, dt, B_t, C_t, A and h0 read once, y and
    h_final written once, against the B·S·I·N exponentials at the SFU rate
    and ~6 f32 flops per (b, t, i, n) (dt·A, the decay, the input, the
    output) at the f32 rate; the larger, with the one that bounds."""
    x, Bc = kw["x"], kw["Bc"]
    B, S, I = x.shape
    N = Bc.shape[-1]
    nbytes = (x.numel() * x.element_size() + 4 * kw["dt"].numel()
              + 2 * B * S * N * Bc.element_size() + 4 * kw["A"].numel()
              + (0 if kw["h0"] is None else 4 * kw["h0"].numel())
              + 4 * B * S * I + 4 * B * I * N)
    n_exp = B * S * I * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_exp / SFU_PER_S, 6.0 * n_exp / F32_FLOPS_PER_S) * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, nbytes, n_exp


def ssm_fused_inputs(case, dev="cuda"):
    """Keyword arguments of one ``SSM_FUSED_CASES`` mixer scan, drawn on
    ``dev`` from a generator seeded with the case's place (by name).  x,
    dt_lin and z in the case's dtype, B_t and C_t slices of one (B, S,
    R + 2N) tensor and z the second half of one (B, S, 2I) tensor, as
    the model passes them; dt_bias, D, A_log float32."""
    name, B, S, I, N, dtype, h0, dt_kind, a_kind = case
    seed = SEED + 100 + [c[0] for c in SSM_FUSED_CASES].index(name)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(B, S, I).to(dtype)
    if dt_kind == "model":
        u = torch.rand(I, generator=gen, device=dev)
        dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        dt_bias, dt_lin = torch.log(torch.expm1(dt0)), 0.5 * normal(B, S, I)
    else:
        dt_bias = 0.5 * normal(I)
        dt_lin = (12.0 if dt_kind == "above 20" else 1.0) * normal(B, S, I)
    xdb = normal(B, S, SSM_RANK + 2 * N).to(dtype)
    xz = normal(B, S, 2 * I).to(dtype)
    A_log = (torch.log(torch.arange(1, N + 1, dtype=_F32, device=dev))
             .expand(I, N).contiguous() if a_kind == "model"
             else normal(I, N))
    return {"x": x, "dt_lin": dt_lin.to(dtype), "dt_bias": dt_bias,
            "Bc": xdb[..., SSM_RANK:SSM_RANK + N],
            "Cc": xdb[..., SSM_RANK + N:], "A_log": A_log,
            "D": 1.0 + 0.25 * normal(I), "z": xz[..., I:],
            "h0": None if h0 is None else (
                torch.zeros(B, I, N, device=dev) if h0 == "zero"
                else normal(B, I, N))}


def ssm_fused_reference(kw, softplus=True, gate=True, round_y=False):
    """The plain mixer chain on ``kw`` (the ops of ``mamba_scan_ref``, one
    plain scan): (out, h_final, u, s) with u = y + D x (f32) and s =
    silu(z) (in z's dtype), the two values the output rounds from.
    ``softplus=False`` or ``gate=False`` drop that piece, and
    ``round_y=True`` rounds y to x's dtype before the D skip, to make a
    wrong scan."""
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    x = kw["x"]
    v = kw["dt_lin"] + kw["dt_bias"]
    dt = (F.softplus(v) if softplus else v).to(_F32)
    y, h = selective_scan_ref(x, dt, kw["Bc"], kw["Cc"],
                              -torch.exp(kw["A_log"]), kw["h0"])
    u = (y.to(x.dtype).to(_F32) if round_y else y) + kw["D"] * x.to(_F32)
    s = F.silu(kw["z"]) if gate else torch.ones_like(kw["z"])
    return u.to(x.dtype) * s, h, u, s


def _ulp(v, dtype):
    """The spacing of ``dtype`` at |v| (elementwise, float32)."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.full_like(v, torch.finfo(dtype).eps, dtype=_F32),
                       e - 1)


def ssm_fused_error(out, h, ref):
    """The fused check of (out, h_final) against ``ssm_fused_reference``'s
    (out_r, h_r, u, s): max|out - out_r|, max|pre| (pre = u·s in f32, the
    value before the roundings), max|h - h_r|, max|h_r| and the worst
    element's ratio of its |diff| over its limit, ``SSM_TOL`` times its
    row's max|pre| (a row: one step of one sequence, all channels) plus
    one ulp of the model dtype at each of the two roundings the output
    passes (|s|·ulp(u) for u.to(dtype), ulp(out_r) for the product): a
    2e-5 difference in y may flip either.  h_final's rows are held to
    ``SSM_TOL`` of their max, as in ``ssm_error``.  The check passes when
    the ratio is at most 1 (NaN fails)."""
    out_r, h_r, u, s = ref
    dtype = out_r.dtype
    sf = s.float()
    pre = u * sf
    limit = (SSM_TOL * pre.abs().amax(-1, keepdim=True)
             + sf.abs() * _ulp(u, dtype) + _ulp(out_r, dtype))
    d = (out.float() - out_r.float()).abs()
    dh = (h - h_r).abs().flatten(1).amax(-1)
    mh = h_r.abs().flatten(1).amax(-1)
    ratio = max(float((d / limit).max()),
                float(torch.where(dh > 0, dh / (SSM_TOL * mh),
                                  torch.zeros_like(dh)).max()))
    return (float(d.max()), float(pre.abs().max()), float(dh.max()),
            float(mh.max()), ratio)


def ssm_fused_passes(err_out, scale_pre, err_h, scale_h, ratio) -> bool:
    """Whether ``ssm_fused_error``'s numbers pass the check."""
    return ratio <= 1.0 and err_h <= SSM_TOL * scale_h


def ssm_fused_controls(kw, scan):
    """The mixer scans that miss what the fused check must see, as thunks
    giving (out, h_final): the D skip dropped, ``dt_bias`` dropped and
    (where there is one) the state ignored, through ``scan`` (the entry
    under test); the gate dropped (silu(z) -> 1), the softplus dropped
    and (below float32) y rounded to the model's dtype before the D skip,
    through the plain chain, since no argument of the entry drops them.
    The check must fail each."""
    out = {"D skip dropped": lambda: scan(**dict(kw, D=torch.zeros_like(
               kw["D"]))),
           "dt_bias dropped": lambda: scan(**dict(
               kw, dt_bias=torch.zeros_like(kw["dt_bias"]))),
           "gate dropped": lambda: ssm_fused_reference(kw, gate=False)[:2],
           "softplus dropped": lambda: ssm_fused_reference(
               kw, softplus=False)[:2]}
    if kw["x"].dtype != _F32:
        out["y rounded before the D skip"] = lambda: ssm_fused_reference(
            kw, round_y=True)[:2]
    if kw["h0"] is not None and bool(kw["h0"].any()):
        out["state ignored"] = lambda: scan(**dict(kw, h0=None))
    return out


def ssm_fused_bound_ms(kw):
    """Least time for one fused call: x, dt_lin, z, B_t, C_t, dt_bias, D,
    A_log and h0 read once, out and h_final written once, against the
    special-function ops at the SFU rate -- the scan's B·S·I·N
    exponentials and 3 per (b, t, i), as the kernel's SASS has them: the
    softplus's exp (one MUFU.EX2; its log1p is a polynomial on the FMA
    pipe), the SiLU's exp and its division's reciprocal (MUFU.RCP) --
    and ~6 f32 flops per (b, t, i, n) at the f32 rate; the larger, with
    the one that bounds."""
    x, Bc = kw["x"], kw["Bc"]
    B, S, I = x.shape
    N = Bc.shape[-1]
    es = x.element_size()
    nbytes = (4 * B * S * I * es + 2 * B * S * N * Bc.element_size()
              + 4 * I * N + 8 * I
              + (0 if kw["h0"] is None else 4 * kw["h0"].numel())
              + 4 * B * I * N)
    n_sfu = B * S * I * (N + 3)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(n_sfu / SFU_PER_S, 6.0 * B * S * I * N / F32_FLOPS_PER_S) * 1e3
    bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return bound, nbytes, n_sfu


def ssm_lanes(ssm_kernel, case, n_sm):
    """The states a lane P phase 11 runs ``case`` at on a card of ``n_sm``
    SMs: the kernel's plan first, then, for a case of at most
    ``SSM_LANE_STEPS`` steps, every other P the source builds for its
    N."""
    B, S, I, N = case[1:5]
    P = ssm_kernel.plan(B, I, N, n_sm)
    return [P] + [p for p in ssm_kernel.LANE_STATES
                  if p <= N and p != P and S <= SSM_LANE_STEPS]


def ssm_all_lanes(ssm_kernel):
    """Every (N, P, dtype) the source builds, for each entry."""
    return {(N, P, str(dt)) for N in ssm_kernel.STATE_SIZES
            for P in ssm_kernel.LANE_STATES if P <= N
            for dt in (_F32, _BF16)}


def ssm_refusals(ssm_ops):
    """Both entries refuse an h0 (and the fused one an h_out) that does
    not start on a 16-byte boundary with a ValueError, and count no
    launch."""
    small = next(c for c in SSM_CASES if c[3] == 100 and c[6] == "random")
    fsmall = next(c for c in SSM_FUSED_CASES
                  if c[3] == 100 and c[6] == "random")
    kw, fkw = ssm_inputs(small), ssm_fused_inputs(fsmall)

    def shifted(t):
        return torch.empty(t.numel() + 1, device=t.device)[1:].view_as(
            t).copy_(t)

    calls = {"selective_scan h0": lambda: ssm_ops.selective_scan(
                 **dict(kw, h0=shifted(kw["h0"]))),
             "mamba_scan h0": lambda: ssm_ops.mamba_scan(
                 **dict(fkw, h0=shifted(fkw["h0"]))),
             "mamba_scan h_out": lambda: ssm_ops.mamba_scan(
                 **fkw, h_out=shifted(fkw["h0"]))}
    for what, call in calls.items():
        n0 = ssm_ops.selective_scan.launches
        try:
            call()
            refused = False
        except ValueError:
            refused = True
        torch.cuda.synchronize()
        check(refused and ssm_ops.selective_scan.launches == n0,
              f"{what} off a 16-byte boundary was not refused")
    log(f"[kernel] ssm_scan refuses a misaligned {', '.join(calls)} "
        f"(ValueError, no launch counted)")


def ssm_lane_times(ssm_kernel):
    """Both entries at P = 4 and P = 8 on each side of the plan's grid
    threshold (``SSM_LANE_SHAPES``): device time (one CUDA graph)."""
    rows = []
    for B, S in SSM_LANE_SHAPES:
        tail = (B, S, 8192, 16, _BF16, "random", "model", "model")
        kw = ssm_inputs(("prefill bf16 h0 random" if S > 1 else
                         "decode bf16",) + tail)
        fkw = ssm_fused_inputs(("fused prefill bf16 h0 random" if S > 1
                                else "fused decode bf16",) + tail)
        plan = ssm_kernel.plan(B, 8192, 16, ssm_kernel._sm_count(0))
        reps, inner = (5, 5) if S > 1 else (20, 20)
        for entry, fn in (
                ("selective_scan",
                 lambda P: ssm_kernel.launch(**kw, P=P)),
                ("mamba_scan",
                 lambda P: ssm_kernel.launch_fused(**fkw, h_out=fkw["h0"],
                                                   P=P))):
            t = {P: graph_ms(lambda: fn(P), reps=reps, inner=inner)
                 for P in ssm_kernel.LANE_STATES}
            rows.append({"entry": entry, "B": B, "S": S, "I": 8192, "N": 16,
                         "blocks": B * 8192 // 64, "plan_P": plan,
                         "graph_ms_by_P": t})
            log(f"[lanes] {entry:14s} B={B} S={S:4d} ({B * 128:4d} blocks, "
                f"plan P={plan}): " + ", ".join(
                    f"P={P} {v * 1e3:9.2f} us" for P, v in t.items()))
        del kw, fkw
        torch.cuda.synchronize()
    return rows


def ssm_kernel_phase():
    """ssm_scan against its plain version at the served shapes and at edge
    shapes (each launched twice: the bytes must not move; the short ones
    under every states a lane P, ``ssm_lanes``), the scans that must fail
    (``ssm_controls``), the refusals, then the times at the served
    prefill and decode shapes and on each side of the plan's threshold."""
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    max_abs_err, by_case, covered = 0.0, [], set()
    for case in SSM_CASES:
        name = case[0]
        kw = ssm_inputs(case)
        y, h = ssm_ops.selective_scan(**kw)
        y2, h2 = ssm_ops.selective_scan(**kw)
        y_ref, h_ref = selective_scan_ref(**kw)
        torch.cuda.synchronize()
        check(y.shape == y_ref.shape and h.shape == h_ref.shape
              and y.dtype == h.dtype == _F32 and bool(torch.isfinite(y).all())
              and bool(torch.isfinite(h).all()), f"{name}: bad output")
        check(torch.equal(y, y2) and torch.equal(h, h2),
              f"{name}: two launches gave different bytes")
        err_y, scale_y, err_h, scale_h, ratio = ssm_error(y, h, y_ref, h_ref)
        log(f"[kernel] ssm_scan {name:30s} max|err| y {err_y:.3e} / max|y| "
            f"{scale_y:.3e}, h_final {err_h:.3e} / {scale_h:.3e} (tol "
            f"{SSM_TOL:g} x max); worst row {ratio:.3f} of its limit; "
            f"relaunch bitwise equal")
        check(ssm_passes(err_y, scale_y, err_h, scale_h, ratio),
              f"{name}: kernel disagrees with the plain version: y {err_y}, "
              f"h {err_h}, worst row {ratio} of its limit")
        controls = {}
        for what, wrong_kw in ssm_controls(kw).items():
            wy, wh = ssm_ops.selective_scan(**wrong_kw)
            w = ssm_error(wy, wh, y_ref, h_ref)
            controls[what] = {"max_abs_err_y": w[0], "max_abs_err_h": w[2],
                              "worst_row_ratio": w[4]}
            check(not ssm_passes(*w), f"{name}: a scan with {what} passed "
                  f"the check")
            del wy, wh, wrong_kw
        log(f"[kernel] ssm_scan {name:30s} must fail and does: "
            + "; ".join(f"{what} worst row {c['worst_row_ratio']:.3g} of its "
                        f"limit" for what, c in controls.items()))
        lanes = ssm_lanes(ssm_kernel, case, ssm_kernel._sm_count(0))
        ratios = {lanes[0]: ratio}
        for P in lanes[1:]:
            fy, fh = ssm_kernel.launch(**kw, P=P)
            fy2, fh2 = ssm_kernel.launch(**kw, P=P)
            torch.cuda.synchronize()
            check(torch.equal(fy, fy2) and torch.equal(fh, fh2),
                  f"{name} P={P}: two launches gave different bytes")
            w = ssm_error(fy, fh, y_ref, h_ref)
            check(ssm_passes(*w), f"{name} P={P}: kernel disagrees with the "
                  f"plain version: y {w[0]}, h {w[2]}, worst row {w[4]}")
            ratios[P] = w[4]
            del fy, fh, fy2, fh2
        covered.update(("selective_scan", case[4], P, str(case[5]))
                       for P in ratios)
        log(f"[kernel] ssm_scan {name:30s} states a lane: " + ", ".join(
            f"P={P}{' (plan)' if P == lanes[0] else ''} worst row "
            f"{r:.3f}" for P, r in ratios.items()) + "; relaunch bitwise")
        by_case.append({"name": name, "max_abs_err_y": err_y,
                        "max_abs_y": scale_y, "max_abs_err_h": err_h,
                        "max_abs_h": scale_h, "worst_row_ratio": ratio,
                        "worst_row_ratio_by_P": ratios, "controls": controls})
        if case in SSM_MAIN:
            max_abs_err = max(max_abs_err, err_y, err_h)
        del kw, y, h, y2, h2, y_ref, h_ref
    torch.cuda.synchronize()
    ssm_refusals(ssm_ops)

    rows = []
    for case in SSM_MAIN:
        name, B, S, I, N, dtype = case[:6]
        kw = ssm_inputs(case)
        reps, inner = (5, 5) if S > 1 else (20, 20)
        k_ms = time_ms(lambda: ssm_ops.selective_scan(**kw), reps=reps,
                       inner=inner)
        g_ms = graph_ms(lambda: ssm_ops.selective_scan(**kw), reps=reps,
                        inner=inner)
        p_ms = time_ms(lambda: selective_scan_ref(**kw), reps=3 if S > 1
                       else reps, inner=1 if S > 1 else inner)
        (b_ms, b_by), nbytes, n_exp = ssm_bound_ms(kw)
        rows.append({"shape": {"name": name, "B": B, "S": S, "I": I, "N": N,
                               "dtype": "bf16", "h0": case[6]},
                     "kernel_ms": k_ms, "kernel_graph_ms": g_ms,
                     "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "exponentials": n_exp})
        log(f"[time] ssm_scan {name:20s} kernel {k_ms * 1e3:10.2f} us (graph "
            f"{g_ms * 1e3:10.2f} us)  plain {p_ms * 1e3:12.2f} us  library - "
            f"(no single PyTorch call)  bound {b_ms * 1e3:9.3f} us ({b_by}; "
            f"bytes {nbytes / HBM_BYTES_PER_S * 1e6:.3f} us, exponentials "
            f"{n_exp / SFU_PER_S * 1e6:.3f} us); "
            f"{nbytes / (g_ms * 1e-3) / 1e12:.3f} TB/s, "
            f"{n_exp / (g_ms * 1e-3) / 1e12:.3f} T exp/s")
        del kw
    torch.cuda.synchronize()
    fused_rows, fused_err, fused_cases = ssm_fused_phase(ssm_ops, ssm_kernel,
                                                         covered)
    want = ssm_all_lanes(ssm_kernel)
    for entry in ("selective_scan", "mamba_scan"):
        got = {k[1:] for k in covered if k[0] == entry}
        check(got >= want, f"{entry}: no case ran (N, P, dtype) "
              f"{sorted(want - got)}")
    log(f"[kernel] ssm_scan both entries held to the plain version at every "
        f"(N, P, dtype) the source builds: {sorted(want)}")
    lanes = ssm_lane_times(ssm_kernel)
    return (rows + fused_rows, max(max_abs_err, fused_err),
            by_case + fused_cases, lanes)


def ssm_fused_phase(ssm_ops, ssm_kernel, covered):
    """The fused mixer entry ``mamba_scan`` against the plain chain at
    ``SSM_FUSED_CASES`` (each launched twice: the bytes must not move;
    the short ones under every P, ``ssm_lanes``, each (entry, N, P,
    dtype) added to ``covered``), its wrong scans
    (``ssm_fused_controls``), then its times at the served prefill and
    decode shapes."""
    from repro_torch.kernels.ssm_scan.ref import mamba_scan_ref
    max_abs_err, by_case = 0.0, []
    for case in SSM_FUSED_CASES:
        name = case[0]
        kw = ssm_fused_inputs(case)
        out, h = ssm_ops.mamba_scan(**kw)
        out2, h2 = ssm_ops.mamba_scan(**kw)
        ref = ssm_fused_reference(kw)
        torch.cuda.synchronize()
        check(out.shape == ref[0].shape and out.dtype == ref[0].dtype
              and h.shape == ref[1].shape and h.dtype == _F32
              and bool(torch.isfinite(out).all())
              and bool(torch.isfinite(h).all()), f"{name}: bad output")
        check(torch.equal(out, out2) and torch.equal(h, h2),
              f"{name}: two launches gave different bytes")
        err = ssm_fused_error(out, h, ref)
        n_over = int(((kw["dt_lin"].float() + kw["dt_bias"]) > 20).sum())
        log(f"[kernel] mamba_scan {name:36s} max|err| out {err[0]:.3e} / "
            f"max|pre| {err[1]:.3e}, h_final {err[2]:.3e} / {err[3]:.3e} "
            f"(tol {SSM_TOL:g} x row max + the roundings' ulps); worst "
            f"element {err[4]:.3f} of its limit; relaunch bitwise equal; "
            f"{n_over} dt past softplus's threshold")
        check(ssm_fused_passes(*err), f"{name}: fused kernel disagrees with "
              f"the plain chain: out {err[0]}, h {err[2]}, worst element "
              f"{err[4]} of its limit")
        controls = {}
        for what, wrong in ssm_fused_controls(kw, ssm_ops.mamba_scan).items():
            wo, wh = wrong()
            w = ssm_fused_error(wo, wh, ref)
            controls[what] = {"max_abs_err_out": w[0], "max_abs_err_h": w[2],
                              "worst_element_ratio": w[4]}
            check(not ssm_fused_passes(*w), f"{name}: a mixer scan with "
                  f"{what} passed the check")
            del wo, wh
        log(f"[kernel] mamba_scan {name:36s} must fail and does: "
            + "; ".join(f"{what} worst element "
                        f"{c['worst_element_ratio']:.3g} of its limit"
                        for what, c in controls.items()))
        lanes = ssm_lanes(ssm_kernel, case, ssm_kernel._sm_count(0))
        ratios = {lanes[0]: err[4]}
        for P in lanes[1:]:
            fo, fh = ssm_kernel.launch_fused(**kw, h_out=None, P=P)
            fo2, fh2 = ssm_kernel.launch_fused(**kw, h_out=None, P=P)
            torch.cuda.synchronize()
            check(torch.equal(fo, fo2) and torch.equal(fh, fh2),
                  f"{name} P={P}: two launches gave different bytes")
            w = ssm_fused_error(fo, fh, ref)
            check(ssm_fused_passes(*w), f"{name} P={P}: fused kernel "
                  f"disagrees with the plain chain: out {w[0]}, h {w[2]}, "
                  f"worst element {w[4]}")
            ratios[P] = w[4]
            del fo, fh, fo2, fh2
        covered.update(("mamba_scan", case[4], P, str(case[5]))
                       for P in ratios)
        log(f"[kernel] mamba_scan {name:36s} states a lane: " + ", ".join(
            f"P={P}{' (plan)' if P == lanes[0] else ''} worst element "
            f"{r:.3f}" for P, r in ratios.items()) + "; relaunch bitwise")
        by_case.append({"name": name, "entry": "mamba_scan",
                        "max_abs_err_out": err[0], "max_abs_pre": err[1],
                        "max_abs_err_h": err[2], "max_abs_h": err[3],
                        "worst_element_ratio": err[4],
                        "worst_element_ratio_by_P": ratios,
                        "dt_past_threshold": n_over, "controls": controls})
        if case in SSM_FUSED_MAIN:
            max_abs_err = max(max_abs_err, err[0], err[2])
        del kw, out, h, out2, h2, ref
    torch.cuda.synchronize()

    rows = []
    for case in SSM_FUSED_MAIN:
        name, B, S, I, N, dtype = case[:6]
        # timed as the mixer calls it: the state carried on in place
        kw = ssm_fused_inputs(case)
        kw["h_out"] = kw["h0"]
        reps, inner = (5, 5) if S > 1 else (20, 20)
        k_ms = time_ms(lambda: ssm_ops.mamba_scan(**kw), reps=reps,
                       inner=inner)
        g_ms = graph_ms(lambda: ssm_ops.mamba_scan(**kw), reps=reps,
                        inner=inner)
        ref_kw = {k: v for k, v in kw.items() if k != "h_out"}
        p_ms = time_ms(lambda: mamba_scan_ref(**ref_kw), reps=3 if S > 1
                       else reps, inner=1 if S > 1 else inner)
        (b_ms, b_by), nbytes, n_sfu = ssm_fused_bound_ms(kw)
        rows.append({"shape": {"name": name, "entry": "mamba_scan", "B": B,
                               "S": S, "I": I, "N": N, "dtype": "bf16",
                               "h0": case[6], "state_in_place": True},
                     "kernel_ms": k_ms, "kernel_graph_ms": g_ms,
                     "plain_ms": p_ms, "library_ms": None, "bound_ms": b_ms,
                     "bound_by": b_by, "bytes": nbytes, "sfu_ops": n_sfu})
        log(f"[time] mamba_scan {name:26s} kernel {k_ms * 1e3:10.2f} us "
            f"(graph {g_ms * 1e3:10.2f} us)  plain {p_ms * 1e3:12.2f} us  "
            f"library - (no single PyTorch call)  bound {b_ms * 1e3:9.3f} us "
            f"({b_by}; bytes {nbytes / HBM_BYTES_PER_S * 1e6:.3f} us, "
            f"special-function ops {n_sfu / SFU_PER_S * 1e6:.3f} us); "
            f"{nbytes / (g_ms * 1e-3) / 1e12:.3f} TB/s")
        del kw
    torch.cuda.synchronize()
    return rows, max_abs_err, by_case


@contextlib.contextmanager
def plain_scan(ssm_mod, decode_change=None):
    """Send the model's selective scans (both entries) through the plain
    version on the card, for the comparison only: the port itself has no
    such switch.  Under autograd the plain version is differentiated as
    it stands (the kernel's ``twin`` is dropped).  ``decode_change`` (keyword arguments -> keyword
    arguments), if given, alters the decode scans (one step), to make a
    wrong scan."""
    from repro_torch.kernels.ssm_scan.ref import (mamba_scan_ref,
                                                  selective_scan_ref)

    def plain(x, dt, Bc, Cc, A, *, h0=None):
        kw = dict(x=x, dt=dt, Bc=Bc, Cc=Cc, A=A, h0=h0)
        if decode_change is not None and x.shape[1] == 1:
            kw = decode_change(kw)
        return selective_scan_ref(**kw)

    def plain_fused(x, dt_lin, dt_bias, Bc, Cc, A_log, D, z, *, h0=None,
                    h_out=None, twin=None):
        kw = dict(x=x, dt_lin=dt_lin, dt_bias=dt_bias, Bc=Bc, Cc=Cc,
                  A_log=A_log, D=D, z=z, h0=h0)
        if decode_change is not None and x.shape[1] == 1:
            kw = decode_change(kw)
        out, h = mamba_scan_ref(**kw)
        return out, (h if h_out is None else h_out.copy_(h))

    kernel_ops = ssm_mod.ssm_ops
    ssm_mod.ssm_ops = types.SimpleNamespace(selective_scan=plain,
                                            mamba_scan=plain_fused)
    try:
        yield
    finally:
        ssm_mod.ssm_ops = kernel_ops


def logits_distance(a, b):
    """Worst (request, step) relative L2 distance |a - b| / |b| of logits
    (B, T, V), and max|a - b|."""
    rel = (a - b).norm(dim=-1) / b.norm(dim=-1)
    return float(rel.max()), float((a - b).abs().max())


def mamba_phase(ssm_ops):
    """The serving path of falcon-mamba-7b at full width: the f32 anchor
    (forward == teacher-forced prefill + decode, kernel == plain), then
    the served bf16 wave through ``ServeEngine``."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.models import ssm as ssm_mod
    cfg = get_config(SSM_ARCH)
    rng = np.random.default_rng(SEED)
    count = lambda: ssm_ops.selective_scan.launches  # noqa: E731
    out = {"anchor": lm_anchor("mamba", model_mod, cfg, SSM_ANCHOR, rng,
                               count, lambda: plain_scan(ssm_mod))}

    model = model_mod.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SSM_PROMPTS]
    engine, requests, toks, batch, serve = lm_wave(
        "mamba", model_mod, model, cfg, prompts, SSM_NEW, SSM_MAX_LEN, count)

    # the served wave held to the plain version: the logits of prefill
    # and of the decode steps teacher-forced on the greedy tokens; wrong
    # decode scans must fail the check
    toks_t = torch.tensor(toks, device="cuda")
    logits_k = served_logits(model_mod, model, batch, toks_t, SSM_MAX_LEN)
    n0 = count()
    with plain_scan(ssm_mod):
        logits_p = served_logits(model_mod, model, batch, toks_t, SSM_MAX_LEN)
    check(count() == n0, "the plain served wave launched the kernel")
    check(torch.equal(logits_k.argmax(-1), toks_t), "mamba served wave: the "
          "teacher-forced kernel logits do not give the engine's tokens")
    top2 = logits_p.topk(2, -1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    n_same = int((logits_p.argmax(-1) == toks_t).sum())
    serve_rel, serve_err = logits_distance(logits_k, logits_p)
    log(f"[mamba] served wave through the kernel vs through the plain "
        f"version (bf16): logits of prefill + {SSM_NEW - 1} decode steps, "
        f"worst relative L2 {serve_rel:.3e} (limit {SSM_SERVE_TOL:g}), "
        f"max|err| {serve_err:.3e} (max|logit| "
        f"{float(logits_p.abs().max()):.2f}); plain greedy tokens equal at "
        f"{n_same} of {toks_t.numel()} steps (least plain top-2 margin "
        f"{margin:.3e}; reported, not checked: bf16 rounding moves near "
        f"ties)")
    check(serve_rel <= SSM_SERVE_TOL, f"mamba served wave: kernel logits "
          f"disagree with the plain version's: {serve_rel}")
    serve_controls = {}
    for what, change in SSM_SERVE_CONTROLS.items():
        with plain_scan(ssm_mod, change):
            wrong = served_logits(model_mod, model, batch, toks_t,
                                  SSM_MAX_LEN)
        serve_controls[what] = logits_distance(wrong, logits_p)[0]
        check(serve_controls[what] > SSM_SERVE_TOL, f"mamba served wave: a "
              f"decode scan with {what} passed the logits check")
        del wrong
    log("[mamba] served wave, wrong decode scans must fail the logits check "
        "and do: " + "; ".join(f"{what} worst relative L2 {e:.3e}"
                               for what, e in serve_controls.items()))
    del logits_k, logits_p, top2
    torch.cuda.empty_cache()
    serve.update({
        "kernel_vs_plain_logits_worst_rel_l2": serve_rel,
        "kernel_vs_plain_logits_max_abs_err": serve_err,
        "plain_greedy_equal": [n_same, toks_t.numel()],
        "plain_top2_margin_min": margin,
        "wrong_decode_logits_worst_rel_l2": serve_controls})
    serve.update(wave_times("mamba", model_mod, model, engine, requests,
                            batch, SSM_NEW, SSM_MAX_LEN, "ssm_scan"))
    out["serve"] = serve
    del model, engine
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12, LM training at full width: gradients through the LM kernels
# ---------------------------------------------------------------------------
TRAIN_S = 4608                   # gemma2: the 4096 window binds on the local
                                 # layers (the f32 anchor's S)
TRAIN_STEPS = 10
TRAIN_WARMUP = 2
# the loss (relative) and, per leaf, ||g_kernel - g_plain|| / ||g_plain||,
# by the model's dtype, from the card's readings (PERF.md §2).  float32:
# ~5x the worst (3.9e-06, falcon-mamba's dt_proj; gemma2's 1.0e-06),
# below every control (the softcap dropped in the kernel, 7.0e-05, the
# least).  bfloat16, at the training steps' model, batch and route: ~3x
# the worst (1.7e-02, falcon-mamba; gemma2's 5.8e-03).  A window or
# softcap bug moves bf16 gradients less than bf16 rounding does at this
# init: phases 10 and 11 hold the kernels at the training shapes
# (``FA_CASES``, ``SSM_FUSED_CASES``) with those controls.
TRAIN_GRAD_TOL = {"float32": 2e-5, "bfloat16": 5e-2}
# falcon-mamba at full width (d 4096, I 8192, N 16), depth cut to 8 of 64:
# at 64 layers the f32 moments alone need ~58 GB, ~87 GB of state in all
MAMBA_TRAIN_LAYERS = 8
MAMBA_TRAIN_S = 2048             # ssm_chunk 1024 divides it: the chunked twin
HEAD = dict(m=6, n=40, S=16, rounds=4, rank=3, logistic_rounds=20, lam=0.01)
HEAD_W_RTOL = 1e-4
TRAIN_TARGET_S = 90.0            # the phase's time budget (reported)


def train_batch(cfg, S, step, dev="cuda"):
    """Step ``step`` of the seeded synthetic token stream, B=1, on
    ``dev``."""
    from repro_torch.data.tokens import SyntheticTokenStream, TokenPipelineSpec
    toks, tgts = SyntheticTokenStream(TokenPipelineSpec(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=1,
        seed=SEED)).batch(step)
    return {"tokens": torch.from_numpy(toks).to(dev),
            "targets": torch.from_numpy(tgts).to(dev)}


@contextlib.contextmanager
def swapped_ops(mod, name, **fns):
    """``mod.<name>`` (a model module's handle on a kernel's ``ops``)
    replaced by a namespace of ``fns`` while the block runs; each
    function is made from the real ops module."""
    real = getattr(mod, name)
    setattr(mod, name, types.SimpleNamespace(
        **{k: make(real) for k, make in fns.items()}))
    try:
        yield
    finally:
        setattr(mod, name, real)


def attention_controls(attn_mod, dtype):
    """Wrong attentions that the gradient check in ``dtype`` must fail
    (name -> context): in float32 the kernel launched with the window,
    the softcap or the causal mask dropped (its twin right) and the twin
    with the window or the softcap dropped (the kernel right); in
    bfloat16 the causal mask dropped in the kernel."""
    def kernel_without(**change):
        def make(ops):
            def call(q, k, v, **kw):
                return ops.flash_attention(q, k, v, **dict(kw, **change))
            return call
        return make

    def twin_without(**change):
        def make(ops):
            def call(q, k, v, twin=None, **kw):
                if twin is not None:     # a call under autograd
                    cfg = twin.keywords["cfg"].replace(
                        **change.get("cfg", {}))
                    twin = functools.partial(
                        twin, cfg=cfg, **{k_: v_ for k_, v_ in change.items()
                                          if k_ != "cfg"})
                return ops.flash_attention(q, k, v, twin=twin, **kw)
            return call
        return make

    wrong = {"causal mask dropped in the kernel": kernel_without(
        causal=False)}
    if dtype == "float32":
        wrong.update({
            "window dropped in the kernel": kernel_without(window=None),
            "softcap dropped in the kernel": kernel_without(softcap=None),
            "window dropped in the twin": twin_without(window=None),
            "softcap dropped in the twin": twin_without(
                cfg={"attn_logit_softcap": None})})
    return {what: functools.partial(swapped_ops, attn_mod, "fa_ops",
                                    flash_attention=make)
            for what, make in wrong.items()}


def scan_controls(ssm_mod):
    """Wrong scans that the gradient check must fail (name -> context):
    the kernel launched with the D skip dropped, its twin right; the
    twin with the D skip dropped, the kernel right."""
    from repro_torch._recompute import recompute_vjp

    def kernel_no_skip(ops):
        def call(*inputs, twin=None, **kw):
            def run(*t):
                return ops.mamba_scan(*t[:6], torch.zeros_like(t[6]), t[7],
                                      **kw)
            if twin is None:         # not under autograd
                return run(*inputs)
            return recompute_vjp(run, twin, inputs)
        return call

    def twin_no_skip(ops):
        def call(*inputs, twin=None, **kw):
            def wrong(*t):
                return twin(*t[:6], t[6] * 0, t[7])
            return ops.mamba_scan(*inputs, twin=None if twin is None
                                  else wrong, **kw)
        return call

    keep = lambda ops: ops.selective_scan  # noqa: E731
    return {what: functools.partial(swapped_ops, ssm_mod, "ssm_ops",
                                    mamba_scan=make, selective_scan=keep)
            for what, make in (("D skip dropped in the kernel", kernel_no_skip),
                               ("D skip dropped in the twin", twin_no_skip))}


def grad_check(tag, cfg, S, plain_ctx, count, dtype="float32", controls=None,
               routes=None, dev="cuda"):
    """``lm_loss`` backward of ``cfg`` in ``dtype`` at B=1, S: through
    the kernels (forward) and their twins (backward), then with the
    kernel's plain version forced on the card and differentiated as it
    stands.  Every leaf's gradient present and nonzero; the loss
    (relative) and, per leaf, ||g_kernel - g_plain|| / ||g_plain|| within
    ``TRAIN_GRAD_TOL[dtype]``; ``count()`` the kernel's launches: n_layers
    in the forward, n_layers more in the remat recompute, none in
    backward (``routes()``, if given, the launches by route).  Each of
    ``controls`` (name -> a context that makes the kernel or its twin
    wrong) must put a leaf outside the limit.  In bfloat16 the model,
    seed and batch are those of the training steps' first step.
    (``dev="cpu"`` with the plain versions counted is the CPU
    rehearsal.)"""
    from repro_torch.models import model as model_mod
    cfgd = cfg.replace(dtype=dtype)
    tol = TRAIN_GRAD_TOL[dtype]
    L = cfgd.n_layers
    t0 = time.perf_counter()
    model = model_mod.init_params(
        cfgd, torch.Generator(device=dev).manual_seed(SEED), dev)
    model.requires_grad_(True)
    names = dict(model.named_parameters())
    batch = train_batch(cfgd, S, 0, dev)

    def loss_and_grads():
        loss, _ = model_mod.lm_loss(model, batch)
        return float(loss.detach()), torch.autograd.grad(
            loss, tuple(names.values()), allow_unused=True)

    def rel_errors(grads):
        return {name: float((gp.float() if g is None
                             else g.float() - gp.float()).norm()
                            / gp.float().norm())
                for name, g, gp in zip(names, grads, grads_p)}

    reset_counts()
    loss_k, _ = model_mod.lm_loss(model, batch)
    _sync(dev)
    fwd = count()
    grads_k = torch.autograd.grad(loss_k, tuple(names.values()),
                                  allow_unused=True)
    _sync(dev)
    launches = count()
    by_route = dict(routes()) if routes else None
    t_kernel = time.perf_counter() - t0
    check(fwd == L and launches == L * (2 if cfgd.remat else 1),
          f"{tag} {dtype} grad check: {fwd} launches in the forward, "
          f"{launches} in all, want {L} and {L * (2 if cfgd.remat else 1)}")
    with plain_ctx():
        lp, grads_p = loss_and_grads()
        _sync(dev)
        check(count() == launches, f"{tag}: the plain run launched the "
              f"kernel")
    lk = float(loss_k.detach())
    missing = [name for name, g in zip(names, grads_k)
               if g is None or float(g.norm()) == 0.0]
    rel = rel_errors(grads_k)
    del grads_k, loss_k
    worst = max(rel, key=rel.get)
    loss_rel = abs(lk - lp) / abs(lp)
    log(f"[train] {tag} {dtype} grad check B=1 S={S} ({L} layers, "
        f"{sum(p.numel() for p in names.values()) / 1e9:.3f}e9 params): loss "
        f"kernel {lk:.6f} plain {lp:.6f} (relative {loss_rel:.3e}); "
        f"{len(names) - len(missing)} of {len(names)} leaves nonzero; worst "
        f"leaf ||g_k - g_p||/||g_p|| {rel[worst]:.3e} ({worst}; tol "
        f"{tol:g}), median {statistics.median(rel.values()):.3e}; launches "
        f"{fwd} forward + {launches - fwd} recompute, 0 backward"
        + (f" {by_route}" if by_route else "")
        + f"; {time.perf_counter() - t0:.1f} s")
    check(not missing, f"{tag}: no gradient (or a zero one) for {missing}")
    check(rel[worst] <= tol, f"{tag}: kernel gradient of {worst} disagrees "
          f"with the plain version's: {rel[worst]}")
    check(loss_rel <= tol, f"{tag}: kernel loss {lk} vs plain {lp}")
    wrong = {}
    for what, ctx in (controls or {}).items():
        with ctx():
            lc, grads_c = loss_and_grads()
        err = rel_errors(grads_c)
        del grads_c
        w = max(err, key=err.get)
        wrong[what] = {"worst_leaf": w, "worst_leaf_rel_l2": err[w],
                       "loss_rel": abs(lc - lp) / abs(lp)}
    if wrong:
        log(f"[train] {tag} {dtype} grad check, wrong kernels and twins must "
            f"fail it and do: " + "; ".join(
                f"{what}: worst leaf {c['worst_leaf_rel_l2']:.3e} "
                f"({c['worst_leaf']}), loss {c['loss_rel']:.3e}"
                for what, c in wrong.items()))
    for what, c in wrong.items():
        check(c["worst_leaf_rel_l2"] > tol, f"{tag} {dtype}: the gradient "
              f"check passed a run with the {what}")
    out = {"dtype": dtype, "S": S, "layers": L, "loss_kernel": lk,
           "loss_plain": lp, "loss_rel": loss_rel, "tol": tol,
           "leaves": len(names), "worst_leaf": worst,
           "worst_leaf_rel_l2": rel[worst],
           "median_leaf_rel_l2": statistics.median(rel.values()),
           "launches_forward": fwd, "launches": launches,
           "launches_by_route": by_route, "controls": wrong,
           "kernel_backward_s": t_kernel,
           "check_s": time.perf_counter() - t0}
    del model, names, grads_p
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def train_steps(tag, cfg, S, count, routes=None, dev="cuda"):
    """``TRAIN_STEPS`` bf16 steps of ``make_train_step`` on the seeded
    stream at B=1, S, warmup ``TRAIN_WARMUP``: the loss finite and step
    10's below step 1's; per-step wall time (each step read back),
    tokens/s, MFU against the bf16 peak, peak memory, the kernel's
    launches (2 n_layers a step under remat; ``routes()``, if given, by
    route).  Returns the numbers, the trained state and the step.
    (``dev="cpu"`` is the CPU rehearsal: no peak memory.)"""
    from repro_torch.launch.roofline import model_flops
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.train.steps import (TrainConfig, init_train_state,
                                         make_train_step)
    tcfg = TrainConfig(total_steps=TRAIN_STEPS, warmup_steps=TRAIN_WARMUP)
    card = dev == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, tcfg,
                             torch.Generator(device=dev).manual_seed(SEED), dev)
    step = make_train_step(cfg, tcfg)
    losses, times, norms = [], [], []
    reset_counts()
    for i in range(TRAIN_STEPS):
        batch = train_batch(cfg, S, i, dev)
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
    launches = count()
    by_route = dict(routes()) if routes else None
    peak = torch.cuda.max_memory_allocated() if card else 0
    flops = model_flops(cfg, INPUT_SHAPES["train_4k"], n_tokens=S)
    step_s = statistics.median(times[1:])
    out = {"S": S, "B": 1, "layers": cfg.n_layers, "steps": TRAIN_STEPS,
           "losses": losses, "grad_norms": norms, "step_s": times,
           "median_step_s": step_s, "tokens_per_s": S / step_s,
           "model_flops": flops, "mfu": flops / (step_s * BF16_FLOPS_PER_S),
           "max_memory_allocated_gb": peak / 1e9, "launches": launches,
           "launches_by_route": by_route}
    log(f"[train] {tag} bf16 {TRAIN_STEPS} steps B=1 S={S} "
        f"({cfg.n_layers} layers): loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"step {step_s * 1e3:.1f} ms median (first {times[0] * 1e3:.1f}), "
        f"{S / step_s:.1f} tokens/s, MFU {out['mfu']:.4f} (6·N·D "
        f"{flops:.3e} FLOP a step at {BF16_FLOPS_PER_S:.3g} FLOP/s); peak "
        f"memory {peak / 1e9:.2f} GB; kernel launches {launches}"
        + (f" {by_route}" if by_route else ""))
    check(all(math.isfinite(v) for v in losses), f"{tag}: loss not finite: "
          f"{losses}")
    check(losses[-1] < losses[0], f"{tag}: the loss did not fall over "
          f"{TRAIN_STEPS} steps: {losses}")
    check(launches == TRAIN_STEPS * cfg.n_layers * (2 if cfg.remat else 1),
          f"{tag}: {launches} kernel launches in {TRAIN_STEPS} steps")
    return out, state, step


def profile_step(tag, cfg, S, step, state):
    """A ``torch.profiler`` window over one more step (step
    ``TRAIN_STEPS + 1``, which advances ``state``): the device's busy
    share and its 20 largest kernels."""
    batch = train_batch(cfg, S, TRAIN_STEPS)
    kernels, window_us = profile_kernels(lambda: step(state, batch))
    log(f"[train] {tag} profiled step: " + describe_profile(kernels,
                                                            window_us))
    return {"profiled_step_busy_share": sum(kernels.values()) / window_us,
            "profiled_step_kernel_us": dict(sorted(
                kernels.items(), key=lambda kv: -kv[1])[:20])}


def head_phase(model, grad_ops):
    """MTLHead on mean-pooled features of a trained model
    (``extract_features`` over ``hidden_states``): m tasks of n
    sequences, labels from a rank-3 subspace; DGSP on the card (U
    orthonormal, ``as_low_rank`` within 1e-3 of W), then a logistic
    ProxGD head on the card, launching ``mtl_grad``, against the port's
    CPU fit on the same features."""
    from repro_torch.core.head import MTLHead, MTLHeadConfig, extract_features
    from repro_torch.models import hidden_states
    m, n, S = HEAD["m"], HEAD["n"], HEAD["S"]
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         (m, n, S))).cuda()

    def pooled(model, tokens):
        h = hidden_states(model, {"tokens": tokens})
        return h.to(torch.float32).mean(1)

    F_ = extract_features(pooled, model, list(toks), batch_size=n)
    F_ = F_ / (F_.norm(dim=2, keepdim=True) + 1e-6)
    p = F_.shape[2]
    U0 = torch.from_numpy(np.linalg.qr(rng.standard_normal((p, 3)))[0]
                          .astype(np.float32)).cuda()
    V0 = torch.from_numpy(rng.standard_normal((3, m)).astype(np.float32)).cuda()
    y = torch.einsum("mnp,pm->mn", F_, U0 @ V0)
    t0 = time.perf_counter()
    head = MTLHead(MTLHeadConfig(solver="dgsp", rounds=HEAD["rounds"],
                                 rank=HEAD["rank"])).fit_features(F_, y)
    Uh = head.U[:, torch.linalg.norm(head.U, dim=0) > 0]
    orth = float((Uh.T @ Uh - torch.eye(Uh.shape[1], device="cuda"))
                 .abs().max())
    Ud, Vd = head.as_low_rank()
    fuse = float((Ud @ Vd - head.W).abs().max())
    mse = float(((head.predict(F_) - y) ** 2).mean())
    log(f"[head] DGSP {HEAD['rounds']} rounds rank {HEAD['rank']} on pooled "
        f"features m={m} n={n} p={p}: U ({Uh.shape[1]} directions) "
        f"orthonormal to {orth:.3e} (tol 1e-4), as_low_rank max|UV - W| "
        f"{fuse:.3e} (tol 1e-3), train mse {mse:.3e}")
    check(orth <= 1e-4 and fuse <= 1e-3, "MTLHead: U not orthonormal or "
          "as_low_rank off W")
    labels = torch.where(y >= 0, 1.0, -1.0)
    lcfg = MTLHeadConfig(solver="proxgd", rounds=HEAD["logistic_rounds"],
                         rank=HEAD["rank"], loss="logistic",
                         solver_kwargs={"lam": HEAD["lam"]})
    grad_ops.task_gradients.launches = 0
    card = MTLHead(lcfg).fit_features(F_, labels)
    torch.cuda.synchronize()
    launches = grad_ops.task_gradients.launches
    cpu = MTLHead(lcfg).fit_features(F_.cpu(), labels.cpu(), device="cpu")
    scale = max(1.0, float(cpu.W.abs().max()))
    w_err = float((card.W.cpu() - cpu.W).abs().max())
    log(f"[head] logistic ProxGD {HEAD['logistic_rounds']} rounds: card vs "
        f"CPU max|dW| {w_err:.3e} (tol {HEAD_W_RTOL:g} x {scale:.3e}); "
        f"mtl_grad launches {launches}; {time.perf_counter() - t0:.1f} s")
    check(launches > 0, "the logistic head never launched mtl_grad")
    check(w_err <= HEAD_W_RTOL * scale, f"MTLHead logistic: card W vs CPU "
          f"{w_err}")
    return {"p": p, "m": m, "n": n, "directions": Uh.shape[1],
            "u_orthonormal_err": orth, "as_low_rank_err": fuse,
            "dgsp_train_mse": mse, "logistic_card_vs_cpu_max_abs": w_err,
            "launches": {"mtl_grad": launches}}


def train_phase(fa_ops, ssm_ops, grad_ops):
    """Phase 12: (a) gemma2-2b FULL, one ``lm_loss`` backward through the
    kernels against the plain version, in float32 and in bfloat16 at the
    training shape, each with its wrong kernel and twin; (b) 10 bf16
    steps of gemma2-2b FULL, then one profiled step; (c) falcon-mamba-7b
    at full width, 8 layers: (a) at S=2048 and 10 bf16 steps; (d)
    MTLHead on (b)'s model after the profiled step (11 steps)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import ssm as ssm_mod
    t_phase = time.perf_counter()
    fa = lambda: fa_ops.flash_attention.launches  # noqa: E731
    fa_routes = lambda: fa_ops.flash_attention.launches_by_route  # noqa: E731
    scan = lambda: ssm_ops.selective_scan.launches  # noqa: E731
    cfg = get_config(LM_ARCH)
    out = {}
    for dtype in ("float32", "bfloat16"):
        out[f"gemma_grad_{dtype}"] = grad_check(
            "gemma2", cfg, TRAIN_S, lambda: plain_attention(attn_mod), fa,
            dtype, attention_controls(attn_mod, dtype), fa_routes)
    out["gemma_train"], state, step = train_steps("gemma2", cfg, TRAIN_S, fa,
                                                  fa_routes)
    check(out["gemma_train"]["launches_by_route"]["wgmma"]
          == out["gemma_train"]["launches"], "gemma2 training steps: the "
          "attention left the tensor-core route")
    out["gemma_train"].update(profile_step("gemma2", cfg, TRAIN_S, step,
                                           state))
    out["head"] = head_phase(state["model"], grad_ops)
    del state, step
    torch.cuda.empty_cache()
    mcfg = get_config(SSM_ARCH).replace(n_layers=MAMBA_TRAIN_LAYERS)
    for dtype in ("float32", "bfloat16"):
        out[f"mamba_grad_{dtype}"] = grad_check(
            "mamba", mcfg, MAMBA_TRAIN_S, lambda: plain_scan(ssm_mod), scan,
            dtype, scan_controls(ssm_mod))
    out["mamba_train"], state, step = train_steps("mamba", mcfg,
                                                  MAMBA_TRAIN_S, scan)
    del state, step
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train] phase 12 in {out['phase_s']:.1f} s (target "
        f"{TRAIN_TARGET_S:.0f} s)")
    return out


# ---------------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; nothing to run",
              file=sys.stderr)
        return 1
    from repro_torch.kernels.mtl_grad import kernel as grad_kernel
    from repro_torch.kernels.mtl_grad import ops as grad_ops
    from repro_torch.kernels.mtl_score import kernel as score_kernel
    from repro_torch.kernels.mtl_score import ops as score_ops
    from repro_torch.kernels.mtl_score.ref import (dequantize_codes,
                                                   mtl_score_ref,
                                                   quantize_codes)
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.prox_step import kernel as prox_kernel
    from repro_torch.kernels.prox_step import ops as prox_ops
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
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
    builds = build_all({"mtl_score": score_kernel, "mtl_grad": grad_kernel,
                        "prox_step": prox_kernel, "flash_attention": fa_kernel,
                        "ssm_scan": ssm_kernel})
    torch.cuda.synchronize()

    # -- 3. kernel vs plain ------------------------------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    f32 = torch.float32
    cases = [(f"serve B={B} {cd}", B, P, M, R, cd, f32, False)
             for B in BATCHES for cd in ("f32", "int8", "fp8")]
    cases += list(SCORE_EDGES)
    # the edge cases again, launched at 4 rows a warp (``score_rw4_plan``)
    cases += [(name + " 4 rows a warp", *rest) for name, *rest in SCORE_EDGES]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    max_abs_err = 0.0
    for name, B, p, m, r, cd, xdt, bad in cases:
        U, C, S, ids, X = make_inputs(gen, B, p, m, r, cd, xdt,
                                      quantize_codes, bad_ids=bad)
        if name.endswith(" 4 rows a warp"):
            pl = score_rw4_plan(score_kernel, B)
            out = score_kernel.launch(U, C, S, ids, X, pl=pl)
            out2 = score_kernel.launch(U, C, S, ids, X, pl=pl)
            check(pl.rows_per_warp == 4, f"{name}: ran at {pl}")
        else:
            pl = score_kernel.plan(B, n_sm)
            out = score_ops.mtl_score(U, C, S, ids, X)
            out2 = score_ops.mtl_score(U, C, S, ids, X)
        ref = mtl_score_ref(U, C, S, ids, X)
        torch.cuda.synchronize()
        check(out.shape == (B,) and out.dtype == f32 and
              bool(torch.isfinite(out).all()), f"{name}: bad output")
        check(torch.equal(out, out2), f"{name}: two launches gave different "
              f"bytes")
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
        log(line + f" (tol {KERNEL_RTOL:g} x max|score|); relaunch bitwise "
            f"equal; plan {pl}")
        check(err <= KERNEL_RTOL * scale, f"{name}: kernel disagrees with "
              f"the plain version: {err} > {KERNEL_RTOL} * {scale}")
        if not bad and p == P:
            max_abs_err = max(max_abs_err, err)
    torch.cuda.synchronize()

    # the floor: an empty kernel (torch's spin kernel for 0 cycles) in the
    # same graph harness
    floor_ms = graph_ms(lambda: torch.cuda._sleep(0))
    log(f"[time] empty kernel (graph) {floor_ms * 1e3:7.2f} us: the floor of "
        f"a launch")
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
                   "floor_graph_ms": floor_ms, "distinct_ids": n_unique}
            by_batch.append(row)
            log(f"[time] B={B:5d} {cd:4s} kernel {k_ms * 1e3:8.2f} us "
                f"(graph {g_ms * 1e3:7.2f} us)  plain {p_ms * 1e3:8.2f} us  "
                f"library {'-' if lib_ms is None else f'{lib_ms * 1e3:8.2f}'} us"
                f"  bound {b_ms * 1e3:7.3f} us ({b_by})")
    torch.cuda.synchronize()

    grad_rows, grad_err = grad_kernel_phase(gen)
    prox_rows, prox_err = prox_kernel_phase(gen)
    sampler = sampler_phase()

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
        # over 10 calls
        def ten_calls():
            for _ in range(10):
                server.score(ids, X)

        kernels, window_us = profile_kernels(ten_calls)
        busy = sum(kernels.values()) / window_us
        log("[e2e] profiled 10 calls: " + describe_profile(kernels, window_us))
    finally:
        shutil.rmtree(store, ignore_errors=True)

    # -- 6-9. the solver paths ----------------------------------------------
    a, a_data = path_a(score_ops, grad_ops)
    b = path_b(grad_ops)
    c = path_c(grad_ops)
    d, d_data = path_d(grad_ops, prox_ops)

    # -- 9b. the mesh runtime ------------------------------------------------
    mesh = mesh_phase(grad_ops, prox_ops, score_ops, d_data)

    # -- 9c. recovery, device metrics and the streaming re-solver ----------
    rec = recovery_phase(grad_ops, prox_ops, score_ops, a_data, d_data)

    # -- 9d. the static checks and the Fig-4 surrogates ---------------------
    vs = verify_phase(grad_ops, prox_ops, d_data)
    del d_data, a_data
    grad_launches = (a["launches"]["mtl_grad"] + b["launches"]["mtl_grad"]
                     + c["launches"]["mtl_grad"] + d["launches"]["mtl_grad"]
                     + mesh["launches"]["mtl_grad"]
                     + rec["launches"]["mtl_grad"]
                     + rec["child_launches"]["mtl_grad"]
                     + vs["launches"]["mtl_grad"])
    check(a["launches"]["mtl_grad"] > 0 and b["launches"]["mtl_grad"] > 0,
          "the solver paths never launched mtl_grad")

    # -- 10. the LM serving path -------------------------------------------
    fa_rows, fa_err, fa_cases, fa_decode = fa_kernel_phase()
    lm = lm_phase(fa_ops)

    # -- 11. falcon-mamba-7b served, and ssm_scan ----------------------------
    ssm_rows, ssm_err, ssm_cases, ssm_lanes_ms = ssm_kernel_phase()
    mamba = mamba_phase(ssm_ops)

    # -- 12. LM training at full width ---------------------------------------
    train = train_phase(fa_ops, ssm_ops, grad_ops)
    grad_launches += train["head"]["launches"]["mtl_grad"]

    # -- results -----------------------------------------------------------
    main_row = next(b_ for b_ in by_batch
                    if b_["B"] == WAVE and b_["code_dtype"] == "f32")
    grad_row = grad_rows[0]                    # FULLSP, path A's shape
    result = {"kernels": [{
        "name": "mtl_score",
        "route": "cuda",
        "source": "src_torch/repro_torch/kernels/mtl_score/csrc/mtl_score.cu",
        "replaces": "src/repro/kernels/mtl_score/kernel.py:57",
        "launches": (main_launches + a["launches"]["mtl_score"]
                     + mesh["launches"]["mtl_score"]
                     + rec["launches"]["mtl_score"]),
        "launches_by_path": {"serve": main_launches,
                             "solver A": a["launches"]["mtl_score"],
                             "mesh": mesh["launches"]["mtl_score"],
                             "recovery": rec["launches"]["mtl_score"]},
        "max_abs_err": max_abs_err,
        "ms": main_row["kernel_ms"],
        "kernel_ms": main_row["kernel_ms"],
        "kernel_graph_ms": main_row["kernel_graph_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "floor_graph_ms": floor_ms,
        "shape": {"B": WAVE, "p": P, "m": M, "r": R, "code_dtype": "f32"},
        "by_batch": by_batch,
    }, {
        "name": "mtl_grad",
        "route": "cuda",
        "source": "src_torch/repro_torch/kernels/mtl_grad/csrc/mtl_grad.cu",
        "replaces": "src/repro/kernels/mtl_grad/kernel.py:57",
        "launches": grad_launches,
        "launches_by_path": {"solver A": a["launches"]["mtl_grad"],
                             "solver B": b["launches"]["mtl_grad"],
                             "solver C": c["launches"]["mtl_grad"],
                             "solver D": d["launches"]["mtl_grad"],
                             "mesh": mesh["launches"]["mtl_grad"],
                             "recovery": rec["launches"]["mtl_grad"],
                             "recovery children":
                                 rec["child_launches"]["mtl_grad"],
                             "verify and surrogates":
                                 vs["launches"]["mtl_grad"],
                             "MTL head on LM features":
                                 train["head"]["launches"]["mtl_grad"]},
        "max_abs_err": grad_err,
        "ms": grad_row["kernel_ms"],
        "kernel_ms": grad_row["kernel_ms"],
        "kernel_graph_ms": grad_row["kernel_graph_ms"],
        "plain_ms": grad_row["plain_ms"],
        "bound_ms": grad_row["bound_ms"],
        "bound_by": grad_row["bound_by"],
        "library_ms": grad_row["library_ms"],
        "library_graph_ms": grad_row["library_graph_ms"],
        "plan": grad_row["plan"],
        "shape": grad_row["shape"],
        "by_shape": grad_rows,
    }, {
        "name": "prox_step",
        "route": "cuda",
        "source": "src_torch/repro_torch/kernels/mtl_grad/csrc/mtl_grad.cu",
        "replaces": "src/repro/kernels/prox_step/kernel.py:69",
        "launches": (d["launches"]["prox_step"]
                     + mesh["launches"]["prox_step"]
                     + rec["launches"]["prox_step"]
                     + rec["child_launches"]["prox_step"]
                     + vs["launches"]["prox_step"]),
        "launches_by_path": {"solver D": d["launches"]["prox_step"],
                             "mesh": mesh["launches"]["prox_step"],
                             "recovery": rec["launches"]["prox_step"],
                             "recovery children":
                                 rec["child_launches"]["prox_step"],
                             "verify and surrogates":
                                 vs["launches"]["prox_step"]},
        "max_abs_err": prox_err,
        "ms": prox_rows[0]["kernel_ms"],
        "kernel_ms": prox_rows[0]["kernel_ms"],
        "kernel_graph_ms": prox_rows[0]["kernel_graph_ms"],
        "plain_ms": prox_rows[0]["plain_ms"],
        "bound_ms": prox_rows[0]["bound_ms"],
        "bound_by": prox_rows[0]["bound_by"],
        "library_ms": prox_rows[0]["library_ms"],
        "library_graph_ms": prox_rows[0]["library_graph_ms"],
        "plan": prox_rows[0]["plan"],
        "shape": prox_rows[0]["shape"],
        "by_shape": prox_rows,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src_torch/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_wgmma.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": (lm["serve"]["launches"]
                     + train["gemma_grad_float32"]["launches"]
                     + train["gemma_grad_bfloat16"]["launches"]
                     + train["gemma_train"]["launches"]),
        "launches_by_path": {"LM served wave": lm["serve"]["launches"],
                             "LM f32 anchor": lm["anchor"]["launches"],
                             "LM f32 grad check":
                                 train["gemma_grad_float32"]["launches"],
                             "LM bf16 grad check":
                                 train["gemma_grad_bfloat16"]["launches"],
                             "LM training steps":
                                 train["gemma_train"]["launches"]},
        "launches_by_route": lm["serve"]["launches_by_route"],
        "routes": {"wgmma": {
            "source": "src_torch/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_wgmma.cu",
            "ptxas": builds["flash_attention_wgmma"]}, "decode": {
            "source": "src_torch/repro_torch/kernels/flash_attention/csrc/"
                      "flash_decode.cu",
            "ptxas": builds["flash_decode"]}, "cuda_cores": {
            "source": "src_torch/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "ptxas": builds["flash_attention"],
            "splits": fa_decode["cuda_core_splits"]}},
        "max_abs_err": fa_err,
        "ms": fa_rows[0]["kernel_ms"],
        "kernel_ms": fa_rows[0]["kernel_ms"],
        "kernel_graph_ms": fa_rows[0]["kernel_graph_ms"],
        "plain_ms": fa_rows[0]["plain_ms"],
        "bound_ms": fa_rows[0]["bound_ms"],
        "bound_by": fa_rows[0]["bound_by"],
        "library_ms": fa_rows[0]["library_ms"],
        "shape": fa_rows[0]["shape"],
        "by_shape": fa_rows,
        "cases": fa_cases,
    }, {
        "name": "flash_attention_decode",
        "route": "cuda",
        "source": "src_torch/repro_torch/kernels/flash_attention/csrc/"
                  "flash_decode.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:85",
        "launches": lm["serve"]["launches_by_route"]["decode"],
        "launches_by_path": {
            "LM served wave": lm["serve"]["launches_by_route"]["decode"],
            "LM f32 anchor": lm["anchor"]["launches_by_route"]["decode"]},
        "max_abs_err": max(c["max_abs_err"] for c in fa_cases
                           if c["name"] in (r["shape"]["name"]
                                            for r in fa_rows[2:])),
        "ms": fa_rows[2]["kernel_ms"],
        "kernel_ms": fa_rows[2]["kernel_ms"],
        "kernel_graph_ms": fa_rows[2]["kernel_graph_ms"],
        "plain_ms": fa_rows[2]["plain_ms"],
        "bound_ms": fa_rows[2]["bound_ms"],
        "bound_by": fa_rows[2]["bound_by"],
        "library_ms": fa_rows[2]["library_ms"],
        "shape": fa_rows[2]["shape"],
        "by_shape": fa_rows[2:],
        "instantiations": fa_decode["instantiations"],
        "empty_splits": fa_decode["empty_splits"],
        "ptxas": builds["flash_decode"],
    }, {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src_torch/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:63",
        "launches": (mamba["serve"]["launches"]
                     + train["mamba_grad_float32"]["launches"]
                     + train["mamba_grad_bfloat16"]["launches"]
                     + train["mamba_train"]["launches"]),
        "launches_by_path": {"mamba served wave": mamba["serve"]["launches"],
                             "mamba f32 anchor": mamba["anchor"]["launches"],
                             "mamba f32 grad check":
                                 train["mamba_grad_float32"]["launches"],
                             "mamba bf16 grad check":
                                 train["mamba_grad_bfloat16"]["launches"],
                             "mamba training steps":
                                 train["mamba_train"]["launches"]},
        "max_abs_err": ssm_err,
        "entries": ["selective_scan", "mamba_scan (the served path)"],
        "ms": ssm_rows[0]["kernel_ms"],
        "kernel_ms": ssm_rows[0]["kernel_ms"],
        "kernel_graph_ms": ssm_rows[0]["kernel_graph_ms"],
        "plain_ms": ssm_rows[0]["plain_ms"],
        "bound_ms": ssm_rows[0]["bound_ms"],
        "bound_by": ssm_rows[0]["bound_by"],
        "library_ms": None,
        "shape": ssm_rows[0]["shape"],
        "by_shape": ssm_rows,
        "lanes": ssm_lanes_ms,
        "cases": ssm_cases,
    }], "serve": {"requests_per_call": N_REQUESTS, "wave": WAVE,
                  "first_call_s": t_score, "p50_call_s": p50,
                  "max_call_s": worst, "requests_per_s_p50": N_REQUESTS / p50,
                  "profiled_device_busy_share": busy if kernels else None,
                  "profiled_kernel_us": kernels},
        "solver": {"A": a, "B": b, "C": c, "D": d}, "mesh": mesh,
        "recovery": rec, "verify": vs,
        "sampler": sampler,
        "lm": lm, "mamba": mamba, "train": train}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
