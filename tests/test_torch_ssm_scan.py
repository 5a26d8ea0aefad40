"""The port's selective scan (``repro_torch.kernels.ssm_scan``) against
the reference's, on the CPU.

Pass criteria: the port's plain version against the reference's oracle
(``repro.kernels.ssm_scan.ref.selective_scan_ref``) and its Pallas kernel
in interpret mode on the reference's own shape grid
(``tests/test_kernels.py:96-111``) at the reference's tolerances (2e-5 in
f32, 3e-2 in bf16, atol twice that); a scan of [0, s) and then of [s, S)
from the first part's state equals one scan of [0, S), bit for bit; the
plain version never holds a (B, S, I, N) tensor.  The CUDA kernel itself
is held to the plain version on the card by ``chip_smoke.py`` (phase
11); its check is shown here to pass the plain version and to fail a
scan that ignores the carried state, takes C_t from step t-1 or drops
the last step.

The fused mixer entry (``ops.mamba_scan``): its plain version equals the
mixer's unfused chain bit for bit (f32 and bf16, with and without h0);
on the CPU it runs that version, writes ``h_out`` in place and refuses
what the bare entry refuses; phase 11's fused check passes it and fails
a scan with the D skip, the gate, ``dt_bias``, the softplus or the state
dropped, or y rounded to the model's dtype before the D skip.  The
kernel's arithmetic order (states split over lanes, the
reduce-scatter's tree, ex2 of a pre-scaled A; ``scan_order.py``) stays
within ``SSM_TOL`` of the reference's oracle on every phase-11 case.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))
sys.path.append(str(ROOT))               # chip_smoke.py

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from repro.kernels.ssm_scan import selective_scan as j_scan  # noqa: E402
from repro.kernels.ssm_scan.ref import selective_scan_ref as j_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import kernel  # noqa: E402
from repro_torch.kernels.ssm_scan import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import mamba_scan, selective_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import (mamba_scan_ref,  # noqa: E402
                                               selective_scan_ref)

import scan_order  # noqa: E402

J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 2e-5, "bf16": 3e-2}


def _inputs(B, S, I, N, seed):
    """x, dt = softplus(normal), B_t, C_t (normal) and A = -exp(normal),
    as the reference's kernel test draws them, from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, I)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, I)))).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.exp(rng.standard_normal((I, N))).astype(np.float32)
    return x, dt, Bc, Cc, A


@pytest.mark.parametrize("dt_", ["f32", "bf16"])
@pytest.mark.parametrize("B,S,I,N,chunk", [
    (2, 128, 32, 8, 64), (1, 100, 16, 4, 32), (2, 64, 64, 16, 64),
    (1, 33, 8, 4, 16),
])
def test_plain_matches_reference_oracle_and_interpret_kernel(B, S, I, N,
                                                             chunk, dt_):
    """x, dt, B_t and C_t in the case's dtype (the same bf16 values on
    both sides), A in f32."""
    x, dt, Bc, Cc, A = _inputs(B, S, I, N, seed=B * 1000 + S + I + N)
    port = [torch.from_numpy(a).to(T_DT[dt_]) for a in (x, dt, Bc, Cc)]
    jax_in = [jnp.asarray(a, J_DT[dt_]) for a in (x, dt, Bc, Cc)]
    y, h = selective_scan(*port, torch.from_numpy(A))
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (B, S, I) and tuple(h.shape) == (B, I, N)
    tol = TOL[dt_]
    for want in (j_ref(*jax_in, jnp.asarray(A)),
                 j_scan(*jax_in, jnp.asarray(A), chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   atol=2 * tol, rtol=tol)
        np.testing.assert_allclose(h.numpy(), np.asarray(want[1]),
                                   atol=2 * tol, rtol=tol)


@pytest.mark.parametrize("split", [1, 17, 63])
def test_carried_state_continues_the_scan(split):
    """A scan of [0, s) and then of [s, S) from the first part's h_final
    gives one scan's y and h_final over [0, S), bit for bit."""
    x, dt, Bc, Cc, A = (torch.from_numpy(a)
                        for a in _inputs(2, 64, 24, 8, seed=split))
    y, h = selective_scan(x, dt, Bc, Cc, A)
    y1, h1 = selective_scan(x[:, :split], dt[:, :split], Bc[:, :split],
                            Cc[:, :split], A)
    y2, h2 = selective_scan(x[:, split:], dt[:, split:], Bc[:, split:],
                            Cc[:, split:], A, h0=h1)
    assert torch.equal(torch.cat([y1, y2], 1), y)
    assert torch.equal(h2, h)


def test_zero_state_is_no_state_and_h0_is_not_written():
    x, dt, Bc, Cc, A = (torch.from_numpy(a) for a in _inputs(1, 9, 8, 4, 5))
    h0 = torch.zeros(1, 8, 4)
    y, h = selective_scan(x, dt, Bc, Cc, A)
    y0, hz = selective_scan(x, dt, Bc, Cc, A, h0=h0)
    assert torch.equal(y0, y) and torch.equal(hz, h)
    assert not h0.any()


def test_plain_version_holds_no_sequence_of_states():
    """The plain version allocates nothing of (B, S, I, N) size: with
    S = 64 steps and state size N = 16, no single allocation reaches a
    quarter of B·S·I·N floats, only (B, S, I) and (B, I, N) ones."""
    B, S, I, N = 2, 64, 32, 16
    x, dt, Bc, Cc, A = (torch.from_numpy(a)
                        for a in _inputs(B, S, I, N, seed=7))
    biggest = []

    class Watch(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, tuple) else (out,):
                if isinstance(t, torch.Tensor):
                    biggest.append(t.numel())
            return out

    with Watch():
        selective_scan_ref(x, dt, Bc, Cc, A)
    assert max(biggest) == B * S * I < B * S * I * N // 4


def test_cpu_dispatch_runs_the_plain_version_and_counts_no_launch():
    x, dt, Bc, Cc, A = (torch.from_numpy(a) for a in _inputs(2, 5, 8, 4, 9))
    h0 = torch.randn(2, 8, 4, generator=torch.Generator().manual_seed(0))
    n0 = ops.selective_scan.launches
    got = selective_scan(x, dt, Bc, Cc, A, h0=h0)
    want = selective_scan_ref(x, dt, Bc, Cc, A, h0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert ops.selective_scan.launches == n0
    meta = [t.to("meta") for t in (x, dt, Bc, Cc, A)]
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        selective_scan(*meta)
    with pytest.raises(ValueError, match="different devices"):
        selective_scan(x, dt, Bc, Cc, A.to("meta"))
    with pytest.raises(ValueError, match="A: want"):
        selective_scan(x, dt, Bc, Cc, A[:, :2])
    with pytest.raises(ValueError, match="h0: want"):
        selective_scan(x, dt, Bc, Cc, A, h0=h0[:1])
    with pytest.raises(TypeError, match="floating point"):
        selective_scan(x, dt, Bc, Cc, A.to(torch.int32))


@pytest.mark.parametrize("case", chip_smoke.SSM_CASES, ids=lambda c: c[0])
def test_card_check_passes_the_plain_version_and_fails_a_wrong_one(case):
    """``chip_smoke``'s scan check (``ssm_error``/``ssm_passes``) on each
    phase-11 case, its served shapes cut to their first 96 steps and 256
    channels: the plain version passes it against itself, and every
    scan of ``ssm_controls`` (the state ignored, C_t from step t-1, the
    last step dropped) fails it."""
    case = case[:2] + (min(case[2], 96), min(case[3], 256)) + case[4:]
    kw = chip_smoke.ssm_inputs(case, dev="cpu")
    y, h = selective_scan(**kw)
    assert chip_smoke.ssm_passes(*chip_smoke.ssm_error(y, h, y, h))
    controls = chip_smoke.ssm_controls(kw)
    assert ("h0 ignored" in controls) == (case[6] == "random")
    assert len(controls) >= 2
    for what, wrong_kw in controls.items():
        wy, wh = selective_scan(**wrong_kw)
        assert not chip_smoke.ssm_passes(
            *chip_smoke.ssm_error(wy, wh, y, h)), what


def _mixer_chain(x, dt_lin, dt_bias, Bc, Cc, A_log, D, z, h0):
    """The mixer's ops around the scan as ``models/ssm.py`` ran them
    before the kernel took them in."""
    F = torch.nn.functional
    dt = F.softplus(dt_lin + dt_bias).to(torch.float32)
    A = -torch.exp(A_log)
    y_scan, new_state = selective_scan_ref(x, dt, Bc, Cc, A, h0)
    y = y_scan + D * x.to(torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    return y, new_state


def _fused_kw(case, S=96, I=256):
    return chip_smoke.ssm_fused_inputs(case[:2] + (min(case[2], S),
                                                   min(case[3], I))
                                       + case[4:], dev="cpu")


@pytest.mark.parametrize("h0", [None, "random"])
@pytest.mark.parametrize("dt_", ["f32", "bf16"])
def test_mamba_scan_ref_is_the_mixers_unfused_chain(dt_, h0):
    case = ("fused prefill bf16 h0 zero", 2, 40, 48, 8, T_DT[dt_], h0,
            "model", "random")
    kw = _fused_kw(case)
    got = mamba_scan_ref(**kw)
    want = _mixer_chain(**kw)
    assert got[0].dtype == T_DT[dt_] and got[1].dtype == torch.float32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ref = chip_smoke.ssm_fused_reference(kw)
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])


def test_fused_cpu_dispatch_writes_h_out_in_place_and_refuses():
    kw = _fused_kw(chip_smoke.SSM_FUSED_CASES[2], S=9, I=16)
    n0 = ops.selective_scan.launches
    out, h = mamba_scan(**kw)
    want = mamba_scan_ref(**kw)
    assert torch.equal(out, want[0]) and torch.equal(h, want[1])
    state = kw["h0"].clone()
    out2, h2 = mamba_scan(**dict(kw, h0=state, h_out=state))
    assert h2 is state and torch.equal(state, want[1])
    assert torch.equal(out2, want[0])
    assert ops.selective_scan.launches == n0
    meta = {k: v.to("meta") for k, v in kw.items()}
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        mamba_scan(**meta)
    with pytest.raises(ValueError, match="different devices"):
        mamba_scan(**dict(kw, D=kw["D"].to("meta")))
    for name, bad in (("A_log", kw["A_log"][:, :2]), ("D", kw["D"][:3]),
                      ("dt_bias", kw["dt_bias"][:3]), ("z", kw["z"][:, :2]),
                      ("dt_lin", kw["dt_lin"][:1]), ("h0", kw["h0"][:1])):
        with pytest.raises(ValueError, match=f"{name}: want"):
            mamba_scan(**dict(kw, **{name: bad}))
    with pytest.raises(ValueError, match="h_out: want"):
        mamba_scan(**kw, h_out=kw["h0"][:1])
    with pytest.raises(TypeError, match="floating point"):
        mamba_scan(**dict(kw, A_log=kw["A_log"].to(torch.int32)))


def test_fused_cases_cover_the_served_shapes_the_edges_and_the_threshold():
    cases = chip_smoke.SSM_FUSED_CASES
    assert chip_smoke.SSM_FUSED_MAIN == cases[:2]
    assert [c[1:5] for c in cases[:2]] == [(8, 2048, 8192, 16),
                                           (8, 1, 8192, 16)]
    assert any(c[1:5] == (4, 4096, 8192, 16) and c[6] is None
               for c in cases)
    edges = {(c[2], c[4]) for c in cases
             if c[3] == 100 and c[5] == torch.float32}
    assert edges >= {(S, N) for S in (1, 33) for N in (4, 8, 16)}
    for c in cases:
        if c[7] == "above 20":
            kw = _fused_kw(c)
            v = kw["dt_lin"].float() + kw["dt_bias"]
            assert bool((v > 20).any()) and bool((v < 20).any()), c[0]


@pytest.mark.parametrize("case", chip_smoke.SSM_FUSED_CASES,
                         ids=lambda c: c[0])
def test_fused_card_check_passes_the_plain_version_and_fails_a_wrong_one(
        case):
    """``chip_smoke``'s fused check (``ssm_fused_error``/
    ``ssm_fused_passes``) on each fused case, cut to 96 steps and 256
    channels: the plain version passes it against itself, and every
    mixer scan of ``ssm_fused_controls`` (the D skip, ``dt_bias``, the
    gate, the softplus or the state dropped; below float32, y rounded
    before the D skip) fails it."""
    kw = _fused_kw(case)
    ref = chip_smoke.ssm_fused_reference(kw)
    out, h = mamba_scan(**kw)
    assert chip_smoke.ssm_fused_passes(*chip_smoke.ssm_fused_error(out, h,
                                                                   ref))
    controls = chip_smoke.ssm_fused_controls(kw, mamba_scan)
    assert ("state ignored" in controls) == (case[6] == "random")
    assert len(controls) >= 4
    for what, wrong in controls.items():
        assert not chip_smoke.ssm_fused_passes(
            *chip_smoke.ssm_fused_error(*wrong(), ref)), what


def test_fused_check_allows_one_flip_at_each_rounding_and_no_more():
    """A y off by a few ulps may flip u.to(bf16) and the product's
    rounding: the fused check passes it, and fails an output moved by
    two bf16 ulps where the plain value is exact in bf16."""
    kw = _fused_kw(chip_smoke.SSM_FUSED_CASES[0], S=40, I=128)
    ref = chip_smoke.ssm_fused_reference(kw)
    out_r, h_r, u, s = ref
    u2 = u * (1 + 2 ** -22)
    flipped = u2.to(torch.bfloat16) * s
    err = chip_smoke.ssm_fused_error(flipped, h_r, ref)
    assert chip_smoke.ssm_fused_passes(*err)
    two = out_r.float() + 2 * chip_smoke._ulp(out_r, torch.bfloat16)
    assert not chip_smoke.ssm_fused_passes(
        *chip_smoke.ssm_fused_error(two.to(torch.bfloat16), h_r, ref))


@pytest.mark.parametrize("case,P", [
    pytest.param(c, P, id=f"{c[0]}-P{P}") for c in chip_smoke.SSM_CASES
    for P in kernel.LANE_STATES if P <= c[4]])
def test_kernel_order_is_within_tolerance_of_the_reference(case, P):
    """The kernel's arithmetic (``scan_order.scan``: P states a lane, the
    lanes' tree, ex2 of A log2 e, fused multiply-adds) on each phase-11
    case cut to 96 steps and 256 channels, against the reference's oracle
    on the same f32 values, within phase 11's per-row ``SSM_TOL``."""
    case = case[:2] + (min(case[2], 96), min(case[3], 256)) + case[4:]
    kw = chip_smoke.ssm_inputs(case, dev="cpu")
    y, h = scan_order.scan(**kw, P=P)
    f32 = {k: None if v is None else jnp.asarray(v.float().numpy())
           for k, v in kw.items()}
    want = j_ref(f32["x"], f32["dt"], f32["Bc"], f32["Cc"], f32["A"])
    if kw["h0"] is None:
        y_r, h_r = (torch.from_numpy(np.array(w)) for w in want)
    else:                                   # the oracle takes no state
        y_r, h_r = selective_scan_ref(**kw)
    assert chip_smoke.ssm_passes(*chip_smoke.ssm_error(y, h, y_r, h_r))


@pytest.mark.parametrize("B,I,N,P", [(8, 8192, 16, 8), (8, 8192, 8, 8),
                                     (4, 8192, 16, 4), (2, 8192, 16, 4),
                                     (1, 100, 4, 4), (1, 100, 8, 4),
                                     (1, 100, 16, 4)])
def test_plan_states_a_lane(B, I, N, P):
    """P = 8 states a lane where the grid reaches 6 blocks an SM (the
    served batch of 8: 1024 blocks of 2 lanes a channel on 132 SMs), else
    P = 4 (twice the threads): on the H100 the fused entry runs faster at
    P = 8 at the served batch and at P = 4 at B = 1, 2 and 4 (``PERF.md``,
    read by phase 11's ``ssm_lane_times``)."""
    assert kernel.plan(B, I, N, n_sm=132) == P
    assert P in kernel.LANE_STATES and P <= N


@pytest.mark.parametrize("cases", ["SSM_CASES", "SSM_FUSED_CASES"])
def test_phase_11_runs_every_lane_split_the_source_builds(cases):
    """Each entry's cases, under ``chip_smoke.ssm_lanes`` on the H100's
    132 SMs (the plan's P, and every P on the short cases), reach every
    (N, P, dtype) the source is built for; the two full-grid cases reach
    P = 8 at N = 8 and in float32 by the plan itself."""
    cases = getattr(chip_smoke, cases)
    got = {(c[4], P, str(c[5])) for c in cases
           for P in chip_smoke.ssm_lanes(kernel, c, 132)}
    assert got == chip_smoke.ssm_all_lanes(kernel)
    planned = {(c[4], chip_smoke.ssm_lanes(kernel, c, 132)[0], c[5])
               for c in cases if c[0].endswith("full grid")}
    assert planned == {(8, 8, torch.bfloat16), (16, 8, torch.float32)}


def test_kernel_refuses_a_misaligned_state_as_a_value_error():
    """The source's refusal of an A, h0 or h_out off a 16-byte boundary
    (it launches nothing) reaches the caller as a ValueError, as the
    entries' other refusals of what they are given; any other CUDA error
    as a RuntimeError.  (Phase 11 makes the card refuse one.)"""
    args = ("mamba_scan", 8, 1, 8192, 16, 8, "torch.bfloat16")
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernel._raise(kernel.MISALIGNED, *args)
    with pytest.raises(RuntimeError, match="CUDA error 1 "):
        kernel._raise(1, *args)
