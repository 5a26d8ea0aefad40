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
from repro_torch.kernels.ssm_scan import ops  # noqa: E402
from repro_torch.kernels.ssm_scan import selective_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref  # noqa: E402

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
