"""The port's attention with explicit positions
(``repro_torch.kernels.flash_attention``) against the reference's, on
the CPU.

Pass criteria: the port's plain version against the reference's oracle
(``repro.kernels.flash_attention.ref.attention_ref``) and its Pallas
kernel in interpret mode on the reference's own shape and mask grid
(``tests/test_kernels.py:26-67``) at the reference's tolerances (2e-5 in
f32, 3e-2 in bf16); against the reference's ``_sdpa_naive`` +
``_mask_bias`` on ring-buffer positions (wrapped and empty slots) at
2e-5; a row where no key counts gives 0.  The CUDA kernel itself is
held to the plain version on the card by ``chip_smoke.py`` (phase 10);
its check is shown here to pass the plain version and to fail an
attention that drops the window, drops the softcap or ignores ``k_pos``.
"""
import functools
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))
sys.path.append(str(ROOT))               # chip_smoke.py

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402

from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro.models.attention import _mask_bias, _sdpa_naive  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as port_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import key_mask  # noqa: E402

J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": 2e-5, "bf16": 3e-2}

# the reference's oracle and naive path, each compiled once per shape
j_oracle = jax.jit(attention_ref, static_argnames=("causal", "window",
                                                   "softcap", "scale"))


@functools.partial(jax.jit, static_argnames=("window", "softcap"))
def j_naive(q, k, v, q_pos, k_pos, *, window, softcap):
    """``_sdpa_naive`` with the causal ``_mask_bias``, scale hd**-0.5."""
    bias = _mask_bias(q_pos, k_pos, True, window)
    return _sdpa_naive(q, k, v, bias, q.shape[-1] ** -0.5, softcap)


def _qkv(B, Sq, Sk, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32),
            rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32))


def _port(arrays, dt):
    return [torch.from_numpy(a).to(T_DT[dt]) for a in arrays]


def _jax(arrays, dt):
    return [jnp.asarray(a, J_DT[dt]) for a in arrays]


def _bhsd(x, B, S, H, hd):
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


def _arange_pos(B, S):
    return torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,hd", [
    (2, 256, 256, 4, 2, 64), (1, 200, 200, 4, 1, 128),
    (2, 128, 384, 2, 2, 64), (1, 130, 130, 8, 4, 32),
])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_plain_matches_reference_oracle_and_interpret_kernel(B, Sq, Sk, H,
                                                             Hkv, hd, dt):
    arrays = _qkv(B, Sq, Sk, H, Hkv, hd, seed=0)
    q, k, v = _port(arrays, dt)
    out = flash_attention(q, k, v, q_pos=_arange_pos(B, Sq),
                          k_pos=_arange_pos(B, Sk), causal=True)
    assert out.dtype == q.dtype and out.shape == q.shape
    jq, jk, jv = _jax(arrays, dt)
    oracle = j_oracle(_bhsd(jq, B, Sq, H, hd), _bhsd(jk, B, Sk, Hkv, hd),
                      _bhsd(jv, B, Sk, Hkv, hd), causal=True)
    oracle = np.asarray(oracle, np.float32).reshape(
        B, H, Sq, hd).transpose(0, 2, 1, 3)
    kern = np.asarray(j_flash(jq, jk, jv, causal=True, interpret=True),
                      np.float32)
    np.testing.assert_allclose(_f32(out), oracle, atol=TOL[dt], rtol=TOL[dt])
    np.testing.assert_allclose(_f32(out), kern, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 64, None), (True, 64, 50.0),
    (False, None, None), (True, None, 30.0),
])
def test_plain_matches_reference_masks(causal, window, softcap):
    B, S, H, Hkv, hd = 2, 192, 4, 2, 64
    arrays = _qkv(B, S, S, H, Hkv, hd, seed=1)
    q, k, v = _port(arrays, "f32")
    pos = _arange_pos(B, S)
    out = flash_attention(q, k, v, q_pos=pos, k_pos=pos, causal=causal,
                          window=window, softcap=softcap)
    jq, jk, jv = _jax(arrays, "f32")
    kern = j_flash(jq, jk, jv, causal=causal, window=window, softcap=softcap,
                   bq=64, bk=64, interpret=True)
    oracle = j_oracle(_bhsd(jq, B, S, H, hd), _bhsd(jk, B, S, Hkv, hd),
                      _bhsd(jv, B, S, Hkv, hd), causal=causal, window=window,
                      softcap=softcap)
    oracle = np.asarray(oracle).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(out.numpy(), oracle, atol=2e-5, rtol=2e-5)


def _ring(B, slots, q_positions, written):
    """Ring-buffer key positions: row b holds its last ``written[b]``
    positions up to ``q_positions[b]`` at slots ``pos % slots``, the
    other slots empty (-10**9)."""
    k_pos = np.full((B, slots), -10 ** 9, np.int32)
    for b in range(B):
        for p in range(q_positions[b] - written[b] + 1, q_positions[b] + 1):
            k_pos[b, p % slots] = p
    return k_pos


@pytest.mark.parametrize("window,softcap,Sq", [
    (None, None, 1), (64, 50.0, 1), (None, 50.0, 1), (64, None, 3),
])
def test_plain_matches_naive_sdpa_on_ring_positions(window, softcap, Sq):
    """Decode against a wrapped ring (and, at Sq=3, three queries against
    it) with empty slots: the reference's naive path at 2e-5."""
    B, slots, H, Hkv, hd = 3, 64, 4, 2, 64
    last = np.array([200, 131, 40])
    q_pos = np.stack([last - Sq + 1 + i for i in range(Sq)], 1).astype(np.int32)
    k_pos = _ring(B, slots, last, written=[64, 64, 30])
    arrays = _qkv(B, Sq, slots, H, Hkv, hd, seed=2)
    q, k, v = _port(arrays, "f32")
    out = flash_attention(q, k, v, q_pos=torch.from_numpy(q_pos),
                          k_pos=torch.from_numpy(k_pos), causal=True,
                          window=window, softcap=softcap, scale=hd ** -0.5)
    naive = j_naive(*_jax(arrays, "f32"), jnp.asarray(q_pos),
                    jnp.asarray(k_pos), window=window, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(naive), atol=2e-5,
                               rtol=2e-5)


def test_row_where_no_key_counts_is_zero():
    """Pinned difference: the port (as the reference's Pallas kernel and
    its oracle) gives 0 where no key counts; the reference's naive path
    gives a near-uniform mean of v there."""
    B, S, H, Hkv, hd = 2, 16, 2, 1, 32
    q, k, v = _port(_qkv(B, S, S, H, Hkv, hd, seed=3), "f32")
    q_pos = _arange_pos(B, S)
    k_pos = q_pos.clone()
    k_pos[1] = -10 ** 9                      # row 1: every slot empty
    out = flash_attention(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=True)
    assert torch.equal(out[1], torch.zeros_like(out[1]))
    assert bool(out[0].abs().sum(-1).gt(0).all())
    naive = np.asarray(j_naive(*(jnp.asarray(t.numpy()) for t in
                                 (q, k, v, q_pos, k_pos)),
                               window=None, softcap=None))
    np.testing.assert_allclose(out[0].numpy(), naive[0], atol=2e-5, rtol=2e-5)
    mean_v = v[1].mean(0).numpy()            # (Hkv, hd)
    np.testing.assert_allclose(naive[1], np.broadcast_to(
        mean_v[None, :, None, :], (S, Hkv, H // Hkv, hd)).reshape(S, H, hd),
        atol=1e-5)


def test_cpu_dispatch_runs_the_plain_version_and_counts_no_launch():
    B, S, H, Hkv, hd = 1, 40, 4, 2, 64
    q, k, v = _port(_qkv(B, S, S, H, Hkv, hd, seed=4), "f32")
    pos = _arange_pos(B, S)
    n0 = ops.flash_attention.launches
    out = flash_attention(q, k, v, q_pos=pos, k_pos=pos, window=16,
                          softcap=50.0)
    assert ops.flash_attention.launches == n0
    assert torch.equal(out, port_ref(q, k, v, q_pos=pos, k_pos=pos,
                                     window=16, softcap=50.0))
    with pytest.raises(NotImplementedError, match="prefix"):
        flash_attention(q, k, v, q_pos=pos, k_pos=pos,
                        prefix_len=torch.tensor([4]))
    with pytest.raises(ValueError, match="group"):
        flash_attention(q[:, :, :3], k, v, q_pos=pos, k_pos=pos)
    with pytest.raises(TypeError, match="integers"):
        flash_attention(q, k, v, q_pos=pos.float(), k_pos=pos)
    with pytest.raises(TypeError, match="share"):
        flash_attention(q, k.bfloat16(), v, q_pos=pos, k_pos=pos)


# the served prefill cases are checked here on their last rows (each
# row's attention is independent of the others'), where the window binds
TAIL_ROWS = 32


@pytest.mark.parametrize("case", chip_smoke.FA_CASES, ids=lambda c: c[0])
def test_card_check_passes_the_plain_version_and_fails_a_wrong_one(case):
    """``chip_smoke``'s attention check (``fa_error``/``fa_passes``
    against ``FA_TOL``) on each of its cases and on the same inputs as on
    the card, the served shapes included (prefill on its last ``TAIL_ROWS`` query rows): a
    float64 evaluation of the plain version passes; the plain version
    with each of ``fa_controls`` (the window dropped where it binds, the
    softcap dropped, ``k_pos`` replaced by ``0..Sk-1`` in ring cases)
    fails, in bf16 as in f32."""
    name, B, Sq, Sk, H, Hkv, hd, dtype, mode, window, softcap = case
    q, k, v, q_pos, k_pos = chip_smoke.fa_inputs(case, dev="cpu")
    if Sq > 400:
        q, q_pos = q[:, -TAIL_ROWS:], q_pos[:, -TAIL_ROWS:]
    kw = dict(q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
              softcap=softcap)
    ref = port_ref(q, k, v, **kw)
    ref_abs = port_ref(q, k, v.abs(), **kw)

    def passes(out):
        return chip_smoke.fa_passes(
            *chip_smoke.fa_error(out, ref, ref_abs, dtype), dtype)

    exact = port_ref(q.double(), k.double(), v.double(), **kw)
    assert passes(exact.to(q.dtype))
    wrong = {what: port_ref(q, k, v, **wrong_kw) for what, wrong_kw
             in chip_smoke.fa_controls(case, kw).items()}
    assert wrong, "the case exercises none of the checked features"
    if window is not None and Sq > 400:
        assert "window dropped" in wrong
    assert [w for w, out in wrong.items() if passes(out)] == []
