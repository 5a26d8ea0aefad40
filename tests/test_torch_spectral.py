"""The port's one-shot truncation (``repro_torch.core.spectral``) against
the JAX reference on the same matrices, on the CPU.

Raw bases are never compared: QR/SVD sign conventions differ between
LAPACK and XLA.  What is compared does not depend on sign: singular
values (1e-5 relative), projectors ``U Uᵀ`` / ``V Vᵀ`` (1e-4) and the
reconstruction (1e-4·s₁)."""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax.numpy as jnp  # noqa: E402

from repro.core import spectral as jspec  # noqa: E402
from repro_torch.core import spectral as tspec  # noqa: E402


def _lowrank(p, m, spectrum, noise, seed):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((p, len(spectrum))))[0]
    V = np.linalg.qr(rng.standard_normal((m, len(spectrum))))[0]
    M = (U * np.asarray(spectrum)) @ V.T + noise * rng.standard_normal((p, m))
    return M.astype(np.float32)


CASES = {
    # lazy branch: K = r + 8 < min(p, m)
    "lazy r=3": (_lowrank(120, 60, [10.0, 7.0, 4.0], 1e-3, 0), 3),
    "lazy r=5": (_lowrank(96, 64, [9.0, 8.0, 6.0, 3.0, 2.0, 0.5], 1e-3, 1), 5),
    # exact branch: K >= min(p, m)
    "exact r=4": (_lowrank(10, 8, [5.0, 4.0, 3.0, 2.0, 1.0], 0.0, 2), 4),
    "exact wide r=2": (_lowrank(6, 30, [3.0, 2.0, 1.0], 1e-2, 3), 2),
}


@pytest.mark.parametrize("name", list(CASES))
def test_truncate_factors_matches_jax(name):
    M, r = CASES[name]
    Uj, sj, Vj = (np.asarray(a) for a in jspec.truncate_factors(jnp.asarray(M), r))
    Ut, st, Vt = (a.numpy() for a in tspec.truncate_factors(torch.from_numpy(M), r))
    assert Ut.shape == Uj.shape and st.shape == sj.shape and Vt.shape == Vj.shape
    np.testing.assert_allclose(st, sj, rtol=1e-5)
    np.testing.assert_allclose(Ut @ Ut.T, Uj @ Uj.T, atol=1e-4)
    np.testing.assert_allclose(Vt @ Vt.T, Vj @ Vj.T, atol=1e-4)
    np.testing.assert_allclose((Ut * st) @ Vt.T, (Uj * sj) @ Vj.T,
                               atol=1e-4 * sj[0])


@pytest.mark.parametrize("name", list(CASES))
def test_truncate_matches_jax(name):
    M, r = CASES[name]
    want = np.asarray(jspec.truncate(jnp.asarray(M), r))
    got = tspec.truncate(torch.from_numpy(M), r).numpy()
    s1 = np.linalg.svd(M, compute_uv=False)[0]
    np.testing.assert_allclose(got, want, atol=1e-4 * s1)


def test_rank_clamped_to_spectrum_width():
    M = _lowrank(20, 3, [3.0, 2.0, 1.0], 0.0, 4)
    U, s, V = tspec.truncate_factors(torch.from_numpy(M), 5)
    assert U.shape == (20, 3) and s.shape == (3,) and V.shape == (3, 3)


def test_probe_spans_the_reference_subspace():
    P = tspec._probe(50, 6, torch.float32, torch.device("cpu")).numpy()
    Pj = np.asarray(jspec._probe(50, 6, jnp.float32))
    np.testing.assert_allclose(P.T @ P, np.eye(6), atol=1e-5)
    np.testing.assert_allclose(P @ P.T, Pj @ Pj.T, atol=1e-4)
