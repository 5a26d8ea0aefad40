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


# ---------------------------------------------------------------------------
# the solver slice: leading_sv, ShrinkEngine, svd_ops
# ---------------------------------------------------------------------------
from repro.core import svd_ops as jsvd  # noqa: E402
from repro_torch.core import svd_ops as tsvd  # noqa: E402


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _sv_cases():
    return {
        "gap": _lowrank(40, 25, [5.0, 2.0, 1.0], 1e-2, 5),
        "close": _lowrank(30, 12, [3.0, 2.7, 1.0], 1e-3, 6),
        "rank1": _lowrank(20, 8, [4.0], 0.0, 7),
        "noise": np.random.default_rng(8).standard_normal((16, 9)).astype(np.float32),
    }


@pytest.mark.parametrize("name", list(_sv_cases()))
def test_leading_sv_matches_jax(name):
    G = _sv_cases()[name]
    uj, sj, vj = (np.asarray(a) for a in jspec.leading_sv(jnp.asarray(G)))
    ut, st, vt = (a.numpy() for a in tspec.leading_sv(_t(G)))
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-5)
    np.testing.assert_allclose(np.outer(ut, ut), np.outer(uj, uj), atol=1e-4)
    np.testing.assert_allclose(np.outer(vt, vt), np.outer(vj, vj), atol=1e-4)


def _drifting(steps, p=60, m=40, seed=9):
    """A rank-3 signal plus a noise bulk well below tau, moving a little
    each round, as a solver's iterate does."""
    M0 = _lowrank(p, m, [10.0, 7.0, 4.0], 1e-2, seed)
    D = _lowrank(p, m, [1.0, 0.5], 0.0, seed + 1)
    return [M0 + 0.02 * t * D for t in range(steps)]


@pytest.mark.parametrize("mode", ["lazy", "exact"])
def test_shrink_engine_warm_sequence_matches_jax(mode):
    tau = 0.5
    je = jspec.ShrinkEngine(60, 40, mode=mode, rank=3)
    te = tspec.ShrinkEngine(60, 40, mode=mode, rank=3)
    assert te.lazy == je.lazy and te.K == je.K
    jc, tc = je.init_carry(), te.init_carry()
    for M in _drifting(6):
        Wj, nnj, jc = je.shrink(jnp.asarray(M), tau, jc)
        Wt, nnt, tc = te.shrink(_t(M), tau, tc)
        s1 = float(np.linalg.svd(M, compute_uv=False)[0])
        np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-4 * s1)
        np.testing.assert_allclose(float(nnt), float(nnj), rtol=1e-5)
    assert te.stats(tc) == je.stats(jc)
    if mode == "lazy":
        assert te.stats(tc)["sv_exact_rounds"] == 1    # only the cold call


@pytest.mark.parametrize("mode", ["lazy", "exact"])
@pytest.mark.parametrize("radius", [15.0, 30.0])
def test_shrink_engine_project_matches_jax(mode, radius):
    """radius 15 cuts the spectrum (~21 in all), 30 holds it inside."""
    je = jspec.ShrinkEngine(60, 40, mode=mode, rank=3)
    te = tspec.ShrinkEngine(60, 40, mode=mode, rank=3)
    jc, tc = je.init_carry(), te.init_carry()
    for M in _drifting(4, seed=11):
        Wj, jc = je.project(jnp.asarray(M), radius, jc)
        Wt, tc = te.project(_t(M), radius, tc)
        s1 = float(np.linalg.svd(M, compute_uv=False)[0])
        np.testing.assert_allclose(Wt.numpy(), np.asarray(Wj), atol=1e-4 * s1)
    assert te.stats(tc) == je.stats(jc)


def test_shrink_engine_names_and_carry():
    with pytest.raises(ValueError, match="unknown sv_engine"):
        tspec.ShrinkEngine(10, 10, mode="fast")
    narrow = tspec.ShrinkEngine(30, 6, rank=3)          # K covers min(p, m)
    assert narrow.mode == "exact" and narrow.init_carry() == {}
    e = tspec.ShrinkEngine(60, 40, rank=3)
    c = e.init_carry()
    assert tuple(c["V"].shape) == (40, 11) and tuple(c["T"].shape) == (40, 4)
    assert c["warm"] == 0 and c["exact_rounds"] == 0
    assert int(e.device_stats(c)["sv_exact"]) == 0


@pytest.mark.parametrize("radius", [3.0, 50.0])
def test_simplex_cap_matches_jax(radius):
    S = np.array([9.0, 5.0, 2.0, 1.0, 0.5], np.float32)
    Pj, thj = jspec._simplex_cap(jnp.asarray(S), radius)
    Pt, tht = tspec._simplex_cap(_t(S), radius)
    np.testing.assert_allclose(Pt.numpy(), np.asarray(Pj), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tht), float(thj), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["sv_shrink", "nuclear_norm", "svd_truncate",
                                "project_in", "project_out", "gram_schmidt"])
def test_svd_ops_match_jax(op):
    M = _lowrank(24, 14, [6.0, 3.0, 1.5, 0.4], 1e-2, 12)
    s1 = float(np.linalg.svd(M, compute_uv=False)[0])
    Mj, Mt = jnp.asarray(M), _t(M)
    if op == "sv_shrink":
        got, want = tsvd.sv_shrink(Mt, 1.0), jsvd.sv_shrink(Mj, 1.0)
    elif op == "nuclear_norm":
        got, want = tsvd.nuclear_norm(Mt), jsvd.nuclear_norm(Mj)
    elif op == "svd_truncate":
        got, want = tsvd.svd_truncate(Mt, 2), jsvd.svd_truncate(Mj, 2)
    elif op.startswith("project"):
        radius = 5.0 if op == "project_out" else 100.0
        got = tsvd.project_nuclear_ball(Mt, radius)
        want = jsvd.project_nuclear_ball(Mj, radius)
    else:
        U = np.linalg.qr(np.random.default_rng(13).standard_normal((24, 4)))[0]
        U = U.astype(np.float32)
        mask = np.array([1, 1, 0, 1], np.float32)
        u = M[:, 0].copy()
        got = tsvd.gram_schmidt_append(_t(U), _t(u), _t(mask))
        want = jsvd.gram_schmidt_append(jnp.asarray(U), jnp.asarray(u),
                                        jnp.asarray(mask))
        s1 = 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5 * s1)
