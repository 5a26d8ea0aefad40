"""The port's ``MTLHead`` (``repro_torch.core.head``) against the
reference on the same backbone features, on the CPU.  ~10 s in one
process.

The features are ``tests/test_system.py``'s: TINY's trunk, mean-pooled
over 16 tokens, row-normalized, for m=6 tasks of n=40 sequences, with
labels from a rank-3 subspace (regression) or their signs (logistic).
The port pools them through its own trunk on the reference's
parameters (within 1e-5 of the reference's features).  Pass criteria:

* DGSP, 4 rounds, rank 3: W within 1e-4·max(1, max|W|) of the
  reference's, the learned basis (a direction a round, as the
  reference's) orthonormal to 1e-4, ``as_low_rank``
  within 1e-3 of W, predictions within 1e-4·max(1, max|margin|);
* a logistic ProxGD head: W within 1e-4·max(1, max|W|), and
  ``as_low_rank`` (through ``truncate_factors``) the reference's
  rank-3 product within 1e-4·max(1, max|W|);
* ``extract_features`` in batches equals one pass.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core import head as j_head  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import head as t_head  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

TINY = dict(arch_id="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=128, dtype="float32", remat=False)
W_RTOL = 1e-4
FEAT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops: one intra-op thread, so that the test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pooled_port(model, tokens):
    with torch.no_grad():
        B, S = tokens.shape
        x = t_model.embed(model.embed, tokens, model.cfg)
        h = t_model._trunk(model, x, t_model._positions(B, S, model.device))
        return h.to(torch.float32).mean(1)


@pytest.fixture(scope="module")
def features():
    jcfg, tcfg = JModelConfig(**TINY), ModelConfig(**TINY)
    params = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 device="cpu")

    @jax.jit
    def pooled(tokens):
        x, positions, *_ = j_model._embed_inputs(params, jcfg,
                                                 {"tokens": tokens})
        h, _, _ = j_model._trunk(params, jcfg, x, positions)
        return jnp.mean(h.astype(jnp.float32), axis=1)

    key = jax.random.PRNGKey(1)
    m, n = 6, 40
    U = jax.random.orthogonal(key, jcfg.d_model)[:, :3]
    V = jax.random.normal(key, (3, m))
    toks = [np.array(jax.random.randint(jax.random.fold_in(key, j),
                                          (n, 16), 0, jcfg.vocab_size))
            for j in range(m)]
    Fj = np.stack([np.asarray(pooled(jnp.asarray(t))) for t in toks])
    Ft = t_head.extract_features(_pooled_port, model,
                                 [torch.from_numpy(t) for t in toks],
                                 batch_size=16).numpy()
    err = float(np.abs(Ft - Fj).max())
    assert err <= FEAT_RTOL * float(np.abs(Fj).max()), err
    Fj = Fj / (np.linalg.norm(Fj, axis=2, keepdims=True) + 1e-6)
    ys = np.stack([Fj[j] @ np.asarray(U @ V[:, j]) for j in range(m)])
    return Fj.astype(np.float32), ys.astype(np.float32), model, toks


def _w_close(port, ref, what):
    ref = np.asarray(ref)
    err = float(np.abs(port.numpy() - ref).max())
    tol = W_RTOL * max(1.0, float(np.abs(ref).max()))
    assert err <= tol, f"{what}: max|err| {err} > {tol}"


def test_dgsp_head_matches_the_reference(features):
    X, y, _, _ = features
    kw = dict(solver="dgsp", rounds=4, rank=3, l2=1e-4)
    ref = j_head.MTLHead(j_head.MTLHeadConfig(**kw)).fit_features(
        jnp.asarray(X), jnp.asarray(y))
    port = t_head.MTLHead(t_head.MTLHeadConfig(**kw)).fit_features(
        X, y, device="cpu")
    _w_close(port.W, ref.W, "W")
    _w_close(port.predict(torch.from_numpy(X)), ref.predict(jnp.asarray(X)),
             "predict")
    Uh = port.U[:, torch.linalg.norm(port.U, dim=0) > 0]
    k = int((jnp.linalg.norm(ref.U, axis=0) > 0).sum())
    assert Uh.shape[1] == k == 4           # one direction a round
    np.testing.assert_allclose(Uh.T @ Uh, np.eye(k), atol=1e-4)
    Ud, Vd = port.as_low_rank()
    np.testing.assert_allclose((Ud @ Vd).numpy(), port.W.numpy(), atol=1e-3)


def test_logistic_head_matches_the_reference(features):
    X, y, _, _ = features
    labels = np.where(y >= 0, 1.0, -1.0).astype(np.float32)
    kw = dict(solver="proxgd", rounds=20, rank=3, loss="logistic", l2=1e-4,
              solver_kwargs={"lam": 0.01})
    ref = j_head.MTLHead(j_head.MTLHeadConfig(**kw)).fit_features(
        jnp.asarray(X), jnp.asarray(labels))
    port = t_head.MTLHead(t_head.MTLHeadConfig(**kw)).fit_features(
        X, labels, device="cpu")
    assert port.U is None and ref.U is None
    _w_close(port.W, ref.W, "logistic W")
    Ud, Vd = port.as_low_rank()
    Uj, Vj = ref.as_low_rank()
    assert Ud.shape == (X.shape[2], 3) and Vd.shape == (3, X.shape[0])
    _w_close(Ud @ Vd, np.asarray(Uj @ Vj), "logistic rank-3 product")


def test_extract_features_in_batches_equals_one_pass(features):
    _, _, model, toks = features
    inputs = [torch.from_numpy(t) for t in toks[:2]]
    batched = t_head.extract_features(_pooled_port, model, inputs,
                                      batch_size=7)
    whole = t_head.extract_features(_pooled_port, model, inputs,
                                    batch_size=64)
    assert batched.shape == (2, 40, 64)
    torch.testing.assert_close(batched, whole, rtol=1e-6, atol=1e-6)
