"""The port's serving engine (``repro_torch.serve.engine``) and its
sampler (``repro_torch.core.prng.categorical``) against the reference,
on the CPU.

Pass criteria: on the reference's parameters (gemma2-2b smoke, one
local/global super-block), the port's ``ServeEngine`` returns exactly the
reference engine's tokens (``attn_impl="naive"``): greedy, over mixed
prompt lengths (one past the 64-token window) in waves larger than the
batch, with EOS retirement and per-request ``max_new_tokens``; and at
temperature 0.8 from the same seed.  ``categorical`` draws the same
tokens as ``jax.random.categorical`` (float32 and bfloat16 logits), its
Gumbel values within 1e-6 relative (float32) and its uniforms bitwise.
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

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

PROMPTS = (12, 30, 7, 70, 25)
MAX_NEW = (6, 4, 8, 5, 3)
BATCH, MAX_LEN = 2, 96
GUMBEL_RTOL = 1e-6


@pytest.fixture(scope="module")
def models():
    jcfg = get_smoke_config("gemma2-2b").replace(attn_impl="naive")
    tcfg = t_configs.get_smoke_config("gemma2-2b")
    params = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    return jcfg, params, tcfg, model, prompts


def _serve(engine, mod, prompts, eos_id=-1):
    reqs = [mod.Request(p, max_new_tokens=n, eos_id=eos_id)
            for p, n in zip(prompts, MAX_NEW)]
    engine.generate(reqs)
    assert all(r.done for r in reqs)
    return [list(map(int, r.out_tokens)) for r in reqs]


def _engines(models, **kw):
    jcfg, params, tcfg, model, _ = models
    return (j_engine.ServeEngine(params, jcfg, batch_size=BATCH,
                                 max_len=MAX_LEN, **kw),
            t_engine.ServeEngine(model, tcfg, batch_size=BATCH,
                                 max_len=MAX_LEN, device="cpu", **kw))


def test_greedy_tokens_match_the_reference_engine(models):
    prompts = models[-1]
    j_eng, t_eng = _engines(models)
    n0 = fa_ops.flash_attention.launches
    port = _serve(t_eng, t_engine, prompts)
    assert fa_ops.flash_attention.launches == n0     # the CPU launches none
    assert port == _serve(j_eng, j_engine, prompts)
    assert [len(t) for t in port] == list(MAX_NEW)
    # EOS: stop request 1 at its third token; as in the reference, only
    # decoded tokens retire a request (the prefill's token does not)
    eos = port[1][2]
    j_eng, t_eng = _engines(models)
    port_eos = _serve(t_eng, t_engine, prompts, eos_id=eos)
    assert port_eos == _serve(j_eng, j_engine, prompts, eos_id=eos)
    first = port[1].index(eos, 1)
    assert port_eos[1] == port[1][:first + 1]


def test_temperature_sampling_matches_the_reference_engine(models):
    prompts = models[-1]
    j_eng, t_eng = _engines(models, temperature=0.8, seed=0)
    port = _serve(t_eng, t_engine, prompts)
    assert port == _serve(j_eng, j_engine, prompts)
    j_eng, t_eng = _engines(models, temperature=0.8, seed=0)
    assert _serve(t_eng, t_engine, prompts) == port       # repeatable


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 5])
def test_categorical_matches_jax(seed):
    key = prng.PRNGKey(seed, device="cpu")
    jkey = jax.random.PRNGKey(seed)
    for i, sub in enumerate(prng.split(key, 4)):
        jsub = jax.random.split(jkey, 4)[i]
        np.testing.assert_array_equal(sub.numpy().astype(np.uint32),
                                      np.asarray(jsub))
        logits = np.random.default_rng(seed + i).standard_normal(
            (6, 512)).astype(np.float32) * 3
        got = prng.categorical(sub, torch.from_numpy(logits))
        want = jax.random.categorical(jsub, jnp.asarray(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        got = prng.categorical(sub, torch.from_numpy(logits).bfloat16())
        want = jax.random.categorical(jsub, jnp.asarray(logits, jnp.bfloat16))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        g = prng.gumbel(sub, (6, 512)).numpy()
        jg = np.asarray(jax.random.gumbel(jsub, (6, 512)))
        assert np.all(np.abs(g - jg) <= GUMBEL_RTOL * np.maximum(1, np.abs(jg)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1.1754944e-38, 1.0),
                                   (-3.0, 2.5)])
def test_bfloat16_uniform_is_bitwise(lo, hi):
    key, jkey = prng.PRNGKey(11, device="cpu"), jax.random.PRNGKey(11)
    got = prng.uniform(key, (40, 300), lo, hi, torch.bfloat16)
    want = jax.random.uniform(jkey, (40, 300), jnp.bfloat16, minval=lo,
                              maxval=hi)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_engine_defaults_to_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is legitimate here")
    _, _, tcfg, model, _ = models
    with pytest.raises(RuntimeError, match="CUDA"):
        t_engine.ServeEngine(model, tcfg, batch_size=BATCH, max_len=MAX_LEN)
