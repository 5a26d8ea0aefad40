"""The port's optimizer, token stream and roofline counts
(``repro_torch.optim``, ``.data.tokens``, ``.launch.roofline``) against
the reference, on the CPU.  ~3 s in one process.

Pass criteria, on the same seeded numpy inputs in both packages:

* AdamW with float32 and bfloat16 moments over three steps (2-D leaves
  decayed, 1-D leaves not; f32 and bf16 parameters), global-norm
  clipping on either side of the limit, and the warmup and cosine
  schedules: 1e-6 relative to each array's max;
* ``SyntheticTokenStream`` batches for steps 0-3: bitwise;
* ``model_flops`` (every input shape) and both parameter counts for every
  config the port registers, FULL and smoke, and the ``mtl_score`` and
  ``prox_step`` cost models: equal.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro import optim as j_optim  # noqa: E402
from repro.data import tokens as j_tokens  # noqa: E402
from repro.launch import roofline as j_roof  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.data import tokens as t_tokens  # noqa: E402
from repro_torch.interop import _tensor  # noqa: E402
from repro_torch.launch import roofline as t_roof  # noqa: E402

RTOL = 1e-6
SHAPES = {"w": (16, 8), "b": (8,), "emb": (32, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops: one intra-op thread, so that the test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(port, ref, what):
    port = port.to(torch.float32).numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float32)
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(port - ref).max())
    tol = RTOL * max(float(np.abs(ref).max()), 1e-30)
    assert err <= tol, f"{what}: max|err| {err} > {tol}"


def _draw(seed, dtype):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32).astype(dtype)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_matches_the_reference(moment_dtype, param_dtype):
    np_dt = jnp.bfloat16 if param_dtype == "bfloat16" else np.float32
    cfg_kw = dict(lr=1e-2, weight_decay=0.1, moment_dtype=moment_dtype)
    jcfg = j_optim.AdamWConfig(**cfg_kw)
    tcfg = t_optim.AdamWConfig(**cfg_kw)
    p0 = _draw(0, np_dt)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _tensor(np.asarray(v)) for k, v in p0.items()}
    js = j_optim.adamw_init(jp, jcfg)
    ts = t_optim.adamw_init(tp, tcfg)
    for step, scale in enumerate((1.0, 0.5, 0.25)):
        g = _draw(10 + step, np_dt)
        jp, js = j_optim.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg,
            jnp.float32(scale))
        t_optim.adamw_update(tp, {k: _tensor(np.asarray(v))
                                  for k, v in g.items()}, ts, tcfg,
                             torch.tensor(scale))
        for k in SHAPES:
            assert tp[k].dtype == _tensor(np.asarray(jp[k])).dtype
            assert ts["mu"][k].dtype == _tensor(np.asarray(js["mu"][k])).dtype
            _close(tp[k], np.asarray(jp[k], np.float32), f"param {k}")
            _close(ts["mu"][k], np.asarray(js["mu"][k], np.float32), f"mu {k}")
            _close(ts["nu"][k], np.asarray(js["nu"][k], np.float32), f"nu {k}")
        assert int(ts["count"]) == int(js["count"]) == step + 1


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_matches_the_reference(max_norm):
    g = _draw(3, np.float32)
    jg, jn = j_optim.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
    tg, tn = t_optim.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, max_norm)
    _close(tn, jn, "global norm")
    for k in SHAPES:
        _close(tg[k], jg[k], f"clipped {k}")
        assert tg[k].dtype == torch.float32


def test_schedules_match_the_reference():
    steps = np.arange(0, 40, dtype=np.int32)
    _close(t_optim.linear_warmup(torch.from_numpy(steps), 7),
           j_optim.linear_warmup(jnp.asarray(steps), 7), "linear_warmup")
    for total, warm, final in ((30, 5, 0.1), (40, 0, 0.0), (10, 20, 0.5)):
        _close(t_optim.cosine_schedule(torch.from_numpy(steps), total, warm,
                                       final),
               j_optim.cosine_schedule(jnp.asarray(steps), total, warm,
                                       final),
               f"cosine_schedule({total}, {warm}, {final})")
    # a Python step and a device int32 count give the same scale
    assert float(t_optim.cosine_schedule(3, 30, 5)) == float(
        t_optim.cosine_schedule(torch.tensor(3, dtype=torch.int32), 30, 5))


def test_token_stream_matches_the_reference_bitwise():
    kw = dict(vocab_size=512, seq_len=48, global_batch=3, seed=7)
    js = j_tokens.SyntheticTokenStream(j_tokens.TokenPipelineSpec(**kw))
    ts = t_tokens.SyntheticTokenStream(t_tokens.TokenPipelineSpec(**kw))
    for step, (tb, jb) in enumerate(zip(ts, js)):
        for a, b in zip(tb, jb):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
        if step == 3:
            break
    np.testing.assert_array_equal(ts.batch(2)[0], js.batch(2)[0])


def test_roofline_counts_match_the_reference():
    for arch in t_configs.ARCH_IDS:
        for get in ("get_config", "get_smoke_config"):
            jc, tc = (getattr(j_configs, get)(arch),
                      getattr(t_configs, get)(arch))
            assert t_roof.active_param_count(tc) == \
                j_roof.active_param_count(jc)
            assert t_roof.total_param_count(tc) == \
                j_roof.total_param_count(jc)
            for name, shape in j_configs.INPUT_SHAPES.items():
                assert t_roof.model_flops(
                    tc, t_configs.INPUT_SHAPES[name]) == \
                    j_roof.model_flops(jc, shape)
            assert t_roof.model_flops(tc, t_configs.INPUT_SHAPES["train_4k"],
                                      n_tokens=4608) == \
                j_roof.model_flops(jc, j_configs.INPUT_SHAPES["train_4k"],
                                   n_tokens=4608)
    for args in ((256, 2048, 4, 4096), (64, 200, 5, 32, 4, 1)):
        t, j = t_roof.mtl_score_terms(*args), j_roof.mtl_score_terms(*args)
        assert (t.flops, t.hbm_bytes, t.collective_bytes) == \
            (j.flops, j.hbm_bytes, j.collective_bytes)
    for args in ((32, 500, 200), (4, 64, 2048, 2)):
        t, j = t_roof.prox_step_terms(*args), j_roof.prox_step_terms(*args)
        assert (t.flops, t.hbm_bytes, t.collective_bytes) == \
            (j.flops, j.hbm_bytes, j.collective_bytes)


def test_roofline_uses_the_h100_machine_model():
    t = t_roof.RooflineTerms(flops=989e12, hbm_bytes=3.35e12 / 2,
                             collective_bytes=0.0, collectives={})
    assert t.t_compute == pytest.approx(1.0) and t.dominant == "compute"
    assert t.t_roofline == pytest.approx(1.0)
    assert t.achieved_fraction(2.0) == pytest.approx(0.5)
    score = t_roof.mtl_score_terms(256, 2048, 4, 4096)
    assert score.flops_per_s == t_roof.F32_FLOPS == 67e12
    assert score.t_memory == score.hbm_bytes / 3.35e12
    assert (t_roof.HBM_BW, t_roof.PEAK_FLOPS, t_roof.NVLINK_BW) == \
        (3.35e12, 989e12, 450e9)
    assert score.as_dict()["dominant"] == score.dominant
