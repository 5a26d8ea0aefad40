"""The port's Mamba-1 serving path (``repro_torch.models.ssm``, the
``"mamba"`` segment, ``interop.lm_params_from_numpy``, ``ServeEngine``)
against the reference, on the CPU.

Pass criteria, on the reference's own parameters carried across by the
converter (falcon-mamba-7b smoke: 2 layers, d_model 256, I 512, N 8,
f32) and seeded numpy inputs:

* one ``Mamba1`` mixer against the reference's ``mamba1_forward`` with
  no state, in all three of its routes (the associative scan, the
  chunked scan at ``ssm_chunk=16``, the Pallas kernel in interpret mode
  under ``attn_impl="pallas"``), within 1e-5·max(1, max|y|), the state
  within 1e-5·max(1, max|h|);
* against its carried-state branch: a prefill from zero state and conv
  caches, then one-token decode steps, with y, the new state and the conv
  cache compared at each step at the same tolerances;
* LM ``forward`` logits against ``repro.models.forward`` within
  1e-4·max(1, max|logit|), as for the dense LMs;
* teacher-forced ``prefill`` + ``decode_step`` against the port's own
  ``forward`` and against the reference's ``prefill``/``decode_step``
  at 2e-3, the reference's decode-consistency check
  (``tests/test_decode_consistency.py:20-41``);
* the converter keeps every leaf bit for bit (bf16 too);
* ``ServeEngine``'s greedy tokens, and its seeded temperature-0.8
  tokens, equal the reference engine's;
* the mixer reaches the scan only through the fused entry
  (``ssm_ops.mamba_scan``), and ``state_out`` carries the state on in
  place.
"""
import dataclasses
import pathlib
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.serve import engine as j_engine  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as ssm_ops  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.serve import engine as t_engine  # noqa: E402

ARCH = "falcon-mamba-7b"
MIXER_RTOL = 1e-5
LOGIT_RTOL = 1e-4
DECODE_TOL = 2e-3


@pytest.fixture(scope="module")
def models():
    jcfg = j_configs.get_smoke_config(ARCH)
    tcfg = t_configs.get_smoke_config(ARCH)
    params = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 device="cpu")
    return jcfg, params, tcfg, model


def _layer(params, j):
    return jax.tree.map(lambda a: a[j], params["segments"][0]["mamba"])


def _close(port, ref, rtol, what):
    ref = np.asarray(ref, np.float32)
    port = port.detach().float().numpy()
    tol = rtol * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol, f"{what}: max|err| {err} > {tol}"


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def test_config_mirrors_the_reference():
    same = lambda a, b: dataclasses.asdict(a) == dataclasses.asdict(b)  # noqa: E731
    assert same(t_configs.get_config(ARCH), j_configs.get_config(ARCH))
    assert same(t_configs.get_smoke_config(ARCH),
                j_configs.get_smoke_config(ARCH))
    full = t_configs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_state,
            full.vocab_size, t_ssm.dt_rank(full)) == (64, 4096, 8192, 16,
                                                      65024, 256)
    assert ARCH in t_configs.ARCH_IDS


@pytest.mark.parametrize("route", ["assoc", "chunked", "pallas"])
def test_mixer_matches_each_reference_route_without_state(models, route):
    jcfg, params, tcfg, model = models
    jcfg = {"assoc": jcfg, "chunked": jcfg.replace(ssm_chunk=16),
            "pallas": jcfg.replace(attn_impl="pallas")}[route]
    B, S = 2, 64
    x = np.random.default_rng(3).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    for j in range(jcfg.n_layers):
        y_r, h_r, c_r = j_ssm.mamba1_forward(_layer(params, j),
                                             jnp.asarray(x), jcfg)
        y, h, c = model.layers[j].mamba(torch.from_numpy(x))
        _close(y, y_r, MIXER_RTOL, f"{route} layer {j} y")
        _close(h, h_r, MIXER_RTOL, f"{route} layer {j} state")
        _close(c, c_r, MIXER_RTOL, f"{route} layer {j} conv cache")


def test_mixer_matches_the_reference_state_branch(models):
    """A 20-token prefill from zero state and conv caches, then 5
    one-token steps, each from the state and conv cache the last one
    left, in both packages."""
    jcfg, params, tcfg, model = models
    B, S, T = 2, 20, 5
    D, I, N, K = jcfg.d_model, jcfg.d_inner, jcfg.ssm_state, jcfg.ssm_conv
    x = np.random.default_rng(4).standard_normal(
        (B, S + T, D)).astype(np.float32)
    p, mixer = _layer(params, 1), model.layers[1].mamba
    j_state = jnp.zeros((B, I, N), jnp.float32)
    j_conv = jnp.zeros((B, K - 1, I), jnp.float32)
    t_state, t_conv = torch.zeros(B, I, N), torch.zeros(B, K - 1, I)
    for lo, hi in [(0, S)] + [(S + t, S + t + 1) for t in range(T)]:
        y_r, j_state, j_conv = j_ssm.mamba1_forward(
            p, jnp.asarray(x[:, lo:hi]), jcfg, j_state, j_conv)
        y, t_state, t_conv = mixer(torch.from_numpy(x[:, lo:hi]), t_state,
                                   t_conv)
        _close(y, y_r, MIXER_RTOL, f"steps [{lo}, {hi}) y")
        _close(t_state, j_state, MIXER_RTOL, f"steps [{lo}, {hi}) state")
        _close(t_conv, j_conv, MIXER_RTOL, f"steps [{lo}, {hi}) conv cache")


def test_forward_logits_match_the_reference(models):
    jcfg, params, tcfg, model = models
    toks = _tokens(jcfg, 2, 96)
    ref = jax.jit(lambda p, t: j_model.forward(p, jcfg, {"tokens": t})[0])(
        params, jnp.asarray(toks))
    n0 = ssm_ops.selective_scan.launches
    port = t_model.forward(model, {"tokens": torch.from_numpy(toks)})
    assert ssm_ops.selective_scan.launches == n0     # the CPU launches none
    assert port.shape == (2, 96, jcfg.vocab_size)
    _close(port, ref, LOGIT_RTOL, "forward logits")


def test_teacher_forced_decode_matches_forward_and_the_reference(models):
    jcfg, params, tcfg, model = models
    B, S, T = 2, 24, 4
    toks = _tokens(jcfg, B, S + T, seed=2)
    full = t_model.forward(model, {"tokens": torch.from_numpy(toks)})
    cache = t_model.init_cache(tcfg, B, 64, device="cpu")
    assert [sorted(c) for c in cache] == [["conv", "state"]] * 2
    assert tuple(cache[0]["state"].shape) == (B, jcfg.d_inner,
                                              jcfg.ssm_state)
    jc = j_model.init_cache(jcfg, B, 64)
    first, cache = t_model.prefill(
        model, {"tokens": torch.from_numpy(toks[:, :S])}, cache)
    jl, jc = jax.jit(lambda p, t, c: j_model.prefill(
        p, jcfg, {"tokens": t}, c))(params, jnp.asarray(toks[:, :S]), jc)
    np.testing.assert_allclose(first.numpy(), full[:, S - 1].numpy(),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    np.testing.assert_allclose(first.numpy(), np.asarray(jl),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    j_decode = jax.jit(lambda p, t, pos, c: j_model.decode_step(
        p, jcfg, t, pos, c))
    for t in range(T):
        pos = np.full((B,), S + t, np.int32)
        step, cache = t_model.decode_step(
            model, torch.from_numpy(toks[:, S + t]), torch.from_numpy(pos),
            cache)
        jl, jc = j_decode(params, jnp.asarray(toks[:, S + t]),
                          jnp.asarray(pos), jc)
        np.testing.assert_allclose(step.numpy(), full[:, S + t].numpy(),
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=f"decode step {t} vs forward")
        np.testing.assert_allclose(step.numpy(), np.asarray(jl),
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=f"decode step {t} vs reference")
    j_state, j_conv = jc[0]
    for j, c in enumerate(cache):
        _close(c["state"], j_state[j], MIXER_RTOL, f"layer {j} state")
        _close(c["conv"], j_conv[j], MIXER_RTOL, f"layer {j} conv cache")


@pytest.mark.parametrize("with_state", [False, True])
def test_mixer_reaches_the_scan_only_through_the_fused_entry(models,
                                                           with_state):
    """With the scan module's namespace cut down to ``mamba_scan`` alone
    (counting its calls), the mixer gives the same bytes as through the
    full module, one call a forward."""
    jcfg, params, tcfg, model = models
    B, S = 2, 12
    mixer = model.layers[0].mamba
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32))
    args = ((torch.randn(B, jcfg.d_inner, jcfg.ssm_state,
                         generator=torch.Generator().manual_seed(1)),
             torch.randn(B, jcfg.ssm_conv - 1, jcfg.d_inner,
                         generator=torch.Generator().manual_seed(2)))
            if with_state else ())
    want = mixer(x, *args)
    calls = []

    def fused(*a, **kw):
        calls.append(kw.get("h0") is not None)
        return ssm_ops.mamba_scan(*a, **kw)

    full = t_ssm.ssm_ops
    t_ssm.ssm_ops = types.SimpleNamespace(mamba_scan=fused)
    try:
        got = mixer(x, *args)
    finally:
        t_ssm.ssm_ops = full
    assert calls == [with_state]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_mixer_state_out_carries_the_state_on_in_place(models):
    jcfg, params, tcfg, model = models
    B, S = 2, 7
    mixer = model.layers[1].mamba
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32))
    state = torch.randn(B, jcfg.d_inner, jcfg.ssm_state,
                        generator=torch.Generator().manual_seed(3))
    conv = torch.zeros(B, jcfg.ssm_conv - 1, jcfg.d_inner)
    y, new_state, new_conv = mixer(x, state.clone(), conv)
    y2, out_state, new_conv2 = mixer(x, state, conv, state_out=state)
    assert out_state is state and torch.equal(state, new_state)
    assert torch.equal(y2, y) and torch.equal(new_conv2, new_conv)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_keeps_every_mamba_leaf_bit_for_bit(dtype):
    jcfg = j_configs.get_smoke_config(ARCH).replace(dtype=dtype)
    tcfg = t_configs.get_smoke_config(ARCH).replace(dtype=dtype)
    params = jax.tree.map(np.asarray,
                          j_model.init_params(jax.random.PRNGKey(5), jcfg))
    model = lm_params_from_numpy(params, tcfg, device="cpu")

    def bits(t):
        a = t.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()

    def want_bits(a):
        return a.view(np.int16) if a.dtype.name == "bfloat16" else a

    seg = params["segments"][0]
    n_leaves = 0
    for j, layer in enumerate(model.layers):
        for leaf, a in seg["mamba"].items():
            got = getattr(layer.mamba, leaf)
            assert str(got.dtype).split(".")[-1] == a.dtype.name, leaf
            np.testing.assert_array_equal(bits(got), want_bits(a[j]))
            n_leaves += 1
        np.testing.assert_array_equal(bits(layer.norm1.scale),
                                      want_bits(seg["norm1"]["scale"][j]))
    assert n_leaves == 9 * jcfg.n_layers
    np.testing.assert_array_equal(bits(model.head),
                                  want_bits(params["head"]["w"]))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))


def test_init_params_draws_the_reference_scales():
    """Seeded init, the reference's shapes and dtypes, its standard
    deviations, dt in the init's [1e-3, 1e-1], A_log = log(1..N), D = 1,
    zero conv bias; the same seed gives the same weights."""
    tcfg = t_configs.get_smoke_config(ARCH)
    a = t_model.init_params(tcfg, torch.Generator().manual_seed(3),
                            device="cpu")
    b = t_model.init_params(tcfg, torch.Generator().manual_seed(3),
                            device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    mix = a.layers[0].mamba
    D, I, N, K = tcfg.d_model, tcfg.d_inner, tcfg.ssm_state, tcfg.ssm_conv
    R = t_ssm.dt_rank(tcfg)
    for w, std in ((mix.in_proj, D ** -0.5), (mix.x_proj, I ** -0.5),
                   (mix.dt_proj, R ** -0.5), (mix.out_proj, I ** -0.5)):
        assert float(w.abs().max()) <= 2 * std
        assert abs(float(w.std()) / std - 0.8796) < 0.05
    assert abs(float(mix.conv_w.std()) / K ** -0.5 - 1.0) < 0.1
    assert not mix.conv_b.any()
    dt = torch.nn.functional.softplus(mix.dt_bias)
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-4)
    assert torch.equal(mix.A_log, torch.log(torch.arange(
        1, N + 1, dtype=torch.float32)).expand(I, N))
    assert torch.equal(mix.D, torch.ones(I))
    assert a.head is not None and a.layers[0].norm1.scale.abs().max() == 0


def test_mamba2_and_zamba2_raise_with_their_roadmap_item():
    cfg = t_configs.get_smoke_config(ARCH)
    with pytest.raises(NotImplementedError, match="mamba-2.*Queue 1 item 11c"):
        t_model.init_params(cfg.replace(mamba_version=2), device="cpu")
    with pytest.raises(NotImplementedError, match="mamba-2.*Queue 1 item 11c"):
        t_ssm.Mamba1(cfg.replace(mamba_version=2), torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="Queue 1 item 11c"):
        t_configs.get_config("zamba2-7b")


PROMPTS = (12, 30, 7, 41, 25)
MAX_NEW = (6, 4, 8, 5, 3)


def _serve(engine, mod, prompts):
    reqs = [mod.Request(p, max_new_tokens=n) for p, n in zip(prompts,
                                                             MAX_NEW)]
    engine.generate(reqs)
    assert all(r.done for r in reqs)
    return [list(map(int, r.out_tokens)) for r in reqs]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_tokens_match_the_reference_engine(models, temperature):
    """Mixed prompt lengths in waves larger than the batch (left padding
    runs through the state, as in the reference), greedy and seeded
    temperature-0.8 sampling."""
    jcfg, params, tcfg, model = models
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in PROMPTS]
    kw = dict(batch_size=2, max_len=64, temperature=temperature, seed=0)
    j_eng = j_engine.ServeEngine(params, jcfg, **kw)
    t_eng = t_engine.ServeEngine(model, tcfg, device="cpu", **kw)
    port = _serve(t_eng, t_engine, prompts)
    assert port == _serve(j_eng, j_engine, prompts)
    assert [len(t) for t in port] == list(MAX_NEW)
