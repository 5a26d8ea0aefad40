"""The port's dense LM stack (``repro_torch.configs``, ``.models``,
``interop.lm_params_from_numpy``) against the reference, on the CPU.

Pass criteria, on the reference's own parameters carried across by the
converter and seeded numpy tokens:

* forward logits of the four dense smoke configs (gemma2-2b at 4 layers,
  two local/global super-blocks) within 1e-4·max(1, max|logit|);
* prefill and decode against the reference's ``attn_impl="naive"`` at a
  96-token prompt, past gemma2's 64-token smoke window, with
  ``max_len=128`` so the local ring wraps during decode, at the same
  tolerance;
* teacher-forced ``prefill`` + ``decode_step`` = ``forward`` at 2e-3, the
  reference's own decode-consistency check
  (``tests/test_decode_consistency.py``);
* the reference's ``attn_impl="pallas"`` decode differs from its
  ``naive`` decode (its kernel ignores the positions), and the port's
  decode is the ``naive`` one.
"""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.interop import lm_params_from_numpy  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402

ARCHS = ["gemma2-2b", "gemma-7b", "starcoder2-3b", "starcoder2-7b"]
LOGIT_RTOL = 1e-4
DECODE_TOL = 2e-3


def _cfgs(arch, **kw):
    """The same smoke config in both packages (gemma2-2b at 4 layers)."""
    if arch == "gemma2-2b":
        kw.setdefault("n_layers", 4)
    return (j_configs.get_smoke_config(arch).replace(**kw),
            t_configs.get_smoke_config(arch).replace(**kw))


def _models(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    params = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 device="cpu")
    return jcfg, params, model


def _tokens(cfg, B, S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _assert_logits(port, ref, what):
    ref = np.asarray(ref, np.float32)
    tol = LOGIT_RTOL * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port.numpy() - ref).max())
    assert err <= tol, f"{what}: max|err| {err} > {tol}"


def test_configs_mirror_the_reference():
    same = lambda a, b: dataclasses.asdict(a) == dataclasses.asdict(b)  # noqa: E731
    for arch in ARCHS:
        assert same(t_configs.get_config(arch), j_configs.get_config(arch))
        assert same(t_configs.get_smoke_config(arch),
                    j_configs.get_smoke_config(arch))
    assert same(t_configs.get_config("gemma2-2b", shape="long_500k"),
                j_configs.get_config("gemma2-2b", shape="long_500k"))
    assert t_configs.get_config("gemma2-2b").resolved_head_dim == 256
    for arch in sorted(set(j_configs.ARCH_IDS) - set(t_configs.ARCH_IDS)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            t_configs.get_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(arch):
    jcfg, params, model = _models(arch)
    toks = _tokens(jcfg, 2, 96)
    ref = jax.jit(lambda p, t: j_model.forward(p, jcfg, {"tokens": t})[0])(
        params, jnp.asarray(toks))
    port = t_model.forward(model, {"tokens": torch.from_numpy(toks)})
    assert port.shape == (2, 96, jcfg.vocab_size)
    _assert_logits(port, ref, arch)


def test_prefill_and_decode_match_the_naive_reference_past_the_window():
    """gemma2: a 96-token prompt against a 64-token window, 8 decode
    steps into a 128-slot cache (the local ring of 64 slots wraps)."""
    jcfg, params, model = _models("gemma2-2b", attn_impl="naive")
    B, S, T, max_len = 2, 96, 8, 128
    toks = _tokens(jcfg, B, S + T)
    j_prefill = jax.jit(lambda p, t, c: j_model.prefill(
        p, jcfg, {"tokens": t}, c))
    j_decode = jax.jit(lambda p, t, pos, c: j_model.decode_step(
        p, jcfg, t, pos, c))
    jc = j_model.init_cache(jcfg, B, max_len)
    tc = t_model.init_cache(model.cfg, B, max_len, device="cpu")
    assert [c["k"].shape[1] for c in tc] == [64, 128] * 2
    jl, jc = j_prefill(params, jnp.asarray(toks[:, :S]), jc)
    tl, tc = t_model.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])},
                             tc)
    _assert_logits(tl, jl, "prefill")
    for t in range(T):
        pos = np.full((B,), S + t, np.int32)
        jl, jc = j_decode(params, jnp.asarray(toks[:, S + t]),
                          jnp.asarray(pos), jc)
        tl, tc = t_model.decode_step(model, torch.from_numpy(toks[:, S + t]),
                                     torch.from_numpy(pos), tc)
        _assert_logits(tl, jl, f"decode step {t}")
    local = tc[0]["pos"].numpy()
    assert sorted(local[0]) == list(range(S + T - 64, S + T))


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    _, tcfg = _cfgs(arch)
    model = t_model.init_params(tcfg, torch.Generator().manual_seed(0),
                                device="cpu")
    B, S, T = 2, 80, 6
    toks = torch.from_numpy(_tokens(tcfg, B, S + T))
    full = t_model.forward(model, {"tokens": toks})
    cache = t_model.init_cache(tcfg, B, 96, device="cpu")
    first, cache = t_model.prefill(model, {"tokens": toks[:, :S]}, cache)
    np.testing.assert_allclose(first.numpy(), full[:, S - 1].numpy(),
                               atol=DECODE_TOL, rtol=DECODE_TOL)
    for t in range(T):
        pos = torch.full((B,), S + t, dtype=torch.int32)
        step, cache = t_model.decode_step(model, toks[:, S + t], pos, cache)
        np.testing.assert_allclose(step.numpy(), full[:, S + t].numpy(),
                                   atol=DECODE_TOL, rtol=DECODE_TOL,
                                   err_msg=f"{arch} decode step {t}")


def test_reference_pallas_decode_ignores_positions_and_the_port_does_not():
    """Pinned reference hazard: under ``attn_impl="pallas"`` the
    reference's decode step runs its flash kernel, which assumes
    positions 0..S-1, so the one decode query sits at position 0 and sees
    only ring slot 0; its logits leave the ``naive`` ones.  The port's
    kernel takes the positions, and its decode is the ``naive`` one."""
    jcfg, params, model = _models("gemma2-2b", n_layers=2)
    B, S = 2, 40
    toks = _tokens(jcfg, B, S + 1, seed=5)
    pos = np.full((B,), S, np.int32)
    steps = {}
    for impl in ("naive", "pallas"):
        cfg = jcfg.replace(attn_impl=impl)

        @jax.jit
        def step(p, t, c):
            _, c = j_model.prefill(p, cfg, {"tokens": t[:, :S]}, c)
            return j_model.decode_step(p, cfg, t[:, S], jnp.asarray(pos),
                                       c)[0]

        steps[impl] = step(params, jnp.asarray(toks),
                           j_model.init_cache(cfg, B, 64))
    gap = float(jnp.abs(steps["pallas"] - steps["naive"]).max())
    assert gap > 0.1 * float(jnp.abs(steps["naive"]).max())
    cache = t_model.init_cache(model.cfg, B, 64, device="cpu")
    _, cache = t_model.prefill(model, {"tokens": torch.from_numpy(
        toks[:, :S])}, cache)
    port, _ = t_model.decode_step(model, torch.from_numpy(toks[:, S]),
                                  torch.from_numpy(pos), cache)
    _assert_logits(port, steps["naive"], "port decode vs naive")


def test_init_params_draws_the_reference_scales():
    """Seeded init on the requested device, same shapes as the
    reference's tree, the reference's standard deviations (truncated at
    2σ), zero norms; the same generator seed gives the same weights."""
    jcfg, tcfg = _cfgs("gemma2-2b")
    a = t_model.init_params(tcfg, torch.Generator().manual_seed(3),
                            device="cpu")
    b = t_model.init_params(tcfg, torch.Generator().manual_seed(3),
                            device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    shapes = jax.eval_shape(lambda k: j_model.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in a.parameters()) == n_ref
    layer = a.layers[0]
    d, hd = tcfg.d_model, tcfg.resolved_head_dim
    for w, std in ((a.embed, 1.0), (layer.attn.wq, d ** -0.5),
                   (layer.attn.wo, (tcfg.n_heads * hd) ** -0.5),
                   (layer.mlp.w_down, tcfg.d_ff ** -0.5)):
        assert float(w.abs().max()) <= 2 * std
        # a normal truncated at 2 sigma has std 0.8796 sigma
        assert abs(float(w.std()) / std - 0.8796) < 0.05
    assert float(layer.norm1.scale.abs().max()) == 0.0
    assert [layer.window for layer in a.layers] == [64, None, 64, None]


def test_unported_families_raise_with_their_roadmap_item():
    cfg = t_configs.get_smoke_config("gemma-7b")
    for change, what in ((dict(family="ssm", mamba_version=2), "mamba"),
                         (dict(family="hybrid"), "mamba"),
                         (dict(n_experts=4), "MoE"),
                         (dict(family="moe", n_experts=4), "MoE"),
                         (dict(family="encdec", n_enc_layers=2), "encdec"),
                         (dict(mla=True), "MLA"),
                         (dict(family="vlm"), "vlm")):
        with pytest.raises(NotImplementedError,
                           match=f"{what}.*ROADMAP Queue 1"):
            t_model.init_params(cfg.replace(**change), device="cpu")
        if "mla" not in change:
            with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
                t_model.init_cache(cfg.replace(**change), 1, 8, device="cpu")
    model = t_model.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        t_model.forward(model, {"tokens": torch.zeros((1, 4), dtype=torch.long),
                                "prefix_len": torch.tensor([2])})


def test_served_logits_check_fails_wrong_decode_attentions():
    """``chip_smoke``'s served-wave check (``served_logits`` through the
    model's attention against through the plain version, within
    ``SERVE_LOGIT_TOL``) on the gemma2 smoke config with prompts past its
    64-token window, so the local ring wraps: the port's attention passes
    it, and each of ``SERVE_CONTROLS`` (positions ignored, as the
    reference's pallas decode does; ring slots taken for positions)
    fails it."""
    sys.path.append(str(ROOT))
    import chip_smoke
    from repro_torch.models import attention as attn_mod
    cfg = t_configs.get_smoke_config("gemma2-2b").replace(n_layers=4)
    model = t_model.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    rng = np.random.default_rng(0)
    S, T, max_len = 96, 8, 104
    batch = rng.integers(0, cfg.vocab_size, (3, S))
    batch[1, :16] = batch[2, :79] = 0                     # left padding
    batch = {"tokens": torch.from_numpy(batch)}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, T)))
    ours = chip_smoke.served_logits(t_model, model, batch, toks, max_len)
    with chip_smoke.plain_attention(attn_mod):
        plain = chip_smoke.served_logits(t_model, model, batch, toks, max_len)
    assert ours.shape == (3, T, cfg.vocab_size)
    assert float((ours - plain).abs().max()) <= chip_smoke.SERVE_LOGIT_TOL
    for what, change in chip_smoke.SERVE_CONTROLS.items():
        with chip_smoke.plain_attention(attn_mod, change):
            wrong = chip_smoke.served_logits(t_model, model, batch, toks,
                                             max_len)
        assert float((wrong - plain).abs().max()) > \
            chip_smoke.SERVE_LOGIT_TOL, what
