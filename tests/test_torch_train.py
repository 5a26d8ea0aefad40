"""The port's LM training path (``repro_torch.models.lm_loss``, the
kernels' twins, ``.train.steps``, ``.train.loop``, ``interop``'s train
state) against the reference, on the CPU.  ~50 s in one process.

On the CPU each LM kernel call runs its plain version forward and, under
autograd, returns the twin's vector-Jacobian product backward, as the
card does with the kernel forward: so these tests run the card's
backward.  Pass criteria, on the reference's parameters (and optimizer
state) carried across by ``interop`` and seeded numpy tokens:

* ``lm_loss`` within 1e-5 relative and every gradient leaf within 1e-4
  of its max|g| of ``jax.value_and_grad(lm_loss)``, on the smoke
  configs of gemma2-2b (S=96 past its 64-token window; also with
  ``remat`` and ``bf16_grad_boundary``, and on the chunked route at a
  chunk of 16) and falcon-mamba-7b (the associative scan; the chunked
  scan at a chunk of 8 with ``remat``); a twin with the softcap dropped
  moves the gradients outside that limit;
* the attention twin (chunked route at a chunk of 16 with window and
  softcap, naive route, ``sdpa_twin``'s routes), ``_chunked_ssd1`` at a
  chunk of 8 and ``_assoc_scan``: value and VJP (``jax.vjp``) within
  2e-5 of their max;
* one ``make_train_step`` on ``tests/test_system.py``'s TINY from the
  same state: loss, ``grad_norm`` and ``lr_scale`` within 1e-5
  relative; the port's clip + AdamW on the reference's own gradients
  within 1e-6 of max|param| of the reference's step; ``microbatch=2``
  against ``microbatch=0`` and against the reference's;
* 30 port steps lower the loss; the checkpoint holds the reference's
  pytree paths; a ``train_loop`` killed at step 4 and resumed equals the
  uninterrupted run bitwise; a bf16 state survives a checkpoint bitwise;
* ``chip_smoke.py`` phase 12's gradient check and training steps pass on
  the CPU at the smoke sizes, the twin's backward within 1e-5 of the
  plain version's own gradient.
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
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.data.tokens import (SyntheticTokenStream,  # noqa: E402
                               TokenPipelineSpec)
from repro.models import attention as j_attn  # noqa: E402
from repro.models import model as j_model  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.train import checkpoint as j_ckpt  # noqa: E402
from repro.train import steps as j_steps  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.interop import (lm_params_from_numpy,  # noqa: E402
                                 lm_tree_to_numpy, load_lm_tree,
                                 train_state_from_numpy, train_state_tree)
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_update,  # noqa: E402
                               clip_by_global_norm, cosine_schedule)
from repro_torch.train import checkpoint as t_ckpt  # noqa: E402
from repro_torch.train import steps as t_steps  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4          # of each leaf's max|g|
TWIN_RTOL = 2e-5          # the reference's f32 kernel tolerance
STEP_RTOL = 1e-5
ADAMW_RTOL = 1e-6
LOGIT_RTOL = 1e-4         # of max|logit|
TINY = dict(arch_id="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=128, vocab_size=128, dtype="float32", remat=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops: one intra-op thread, so that the test workers do not
    oversubscribe the host's cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

LOSS_CASES = {
    "gemma2-2b": ("gemma2-2b", 96, {}),
    "gemma2-2b remat bf16-boundary": (
        "gemma2-2b", 96, {"remat": True, "bf16_grad_boundary": True}),
    "gemma2-2b chunked 16": (
        "gemma2-2b", 96, {"attn_impl": "chunked", "attn_chunk": 16}),
    "falcon-mamba-7b": ("falcon-mamba-7b", 32, {}),
    "falcon-mamba-7b chunked 8 remat": (
        "falcon-mamba-7b", 32, {"ssm_chunk": 8, "remat": True}),
}


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, np.asarray(tree, np.float32)


def _leaf_errors(port_tree, ref_tree):
    """Each leaf's max|port - ref| / max|ref|, keyed by path; the two
    trees must hold the same paths."""
    port, ref = dict(_leaves(port_tree)), dict(_leaves(ref_tree))
    assert set(port) == set(ref), set(port) ^ set(ref)
    return {k: float(np.abs(port[k] - ref[k]).max())
            / max(float(np.abs(ref[k]).max()), 1e-30) for k in ref}


def _close(port, ref, rtol, what):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, np.float32)
    err = float(np.abs(np.asarray(port, np.float32) - ref).max())
    tol = rtol * max(float(np.abs(ref).max()), 1e-30)
    assert err <= tol, f"{what}: max|err| {err} > {tol}"


def _loss_setup(arch, S, kw, seed=1):
    jcfg = j_configs.get_smoke_config(arch).replace(**kw)
    tcfg = t_configs.get_smoke_config(arch).replace(**kw)
    params = j_model.init_params(jax.random.PRNGKey(0), jcfg)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                 device="cpu").requires_grad_(True)
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                                (2, S + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return jcfg, params, model, batch


def _port_loss_and_grads(model, batch):
    names = dict(model.named_parameters())
    loss, aux = t_model.lm_loss(model, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tuple(names.values()))
    return loss.detach(), aux, lm_tree_to_numpy(dict(zip(names, grads)),
                                                model.cfg)


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_lm_loss_and_gradients_match_the_reference(case):
    arch, S, kw = LOSS_CASES[case]
    jcfg, params, model, batch = _loss_setup(arch, S, kw)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: j_model.lm_loss(p, jcfg, jb), has_aux=True))(params)
    loss, aux, grads = _port_loss_and_grads(model, batch)
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert abs(float(aux["nll"].detach()) - float(jaux["nll"])) <= \
        LOSS_RTOL * abs(float(jaux["nll"]))
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    errs = _leaf_errors(grads, jax.tree.map(np.asarray, jg))
    bad = {k: e for k, e in errs.items() if e > GRAD_RTOL}
    assert not bad, bad
    assert all(float(np.abs(g).max()) > 0 for _, g in _leaves(grads))


def test_gradients_go_through_the_twin(monkeypatch):
    """The control: the same loss with a twin that drops the softcap
    moves the attention weights' gradients outside the limit (the
    forward, the plain version, is unchanged)."""
    jcfg, params, model, batch = _loss_setup("gemma2-2b", 96, {})
    _, _, good = _port_loss_and_grads(model, batch)
    real = t_attn.sdpa_twin

    def no_softcap(q, k, v, *, cfg, **kw):
        return real(q, k, v, cfg=cfg.replace(attn_logit_softcap=None), **kw)

    monkeypatch.setattr(t_attn, "sdpa_twin", no_softcap)
    loss, _, bad = _port_loss_and_grads(model, batch)
    errs = _leaf_errors(bad, good)
    assert max(errs[k] for k in errs if "/attn/" in k) > GRAD_RTOL
    # the forward is the plain version's: only backward sees the change
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl = j_model.lm_loss(params, jcfg, jb)[0]
    assert abs(float(loss) - float(jl)) <= LOSS_RTOL * abs(float(jl))


def _attn_inputs(seed=3, B=2, S=40, H=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    q = (4.0 * rng.standard_normal((B, S, H, hd))).astype(np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.stack([np.arange(S), np.arange(S) + 7]).astype(np.int32)
    cot = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, pos, cot


def _vjp_pair(port_fn, ref_fn, args, cot):
    """Value and VJP of port_fn (torch) and ref_fn (jax) on the same
    numpy args and cotangent(s)."""
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = port_fn(*targs)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    tg = torch.autograd.grad(outs, targs, [torch.from_numpy(c) for c in cots])
    jout, vjp = jax.vjp(ref_fn, *[jnp.asarray(a) for a in args])
    jg = vjp(tuple(jnp.asarray(c) for c in cots) if isinstance(cot, tuple)
             else jnp.asarray(cot))
    jouts = jout if isinstance(jout, tuple) else (jout,)
    return outs, tg, jouts, jg


@pytest.mark.parametrize("route", ["chunked", "naive"])
def test_attention_twin_routes_match_the_reference(route):
    q, k, v, pos, cot = _attn_inputs()
    tp, jp = torch.from_numpy(pos), jnp.asarray(pos)
    scale, cap, window = 16 ** -0.5, 5.0, 24
    if route == "chunked":
        port = lambda q, k, v: t_attn._sdpa_chunked(  # noqa: E731
            q, k, v, tp, tp, scale, cap, True, window, 16)
        ref = lambda q, k, v: j_attn._sdpa_chunked(  # noqa: E731
            q, k, v, jp, jp, scale, cap, True, window, None, 16)
    else:
        port = lambda q, k, v: t_attn._sdpa_naive(  # noqa: E731
            q, k, v, t_attn._mask_bias(tp, tp, True, window), scale, cap)
        ref = lambda q, k, v: j_attn._sdpa_naive(  # noqa: E731
            q, k, v, j_attn._mask_bias(jp, jp, True, window), scale, cap)
    outs, tg, jouts, jg = _vjp_pair(port, ref, (q, k, v), cot)
    _close(outs[0], jouts[0], TWIN_RTOL, f"{route} value")
    for name, a, b in zip("qkv", tg, jg):
        _close(a, b, TWIN_RTOL, f"{route} d{name}")


@pytest.mark.parametrize("impl", ["auto", "chunked", "naive"])
def test_sdpa_twin_takes_the_reference_route(impl):
    q, k, v, pos, cot = _attn_inputs(seed=4)
    kw = dict(attn_impl=impl, attn_chunk=16, attn_logit_softcap=5.0)
    jcfg = j_configs.get_smoke_config("gemma2-2b").replace(**kw)
    tcfg = t_configs.get_smoke_config("gemma2-2b").replace(**kw)
    tp, jp = torch.from_numpy(pos), jnp.asarray(pos)
    outs, tg, jouts, jg = _vjp_pair(
        lambda q, k, v: t_attn.sdpa_twin(q, k, v, q_pos=tp, k_pos=tp,
                                         cfg=tcfg, window=24),
        lambda q, k, v: j_attn.sdpa(q, k, v, q_pos=jp, k_pos=jp, cfg=jcfg,
                                    causal=True, window=24), (q, k, v), cot)
    _close(outs[0], jouts[0], TWIN_RTOL, f"{impl} value")
    for name, a, b in zip("qkv", tg, jg):
        _close(a, b, TWIN_RTOL, f"{impl} d{name}")
    assert t_attn.CHUNKED_FROM == 4096 * 4096


def _scan_inputs(seed=5, B=2, S=32, I=12, N=4):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, S, I)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, I)))).astype(np.float32)
    Bc, Cc = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    A = -np.exp(rng.standard_normal((I, N))).astype(np.float32)
    cot = (rng.standard_normal((B, S, I)).astype(np.float32),
           rng.standard_normal((B, I, N)).astype(np.float32))
    return (xs, dt, Bc, Cc, A), cot


def test_chunked_ssd1_matches_the_reference():
    args, cot = _scan_inputs()
    outs, tg, jouts, jg = _vjp_pair(
        lambda *a: t_ssm._chunked_ssd1(*a, 8),
        lambda *a: j_ssm._chunked_ssd1(*a, 8), args, cot)
    for what, a, b in zip(("y", "h_final"), outs, jouts):
        _close(a, b, TWIN_RTOL, f"chunked_ssd1 {what}")
    for name, a, b in zip(("xs", "dt", "B", "C", "A"), tg, jg):
        _close(a, b, TWIN_RTOL, f"chunked_ssd1 d{name}")


def test_assoc_scan_matches_the_reference():
    (xs, dt, Bc, _, A), _ = _scan_inputs(seed=6, S=37)
    a = np.exp(dt[..., None] * A).astype(np.float32)
    b = ((dt * xs)[..., None] * Bc[..., None, :]).astype(np.float32)
    rng = np.random.default_rng(7)
    cot = tuple(rng.standard_normal(a.shape).astype(np.float32)
                for _ in range(2))
    outs, tg, jouts, jg = _vjp_pair(t_ssm._assoc_scan, j_ssm._assoc_scan,
                                    (a, b), cot)
    for what, p, r in zip(("cumprod", "h"), outs, jouts):
        _close(p, r, TWIN_RTOL, f"assoc_scan {what}")
    for what, p, r in zip(("a", "b"), tg, jg):
        _close(p, r, TWIN_RTOL, f"assoc_scan d{what}")


@pytest.mark.parametrize("arch", ["gemma2-2b", "falcon-mamba-7b"])
def test_prefill_and_serve_steps_match_the_reference(arch):
    """``make_prefill_step`` and ``make_serve_step`` against the
    reference's on its parameters: a 24-token prefill then 3 decode
    steps, logits within 1e-4 of max|logit| (gemma2 on the naive
    route, its window past the prompt)."""
    kw = {"attn_impl": "naive"} if arch == "gemma2-2b" else {}
    jcfg, params, model, _ = _loss_setup(arch, 8, kw)
    B, S, T, max_len = 2, 24, 3, 32
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S + T))
    j_prefill = jax.jit(j_steps.make_prefill_step(jcfg))
    j_serve = jax.jit(j_steps.make_serve_step(jcfg))
    t_prefill = t_steps.make_prefill_step(model.cfg)
    t_serve = t_steps.make_serve_step(model.cfg)
    jc = j_model.init_cache(jcfg, B, max_len)
    tc = t_model.init_cache(model.cfg, B, max_len, device="cpu")
    jl, jc = j_prefill(params, {"tokens": jnp.asarray(toks[:, :S])}, jc)
    tl, tc = t_prefill(model, {"tokens": torch.from_numpy(toks[:, :S])}, tc)
    assert not tl.requires_grad
    _close(tl, jl, LOGIT_RTOL, "prefill logits")
    for t in range(T):
        pos = np.full((B,), S + t, np.int32)
        jl, jc = j_serve(params, jc, jnp.asarray(toks[:, S + t]),
                         jnp.asarray(pos))
        tl, tc = t_serve(model, tc, torch.from_numpy(toks[:, S + t]),
                         torch.from_numpy(pos))
        _close(tl, jl, LOGIT_RTOL, f"decode step {t}")


# --- the train step, the loop ---------------------------------------------

def _tiny(**kw):
    return JModelConfig(**TINY).replace(**kw), ModelConfig(**TINY).replace(
        **kw)


def _batches(cfg, n, B=4, S=32):
    stream = SyntheticTokenStream(TokenPipelineSpec(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B))
    return [stream.batch(i) for i in range(n)]


def _states(jcfg, tcfg, jt, tt):
    jstate = j_steps.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                    device="cpu")
    return jstate, tstate


def _tcfgs(**kw):
    return j_steps.TrainConfig(total_steps=30, warmup_steps=2, **kw), \
        t_steps.TrainConfig(total_steps=30, warmup_steps=2, **kw)


def test_train_step_matches_the_reference():
    """One step from the same params and optimizer state.  The metrics
    are held to the reference's; the update is held on the reference's
    own gradients.  Parameters after a step fed by the two packages'
    gradients are not compared elementwise: AdamW's first step is
    ≈ lr·sign(g), so a gradient entry near 0 whose sign differs at
    rounding level moves its parameter by 2·lr."""
    jcfg, tcfg = _tiny()
    jt, tt = _tcfgs()
    jstate, tstate = _states(jcfg, tcfg, jt, tt)
    toks, tgts = _batches(jcfg, 1)[0]
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    jnew, jm = jax.jit(j_steps.make_train_step(jcfg, jt))(jstate, jb)
    _, tm = t_steps.make_train_step(tcfg, tt)(
        tstate, {"tokens": torch.from_numpy(toks),
                 "targets": torch.from_numpy(tgts)})
    for key in ("loss", "nll", "grad_norm", "lr_scale"):
        _close(tm[key], jm[key], STEP_RTOL, key)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    assert int(tstate["opt"]["count"]) == int(jnew["opt"]["count"]) == 1

    # the port's clip, schedule and AdamW on the reference's gradients
    jstate = j_steps.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    _, jg = jax.value_and_grad(lambda p: j_model.lm_loss(p, jcfg, jb),
                               has_aux=True)(jstate["params"])
    fresh = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg,
                                   device="cpu")
    params = dict(fresh["model"].named_parameters())
    grads = {k: torch.empty_like(p) for k, p in params.items()}
    load_lm_tree(grads, jax.tree.map(np.asarray, jg), tcfg)
    grads, _ = clip_by_global_norm(grads, tt.max_grad_norm)
    adamw_update(params, grads, fresh["opt"], tt.optimizer,
                 cosine_schedule(fresh["opt"]["count"], tt.total_steps,
                                 tt.warmup_steps))
    port = train_state_tree(fresh)
    ref = jax.tree.map(np.asarray, jnew)
    for part in ("params", ("opt", "mu"), ("opt", "nu")):
        p_tree = port[part] if isinstance(part, str) else port[part[0]][
            part[1]]
        r_tree = ref[part] if isinstance(part, str) else ref[part[0]][
            part[1]]
        p, r = dict(_leaves(p_tree)), dict(_leaves(r_tree))
        assert set(p) == set(r)
        for k in r:
            _close(p[k], r[k], ADAMW_RTOL, f"{part}{k}")


def test_microbatch_matches_the_full_batch_and_the_reference():
    jcfg, tcfg = _tiny()
    jt, tt = _tcfgs(microbatch=2)
    toks, tgts = _batches(jcfg, 1)[0]
    tb = {"tokens": torch.from_numpy(toks), "targets": torch.from_numpy(tgts)}
    _, tstate = _states(jcfg, tcfg, jt, tt)
    model = tstate["model"]
    params = dict(model.named_parameters())
    g_acc, m_acc = t_steps._accumulated_grads(model, params, tb, 2)
    loss, _, g_full = t_steps._loss_and_grads(model, params, tb)
    _close(m_acc["loss"], loss.numpy(), 1e-6, "microbatched loss")
    for (k, a), b in zip(g_acc.items(), g_full):
        assert a.dtype == torch.float32
        _close(a, b.numpy(), STEP_RTOL, f"microbatched grad {k}")
    jstate, tstate = _states(jcfg, tcfg, jt, tt)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    _, jm = jax.jit(j_steps.make_train_step(jcfg, jt))(jstate, jb)
    _, tm = t_steps.make_train_step(tcfg, tt)(tstate, tb)
    assert set(tm) == set(jm) == {"loss", "grad_norm", "lr_scale"}
    for key in tm:
        _close(tm[key], jm[key], STEP_RTOL, key)


def test_thirty_steps_lower_the_loss_and_checkpoint_the_reference_paths(
        tmp_path):
    jcfg, tcfg = _tiny()
    jt, tt = _tcfgs()
    state = t_steps.init_train_state(tcfg, tt, torch.Generator().manual_seed(0),
                                     device="cpu")
    ckpt = str(tmp_path / "ck")
    hist = train_loop(t_steps.make_train_step(tcfg, tt), state,
                      _batches(tcfg, 30), 30, log_every=10, ckpt_dir=ckpt,
                      ckpt_every=15, log_fn=lambda s: None)
    assert hist["step"] == [1, 10, 20, 30]
    assert np.isfinite(hist["loss"]).all()
    assert hist["loss"][-1] < hist["loss"][0]
    assert t_ckpt.available_steps(ckpt) == [15, 30]
    step, tree = t_ckpt.load_checkpoint(ckpt)
    assert step == 30 and int(tree["opt"]["count"]) == 30
    # the same paths as a reference train state's checkpoint
    jstate = j_steps.init_train_state(jax.random.PRNGKey(0), jcfg, jt)
    assert set(t_ckpt._flatten(train_state_tree(state))) == \
        set(j_ckpt._flatten(jstate))


def test_killed_train_loop_resumes_bitwise(tmp_path):
    """Killed at step 4 (the run ends there, its checkpoint at 4), then
    relaunched from a different init with the same stream: the resumed
    state equals the uninterrupted run's bit for bit."""
    _, tcfg = _tiny()
    tt = t_steps.TrainConfig(total_steps=8, warmup_steps=2)
    step_fn = t_steps.make_train_step(tcfg, tt)
    batches = _batches(tcfg, 8)

    def fresh(seed):
        return t_steps.init_train_state(
            tcfg, tt, torch.Generator().manual_seed(seed), device="cpu")

    full = fresh(0)
    train_loop(step_fn, full, batches, 8, log_fn=lambda s: None)
    d = str(tmp_path / "ck")
    train_loop(step_fn, fresh(0), batches, 4, ckpt_dir=d, ckpt_every=2,
               log_fn=lambda s: None)
    assert t_ckpt.available_steps(d) == [2, 4]
    logs = []
    resumed = fresh(1)
    hist = train_loop(step_fn, resumed, batches, 8, ckpt_dir=d,
                      ckpt_every=2, log_fn=logs.append)
    assert any("resume: restarting from checkpoint step 4" in s
               for s in logs)
    assert hist["step"] == [5]
    want, got = train_state_tree(full), train_state_tree(resumed)
    for (k, a), (_, b) in zip(_leaves_t(want), _leaves_t(got)):
        assert torch.equal(a, b), k
    assert int(resumed["opt"]["count"]) == 8


def _leaves_t(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_t(tree[k], f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves_t(v, f"{path}/{i}")
    else:
        yield path, tree


def test_train_state_crosses_over_and_a_bf16_state_checkpoints(tmp_path):
    jcfg, tcfg = _tiny()
    jt, tt = _tcfgs()
    jstate, tstate = _states(jcfg, tcfg, jt, tt)
    assert all(p.requires_grad for p in tstate["model"].parameters())
    ref = dict(_leaves(jax.tree.map(np.asarray, jstate)))
    got = dict(_leaves(train_state_tree(tstate)))
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    cfg16 = dataclasses.replace(tcfg, dtype="bfloat16")
    tt16 = t_steps.TrainConfig(optimizer=AdamWConfig(moment_dtype="bfloat16"))
    s16 = t_steps.init_train_state(cfg16, tt16, torch.Generator().manual_seed(0),
                                   device="cpu")
    t_steps.make_train_step(cfg16, tt16)(s16, {
        "tokens": torch.from_numpy(_batches(cfg16, 1)[0][0]),
        "targets": torch.from_numpy(_batches(cfg16, 1)[0][1])})
    t_ckpt.save_checkpoint(str(tmp_path), 1, train_state_tree(s16))
    _, back = t_ckpt.load_checkpoint(str(tmp_path), 1)
    for (k, a), (_, b) in zip(_leaves_t(train_state_tree(s16)),
                              _leaves_t(back)):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert back["params"]["embed"]["table"].dtype == torch.bfloat16
    assert back["opt"]["mu"]["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_phase12_checks_rehearse_on_the_cpu(monkeypatch, dtype):
    """``chip_smoke.py`` phase 12's gradient checks and training steps on
    the smoke configs (remat on, gemma2's 64-token window binding at
    S=96, falcon-mamba's chunked twin at a chunk of 8), the plain
    versions counted as the kernel's launches: every check of the card
    run holds here at the card's limits, each wrong kernel and wrong
    twin of the card run (``attention_controls``, ``scan_controls``)
    falls outside them, and in float32 the twin's backward sits within
    1e-5 of the plain version's own gradient (printed with ``-s``)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops

    def counted(fn, counter):
        def run(*a, **k):
            counter.launches += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(fa_ops, "attention_ref",
                        counted(fa_ops.attention_ref, fa_ops.flash_attention))
    monkeypatch.setattr(ssm_ops, "mamba_scan_ref",
                        counted(ssm_ops.mamba_scan_ref,
                                ssm_ops.selective_scan))
    fa = lambda: fa_ops.flash_attention.launches  # noqa: E731
    scan = lambda: ssm_ops.selective_scan.launches  # noqa: E731
    gemma = t_configs.get_smoke_config("gemma2-2b").replace(remat=True)
    mamba = t_configs.get_smoke_config("falcon-mamba-7b").replace(
        remat=True, ssm_chunk=8)
    g = chip_smoke.grad_check("gemma2", gemma, 96,
                              lambda: chip_smoke.plain_attention(t_attn), fa,
                              dtype,
                              chip_smoke.attention_controls(t_attn, dtype),
                              dev="cpu")
    m = chip_smoke.grad_check("mamba", mamba, 32,
                              lambda: chip_smoke.plain_scan(t_ssm), scan,
                              dtype, chip_smoke.scan_controls(t_ssm),
                              dev="cpu")
    assert g["launches"] == 2 * gemma.n_layers and m["launches"] == 4
    assert len(g["controls"]) == (5 if dtype == "float32" else 1)
    assert len(m["controls"]) == 2
    if dtype == "float32":
        assert max(g["worst_leaf_rel_l2"], m["worst_leaf_rel_l2"]) <= 1e-5
        return
    out, _, _ = chip_smoke.train_steps("gemma2", gemma.replace(
        dtype="bfloat16"), 96, fa, dev="cpu")
    assert out["launches"] == chip_smoke.TRAIN_STEPS * 2 * gemma.n_layers
    assert out["losses"][-1] < out["losses"][0]
