"""Model-level API of the LMs: init, forward, cache, prefill, decode.

Port of ``repro.models.model`` for the decoder-only dense family and
Mamba-1 (falcon-mamba).  The
reference's params are a pytree beside a static config; the port's model
is an :class:`LM` module that holds its config, and the entry points take
it where the reference takes ``(params, cfg)``:

  init_params(cfg, generator, device)   -> LM (random init, seeded)
  forward(model, batch)                 -> logits (B, S, V), no cache
  hidden_states(model, batch)           -> final-normed trunk output
  init_cache(cfg, batch, max_len, device) -> list of per-layer caches
  prefill(model, batch, cache)          -> (last-token logits (B, V), cache)
  decode_step(model, token, pos, cache) -> (logits (B, V), cache)
  lm_loss(model, batch)                 -> (total, {"nll", "aux"}), with grad

The serving entry points run without autograd.  :func:`lm_loss` is the
training side: the trunk with gradients on, each layer rematerialized in
backward under ``cfg.remat`` (:func:`repro_torch._recompute.recompute_vjp`,
the port's ``jax.checkpoint``), the LM kernels differentiated through
their twins.  Parameters are created with ``requires_grad=False``;
training switches it on (:func:`repro_torch.train.steps.init_train_state`).

``batch`` is ``{"tokens": (B, S) int}``.  Positions are ``0..S-1`` for
every row, padding included, as in the reference; Mamba layers do not
read them.  A cache holds one dict per layer: a KV ring buffer for an
attention layer, the SSM state and conv window for a Mamba layer, each
written in place by prefill and decode.  Encoder-decoder,
VLM, learned positions and MTP raise :class:`NotImplementedError`.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .._device import DeviceLike, resolve_device
from .._recompute import recompute_vjp
from ..configs.base import ModelConfig
from .blocks import build_plan, grad_cast, init_segment_cache, segment_layers
from .common import Norm, dtype_of, embed, truncated_normal_, unembed
from .ssm import MAMBA2_NOT_PORTED


_NOT_PORTED = {
    "hybrid": "mamba-2 layers and the shared attention block (zamba2) are "
              "not ported: ROADMAP Queue 1 item 11c",
    "moe": "MoE layers are not ported: ROADMAP Queue 1 item 11c",
    "encdec": "the encdec family (whisper's cross-attention layers) is not "
              "ported: ROADMAP Queue 1 item 11c",
    "vlm": "the vlm family is not ported: ROADMAP Queue 1 item 11c",
}


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family == "ssm" and cfg.mamba_version != 1:
        raise NotImplementedError(f"{cfg.arch_id}: {MAMBA2_NOT_PORTED}")
    if cfg.family in _NOT_PORTED or cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.arch_id}: {_NOT_PORTED.get(cfg.family, _NOT_PORTED['moe'])}")
    if cfg.mtp or cfg.learned_pos_embed:
        raise NotImplementedError(
            f"{cfg.arch_id}: MTP heads and learned positions are not "
            f"ported: ROADMAP Queue 1 item 11c")


class LM(nn.Module):
    """Embedding, the layer stack in the reference's order, the final
    norm and the (tied or untied) unembedding.  Parameters are created
    uninitialised on ``device``; :func:`init_params` draws them and
    :func:`repro_torch.interop.lm_params_from_numpy` copies them in."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        cfg.validate()
        _check_ported(cfg)
        self.cfg = cfg
        dt = dtype_of(cfg)
        shape = (cfg.vocab_size, cfg.d_model)
        self.embed = nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                  requires_grad=False)
        self.final_norm = Norm(cfg, cfg.d_model, device)
        self.head = (None if cfg.tie_embeddings else
                     nn.Parameter(torch.empty(shape, dtype=dt, device=device),
                                  requires_grad=False))
        self.layers = nn.ModuleList(
            layer for seg in build_plan(cfg)
            for layer in segment_layers(cfg, seg, device))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The reference's initializers: embedding std 1, untied head std
        ``d_model ** -0.5``, dense weights std ``d_in ** -0.5`` (output
        projections ``d_out``-scaled as in the reference), norms zero."""
        truncated_normal_(self.embed, 1.0, generator)
        self.final_norm.reset_parameters()
        if self.head is not None:
            truncated_normal_(self.head, self.cfg.d_model ** -0.5, generator)
        for layer in self.layers:
            layer.reset_parameters(generator)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device: DeviceLike = None) -> LM:
    """A randomly initialised model on ``device`` (default: the card),
    drawn from ``generator`` (a ``torch.Generator`` on that device)."""
    model = LM(cfg, resolve_device(device))
    model.reset_parameters(generator)
    return model


def _tokens(model: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    extra = sorted(set(batch) - {"tokens"})
    if extra:
        raise NotImplementedError(
            f"batch keys {extra} (modality prefixes, prefix-LM) are not "
            f"ported: ROADMAP Queue 1 item 11c")
    return torch.as_tensor(batch["tokens"], device=model.device)


def _positions(B: int, S: int, device: torch.device) -> torch.Tensor:
    return (torch.arange(S, dtype=torch.int32, device=device)[None]
            .expand(B, S).contiguous())


def _trunk(model: LM, x: torch.Tensor, positions: torch.Tensor,
           caches: Optional[List[dict]] = None,
           remat: bool = False) -> torch.Tensor:
    """The layers and the final norm.  ``remat`` (training, no cache):
    each layer runs without a graph and is re-run in backward, its
    parameters the recomputation's leaves (the reference's
    ``jax.checkpoint`` of the layer scan's body)."""
    for i, layer in enumerate(model.layers):
        if remat:
            run = functools.partial(_run_layer, layer, positions)
            x = recompute_vjp(run, run, (x,), tuple(layer.parameters()))
        else:
            x = layer(x, positions=positions,
                      cache=None if caches is None else caches[i])
    return model.final_norm(x)


def _run_layer(layer: nn.Module, positions: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    return layer(x, positions=positions)


@torch.no_grad()
def hidden_states(model: LM, batch: Dict[str, torch.Tensor]
                  ) -> torch.Tensor:
    """The trunk's output after the final norm, (B, S, d_model), without
    a cache: the features a head on the backbone reads."""
    tokens = _tokens(model, batch)
    B, S = tokens.shape
    x = embed(model.embed, tokens, model.cfg)
    return _trunk(model, x, _positions(B, S, model.device))


@torch.no_grad()
def forward(model: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward without a cache: logits (B, S, V)."""
    return unembed(model.embed, model.head, hidden_states(model, batch),
                   model.cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> List[dict]:
    """One cache per layer, in layer order: a ring buffer per attention
    layer, zero SSM state and conv window per Mamba layer."""
    _check_ported(cfg)
    dev = resolve_device(device)
    return [c for seg in build_plan(cfg)
            for c in init_segment_cache(cfg, seg, batch, max_len, dev)]


@torch.no_grad()
def prefill(model: LM, batch: Dict[str, torch.Tensor], cache: List[dict]
            ) -> Tuple[torch.Tensor, List[dict]]:
    """Run the prompt through the trunk, filling the cache in place.
    Returns (last-token logits (B, V), cache)."""
    tokens = _tokens(model, batch)
    B, S = tokens.shape
    x = embed(model.embed, tokens, model.cfg)
    x = _trunk(model, x, _positions(B, S, model.device), cache)
    logits = unembed(model.embed, model.head, x[:, -1:], model.cfg)
    return logits[:, 0], cache


def lm_loss(model: LM, batch: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``lm_loss`` with gradients: float32 logits, mean of
    logsumexp minus the gold logit over ``batch["targets"]`` (B, S), plus
    ``router_aux_coef`` times the auxiliary loss (0: no ported layer has
    one).  Returns (total, {"nll", "aux"}), device scalars."""
    cfg = model.cfg
    tokens = _tokens(model, {"tokens": batch["tokens"]})
    targets = torch.as_tensor(batch["targets"], device=model.device)
    B, S = tokens.shape
    x = embed(model.embed, tokens, cfg)
    x = _trunk(model, x, _positions(B, S, model.device), remat=cfg.remat)
    logits = unembed(model.embed, model.head, x, cfg)
    if cfg.bf16_grad_boundary:
        logits = grad_cast(logits)    # model-dtype cotangent into unembed
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].to(torch.int64))[..., 0]
    nll = (logz - gold).mean()
    aux = torch.zeros((), dtype=torch.float32, device=model.device)
    return nll + cfg.router_aux_coef * aux, {"nll": nll, "aux": aux}


@torch.no_grad()
def decode_step(model: LM, token: torch.Tensor, pos: torch.Tensor,
                cache: List[dict]) -> Tuple[torch.Tensor, List[dict]]:
    """One decode step. token: (B,) int; pos: (B,) absolute positions.
    Returns (logits (B, V), cache), the cache updated in place."""
    token = torch.as_tensor(token, device=model.device)
    positions = torch.as_tensor(pos, device=model.device).to(
        torch.int32).reshape(-1, 1)
    x = embed(model.embed, token[:, None], model.cfg)
    x = _trunk(model, x, positions, cache)
    return unembed(model.embed, model.head, x, model.cfg)[:, 0], cache
