"""train_step / serve_step factories, port of ``repro.train.steps``.

train_step(state, batch) -> (state, metrics)
  state = {"model": LM, "opt": {"mu", "nu", "count"}}; forward and
  backward through :func:`repro_torch.models.model.lm_loss` (each layer
  rematerialized under ``cfg.remat``), global-norm clip, AdamW, cosine
  LR.  The parameters and moments are updated in place and the same
  state is returned; the metrics (``loss``, ``nll``, ``aux``,
  ``grad_norm``, ``lr_scale``) are device scalars, so a step reads
  nothing back to the host.

serve_step(model, cache, token, pos) -> (logits, cache)
  ONE new token against a KV cache / SSM state, the port's
  ``decode_step``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from ..models import model as model_mod
from ..optim import (AdamWConfig, adamw_init, adamw_update,
                     clip_by_global_norm, cosine_schedule)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    max_grad_norm: float = 1.0
    total_steps: int = 10_000
    warmup_steps: int = 200
    microbatch: int = 0        # 0 -> no gradient accumulation


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig,
                     generator: Optional[torch.Generator] = None,
                     device: DeviceLike = None) -> Dict[str, object]:
    """A seeded model on ``device`` (default: the card) with trainable
    parameters, and zero AdamW moments beside them."""
    model = model_mod.init_params(cfg, generator, resolve_device(device))
    model.requires_grad_(True)
    return {"model": model,
            "opt": adamw_init(dict(model.named_parameters()),
                              tcfg.optimizer)}


def _loss_and_grads(model, params, batch
                    ) -> Tuple[torch.Tensor, Dict, Tuple[torch.Tensor, ...]]:
    loss, metrics = model_mod.lm_loss(model, batch)
    grads = torch.autograd.grad(loss, tuple(params.values()))
    return loss.detach(), metrics, grads


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig) -> Callable:
    """The training step of ``cfg`` (the model in the state must be of
    this config)."""
    def train_step(state, batch):
        model, opt = state["model"], state["opt"]
        params = dict(model.named_parameters())
        if tcfg.microbatch:
            grads, metrics = _accumulated_grads(model, params, batch,
                                                tcfg.microbatch)
        else:
            loss, aux, g = _loss_and_grads(model, params, batch)
            grads = dict(zip(params, g))
            metrics = {"nll": aux["nll"].detach(),
                       "aux": aux["aux"].detach(), "loss": loss}
        grads, gnorm = clip_by_global_norm(grads, tcfg.max_grad_norm)
        lr_scale = cosine_schedule(opt["count"], tcfg.total_steps,
                                   tcfg.warmup_steps)
        adamw_update(params, grads, opt, tcfg.optimizer, lr_scale)
        metrics = dict(metrics, grad_norm=gnorm, lr_scale=lr_scale)
        return state, metrics

    return train_step


def _accumulated_grads(model, params, batch, n_micro: int):
    """Gradient accumulation over ``n_micro`` microbatches (the batch split
    on dim 0): float32 gradients summed and divided by ``n_micro``, the
    loss their mean, as the reference's ``lax.scan`` (whose metrics are
    the loss alone)."""
    def split(x):
        x = torch.as_tensor(x)
        return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])

    micro = {k: split(v) for k, v in batch.items()}
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
    for i in range(n_micro):
        loss, _, g = _loss_and_grads(model, params,
                                     {k: v[i] for k, v in micro.items()})
        for k, gi in zip(params, g):
            acc[k].add_(gi)
        loss_sum = loss_sum + loss
    return ({k: a / n_micro for k, a in acc.items()},
            {"loss": loss_sum / n_micro})


def make_serve_step(cfg: ModelConfig) -> Callable:
    def serve_step(model, cache, token, pos):
        return model_mod.decode_step(model, token, pos, cache)
    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def prefill_step(model, batch, cache):
        return model_mod.prefill(model, batch, cache)
    return prefill_step
