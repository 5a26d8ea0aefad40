"""Hand-rolled AdamW, port of ``repro.optim.adamw``: moments in float32
whatever the parameters' dtype, or in bfloat16 (``moment_dtype``), which
halves the optimizer's memory for a small quality risk.

Parameters, gradients and moments are dicts of tensors with the same
keys (the port keys them by parameter name); the update writes the
parameters and the moments in place and reads nothing back to the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "float32"    # "bfloat16" halves optimizer memory


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig
               ) -> Dict[str, object]:
    """Zero moments beside each parameter and an int32 step count on the
    parameters' device."""
    mdt = _DTYPES[cfg.moment_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)  # noqa: E731
    dev = next(iter(params.values())).device
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict[str, object],
                 cfg: AdamWConfig,
                 lr_scale: Union[torch.Tensor, float] = 1.0
                 ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, object]]:
    """One AdamW step in float32: bias-corrected moments, decoupled
    weight decay on leaves of two or more dims (norms and biases
    exempt), ``lr · lr_scale`` as the step size.  Writes ``params`` and
    the moments in place, advances ``count``, and returns both."""
    f32 = torch.float32
    count = state["count"] + 1
    c = count.to(f32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=f32, device=c.device), c)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=f32, device=c.device), c)
    step_size = cfg.lr * torch.as_tensor(lr_scale, dtype=f32,
                                         device=c.device)
    mu_all, nu_all = state["mu"], state["nu"]
    for k, p in params.items():
        g32 = grads[k].to(f32)
        mu32 = cfg.b1 * mu_all[k].to(f32) + (1 - cfg.b1) * g32
        nu32 = cfg.b2 * nu_all[k].to(f32) + (1 - cfg.b2) * g32 * g32
        step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * p.to(f32)
        p.copy_(p.to(f32) - step_size * step)
        mu_all[k].copy_(mu32)
        nu_all[k].copy_(nu32)
    state["count"] = count
    return params, state
