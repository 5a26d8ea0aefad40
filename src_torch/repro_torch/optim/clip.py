"""Global-norm gradient clipping, port of ``repro.optim.clip``."""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


@torch.no_grad()
def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / ‖g‖)``, with ‖g‖ the
    float32 norm over all of them; each keeps its dtype.  Returns the
    clipped gradients and ‖g‖ (a device scalar)."""
    sq = None
    for g in grads.values():
        s = torch.sum(g.to(torch.float32) ** 2)
        sq = s if sq is None else sq + s
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return ({k: (g.to(torch.float32) * scale).to(g.dtype)
             for k, g in grads.items()}, gnorm)
