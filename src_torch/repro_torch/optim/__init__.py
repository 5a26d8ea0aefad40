"""The optimizer of the LM training path: hand-rolled AdamW, global-norm
clipping and the LR schedules, on tensors under ``torch.no_grad()``.

Port of ``repro.optim``.  ``torch.optim`` is not used: its ``step()``
imports ``torch._dynamo``, which writes ``os.environ``."""
from .adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from .clip import clip_by_global_norm  # noqa: F401
from .schedules import cosine_schedule, linear_warmup  # noqa: F401

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "cosine_schedule", "linear_warmup"]
