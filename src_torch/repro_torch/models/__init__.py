"""The LM stack of the port: configs in :mod:`repro_torch.configs`,
modules here, the serving engine in :mod:`repro_torch.serve.engine`, the
training step in :mod:`repro_torch.train.steps`."""
from .model import (LM, decode_step, forward, hidden_states, init_cache,
                    init_params, lm_loss, prefill)

__all__ = ["LM", "decode_step", "forward", "hidden_states", "init_cache",
           "init_params", "lm_loss", "prefill"]
