"""The dense LM stack of the port (serving path): configs in
:mod:`repro_torch.configs`, modules here, the engine in
:mod:`repro_torch.serve.engine`."""
from .model import (LM, decode_step, forward, init_cache, init_params,
                    prefill)

__all__ = ["LM", "decode_step", "forward", "init_cache", "init_params",
           "prefill"]
