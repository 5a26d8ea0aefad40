"""Serving: the factored MTL server (``repro_torch.serve.mtl``) and the
LM engine (``repro_torch.serve.engine``, imported on its own so that the
MTL server does not load the LM stack)."""
from .mtl import FactoredModel, MTLServer, onboard_code  # noqa: F401

__all__ = ["FactoredModel", "MTLServer", "onboard_code"]
