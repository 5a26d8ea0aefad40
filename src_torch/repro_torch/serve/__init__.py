"""Serving: the factored MTL server (``repro_torch.serve.mtl``)."""
from .mtl import FactoredModel, MTLServer, onboard_code  # noqa: F401

__all__ = ["FactoredModel", "MTLServer", "onboard_code"]
