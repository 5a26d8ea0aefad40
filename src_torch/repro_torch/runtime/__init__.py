"""repro_torch.runtime — the protocol API and its simulated backend."""
from .base import ProtocolRuntime, RecordSpec, make_runtime
from .sim import SimRuntime

__all__ = ["ProtocolRuntime", "RecordSpec", "SimRuntime", "make_runtime"]
