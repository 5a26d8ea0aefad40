"""repro_torch.runtime — the protocol API and its two backends: the
simulated cluster and the ``torch.distributed`` mesh."""
from .base import ProtocolRuntime, RecordSpec, make_runtime
from .mesh import MeshRuntime, task_data_mesh, task_mesh
from .recovery import init_cluster
from .sim import SimRuntime


__all__ = ["MeshRuntime", "ProtocolRuntime", "RecordSpec", "SimRuntime",
           "init_cluster", "make_runtime", "task_data_mesh", "task_mesh"]
