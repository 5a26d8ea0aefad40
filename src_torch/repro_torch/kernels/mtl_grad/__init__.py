"""Per-task loss gradients, the raw-path worker kernel of every solver round."""
from .ops import task_gradients
from .ref import task_gradients_ref

__all__ = ["task_gradients", "task_gradients_ref"]
