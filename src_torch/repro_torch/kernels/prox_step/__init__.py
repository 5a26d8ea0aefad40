"""The fused prox-family worker step: mini-batch gradient and step in one
kernel, the local step of every stochastic ProxGD / AccProxGD / ADMM
round."""
from .ops import prox_step
from .ref import prox_step_ref

__all__ = ["prox_step", "prox_step_ref"]
