"""Instantaneous losses from the paper (Assumption 2.1 family).

Port of ``repro.core.losses``.  Each loss exposes value / first / second
derivative w.r.t. the margin ``a = <w, x>``:

  squared:   l(a, y) = 0.5 (a - y)^2          H = 1
  logistic:  l(a, y) = log(1 + exp(-y a)),    y in {-1, +1},   H = 1/4
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F

Fn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Loss:
    name: str
    smoothness: float  # H in the paper's Assumption 2.1
    value: Fn
    d1: Fn
    d2: Fn

    def mean_loss(self, preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.mean(self.value(preds, y))


def _sq_value(a, y):
    return 0.5 * (a - y) ** 2


def _sq_d1(a, y):
    return a - y


def _sq_d2(a, y):
    return torch.ones_like(a)


squared = Loss("squared", 1.0, _sq_value, _sq_d1, _sq_d2)


def _logistic_value(a, y):
    # log(1 + exp(-y a)), numerically stable via softplus.
    return F.softplus(-y * a)


def _logistic_d1(a, y):
    return -y * torch.sigmoid(-y * a)


def _logistic_d2(a, y):
    s = torch.sigmoid(y * a)
    return s * (1.0 - s)


logistic = Loss("logistic", 0.25, _logistic_value, _logistic_d1, _logistic_d2)

LOSSES = {"squared": squared, "logistic": logistic}


def get_loss(name: str) -> Loss:
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; have {sorted(LOSSES)}") from None
