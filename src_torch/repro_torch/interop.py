"""Carry the JAX package's weights across to the port.

Models that were saved cross over through the shared store format
(``FactoredModel.load`` reads the reference's stores).  A model held in
memory by the reference crosses as numpy factors: hand
``np.asarray(model.U)``, ``np.asarray(model.s)`` and ``np.asarray(model.V)``
to :func:`factored_from_numpy`.  The bytes are kept as they are, so the
port's model has the reference model's ``version``.  This module imports
neither JAX nor the reference: the caller does the ``np.asarray``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ._device import DeviceLike, resolve_device
from .serve.mtl import FactoredModel


def factored_from_numpy(U: np.ndarray, s: np.ndarray, V: np.ndarray,
                        loss: str = "squared",
                        task_keys: Optional[Sequence[str]] = None,
                        device: DeviceLike = None) -> FactoredModel:
    """A port :class:`FactoredModel` on ``device`` (default: the card)
    from numpy factors ``U (p, r)``, ``s (r,)``, ``V (m, r)``, dtype
    kept, with the same content-hash ``version`` as the model they came
    from."""
    dev = resolve_device(device)

    def move(a):
        return torch.from_numpy(np.array(a, order="C")).to(dev)  # own copy

    return FactoredModel(U=move(U), s=move(s), V=move(V), loss=loss,
                         task_keys=None if task_keys is None
                         else tuple(task_keys))
