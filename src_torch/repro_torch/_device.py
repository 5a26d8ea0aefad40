"""Device resolution: the card by default, the CPU only when asked."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; any other value is taken as given.

    Raises ``RuntimeError`` when the card is asked for (explicitly or by
    default) and PyTorch sees none: the port never falls back to the
    CPU on its own, so a run that was meant for the card cannot quietly
    measure the host instead.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return dev

