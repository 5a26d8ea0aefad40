"""Multi-process bring-up of the mesh runtime.

Port of the ``init_cluster`` part of ``repro.runtime.recovery``; the
segmented, resumable solves of that module are not ported yet.
"""
from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device

# (world group, its collective timeout) as ``init_cluster`` started it:
# the mesh builders give every subgroup the same timeout
_STARTED: Optional[tuple] = None


def world_timeout() -> datetime.timedelta:
    """The collective timeout ``init_cluster`` gave the current world
    group; raises if the group was started some other way."""
    if _STARTED is None or _STARTED[0] is not dist.group.WORLD:
        raise RuntimeError("the torch.distributed process group was not "
                           "started by init_cluster, so its timeout is "
                           "unknown: start it with init_cluster")
    return _STARTED[1]


def _coordinator_up(address: str, timeout_s: float) -> bool:
    """Whether the TCP coordinator at ``host:port`` accepts connections."""
    host, _, port = address.rpartition(":")
    try:
        with socket.create_connection((host, int(port)), timeout=timeout_s):
            return True
    except OSError:
        return False


def init_cluster(coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None, *,
                 timeout_s: float = 60.0, backoff_s: float = 0.5,
                 retries: int = 5, device: DeviceLike = None) -> None:
    """``torch.distributed.init_process_group`` for one rank of the mesh
    runtime, with coordinator retry and exponential backoff.

    ``device`` picks the backend and is the card by default (raising
    without one): NCCL for ``cuda`` (the rank's card becomes the current
    device), gloo for ``cpu``.  ``coordinator_address`` is ``host:port``
    of process 0, or a ``file://`` path that every rank can reach (a
    file store, which opens no port).  The coordinator may come up later
    than its workers under a real launcher, so a worker waits for the
    TCP coordinator to accept connections, retrying ``retries`` times
    with waits of ``backoff_s * 2**attempt``, before it joins.
    ``timeout_s`` bounds the join and every later collective of the
    group and of the mesh subgroups built on it (:func:`world_timeout`).

    Arguments default to the ``REPRO_COORDINATOR`` /
    ``REPRO_NUM_PROCESSES`` / ``REPRO_PROCESS_ID`` environment
    variables, so one script serves every rank.
    """
    coordinator_address = coordinator_address or \
        os.environ.get("REPRO_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("REPRO_NUM_PROCESSES", "0")) or None
    if process_id is None:
        pid = os.environ.get("REPRO_PROCESS_ID")
        process_id = int(pid) if pid is not None else None
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("init_cluster needs coordinator_address, "
                         "num_processes and process_id (arguments or "
                         "REPRO_* environment)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_cluster runs on 'cuda' or 'cpu', not "
                         f"{dev.type!r}")
    tcp = "://" not in coordinator_address
    init_method = (f"tcp://{coordinator_address}" if tcp
                   else coordinator_address)
    global _STARTED
    timeout = datetime.timedelta(seconds=timeout_s)
    last = None
    for attempt in range(retries + 1):
        if not tcp or process_id == 0 or \
                _coordinator_up(coordinator_address, backoff_s):
            try:
                dist.init_process_group(
                    backend, init_method=init_method,
                    world_size=num_processes, rank=process_id,
                    timeout=timeout)
                _STARTED = (dist.group.WORLD, timeout)
                return
            except Exception as e:        # coordinator gone, or busy
                last = e
        else:
            last = ConnectionRefusedError(
                f"no coordinator at {coordinator_address} yet")
        if attempt == retries:
            break
        time.sleep(backoff_s * (2 ** attempt))
    raise RuntimeError(
        f"could not join the torch.distributed cluster at "
        f"{coordinator_address} as process {process_id}/{num_processes} "
        f"after {retries + 1} attempts: {last}") from last
