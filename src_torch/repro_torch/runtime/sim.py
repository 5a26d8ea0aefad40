"""Simulated-cluster backend: one process plays all m machines.

Port of ``repro.runtime.sim`` with ``data_shards=1``.  The worker view
holds every task, per-task work is batched over the full task axis (the
solvers' ``torch.func.vmap`` and batched ops) and the collectives are
identities that only charge the ledger.
"""
from __future__ import annotations

import torch

from .base import MESH_TODO, ProtocolRuntime


class SimRuntime(ProtocolRuntime):
    name = "sim"

    def __init__(self, prob, data_shards: int = 1):
        super().__init__(prob)
        if data_shards != 1:
            raise NotImplementedError(MESH_TODO)

    def local_slice(self, x, axis: int = -1):
        return x

    def gather_columns(self, x, note: str = ""):
        # (d, m) already global; ledger: 1 d-vector per machine.
        self._charge("worker->master", 1, x.shape[0], note, wire=0)
        return x

    def gather_tasks(self, x, note: str = ""):
        vectors, dim = self._payload_vectors(x)
        self._charge("worker->master", vectors, dim, note, wire=0)
        return x

    def sum_tasks(self, x, note: str = ""):
        vectors, dim = self._payload_vectors(x)
        self._charge("worker->master", vectors, dim, note, wire=0)
        return torch.sum(x, dim=0)
