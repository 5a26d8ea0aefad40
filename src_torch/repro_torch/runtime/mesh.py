"""Mesh backend: the task axis is a real ``torch.distributed`` mesh axis.

Port of ``repro.runtime.mesh``.  One process (rank) plays one device of
the reference's mesh and runs the round body eagerly, SPMD, on its own
block of the problem.  Every rank holds the whole problem, as the
reference builds it on every host, and keeps its block:

* its ``m/T`` tasks, ``T`` the size of the "tasks" axis;
* under 2-D, its contiguous rows ``[d n/D, (d+1) n/D)`` of each task,
  ``d`` its index on the "data" axis of size ``D`` — the blocks
  ``PartitionSpec("tasks", "data", None)`` assigns.

The paper's messages become collectives over the "tasks" group:

  workers send columns to master   ->  all-gather (``gather_columns`` /
                                       ``gather_tasks``)
  workers send a summed payload    ->  local sum, then all-reduce
  master broadcasts                ->  free: every rank holds the gathered
                                       matrix and runs the master step on
                                       it (the replicated master), but
                                       still charged to the ledger

The ledger and ``collective_floats_per_chip`` come from the same
primitive calls as the reference's (``wire = x.numel()``, the
collective's kind and its operand size), so they cannot disagree.
Data-axis statistics reduce over the "data" group (``psum_data`` /
``pmean_data`` / ``gather_samples``) and are measured into
``data_collective_floats_per_chip``; the 2-D Gram cache is a data-group
all-reduce of per-shard partial Grams, charged once per solve as setup.

Meshes are ``torch.distributed.device_mesh.DeviceMesh`` objects over
``("tasks",)`` or ``("tasks", "data")``, shaped ``(world/D, D)`` row
major as ``jax.make_mesh`` lays them out.  The process group comes
first (``runtime.recovery.init_cluster``); its backend must suit the
mesh's device (NCCL for the card, gloo for the CPU), and nothing here
switches either one.  Subgroups are made by every rank in the same
order, each with the timeout ``init_cluster`` gave the world group.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from .._device import DeviceLike, resolve_device
from .base import SAMPLE_AXIS_LEAVES, ProtocolRuntime
from .recovery import world_timeout

# torch names the flat all-gather ``all_gather_single`` from 2.13 and
# ``all_gather_into_tensor`` before it (deprecated since)
_all_gather_flat = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)

# the process-group backend each mesh device type needs
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}

# default meshes, one per (world group, device type, shape, names): a
# solve without ``mesh=`` reuses the groups of the last one
_MESHES: dict = {}


def _all_gather(x: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``, in group-rank
    order (``lax.all_gather(..., tiled=True)``)."""
    x = x.contiguous()
    out = torch.empty((size * x.numel(),), dtype=x.dtype, device=x.device)
    _all_gather_flat(out, x.reshape(-1), group=group)
    out = torch.movedim(out.reshape((size,) + tuple(x.shape)), 0, dim)
    return out.reshape(x.shape[:dim] + (size * x.shape[dim],)
                       + x.shape[dim + 1:])


def _checked_world(device: DeviceLike) -> Tuple[str, int]:
    """The mesh's device type and the world size, after checking that a
    process group exists and that its backend suits the device."""
    dev = resolve_device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu' devices, not "
                         f"{dev.type!r}")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start one first "
            "(repro_torch.runtime.init_cluster), one process per device")
    backend = str(dist.get_backend())
    if _BACKENDS[dev.type] not in backend:
        raise ValueError(f"the process group runs {backend!r}; a "
                         f"{dev.type!r} mesh needs {_BACKENDS[dev.type]!r}")
    return dev.type, dist.get_world_size()


def _grid_mesh(device_type: str, shape: Tuple[int, ...],
               names: Tuple[str, ...]):
    """A DeviceMesh over the world's ranks laid out row major in
    ``shape``.  Every rank creates every group of every axis in the same
    order, so the collective group creation cannot deadlock."""
    from torch.distributed.device_mesh import DeviceMesh
    key = (dist.group.WORLD, device_type, shape, names)
    if key in _MESHES:
        return _MESHES[key]
    timeout = world_timeout()
    rank = dist.get_rank()
    grid = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    groups = []
    for axis in range(len(shape)):
        mine = None
        for line in grid.movedim(axis, -1).reshape(-1, shape[axis]).tolist():
            g = dist.new_group(line, timeout=timeout)
            if rank in line:
                mine = g
        groups.append(mine)
    mesh = DeviceMesh.from_group(groups[0] if len(groups) == 1 else groups,
                                 device_type, mesh=grid,
                                 mesh_dim_names=names)
    _MESHES[key] = mesh
    return mesh


def task_mesh(axis: str = "tasks", *, device: DeviceLike = None):
    """A 1-D mesh over the whole process group: every rank is one worker
    group on the task axis.  ``device`` is the mesh's device type, the
    card by default (raising without one)."""
    dev_type, world = _checked_world(device)
    return _grid_mesh(dev_type, (world,), (axis,))


def task_data_mesh(data_shards: int, axis: str = "tasks",
                   data_axis: str = "data", *, device: DeviceLike = None):
    """A 2-D ``(tasks, data)`` mesh over the whole process group:
    ``world / data_shards`` worker groups, each sharding its tasks' rows
    over ``data_shards`` ranks."""
    dev_type, world = _checked_world(device)
    if data_shards < 1 or world % data_shards:
        raise ValueError(f"{world} devices cannot form a mesh with "
                         f"data_shards={data_shards}")
    return _grid_mesh(dev_type, (world // data_shards, data_shards),
                      (axis, data_axis))


def mesh_axis(mesh, axis: str) -> Tuple[int, int, object]:
    """(size, this rank's index, this rank's group) of one mesh axis."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"the mesh has no {axis!r} axis; its axes are "
                         f"{names}")
    return (mesh.size(names.index(axis)), mesh.get_local_rank(axis),
            mesh.get_group(axis))


def _tree_map(fn, value):
    """``fn`` on every tensor leaf of a state entry (a tensor, or a dict
    of them such as a spectral-engine carry)."""
    if isinstance(value, dict):
        return {k: _tree_map(fn, v) for k, v in value.items()}
    return fn(value)


class MeshRuntime(ProtocolRuntime):
    name = "mesh"

    def __init__(self, prob, mesh=None, axis: str = "tasks",
                 data_axis: str = "data", data_shards: int = 1):
        super().__init__(prob)
        if mesh is None:
            dev = prob.device.type
            mesh = (task_data_mesh(data_shards, axis=axis,
                                   data_axis=data_axis, device=dev)
                    if data_shards > 1 else task_mesh(axis=axis, device=dev))
        names = tuple(mesh.mesh_dim_names or ())
        if data_axis in names:
            mesh_shards = mesh.size(names.index(data_axis))
            if data_shards not in (1, mesh_shards):
                raise ValueError(
                    f"data_shards={data_shards} contradicts the mesh's "
                    f"{data_axis!r} axis of size {mesh_shards}")
            data_shards = mesh_shards
        elif data_shards > 1:
            raise ValueError(f"data_shards={data_shards} needs a mesh with "
                             f"a {data_axis!r} axis (task_data_mesh)")
        if mesh.device_type != prob.device.type:
            raise ValueError(f"the mesh lies on {mesh.device_type!r} devices "
                             f"and the problem on {prob.device}")
        self.mesh = mesh
        self.axis = axis
        self.data_axis = data_axis
        self.data_shards = int(data_shards)
        ndev, self._t, self._tasks_group = mesh_axis(mesh, axis)
        if prob.m % ndev:
            raise ValueError(f"m={prob.m} tasks must be divisible by the "
                             f"{ndev} devices on axis {axis!r} (each chip "
                             f"simulates m/devices machines)")
        if prob.n % self.data_shards:
            raise ValueError(f"n={prob.n} samples per task must be "
                             f"divisible by data_shards={self.data_shards}")
        self._T = ndev
        self._per_chip = prob.m // ndev
        self._d, self._data_group = 0, None
        if self.data_shards > 1:
            _, self._d, self._data_group = mesh_axis(mesh, data_axis)

    @property
    def local_tasks(self) -> int:
        return self._per_chip

    def data_index(self) -> int:
        return self._d

    def local_slice(self, x, axis: int = -1):
        per = x.shape[axis] // self._T
        return x.narrow(axis, self._t * per, per)

    def gather_columns(self, x, note: str = ""):
        # x: (d, L) local columns -> (d, m); each machine ships 1 d-vector
        self._charge("worker->master", 1, x.shape[0], note, wire=x.numel(),
                     kind="all_gather", payload=x.numel())
        return _all_gather(x, self._tasks_group, self._T, x.ndim - 1)

    def gather_tasks(self, x, note: str = ""):
        vectors, dim = self._payload_vectors(x)
        self._charge("worker->master", vectors, dim, note, wire=x.numel(),
                     kind="all_gather", payload=x.numel())
        return _all_gather(x, self._tasks_group, self._T, 0)

    def sum_tasks(self, x, note: str = ""):
        vectors, dim = self._payload_vectors(x)
        # charged wire: every simulated machine ships its payload; the
        # all-reduce operand is the rank's local pre-reduction, L times
        # smaller
        self._charge("worker->master", vectors, dim, note, wire=x.numel(),
                     kind="psum", payload=x.numel() // x.shape[0])
        out = torch.sum(x, dim=0)
        dist.all_reduce(out, group=self._tasks_group)
        return out

    # -- data axis: real collectives over the "data" group ---------------
    _count_data_wire = True

    def _psum_data(self, x):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=self._data_group)
        return out

    def _gather_samples(self, x, axis):
        return _all_gather(x, self._data_group, self.data_shards, axis)

    # ------------------------------------------------------------------
    # this rank's block of the problem and of the state
    # ------------------------------------------------------------------
    def _worker_data(self):
        L, t = self._per_chip, self._t
        data = {k: v.narrow(0, t * L, L)
                for k, v in self.prob.worker_data().items()}
        D = self.data_shards
        if D == 1:
            return data
        n_loc = self.prob.n // D
        for name in SAMPLE_AXIS_LEAVES & set(data):
            data[name] = data[name].narrow(1, self._d * n_loc, n_loc)
        if "gram_A" in data:
            # the Gram cache as a data-group all-reduce of this rank's
            # partial Grams, charged once per solve as setup traffic
            from ..core.worker_ops import shard_gram_stats
            A, b = shard_gram_stats(data["Xs"], data["ys"], self.prob.n)
            for part in (A, b):
                self._charge_data("psum", part.numel(), 1, "gram cache")
                dist.all_reduce(part, group=self._data_group)
            data["gram_A"], data["gram_b"] = A, b
        return data

    def _round_data(self):
        return {k: v.contiguous() for k, v in super()._round_data().items()}

    def _local_state(self, state, sharded):
        def local(leaf):
            return self.local_slice(leaf).contiguous() if leaf.ndim else leaf

        return {k: _tree_map(local, v) if k in sharded else v
                for k, v in state.items()}

    def _global_entry(self, value, shard_it: bool):
        if not shard_it:
            return value

        def gather(leaf):
            if not leaf.ndim:
                return leaf
            return _all_gather(leaf, self._tasks_group, self._T, leaf.ndim - 1)

        return _tree_map(gather, value)
