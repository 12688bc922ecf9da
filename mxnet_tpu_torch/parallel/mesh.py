"""The device mesh over a torch.distributed world (port of
`mxnet_tpu/parallel/mesh.py`).

One process is one rank. A `Mesh` names the axes of a grid of ranks
('dp' data, 'tp' tensor, 'pp' pipeline, 'sp' sequence, 'ep' expert), and
each set of axes has one process group: the ranks that share every other
coordinate. Every rank runs the same step on its own shard, the per-rank
counterpart of the reference's single-process GSPMD programs: the caller
passes the global batch on every rank and `shard_batch` takes this rank's
slice, where the reference's `shard_batch` places it.

The world comes up from the launcher's variables (`DMLC_NUM_WORKER`,
`DMLC_WORKER_ID`, `DMLC_PS_ROOT_URI`, `DMLC_PS_ROOT_PORT`, which
`tools/launch.py` sets: rank 0 hosts the rendezvous at that address), from
an explicit `init_world(...)`, or not at all: with no world and no
`DMLC_*` a mesh of one rank runs in-process and every collective is the
identity.

`MXNET_WORLD_TIMEOUT` (seconds, default 600) bounds every collective of
the world and of its groups: a rank whose peer died (a SIGKILLed host)
gets an error from its next collective within that time instead of
gloo's 30 minutes, so a resilient loop's preemption grace timer can end
it (`parallel/resilient.py`).

The backend rule, printed once when the world comes up (never silent):
NCCL when every rank has a card of its own, gloo on the CPU, and gloo on
CUDA tensors when ranks share a card (NCCL refuses two ranks of one
communicator on one device). Each rank's device is
`cuda:(local_rank % device_count)` unless the caller asks for the CPU.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import sys

import numpy as np
import torch

from ..base import MXNetError


class PartitionSpec(tuple):
    """The layout of a tensor over a mesh, one entry a dimension: an axis
    name, a tuple of axis names, or None (not split). The reference's
    `jax.sharding.PartitionSpec`; trailing dimensions not named are not
    split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "P%s" % (tuple.__repr__(self),)

    def axes(self):
        """Every axis name the spec splits over."""
        out = []
        for e in self:
            if e is None:
                continue
            out.extend(e if isinstance(e, tuple) else (e,))
        return tuple(out)


P = PartitionSpec

_CURRENT = contextvars.ContextVar("mxnet_tpu_torch_mesh", default=None)
_WORLD = {"announced": False, "backend": None, "reason": None}


def _env_world():
    """(world size, rank) from the launcher's DMLC_* variables, or None."""
    n = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    if n <= 1 or os.environ.get("DMLC_ROLE", "worker") != "worker":
        return None
    return n, int(os.environ.get("DMLC_WORKER_ID", "0"))


def choose_backend(device_type, world_size, local_world_size=None):
    """(backend, reason) by the port's rule: NCCL when every rank has a
    card of its own, gloo on the CPU and for ranks that share a card."""
    if device_type != "cuda":
        return "gloo", "CPU tensors"
    local = world_size if local_world_size is None else local_world_size
    cards = torch.cuda.device_count()
    if local <= cards:
        return "nccl", "one card a rank (%d ranks here, %d cards)" % (
            local, cards)
    return "gloo", ("ranks share a card (%d ranks here, %d cards): NCCL "
                    "refuses two ranks of one communicator on one device"
                    % (local, cards))


def world_timeout():
    """MXNET_WORLD_TIMEOUT as a timedelta (default 600 s): the longest
    any collective of the world waits for its peers."""
    import datetime
    raw = os.environ.get("MXNET_WORLD_TIMEOUT", "") or "600"
    try:
        secs = float(raw)
    except ValueError:
        raise ValueError("MXNET_WORLD_TIMEOUT must be seconds, got %r"
                         % (raw,))
    if secs <= 0:
        raise ValueError("MXNET_WORLD_TIMEOUT must be > 0, got %r" % (raw,))
    return datetime.timedelta(seconds=secs)


def init_world(init_method=None, rank=None, world_size=None, device=None):
    """Bring up the torch.distributed world once per process and return
    (backend, rank, world size). Arguments left None come from the
    launcher's DMLC_* variables; `device` ("cpu" or "cuda", default the
    card) decides the backend by `choose_backend`. On CUDA the rank's
    card becomes the current device. A world already up is returned as
    it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        return _WORLD["backend"] or dist.get_backend(), dist.get_rank(), \
            dist.get_world_size()
    env = _env_world()
    if world_size is None:
        world_size, rank = env if env is not None else (1, 0)
    if rank is None:
        rank = 0
    if init_method is None:
        uri = os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1")
        port = os.environ.get("DMLC_PS_ROOT_PORT", "9091")
        init_method = "tcp://%s:%s" % (uri, port)
    dev_type = torch.device("cuda" if device is None else device).type
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev_type == "cuda":
        if not torch.cuda.is_available():
            raise MXNetError("init_world on the card, but "
                             "torch.cuda.is_available() is False; pass "
                             "device='cpu' to run the world on the CPU")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    backend, reason = choose_backend(dev_type, world_size, local_world)
    timeout = world_timeout()
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    _WORLD.update(backend=backend, reason=reason, device_type=dev_type,
                  timeout=timeout)
    if not _WORLD["announced"]:
        _WORLD["announced"] = True
        print("mxnet_tpu_torch: rank %d of a world of %d over %s on %s (%s)"
              % (rank, world_size, backend, dev_type, reason),
              file=sys.stderr, flush=True)
    return backend, rank, world_size


def world_info():
    """{"backend", "reason", "rank", "world_size", "device_type"} of the
    world this process is in (a world of one when none came up)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return {"backend": None, "reason": "no world", "rank": 0,
                "world_size": 1, "device_type": None}
    return {"backend": _WORLD["backend"] or dist.get_backend(),
            "reason": _WORLD["reason"], "rank": dist.get_rank(),
            "world_size": dist.get_world_size(),
            "device_type": _WORLD.get("device_type")}


def _world():
    """(rank, world size, whether a process group is up), bringing the
    world up first when the launcher's variables ask for one."""
    import torch.distributed as dist
    if not dist.is_initialized() and _env_world() is not None:
        init_world()
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


class Mesh:
    """A named grid of ranks. `devices` is the rank grid (numpy array of
    global ranks, shape = the axis sizes), `shape` the axis sizes by name
    (an ordered dict, as the reference's `Mesh.shape`), `rank` this
    process's rank and `coords` its coordinate on each axis (None when the
    rank is outside the mesh). `group(axes)` is the process group of this
    rank's row over `axes`; `device` the torch device this rank computes
    on (set by `to(device)`, default the rank's card)."""

    def __init__(self, devices, axis_names, distributed):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self._distributed = distributed
        self.rank = _world()[0]
        where = np.argwhere(self.devices == self.rank)
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self._groups = {}
        self._device = None

    def __repr__(self):
        return "Mesh(%s)" % ", ".join("%s=%d" % kv for kv in
                                      self.shape.items())

    # -- devices ------------------------------------------------------------
    @property
    def device(self):
        if self._device is None:
            from ..base import resolve_device
            self._device = resolve_device(
                "cpu" if _WORLD.get("device_type") == "cpu" else None)
        return self._device

    def to(self, device):
        """Compute on `device` (a torch device or its name); returns the
        mesh."""
        self._device = torch.device(device)
        return self

    # -- axes ---------------------------------------------------------------
    @staticmethod
    def _names(axes):
        if axes is None:
            return ()
        if isinstance(axes, str):
            return (axes,)
        return tuple(axes)

    def axis_size(self, axes):
        """The product of the sizes of `axes` (1 for an axis the mesh
        lacks, as a replicated dimension has one shard)."""
        n = 1
        for a in self._names(axes):
            n *= self.shape.get(a, 1)
        return n

    def axis_index(self, axes):
        """This rank's index along `axes`: its position in the group over
        them, row-major in the mesh's axis order (the order all_gather
        assembles shards in, whatever order `axes` names them in)."""
        if self.coords is None:
            raise MXNetError("rank %d is not in %r" % (self.rank, self))
        names = self._names(axes)
        idx = 0
        for a in self.axis_names:
            if a in names:
                idx = idx * self.shape[a] + self.coords[a]
        return idx

    def group_ranks(self, axes):
        """The global ranks of this rank's group over `axes`, in
        axis_index order."""
        names = self._names(axes)
        if self.coords is None:
            raise MXNetError("rank %d is not in %r" % (self.rank, self))
        index = tuple(slice(None) if a in names else self.coords[a]
                      for a in self.axis_names)
        return [int(r) for r in np.asarray(self.devices[index]).reshape(-1)]

    def group(self, axes):
        """The process group over `axes` holding this rank: None when no
        world is up, or the group has one rank of a larger world (its
        collectives are the identity); a world of one rank is its own
        group, so its collectives run through the backend. Every rank
        of the mesh must ask for a set of axes the first time together:
        the groups of all rows are created at once, as torch.distributed
        needs."""
        import torch.distributed as dist
        names = tuple(a for a in self._names(axes) if a in self.shape)
        if not self._distributed:
            return None
        if self.axis_size(names) == 1:
            return dist.group.WORLD if dist.get_world_size() == 1 else None
        key = tuple(sorted(names))
        if key not in self._groups:
            self._groups[key] = self._make_groups(key)
        return self._groups[key]

    def _make_groups(self, names):
        import torch.distributed as dist
        if set(names) == set(self.axis_names) and \
                self.size == dist.get_world_size():
            return dist.group.WORLD
        others = [a for a in self.axis_names if a not in names]
        mine = None
        for fixed in itertools.product(*[range(self.shape[a])
                                         for a in others]):
            coords = dict(zip(others, fixed))
            index = tuple(slice(None) if a in names else coords[a]
                          for a in self.axis_names)
            ranks = sorted(int(r) for r in
                           np.asarray(self.devices[index]).reshape(-1))
            g = dist.new_group(ranks, timeout=_WORLD.get("timeout"))
            if self.rank in ranks:
                mine = g
        return mine

    # -- shards -------------------------------------------------------------
    def shard_slices(self, shape, spec):
        """The index (tuple of slices) of this rank's shard of a tensor of
        `shape` laid out by `spec`."""
        out = []
        spec = tuple(spec) + (None,) * (len(shape) - len(spec))
        for dim, entry in zip(shape, spec):
            n = self.axis_size(entry)
            if n == 1:
                out.append(slice(None))
                continue
            if dim % n:
                raise MXNetError("dimension %d does not split over %r "
                                 "(%d shards)" % (dim, entry, n))
            i, step = self.axis_index(entry), dim // n
            out.append(slice(i * step, (i + 1) * step))
        return tuple(out)


def current_mesh():
    """The mesh collectives resolve axis names on (set by `use_mesh`)."""
    return _CURRENT.get()


@contextlib.contextmanager
def use_mesh(mesh):
    """Resolve axis names on `mesh` inside the block."""
    token = _CURRENT.set(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.reset(token)


def build_mesh(axes, devices=None):
    """A named mesh, e.g. build_mesh({'dp': 2, 'tp': 2}), over the ranks
    of the world (`devices`, a list of global ranks, defaults to all of
    them). An axis size of -1 takes the remaining ranks, as reshape's -1.
    With no world up and no launcher variables the mesh has one rank."""
    rank, world, up = _world()
    devices = list(range(world)) if devices is None else \
        [int(d) for d in devices]
    names = list(axes.keys())
    sizes = list(axes.values())
    n = len(devices)
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total > n:
        raise MXNetError("mesh %s needs %d devices, have %d"
                         % (axes, total, n))
    grid = np.asarray(devices[:total], dtype=np.int64).reshape(sizes)
    return Mesh(grid, names, up)


def data_parallel_mesh(devices=None):
    return build_mesh({"dp": -1}, devices)


def replica_devices(replica, tp, devices=None):
    """Device window for serving replica `replica` at tensor-parallel
    degree `tp`: the contiguous slice [replica*tp, (replica+1)*tp),
    wrapping modulo the device count (replicas share windows when there
    are fewer than replicas*tp devices); with fewer than tp devices the
    whole short list comes back, as the reference's does. `devices`
    defaults to the world's ranks."""
    devices = list(range(_world()[1])) if devices is None else list(devices)
    n = len(devices)
    if n < tp:
        return list(devices)
    start = (replica * tp) % n
    return [devices[(start + i) % n] for i in range(tp)]


class NamedSharding:
    """A mesh and a spec (the reference's `jax.sharding.NamedSharding`)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = spec

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh, self.spec)


def mesh_sharding(mesh, *spec):
    """NamedSharding shorthand: mesh_sharding(mesh, 'dp', None)."""
    return NamedSharding(mesh, P(*spec))


def _as_tensor(array, device):
    from ..ndarray import NDArray
    if isinstance(array, NDArray):
        array = array._data
    if isinstance(array, torch.Tensor):
        return array.detach().to(device)
    return torch.as_tensor(np.asarray(array), device=device)


def shard(mesh, array, spec):
    """This rank's shard of the global `array` (numpy, tensor or NDArray)
    under `spec`, as a tensor on the mesh's device."""
    t = _as_tensor(array, mesh.device)
    return t[mesh.shard_slices(tuple(t.shape), spec)].contiguous()


def shard_batch(mesh, array, axis_name="dp", batch_dim=0):
    """This rank's slice of the global host batch along the data axis
    (an NDArray in, an NDArray out; otherwise a tensor)."""
    from ..ndarray import NDArray
    spec = [None] * len(array.shape)
    spec[batch_dim] = axis_name
    out = shard(mesh, array, P(*spec))
    if isinstance(array, NDArray):
        return NDArray(out, ctx=array.context)
    return out


def replicate(mesh, array):
    """The global `array` on the mesh's device, whole."""
    return _as_tensor(array, mesh.device)
