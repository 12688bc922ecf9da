"""KVStore (port of `mxnet_tpu/kvstore.py`).

`push` sums a value (or a list of per-device values) into the stored one,
or, after `set_optimizer`, hands the sum to the optimizer's updater,
which updates the stored weight; `pull` copies the stored value out.

- 'local' / 'device' (and the local_* aliases): one process, nothing
  crosses processes. This is the path `Module.init_optimizer`'s default
  `kvstore="local"` takes.
- 'tpu' / 'nccl' and 'dist_sync' / 'dist_device_sync' / 'dist_async' /
  'dist': every push is summed over the torch.distributed world, which
  `parallel.init_world` brings up, or the store itself from the
  launcher's DMLC_* variables (tools/launch.py): NCCL when each rank has
  a card of its own, gloo otherwise (the mesh's backend rule; a worker
  on the CPU calls `init_world(device="cpu")` first). With no world and
  no launcher variables the store has one worker and sums nothing
  across processes, as the reference's. `init` takes rank 0's value, as the first
  worker to init a key on a parameter server defines it. 'dist_async'
  keeps the reference's documented divergence: a synchronous collective
  cannot reproduce a parameter server's unsynchronized clocks, so it
  runs as 'dist_sync' does. Arrays past MXNET_KVSTORE_BIGARRAY_BOUND
  elements (default 1000000) are summed in chunks of that many, as the
  reference bounds each message. The server-side optimizer
  (`set_optimizer`) is applied by every worker to the identical global
  sum, which reproduces the server's one update on every rank.

2-bit gradient compression (`set_gradient_compression({"type": "2bit",
"threshold": t})`) quantizes each pushed value with error feedback before
the sum (the reference's _TwoBitCompressor); row-sparse values are sent
as they are.

Row-sparse values (`ndarray.sparse.RowSparseNDArray`): a list of them
pushed at once is summed without densifying (`merge_rowsparse`); without
an optimizer a row-sparse push merges into the stored value, with one
the optimizer updates the stored weight lazily over the pushed rows.
`row_sparse_pull` gathers only the asked rows of the stored value. The
world stores sum a row-sparse push over the ranks by gathering every
rank's (ids, rows), padded to the largest count, and summing duplicate
ids in rank order (no float atomics, the same bits on every rank and
run); rows whose sum is zero drop out, as the reference's densify and
compact drops them. `init` broadcasts rank 0's row-sparse value, its row
count first.
"""
from __future__ import annotations

import os
import pickle

from .base import MXNetError
from .ndarray import NDArray
from .ndarray.sparse import RowSparseNDArray, merge_rowsparse
from . import optimizer as opt

_LOCAL_TYPES = ("local", "local_update_cpu", "local_allreduce_cpu",
                "local_allreduce_device", "device")
_WORLD_TYPES = ("tpu", "nccl", "dist_sync", "dist_async", "dist_device_sync",
                "dist")


class _TwoBitCompressor:
    """2-bit quantization (`parallel.collectives.quantize_2bit`) with
    error feedback: the error is added to the next value pushed under the
    same key."""

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self.residual = {}

    def compress(self, key, grad):
        from .parallel.collectives import quantize_2bit
        r = self.residual.get(key)
        g = grad if r is None else grad + r
        q = quantize_2bit(g, self.threshold)
        self.residual[key] = g - q
        return q


class KVStore:
    """The single-process store ('local' / 'device') and the base of the
    distributed ones."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._store = {}
        self._updater = None
        self._optimizer = None
        self._compressor = None

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    @staticmethod
    def _key_list(key, value):
        if isinstance(key, (list, tuple)):
            return list(key), list(value)
        return [key], [value]

    @staticmethod
    def _aggregate(vlist):
        """The sum of a per-device list of values (row-sparse ones merged,
        never densified)."""
        if not isinstance(vlist, (list, tuple)):
            return vlist
        if isinstance(vlist[0], RowSparseNDArray):
            return vlist[0] if len(vlist) == 1 else merge_rowsparse(vlist)
        out = vlist[0]._data
        for v in vlist[1:]:
            out = out + v._data.to(out.device)
        return NDArray(out, ctx=vlist[0].context)

    def _reduce_global(self, value):
        """The sum of `value` over the store's workers (here: itself)."""
        return value

    def init(self, key, value):
        for k, v in zip(*self._key_list(key, value)):
            if k in self._store:
                continue
            if isinstance(v, RowSparseNDArray):
                self._store[k] = v
            else:
                self._store[k] = NDArray(v._data.detach().clone(),
                                         ctx=v.context)

    def push(self, key, value, priority=0):
        for k, v in zip(*self._key_list(key, value)):
            agg = self._aggregate(v)
            sparse = isinstance(agg, RowSparseNDArray)
            if self._compressor is not None and not sparse:
                agg = NDArray(self._compressor.compress(k, agg._data),
                              ctx=agg.context)
            agg = self._reduce_global(agg)
            stored = self._store[k]
            if self._updater is not None:
                self._updater(k, agg, stored)
            elif isinstance(stored, RowSparseNDArray) and sparse:
                self._store[k] = merge_rowsparse([stored, agg])
            elif isinstance(stored, RowSparseNDArray) or sparse:
                dense = stored.todense()._data \
                    if isinstance(stored, RowSparseNDArray) else stored._data
                add = agg.todense()._data if sparse else agg._data
                self._store[k] = RowSparseNDArray.from_dense(
                    NDArray(dense + add.to(dense.device)))
            else:
                stored._data = stored._data + agg._data.to(
                    stored._data.device)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        for k, o in zip(*self._key_list(key, out)):
            stored = self._store[k]
            src = stored.todense()._data \
                if isinstance(stored, RowSparseNDArray) else stored._data
            for oo in (o if isinstance(o, (list, tuple)) else [o]):
                oo._data = src.to(oo._data.device)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Only the rows `row_ids` of the stored value: into `out` (a
        RowSparseNDArray takes the rows, a dense NDArray the densified
        result), else returned."""
        if row_ids is None:
            raise MXNetError("row_sparse_pull requires row_ids")
        if out is None and isinstance(key, (list, tuple)):
            keys, outs = list(key), [None] * len(key)
        else:
            keys, outs = self._key_list(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        results = []
        for k, o, rid in zip(keys, outs, row_ids):
            stored = self._store[k]
            rsp = stored if isinstance(stored, RowSparseNDArray) else \
                RowSparseNDArray.from_dense(stored)
            if o is None:
                results.append(rsp.retain(rid))
                continue
            olist = o if isinstance(o, (list, tuple)) else [o]
            rids = rid if isinstance(rid, (list, tuple)) \
                else [rid] * len(olist)
            for oo, rr in zip(olist, rids):
                ret = rsp.retain(rr)
                if isinstance(oo, RowSparseNDArray):
                    dev = oo._values.device
                    oo._indices = ret._indices.to(dev)
                    oo._values = ret._values.to(dev)
                else:
                    oo._data = ret.todense()._data.to(oo._data.device)
            results.append(o)
        if out is None:
            return results if isinstance(key, (list, tuple)) \
                else results[0]

    def set_optimizer(self, optimizer):
        """Run the optimizer inside the store. The optimizer is copied
        through pickle, as the reference sends it to its servers."""
        self._optimizer = pickle.loads(pickle.dumps(optimizer))
        self._updater = opt.get_updater(self._optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        ctype = compression_params.get("type", "2bit")
        if ctype != "2bit":
            raise MXNetError("unsupported compression type %s" % ctype)
        self._compressor = _TwoBitCompressor(
            compression_params.get("threshold", 0.5))

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("there is no optimizer attached")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        """Read states `save_optimizer_states` wrote (a pickle: load only
        files this program wrote)."""
        if self._updater is None:
            raise MXNetError("there is no optimizer attached")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        pass


def _bigarray_bound():
    """Elements above which a cross-process sum runs in chunks
    (MXNET_KVSTORE_BIGARRAY_BOUND, as the reference)."""
    return int(os.environ.get("MXNET_KVSTORE_BIGARRAY_BOUND", 1000000))


def _multihost_psum(tensors):
    """Each tensor summed over the torch.distributed world (the
    reference's `_multihost_psum`): the tensors of one dtype in one
    allreduce, in pieces of at most MXNET_KVSTORE_BIGARRAY_BOUND elements,
    as the reference bounds each message. With no world up, the tensors
    as they are."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return list(tensors)
    from .parallel.collectives import _Axis, all_reduce_flat
    from .parallel.mesh import build_mesh
    world = _Axis(build_mesh({"world": -1}), "world")
    return all_reduce_flat(tensors, world, _bigarray_bound())


def _multihost_rsp_sum(rsp, ax):
    """The sum of a row-sparse value over the group `ax`: every rank's
    (ids, rows), padded to the largest count (one gather of the counts
    first), gathered; the pads dropped; duplicate ids summed in rank
    order; rows whose sum is zero dropped."""
    import torch
    from .parallel.collectives import all_gather_raw
    idx, vals = rsp._indices, rsp._values
    cols = tuple(vals.shape[1:])
    counts = all_gather_raw(idx.new_full((1,), idx.shape[0]), ax)
    kmax = int(counts.max())
    pad = kmax - idx.shape[0]
    idx_p = torch.cat([idx, idx.new_full((pad,), -1)])
    vals_p = torch.cat([vals, vals.new_zeros((pad,) + cols)])
    gi = all_gather_raw(idx_p, ax)
    gv = all_gather_raw(vals_p, ax).reshape((-1,) + cols)
    keep = gi >= 0
    merged = merge_rowsparse([RowSparseNDArray(gi[keep], gv[keep],
                                               rsp.shape, ctx=rsp.context)])
    nz = (merged._values.reshape(merged._values.shape[0], -1) != 0) \
        .any(dim=1)
    return RowSparseNDArray(merged._indices[nz], merged._values[nz],
                            rsp.shape, ctx=rsp.context)


class KVStoreWorld(KVStore):
    """'tpu' / 'nccl' and the dist_* types: every push summed over the
    torch.distributed world."""

    def __init__(self, kv_type):
        from .parallel import mesh as _mesh
        _mesh._world()  # the launcher's world, when its variables ask
        super().__init__(kv_type)
        self._mesh = _mesh.build_mesh({"world": -1})

    @property
    def rank(self):
        return self._mesh.rank

    @property
    def num_workers(self):
        return self._mesh.size

    def _axis(self):
        from .parallel.collectives import _Axis
        return _Axis(self._mesh, "world")

    def _up(self):
        import torch.distributed as dist
        return dist.is_initialized()

    def init(self, key, value):
        """Rank 0's value wins (a row-sparse one: its row count, then its
        ids and rows)."""
        keys, values = self._key_list(key, value)
        if self._up():
            from .parallel.collectives import broadcast_raw
            ax = self._axis()
            values = [self._broadcast_rsp(v, ax)
                      if isinstance(v, RowSparseNDArray)
                      else NDArray(broadcast_raw(v._data, ax), ctx=v.context)
                      for v in values]
        super().init(keys, values)

    @staticmethod
    def _broadcast_rsp(v, ax):
        from .parallel.collectives import broadcast_raw
        idx, vals = v._indices, v._values
        n0 = int(broadcast_raw(idx.new_full((1,), idx.shape[0]), ax)[0])
        if ax.index != 0:
            idx = idx.new_zeros((n0,))
            vals = vals.new_zeros((n0,) + tuple(vals.shape[1:]))
        return RowSparseNDArray(broadcast_raw(idx, ax),
                                broadcast_raw(vals, ax), v.shape,
                                ctx=v.context)

    def _reduce_global(self, value):
        if isinstance(value, RowSparseNDArray):
            if not self._up() or self.num_workers <= 1:
                return value
            return _multihost_rsp_sum(value, self._axis())
        return NDArray(_multihost_psum([value._data])[0], ctx=value.context)

    def barrier(self):
        if self._up():
            import torch.distributed as dist
            dist.barrier()


def create(name="local"):
    """A store by type name: 'local', 'device' and their aliases, 'tpu' /
    'nccl', and the dist_* types."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in _LOCAL_TYPES:
        return KVStore(name)
    if name in _WORLD_TYPES:
        return KVStoreWorld(name)
    raise MXNetError("unknown KVStore type %s" % name)
