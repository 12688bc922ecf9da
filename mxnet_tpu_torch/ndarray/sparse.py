"""Sparse NDArrays: row_sparse and CSR (port of
`mxnet_tpu/ndarray/sparse.py`).

A RowSparseNDArray is (indices[nnz], values[nnz, cols...]) with its row
ids sorted ascending and unique; a CSRNDArray is (data, indices, indptr).
Each component is a dense tensor on the array's context, the row and
column ids int32 as the reference casts them. The sparse math is the ops
of `mxnet_tpu_torch/ops/sparse.py` (gathers, row scatters, segment sums).

The reference finds rows on the host (numpy): `from_dense`,
`touched_rows` and `merge_rowsparse`'s `np.unique`. The port finds them
on the array's device (`torch.nonzero`, `torch.unique(sorted=True)`),
the same ascending int32 ids: each such call waits for the device once
to learn how many rows there are, and no value array leaves the device.
`merge_rowsparse` sums duplicate rows by a stable sort and segment sums,
without float atomics, so it gives the same bits every run.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import numpy_dtype, torch_dtype
from ..context import Context, context_of, current_context
from ..ops import registry as _registry
from .ndarray import NDArray, _as_tensor


def _place(ctx, *tensors):
    """(ctx, device): the given context, else the first tensor's, else
    the current one."""
    if ctx is None:
        first = next((t for t in tensors if isinstance(t, torch.Tensor)),
                     None)
        ctx = context_of(first.device) if first is not None \
            else current_context()
    return ctx, ctx.torch_device()


def _ids(x, device):
    """int32 row or column ids on `device`."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x).astype(np.int32), device=device)


def _values(x, device, dtype=None):
    """A tensor of `x` (NDArray, tensor or array-like) on `device`, 64-bit
    dtypes narrowed."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return _as_tensor(x.detach(), None, dtype).to(device)
    return _as_tensor(x, context_of(device), dtype)


class BaseSparseNDArray:
    def __init__(self, shape, ctx):
        self._shape = tuple(int(s) for s in shape)
        self._ctx = ctx

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return numpy_dtype(self._values.dtype)

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def ndim(self):
        return len(self._shape)

    def asnumpy(self):
        return self.todense().asnumpy()

    def wait_to_read(self):
        if self._values.device.type == "cuda":
            torch.cuda.synchronize(self._values.device)
        return self

    def __repr__(self):
        return "\n%s\n<%s %s @%s>" % (
            self.asnumpy(), type(self).__name__,
            "x".join(str(s) for s in self._shape), self._ctx)


class RowSparseNDArray(BaseSparseNDArray):
    """(indices[nnz], values[nnz, cols...]); indices sorted ascending."""

    stype = "row_sparse"

    def __init__(self, indices, values, shape, ctx=None):
        ctx, dev = _place(ctx, values, indices)
        super().__init__(shape, ctx)
        self._indices = _ids(indices, dev)
        self._values = _values(values, dev)

    @property
    def indices(self):
        return NDArray(self._indices, ctx=self._ctx)

    @property
    def data(self):
        return NDArray(self._values, ctx=self._ctx)

    @classmethod
    def from_dense(cls, arr):
        """The nonzero rows of a dense array (an NDArray keeps its
        context)."""
        ctx = arr.context if isinstance(arr, NDArray) else None
        data = arr._data.detach() if isinstance(arr, NDArray) \
            else _as_tensor(arr, None, None)
        nz = (data.reshape(data.shape[0], -1) != 0).any(dim=1)
        idx = torch.nonzero(nz).reshape(-1)
        return cls(idx.int(), data.index_select(0, idx), data.shape,
                   ctx=ctx)

    def todense(self):
        dense = _registry.get("_rsp_to_dense").fn(
            self._indices, self._values, num_rows=self._shape[0])
        return NDArray(dense, ctx=self._ctx)

    def tostype(self, stype):
        if stype == "row_sparse":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError("cannot cast row_sparse to %s" % stype)

    def retain(self, indices):
        new_idx, vals = _registry.get("sparse_retain").fn(
            self._indices, self._values,
            _values(indices, self._values.device))
        return RowSparseNDArray(new_idx, vals, self._shape, ctx=self._ctx)

    def copyto(self, other):
        if isinstance(other, RowSparseNDArray):
            other._indices = self._indices.to(other._indices.device)
            other._values = self._values.to(other._values.device)
            return other
        if isinstance(other, NDArray):
            return self.todense().copyto(other)
        if isinstance(other, Context):
            return RowSparseNDArray(self._indices, self._values,
                                    self._shape, ctx=other)
        raise TypeError(type(other))

    def __add__(self, other):
        if isinstance(other, RowSparseNDArray):
            return merge_rowsparse([self, other])
        return self.todense() + other


class CSRNDArray(BaseSparseNDArray):
    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        ctx, dev = _place(ctx, data, indices, indptr)
        super().__init__(shape, ctx)
        self._values = _values(data, dev)
        self._indices = _ids(indices, dev)
        self._indptr = _ids(indptr, dev)

    @property
    def data(self):
        return NDArray(self._values, ctx=self._ctx)

    @property
    def indices(self):
        return NDArray(self._indices, ctx=self._ctx)

    @property
    def indptr(self):
        return NDArray(self._indptr, ctx=self._ctx)

    @classmethod
    def from_dense(cls, arr):
        """The nonzero entries of a 2-D dense array, row by row, columns
        ascending (an NDArray keeps its context)."""
        ctx = arr.context if isinstance(arr, NDArray) else None
        data = arr._data.detach() if isinstance(arr, NDArray) \
            else _as_tensor(arr, None, None)
        mask = data != 0
        counts = mask.sum(dim=1)
        indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        rc = torch.nonzero(mask)
        return cls(data[rc[:, 0], rc[:, 1]], rc[:, 1].int(), indptr.int(),
                   data.shape, ctx=ctx)

    def todense(self):
        dense = _registry.get("_csr_to_dense").fn(
            self._indptr, self._indices, self._values,
            num_rows=self._shape[0], num_cols=self._shape[1])
        return NDArray(dense, ctx=self._ctx)

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise ValueError("cannot cast csr to %s" % stype)

    def __getitem__(self, key):
        """A row slice (the step is ignored, as the reference's): its
        rows' entries, read off indptr (one read of two ids)."""
        if isinstance(key, slice):
            start, stop, _ = key.indices(self._shape[0])
            stop = max(stop, start)
            lo, hi = (int(v) for v in
                      self._indptr[[start, stop]].cpu().tolist())
            return CSRNDArray(self._values[lo:hi], self._indices[lo:hi],
                              self._indptr[start:stop + 1] - lo,
                              (stop - start, self._shape[1]), ctx=self._ctx)
        raise NotImplementedError("csr indexing supports row slices")

    def asscipy(self):
        """This matrix as a scipy.sparse.csr_matrix (a host copy)."""
        import scipy.sparse as sps
        return sps.csr_matrix(
            (self._values.cpu().numpy(), self._indices.cpu().numpy(),
             self._indptr.cpu().numpy()), shape=self._shape)

    def copyto(self, other):
        """A Context gets a new csr there; a dense NDArray receives the
        densified values; a CSRNDArray takes this matrix's buffers."""
        if isinstance(other, CSRNDArray):
            other._values = self._values
            other._indices = self._indices
            other._indptr = self._indptr
            other._shape = self._shape
            return other
        if isinstance(other, NDArray):
            return self.todense().copyto(other)
        if isinstance(other, Context):
            return CSRNDArray(self._values, self._indices, self._indptr,
                              self._shape, ctx=other)
        raise TypeError(type(other))


# -- constructors (mx.nd.sparse.row_sparse_array / csr_matrix) --------------


def _np_dtype(dtype):
    """The numpy dtype of a user dtype spec; None is float32."""
    return numpy_dtype(torch_dtype(dtype))


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    if isinstance(arg1, (tuple, list)) and len(arg1) == 2 and \
            not np.isscalar(arg1[0]):
        values, indices = arg1
        ctx, _ = _place(ctx)
        return RowSparseNDArray(np.asarray(indices, dtype=np.int32),
                                np.asarray(values, dtype=_np_dtype(dtype)),
                                shape, ctx=ctx)
    if isinstance(arg1, RowSparseNDArray):
        return arg1
    if isinstance(arg1, NDArray):
        return RowSparseNDArray.from_dense(arg1)
    return RowSparseNDArray.from_dense(
        NDArray(np.asarray(arg1, dtype=_np_dtype(dtype)), ctx=ctx))


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    if isinstance(arg1, (tuple, list)) and len(arg1) == 3:
        data, indices, indptr = arg1
        ctx, _ = _place(ctx)
        return CSRNDArray(np.asarray(data, dtype=_np_dtype(dtype)),
                          np.asarray(indices, dtype=np.int32),
                          np.asarray(indptr, dtype=np.int32), shape, ctx=ctx)
    if isinstance(arg1, CSRNDArray):
        return arg1
    if isinstance(arg1, NDArray):
        return CSRNDArray.from_dense(arg1)
    return CSRNDArray.from_dense(
        NDArray(np.asarray(arg1, dtype=_np_dtype(dtype)), ctx=ctx))


def zeros(stype, shape, ctx=None, dtype=None):
    ctx, dev = _place(ctx)
    dt = torch_dtype(dtype)
    if stype == "row_sparse":
        cols = tuple(shape[1:]) if len(shape) > 1 else ()
        return RowSparseNDArray(torch.zeros((0,), dtype=torch.int32,
                                            device=dev),
                                torch.zeros((0,) + cols, dtype=dt,
                                            device=dev), shape, ctx=ctx)
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int32, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int32,
                                      device=dev), shape, ctx=ctx)
    raise ValueError(stype)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """dot with a CSR left operand (its plain and transposed forms), or
    the dense dot."""
    if isinstance(lhs, CSRNDArray) and isinstance(rhs, NDArray):
        if transpose_b:
            raise NotImplementedError(
                "dot(csr, dense, transpose_b=True) is not supported; "
                "transpose the dense operand first")
        out = _registry.get("_csr_dot_dense").fn(
            lhs._indptr, lhs._indices, lhs._values, rhs._data,
            num_rows=lhs.shape[0], num_cols=lhs.shape[1],
            transpose_lhs=transpose_a)
        return NDArray(out, ctx=rhs.context)
    if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
        from . import dot as _dense_dot
        return _dense_dot(lhs, rhs, transpose_a=transpose_a,
                          transpose_b=transpose_b)
    raise TypeError("unsupported sparse dot: %s x %s" % (type(lhs),
                                                         type(rhs)))


def touched_rows(csr):
    """The feature columns that carry gradient in a csr batch: the
    sorted unique column ids of its NONZERO stored values (an explicit
    stored zero carries none, so the csr and dense paths train alike),
    int32 on the batch's device."""
    cols = csr._indices[csr._values != 0]
    return torch.unique(cols, sorted=True).int()


def merge_rowsparse(vlist):
    """The sum of row-sparse arrays, never densified: their rows
    concatenated, stably sorted by id, and each run of one id summed
    (in list order). The ids come back sorted ascending and unique, the
    invariant the lazy optimizers rely on."""
    dev = vlist[0]._values.device
    idx = torch.cat([v._indices.to(dev) for v in vlist]).long()
    vals = torch.cat([v._values.to(dev) for v in vlist], dim=0)
    order = torch.sort(idx, stable=True).indices
    uniq, counts = torch.unique_consecutive(idx[order], return_counts=True)
    summed = torch.segment_reduce(vals[order], "sum", lengths=counts,
                                  axis=0, unsafe=True)
    return RowSparseNDArray(uniq.int(), summed, vlist[0].shape,
                            ctx=vlist[0].context)


def array(source_array, ctx=None, dtype=None):
    """A sparse ndarray from a sparse source: another sparse ndarray (same
    stype) or a scipy.sparse matrix (as csr). Dense sources belong to
    nd.array / .tostype()."""
    def vals(values):
        # dtype None keeps the source's dtype (the reference's rule)
        return values if dtype is None else values.to(torch_dtype(dtype))

    if isinstance(source_array, RowSparseNDArray):
        return RowSparseNDArray(source_array._indices,
                                vals(source_array._values),
                                source_array.shape, ctx=ctx)
    if isinstance(source_array, CSRNDArray):
        return CSRNDArray(vals(source_array._values), source_array._indices,
                          source_array._indptr, source_array.shape, ctx=ctx)
    try:
        import scipy.sparse as sps
    except ImportError:
        sps = None
    if sps is not None and sps.issparse(source_array):
        m = source_array.tocsr()
        ctx, _ = _place(ctx)
        return CSRNDArray(vals(torch.from_numpy(np.array(m.data))),
                          m.indices.astype(np.int32),
                          m.indptr.astype(np.int32), m.shape, ctx=ctx)
    raise TypeError(
        "sparse.array expects a sparse ndarray or scipy.sparse matrix; "
        "for dense sources use mx.nd.array(...).tostype('csr'/"
        "'row_sparse')")


def empty(stype, shape, ctx=None, dtype=None):
    """An uninitialized sparse ndarray is an all-zero one."""
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def _densify_binary(lhs, rhs, op):
    """Elementwise arithmetic on mixed sparse / dense operands through
    their dense forms (the reference's fallback for these ops)."""
    ld = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    rd = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return op(ld, rd)


def add(lhs, rhs):
    return lhs + rhs


def elemwise_add(lhs, rhs):
    return lhs + rhs


def _map_values(sp, fn):
    """A structure-preserving elementwise op on the stored values."""
    if isinstance(sp, RowSparseNDArray):
        return RowSparseNDArray(sp._indices, fn(sp._values), sp.shape,
                                ctx=sp.context)
    return CSRNDArray(fn(sp._values), sp._indices, sp._indptr, sp.shape,
                      ctx=sp.context)


def subtract(lhs, rhs):
    return _densify_binary(lhs, rhs, lambda a, b: a - b)


def multiply(lhs, rhs):
    if isinstance(lhs, BaseSparseNDArray) and np.isscalar(rhs):
        return _map_values(lhs, lambda v: v * rhs)
    return _densify_binary(lhs, rhs, lambda a, b: a * b)


def divide(lhs, rhs):
    if isinstance(lhs, BaseSparseNDArray) and np.isscalar(rhs):
        # true division of the stored values (a 0-dim divisor keeps it
        # true on CUDA too); rhs 0 gives inf / nan as the dense path does
        return _map_values(lhs, lambda v: v / v.new_full((), rhs))
    return _densify_binary(lhs, rhs, lambda a, b: a / b)


def retain(data, indices):
    return data.retain(indices)
