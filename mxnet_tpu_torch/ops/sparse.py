"""Sparse storage ops (port of `mxnet_tpu/ops/sparse.py`).

A row_sparse array is an (indices[nnz], values[nnz, cols...]) pair and a
CSR matrix an (indptr, indices, values) triple of dense tensors; the
user-facing classes are in `mxnet_tpu_torch.ndarray.sparse`. The
reference lowers these ops to XLA gathers, scatters and segment sums, so
the port runs them as PyTorch gathers (`index_select`), row scatters
(`index_add`) and segment reductions (`torch.segment_reduce`) on the
arrays' device. No op reads a value back to the host.

`_csr_dot_dense` sums each output row over its own contiguous run of
stored values, so neither form needs float atomics: the plain form
reduces the runs `indptr` delimits, and the transposed form first sorts
the stored values by column (a stable sort, so equal columns keep their
row order, the order the reference's scatter-add visits them) and
reduces those runs. Both give the same bits run after run on a card.
"""
from __future__ import annotations

import torch

from .registry import register


def _segment_sum(data, lengths):
    """Sums of the consecutive runs of `data` (along dim 0) that
    `lengths` (int64) counts; an empty run sums to 0. `unsafe` skips the
    lengths' check, which would read them back to the host."""
    return torch.segment_reduce(data, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _csr_rows(indptr, nnz):
    """The row of each of the `nnz` stored values (the reference's
    searchsorted over indptr)."""
    pos = torch.arange(nnz, dtype=indptr.dtype, device=indptr.device)
    return torch.searchsorted(indptr, pos, right=True) - 1


@register("_rsp_to_dense")
def rsp_to_dense(indices, values, num_rows=0):
    shape = (int(num_rows),) + tuple(values.shape[1:])
    out = torch.zeros(shape, dtype=values.dtype, device=values.device)
    return out.index_add(0, indices.long(), values)


@register("_dense_to_rsp", num_outputs=2, differentiable=False)
def dense_to_rsp(dense):
    """Full-row storage: every row kept, zero rows as zero rows (the
    compacted form is RowSparseNDArray.from_dense)."""
    idx = torch.arange(dense.shape[0], dtype=torch.int32,
                       device=dense.device)
    return idx, dense


@register("_csr_to_dense")
def csr_to_dense(indptr, indices, values, num_rows=0, num_cols=0):
    rows = _csr_rows(indptr.int(), values.shape[0]).long()
    out = torch.zeros((int(num_rows), int(num_cols)), dtype=values.dtype,
                      device=values.device)
    return out.index_put((rows, indices.long()), values, accumulate=True)


@register("sparse_retain", num_outputs=2, aliases=("_sparse_retain",))
def sparse_retain(indices, values, new_idx):
    """The rows listed in new_idx (the sparse_retain op); a row of
    `new_idx` absent from `indices` is a zero row."""
    want = new_idx.long()
    tail = (values.dim() - 1) * (1,)
    if indices.shape[0] == 0:
        return new_idx, values.new_zeros((want.shape[0],)
                                         + tuple(values.shape[1:]))
    have = indices.long()
    pos = torch.searchsorted(have, want).clamp(0, have.shape[0] - 1)
    found = (have[pos] == want).reshape((-1,) + tail)
    vals = torch.where(found, values[pos], values.new_zeros(()))
    return new_idx, vals


@register("_csr_dot_dense")
def csr_dot_dense(indptr, indices, values, rhs, num_rows=0, num_cols=0,
                  transpose_lhs=False):
    """dot(csr, dense), or dot(csr^T, dense) with transpose_lhs (the
    gradient of a sparse linear model), by segment sums over the stored
    values; a 1-D rhs gives a matrix-vector product."""
    nnz = values.shape[0]
    cols = indices.long()
    matvec = rhs.dim() == 1
    if matvec:
        rhs = rhs[:, None]
    if transpose_lhs:
        if int(num_cols) <= 0:
            raise ValueError(
                "csr_dot_dense(transpose_lhs=True) needs num_cols (the "
                "csr's column count) to size the output")
        # out[c, :] = sum over the stored values of column c of
        # v * rhs[row, :], in row order
        rows = _csr_rows(indptr.int(), nnz).long()
        order = torch.sort(cols, stable=True).indices
        contrib = values[order, None] * rhs.index_select(0, rows[order])
        # per-column counts by an integer scatter (bincount would read
        # the largest column back to size its output)
        lengths = torch.zeros(int(num_cols), dtype=torch.long,
                              device=cols.device)
        lengths.index_add_(0, cols, torch.ones_like(cols))
        out = _segment_sum(contrib, lengths)
    else:
        # out[r, :] = sum over the stored values of row r of
        # v * rhs[col, :]
        contrib = values[:, None] * rhs.index_select(0, cols)
        out = _segment_sum(contrib, (indptr[1:] - indptr[:-1]).long())
    if matvec:
        out = out[:, 0]
    return out.to(rhs.dtype)


@register("_rsp_dot_dense")
def rsp_dot_dense(indices, values, rhs):
    return values @ rhs  # the caller scatters the rows back
