"""Sparse linear classifier (port of `mxnet_tpu/models/sparse_linear.py`;
the reference's example/sparse/linear_classification, BASELINE config
5): CSR features times a weight that a row-sparse gradient updates,
through a KVStore's row-sparse push and pull when one is given.

The loss and gradients are torch expressions of the reference's
formulas (softmax cross entropy, dscore = (softmax - one_hot) / n), on
the weight's device. A CSR batch is never densified: the forward is
`_csr_dot_dense` and the weight gradient its transposed form, kept at
the feature rows the batch touches (`touched_rows`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ndarray import NDArray
from ..ndarray.sparse import (CSRNDArray, RowSparseNDArray,
                              dot as sparse_dot, touched_rows)
from .. import ndarray as nd
from .. import kvstore as kvs
from .. import optimizer as opt


class SparseLinear:
    """Logistic-regression-style linear model over sparse features, trained
    with row-sparse gradient push / pull through a KVStore."""

    def __init__(self, num_features, num_classes=2, kvstore=None,
                 optimizer="sgd", learning_rate=0.1):
        self.num_features = num_features
        self.num_classes = num_classes
        self.weight = NDArray(np.zeros((num_features, num_classes),
                                       dtype=np.float32))
        self.bias = NDArray(np.zeros((num_classes,), dtype=np.float32))
        self._kv = kvs.create(kvstore) if isinstance(kvstore, str) \
            else kvstore
        self._opt = opt.create(optimizer, learning_rate=learning_rate)
        self._updater = opt.get_updater(self._opt)
        if self._kv is not None:
            self._kv.init("weight", self.weight)
            self._kv.set_optimizer(self._opt)

    def forward(self, x):
        if isinstance(x, CSRNDArray):
            scores = sparse_dot(x, self.weight)
        else:
            scores = nd.dot(x, self.weight)
        return scores + self.bias

    def loss_grad(self, x, y):
        """(softmax cross-entropy loss, row-sparse weight gradient, bias
        gradient)."""
        scores = self.forward(x)._data
        n = scores.shape[0]
        logp = torch.log_softmax(scores, dim=-1)
        yi = (y._data if isinstance(y, NDArray) else torch.as_tensor(
            np.asarray(y))).to(scores.device).long()
        loss = -torch.mean(torch.gather(logp, 1, yi[:, None]))
        prob = torch.softmax(scores, dim=-1)
        onehot = torch.nn.functional.one_hot(yi, self.num_classes)
        dscore = (prob - onehot.to(prob.dtype)) / scores.new_full((), n)
        if isinstance(x, CSRNDArray):
            # csr^T . dscore by the segment-sum op: x is never densified
            wgrad_dense = sparse_dot(x, NDArray(dscore),
                                     transpose_a=True)._data
            touched = touched_rows(x)
        else:
            xd = x._data.to(scores.device)
            wgrad_dense = xd.t() @ dscore
            touched = torch.nonzero((xd != 0).any(dim=0)).reshape(-1)
        bgrad = torch.sum(dscore, dim=0)
        # only the feature rows present in the batch received gradient
        wgrad = RowSparseNDArray(touched.int(),
                                 wgrad_dense.index_select(0, touched.long()),
                                 wgrad_dense.shape)
        return float(loss), wgrad, NDArray(bgrad)

    def step(self, x, y):
        loss, wgrad, bgrad = self.loss_grad(x, y)
        if self._kv is not None:
            self._kv.push("weight", wgrad)
            self._kv.pull("weight", out=self.weight)
        else:
            self._updater("weight", wgrad, self.weight)
        self._updater("bias", bgrad, self.bias)
        return loss

    def row_sparse_pull(self, row_ids):
        """Only the rows a batch needs (row_sparse_pull)."""
        out = RowSparseNDArray.from_dense(self.weight)
        if self._kv is None:
            return out.retain(row_ids)
        self._kv.row_sparse_pull("weight", out=out, row_ids=row_ids)
        return out
