"""Factorization machine over sparse features (port of
`mxnet_tpu/models/fm.py`; the reference's example/sparse/
factorization_machine):

score(x) = w.x + b + 0.5 * sum_f [(x V)_f^2 - (x.x)(V.V)_f]

Both forward products and the factor gradient run through the csr and
csr^T segment-sum op (ops/sparse.py), so a CSR batch is never densified,
and the weight and factor gradients are row-sparse over the features the
batch touches, the lazy-update flow of SparseLinear. The logistic loss
and its gradients are torch expressions of the reference's formulas.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ndarray import NDArray
from ..ndarray.sparse import (CSRNDArray, RowSparseNDArray,
                              dot as sparse_dot, touched_rows)
from .. import optimizer as opt


class FactorizationMachine:
    """Binary FM classifier trained with logistic loss."""

    def __init__(self, num_features, num_factors=8, optimizer="sgd",
                 learning_rate=0.1, seed=0):
        rng = np.random.RandomState(seed)
        self.num_features = num_features
        self.num_factors = num_factors
        self.w = NDArray(np.zeros((num_features, 1), dtype=np.float32))
        self.v = NDArray((rng.randn(num_features, num_factors) * 0.05)
                         .astype(np.float32))
        self.b = NDArray(np.zeros((1,), dtype=np.float32))
        self._opt = opt.create(optimizer, learning_rate=learning_rate)
        self._updater = opt.get_updater(self._opt)

    def _squared(self, x):
        """The element-squared csr, same structure."""
        return CSRNDArray(x._values * x._values, x._indices, x._indptr,
                          x.shape, ctx=x.context)

    def forward(self, x):
        s1 = sparse_dot(x, self.v)._data                 # (n, k)
        v = self.v._data
        s2 = sparse_dot(self._squared(x), NDArray(v * v))._data
        pair = 0.5 * torch.sum(s1 * s1 - s2, dim=1)
        lin = sparse_dot(x, self.w)._data[:, 0]
        return lin + pair + self.b._data[0], s1

    def loss_grad(self, x, y):
        """(logistic loss, row-sparse w gradient, row-sparse V gradient,
        b gradient)."""
        score, s1 = self.forward(x)
        yv = (y._data if isinstance(y, NDArray)
              else torch.as_tensor(np.asarray(y))).to(score.device)
        prob = torch.sigmoid(score)
        loss = -torch.mean(yv * torch.log(prob + 1e-12) +
                           (1 - yv) * torch.log(1 - prob + 1e-12))
        g = (prob - yv) / score.new_full((), score.shape[0])  # dL/dscore
        # w grad: x^T g            (features, 1)
        wgrad = sparse_dot(x, NDArray(g[:, None]), transpose_a=True)._data
        # V grad: x^T (g*s1) - V * ((x.x)^T g)
        t1 = sparse_dot(x, NDArray(g[:, None] * s1), transpose_a=True)._data
        t2 = self.v._data * sparse_dot(self._squared(x),
                                       NDArray(g[:, None]),
                                       transpose_a=True)._data
        vgrad = t1 - t2
        bgrad = torch.sum(g)[None]
        touched = touched_rows(x)
        rows = touched.long()
        return (float(loss),
                RowSparseNDArray(touched, wgrad.index_select(0, rows),
                                 wgrad.shape),
                RowSparseNDArray(touched, vgrad.index_select(0, rows),
                                 vgrad.shape),
                NDArray(bgrad))

    def step(self, x, y):
        loss, wg, vg, bg = self.loss_grad(x, y)
        self._updater("w", wg, self.w)
        self._updater("v", vg, self.v)
        self._updater("b", bg, self.b)
        return loss

    def predict(self, x):
        score, _ = self.forward(x)
        return torch.sigmoid(score).cpu().numpy()
