"""Contrib data iterators (port of `mxnet_tpu/contrib/io.py`).

`DataLoaderIter` adapts a gluon `DataLoader` to the symbolic `DataIter`
contract, so Module's `fit` can train on gluon datasets: a short final
batch is zero-padded up to `batch_size` and `pad` counts the padding,
as NDArrayIter's pad does. Batches are host (CPU) NDArrays of `dtype`,
as every iterator's are.
"""
from __future__ import annotations

import numpy as np

from ..context import cpu
from ..io import DataBatch, DataDesc, DataIter
from ..ndarray import NDArray


class DataLoaderIter(DataIter):
    def __init__(self, loader, data_name="data", label_name="softmax_label",
                 dtype="float32"):
        super().__init__()
        self._loader = loader
        self._dtype = np.dtype(dtype)
        # the shapes come from the first batch, which is kept with its
        # iterator: a fresh one would start the loader's workers again
        self._iter = iter(loader)
        data, label = next(self._iter)[:2]
        self._pending = (data, label)
        self.batch_size = int(data.shape[0])
        self.provide_data = [DataDesc(data_name, tuple(data.shape), dtype)]
        self.provide_label = [DataDesc(label_name, tuple(label.shape),
                                       dtype)]

    def reset(self):
        self._iter = iter(self._loader)
        self._pending = None

    def _padded(self, arr):
        """`arr` as `dtype`, zero rows appended up to batch_size."""
        a = np.asarray(arr.asnumpy() if isinstance(arr, NDArray) else arr,
                       dtype=self._dtype)
        short = self.batch_size - a.shape[0]
        if short > 0:
            a = np.concatenate(
                [a, np.zeros((short,) + a.shape[1:], self._dtype)])
        return NDArray(a, ctx=cpu())

    def next(self):
        if self._pending is not None:
            data, label = self._pending
            self._pending = None
        else:
            data, label = next(self._iter)[:2]
        pad = self.batch_size - int(data.shape[0])
        return DataBatch(data=[self._padded(data)],
                         label=[self._padded(label)],
                         pad=pad, index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
