"""mx.rnn: the symbolic RNN workflow (port of `mxnet_tpu/rnn/`): the
bucketed sentence iterator, the pre-Gluon symbolic cells and the
checkpoint helpers (upstream `python/mxnet/rnn/` io.py, rnn_cell.py,
rnn.py), the data and graph side of `example/rnn/bucketing`.

`BucketSentenceIter` shuffles with Python's `random` and numpy's global
generator, as the reference does, so the same seeds give both packages
the same batch order. Its batches are host (CPU) NDArrays, as every
iterator's of the port: `Module.forward` moves them to the executor.
"""
from __future__ import annotations

import random as _random

import numpy as np

from ..context import cpu
from ..io import DataBatch, DataDesc
from ..ndarray import NDArray


class BucketSentenceIter:
    """Bucketed iterator over variable-length token sentences.

    Each sentence lands in the smallest bucket that fits (longer ones are
    dropped, like the reference); batches are drawn from one bucket at a
    time and padded with `invalid_label`. Labels are the next-token shift.
    """

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT"):
        if layout not in ("NT", "TN"):
            raise ValueError("layout must be 'NT' or 'TN', got %r" % layout)
        self._dtype = np.dtype(dtype)
        self._layout = layout
        if buckets is None:
            lens = np.bincount([len(s) for s in sentences])
            buckets = [i for i, n in enumerate(lens)
                       if n >= batch_size]
        buckets = sorted(buckets)
        self.data = [[] for _ in buckets]
        for s in sentences:
            buck = np.searchsorted(buckets, len(s))
            if buck == len(buckets):
                continue  # longer than the largest bucket: dropped
            # buffers honor the constructor dtype end to end: staging in
            # float32 would silently round int tokens above 2**24 before
            # the final cast in next()
            padded = np.full((buckets[buck],), invalid_label,
                             dtype=self._dtype)
            padded[:len(s)] = s
            self.data[buck].append(padded)
        self.data = [np.asarray(x, dtype=self._dtype) for x in self.data]
        self.buckets = buckets
        self.batch_size = batch_size
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.default_bucket_key = max(buckets)
        self.provide_data = [DataDesc(
            data_name, self._shape(self.default_bucket_key))]
        self.provide_label = [DataDesc(
            label_name, self._shape(self.default_bucket_key))]
        self.reset()

    def _shape(self, T):
        return (T, self.batch_size) if self._layout == "TN" \
            else (self.batch_size, T)

    def reset(self):
        self._plan = []
        for i, d in enumerate(self.data):
            for start in range(0, len(d) - self.batch_size + 1,
                               self.batch_size):
                self._plan.append((i, start))
        _random.shuffle(self._plan)
        self._cursor = 0
        for d in self.data:
            np.random.shuffle(d)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self):
        if self._cursor >= len(self._plan):
            raise StopIteration
        buck, start = self._plan[self._cursor]
        self._cursor += 1
        d = self.data[buck][start:start + self.batch_size]
        label = np.full_like(d, self.invalid_label)
        label[:, :-1] = d[:, 1:]
        if self._layout == "TN":
            d, label = d.T, label.T
        T = self.buckets[buck]
        return DataBatch(
            data=[NDArray(np.ascontiguousarray(d, dtype=self._dtype),
                          ctx=cpu())],
            label=[NDArray(np.ascontiguousarray(label, dtype=self._dtype),
                           ctx=cpu())],
            bucket_key=T,
            provide_data=[DataDesc(self.data_name, self._shape(T))],
            provide_label=[DataDesc(self.label_name, self._shape(T))])


from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell,  # noqa: E402,F401
                       FusedRNNCell, SequentialRNNCell, DropoutCell,
                       ModifierCell, ZoneoutCell, ResidualCell,
                       BidirectionalCell, RNNParams,
                       BaseConvRNNCell, ConvRNNCell, ConvLSTMCell,
                       ConvGRUCell,
                       save_rnn_checkpoint, load_rnn_checkpoint,
                       do_rnn_checkpoint, rnn_unroll)
