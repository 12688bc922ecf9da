"""Data iterators (port of `mxnet_tpu/io.py`): DataDesc, DataBatch,
DataIter, NDArrayIter, ResizeIter, PrefetchingIter, MNISTIter, CSVIter
and DevicePrefetchIter.

Iterators yield batches in host memory (CPU NDArrays): the consumer
moves them to its device, as `Module.forward` does when it feeds the
executor's arrays, unless it wraps the iterator in `DevicePrefetchIter`,
which stages the next batches on the card while the current step runs.
`NDArrayIter` shuffles with numpy's global generator, as the reference
does, so one `np.random.seed` gives both packages the same order. A CSR
data source (a `CSRNDArray`) is kept as a host scipy CSR matrix and each batch densifies only its own rows, as the
reference's `_take` does. `LibSVMIter` reads a LibSVM text file into
such a source (its `num_parts` / `part_index` take every num_parts-th
line). Not ported yet: the image record iterators (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import collections
import gzip
import os
import struct
import threading

import numpy as np
import torch

from .context import cpu
from .ndarray import NDArray
from .ndarray.sparse import CSRNDArray


def _host(arr):
    """A CPU NDArray of a numpy array."""
    return NDArray(arr, ctx=cpu())


class DataDesc(collections.namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        return 0 if layout is None else layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(name, shape, type_dict[name])
                    for name, shape in shapes]
        return [DataDesc(name, shape) for name, shape in shapes]


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None:
            assert isinstance(data, (list, tuple)), \
                "DataBatch.data takes a list/tuple of arrays"
        if label is not None:
            assert isinstance(label, (list, tuple)), \
                "DataBatch.label takes a list/tuple of arrays"
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        label_shapes = [l.shape for l in self.label] if self.label else None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, [d.shape for d in self.data],
            label_shapes)


class DataIter:
    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class NDArrayIter(DataIter):
    """Batches of arrays (numpy, NDArray, a list or a {name: array} dict),
    with shuffle and last_batch_handle "pad" (the last batch wraps to the
    start, `pad` counting the wrapped rows), "discard" or "roll_over" (the
    tail leads the next epoch's first batch)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        if (_has_sparse(self.data) or _has_sparse(self.label)) and \
                last_batch_handle != "discard":
            raise NotImplementedError(
                "sparse (CSR) inputs cannot be padded or rolled over; "
                "construct NDArrayIter with last_batch_handle='discard'")
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.batch_size = batch_size
        if last_batch_handle == "roll_over" and \
                batch_size > self.idx.shape[0]:
            raise ValueError(
                "roll_over needs batch_size (%d) <= num_data (%d)"
                % (batch_size, self.idx.shape[0]))
        self.cursor = -batch_size
        self.num_data = self.idx.shape[0]
        self._cache_data = None
        self._cache_label = None

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        self.cursor = -self.batch_size
        self._cache_data = None
        self._cache_label = None

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                0 <= self.cursor < self.num_data and \
                self.num_data - self.cursor < self.batch_size:
            # the tail not yet emitted leads the next epoch: gather it
            # before a reshuffle reorders idx
            tail = self.idx[self.cursor:self.num_data]
            self._cache_data = [_take(arr, tail) for _, arr in self.data]
            self._cache_label = [_take(arr, tail) for _, arr in self.label]
        else:
            self._cache_data = None
            self._cache_label = None
        if self.shuffle:
            np.random.shuffle(self.idx)
        ncache = len(self._cache_data[0]) if self._cache_data else 0
        self.cursor = -self.batch_size - ncache

    def iter_next(self):
        self.cursor += self.batch_size
        if self.last_batch_handle == "roll_over":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def next(self):
        if not self.iter_next():
            raise StopIteration
        if self.last_batch_handle == "discard" and \
                self.cursor + self.batch_size > self.num_data:
            raise StopIteration
        batch = DataBatch(data=self.getdata(), label=self.getlabel(),
                          pad=self.getpad(), index=None)
        if self.cursor < 0:  # the rolled-over cache is used once
            self._cache_data = None
            self._cache_label = None
        return batch

    def _getdata(self, data_source, cache):
        start = max(self.cursor, 0)
        end = min(self.cursor + self.batch_size, self.num_data)
        s = self.idx[start:end]
        pad = self.getpad()
        out = []
        for i, (_, arr) in enumerate(data_source):
            batch = _take(arr, s)
            if self.cursor < 0 and cache:
                batch = np.concatenate([cache[i], batch])
            if pad and self.last_batch_handle == "pad":
                batch = np.concatenate([batch,
                                        _take(arr, self.idx[:pad])])
            out.append(_host(batch))
        return out

    def getdata(self):
        return self._getdata(self.data, self._cache_data)

    def getlabel(self):
        return self._getdata(self.label, self._cache_label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


def _has_sparse(data):
    return any(not isinstance(v, np.ndarray) for _, v in data)


def _take(arr, s):
    """Rows `s` of a source as a numpy array (a CSR source's densified)."""
    if isinstance(arr, np.ndarray):
        return arr[s]
    return arr[s].toarray()


def _init_data(data, allow_empty, default_name):
    """[(name, numpy array or host CSR matrix)] of an iterator's data
    argument (float64 and int64 narrowed to float32 and int32, as the
    reference's NDArrays are)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray, CSRNDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = collections.OrderedDict([(default_name, data[0])])
        else:
            data = collections.OrderedDict(
                [("_%d_%s" % (i, default_name), d)
                 for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError(
            "cannot build a data source from %r: expected an array, a "
            "list of arrays, or a {name: array} dict" % type(data).__name__)
    out = []
    for k, v in data.items():
        if isinstance(v, CSRNDArray):
            out.append((k, v.asscipy()))
            continue
        v = v.asnumpy() if isinstance(v, NDArray) else np.asarray(v)
        if v.dtype in (np.float64, np.int64):
            v = v.astype(np.float32 if v.dtype == np.float64 else np.int32)
        out.append((k, v))
    return out


class ResizeIter(DataIter):
    """An iterator's epoch resized to `size` batches (restarting it when
    it runs out)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Each inner iterator's next batch fetched ahead on a thread of its
    own (the first iterator's batch is the one returned)."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = iters[0].batch_size
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i],
                             daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    @property
    def provide_data(self):
        return [d for i in self.iters for d in i.provide_data]

    @property
    def provide_label(self):
        return [d for i in self.iters for d in i.provide_label]

    def close(self):
        """Stop the prefetch threads."""
        self.started = False
        for e in self.data_taken:
            e.set()

    __del__ = close

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            return False
        self.current_batch = self.next_batch[0]
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _synthetic_mnist(train):
    from .gluon.data.vision.datasets import _synthetic
    raw, lab = _synthetic(6000 if train else 1000, (28, 28, 1), 10,
                          seed=42 if train else 43)
    return raw[..., 0].astype(np.float32) / 255., lab.astype(np.float32)


class MNISTIter(DataIter):
    """MNIST from its idx files (gzip or not), scaled to [0, 1]; when the
    files are absent, the hermetic synthetic set of
    `gluon.data.vision.MNIST` (6000 training or 1000 test images, by
    whether "train" is in the image path)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=None,
                 **kwargs):
        super().__init__(batch_size)
        if os.path.exists(image) and os.path.exists(label):
            opener = gzip.open if image.endswith(".gz") else open
            with opener(label, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                lab = np.frombuffer(fin.read(), dtype=np.uint8).astype(
                    np.float32)
            with opener(image, "rb") as fin:
                struct.unpack(">IIII", fin.read(16))
                data = np.frombuffer(fin.read(), dtype=np.uint8)
                data = data.reshape(len(lab), 28, 28).astype(
                    np.float32) / 255.
        else:
            data, lab = _synthetic_mnist("train" in image)
        data = data.reshape((len(lab), -1) if flat else (len(lab), 1, 28, 28))
        self._inner = NDArrayIter(data, lab, batch_size=batch_size,
                                  shuffle=shuffle,
                                  last_batch_handle="discard")
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class LibSVMIter(DataIter):
    """Batches of a LibSVM text file (parity: LibSVMIter,
    src/io/iter_libsvm.cc): `label index:value ...` a line, the features
    a CSR source of `prod(data_shape)` columns, every num_parts-th line
    from part_index, the last partial batch discarded. Batches are dense
    host NDArrays, as the reference's are."""

    def __init__(self, data_libsvm, data_shape, label_shape=(1,),
                 batch_size=1, num_parts=1, part_index=0, **kwargs):
        super().__init__(batch_size)
        ncol = int(np.prod(data_shape))
        with open(data_libsvm) as f:
            lines = f.readlines()[part_index::num_parts]
        labels, indptr, indices, values = [], [0], [], []
        for line in lines:
            parts = line.strip().split()
            labels.append(float(parts[0]))
            for kv in parts[1:]:
                k, v = kv.split(":")
                indices.append(int(k))
                values.append(float(v))
            indptr.append(len(indices))
        csr = CSRNDArray(np.asarray(values, dtype=np.float32),
                         np.asarray(indices, dtype=np.int64),
                         np.asarray(indptr, dtype=np.int64),
                         (len(labels), ncol), ctx=cpu())
        self._inner = NDArrayIter(
            {"data": csr},
            {"softmax_label": np.asarray(labels, dtype=np.float32)},
            batch_size=batch_size, last_batch_handle="discard")
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class CSVIter(DataIter):
    """Batches of a CSV file's rows (parity: CSVIter, src/io/iter_csv.cc):
    each row reshaped to `data_shape`, the labels from `label_csv` (one
    or more columns; zeros without one). `round_batch=True` pads the last
    batch by wrapping to the start, False discards it."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape(len(data), -1)
            if label.shape[1] == 1:
                label = label[:, 0]
        else:
            label = np.zeros(len(data), dtype=np.float32)
        self._inner = NDArrayIter(data, label, batch_size=batch_size,
                                  last_batch_handle="pad" if round_batch
                                  else "discard")
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class DevicePrefetchIter(DataIter):
    """Stage the next `depth` batches of `base_iter` on `device` while the
    current step runs (parity: DevicePrefetchIter; the current context's
    device when None).

    On a CUDA device each batch is copied from pinned host memory on a
    side stream with `non_blocking=True`, and an event is recorded
    there; `next()` makes the consuming (current) stream wait on that
    event before handing the batch out, and calls `record_stream` on its
    arrays so that the caching allocator does not reuse their memory
    while the consumer's work is in flight. On the CPU it stages with
    plain copies. It stages onto one device: a list of more than one
    raises, as the reference's does."""

    def __init__(self, base_iter, depth=2, device=None):
        super().__init__()
        if isinstance(device, (list, tuple)):
            if len(device) != 1:
                raise ValueError(
                    "DevicePrefetchIter stages onto ONE device; for "
                    "several devices split the batch per device instead")
            device = device[0]
        if device is None:
            from .context import current_context
            device = current_context()
        self._ctx = device if hasattr(device, "torch_device") else None
        self._device = (device.torch_device() if self._ctx is not None
                        else torch.device(device))
        if self._ctx is None:
            from .context import context_of
            self._ctx = context_of(self._device)
        self.base = base_iter
        self.depth = max(1, int(depth))
        self.batch_size = getattr(base_iter, "batch_size", None)
        self._queue = None
        self._stream = None
        if self._device.type == "cuda":
            self._stream = torch.cuda.Stream(self._device)

    @property
    def provide_data(self):
        return self.base.provide_data

    @property
    def provide_label(self):
        return self.base.provide_label

    def reset(self):
        self.base.reset()
        self._queue = None

    def _copy(self, nd):
        t = nd._data if isinstance(nd, NDArray) else torch.as_tensor(nd)
        if self._stream is None:
            return t.to(self._device, copy=True)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self._device, non_blocking=True)

    def _stage(self, batch):
        """(staged batch, the event its copies finish at, or None)."""
        def put(nd):
            return NDArray(self._copy(nd), ctx=self._ctx)

        event = None
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                data = [put(d) for d in batch.data]
                label = [put(d) for d in (batch.label or [])]
                event = torch.cuda.Event()
                event.record(self._stream)
        else:
            data = [put(d) for d in batch.data]
            label = [put(d) for d in (batch.label or [])]
        staged = DataBatch(data=data, label=label,
                           pad=getattr(batch, "pad", 0),
                           index=getattr(batch, "index", None),
                           bucket_key=getattr(batch, "bucket_key", None),
                           provide_data=getattr(batch, "provide_data",
                                                None),
                           provide_label=getattr(batch, "provide_label",
                                                 None))
        return staged, event

    def _fill(self):
        while len(self._queue) < self.depth:
            try:
                self._queue.append(self._stage(self.base.next()))
            except StopIteration:
                break

    def next(self):
        if self._queue is None:
            self._queue = []
            self._fill()
        if not self._queue:
            raise StopIteration
        batch, event = self._queue.pop(0)
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for nd in list(batch.data) + list(batch.label or []):
                nd._data.record_stream(consumer)
        self._fill()  # start the next copies before the step uses this one
        return batch
