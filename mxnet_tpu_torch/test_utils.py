"""Test helpers (the share of `mxnet_tpu/test_utils.py` that BASELINE
configs 1, 4 and 5 use): the hermetic synthetic MNIST and its iterators,
the synthetic detection dataset, and the random sparse arrays
(`rand_ndarray`, `rand_sparse_ndarray`, `create_sparse_array[_zd]`,
`shuffle_csr_column_indices`), drawn from numpy's global generator as
the reference's are, so one seed gives both packages the same arrays."""
from __future__ import annotations

import os

import numpy as np


def get_mnist():
    """{train,test}_{data,label}: the synthetic MNIST of
    `gluon.data.vision.MNIST` as NCHW float32 in [0, 1] and int32 labels
    (6000 training, 1000 test images), value for value the reference's."""
    from .gluon.data.vision.datasets import _synthetic
    tr_d, tr_l = _synthetic(6000, (28, 28, 1), 10, 42)
    te_d, te_l = _synthetic(1000, (28, 28, 1), 10, 43)
    return {"train_data": tr_d.transpose(0, 3, 1, 2).astype(np.float32) / 255,
            "train_label": tr_l,
            "test_data": te_d.transpose(0, 3, 1, 2).astype(np.float32) / 255,
            "test_label": te_l}


def get_mnist_iterator(batch_size, input_shape, num_parts=1, part_index=0):
    """(train, val) NDArrayIters over `get_mnist()` reshaped to
    (-1, *input_shape); the training one shuffles (numpy's global
    generator) and takes every num_parts-th image from part_index."""
    from .io import NDArrayIter
    mnist = get_mnist()
    shape = (-1,) + tuple(input_shape)
    train = NDArrayIter(
        mnist["train_data"].reshape(shape)[part_index::num_parts],
        mnist["train_label"][part_index::num_parts], batch_size,
        shuffle=True)
    val = NDArrayIter(mnist["test_data"].reshape(shape), mnist["test_label"],
                      batch_size)
    return train, val


def synthetic_det_images(num_images=40, size=48, num_classes=2, seed=0):
    """(images, imglist) of `make_synthetic_det_dataset` without the
    files: HWC uint8 RGB arrays, and [flat_det_label, filename] rows."""
    rng = np.random.RandomState(seed)
    images, imglist = [], []
    for i in range(num_images):
        img = rng.randint(0, 60, (size, size, 3)).astype(np.uint8)
        objs = []
        for _ in range(rng.randint(1, 3)):
            cls = rng.randint(num_classes)
            w = rng.randint(size // 4, size // 2)
            h = rng.randint(size // 4, size // 2)
            x0 = rng.randint(0, size - w)
            y0 = rng.randint(0, size - h)
            img[y0:y0 + h, x0:x0 + w, cls] = 230
            objs += [float(cls), x0 / size, y0 / size,
                     (x0 + w) / size, (y0 + h) / size]
        images.append(img)
        imglist.append([[2.0, 5.0] + objs, "img%04d.jpg" % i])
    return images, imglist


def make_synthetic_det_dataset(path, num_images=40, size=48, num_classes=2,
                               seed=0):
    """Write a synthetic detection dataset under `path`: noise images
    with 1-2 solid rectangles, class c filling channel c, as JPEG files.
    Returns the imglist of [flat_det_label, filename] rows in im2rec's
    detection label format [2, 5, (cls, xmin, ymin, xmax, ymax)*],
    corners normalized. Writing needs OpenCV."""
    from .image import _cv2
    cv2 = _cv2("make_synthetic_det_dataset")
    images, imglist = synthetic_det_images(num_images, size, num_classes,
                                           seed)
    os.makedirs(path, exist_ok=True)
    for img, (_, fname) in zip(images, imglist):
        cv2.imwrite(os.path.join(path, fname),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    return imglist


def _to_np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def rand_ndarray(shape, stype="default", density=None, dtype=None,
                 distribution=None):
    """A random array in [-1, 1): dense, or row_sparse with a share
    `density` (0.5 by default) of its rows kept, or csr with that share
    of rows and of entries kept."""
    from .ndarray import NDArray
    from .ndarray.sparse import CSRNDArray, RowSparseNDArray
    density = density if density is not None else 0.5
    dtype = dtype or np.float32
    if stype == "default":
        return NDArray(np.random.uniform(-1, 1, shape).astype(dtype))
    dense = np.random.uniform(-1, 1, shape).astype(dtype)
    mask = np.random.rand(shape[0]) < density
    dense[~mask] = 0
    if stype == "row_sparse":
        return RowSparseNDArray.from_dense(NDArray(dense))
    if stype == "csr":
        flat_mask = np.random.rand(*shape) < density
        dense = np.where(flat_mask, dense, 0)
        return CSRNDArray.from_dense(NDArray(dense))
    raise ValueError(stype)


def rand_sparse_ndarray(shape, stype, density=None, dtype=None):
    """(`rand_ndarray(shape, stype, ...)`, its stored ids)."""
    arr = rand_ndarray(shape, stype, density, dtype)
    return arr, getattr(arr, "_indices", None)


def shuffle_csr_column_indices(csr):
    """The csr with each row's (column, value) pairs in a shuffled order
    (a fixture of unsorted columns)."""
    from .ndarray.sparse import CSRNDArray
    indices = csr._indices.cpu().numpy().copy()
    indptr = csr._indptr.cpu().numpy()
    for i in range(len(indptr) - 1):
        seg = indices[indptr[i]:indptr[i + 1]]
        np.random.shuffle(seg)
        indices[indptr[i]:indptr[i + 1]] = seg
    return CSRNDArray(csr._values, indices, csr._indptr, csr.shape,
                      ctx=csr.context)


def create_sparse_array(shape, stype, data_init=None, rsp_indices=None,
                        dtype=None, modifier_func=None, density=0.5,
                        shuffle_csr_indices=False):
    """A random sparse array; `rsp_indices` pins which rows a row_sparse
    one holds (values from np.random.randn), `data_init` sets every
    nonzero value, `modifier_func` maps every value."""
    from . import ndarray as nd
    from .ndarray.sparse import RowSparseNDArray
    if rsp_indices is not None:
        if stype != "row_sparse":
            raise ValueError("rsp_indices only applies to row_sparse")
        idx = np.sort(np.asarray(rsp_indices).astype(np.int32))
        vals = np.random.randn(len(idx), *shape[1:]).astype(
            np.dtype(dtype) if dtype else np.float32)
        arr = RowSparseNDArray(idx, vals, shape)
    else:
        arr = rand_ndarray(shape, stype=stype, density=density,
                           dtype=dtype)
    if data_init is not None:
        d = _to_np(arr)
        d[d != 0] = data_init
        arr = nd.array(d).tostype(stype)
    if modifier_func is not None:
        d = np.vectorize(modifier_func)(_to_np(arr))
        arr = nd.array(d).tostype(stype)
    if stype == "csr" and shuffle_csr_indices:
        arr = shuffle_csr_column_indices(arr)
    return arr


def create_sparse_array_zd(shape, stype, density, data_init=None,
                           rsp_indices=None, dtype=None,
                           modifier_func=None, shuffle_csr_indices=False):
    """`create_sparse_array`, or an all-zero array at density 0."""
    if density == 0:
        from .ndarray import sparse as _sp
        return _sp.zeros(stype, shape, dtype=dtype)
    return create_sparse_array(shape, stype, data_init=data_init,
                               rsp_indices=rsp_indices, dtype=dtype,
                               modifier_func=modifier_func,
                               density=density,
                               shuffle_csr_indices=shuffle_csr_indices)
