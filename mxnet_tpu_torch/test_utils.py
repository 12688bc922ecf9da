"""Test helpers (the share of `mxnet_tpu/test_utils.py` that BASELINE
configs 1 and 4 use): the hermetic synthetic MNIST and its iterators, and
the synthetic detection dataset."""
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
