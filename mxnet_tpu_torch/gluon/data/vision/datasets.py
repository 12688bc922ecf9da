"""Vision datasets (port of `mxnet_tpu/gluon/data/vision/datasets.py`):
MNIST, FashionMNIST, CIFAR10 and CIFAR100, ImageRecordDataset and
ImageFolderDataset.

Nothing is downloaded: a dataset reads its standard files under `root`
when they are there, and otherwise builds the reference's hermetic
synthetic set from the same seeds, value for value. Samples are host
(CPU) NDArrays of uint8 HWC images with int32 labels. ImageRecordDataset
(a RecordIO pack) and ImageFolderDataset (one subfolder a class) decode
with `image.imdecode`, which needs OpenCV.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....context import cpu
from ....ndarray import NDArray
from ..dataset import Dataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        self._transform = transform
        self._data = None
        self._label = None
        self._root = os.path.expanduser(root)
        self._get_data()

    def __getitem__(self, idx):
        if self._transform is not None:
            return self._transform(NDArray(self._data[idx], ctx=cpu()),
                                   self._label[idx])
        return NDArray(self._data[idx], ctx=cpu()), self._label[idx]

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _synthetic(n, shape, num_classes, seed):
    """(uint8 images [n, *shape], int32 labels [n]): a deterministic
    stand-in for a dataset whose files are absent, value for value the
    reference's. Class prototypes come from a fixed seed, so the train
    and test splits share their classes; `seed` varies the samples."""
    proto_rng = np.random.RandomState(1234 + num_classes)
    base = proto_rng.rand(num_classes, *shape).astype(np.float32)
    rng = np.random.RandomState(seed)
    label = rng.randint(0, num_classes, n).astype(np.int32)
    noise = rng.rand(n, *shape).astype(np.float32) * 0.3
    data = (base[label] * 0.7 + noise)
    return (data * 255).astype(np.uint8), label


class MNIST(_DownloadedDataset):
    """MNIST from its gzipped idx files under `root`, else the synthetic
    set (6000 training, 1000 test images)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train = train
        self._train_data = ("train-images-idx3-ubyte.gz",)
        self._train_label = ("train-labels-idx1-ubyte.gz",)
        self._test_data = ("t10k-images-idx3-ubyte.gz",)
        self._test_label = ("t10k-labels-idx1-ubyte.gz",)
        self._num_classes = 10
        self._shape = (28, 28, 1)
        super().__init__(root, transform)

    def _get_data(self):
        if self._train:
            data_file = os.path.join(self._root, self._train_data[0])
            label_file = os.path.join(self._root, self._train_label[0])
            n_syn = 6000
        else:
            data_file = os.path.join(self._root, self._test_data[0])
            label_file = os.path.join(self._root, self._test_label[0])
            n_syn = 1000
        if os.path.exists(data_file) and os.path.exists(label_file):
            with gzip.open(label_file, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(data_file, "rb") as fin:
                struct.unpack(">IIII", fin.read(16))
                data = np.frombuffer(fin.read(), dtype=np.uint8)
                data = data.reshape(len(label), 28, 28, 1)
            self._data = data
            self._label = label
        else:
            self._data, self._label = _synthetic(
                n_syn, self._shape, self._num_classes,
                seed=42 if self._train else 43)


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"),
                 train=True, transform=None):
        super().__init__(root=root, train=train, transform=transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR-10 from its binary batches under `root`, else the synthetic
    set (5000 training, 1000 test images)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._train = train
        self._num_classes = 10
        super().__init__(root, transform)

    def _read_batch(self, filename):
        with open(filename, "rb") as fin:
            data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3073)
        return data[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            data[:, 0].astype(np.int32)

    def _get_data(self):
        files = ["data_batch_%d.bin" % i for i in range(1, 6)] \
            if self._train else ["test_batch.bin"]
        paths = [os.path.join(self._root, "cifar-10-batches-bin", f)
                 for f in files]
        if all(os.path.exists(p) for p in paths):
            data, label = zip(*[self._read_batch(p) for p in paths])
            self._data = np.concatenate(data)
            self._label = np.concatenate(label)
        else:
            self._data, self._label = _synthetic(
                5000 if self._train else 1000, (32, 32, 3),
                self._num_classes, seed=44 if self._train else 45)


class CIFAR100(CIFAR10):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        self._fine_label = fine_label
        self._train = train
        self._num_classes = 100 if fine_label else 20
        _DownloadedDataset.__init__(self, root, transform)

    def _get_data(self):
        f = "train.bin" if self._train else "test.bin"
        path = os.path.join(self._root, "cifar-100-binary", f)
        if os.path.exists(path):
            with open(path, "rb") as fin:
                data = np.frombuffer(fin.read(), dtype=np.uint8).reshape(-1, 3074)
            self._data = data[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
            self._label = data[:, 1 if self._fine_label else 0].astype(np.int32)
        else:
            self._data, self._label = _synthetic(
                5000 if self._train else 1000, (32, 32, 3),
                self._num_classes, seed=46 if self._train else 47)


class ImageRecordDataset(Dataset):
    """(decoded image, header label) of each record of a RecordIO
    pack."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from .... import image, recordio
        header, img = recordio.unpack(self._record[idx])
        img = image.imdecode(img, flag=self._flag)
        label = header.label
        if self._transform is not None:
            return self._transform(img, label)
        return img, label


class ImageFolderDataset(Dataset):
    """(decoded image, class index) of the .jpg / .jpeg / .png files
    under root, one subfolder a class in sorted order (`synsets`)."""

    def __init__(self, root, flag=1, transform=None):
        self._root = os.path.expanduser(root)
        self._flag = flag
        self._transform = transform
        self._exts = [".jpg", ".jpeg", ".png"]
        self._list_images(self._root)

    def _list_images(self, root):
        self.synsets = []
        self.items = []
        for folder in sorted(os.listdir(root)):
            path = os.path.join(root, folder)
            if not os.path.isdir(path):
                continue
            label = len(self.synsets)
            self.synsets.append(folder)
            for filename in sorted(os.listdir(path)):
                filename = os.path.join(path, filename)
                ext = os.path.splitext(filename)[1]
                if ext.lower() not in self._exts:
                    continue
                self.items.append((filename, label))

    def __getitem__(self, idx):
        from .... import image
        with open(self.items[idx][0], "rb") as f:
            img = image.imdecode(f.read(), flag=self._flag)
        label = self.items[idx][1]
        if self._transform is not None:
            return self._transform(img, label)
        return img, label

    def __len__(self):
        return len(self.items)
