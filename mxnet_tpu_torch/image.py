"""Image decoding, augmentation and ImageIter (port of
`mxnet_tpu/image.py`): imdecode / imencode / imread, imresize and the
crops, color_normalize, the augmenters and CreateAugmenter, and ImageIter
with its override hooks (check_data_shape, check_valid_image, imdecode,
read_image, augmentation_transform, postprocess_data, next_sample).

Decoding and augmentation are host work on numpy, as in the reference;
images and batches are host (CPU) NDArrays, and a batch reaches the card
through `as_in_context`. The augmenters draw from Python's `random` and
numpy's global generator in the reference's order, so equal seeds give
equal images in both packages. OpenCV is used when it can be imported;
a function that needs it (decode, encode, resize) raises MXNetError when
it cannot, and the rest of the module works without it: feed ImageIter
decoded arrays through its `read_image` / `imdecode` hooks and give it an
`aug_list` without a resize.
"""
from __future__ import annotations

import os
import random

import numpy as np

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray


def _cv2(what):
    """OpenCV, or MXNetError naming the function that needs it."""
    try:
        import cv2
    except ImportError:
        raise MXNetError("cv2 is required for %s" % what) from None
    return cv2


def _host(arr):
    return NDArray(arr, ctx=cpu())


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """A jpeg/png buffer decoded to an HWC uint8 NDArray (RGB unless
    to_rgb is False; one channel with flag 0)."""
    cv2 = _cv2("imdecode")
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().astype(np.uint8)
    arr = np.frombuffer(buf, dtype=np.uint8) if isinstance(buf, (bytes, bytearray)) \
        else np.asarray(buf, dtype=np.uint8)
    img = cv2.imdecode(arr, flag)
    if img is None:
        raise MXNetError("imdecode failed")
    if to_rgb and img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if img.ndim == 2:
        img = img[:, :, None]
    return _host(img)


def imencode(img, quality=95, img_fmt=".jpg"):
    """The bytes of an HWC RGB image encoded as img_fmt."""
    cv2 = _cv2("imencode")
    arr = img.asnumpy() if isinstance(img, NDArray) else np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 3:
        arr = cv2.cvtColor(arr.astype(np.uint8), cv2.COLOR_RGB2BGR)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality] if img_fmt in (".jpg", ".jpeg") \
        else []
    ok, buf = cv2.imencode(img_fmt, arr, params)
    if not ok:
        raise MXNetError("imencode failed")
    return buf.tobytes()


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """src resized to w x h."""
    cv2 = _cv2("imresize")
    arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    out = cv2.resize(arr, (w, h), interpolation=_interp(cv2, interp))
    if out.ndim == 2:
        out = out[:, :, None]
    return _host(out)


def _interp(cv2, interp):
    return {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR, 2: cv2.INTER_CUBIC,
            3: cv2.INTER_AREA, 4: cv2.INTER_LANCZOS4}.get(interp,
                                                          cv2.INTER_LINEAR)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    arr = src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp=interp)
    return _host(out)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = random.randint(0, w - new_w)
    y0 = random.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, min_area=0.08, ratio=(3.0 / 4.0, 4.0 / 3.0),
                     interp=2):
    h, w = src.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = random.uniform(min_area, 1.0) * area
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(random.uniform(*log_ratio))
        new_w = int(round(np.sqrt(target_area * aspect)))
        new_h = int(round(np.sqrt(target_area / aspect)))
        if new_w <= w and new_h <= h:
            x0 = random.randint(0, w - new_w)
            y0 = random.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    arr = src.asnumpy().astype(np.float32) if isinstance(src, NDArray) \
        else np.asarray(src, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    arr = arr - mean
    if std is not None:
        arr = arr / np.asarray(std, dtype=np.float32)
    return _host(arr)


# ---------------------------------------------------------------------------
# augmenters
# ---------------------------------------------------------------------------


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(Augmenter):
    """Apply the augmenter list in a fresh random order per image."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def __call__(self, src):
        order = list(range(len(self.ts)))
        random.shuffle(order)
        for i in order:
            src = self.ts[i](src)
        return src


def scale_down(src_size, size):
    """Shrink a crop size to fit inside the image, preserving the crop's
    aspect ratio; sizes are (w, h)."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area=0.08, ratio=(3 / 4., 4 / 3.), interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)
        self.size = size
        self.min_area = min_area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            return _host(src.asnumpy()[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return _host(src.asnumpy().astype(self.typ))


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.brightness, self.brightness)
        return _host(src.asnumpy().astype(np.float32) * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.contrast, self.contrast)
        arr = src.asnumpy().astype(np.float32)
        gray = arr.mean()
        return _host(gray * (1 - alpha) + arr * alpha)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        alpha = 1.0 + random.uniform(-self.saturation, self.saturation)
        arr = src.asnumpy().astype(np.float32)
        gray = arr.mean(axis=2, keepdims=True)
        return _host(gray * (1 - alpha) + arr * alpha)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue

    def __call__(self, src):
        alpha = random.uniform(-self.hue, self.hue)
        arr = src.asnumpy().astype(np.float32)
        rotated = np.roll(arr, 1, axis=2)
        return _host((1 - abs(alpha)) * arr + abs(alpha) * rotated)


class ColorJitterAug(SequentialAug):
    def __init__(self, brightness, contrast, saturation):
        ts = []
        if brightness > 0:
            ts.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            ts.append(ContrastJitterAug(contrast))
        if saturation > 0:
            ts.append(SaturationJitterAug(saturation))
        super().__init__(ts)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval)
        self.eigvec = np.asarray(eigvec)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return _host(src.asnumpy().astype(np.float32) + rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if random.random() < self.p:
            arr = src.asnumpy().astype(np.float32)
            gray = (arr * np.array([0.299, 0.587, 0.114])).sum(
                axis=2, keepdims=True)
            return _host(np.broadcast_to(gray, arr.shape).copy())
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list: resize, crop, mirror, cast, colour
    jitter, hue, lighting, gray, normalize."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0,
                                                            4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and len(np.atleast_1d(mean)) > 0:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter:
    """Image iterator over a RecordIO pack, an image list file or an
    in-memory imglist; batches of host NDArrays."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="softmax_label",
                 **kwargs):
        from .io import DataBatch, DataDesc
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        self.batch_size = batch_size
        self.check_data_shape(tuple(data_shape))
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._data_name = data_name
        self._label_name = label_name
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape, **{k: v for k, v in kwargs.items()
                                           if k in ("resize", "rand_crop",
                                                    "rand_resize",
                                                    "rand_mirror", "mean",
                                                    "std", "brightness",
                                                    "contrast", "saturation",
                                                    "hue", "pca_noise",
                                                    "rand_gray",
                                                    "inter_method")})
        self.shuffle = shuffle
        self.imgrec = None
        self.imglist = None
        self.path_root = path_root
        if path_imgrec:
            idx_path = os.path.splitext(path_imgrec)[0] + ".idx"
            from . import recordio
            self.imgrec = recordio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
            self.seq = list(self.imgrec.keys)
            # distributed sharding: every num_parts-th record
            self.seq = self.seq[part_index::num_parts]
        elif path_imglist:
            self.imglist = {}
            with open(path_imglist) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    label = np.asarray([float(x) for x in parts[1:-1]],
                                       dtype=np.float32)
                    self.imglist[int(parts[0])] = (label, parts[-1])
            self.seq = sorted(self.imglist.keys())[part_index::num_parts]
        else:
            self.imglist = {i: (np.asarray(item[0], dtype=np.float32), item[1])
                            for i, item in enumerate(imglist)}
            self.seq = sorted(self.imglist.keys())[part_index::num_parts]
        self.cur = 0
        self.reset()

    @property
    def provide_data(self):
        from .io import DataDesc
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        from .io import DataDesc
        shape = (self.batch_size,) if self.label_width == 1 else \
            (self.batch_size, self.label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self.cur = 0
        if self.shuffle:
            random.shuffle(self.seq)

    # -- overridable pipeline hooks: users subclass and override these to
    # customize decode / augment / layout ----

    def check_data_shape(self, data_shape):
        """Validate the (C, H, W) shape argument."""
        if len(data_shape) != 3:
            raise ValueError("data_shape must be (channels, height, "
                             "width), got %s" % (data_shape,))
        if data_shape[0] not in (1, 3):
            raise ValueError("data_shape channel dim must be 1 or 3")

    def check_valid_image(self, data):
        """Reject undecodable samples."""
        if len(data[0].shape) == 0:
            raise RuntimeError("Data shape is wrong")

    def imdecode(self, s):
        """Decode raw image bytes (the module-level imdecode)."""
        return imdecode(s)

    def read_image(self, fname):
        """Raw bytes of an image under path_root."""
        with open(os.path.join(self.path_root or "", fname), "rb") as f:
            return f.read()

    def augmentation_transform(self, data):
        """Run the augmenter list."""
        for aug in self.auglist:
            data = aug(data)
        return data

    def postprocess_data(self, datum):
        """Final per-sample layout transform HWC -> CHW."""
        arr = datum.asnumpy() if isinstance(datum, NDArray) \
            else np.asarray(datum)
        if arr.shape[:2] != self.data_shape[1:]:
            arr = _cv2("postprocess_data").resize(
                arr, (self.data_shape[2], self.data_shape[1]))
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(2, 0, 1)

    def next_sample(self):
        """(label, raw image bytes) of the next sample."""
        if self.cur >= len(self.seq):
            raise StopIteration
        idx = self.seq[self.cur]
        self.cur += 1
        if self.imgrec is not None:
            from . import recordio
            s = self.imgrec.read_idx(idx)
            header, img = recordio.unpack(s)
            return header.label, img
        label, fname = self.imglist[idx]
        return label, self.read_image(fname)

    def next(self):
        from .io import DataBatch
        batch_data = np.zeros((self.batch_size,) + self.data_shape,
                              dtype=np.float32)
        batch_label = np.zeros((self.batch_size, self.label_width),
                               dtype=np.float32)
        i = 0
        try:
            while i < self.batch_size:
                label, raw = self.next_sample()
                img = self.imdecode(raw)
                self.check_valid_image([img])
                img = self.augmentation_transform(img)
                batch_data[i] = self.postprocess_data(img)
                batch_label[i] = np.atleast_1d(label)[:self.label_width]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        lab = batch_label[:, 0] if self.label_width == 1 else batch_label
        return DataBatch(data=[_host(batch_data)], label=[_host(lab)],
                         pad=self.batch_size - i)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self


# the detection pipeline, imported at the tail so that image_detection can
# import ImageIter from here
from .image_detection import (DetAugmenter, DetBorrowAug,  # noqa: E402,F401
                              DetRandomSelectAug, DetHorizontalFlipAug,
                              DetRandomCropAug, DetRandomPadAug,
                              CreateMultiRandCropAugmenter,
                              CreateDetAugmenter, ImageDetIter)
