"""The detection data pipeline (port of `mxnet_tpu/image_detection.py`):
the Det* augmenters, CreateMultiRandCropAugmenter, CreateDetAugmenter and
ImageDetIter with its label parsing, padding, reshape, sync_label_shape
and draw_next.

Labels follow im2rec's detection format: a flat record ``[header_width,
obj_width, <header...>, (id, xmin, ymin, xmax, ymax, ...extras) * n]``
with corner coordinates normalized to [0, 1]. Parsed labels are
``[n, obj_width]`` arrays; batches pad the object axis with -1 rows.
Augmentation is host work on numpy (and OpenCV for resizes), drawing from
Python's `random` in the reference's order; images and batches are host
NDArrays.
"""
from __future__ import annotations

import json
import math
import random

import numpy as np

from .base import MXNetError
from .ndarray import NDArray
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug, HueJitterAug, ImageIter, LightingAug,
                    RandomGrayAug, ResizeAug, _cv2, _host, fixed_crop)


def _box_areas(boxes):
    """Areas of [N, 4+] normalized corner boxes (first 4 cols)."""
    return np.maximum(0, boxes[:, 2] - boxes[:, 0]) * \
        np.maximum(0, boxes[:, 3] - boxes[:, 1])


def _as_np(x):
    """Augmenters compute on host: coerce NDArray (image or label) to
    numpy."""
    return x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)


class DetAugmenter:
    """Base detection augmenter: transforms (image, label) jointly."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        """Serialize to [class_name, kwargs]."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        return src, label


class DetBorrowAug(DetAugmenter):
    """Lift an image-only Augmenter into the detection pipeline."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("DetBorrowAug requires an image Augmenter")
        super().__init__(augmenter=augmenter.__class__.__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply one randomly-chosen augmenter from the list, or skip entirely
    with probability skip_prob."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if not self.aug_list or random.random() < self.skip_prob:
            return src, label
        return random.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image and x-coordinates with probability p."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        label = _as_np(label)
        if random.random() < self.p:
            arr = _as_np(src)
            src = _host(arr[:, ::-1].copy())
            label = label.copy()
            x1 = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - x1
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Constrained random crop: the crop must cover at least
    min_object_covered of every (overlapped) object; objects whose surviving
    area falls below min_eject_coverage of their original are ejected.

    tf.image.sample_distorted_bounding_box's semantics.
    """

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts
        self.enabled = (0 < area_range[0] <= area_range[1]) and \
            (0 < aspect_ratio_range[0] <= aspect_ratio_range[1])

    def _satisfies(self, label, x1, y1, x2, y2):
        """All overlapped objects must be covered >= min_object_covered."""
        if (x2 - x1) * (y2 - y1) < 1e-6:
            return False
        boxes = label[:, 1:5]
        areas = _box_areas(label[:, 1:])
        ok = areas > 1e-6
        if not ok.any():
            return False
        il = np.maximum(boxes[ok, 0], x1)
        it = np.maximum(boxes[ok, 1], y1)
        ir = np.minimum(boxes[ok, 2], x2)
        ib = np.minimum(boxes[ok, 3], y2)
        inter = np.maximum(0, ir - il) * np.maximum(0, ib - it)
        cov = inter / areas[ok]
        cov = cov[cov > 0]
        return cov.size > 0 and cov.min() > self.min_object_covered

    def _crop_labels(self, label, x0, y0, w, h):
        """Re-express labels in the crop frame; eject low-coverage boxes."""
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] - x0) / w
        out[:, (2, 4)] = (out[:, (2, 4)] - y0) / h
        out[:, 1:5] = np.clip(out[:, 1:5], 0, 1)
        cov = _box_areas(out[:, 1:]) * w * h / \
            np.maximum(_box_areas(label[:, 1:]), 1e-12)
        keep = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2]) & \
            (cov > self.min_eject_coverage)
        if not keep.any():
            return None
        return out[keep]

    def __call__(self, src, label):
        label = _as_np(label)
        arr = _as_np(src)
        H, W = arr.shape[:2]
        if not self.enabled or H <= 0 or W <= 0:
            return src, label
        for _ in range(self.max_attempts):
            ratio = random.uniform(*self.aspect_ratio_range)
            area = random.uniform(*self.area_range) * H * W
            h = int(round(math.sqrt(area / ratio)))
            w = int(round(h * ratio))
            if not (0 < w <= W and 0 < h <= H):
                continue
            x = random.randint(0, W - w)
            y = random.randint(0, H - h)
            if not self._satisfies(label, x / W, y / H, (x + w) / W,
                                   (y + h) / H):
                continue
            new_label = self._crop_labels(label, x / W, y / H, w / W, h / H)
            if new_label is None:
                continue
            return fixed_crop(arr, x, y, w, h), new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Random expansion: place the image at a random offset inside a larger
    pad_val canvas and rescale boxes (SSD 'zoom-out' augmentation).
    """

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(128, 128, 128)):
        if not isinstance(pad_val, (tuple, list)):
            pad_val = (pad_val,)
        if not isinstance(aspect_ratio_range, (tuple, list)):
            aspect_ratio_range = (aspect_ratio_range, aspect_ratio_range)
        if not isinstance(area_range, (tuple, list)):
            area_range = (area_range, area_range)
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.pad_val = pad_val
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = (area_range[1] > 1.0 and
                        area_range[0] <= area_range[1] and
                        0 < aspect_ratio_range[0] <= aspect_ratio_range[1])

    def __call__(self, src, label):
        label = _as_np(label)
        arr = _as_np(src)
        H, W, C = arr.shape
        if not self.enabled or H <= 0 or W <= 0:
            return src, label
        for _ in range(self.max_attempts):
            ratio = random.uniform(*self.aspect_ratio_range)
            area = random.uniform(*self.area_range) * H * W
            h = int(round(math.sqrt(area / ratio)))
            w = int(round(h * ratio))
            if h - H < 2 or w - W < 2:
                continue
            y = random.randint(0, h - H)
            x = random.randint(0, w - W)
            canvas = np.empty((h, w, C), dtype=arr.dtype)
            canvas[:] = np.asarray(self.pad_val, dtype=arr.dtype)[:C]
            canvas[y:y + H, x:x + W] = arr
            out = label.copy()
            out[:, (1, 3)] = (out[:, (1, 3)] * W + x) / w
            out[:, (2, 4)] = (out[:, (2, 4)] * H + y) / h
            return _host(canvas), out
        return src, label


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """Build a DetRandomSelectAug over per-parameter-set crop augmenters
    Scalar parameters
    broadcast against list-valued ones."""
    params = [min_object_covered, aspect_ratio_range, area_range,
              min_eject_coverage, max_attempts]
    lists = [p if isinstance(p, list) else [p] for p in params]
    n = max(len(p) for p in lists)
    for i, p in enumerate(lists):
        if len(p) != n:
            assert len(p) == 1, "parameter lists must align or be scalar"
            lists[i] = p * n
    augs = [DetRandomCropAug(min_object_covered=moc, aspect_ratio_range=arr,
                             area_range=ar, min_eject_coverage=mec,
                             max_attempts=ma)
            for moc, arr, ar, mec, ma in zip(*lists)]
    return DetRandomSelectAug(augs, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 3.0),
                       min_eject_coverage=0.3, max_attempts=50,
                       pad_val=(127, 127, 127)):
    """The standard detection augmenter list: resize -> random crop (prob rand_crop) -> random
    pad (prob rand_pad) -> mirror -> force-resize to data_shape -> cast ->
    color jitter/hue/lighting/gray -> normalize."""
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop_augs = CreateMultiRandCropAugmenter(
            min_object_covered=min_object_covered,
            aspect_ratio_range=aspect_ratio_range,
            area_range=(min(area_range[0], 1.0),
                        min(area_range[1], 1.0)),
            min_eject_coverage=min_eject_coverage,
            max_attempts=max_attempts, skip_prob=1 - rand_crop)
        auglist.append(crop_augs)
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        pad_aug = DetRandomPadAug(
            aspect_ratio_range,
            (max(area_range[0], 1.0), max(area_range[1], 1.0)),
            max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad_aug], 1 - rand_pad))
    # force resize to the network input size
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2], data_shape[1]),
                                               inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(ColorJitterAug(brightness, contrast,
                                                   saturation)))
    if hue:
        auglist.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist


class ImageDetIter(ImageIter):
    """Detection image iterator: parses im2rec detection labels, applies
    joint (image, boxes) augmentation, and pads the object axis with -1.
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, shuffle=False,
                 part_index=0, num_parts=1, aug_list=None, imglist=None,
                 data_name="data", label_name="label", **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         part_index=part_index, num_parts=num_parts,
                         aug_list=[], imglist=imglist, data_name=data_name,
                         label_name=label_name)
        self.auglist = aug_list if aug_list is not None else \
            CreateDetAugmenter(data_shape, **kwargs)
        self.label_shape = self._estimate_label_shape()

    @property
    def provide_label(self):
        from .io import DataDesc
        return [DataDesc(self._label_name,
                         (self.batch_size,) + self.label_shape)]

    def _parse_label(self, label):
        """Flat [A, B, header..., objects...] -> [num_obj, B] ."""
        if isinstance(label, NDArray):
            label = label.asnumpy()
        raw = np.asarray(label, dtype=np.float32).ravel()
        if raw.size < 7:
            raise MXNetError("Label shape is invalid: %s" % (raw.shape,))
        header_width = int(raw[0])
        obj_width = int(raw[1])
        if obj_width < 5:
            raise MXNetError("Object width must be >= 5, got %d" % obj_width)
        if (raw.size - header_width) % obj_width != 0:
            raise MXNetError("Label size %d inconsistent with object width "
                             "%d" % (raw.size, obj_width))
        out = raw[header_width:].reshape(-1, obj_width)
        valid = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2])
        if not valid.any():
            raise MXNetError("Encountered sample with no valid label")
        return out[valid]

    def _labels_only(self):
        """Yield raw labels without decoding images — imglist-backed
        datasets keep labels in memory, so the construction-time shape scan
        must not pay a full-dataset JPEG decode. RecordIO still reads
        records (label and image share the record) but skips the decode."""
        if self.imglist is not None:
            for idx in self.seq:
                yield self.imglist[idx][0]
        else:
            from . import recordio
            for idx in self.seq:
                header, _img = recordio.unpack(self.imgrec.read_idx(idx))
                yield header.label

    def _estimate_label_shape(self):
        max_count, width = 0, 5
        for label in self._labels_only():
            try:
                parsed = self._parse_label(label)
            except MXNetError:
                continue  # bad records are skipped again in next()
            max_count = max(max_count, parsed.shape[0])
            width = parsed.shape[1]
        return (max_count, width)

    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.check_data_shape(tuple(data_shape))
            self.data_shape = tuple(data_shape)
        if label_shape is not None:
            self.check_label_shape(tuple(label_shape))
            self.label_shape = tuple(label_shape)

    def sync_label_shape(self, it, verbose=False):
        """Synchronize label padding with another ImageDetIter (train/val
        must agree on max-object count)."""
        assert isinstance(it, ImageDetIter)
        shape = (max(self.label_shape[0], it.label_shape[0]),
                 max(self.label_shape[1], it.label_shape[1]))
        self.reshape(label_shape=shape)
        it.reshape(label_shape=shape)
        return it

    def augmentation_transform(self, data, label):
        """Joint (image, boxes) augmentation (a hook)."""
        for aug in self.auglist:
            data, label = aug(data, label)
        return data, label

    def check_label_shape(self, label_shape):
        """Validate a (max_objects, width) label shape (a hook)."""
        if len(label_shape) != 2:
            raise ValueError("label_shape must be (max_objects, width)")
        if label_shape[1] < 5:
            raise ValueError("label width must be >= 5 (id + 4 coords)")

    def draw_next(self, color=None, thickness=2, waitKey=None,
                  window_name="draw_next"):
        """Yield augmented images with their boxes drawn (the visual-debugging generator).
        Yields HWC uint8 numpy arrays; waitKey/window_name additionally
        display via cv2 when a GUI is available."""
        cv2 = _cv2("draw_next")
        while True:
            try:
                label, raw = self.next_sample()
            except StopIteration:
                return
            try:
                parsed = self._parse_label(label)
            except MXNetError:
                continue
            img = self.imdecode(raw)
            self.check_valid_image([img])
            img, parsed = self.augmentation_transform(img, parsed)
            arr = np.clip(img.asnumpy(), 0, 255).astype(np.uint8).copy()
            h, w = arr.shape[:2]
            for obj in parsed:
                x0, y0 = int(obj[1] * w), int(obj[2] * h)
                x1, y1 = int(obj[3] * w), int(obj[4] * h)
                cv2.rectangle(arr, (x0, y0), (x1, y1),
                              color or (255, 0, 0), thickness)
            if waitKey is not None:
                cv2.imshow(window_name, arr)
                cv2.waitKey(waitKey)
            yield arr

    def next(self):
        from .io import DataBatch
        B = self.batch_size
        batch_data = np.zeros((B,) + self.data_shape, dtype=np.float32)
        batch_label = np.full((B,) + self.label_shape, -1.0, dtype=np.float32)
        i = 0
        try:
            while i < B:
                label, raw = self.next_sample()
                try:
                    parsed = self._parse_label(label)
                except MXNetError:
                    continue
                img = self.imdecode(raw)
                self.check_valid_image([img])
                img, parsed = self.augmentation_transform(img, parsed)
                batch_data[i] = self.postprocess_data(img)
                n = min(parsed.shape[0], self.label_shape[0])
                batch_label[i, :n, :parsed.shape[1]] = parsed[:n]
                i += 1
        except StopIteration:
            if i == 0:
                raise
        return DataBatch(data=[_host(batch_data)],
                         label=[_host(batch_label)], pad=B - i)
