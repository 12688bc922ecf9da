"""The image and detection data pipeline on the port (mxnet_tpu_torch/
image.py, image_detection.py, recordio.py, gluon.data's
RecordFileDataset, ImageRecordDataset and ImageFolderDataset,
test_utils.make_synthetic_det_dataset) against the JAX reference on the
CPU.

Every augmenter and image function runs on the same image under the same
`random` / `np.random` seeds in both packages; ImageIter and
ImageDetIter batches come from `make_synthetic_det_dataset`'s JPEGs and
from RecordIO packs; RecordIO files written by either package are read
by the other, and both write the same bytes. ImageDetIter also runs with
OpenCV unimportable, fed decoded arrays through its `read_image` /
`imdecode` hooks with an augmenter list without a resize (the way
chip_smoke.py phase 27c feeds it on a machine without OpenCV), while
`imdecode` itself raises MXNetError there. Mirrors tests/test_io.py's
and tests/test_detection.py's image and RecordIO cases.

Tolerances: none; every array is compared exactly (the same numpy and
OpenCV calls in the same order).
"""
import os
import random
import sys

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _img(seed=0, h=40, w=56):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(
        np.uint8)


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _dumps(aug):
    """aug.dumps(), or the error it raises (an augmenter holding a numpy
    array cannot be dumped, in either package)."""
    try:
        return aug.dumps()
    except TypeError as e:
        return "TypeError: %s" % e


def _seeded(fn, seed):
    random.seed(seed)
    np.random.seed(seed)
    return fn()


def _both(make, seed=0):
    """make(pkg) under the same seeds for each package: (ref, port)."""
    return _seeded(lambda: make(mx), seed), _seeded(lambda: make(tmx), seed)


AUGMENTERS = {
    "ResizeAug": lambda m: m.image.ResizeAug(24),
    "ForceResizeAug": lambda m: m.image.ForceResizeAug((30, 20), interp=1),
    "RandomCropAug": lambda m: m.image.RandomCropAug((24, 32)),
    "CenterCropAug": lambda m: m.image.CenterCropAug((36, 20)),
    "RandomSizedCropAug": lambda m: m.image.RandomSizedCropAug((24, 24),
                                                               0.3),
    "HorizontalFlipAug": lambda m: m.image.HorizontalFlipAug(0.5),
    "CastAug": lambda m: m.image.CastAug(),
    "BrightnessJitterAug": lambda m: m.image.BrightnessJitterAug(0.3),
    "ContrastJitterAug": lambda m: m.image.ContrastJitterAug(0.3),
    "SaturationJitterAug": lambda m: m.image.SaturationJitterAug(0.3),
    "HueJitterAug": lambda m: m.image.HueJitterAug(0.2),
    "ColorJitterAug": lambda m: m.image.ColorJitterAug(0.2, 0.3, 0.4),
    "LightingAug": lambda m: m.image.LightingAug(
        0.1, np.array([55.46, 4.794, 1.148]),
        np.array([[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]])),
    "ColorNormalizeAug": lambda m: m.image.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.395, 57.12,
                                                      57.375])),
    "RandomGrayAug": lambda m: m.image.RandomGrayAug(0.5),
    "RandomOrderAug": lambda m: m.image.RandomOrderAug(
        [m.image.BrightnessJitterAug(0.3), m.image.HueJitterAug(0.1),
         m.image.RandomGrayAug(0.7)]),
    "SequentialAug": lambda m: m.image.SequentialAug(
        [m.image.RandomCropAug((30, 30)), m.image.HorizontalFlipAug(0.5)]),
}


@pytest.mark.parametrize("name", sorted(AUGMENTERS))
def test_augmenters_match_the_reference(name):
    for seed in range(4):
        def run(m):
            aug = AUGMENTERS[name](m)
            out = aug(m.nd.array(_img(seed), dtype="uint8"))
            return _np(out), _dumps(aug)
        (r, rd), (p, pd) = _both(run, seed)
        assert p.dtype == r.dtype and p.shape == r.shape, name
        np.testing.assert_array_equal(p, r)
        assert pd == rd


def test_image_functions_match_the_reference():
    img = _img(1)
    calls = [
        lambda m: m.image.imresize(m.nd.array(img, dtype="uint8"), 17, 23,
                                   interp=2),
        lambda m: m.image.resize_short(m.nd.array(img, dtype="uint8"), 30),
        lambda m: m.image.fixed_crop(m.nd.array(img, dtype="uint8"), 3, 5,
                                     20, 10, size=(8, 8)),
        lambda m: m.image.random_crop(m.nd.array(img, dtype="uint8"),
                                      (30, 30)),
        lambda m: m.image.center_crop(m.nd.array(img, dtype="uint8"),
                                      (100, 10)),
        lambda m: m.image.random_size_crop(m.nd.array(img, dtype="uint8"),
                                           (16, 16), 0.2),
        lambda m: m.image.color_normalize(m.nd.array(img, dtype="uint8"),
                                          np.array([1.0, 2.0, 3.0]),
                                          np.array([2.0, 2.0, 4.0])),
        lambda m: m.image.imdecode(m.image.imencode(img, quality=90)),
        lambda m: m.image.imdecode(m.image.imencode(img, img_fmt=".png"),
                                   flag=0),
        lambda m: m.image.scale_down((40, 30), (50, 20)),
    ]
    for i, call in enumerate(calls):
        r, p = _both(call, i)
        r, p = (r if isinstance(r, tuple) else (r,)), \
            (p if isinstance(p, tuple) else (p,))
        for a, b in zip(p, r):
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=str(i))
    r, p = _both(lambda m: [
        (type(a).__name__, _dumps(a)) for a in m.image.CreateAugmenter(
            (3, 24, 24), resize=30, rand_crop=True, rand_resize=True,
            rand_mirror=True, mean=True, std=True, brightness=0.1,
            contrast=0.1, saturation=0.1, hue=0.1, pca_noise=0.1,
            rand_gray=0.1)])
    assert p == r and len(r) == 9


def _det_label():
    return np.array([[0, 0.1, 0.2, 0.5, 0.6], [1, 0.4, 0.1, 0.9, 0.7],
                     [1, 0.0, 0.5, 0.3, 1.0]], np.float32)


DET_AUGMENTERS = {
    "DetHorizontalFlipAug": lambda m: m.image.DetHorizontalFlipAug(0.5),
    "DetRandomCropAug": lambda m: m.image.DetRandomCropAug(
        min_object_covered=0.3, area_range=(0.2, 1.0)),
    "DetRandomPadAug": lambda m: m.image.DetRandomPadAug(
        area_range=(1.2, 2.5)),
    "DetRandomSelectAug": lambda m: m.image.DetRandomSelectAug(
        [m.image.DetHorizontalFlipAug(1.0), m.image.DetRandomPadAug()],
        skip_prob=0.3),
    "DetBorrowAug": lambda m: m.image.DetBorrowAug(
        m.image.BrightnessJitterAug(0.2)),
    "CreateMultiRandCropAugmenter": lambda m:
        m.image.CreateMultiRandCropAugmenter(
            min_object_covered=[0.1, 0.5], area_range=(0.1, 1.0),
            skip_prob=0.2),
    "CreateDetAugmenter": lambda m: m.image.SequentialAug(
        m.image.CreateDetAugmenter((3, 32, 32), resize=48, rand_crop=0.7,
                                   rand_pad=0.5, rand_mirror=True,
                                   mean=True, std=True, brightness=0.1,
                                   contrast=0.1, saturation=0.1, hue=0.05,
                                   pca_noise=0.05, rand_gray=0.2)),
}


def _run_det(m, make, seed):
    aug = make(m)
    img = m.nd.array(_img(seed), dtype="uint8")
    if isinstance(aug, m.image.SequentialAug):   # a Det augmenter list
        out, lab = img, _det_label()
        for a in aug.ts:
            out, lab = a(out, lab)
        return _np(out), np.asarray(lab), [_dumps(a) for a in aug.ts]
    out, lab = aug(img, _det_label())
    return _np(out), np.asarray(lab), _dumps(aug)


@pytest.mark.parametrize("name", sorted(DET_AUGMENTERS))
def test_det_augmenters_match_the_reference(name):
    for seed in range(6):
        r, p = _both(lambda m: _run_det(m, DET_AUGMENTERS[name], seed),
                     seed)
        np.testing.assert_array_equal(p[0], r[0])
        np.testing.assert_array_equal(p[1], r[1])
        assert p[2] == r[2]


@pytest.fixture(scope="module")
def det_dir(tmp_path_factory):
    """make_synthetic_det_dataset's files, written by the reference; the
    port's writer must give the same imglist and the same files."""
    d = str(tmp_path_factory.mktemp("det"))
    imglist = mx.test_utils.make_synthetic_det_dataset(d, num_images=20,
                                                      size=48)
    d2 = str(tmp_path_factory.mktemp("det_port"))
    assert tmx.test_utils.make_synthetic_det_dataset(
        d2, num_images=20, size=48) == imglist
    for _, f in imglist:
        with open(os.path.join(d, f), "rb") as a, \
                open(os.path.join(d2, f), "rb") as b:
            assert a.read() == b.read(), f
    return d, imglist


def _batches(it, n=None):
    out = []
    for i, b in enumerate(it):
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        if n is not None and i + 1 == n:
            break
    return out


def _same_batches(r, p):
    assert len(r) == len(p) > 0
    for (rd, rl, rp), (pd, pl, pp) in zip(r, p):
        np.testing.assert_array_equal(pd, rd)
        np.testing.assert_array_equal(pl, rl)
        assert pp == rp


def test_image_det_iter_matches_the_reference(det_dir):
    d, imglist = det_dir

    def run(m):
        it = m.image.ImageDetIter(
            batch_size=6, data_shape=(3, 32, 32), imglist=imglist,
            path_root=d, shuffle=True, rand_mirror=True, rand_crop=0.5,
            rand_pad=0.3, mean=True, std=True)
        assert it.label_shape == (2, 5)
        assert it.provide_label[0].shape == (6, 2, 5)
        first = _batches(it)
        it.reset()
        return first + _batches(it), [_dumps(a) for a in it.auglist]
    r, p = _both(run, 3)
    _same_batches(r[0], p[0])
    assert p[1] == r[1]
    assert r[0][3][2] == 4          # 20 images: the last batch pads 4


def test_image_det_iter_reshape_sync_and_draw(det_dir):
    d, imglist = det_dir
    for m in (mx, tmx):
        a = m.image.ImageDetIter(2, (3, 48, 48), imglist=imglist[:4],
                                 path_root=d)
        b = m.image.ImageDetIter(2, (3, 48, 48), imglist=imglist[4:],
                                 path_root=d)
        a.reshape(label_shape=(1, 5))
        a.sync_label_shape(b)
        assert a.label_shape == b.label_shape == (2, 5)
        with pytest.raises(ValueError):
            a.reshape(label_shape=(3, 4))
        with pytest.raises(m.base.MXNetError):
            a._parse_label([2, 4, 0, 0.1, 0.1, 0.2, 0.2])
    r, p = _both(lambda m: [x for x in m.image.ImageDetIter(
        2, (3, 48, 48), imglist=imglist[:3], path_root=d,
        rand_mirror=True).draw_next(color=(0, 255, 0))], 4)
    assert len(r) == len(p) == 3
    for x, y in zip(p, r):
        np.testing.assert_array_equal(x, y)


def test_image_iter_over_a_record_pack_and_an_imglist(det_dir, tmp_path):
    """ImageIter (classification labels) over a .rec pack that each
    package writes and over an image list file: the same batches."""
    d, imglist = det_dir
    for m, name in ((mx, "ref"), (tmx, "port")):
        rec = m.recordio.MXIndexedRecordIO(str(tmp_path / (name + ".idx")),
                                           str(tmp_path / (name + ".rec")),
                                           "w")
        for i, (lab, f) in enumerate(imglist):
            with open(os.path.join(d, f), "rb") as fh:
                rec.write_idx(i, m.recordio.pack(
                    m.recordio.IRHeader(0, float(lab[2]), i, 0), fh.read()))
        rec.close()
    assert (tmp_path / "ref.rec").read_bytes() == \
        (tmp_path / "port.rec").read_bytes()
    assert (tmp_path / "ref.idx").read_text() == \
        (tmp_path / "port.idx").read_text()
    lst = tmp_path / "images.lst"
    lst.write_text("".join("%d\t%f\t%s\n" % (i, lab[2], f)
                           for i, (lab, f) in enumerate(imglist)))
    for kw in (dict(path_imgrec=str(tmp_path / "port.rec")),
               dict(path_imglist=str(lst), path_root=d),
               dict(path_imgrec=str(tmp_path / "ref.rec"), part_index=1,
                    num_parts=2)):
        r, p = _both(lambda m: _batches(m.image.ImageIter(
            batch_size=4, data_shape=(3, 40, 40), shuffle=True,
            rand_crop=True, rand_mirror=True, mean=True, **kw)), 5)
        _same_batches(r, p)


def test_image_det_iter_without_opencv(det_dir, monkeypatch):
    """With cv2 unimportable: imdecode raises MXNetError, and an
    ImageDetIter fed decoded arrays through read_image / imdecode with a
    resize-free augmenter list gives the reference's batches."""
    images, imglist = tmx.test_utils.synthetic_det_images(20, 48)
    assert imglist == det_dir[1]      # the reference writer's labels

    def hooked(m):
        class ArrayDetIter(m.image.ImageDetIter):
            def read_image(self, fname):
                return images[int(fname[3:7])]

            def imdecode(self, s):
                return m.nd.array(s, dtype="uint8")

        augs = [m.image.DetHorizontalFlipAug(0.5),
                m.image.DetBorrowAug(m.image.CastAug()),
                m.image.DetBorrowAug(m.image.ColorNormalizeAug(
                    np.array([123.68, 116.28, 103.53]),
                    np.array([58.395, 57.12, 57.375])))]
        return _batches(ArrayDetIter(batch_size=8, data_shape=(3, 48, 48),
                                     imglist=imglist, shuffle=True,
                                     aug_list=augs))

    r = _seeded(lambda: hooked(mx), 6)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(tmx.MXNetError, match="cv2 is required"):
        tmx.image.imdecode(b"\xff\xd8")
    with pytest.raises(tmx.MXNetError, match="cv2 is required"):
        tmx.image.imresize(np.zeros((4, 4, 3), np.uint8), 2, 2)
    p = _seeded(lambda: hooked(tmx), 6)
    _same_batches(r, p)


# ---------------------------------------------------------------------------
# RecordIO across the packages
# ---------------------------------------------------------------------------

def _write(m, path, idx_path, records):
    if idx_path is None:
        w = m.recordio.MXRecordIO(path, "w")
        for rec in records:
            w.write(rec)
    else:
        w = m.recordio.MXIndexedRecordIO(idx_path, path, "w")
        for i, rec in enumerate(records):
            w.write_idx(i * 3, rec)
    w.close()


def _read(m, path, idx_path, n):
    if idx_path is None:
        r = m.recordio.MXRecordIO(path, "r")
        out = [r.read() for _ in range(n)]
        assert r.read() is None
    else:
        r = m.recordio.MXIndexedRecordIO(idx_path, path, "r")
        assert r.keys == [i * 3 for i in range(n)]
        out = [r.read_idx(k) for k in reversed(r.keys)][::-1]
    r.close()
    return out


@pytest.mark.parametrize("indexed", [False, True])
def test_recordio_files_cross_the_packages(tmp_path, indexed):
    img = _img(2, 16, 16)
    records = [b"", b"a", b"abcd", b"x" * 1023]
    records += [m.recordio.pack(m.recordio.IRHeader(0, 3.5, 7, 0), b"pay")
                for m in (mx,)]
    records += [mx.recordio.pack(mx.recordio.IRHeader(
        0, np.array([1, 2.5, -3], np.float32), 9, 1), b"lbl")]
    records += [mx.recordio.pack_img((0, 1.0, 2, 0), img, img_fmt=".png")]
    for writer, reader in ((mx, tmx), (tmx, mx)):
        base = tmp_path / ("%s_%s" % (writer.__name__, indexed))
        path, idx = str(base) + ".rec", (str(base) + ".idx" if indexed
                                         else None)
        _write(writer, path, idx, records)
        assert _read(reader, path, idx, len(records)) == records
    a = (tmp_path / ("mxnet_tpu_%s.rec" % indexed)).read_bytes()
    b = (tmp_path / ("mxnet_tpu_torch_%s.rec" % indexed)).read_bytes()
    assert a == b
    for rec in records[4:]:
        rh, rp = mx.recordio.unpack(rec)
        ph, pp = tmx.recordio.unpack(rec)
        assert pp == rp and ph.id == rh.id and ph.flag == rh.flag
        np.testing.assert_array_equal(np.asarray(ph.label),
                                      np.asarray(rh.label))
    for m in (mx, tmx):
        assert m.recordio.pack(m.recordio.IRHeader(
            3, np.array([1, 2.5, -3], np.float32), 9, 1), b"lbl") == \
            records[5]
        h, out = m.recordio.unpack_img(records[6])
        np.testing.assert_array_equal(out, img)
        assert tmx.recordio.pack_img((0, 1.0, 2, 0), img, img_fmt=".png") \
            == records[6]


# ---------------------------------------------------------------------------
# gluon.data: RecordFileDataset, ImageRecordDataset, ImageFolderDataset
# ---------------------------------------------------------------------------

def test_record_and_image_datasets_match_the_reference(det_dir, tmp_path):
    d, imglist = det_dir
    rec = mx.recordio.MXIndexedRecordIO(str(tmp_path / "d.idx"),
                                        str(tmp_path / "d.rec"), "w")
    for i, (lab, f) in enumerate(imglist[:6]):
        with open(os.path.join(d, f), "rb") as fh:
            rec.write_idx(i, mx.recordio.pack(
                mx.recordio.IRHeader(0, np.asarray(lab, np.float32), i, 0),
                fh.read()))
    rec.close()
    folder = tmp_path / "folder"
    for cls in ("cat", "dog"):
        (folder / cls).mkdir(parents=True)
    (folder / "readme.txt").write_text("not a class")
    for i, (_, f) in enumerate(imglist[:5]):
        os.link(os.path.join(d, f), folder / ("cat", "dog")[i % 2] / f)
    (folder / "dog" / "notes.txt").write_text("skipped")

    rd = mx.gluon.data.RecordFileDataset(str(tmp_path / "d.rec"))
    pd = tmx.gluon.data.RecordFileDataset(str(tmp_path / "d.rec"))
    assert len(pd) == len(rd) == 6
    assert [pd[i] for i in range(6)] == [rd[i] for i in range(6)]
    for make in (
            lambda m: m.gluon.data.vision.ImageRecordDataset(
                str(tmp_path / "d.rec")),
            lambda m: m.gluon.data.vision.ImageRecordDataset(
                str(tmp_path / "d.rec"), flag=0,
                transform=lambda x, y: (x, y[2:4])),
            lambda m: m.gluon.data.vision.ImageFolderDataset(str(folder)),
            lambda m: m.gluon.data.vision.ImageFolderDataset(
                str(folder), transform=lambda x, y: (x, y + 10))):
        r, p = make(mx), make(tmx)
        assert len(p) == len(r) > 0
        for i in range(len(r)):
            (rx, ry), (px, py) = r[i], p[i]
            np.testing.assert_array_equal(_np(px), _np(rx))
            np.testing.assert_array_equal(np.asarray(py), np.asarray(ry))
    assert tmx.gluon.data.vision.ImageFolderDataset(str(folder)).synsets \
        == ["cat", "dog"]
