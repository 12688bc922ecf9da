"""The port's native runtime (mxnet_tpu_torch/native/: its own ctypes
loader of the unchanged native/mxtpu_native.cc, built into
mxnet_tpu_torch/_build/) and the image record iterators of io.py, on the
CPU.

The engine cases are the reference's (tests/test_native.py); recordio
packs cross both ways between the native reader / writer and the port's
recordio.py; the native route's decode is held to PIL within 4.0 (the
reference test's criterion), the Python route (num_parts=2) to the JAX
reference's image.ImageIter on the same pack. The reference's own
ImageRecordIter is not called: importing mxnet_tpu.native runs g++ into
native/ (ROADMAP queue 3's race).
"""
import io as pyio
import os
import threading
import time

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import native
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def test_builds_under_build_not_beside_the_source():
    assert native.available() and native.AVAILABLE
    path = native.target()
    assert os.path.exists(path)
    assert os.path.basename(os.path.dirname(path)) == "_build"
    assert os.path.basename(path).startswith("native-")
    assert native.build_error() is None


def test_engine_runs_every_task():
    eng = native.NativeEngine(4)
    got, lock = [], threading.Lock()
    for i in range(50):
        def fn(i=i):
            with lock:
                got.append(i)
        eng.push(fn)
    eng.wait_all()
    eng.close()
    assert sorted(got) == list(range(50))


def test_engine_serializes_writers():
    eng = native.NativeEngine(8)
    var = eng.new_var()
    state = {"v": 0, "now": 0, "most": 0}
    lock = threading.Lock()

    def writer():
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
        time.sleep(0.001)
        state["v"] += 1
        with lock:
            state["now"] -= 1

    for _ in range(40):
        eng.push(writer, write_vars=[var])
    eng.wait_all()
    eng.close()
    assert state["v"] == 40 and state["most"] == 1


def test_engine_orders_reads_around_a_write():
    eng = native.NativeEngine(8)
    var = eng.new_var()
    log, lock = [], threading.Lock()

    def reader(i):
        time.sleep(0.002)
        with lock:
            log.append(("r", i))

    def writer():
        with lock:
            log.append(("w", None))

    for i in range(6):
        eng.push(lambda i=i: reader(i), read_vars=[var])
    eng.push(writer, write_vars=[var])
    for i in range(6, 12):
        eng.push(lambda i=i: reader(i), read_vars=[var])
    eng.wait_all()
    eng.close()
    w = [k for k, (kind, _) in enumerate(log) if kind == "w"][0]
    assert {i for kind, i in log[:w]} == set(range(6))
    assert {i for kind, i in log[w + 1:]} == set(range(6, 12))


def test_engine_write_chain_runs_in_push_order():
    eng = native.NativeEngine(8)
    var = eng.new_var()
    seq = []
    for i in range(20):
        eng.push(lambda i=i: seq.append(i), write_vars=[var])
    eng.wait_all()
    eng.close()
    assert seq == list(range(20))


@pytest.mark.parametrize("writer", ["native", "python"])
def test_recordio_crosses_both_ways(tmp_path, writer):
    """A pack the native writer makes reads back through the port's
    recordio.py, and the other way round, record for record."""
    path = str(tmp_path / "x.rec")
    records = [b"payload-%03d" % i + b"x" * i for i in range(10)]
    if writer == "native":
        w = native.RecWriter(path)
    else:
        w = tmx.recordio.MXRecordIO(path, "w")
    for r in records:
        w.write(r)
    w.close()
    if writer == "native":
        r = tmx.recordio.MXRecordIO(path, "r")
    else:
        r = native.RecReader(path)
    assert [r.read() for _ in records] == records
    assert r.read() is None
    r.close()


def test_missing_library_raises(monkeypatch):
    """No fallback: with the build failed, every native object raises with
    the build's output, and AVAILABLE reads False."""
    monkeypatch.setitem(native._state, "lib", None)
    monkeypatch.setitem(native._state, "error", "g++ exit 1: no jpeglib.h")
    assert not native.AVAILABLE
    for make in (lambda: native.NativeEngine(1),
                 lambda: native.RecWriter("unused.rec"),
                 lambda: native.NativeImageIter("unused.rec", 1, (3, 4, 4))):
        with pytest.raises(MXNetError, match="no jpeglib.h"):
            make()


def _jpeg(arr, quality=95):
    from PIL import Image
    buf = pyio.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _pack(path, n=12, size=(16, 16)):
    """n JPEGs that PIL encodes, labels i % 4, with the pack's .idx."""
    rng = np.random.RandomState(0)
    w = tmx.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                       path, "w")
    jpgs = []
    for i in range(n):
        arr = rng.randint(0, 255, size + (3,)).astype(np.uint8)
        jpgs.append(_jpeg(arr))
        w.write_idx(i, tmx.recordio.pack(
            tmx.recordio.IRHeader(0, float(i % 4), i, 0), jpgs[-1]))
    w.close()
    return jpgs


def test_native_route_decodes_as_pil(tmp_path):
    """ImageRecordIter's native route (RGB, one part): every image within
    4.0 of PIL's decode of the same JPEG, the labels in order, a ragged
    last batch padded, batches on the context asked for."""
    from PIL import Image
    rec = str(tmp_path / "p.rec")
    jpgs = _pack(rec, n=10)
    it = tmx.io.ImageRecordIter(path_imgrec=rec, batch_size=4,
                                data_shape=(3, 16, 16), ctx=tmx.cpu())
    assert type(it.iters[0]).__name__ == "NativeImageRecordIter"
    got, labels, pads = [], [], []
    for b in it:
        assert b.data[0].context == tmx.cpu()
        n = 4 - b.pad
        got.extend(b.data[0].asnumpy()[:n])
        labels.extend(b.label[0].asnumpy()[:n].tolist())
        pads.append(b.pad)
    it.close()
    assert pads == [0, 0, 2] and labels == [float(i % 4) for i in range(10)]
    for img, jpg in zip(got, jpgs):
        ref = np.asarray(Image.open(pyio.BytesIO(jpg))).astype(np.float32)
        assert np.abs(img.transpose(1, 2, 0) - ref).max() <= 4.0


def test_python_route_equals_the_references_image_iter(tmp_path):
    """num_parts=2 takes the Python route: its batches equal the JAX
    reference's image.ImageIter over the same pack and part."""
    import mxnet_tpu as mx
    rec = str(tmp_path / "q.rec")
    _pack(rec, n=12)
    it = tmx.io.ImageRecordIter(path_imgrec=rec, batch_size=3,
                                data_shape=(3, 16, 16), num_parts=2,
                                part_index=1, ctx=tmx.cpu())
    assert type(it.iters[0]).__name__ == "_OnContext"
    ref = mx.image.ImageIter(batch_size=3, data_shape=(3, 16, 16),
                             path_imgrec=rec, num_parts=2, part_index=1)
    got = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in it]
    want = [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in ref]
    it.close()
    assert len(got) == len(want) == 2
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
