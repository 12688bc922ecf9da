"""ctypes bindings to the native C++ runtime (port of
`mxnet_tpu/native/__init__.py`).

The runtime is the repository's `native/mxtpu_native.cc`, read as it is:
it is host code (threads, file I/O, libjpeg), the same for either
package. Its pieces:
  NativeEngine      a threaded dependency engine (the var-queue protocol)
  RecWriter/Reader  recordio framing, compatible with recordio.py
  NativeImageIter   parallel JPEG decode + augment + batch (the
                    ImageRecordIter hot loop)

The port builds the source with g++ at first use, never at import, into
`mxnet_tpu_torch/_build/native-<hash of the source and flags>.so` (the
reference builds beside the source, into `native/libmxtpu_native.so`);
several processes building at once take a file lock, and each writes a
file of its own that it renames into place. `AVAILABLE` (read as an
attribute) or `available()` builds and reports whether the library
loaded; asking for a native object when it did not raises with g++'s
output (the source includes jpeglib.h, so a host without libjpeg's
headers cannot build it).
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..base import MXNetError

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native", "mxtpu_native.cc")
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_state = {"lib": None, "error": None}


def target():
    """The library's path at the current source and flags."""
    from ..ops._cuda import BUILD_DIR
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, "native-%s.so" % digest.hexdigest()[:12])


def _build(path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return None
        tmp = "%s.%d.tmp" % (path, os.getpid())
        try:
            p = subprocess.run(["g++", *FLAGS, "-o", tmp, _SRC, *LIBS],
                               capture_output=True, text=True)
        except FileNotFoundError as e:
            return "g++ not found: %s" % e
        if p.returncode != 0:
            return "g++ exit %d:\n%s%s" % (p.returncode, p.stdout, p.stderr)
        os.replace(tmp, path)
    return None


def _declare(lib):
    P, I, L, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_uint64
    sigs = {
        "EngineCreate": ([I], P), "EngineFree": ([P], None),
        "EngineNewVar": ([P], P),
        "EnginePush": ([P, P, P, ctypes.POINTER(P), I, ctypes.POINTER(P), I,
                        U], None),
        "EngineWaitAll": ([P], None), "EngineOutstanding": ([P], L),
        "EngineDrainDone": ([P, ctypes.POINTER(U), L], L),
        "RecWriterCreate": ([ctypes.c_char_p], P),
        "RecWriterTell": ([P], L),
        "RecWriterWrite": ([P, ctypes.c_char_p, U], None),
        "RecWriterClose": ([P], None),
        "RecReaderCreate": ([ctypes.c_char_p], P),
        "RecReaderSeek": ([P, L], None), "RecReaderTell": ([P], L),
        "RecReaderRead": ([P, ctypes.POINTER(ctypes.c_char_p)], L),
        "RecReaderClose": ([P], None),
        "ImgIterCreate": ([ctypes.c_char_p] + [I] * 8 + [ctypes.c_uint], P),
        "ImgIterSize": ([P], L), "ImgIterReset": ([P], None),
        "ImgIterNext": ([P, ctypes.POINTER(ctypes.c_float),
                         ctypes.POINTER(ctypes.c_float)], I),
        "ImgIterFree": ([P], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def _load():
    with _lock:
        if _state["lib"] is None and _state["error"] is None:
            path = target()
            err = None if os.path.exists(path) else _build(path)
            if err is None:
                try:
                    lib = ctypes.CDLL(path)
                    _declare(lib)
                    _state["lib"] = lib
                except OSError as e:
                    err = "cannot load %s: %s" % (path, e)
            _state["error"] = err
    return _state["lib"]


def available():
    """Whether the native library built and loaded (built on first ask)."""
    return _load() is not None


def build_error():
    """g++'s output when the build failed, else None."""
    _load()
    return _state["error"]


def _library():
    lib = _load()
    if lib is None:
        raise MXNetError("the native runtime is unavailable: the build of "
                         "%s failed: %s" % (_SRC, _state["error"]))
    return lib


def __getattr__(name):
    if name == "AVAILABLE":
        return available()
    raise AttributeError(name)


_ENGINE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _env_nthreads(num_threads):
    """An explicit count wins; otherwise MXNET_CPU_WORKER_NTHREADS sizes
    the pool, 0 falling through to the hardware's count in C++. A bad
    value is ignored with the variable named."""
    if num_threads > 0:
        return num_threads
    raw = os.environ.get("MXNET_CPU_WORKER_NTHREADS", "0")
    try:
        return int(raw)
    except ValueError:
        import warnings
        warnings.warn("ignoring non-integer MXNET_CPU_WORKER_NTHREADS=%r"
                      % raw)
        return 0


class _Handle:
    """A native object freed once, by `close()` or at collection."""

    _free = None

    def close(self):
        if getattr(self, "_h", None):
            getattr(self._lib, self._free)(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeEngine(_Handle):
    """Threaded dependency engine (Engine::PushAsync semantics): Python
    callables run on C++ worker threads; vars serialize writers and share
    readers."""

    _free = "EngineFree"
    _DRAIN_BUF_CAP = 1024

    def __init__(self, num_threads=0):
        self._lib = _library()
        self._h = self._lib.EngineCreate(_env_nthreads(num_threads))
        self._keepalive = {}
        self._token = 0
        self._drain_buf = (ctypes.c_uint64 * self._DRAIN_BUF_CAP)()

    def new_var(self):
        return self._lib.EngineNewVar(self._h)

    def _drain_done(self):
        # free the callbacks that have returned: the C++ side records a
        # token only after its callback returned, so a closure is never
        # freed while a worker still runs it
        while True:
            n = self._lib.EngineDrainDone(self._h, self._drain_buf,
                                          self._DRAIN_BUF_CAP)
            for i in range(n):
                self._keepalive.pop(self._drain_buf[i], None)
            if n < self._DRAIN_BUF_CAP:
                break

    def push(self, fn, read_vars=(), write_vars=()):
        self._drain_done()
        token = self._token
        self._token += 1

        def trampoline(_arg):
            fn()

        cb = _ENGINE_CB(trampoline)
        self._keepalive[token] = cb
        n_r, n_w = len(read_vars), len(write_vars)
        r = (ctypes.c_void_p * max(n_r, 1))(*read_vars)
        w = (ctypes.c_void_p * max(n_w, 1))(*write_vars)
        self._lib.EnginePush(self._h, ctypes.cast(cb, ctypes.c_void_p), None,
                             r, n_r, w, n_w, token)

    def wait_all(self):
        self._lib.EngineWaitAll(self._h)
        self._drain_done()


class RecWriter(_Handle):
    _free = "RecWriterClose"

    def __init__(self, path):
        self._lib = _library()
        self._h = self._lib.RecWriterCreate(path.encode())
        if not self._h:
            raise IOError("cannot open %s" % path)

    def tell(self):
        return self._lib.RecWriterTell(self._h)

    def write(self, buf):
        self._lib.RecWriterWrite(self._h, buf, len(buf))


class RecReader(_Handle):
    _free = "RecReaderClose"

    def __init__(self, path):
        self._lib = _library()
        self._h = self._lib.RecReaderCreate(path.encode())
        if not self._h:
            raise IOError("cannot open %s" % path)

    def seek(self, pos):
        self._lib.RecReaderSeek(self._h, pos)

    def tell(self):
        return self._lib.RecReaderTell(self._h)

    def read(self):
        data = ctypes.c_char_p()
        n = self._lib.RecReaderRead(self._h, ctypes.byref(data))
        if n < 0:
            return None
        return ctypes.string_at(data, n)


class NativeImageIter(_Handle):
    """Parallel JPEG decode pipeline over a .rec file
    (ImageRecordIOParser2). Yields (data[batch, c, h, w] float32,
    label[batch] float32, n)."""

    _free = "ImgIterFree"

    def __init__(self, rec_path, batch_size, data_shape, shuffle=False,
                 num_threads=0, rand_crop=False, rand_mirror=False, seed=0):
        self._lib = _library()
        c, h, w = data_shape
        self.batch_size = batch_size
        self.data_shape = data_shape
        self._h = self._lib.ImgIterCreate(
            rec_path.encode(), batch_size, h, w, c, int(shuffle),
            _env_nthreads(num_threads), int(rand_crop), int(rand_mirror),
            seed)
        if not self._h:
            raise IOError("cannot open %s" % rec_path)
        self._data = np.empty((batch_size, c, h, w), np.float32)
        self._label = np.empty((batch_size,), np.float32)

    def __len__(self):
        return int(self._lib.ImgIterSize(self._h))

    def reset(self):
        self._lib.ImgIterReset(self._h)

    def next_batch(self, out=None):
        """(data, label, n) of the next batch, None at the end. The data
        lands in `out` (a float32 array of the batch's shape, e.g. a pinned
        host buffer's numpy view) when given, else in a copy of the
        internal buffer, which the next call refills."""
        data = self._data if out is None else out
        n = self._lib.ImgIterNext(
            self._h, data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._label.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if n == 0:
            return None
        return (data.copy() if out is None else data), self._label.copy(), n
