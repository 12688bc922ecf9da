"""Build and load the port's CUDA kernels.

A source under `csrc/` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with ctypes. The library goes
to `mxnet_tpu_torch/_build/` (listed in .gitignore), named by a hash of
the source and the flags, so a changed source rebuilds and an unchanged
one loads at once. Nothing is built when a module is imported: the first
`library()` call of a source builds it. Each source has its own lock, so
two sources build at once when two threads ask for them.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading

from ..base import MXNetError

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v")

_lock = threading.Lock()      # guards _locks
_locks = {}                   # source -> lock held while it builds/loads
_libs = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME
    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise MXNetError("nvcc not found (CUDA_HOME=%r): the CUDA toolkit "
                         "is needed to build the port's kernels"
                         % (CUDA_HOME,))
    return path


def target(source):
    """(library path, build log path) of one source at the current flags;
    the log holds nvcc's output, register and spill counts included."""
    with open(os.path.join(_CSRC, source), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = "%s-%s" % (os.path.splitext(source)[0], digest.hexdigest()[:12])
    return (os.path.join(BUILD_DIR, stem + ".so"),
            os.path.join(BUILD_DIR, stem + ".log"))


def _build(source, path, log):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    with open(log, "w") as fh:
        rc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, source)],
            stdout=fh, stderr=subprocess.STDOUT).returncode
    if rc != 0:
        with open(log) as f:
            raise MXNetError("kernel build of %s failed (nvcc exit %d):\n%s"
                             % (source, rc, f.read()))
    os.replace(tmp, path)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_float
#: C entry -> (argtypes, restype). Every pointer and the stream are
#: c_void_p: a Python int passed bare would be cut to 32 bits.
_SIGNATURES = {
    "mxtt_bn_stats": ([_I, _P, _L, _L, _L, _I, _F, _P, _P, _P, _P], _I),
    "mxtt_bn_apply": ([_I, _P, _P, _P, _P, _P, _L, _L, _L, _I, _P], _I),
    "mxtt_bn_bwd_reduce": ([_I, _P, _P, _P, _P, _P, _P, _L, _L, _L, _I, _P,
                           _P, _P, _P], _I),
    "mxtt_bn_bwd_dx": ([_I, _P, _P, _P, _P, _P, _P, _L, _L, _L, _P], _I),
    "mxtt_bn_reduce_max_clusters": ([_I, _I, _I], _I),
    "mxtt_paged_attention": ([_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                              _I, _I, _I, _I, _I, _F, _P], _I),
    "mxtt_paged_smem_bytes": ([_I, _I, _I, _I], ctypes.c_longlong),
    "mxtt_flash_fwd": ([_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                        _P], _I),
    "mxtt_flash_fwd_smem_bytes": ([_I, _I], ctypes.c_longlong),
    "mxtt_flash_bwd": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _F, _I, _P], _I),
    "mxtt_rnn_fwd": ([_I, _I] + [_P] * 8 + [_I] * 6 + [_P], _I),
    "mxtt_rnn_bwd": ([_I, _I] + [_P] * 14 + [_I] * 6 + [_P], _I),
    "mxtt_rnn_floor": ([_I] * 7 + [_P], _I),
    "mxtt_rnn_smem_bytes": ([_I] * 6, ctypes.c_longlong),
    "mxtt_rnn_max_clusters": ([_I] * 6, _I),
    "mxtt_error_string": ([_I], ctypes.c_char_p),
}


def _declare(lib):
    for name, (argtypes, restype) in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype


def library(source):
    """The loaded library of one source, built on first use."""
    with _lock:
        lock = _locks.setdefault(source, threading.Lock())
    with lock:
        lib = _libs.get(source)
        if lib is None:
            path, log = target(source)
            if not os.path.exists(path):
                _build(source, path, log)
            lib = ctypes.CDLL(path)
            _declare(lib)
            _libs[source] = lib
    return lib


#: set while `predict.export_train_step` traces a step with make_fx, which
#: torch.compiler.is_exporting() does not report
_TRACING = threading.local()


@contextlib.contextmanager
def tracing_step():
    """Within the block `refuse_export` refuses as under torch.export."""
    prev = getattr(_TRACING, "on", False)
    _TRACING.on = True
    try:
        yield
    finally:
        _TRACING.on = prev


def refuse_export(kernel, hint=""):
    """Raise while `torch.export` traces (or `tracing_step` is on): this
    kernel launches through ctypes, which cannot take the tracer's fake
    tensors, and its plain version would stand in for it in the exported
    graph without a word. Only K4a, a torch.library op
    (`mxnet_tpu_torch::rnn_fwd`), stays in an exported graph; K1-K3 sit on
    no path that `predict.export_model` takes, and K4b (the op's backward)
    on none that `export_train_step` can hold, so a graph that reaches one
    is refused here, naming it (and `hint`, what to export instead)."""
    import torch
    if torch.compiler.is_exporting() or getattr(_TRACING, "on", False):
        raise MXNetError(
            "export: the graph reaches %s, a kernel launched through "
            "ctypes that an exported program cannot hold (only the fused "
            "RNN forward, K4a, is an exportable op)%s"
            % (kernel, "; " + hint if hint else ""))


def check(lib, err, what):
    """Raise when a C entry returned a CUDA error."""
    if err != 0:
        raise MXNetError("%s failed: CUDA error %d (%s)" % (
            what, err, lib.mxtt_error_string(err).decode()))
