"""The C++ deployment half (port of the reference's `cpp-package/`).

The reference's C++ side dlopens a PJRT plugin and compiles an artifact's
StableHLO in C++. Here Inductor compiles in Python
(`predict.compile_for_cpp`, or `predict.export_train_step`), the artifact
carries the AOTInductor package of each device it was compiled for
(`aoti/cuda.pt2`, `aoti/cpu.pt2`), and the C++ runs it on libtorch:

- `include/mxtpu/predictor.hpp`, `src/predictor.cc`: `mxtpu::Predictor`
  (forward, and the training artifact's load_state / train_step /
  read_state with the state kept on the device);
- `include/mxtpu/c_predict_api.h`, `src/c_predict_api.cc` ->
  `libmxtpu_predict.so`: the reference's 13 C functions;
- `src/predict_cli.cc` -> `mxtpu_predict`, `src/train_cli.cc` ->
  `mxtpu_train`;
- `src/rnn_op.cc` -> `libmxtpu_torch_ops.so`: K4a as the op
  `mxnet_tpu_torch::rnn_fwd` for the packages that hold it, launching
  `ops/csrc/fused_rnn.cu` on CUDA tensors (the library `ops/_cuda.py`
  builds with nvcc) and a plain ATen scan on CPU tensors.

`build(device)` compiles them with g++ against torch's own headers and
libraries (C++20, torch's C++ ABI, rpaths to torch's libraries and to the
build), into `mxnet_tpu_torch/_build/cpp-<device>-<hash of the sources,
flags and torch>/`, at first use and never at import. Builds from several
processes at once take a file lock; each builds in a directory of its own
and renames it into place. `device="cpu"` builds the tree without CUDA;
a CUDA build without nvcc, or against a torch without CUDA, raises.

The libraries link libtorch, and `libmxtpu_torch_ops.so` registers the
namespace `mxnet_tpu_torch` that `ops/fused_rnn.py` registers in Python:
load neither into a Python process that imported the port. Drive them
through the binaries or from a process of their own.
"""
from __future__ import annotations

import collections
import concurrent.futures
import fcntl
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..base import MXNetError

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("src/predictor.cc", "src/c_predict_api.cc", "src/predict_cli.cc",
           "src/train_cli.cc", "src/rnn_op.cc")
HEADERS = ("include/mxtpu/predictor.hpp", "include/mxtpu/c_predict_api.h")
CXXFLAGS = ("-std=c++20", "-O2", "-fPIC")

#: a finished build: its directory, device ("cuda" or "cpu"), the two
#: libraries and the two binaries
Build = collections.namedtuple(
    "Build", "dir device predict_lib ops_lib mxtpu_predict mxtpu_train")

_PRODUCTS = ("libmxtpu_predict.so", "libmxtpu_torch_ops.so",
             "mxtpu_predict", "mxtpu_train")


def _torch_paths(cuda):
    """(include dirs, torch's library dir, the libraries to link) after
    the checks a CUDA build needs."""
    import torch
    from torch.utils import cpp_extension
    includes = list(cpp_extension.include_paths())
    lib_dir = cpp_extension.library_paths()[0]
    libs = ["torch", "torch_cpu", "c10"]
    if cuda:
        if torch.version.cuda is None:
            raise MXNetError("cpp_package.build(device='cuda'): this torch "
                             "(%s) is built without CUDA; build with "
                             "device='cpu'" % torch.__version__)
        from ..ops import _cuda
        nvcc = _cuda._nvcc()  # raises, naming the missing toolkit
        for lib in ("torch_cuda", "c10_cuda"):
            if not os.path.exists(os.path.join(lib_dir, "lib%s.so" % lib)):
                raise MXNetError("cpp_package.build(device='cuda'): lib%s.so "
                                 "is missing from %s" % (lib, lib_dir))
        includes.append(os.path.join(os.path.dirname(os.path.dirname(nvcc)),
                                     "include"))
        libs += ["torch_cuda", "c10_cuda"]
    return includes, lib_dir, libs


def _flags(cuda, includes):
    import torch
    return list(CXXFLAGS) + [
        "-D_GLIBCXX_USE_CXX11_ABI=%d" % int(torch._C._GLIBCXX_USE_CXX11_ABI),
        "-I" + os.path.join(HERE, "include")] + \
        ["-I" + p for p in includes] + (["-DMXTPU_WITH_CUDA"] if cuda else [])


def _digest(cuda, flags):
    import torch
    h = hashlib.sha256()
    for rel in SOURCES + HEADERS:
        with open(os.path.join(HERE, rel), "rb") as f:
            h.update(rel.encode() + f.read())
    h.update(" ".join(flags).encode() + torch.__version__.encode())
    if cuda:
        from ..ops import _cuda
        h.update(os.path.basename(_cuda.target("fused_rnn.cu")[0]).encode())
    return h.hexdigest()[:12]


def _run(cmd, cwd, log):
    """Run one compiler command, its output appended to `log`; raises with
    the output when it fails."""
    p = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    with open(log, "a") as f:
        f.write("$ %s\n%s%s" % (" ".join(cmd), p.stdout, p.stderr))
    if p.returncode != 0:
        raise MXNetError("cpp_package build failed (exit %d):\n$ %s\n%s%s"
                         % (p.returncode, " ".join(cmd), p.stdout,
                            p.stderr[-8000:]))


def _compile_tree(work, cuda, flags, lib_dir, libs, src_dir=HERE):
    """Compile and link every product of the sources under `src_dir` into
    `work`."""
    log = os.path.join(work, "build.log")
    if cuda:
        # K4a's kernels: the library ops/_cuda.py builds with nvcc, under a
        # name the linker can take
        from ..ops import _cuda
        _cuda.library("fused_rnn.cu")
        shutil.copy(_cuda.target("fused_rnn.cu")[0],
                    os.path.join(work, "libmxtt_fused_rnn.so"))
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        jobs = [pool.submit(_run, ["g++", *flags, "-c",
                                   os.path.join(src_dir, src), "-o",
                                   os.path.basename(src)[:-3] + ".o"],
                            work, log) for src in SOURCES]
        for job in jobs:
            job.result()
    rpath = "-Wl,-rpath,$ORIGIN:" + lib_dir
    torch_libs = ["-L" + lib_dir, "-Wl,--no-as-needed"] + \
        ["-l" + n for n in libs]
    here = ["-L" + work, "-Wl,--no-as-needed"]
    _run(["g++", "-shared", "rnn_op.o", "-o", "libmxtpu_torch_ops.so", rpath]
         + here + (["-lmxtt_fused_rnn"] if cuda else []) + torch_libs,
         work, log)
    _run(["g++", "-shared", "predictor.o", "c_predict_api.o", "-o",
          "libmxtpu_predict.so", rpath] + here + ["-lmxtpu_torch_ops"]
         + torch_libs, work, log)
    for cli, obj in (("mxtpu_predict", "predict_cli.o"),
                     ("mxtpu_train", "train_cli.o")):
        _run(["g++", obj, "-o", cli, rpath] + here
             + ["-lmxtpu_predict", "-lmxtpu_torch_ops"] + torch_libs,
             work, log)


def build(device="cuda"):
    """Build (once) the C++ tree for `device` ("cuda" or "cpu") and return
    its `Build`. Raises, naming what is missing, for a CUDA build without
    nvcc or CUDA, and with g++'s output when a step fails."""
    device = str(device).split(":")[0]
    if device not in ("cuda", "cpu"):
        raise MXNetError("cpp_package.build: device must be 'cuda' or "
                         "'cpu', got %r" % (device,))
    cuda = device == "cuda"
    if shutil.which("g++") is None:
        raise MXNetError("cpp_package.build: g++ not found")
    includes, lib_dir, libs = _torch_paths(cuda)
    flags = _flags(cuda, includes)
    from ..ops._cuda import BUILD_DIR
    final = os.path.join(BUILD_DIR, "cpp-%s-%s" % (device,
                                                   _digest(cuda, flags)))
    if not all(os.path.exists(os.path.join(final, p)) for p in _PRODUCTS):
        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(final + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.isdir(final):
                work = "%s.tmp-%d" % (final, os.getpid())
                shutil.rmtree(work, ignore_errors=True)
                os.makedirs(work)
                try:
                    _compile_tree(work, cuda, flags, lib_dir, libs)
                    os.rename(work, final)
                finally:
                    shutil.rmtree(work, ignore_errors=True)
    return Build(final, device, *(os.path.join(final, p)
                                  for p in _PRODUCTS))


# ---------------------------------------------------------------------------
# mxtpu_train's synthetic batches, rebuilt bit for bit
# ---------------------------------------------------------------------------

_MUL, _INC, _MASK = 6364136223846793005, 1442695040888963407, (1 << 64) - 1


def lcg_batch(step, x_shape, y_shape, y_dtype="int32", num_classes=10):
    """The (x, y) that `mxtpu_train` feeds at step `step` (1-based): an LCG
    seeded with the step (the reference's train_cli.cc constants), x
    float32 uniform in [-1, 1), then y the draws mod `num_classes` in
    `y_dtype` (a float label slot gets the class index as a float)."""
    s = (step * _MUL + 1) & _MASK
    nx, ny = int(np.prod(x_shape)), int(np.prod(y_shape))
    draws = np.empty(nx + ny, np.uint64)
    for i in range(nx + ny):
        s = (s * _MUL + _INC) & _MASK
        draws[i] = s >> 33
    x = (draws[:nx].astype(np.float32) / np.float32(2147483648.0)
         - np.float32(1.0)).astype(np.float32)
    y = (draws[nx:] % np.uint64(num_classes)).astype(y_dtype)
    return x.reshape(x_shape), y.reshape(y_shape)
