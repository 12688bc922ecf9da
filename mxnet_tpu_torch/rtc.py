"""Runtime compilation of user CUDA kernels (port of `mxnet_tpu/rtc.py`).

Parity: the reference MXNet's NVRTC runtime kernels (`src/common/rtc.cc`,
`python/mxnet/rtc.py` CudaModule / CudaKernel), which the JAX package
cites as its parity target. There a user kernel is a Pallas body run by
`pl.pallas_call` (`mxnet_tpu/rtc.py:18`, the call at :46) and
`CudaModule` is a stub that raises; here it is the other way round:

    mod = CudaModule(source, options=(), exports=())
    k = mod.get_kernel("axpy", "const float *x, float *y, float a, int n")
    k.launch([x, y, 2.0, n], mx.gpu(0), (blocks, 1, 1), (256, 1, 1),
             shared_mem=0)

`CudaModule` compiles `source` with NVRTC (loaded through ctypes) for
`sm_90a` into a CUBIN, with `$CUDA_HOME/include` on the include path; a
failed compile raises with NVRTC's log, and a machine without libnvrtc
raises naming it. `exports` names kernels that are not `extern "C"`
(their lowered names are looked up, as upstream does). The CUBIN is
loaded through libcuda (`cuModuleLoadData`, in torch's primary
context of each device it launches on), and `CudaKernel.launch` calls
`cuLaunchKernel` on torch's current stream of that device. What repeats
on every launch is kept to the checks and the call: the primary context
is made current only when the thread's current one is another, and
`cuFuncSetAttribute` (the opt-in to dynamic shared memory, which past 48
KB less the kernel's static shared memory a launch needs) is called only
when a launch's dynamic shared memory passes the most this function was
opted in to on that device. It
checks every argument against the C signature first: a dense NDArray
for each pointer, of the pointer's dtype; a number for each scalar; a GPU
context and GPU arrays (a CPU context or a CPU array raises: a CUDA
kernel has no CPU version). Pointers travel as `c_void_p` and scalars as
their own ctypes type. Each launch adds one to its kernel's `launches`.
What bounds a user kernel is the user's source; nothing here adds work
to it but the launch itself.

`PallasModule`, the reference's TPU route, raises, naming `CudaModule`.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import re
import threading

import torch

from .base import MXNetError
from .ndarray import NDArray

#: the target every user kernel is compiled for (the H100's full ISA)
ARCH = "sm_90a"
_CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES = 8

#: C type -> (torch dtype of an array argument, ctypes type of a scalar)
_C_TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, None), "half": (torch.float16, None),
    "__nv_bfloat16": (torch.bfloat16, None),
    "nv_bfloat16": (torch.bfloat16, None),
    "int": (torch.int32, ctypes.c_int32),
    "int32_t": (torch.int32, ctypes.c_int32),
    "unsigned": (None, ctypes.c_uint32),
    "unsigned int": (None, ctypes.c_uint32),
    "uint32_t": (None, ctypes.c_uint32),
    "long long": (torch.int64, ctypes.c_int64),
    "int64_t": (torch.int64, ctypes.c_int64),
    "size_t": (None, ctypes.c_uint64),
    "short": (torch.int16, ctypes.c_int16),
    "int16_t": (torch.int16, ctypes.c_int16),
    "char": (torch.int8, ctypes.c_int8),
    "signed char": (torch.int8, ctypes.c_int8),
    "int8_t": (torch.int8, ctypes.c_int8),
    "unsigned char": (torch.uint8, ctypes.c_uint8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "bool": (torch.bool, ctypes.c_bool),
}
_QUALIFIERS = ("const", "volatile", "__restrict__", "restrict")


class _Param:
    __slots__ = ("name", "ctype", "pointer", "dtype", "scalar")

    def __init__(self, name, ctype, pointer):
        self.name, self.ctype, self.pointer = name, ctype, pointer
        self.dtype, self.scalar = _C_TYPES[ctype]


def parse_signature(signature):
    """[_Param] of a C parameter list such as
    "const float *x, float *y, int n": each parameter's name, base C
    type, whether it is a pointer, the dtype an array argument must have
    and the ctypes type of a scalar. Raises on a type it does not know
    and on a scalar of a type that only arrays take (half, bfloat16)."""
    params = []
    for i, part in enumerate(p.strip() for p in signature.split(",")):
        if not part:
            raise MXNetError("signature %r: empty parameter %d"
                             % (signature, i))
        pointer = part.count("*")
        if pointer > 1 or "&" in part or "[" in part:
            raise MXNetError("signature %r: parameter %r must be a scalar "
                             "or a pointer to one" % (signature, part))
        tokens = [t for t in re.split(r"[\s*]+", part)
                  if t and t not in _QUALIFIERS]
        if len(tokens) < 2:
            raise MXNetError("signature %r: parameter %r needs a type and "
                             "a name" % (signature, part))
        name, ctype = tokens[-1], " ".join(tokens[:-1])
        if ctype not in _C_TYPES:
            raise MXNetError("signature %r: unsupported type %r (one of %s)"
                             % (signature, ctype, sorted(_C_TYPES)))
        param = _Param(name, ctype, bool(pointer))
        if param.pointer and param.dtype is None:
            raise MXNetError("signature %r: no NDArray dtype is %s"
                             % (signature, ctype))
        if not param.pointer and param.scalar is None:
            raise MXNetError("signature %r: a %s scalar cannot be passed; "
                             "pass a pointer to it" % (signature, ctype))
        params.append(param)
    return params


def pack_args(params, args, ctx):
    """The ctypes values of one launch's arguments, after the checks: one
    argument a parameter; a dense NDArray of the pointer's dtype on a GPU
    for each pointer (a strided view such as a transpose would hand the
    kernel its parent's memory), a number for each scalar; a GPU `ctx`.
    Raises naming the first argument that fails."""
    if len(args) != len(params):
        raise MXNetError("kernel takes %d arguments (%s), got %d"
                         % (len(params), ", ".join(p.name for p in params),
                            len(args)))
    for p, a in zip(params, args):
        if p.pointer:
            if not isinstance(a, NDArray):
                raise MXNetError("argument %s (%s *) must be an NDArray, "
                                 "got %s" % (p.name, p.ctype,
                                             type(a).__name__))
            if a._data.dtype != p.dtype:
                raise MXNetError("argument %s (%s *) needs dtype %s, got %s"
                                 % (p.name, p.ctype, p.dtype, a._data.dtype))
            if not a._data.is_contiguous():
                raise MXNetError("argument %s (%s *) is a strided view "
                                 "(shape %s, strides %s): a kernel reads and "
                                 "writes dense row-major memory; pass "
                                 "a.copy() for an input" % (
                                     p.name, p.ctype, tuple(a.shape),
                                     a._data.stride()))
        elif isinstance(a, NDArray) or not isinstance(
                a, (int, float, bool)):
            raise MXNetError("argument %s (%s) must be a number, got %s"
                             % (p.name, p.ctype, type(a).__name__))
    if ctx is None or ctx.device_type != "gpu":
        raise MXNetError("CudaKernel.launch: context %s is not a GPU; a "
                         "CUDA kernel has no CPU version" % (ctx,))
    values = []
    for p, a in zip(params, args):
        if p.pointer:
            dev = a._data.device
            if dev.type != "cuda" or (dev.index or 0) != ctx.device_id:
                raise MXNetError("argument %s lies on %s, not on the "
                                 "launch's %s: a CUDA kernel reads its own "
                                 "device's memory" % (p.name, dev, ctx))
            values.append(ctypes.c_void_p(a._data.data_ptr()))
        else:
            values.append(p.scalar(a))
    return values


# ---------------------------------------------------------------------------
# NVRTC and libcuda, through ctypes
# ---------------------------------------------------------------------------


def _cuda_home():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if not home:
        from torch.utils.cpp_extension import CUDA_HOME
        home = CUDA_HOME
    return home


def _nvrtc_candidates():
    """Where libnvrtc may be: the toolkit's lib64, the nvidia-cuda-nvrtc
    wheel beside torch, then the loader's own search."""
    out = []
    home = _cuda_home()
    if home:
        out += [os.path.join(home, "lib64", "libnvrtc.so")]
    site = os.path.dirname(os.path.dirname(torch.__file__))
    out += sorted(glob.glob(os.path.join(site, "nvidia", "cuda_nvrtc",
                                         "lib", "libnvrtc.so*")))
    return out + ["libnvrtc.so.12", "libnvrtc.so"]


_libs = {}
_lock = threading.Lock()


def _declare(lib, signatures):
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


_P, _PP, _I, _SZ = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p), \
    ctypes.c_int, ctypes.POINTER(ctypes.c_size_t)
_NVRTC = {
    "nvrtcCreateProgram": [_PP, ctypes.c_char_p, ctypes.c_char_p, _I, _P,
                           _P],
    "nvrtcCompileProgram": [_P, _I, ctypes.POINTER(ctypes.c_char_p)],
    "nvrtcGetProgramLogSize": [_P, _SZ],
    "nvrtcGetProgramLog": [_P, ctypes.c_char_p],
    "nvrtcGetCUBINSize": [_P, _SZ],
    "nvrtcGetCUBIN": [_P, ctypes.c_char_p],
    "nvrtcAddNameExpression": [_P, ctypes.c_char_p],
    "nvrtcGetLoweredName": [_P, ctypes.c_char_p,
                            ctypes.POINTER(ctypes.c_char_p)],
    "nvrtcDestroyProgram": [_PP],
}
_U = ctypes.c_uint
_LIBCUDA = {
    "cuInit": [_U],
    "cuDeviceGet": [ctypes.POINTER(_I), _I],
    "cuDevicePrimaryCtxRetain": [_PP, _I],
    "cuCtxSetCurrent": [_P],
    "cuCtxGetCurrent": [_PP],
    "cuModuleLoadData": [_PP, ctypes.c_char_p],
    "cuModuleGetFunction": [_PP, _P, ctypes.c_char_p],
    "cuFuncSetAttribute": [_P, _I, _I],
    "cuLaunchKernel": [_P, _U, _U, _U, _U, _U, _U, _U, _P, _PP, _PP],
    "cuGetErrorString": [_I, ctypes.POINTER(ctypes.c_char_p)],
}


def nvrtc():
    """The loaded libnvrtc; raises naming it when none is found."""
    with _lock:
        if "nvrtc" not in _libs:
            tried = []
            for path in _nvrtc_candidates():
                try:
                    lib = ctypes.CDLL(path)
                except OSError as e:
                    tried.append("%s (%s)" % (path, e))
                    continue
                _declare(lib, _NVRTC)
                lib.nvrtcGetErrorString.argtypes = [_I]
                lib.nvrtcGetErrorString.restype = ctypes.c_char_p
                _libs["nvrtc"] = lib
                break
            else:
                raise MXNetError(
                    "libnvrtc (NVIDIA's runtime CUDA compiler) was not "
                    "found; rtc.CudaModule needs the CUDA toolkit. Tried: "
                    + "; ".join(tried))
    return _libs["nvrtc"]


def _libcuda():
    with _lock:
        if "cuda" not in _libs:
            try:
                lib = ctypes.CDLL("libcuda.so.1")
            except OSError as e:
                raise MXNetError("libcuda.so.1 (CUDA's user-mode library) was not "
                                 "found: %s" % e)
            _declare(lib, _LIBCUDA)
            _libs["cuda"] = lib
    return _libs["cuda"]


def _nvrtc_check(lib, err, what):
    if err != 0:
        raise MXNetError("%s failed: NVRTC error %d (%s)" % (
            what, err, lib.nvrtcGetErrorString(err).decode()))


def _cu_check(lib, err, what):
    if err != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(err, ctypes.byref(msg))
        raise MXNetError("%s failed: libcuda error %d (%s)" % (
            what, err, (msg.value or b"?").decode()))


def _program_log(lib, prog):
    size = ctypes.c_size_t()
    lib.nvrtcGetProgramLogSize(prog, ctypes.byref(size))
    buf = ctypes.create_string_buffer(size.value)
    lib.nvrtcGetProgramLog(prog, buf)
    return buf.value.decode(errors="replace")


def compile_cubin(source, options=(), exports=()):
    """(CUBIN bytes, {exported name: lowered name}, compile log) of
    `source`, compiled by NVRTC for ARCH; raises with NVRTC's log when the
    compile fails. Each compile is an event at the watchdog's site
    `rtc.compile_cubin`."""
    from .telemetry import introspect
    lib = nvrtc()
    with introspect.compile_region("rtc.compile_cubin", phase="nvrtc"):
        return _compile_cubin(lib, source, options, exports)


def _compile_cubin(lib, source, options, exports):
    prog = ctypes.c_void_p()
    _nvrtc_check(lib, lib.nvrtcCreateProgram(
        ctypes.byref(prog), source.encode(), b"mxnet_rtc.cu", 0, None,
        None), "nvrtcCreateProgram")
    try:
        for name in exports:
            _nvrtc_check(lib, lib.nvrtcAddNameExpression(
                prog, name.encode()), "nvrtcAddNameExpression(%s)" % name)
        opts = ["--gpu-architecture=%s" % ARCH]
        home = _cuda_home()
        if home and os.path.isdir(os.path.join(home, "include")):
            opts.append("-I%s" % os.path.join(home, "include"))
        opts += list(options)
        arr = (ctypes.c_char_p * len(opts))(*[o.encode() for o in opts])
        err = lib.nvrtcCompileProgram(prog, len(opts), arr)
        log = _program_log(lib, prog)
        if err != 0:
            raise MXNetError("NVRTC failed to compile the module (error %d, "
                             "%s), options %s:\n%s" % (
                                 err, lib.nvrtcGetErrorString(err).decode(),
                                 opts, log))
        lowered = {}
        for name in exports:
            out = ctypes.c_char_p()
            _nvrtc_check(lib, lib.nvrtcGetLoweredName(
                prog, name.encode(), ctypes.byref(out)),
                "nvrtcGetLoweredName(%s)" % name)
            lowered[name] = out.value.decode()
        size = ctypes.c_size_t()
        _nvrtc_check(lib, lib.nvrtcGetCUBINSize(prog, ctypes.byref(size)),
                     "nvrtcGetCUBINSize")
        cubin = ctypes.create_string_buffer(size.value)
        _nvrtc_check(lib, lib.nvrtcGetCUBIN(prog, cubin), "nvrtcGetCUBIN")
        return cubin.raw, lowered, log
    finally:
        lib.nvrtcDestroyProgram(ctypes.byref(prog))


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------


class CudaModule:
    """A CUDA C++ source compiled by NVRTC (parity: rtc.CudaModule).

    `options` are extra NVRTC options ("-DN=4", "--use_fast_math");
    `exports` the names of kernels declared without `extern "C"`."""

    def __init__(self, source, options=(), exports=()):
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self.source = source
        self.options = tuple(options)
        self.exports = tuple(exports)
        self.cubin, self._lowered, self.log = compile_cubin(
            source, self.options, self.exports)
        self._modules = {}  # device index -> CUmodule
        self._mod_lock = threading.Lock()

    def get_kernel(self, name, signature):
        """The kernel `name` with the C parameter list `signature`."""
        return CudaKernel(self, name, signature)

    def _function(self, name, device):
        """The CUfunction of `name` in this module on `device`, the
        module loaded into torch's primary context of that device on first
        use."""
        lib = _libcuda()
        index = device.index if device.index is not None else \
            torch.cuda.current_device()
        with self._mod_lock:
            module = self._modules.get(index)
            if module is None:
                _cu_check(lib, lib.cuInit(0), "cuInit")
                _set_context(lib, index)
                module = ctypes.c_void_p()
                _cu_check(lib, lib.cuModuleLoadData(ctypes.byref(module),
                                                    self.cubin),
                          "cuModuleLoadData")
                self._modules[index] = module
        fn = ctypes.c_void_p()
        symbol = self._lowered.get(name, name)
        _cu_check(lib, lib.cuModuleGetFunction(ctypes.byref(fn), module,
                                               symbol.encode()),
                  "cuModuleGetFunction(%s)" % symbol)
        return fn


_contexts = {}


def _primary_context(lib, index):
    """torch's primary context of device `index` (the one torch's runtime
    calls use), retained once."""
    ctx = _contexts.get(index)
    if ctx is None:
        dev = ctypes.c_int()
        _cu_check(lib, lib.cuDeviceGet(ctypes.byref(dev), index),
                  "cuDeviceGet")
        ctx = ctypes.c_void_p()
        _cu_check(lib, lib.cuDevicePrimaryCtxRetain(ctypes.byref(ctx),
                                                    dev.value),
                  "cuDevicePrimaryCtxRetain")
        _contexts[index] = ctx
    return ctx


def _set_context(lib, index):
    """Make torch's primary context of device `index` current on this
    thread."""
    _cu_check(lib, lib.cuCtxSetCurrent(_primary_context(lib, index)),
              "cuCtxSetCurrent")


@contextlib.contextmanager
def _switch(lib, index):
    """Device `index` current for torch and its primary context current
    on this thread, for the body."""
    with torch.cuda.device(index):
        _set_context(lib, index)
        yield


def _context_is_current(lib, index):
    """Whether this thread's current context is device `index`'s primary
    one (a thread that has run torch's CUDA calls on that device holds
    it already)."""
    cur = ctypes.c_void_p()
    _cu_check(lib, lib.cuCtxGetCurrent(ctypes.byref(cur)), "cuCtxGetCurrent")
    return cur.value == _primary_context(lib, index).value


def _dims(dims, what):
    dims = tuple(int(d) for d in dims)
    if not 1 <= len(dims) <= 3 or any(d < 1 for d in dims):
        raise MXNetError("%s must be 1 to 3 positive sizes, got %r"
                         % (what, dims))
    return dims + (1,) * (3 - len(dims))


class CudaKernel:
    """One kernel of a CudaModule (parity: rtc.CudaKernel). `launches`
    counts its launches."""

    def __init__(self, module, name, signature):
        self.launches = 0
        self.module = module
        self.name = name
        self.signature = signature
        self.params = parse_signature(signature)
        self._functions = {}
        # device index -> the most dynamic shared memory the function
        # was opted in to there
        self._smem_opt_in = {}

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on `ctx`'s device, on torch's current stream there, with
        `grid_dims` blocks of `block_dims` threads (1 to 3 sizes each) and
        `shared_mem` bytes of dynamic shared memory. Checks the arguments
        against the signature first (see `pack_args`); raises on a failed
        launch. Asynchronous, as any launch: synchronise to read the
        results."""
        values = pack_args(self.params, list(args), ctx)
        grid, block = _dims(grid_dims, "grid_dims"), \
            _dims(block_dims, "block_dims")
        index = ctx.device_id
        shared_mem = int(shared_mem)
        lib = _libcuda()
        fn = self._functions.get(index)
        if fn is None:
            fn = self.module._function(self.name,
                                       torch.device("cuda", index))
            self._functions[index] = fn
        if shared_mem > self._smem_opt_in.get(index, 0):
            _cu_check(lib, lib.cuFuncSetAttribute(
                fn, _CU_FUNC_ATTRIBUTE_MAX_DYNAMIC_SHARED_SIZE_BYTES,
                shared_mem), "cuFuncSetAttribute(%s)" % self.name)
            self._smem_opt_in[index] = shared_mem
        # kernelParams: an array of pointers to each argument's value
        params = (ctypes.c_void_p * len(values))(
            *[ctypes.addressof(v) for v in values])
        # torch's current stream there, as the raw handle: building a
        # torch.cuda.Stream for it took 3.6-4.5 us a launch on an H100
        # host, the raw handle 0.3 (tools/rtc_probe.py)
        stream = torch._C._cuda_getCurrentRawStream(index)
        with (contextlib.nullcontext() if _context_is_current(lib, index)
              else _switch(lib, index)):
            err = lib.cuLaunchKernel(fn, *grid, *block, shared_mem, stream,
                                     params, None)
        _cu_check(lib, err, "cuLaunchKernel(%s)" % self.name)
        self.launches += 1


class PallasModule:
    """The reference's TPU route for user kernels (a Pallas body run by
    pl.pallas_call). There is no Pallas on a GPU: write the kernel in CUDA
    C++ and compile it with `CudaModule`."""

    def __init__(self, *args, **kwargs):
        raise MXNetError(
            "PallasModule runs Pallas kernels on a TPU; on the GPU write "
            "the kernel in CUDA C++ and compile it with "
            "mxnet_tpu_torch.rtc.CudaModule(source).get_kernel(name, "
            "signature).launch(args, ctx, grid_dims, block_dims)")
