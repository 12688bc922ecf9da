"""Runtime-compiled user kernels (`mxnet_tpu_torch.rtc`, K5).

On the CPU: the C signature parsing, the argument checks a launch makes
before it touches the card (count, NDArray for a pointer, its dtype and
dense layout, a number for a scalar, a GPU context, arrays on that GPU),
the raise of a machine without libnvrtc, and `PallasModule`'s raise naming CudaModule —
the mirror of the reference's CudaModule stub (tests/test_misc.py:
test_cuda_module_raises_helpfully). On the card (marker `cuda`, skipped
without one): chip_smoke.py's three kernels (phase 29c) compiled by NVRTC
and launched, each held to its plain PyTorch version (doubling bit for
bit, saxpy within chip_smoke.RTC_SAXPY_ULPS, the block sum within
chip_smoke.RTC_SUM_RTOL), `exports` of a C++ kernel, a failed compile raising with NVRTC's log,
and the launch count. This file
imports neither jax nor mxnet_tpu; run the card tests with

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_rtc.py -q
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True)
def _on_cpu():
    with mx.cpu():
        yield


@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, int n",
     [("x", "float", True, torch.float32), ("y", "float", True,
                                            torch.float32),
      ("n", "int", False, torch.int32)]),
    ("const __nv_bfloat16* __restrict__ a, double s, unsigned char *m",
     [("a", "__nv_bfloat16", True, torch.bfloat16),
      ("s", "double", False, torch.float64),
      ("m", "unsigned char", True, torch.uint8)]),
    ("int64_t *idx,long long k, bool flag, unsigned int u",
     [("idx", "int64_t", True, torch.int64),
      ("k", "long long", False, torch.int64),
      ("flag", "bool", False, torch.bool),
      ("u", "unsigned int", False, None)]),
])
def test_parse_signature(sig, want):
    got = [(p.name, p.ctype, p.pointer, p.dtype)
           for p in rtc.parse_signature(sig)]
    assert got == want


@pytest.mark.parametrize("sig,match", [
    ("float **x", "scalar or a pointer"),
    ("float &x", "scalar or a pointer"),
    ("float x[4]", "scalar or a pointer"),
    ("float4 *x", "unsupported type"),
    ("int", "a type and a name"),
    ("float *x,, int n", "empty parameter"),
    ("__half h", "scalar cannot be passed"),
    ("unsigned int *p", "no NDArray dtype"),
])
def test_parse_signature_rejects(sig, match):
    with pytest.raises(MXNetError, match=match):
        rtc.parse_signature(sig)


_SIG = rtc.parse_signature("const float *x, float *y, float a, int n")
_GPU = mx.Context("gpu", 0)  # not resolved: no card is needed to check


def _args(dtype=np.float32):
    return [mx.nd.array(np.zeros(4, dtype)), mx.nd.array(np.zeros(4,
                                                                  dtype)),
            0.5, 4]


def test_pack_args_count():
    with pytest.raises(MXNetError, match="takes 4 arguments"):
        rtc.pack_args(_SIG, _args()[:3], _GPU)


def test_pack_args_dtype():
    args = _args()
    args[1] = mx.nd.array(np.zeros(4, np.int32))
    with pytest.raises(MXNetError, match="argument y .* needs dtype "
                                         "torch.float32"):
        rtc.pack_args(_SIG, args, _GPU)


def test_pack_args_pointer_needs_ndarray():
    args = _args()
    args[0] = np.zeros(4, np.float32)
    with pytest.raises(MXNetError, match="argument x .* must be an NDArray"):
        rtc.pack_args(_SIG, args, _GPU)


def test_pack_args_scalar_needs_number():
    args = _args()
    args[3] = mx.nd.array(np.zeros(1, np.int32))
    with pytest.raises(MXNetError, match="argument n .* must be a number"):
        rtc.pack_args(_SIG, args, _GPU)


@pytest.mark.parametrize("which,view", [
    (0, lambda a: mx.nd.transpose(a)),
    (1, lambda a: a[:, 1:3]),
], ids=["transposed_input", "column_sliced_output"])
def test_pack_args_strided_view_raises(which, view):
    """A transposed input or a column slice for an output is a view whose
    memory is not the dense array the kernel indexes: raise, do not pass
    the parent's pointer."""
    args = _args()
    args[which] = view(mx.nd.array(np.arange(16, dtype=np.float32)
                                   .reshape(4, 4)))
    assert not args[which]._data.is_contiguous()
    with pytest.raises(MXNetError, match="argument %s .* strided view"
                       % "xy"[which]):
        rtc.pack_args(_SIG, args, _GPU)


def test_pack_args_dense_slice_passes_its_offset():
    """A row slice is dense: its pointer is the slice's first element."""
    a = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    view = mx.nd.NDArray(a)[1:3]
    assert view._data.is_contiguous()
    args = _args()
    args[1] = view
    with pytest.raises(MXNetError, match="argument x lies on cpu"):
        rtc.pack_args(_SIG, args, _GPU)
    assert view._data.data_ptr() == a.data_ptr() + 4 * 4


def test_pack_args_cpu_context_raises():
    with pytest.raises(MXNetError, match="not a GPU"):
        rtc.pack_args(_SIG, _args(), mx.cpu())


def test_pack_args_cpu_array_raises():
    with pytest.raises(MXNetError, match="argument x lies on cpu"):
        rtc.pack_args(_SIG, _args(), _GPU)


def test_launch_on_cpu_context_raises():
    """A kernel's launch checks before it touches libcuda: no fallback
    to the CPU."""
    k = rtc.CudaKernel(None, "saxpy", "const float *x, float *y, float a, "
                                      "int n")
    with pytest.raises(MXNetError, match="not a GPU"):
        k.launch(_args(), mx.cpu(), (1,), (4,))
    assert k.launches == 0


def test_dims():
    assert rtc._dims((4,), "g") == (4, 1, 1)
    assert rtc._dims([2, 3], "g") == (2, 3, 1)
    for bad in ((), (1, 1, 1, 1), (0,)):
        with pytest.raises(MXNetError):
            rtc._dims(bad, "grid_dims")


def test_missing_nvrtc_raises_naming_it(monkeypatch):
    monkeypatch.setattr(rtc, "_nvrtc_candidates",
                        lambda: ["/nonexistent/libnvrtc.so"])
    monkeypatch.setattr(rtc, "_libs", {})
    with pytest.raises(MXNetError, match="libnvrtc"):
        rtc.CudaModule(cs.RTC_SOURCE)


def test_nvrtc_candidates_start_at_the_toolkit(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/opt/toolkit")
    cands = rtc._nvrtc_candidates()
    assert cands[0] == "/opt/toolkit/lib64/libnvrtc.so"
    assert cands[-2:] == ["libnvrtc.so.12", "libnvrtc.so"]


def test_pallas_module_raises_naming_cuda_module():
    with pytest.raises(MXNetError, match="CudaModule"):
        rtc.PallasModule(lambda x_ref, o_ref: None)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,rows,tile", [(1 << 16, 4, 4096),
                                         (1 << 20, 8, 16384)])
def test_kernels_match_plain(dev, n, rows, tile):
    """Phase 29c's kernels at small sizes (the dynamic shared memory
    opt-in: tests/test_torch_cuda.py::
    test_rtc_dynamic_shared_memory_opt_in)."""
    with mx.gpu(0):
        calls, kernels, errs, _ = cs.rtc_run(torch, mx, dev, n, rows, tile)
    assert {k: v.launches for k, v in kernels.items()} == {
        name: 1 for name, _ in cs.RTC_KERNELS}
    for name, (_, e, limit) in errs.items():
        assert e <= limit, (name, e, limit)


@pytest.mark.cuda
def test_exports_and_templates(dev):
    """A kernel without extern "C" is found through `exports`; options
    reach NVRTC."""
    src = ("template <int K> __global__ void scale(float *x, int n) {"
           " int i = blockIdx.x * blockDim.x + threadIdx.x;"
           " if (i < n) x[i] *= K * SCALE; }")
    mod = rtc.CudaModule(src, options=("-DSCALE=2",),
                         exports=("scale<3>",))
    k = mod.get_kernel("scale<3>", "float *x, int n")
    with mx.gpu(0):
        x = mx.nd.array(np.arange(100, dtype=np.float32))
        k.launch([x, 100], mx.gpu(0), (1,), (128,))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(x.asnumpy(), np.arange(100) * 6.0)
    assert k.launches == 1


@pytest.mark.cuda
def test_failed_compile_raises_with_log(dev):
    with pytest.raises(MXNetError, match="undefined_name"):
        rtc.CudaModule('extern "C" __global__ void k(float *x) '
                       '{ x[0] = undefined_name; }')


@pytest.mark.cuda
def test_cpu_array_raises_on_the_card(dev):
    mod = rtc.CudaModule(cs.RTC_SOURCE)
    k = mod.get_kernel("double_it", "const float *x, float *y, int n")
    with pytest.raises(MXNetError, match="lies on cpu"):
        k.launch([mx.nd.array(np.zeros(4, np.float32)),
                  mx.nd.array(np.zeros(4, np.float32)), 4], mx.gpu(0),
                 (1,), (4,))
    assert k.launches == 0
