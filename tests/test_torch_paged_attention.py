"""Port parity for the paged-attention op (mxnet_tpu_torch/ops/
paged_attention.py) against the JAX reference (mxnet_tpu/ops/
pallas_paged.py, the Pallas kernel in interpreter mode on the CPU).

On CPU tensors the port's wrapper runs its plain PyTorch version; the
CUDA kernel itself is held against that plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py). Inputs are made with numpy
from a seed and handed to both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_paged as ref
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as pa

_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# f32: same math, different summation order; bf16: output rounding
_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
        "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(width, tq, bs=4, H=2, Dh=8, nb=12, B=3):
    """The reference test's case (tests/test_pallas_paged.py): ragged
    rows at the last slot, mid-block, and position 0."""
    rng = np.random.RandomState(0)
    k = rng.randn(nb, bs, H, Dh).astype(np.float32)
    v = rng.randn(nb, bs, H, Dh).astype(np.float32)
    q = rng.randn(B, tq, H, Dh).astype(np.float32)
    tables = rng.choice(np.arange(1, nb), (B, width),
                        replace=B * width >= nb).astype(np.int32)
    q_start = np.asarray([width * bs - tq, bs + 1, 0], np.int32)
    return q, k, v, tables, q_start


def _torch(q, k, v, tables, q_start, dtype):
    return (torch.from_numpy(q).to(dtype), torch.from_numpy(k).to(dtype),
            torch.from_numpy(v).to(dtype), torch.from_numpy(tables),
            torch.from_numpy(q_start))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [2, 4])          # >= 2 table widths
@pytest.mark.parametrize("tq", [1, 4])             # decode / prefill chunk
def test_paged_attention_matches_jax(dtype, width, tq):
    q, k, v, tables, q_start = _inputs(width, tq)
    tdt, jdt = _DT[dtype]
    want = ref.paged_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(v).astype(jdt), jnp.asarray(tables),
        jnp.asarray(q_start), 4, interpret=True)
    n0 = pa.paged_attention.launches
    got = pa.paged_attention(*_torch(q, k, v, tables, q_start, tdt), 4)
    assert pa.paged_attention.launches == n0     # CPU: no kernel launch
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_TOL[dtype])


def _quantize_pool(pool):
    """Per-(block, head) symmetric int8 of an (NB, bs, H, Dh) float pool,
    as tests/test_serving_quant.py:87 quantizes it."""
    a = np.max(np.abs(pool), axis=(1, 3))
    s = (np.maximum(a, 1e-12) / 127.0).astype(np.float32)      # (NB, H)
    q = np.clip(np.rint(pool / s[:, None, :, None]), -127, 127)
    return q.astype(np.int8), s


#: int8 pool: the same function after dequantization, so the float
#: tolerances above hold (the plain version dequantizes in float32 in the
#: reference's order, k * scale before the product)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [2, 4])
@pytest.mark.parametrize("tq", [1, 4])
def test_paged_attention_int8_matches_jax(dtype, width, tq):
    q, k, v, tables, q_start = _inputs(width, tq)
    kq, ks = _quantize_pool(k)
    vq, vs = _quantize_pool(v)
    tdt, jdt = _DT[dtype]
    want = ref.paged_attention(
        jnp.asarray(q).astype(jdt), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tables), jnp.asarray(q_start), 4, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    n0 = (pa.paged_attention.launches, pa.paged_attention.launches_int8)
    got = pa.paged_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(kq),
        torch.from_numpy(vq), torch.from_numpy(tables),
        torch.from_numpy(q_start), 4, k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs))
    assert (pa.paged_attention.launches,
            pa.paged_attention.launches_int8) == n0   # CPU: no launch
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_TOL[dtype])


def test_int8_wrapper_validates_scales():
    q, k, v, tables, q_start = _torch(*_inputs(2, 1), torch.float32)
    kq, ks = (torch.from_numpy(a) for a in _quantize_pool(k.numpy()))
    vq, vs = (torch.from_numpy(a) for a in _quantize_pool(v.numpy()))
    with pytest.raises(MXNetError, match="needs k_scale"):
        pa.paged_attention(q, kq, vq, tables, q_start, 4)
    with pytest.raises(MXNetError, match="not int8"):
        pa.paged_attention(q, k, v, tables, q_start, 4, k_scale=ks,
                           v_scale=vs)
    with pytest.raises(MXNetError, match="both"):
        pa.paged_attention(q, kq, vq, tables, q_start, 4, k_scale=ks)
    with pytest.raises(MXNetError, match="num_blocks, H"):
        pa.paged_attention(q, kq, vq, tables, q_start, 4, k_scale=ks[:3],
                           v_scale=vs)
    with pytest.raises(MXNetError, match="float32"):
        pa.paged_attention(q, kq, vq, tables, q_start, 4,
                           k_scale=ks.double(), v_scale=vs)
    with pytest.raises(MXNetError, match="contiguous"):
        pa.paged_attention(q, kq, vq, tables, q_start, 4,
                           k_scale=ks.t().contiguous().t(), v_scale=vs)


@pytest.mark.parametrize("args,kw", [
    ((8, 1, 4, 128, 16, 16), {}),
    ((1, 32, 4, 128, 4, 16), dict(kv_itemsize=2, q_itemsize=2)),
    ((3, 5, 2, 64, 7, 8), dict(kv_itemsize=1, scale_blocks=33)),
])
def test_paged_call_cost_matches_jax(args, kw):
    assert pa.paged_call_cost(*args, **kw) == ref.paged_call_cost(*args,
                                                                  **kw)


@pytest.mark.parametrize("head_dim,bs,tq,dtype,ok", [
    (128, 16, 1, torch.float32, True),      # the main path, decode
    (128, 16, 32, torch.bfloat16, True),    # prefill chunk, bf16
    (32, 4, 1, torch.float32, True),
    (256, 16, 8, torch.float32, True),
    (48, 16, 1, torch.float32, False),      # not a multiple of 32
    (512, 16, 1, torch.float32, False),     # > 8 columns per lane
    (128, 16, 1, torch.float16, False),     # no fp16 instantiation
    (256, 64, 1, torch.float32, False),     # shared memory
    (128, 16, 70000, torch.float32, False),  # grid y
])
def test_paged_supported_gate(head_dim, bs, tq, dtype, ok):
    assert pa.paged_supported(head_dim, bs, tq, dtype) is ok
    limit = pa.paged_limit(head_dim, bs, tq, dtype)
    assert (limit is None) is ok
    # an int8 pool stages the same float32 rows: the same limits
    assert pa.paged_supported(head_dim, bs, tq, dtype, torch.int8) is ok


@pytest.mark.parametrize("dtype,pool,ok", [
    (torch.float32, torch.float32, True),
    (torch.bfloat16, torch.int8, True),
    (torch.float32, torch.bfloat16, False),   # a float pool in q's dtype
    (torch.float32, torch.float16, False),
])
def test_paged_limit_pool_dtype(dtype, pool, ok):
    limit = pa.paged_limit(128, 32, 4, dtype, pool)
    assert (limit is None) is ok, limit


def test_wrapper_validates_inputs():
    q, k, v, tables, q_start = _torch(*_inputs(2, 1), torch.float32)
    with pytest.raises(MXNetError, match="int32"):
        pa.paged_attention(q, k, v, tables.long(), q_start, 4)
    with pytest.raises(MXNetError, match="int32"):
        pa.paged_attention(q, k, v, tables, q_start.long(), 4)
    with pytest.raises(MXNetError, match="contiguous"):
        pa.paged_attention(q, k.transpose(0, 1).contiguous()
                           .transpose(0, 1), v, tables, q_start, 4)
    with pytest.raises(MXNetError, match="k_pool"):
        pa.paged_attention(q, k[:, :2], v, tables, q_start, 4)
    with pytest.raises(MXNetError, match="dtype"):
        pa.paged_attention(q, k.double(), v, tables, q_start, 4)
    with pytest.raises(MXNetError, match="q_start"):
        pa.paged_attention(q, k, v, tables, q_start[:2], 4)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors run the plain version; any other device launches
    a kernel or raises (here: a device with no kernel)."""
    q, k, v, tables, q_start = (t.to("meta") for t in
                                _torch(*_inputs(2, 1), torch.float32))
    with pytest.raises(MXNetError, match="no kernel for device meta"):
        pa.paged_attention(q, k, v, tables, q_start, 4)
