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


#: the K1 cluster and tile edges of chip_smoke.PAGED_EDGE_CASES at a
#: size the interpreter runs quickly (bs 2, so 16 slots are 32 tokens):
#: (B, Tq, w, q_starts)
_EDGES = {
    "one_live_slot": (3, 1, 16, [0, 1, 1]),
    "live_eq_cluster": (2, 1, 16, [15, 14]),         # 8 live slots
    "live_cluster_minus_1": (2, 1, 16, [13, 12]),    # 7
    "live_cluster_plus_1": (2, 1, 16, [16, 17]),     # 9
    "chunk_mid_block": (1, 9, 8, [3]),
    "ragged_live_counts": (3, 1, 16, [0, 31, 9]),    # 1, 16, 5
    "spec_ragged_live": (3, 4, 16, [0, 28, 11]),
}


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", sorted(_EDGES))
def test_paged_attention_edges_match_jax(case, quant):
    """The plain version the card holds K1 to, against the reference at
    the cluster split's and query tile's edges (float32 q; an int8 pool
    with its scales when quant)."""
    B, tq, w, q_start = _EDGES[case]
    bs, H, Dh = 2, 2, 16
    nb = B * w + 2
    rng = np.random.RandomState(len(case))
    k = rng.randn(nb, bs, H, Dh).astype(np.float32)
    v = rng.randn(nb, bs, H, Dh).astype(np.float32)
    q = rng.randn(B, tq, H, Dh).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[:B * w].reshape(B, w) \
        .astype(np.int32)
    qs = np.asarray(q_start, np.int32)
    kw, tkw = {}, {}
    if quant:
        k, ks = _quantize_pool(k)
        v, vs = _quantize_pool(v)
        kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        tkw = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    want = ref.paged_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(tables), jnp.asarray(qs), bs,
                               interpret=True, **kw)
    got = pa.paged_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), torch.from_numpy(tables),
                             torch.from_numpy(qs), bs, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **_TOL["float32"])


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


@pytest.mark.parametrize("head_dim,bs,tq,dtype,ok,ok8", [
    (128, 16, 1, torch.float32, True, True),      # the main path, decode
    (128, 16, 32, torch.bfloat16, True, True),    # prefill chunk, bf16
    (32, 4, 1, torch.float32, True, True),
    (256, 16, 8, torch.float32, True, True),
    (48, 16, 1, torch.float32, True, True),       # a multiple of 16
    (16, 1, 64, torch.float32, True, True),
    (40, 16, 1, torch.float32, False, False),     # not a multiple of 16
    (512, 16, 1, torch.float32, False, False),    # > 8 columns per lane
    (128, 16, 1, torch.float16, False, False),    # no fp16 instantiation
    # shared memory: a float32 pool stages 4 x 64 rows of 1040 bytes,
    # an int8 pool a quarter of that
    (256, 64, 1, torch.float32, False, True),
    (128, 16, 70000, torch.float32, False, False),  # query rows
])
def test_paged_supported_gate(head_dim, bs, tq, dtype, ok, ok8):
    assert pa.paged_supported(head_dim, bs, tq, dtype) is ok
    limit = pa.paged_limit(head_dim, bs, tq, dtype)
    assert (limit is None) is ok
    # an int8 pool is staged as int8: its blocks take a quarter of the
    # float32 pool's shared memory
    assert pa.paged_supported(head_dim, bs, tq, dtype, torch.int8) is ok8


@pytest.mark.parametrize("bh,ok", [(1, True), (65535, True),
                                   (65536, False)])
def test_paged_limit_grid_rows(bh, ok):
    """Batch rows x heads fill the grid's y dimension."""
    limit = pa.paged_limit(128, 16, 1, torch.float32, bh=bh)
    assert (limit is None) is ok
    if not ok:
        assert "batch rows x heads" in limit


@pytest.mark.parametrize("tq,head_dim,tile", [(1, 128, 4), (4, 128, 4),
                                              (5, 128, 16), (16, 64, 16),
                                              (17, 128, 64), (64, 128, 64),
                                              (64, 256, 32), (500, 16, 64)])
def test_paged_row_tile(tq, head_dim, tile):
    """One cluster serves a tile of up to 64 query rows (32 above head_dim
    128); decode and spec score take the 4-row tile."""
    assert pa._row_tile(tq, head_dim) == tile


@pytest.mark.parametrize("pool,itemsize", [(torch.float32, 4),
                                           (torch.bfloat16, 2),
                                           (torch.int8, 1)])
def test_paged_smem_bytes(pool, itemsize):
    """The shared memory of one thread block, as csrc smem_bytes: the
    float32 query tile, its rows' m, l and 32 probabilities, and two
    stages of K and V blocks in the pool's dtype, rows padded by 16
    bytes."""
    tile = 64
    want = (tile * 128 * 4 + tile * 2 * 4 + tile * 32 * 4
            + 4 * 32 * (128 * itemsize + 16))
    assert pa._smem_bytes(128, 32, 64, itemsize) == want
    # the limit names the bytes it needs when they pass 227 KB
    limit = pa.paged_limit(256, 256, 64, torch.float32,
                           None if pool is torch.float32 else pool)
    if pool is not torch.bfloat16:
        assert "%d bytes of shared memory" % pa._smem_bytes(
            256, 256, 64, itemsize) in limit


def test_paged_limit_alignment():
    """Every pointer the kernel stages from must be 16-byte aligned; a
    per-layer slice of a (layers, blocks, bs, H, Dh) pool is."""
    pool = torch.zeros(3, 5, 16, 2, 64)
    for layer in range(3):
        assert pa.paged_limit(64, 16, 1, torch.float32, torch.float32,
                              (("k_pool", pool[layer]),)) is None
    flat = torch.zeros(2 * 16 * 2 * 64 + 1)
    shifted = flat[1:].view(2, 16, 2, 64)          # 4 bytes off
    limit = pa.paged_limit(64, 16, 1, torch.float32, torch.float32,
                           (("k_pool", shifted),))
    assert "k_pool" in limit and "16-byte aligned" in limit
    q8 = torch.zeros(2 * 16 * 2 * 64 + 8, dtype=torch.int8)[8:]
    limit = pa.paged_limit(64, 16, 1, torch.float32, torch.int8,
                           (("v_pool", q8.view(2, 16, 2, 64)),))
    assert "v_pool" in limit and "16-byte aligned" in limit


def _serving_widths():
    """(head_dim, block_size, q dtype, pool dtype, query rows) of every
    serving config chip_smoke.py drives: phase 4's float pool at block
    16, phases 6-7's int8 pool at block 32 and phase 7's float pool at
    block 32, each at decode (1 row), its prefill chunk (2 blocks) and,
    with speculation, spec_k + 1 rows; and the kernel cases of phases
    1-2."""
    import chip_smoke as cs
    dh = cs.BENCH_CFG["d_model"] // cs.BENCH_CFG["n_heads"]
    out = []
    for bs, pool, spec in ((16, torch.float32, False),
                           (cs.QUANT_BLOCK, torch.int8, True),
                           (cs.QUANT_BLOCK, torch.float32, True)):
        for tq in (1, 2 * bs) + ((cs.SPEC_K + 1,) if spec else ()):
            out.append((dh, bs, torch.float32, pool, tq))
    for _, B, tq, w, _ in cs.INT8_CASES:
        for q in (torch.float32, torch.bfloat16):
            out.append((128, cs.QUANT_BLOCK, q, torch.int8, tq))
    for _, B, tq, w, _ in cs.PAGED_EDGE_CASES:
        for q in (torch.float32, torch.bfloat16):
            for pool in (q, torch.int8):
                out.append((128, 16, q, pool, tq))
    return out


@pytest.mark.parametrize("dh,bs,dtype,pool,tq", _serving_widths())
def test_chip_smoke_configs_pass_gate(dh, bs, dtype, pool, tq):
    assert pa.paged_limit(dh, bs, tq, dtype, pool) is None


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
