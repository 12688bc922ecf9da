"""Ragged paged attention: decode, prefill chunks and speculative
scoring read straight off the block pool (port of
`mxnet_tpu/ops/pallas_paged.py`).

`paged_attention` is the entry the serving engine calls once per layer
for every paged decode step (Tq = 1), every prefill chunk (Tq = the
chunk) and every speculative scoring pass (Tq = k + 1). On CUDA tensors
it launches the hand-written Hopper kernel in `csrc/paged_attention.cu`,
or raises; there is no fallback. On CPU tensors, and only there, it runs
`paged_attention_plain`, the plain PyTorch version of the same function
(gather by table, dequantize, masked softmax), which the CPU tests
compare with the JAX reference and `chip_smoke.py` holds the kernel
against on the card.

The pool is float32 or bfloat16 in q's dtype, or int8 with per-(block,
head) float32 scales `k_scale`/`v_scale` (the reference's `quant=True`):
the kernel stages each live block as int8 and dequantizes it in
registers where it is used. Launches over an int8 pool count in
`paged_attention.launches_int8`, the others in `paged_attention.launches`.
"""
from __future__ import annotations

import math
import os
import threading

import torch

from ..base import MXNetError
from ._cuda import refuse_export as _refuse_export

#: dynamic shared memory one thread block may use on Hopper (227 KB)
_SMEM_LIMIT = 232448
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: pool dtype codes of the C entry: q's own code, or int8
_POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def paged_enabled():
    """MXNET_PAGED_ATTENTION=1, read when an Engine is constructed."""
    return os.environ.get("MXNET_PAGED_ATTENTION", "0") == "1"


def paged_call_cost(B, Tq, H, Dh, w, block_size, kv_itemsize=4,
                    q_itemsize=4, scale_blocks=0):
    """(flops, bytes) of ONE paged_attention call over `w` table slots per
    row — the reference's declared cost, copied as is. `H` is the head
    count the kernel sees; a quantized pool passes `kv_itemsize=1` plus
    `scale_blocks=num_blocks`."""
    nk = B * H * w * block_size           # pool tokens touched
    flops = 4 * nk * Tq * Dh              # 2 MACs/pair for QK and PV
    bytes_ = (2 * nk * Dh * kv_itemsize           # K + V blocks walked
              + 2 * B * Tq * H * Dh * q_itemsize  # q in, out back
              + 2 * scale_blocks * H * 4          # k/v scale sidecars
              + B * w * 4 + B * 4)                # tables + q_start
    return flops, bytes_


def _row_tile(tq, head_dim):
    """Query rows one cluster serves (csrc row_tile): 4 for decode and
    spec score, 16, or 64 (32 above head_dim 128)."""
    if tq <= 4:
        return 4
    if tq <= 16:
        return 16
    return 32 if head_dim > 128 else 64


def _smem_bytes(head_dim, block_size, tq, pool_itemsize):
    """Dynamic shared memory of one thread block (csrc smem_bytes): the
    float32 query tile, its rows' m and l and 32 probabilities a row, and
    two stages of K and V blocks in the pool's dtype, rows padded by 16
    bytes."""
    tile = _row_tile(tq, head_dim)
    return (tile * head_dim * 4 + tile * 2 * 4 + tile * 32 * 4
            + 4 * block_size * (head_dim * pool_itemsize + 16))


def paged_limit(head_dim, block_size, tq, dtype, pool_dtype=None,
                tensors=(), bh=1):
    """None when the CUDA kernel takes this shape (`bh` = batch rows x
    heads), q dtype and pool dtype (default: q's), and every (name,
    tensor) of `tensors` starts 16-byte aligned; else the limit it
    breaks, named. The pool is q's dtype or int8 and is staged in its own
    dtype, so an int8 pool's blocks take a quarter of a float32 pool's
    shared memory."""
    if dtype not in _DTYPE_CODE:
        return "dtype %s: the kernel takes float32 or bfloat16" % (dtype,)
    if pool_dtype is not None and pool_dtype not in (dtype, torch.int8):
        return ("pool dtype %s: the kernel takes a pool in q's dtype (%s) "
                "or int8" % (pool_dtype, dtype))
    if head_dim % 16 or not 16 <= head_dim <= 256:
        return ("head_dim %d: must be a multiple of 16 in [16, 256] (rows "
                "are staged in 16-byte pieces; a lane keeps at most 8 "
                "accumulator columns)" % head_dim)
    if block_size < 1:
        return "block_size %d: must be >= 1" % block_size
    if not 1 <= tq <= 65535:
        return "%d query rows: the kernel takes 1..65535" % tq
    if not 1 <= bh <= 65535:
        return ("%d batch rows x heads: the grid's y dimension takes "
                "1..65535" % bh)
    for name, t in tensors:
        if t.data_ptr() % 16:
            return ("%s starts at an address that is not 16-byte aligned "
                    "(the kernel stages it in 16-byte pieces)" % name)
    pool = (dtype if pool_dtype is None else pool_dtype).itemsize
    smem = _smem_bytes(head_dim, block_size, tq, pool)
    if smem > _SMEM_LIMIT:
        return ("block_size %d x head_dim %d at %d query rows needs %d "
                "bytes of shared memory per thread block; Hopper gives at "
                "most %d" % (block_size, head_dim, tq, smem, _SMEM_LIMIT))
    return None


def paged_supported(head_dim, block_size, tq, dtype, pool_dtype=None):
    """Hopper gate (replaces the reference's Mosaic `paged_eligible`):
    True when the CUDA kernel takes this shape and these dtypes (the
    pointers' alignment is checked at the call)."""
    return paged_limit(head_dim, block_size, tq, dtype, pool_dtype) is None


def _check(q, k_pool, v_pool, tables, q_start, block_size, k_scale=None,
           v_scale=None):
    if q.dim() != 4:
        raise MXNetError("paged_attention: q must be (B, Tq, H, Dh), got "
                         "shape %s" % (tuple(q.shape),))
    B, Tq, H, Dh = q.shape
    if B == 0 or Tq == 0:
        raise MXNetError("paged_attention: empty query %s"
                         % (tuple(q.shape),))
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if tuple(pool.shape[1:]) != (block_size, H, Dh) or pool.dim() != 4:
            raise MXNetError(
                "paged_attention: %s must be (num_blocks, %d, %d, %d), got "
                "%s" % (name, block_size, H, Dh, tuple(pool.shape)))
    quant = k_scale is not None or v_scale is not None
    for name, pool in (("k_pool", k_pool), ("v_pool", v_pool)):
        if quant and pool.dtype != torch.int8:
            raise MXNetError("paged_attention: scales given but %s dtype is "
                             "%s, not int8" % (name, pool.dtype))
        if not quant and pool.dtype != q.dtype:
            raise MXNetError("paged_attention: %s dtype %s != q dtype %s "
                             "(an int8 pool needs k_scale and v_scale)"
                             % (name, pool.dtype, q.dtype))
    scales = ()
    if quant:
        scales = (("k_scale", k_scale), ("v_scale", v_scale))
        for name, s in scales:
            if s is None:
                raise MXNetError("paged_attention: an int8 pool needs both "
                                 "k_scale and v_scale")
            if tuple(s.shape) != (k_pool.shape[0], H) or \
                    s.dtype != torch.float32:
                raise MXNetError(
                    "paged_attention: %s must be (num_blocks, H) = (%d, %d) "
                    "float32, got %s %s" % (name, k_pool.shape[0], H,
                                            tuple(s.shape), s.dtype))
    if tables.dim() != 2 or tables.shape[0] != B:
        raise MXNetError("paged_attention: tables must be (%d, w), got %s"
                         % (B, tuple(tables.shape)))
    if tuple(q_start.shape) != (B,):
        raise MXNetError("paged_attention: q_start must be (%d,), got %s"
                         % (B, tuple(q_start.shape)))
    for name, t in (("tables", tables), ("q_start", q_start)):
        if t.dtype != torch.int32:
            raise MXNetError("paged_attention: %s must be int32, got %s"
                             % (name, t.dtype))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("q_start", q_start)) + scales:
        if t.device != q.device:
            raise MXNetError("paged_attention: %s is on %s, q on %s"
                             % (name, t.device, q.device))
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("q_start", q_start)) + scales:
        if not t.is_contiguous():
            raise MXNetError("paged_attention: %s must be contiguous"
                             % name)


def paged_attention_plain(q, k_pool, v_pool, tables, q_start, block_size,
                          scale=None, k_scale=None, v_scale=None):
    """The plain PyTorch version: gather each row's blocks by table into
    a dense (B, w*bs, H, Dh) tensor (an int8 pool dequantized by its
    (block, head) scales), then a masked float32 softmax. Keys past
    position q_start+i are masked for query row i."""
    B, Tq, H, Dh = q.shape
    w = tables.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    idx = tables.long()
    ks = k_pool[idx].float()                               # (B,w,bs,H,Dh)
    vs = v_pool[idx].float()
    if k_scale is not None:
        ks = ks * k_scale[idx][:, :, None, :, None]
        vs = vs * v_scale[idx][:, :, None, :, None]
    ks = ks.reshape(B, w * block_size, H, Dh)
    vs = vs.reshape(B, w * block_size, H, Dh)
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), ks) * scale
    kp = torch.arange(w * block_size, device=q.device)
    qp = q_start.long()[:, None] + torch.arange(Tq, device=q.device)
    s = s.masked_fill(kp[None, None, None, :] > qp[:, None, :, None],
                      float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p, vs).to(q.dtype)


def paged_attention(q, k_pool, v_pool, tables, q_start, block_size,
                    scale=None, k_scale=None, v_scale=None):
    """Ragged paged attention against one layer's block pool.

    q:       (B, Tq, H, Dh) query block — Tq=1 for decode, Tq=chunk for
             chunked prefill, Tq=k+1 for speculative scoring (their K/V
             are already written to the pool).
    k_pool:  (num_blocks, block_size, H, Dh) one layer's key pool, in q's
             dtype, or int8 with `k_scale`/`v_scale`.
    v_pool:  same shape and dtype, values.
    tables:  (B, w) int32 block table (null-padded past each row's blocks).
    q_start: (B,) int32 true position of each row's FIRST query token.
    k_scale, v_scale: (num_blocks, H) float32 per-(block, head) scales of
             an int8 pool; each block is dequantized before use.

    Returns (B, Tq, H, Dh) in q's dtype; statistics accumulate in float32.
    CUDA tensors launch the kernel (counted in `paged_attention.launches`,
    or `paged_attention.launches_int8` over an int8 pool) or raise; CPU
    tensors take `paged_attention_plain`. Every tensor must be contiguous
    and on q's device."""
    _refuse_export("K1 (paged_attention)")
    _check(q, k_pool, v_pool, tables, q_start, block_size, k_scale,
           v_scale)
    B, Tq, H, Dh = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, tables, q_start,
                                     block_size, scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise MXNetError("paged_attention: no kernel for device %s"
                         % (q.device,))
    limit = paged_limit(Dh, block_size, Tq, q.dtype, k_pool.dtype,
                        (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)),
                        B * H)
    if limit is not None:
        raise MXNetError("paged_attention: " + limit)
    quant = k_scale is not None
    from . import _cuda
    lib = _cuda.library("paged_attention.cu")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_paged_attention(
            _DTYPE_CODE[q.dtype], _POOL_CODE[k_pool.dtype], q.data_ptr(),
            k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None, tables.data_ptr(),
            q_start.data_ptr(), out.data_ptr(), B, Tq, H, Dh,
            tables.shape[1], block_size, float(scale), stream)
    _cuda.check(lib, err, "paged_attention kernel launch")
    count_launch(quant)
    return out


#: kernel launches so far, over float32/bfloat16 pools and over int8
#: pools (plain-version calls on the CPU do not count)
paged_attention.launches = 0
paged_attention.launches_int8 = 0
_count_lock = threading.Lock()


def count_launch(quant=False):
    """Add one to `paged_attention.launches` (or `.launches_int8`). A
    fleet's serving threads launch K1 at once; `+=` on an attribute is a
    read-modify-write, so the lock keeps every launch counted."""
    with _count_lock:
        if quant:
            paged_attention.launches_int8 += 1
        else:
            paged_attention.launches += 1
