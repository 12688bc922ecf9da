"""Flash attention, forward and backward (port of
`mxnet_tpu/ops/pallas_attention.py`).

`flash_attention` is what the transformer's `_attention` calls once per
layer when MXNET_FLASH_ATTENTION=1. It is a `torch.autograd.Function`
(`_FlashAttention`) whose forward and backward are both hand-written
Hopper kernels (`csrc/flash_attention.cu`), entered through
`flash_attention_fwd` and `flash_attention_bwd`. On CUDA tensors they
launch the kernels or raise, naming the limit; there is no fallback. On
CPU tensors, and only there, they run `flash_fwd_plain` and
`flash_bwd_plain`, the plain PyTorch versions of the same functions,
which the CPU tests compare with the JAX reference and `chip_smoke.py`
holds the kernels against on the card.

The reference's block-size arguments and its MXNET_FLASH_BLOCK_Q/K reads
are TPU tiling knobs and do not carry over: the tile is the kernels' own
constant. Nor does its fallback for shapes that do not tile: the kernels
mask the ragged tail, so any T >= 1 is taken.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
#: the forward kernel's tile: query rows of a block, keys of a K/V tile
#: (csrc/flash_attention.cu kBQ, kBC)
_BQ, _BC = 64, 64


def flash_fwd_smem_bytes(head_dim, dtype):
    """Dynamic shared memory (bytes) of one forward block: the Q tile and
    two stages of K and V tiles, staged in the input dtype in rows of
    head_dim elements and a 16-byte pad; under an H100 block's 227 KB for
    every head_dim and dtype the gate takes (the kernel's own size is
    `mxtt_flash_fwd_smem_bytes`, held to this on the card)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return (_BQ + 4 * _BC) * (head_dim + 16 // itemsize) * itemsize


def flash_limit(head_dim, tq, tk, causal, dtype, bh=1):
    """None when the CUDA kernels take this shape and dtype, else the
    limit it breaks, named."""
    if dtype not in _DTYPE_CODE:
        return "dtype %s: the kernels take float32 or bfloat16" % (dtype,)
    if head_dim not in _HEAD_DIMS:
        return ("head_dim %d: the kernels are built for head_dim in %s"
                % (head_dim, _HEAD_DIMS))
    if tq < 1 or tk < 1:
        return "empty sequence (Tq=%d, Tk=%d)" % (tq, tk)
    if causal and tq != tk:
        return ("causal with Tq=%d != Tk=%d: the causal mask is tril(T, T)"
                % (tq, tk))
    if not 1 <= bh <= 65535:
        return "%d batch*head rows: the grid's y dimension takes 1..65535" \
            % bh
    return None


def flash_supported(head_dim, tq, tk, causal, dtype, bh=1):
    """Hopper gate: True when the CUDA kernels take this shape and
    dtype (the reference's TPU gate, D % 128 and T % block, does not
    carry over)."""
    return flash_limit(head_dim, tq, tk, causal, dtype, bh) is None


def flash_call_cost(BH, T, Tk, D, itemsize=4, nq=1, pairs=None,
                    backward=False):
    """(flops, bytes, transcendentals) of one call.

    Forward: the reference's declared cost (pallas_attention.py:130-134)
    copied as is — 2 MACs per (query, key, d) for each of QK^T and PV;
    q and out once, K and V re-walked once per query block (`nq`; the
    reference passes T // block_q, a bound passes 1), the f32 m and l.
    Backward, stated beside it: five products per (query, key, d) — the
    recomputed QK^T, dP = dO V^T, dV, dQ and dK — 10 flops; q, out, dO
    and dq once, k, v, dk and dv once, m and l read.
    `pairs` is the (query, key) pairs scored per row, T * Tk by default;
    a causal bound passes the live ones, T (T + 1) / 2."""
    pairs = T * Tk if pairs is None else pairs
    if backward:
        return (10 * BH * pairs * D,
                BH * D * itemsize * (4 * T + 4 * Tk) + 2 * BH * T * 4,
                BH * pairs)
    return (4 * BH * pairs * D,
            2 * BH * T * D * itemsize + 2 * BH * nq * Tk * D * itemsize
            + 2 * BH * T * 4,
            BH * pairs)


def _scores(q, k, scale, causal):
    """float32 [BH, T, Tk] scores, -inf above the diagonal when causal."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        T, Tk = q.shape[1], k.shape[1]
        keep = torch.ones((T, Tk), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _exp_scores(s, m):
    """exp(s - m_safe), with m_safe = 0 where the row max m is -inf, and
    0 where s is masked: the reference's guards."""
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    return torch.where(torch.isfinite(s), p, torch.zeros_like(p))


def flash_fwd_plain(q, k, v, scale, causal):
    """The plain PyTorch forward: [BH, T, D] q, [BH, Tk, D] k, v ->
    (out [BH, T, D] in q's dtype, m [BH, T, 1], l [BH, T, 1] float32),
    the outputs of the reference's `_flash_fwd`, from one dense masked
    softmax."""
    s = _scores(q, k, scale, causal)
    m = s.amax(-1, keepdim=True)
    p = _exp_scores(s, m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()) \
        / torch.clamp(l, min=1e-20)
    return out.to(q.dtype), m, l


def flash_bwd_plain(q, k, v, out, m, l, g, scale, causal):
    """The plain PyTorch backward, the formula of the reference's
    `_flash_bwd_blockwise` written densely: delta = sum(dO * O),
    p recomputed from m and l, ds = p (dP - delta) scale. Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    gf = g.float()
    delta = (gf * out.float()).sum(-1, keepdim=True)
    p = _exp_scores(_scores(q, k, scale, causal), m) \
        / torch.clamp(l, min=1e-20)
    dv = torch.einsum("bqk,bqd->bkd", p, gf)
    dp = torch.einsum("bqd,bkd->bqk", gf, v.float())
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise MXNetError("flash_attention: %s must be [BH, T, D], got %s"
                             % (name, tuple(t.shape)))
        if t.dtype != q.dtype or t.device != q.device:
            raise MXNetError("flash_attention: %s is %s on %s, q is %s on %s"
                             % (name, t.dtype, t.device, q.dtype, q.device))
    if k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[2] != q.shape[2]:
        raise MXNetError("flash_attention: q %s, k %s, v %s do not match"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))


def _kernel_ready(t):
    """Contiguous and 16-byte aligned, as the kernels load 16 bytes at a
    time: a copy for a transposed view or an odd offset, else `t`."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch_args(q, k, causal, what):
    if q.device.type != "cuda":
        raise MXNetError("%s: no kernel for device %s" % (what, q.device))
    BH, T, D = q.shape
    limit = flash_limit(D, T, k.shape[1], causal, q.dtype, BH)
    if limit is not None:
        raise MXNetError("%s: %s" % (what, limit))
    from . import _cuda
    return _cuda, _cuda.library("flash_attention.cu")


def flash_attention_fwd(q, k, v, scale, causal):
    """Forward over [BH, T, D] q and [BH, Tk, D] k, v -> (out, m, l) as
    `flash_fwd_plain`. CUDA tensors launch the kernel (counted in
    `flash_attention_fwd.launches`) or raise; CPU tensors take
    `flash_fwd_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal)
    _cuda, lib = _launch_args(q, k, causal, "flash_attention forward")
    if scale < 0:  # the kernel scales the row max of q k^T, so scale >= 0:
        q, scale = -q, -scale  # (-q) k^T |scale| is q k^T scale, exactly
    q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
    BH, T, D = q.shape
    out = torch.empty_like(q)
    m = torch.empty((BH, T, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_flash_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), BH, T, k.shape[1],
            D, float(scale), int(bool(causal)), stream)
    _cuda.check(lib, err, "flash_attention forward kernel launch")
    flash_attention_fwd.launches += 1
    return out, m, l


def flash_attention_bwd(q, k, v, out, m, l, g, scale, causal):
    """Backward -> (dq, dk, dv) as `flash_bwd_plain`. CUDA tensors launch
    the three backward kernels (delta, dq, dk/dv) through one C entry,
    counted once in `flash_attention_bwd.launches`, or raise; CPU tensors
    take `flash_bwd_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, out, m, l, g, scale, causal)
    _cuda, lib = _launch_args(q, k, causal, "flash_attention backward")
    BH, T, D = q.shape
    if tuple(g.shape) != (BH, T, D) or tuple(out.shape) != (BH, T, D) \
            or g.dtype != q.dtype or out.dtype != q.dtype:
        raise MXNetError("flash_attention backward: out %s %s and g %s %s "
                         "must be q's shape and dtype %s %s"
                         % (tuple(out.shape), out.dtype, tuple(g.shape),
                            g.dtype, tuple(q.shape), q.dtype))
    q, k, v, out, g = (_kernel_ready(t) for t in (q, k, v, out, g))
    m, l = m.float().contiguous(), l.float().contiguous()
    delta = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mxtt_flash_bwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), g.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, T, k.shape[1], D, float(scale), int(bool(causal)), stream)
    _cuda.check(lib, err, "flash_attention backward kernel launch")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


#: kernel launches so far (plain-version calls on the CPU do not count)
flash_attention_fwd.launches = 0
flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """Forward and backward are the kernels (CUDA) or their plain
    versions (CPU). Saves (q, k, v, out, m, l), as the reference's
    custom_vjp fwd does."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, m, l = flash_attention_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, m, l, g, ctx.scale,
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention over [B, H, T, D] (or [BH, T, D]) q/k/v; k and v
    may have another length Tk (not when causal). Differentiable: the
    backward is the flash backward, from the saved softmax statistics,
    with no [T, Tk] matrix kept. Returns q's shape and dtype."""
    squeeze = q.dim() == 4
    if squeeze:
        B, H, T, D = q.shape
        q3 = q.reshape(B * H, T, D)
        k3 = k.reshape(B * H, k.shape[2], D)
        v3 = v.reshape(B * H, v.shape[2], D)
    else:
        q3, k3, v3 = q, k, v
    scale = 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)
    out3 = _FlashAttention.apply(q3, k3, v3, scale, bool(causal))
    return out3.reshape(q.shape) if squeeze else out3
