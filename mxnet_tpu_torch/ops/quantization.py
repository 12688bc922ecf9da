"""int8 weight quantization for the serving path (port of the
weight-quant helpers of `mxnet_tpu/ops/quantization.py`).

`quantize_channelwise` turns a float weight into int8 with one float32
scale per output channel; `dynamic_quant_matmul` multiplies a float
activation by such a weight, quantizing the activation per row on the
fly and contracting s8 x s8 -> s32; `maybe_quant_matmul` is the engine's
matmul, which takes either a plain weight or a `{"q", "s"}` dict.

The s8 x s8 -> s32 contraction is a plain matrix product outside any
Pallas kernel in the reference (an XLA `dot_general`), so on CUDA it is
`torch._int_mm`. That call wants more than 16 rows and inner and output
extents that are multiples of 8: the rows are zero-padded to a multiple
of 32 (a decode batch has 1-8) and the result sliced; an extent that is
not a multiple of 8 raises. On the CPU the product is an int32 matmul,
exact as the reference's s32 accumulate is (127^2 * 2048 < 2^31).

The contrib ops the reference registers in the same file (quantize,
dequantize, quantized FC and conv) wait for the op registry of the
framework-core slice.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

_INT8_RANGE = 127.0


def div_int8_range(t):
    """t / 127, divided TRULY on every device. A Python-number divisor
    would make PyTorch's CUDA kernel multiply by its rounded reciprocal,
    an ulp off the CPU's (and the reference's) quotient in some
    elements; a 0-dim tensor on the same device keeps the division."""
    return t / t.new_full((), _INT8_RANGE)


def int8_scale(amax):
    """Symmetric int8 scale: max(amax, 1e-12) / 127."""
    return div_int8_range(torch.clamp(amax, min=1e-12))


def quantize_channelwise(w, axis=-1):
    """Per-channel symmetric int8: one float32 scale per slice of `axis`
    (every other axis reduced). Returns (q int8, scales float32) with the
    scales shaped like `axis`'s extent."""
    nd = w.dim()
    axis %= nd
    red = tuple(i for i in range(nd) if i != axis)
    wf = w.float()
    # an empty dim tuple would make amax reduce every axis
    amax = wf.abs().amax(dim=red) if red else wf.abs()
    s = int8_scale(amax)
    shape = [1] * nd
    shape[axis] = -1
    q = torch.clamp(torch.round(wf / s.reshape(shape)), -127, 127)
    return q.to(torch.int8), s


def _int8_matmul(xq, w_q):
    """(N, I) int8 @ (I, O) int8 -> (N, O) int32."""
    if xq.device.type == "cpu":
        return xq.int() @ w_q.int()
    if xq.device.type != "cuda":
        raise MXNetError("dynamic_quant_matmul: no int8 matmul for device "
                         "%s" % (xq.device,))
    n, inner = xq.shape
    out = w_q.shape[1]
    if inner % 8 or out % 8:
        raise MXNetError("dynamic_quant_matmul: torch._int_mm needs inner "
                         "and output extents that are multiples of 8, got "
                         "(%d, %d)" % (inner, out))
    rows = max(32, -(-n // 32) * 32)
    if rows != n:
        xq = torch.cat([xq, xq.new_zeros((rows - n, inner))])
    return torch._int_mm(xq, w_q)[:n]


def dynamic_quant_matmul(x, w_q, w_s):
    """x (..., I) float @ per-output-channel int8 weight (I, O): the
    activation is quantized per row (its own symmetric scale), the
    product runs s8 x s8 -> s32, and the accumulator is dequantized by
    the product of the two scales in the reference's order
    (`acc * sx * w_s`). Returns float32."""
    xf = x.float()
    sx = int8_scale(xf.abs().amax(dim=-1, keepdim=True))
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    lead = xq.shape[:-1]
    acc = _int8_matmul(xq.reshape(-1, xq.shape[-1]), w_q)
    acc = acc.reshape(*lead, w_q.shape[1])
    return acc.float() * sx * w_s


def maybe_quant_matmul(x, w):
    """Matmul against a possibly quantized weight: a tensor goes straight
    through `x @ w`; a `{"q": int8, "s": float32}` dict goes through
    `dynamic_quant_matmul`, cast back to x's dtype."""
    if isinstance(w, dict):
        return dynamic_quant_matmul(x, w["q"], w["s"]).to(x.dtype)
    return x @ w
