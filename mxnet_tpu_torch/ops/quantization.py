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

The contrib ops the reference registers in the same file are the
int8 inference graph's (`contrib/quantization.py`): quantize,
dequantize, requantize and the quantized FullyConnected, Convolution,
Pooling and Flatten. Ranges travel beside the tensors as 0-dim (min,
max) tensors, as in the reference. Every scale is a true division by a
0-dim tensor (`_div`): a Python number on either side would make
PyTorch multiply by a rounded reciprocal (`127.0 / t` is
`t.reciprocal() * 127` on every device, `t / 127.0` on CUDA), and a
scale an ulp off flips `round` at a .5 boundary. Rounding is half to
even, as `jnp.rint`'s. The quantized FullyConnected contracts s8 x s8 ->
s32 (`_int8_matmul`, its extents zero-padded to `torch._int_mm`'s rule on
CUDA and the result sliced, exact in int32); the quantized convolution
computes from the integer values in float32 and rounds, as the
reference's does (exact while each partial sum stays below 2^24). The
ops also run on the "meta" device, which is how a Symbol infers their
shapes: requantize's dynamic range stays a pair of 0-dim tensors, never
a host number.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

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


def _int8_matmul(xq, w_q, pad=False):
    """(N, I) int8 @ (I, O) int8 -> (N, O) int32. On CUDA the rows are
    zero-padded to a multiple of 32; with `pad` the inner and output
    extents are zero-padded to multiples of 8 too (exact in int32),
    else such an extent raises."""
    if xq.device.type == "cpu":
        return xq.int() @ w_q.int()
    if xq.device.type != "cuda":
        raise MXNetError("dynamic_quant_matmul: no int8 matmul for device "
                         "%s" % (xq.device,))
    n, inner = xq.shape
    out = w_q.shape[1]
    if pad:
        inner8, out8 = -(-inner // 8) * 8, -(-out // 8) * 8
        if inner8 != inner or out8 != out:
            w_q = torch.nn.functional.pad(w_q, (0, out8 - out,
                                                0, inner8 - inner))
            xq = torch.nn.functional.pad(xq, (0, inner8 - inner))
            inner = inner8
    elif inner % 8 or out % 8:
        raise MXNetError("dynamic_quant_matmul: torch._int_mm needs inner "
                         "and output extents that are multiples of 8, got "
                         "(%d, %d)" % (inner, out))
    rows = max(32, -(-n // 32) * 32)
    if rows != n:
        xq = torch.cat([xq, xq.new_zeros((rows - n, inner))])
    return torch._int_mm(xq, w_q.contiguous())[:n, :out]


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


# ---------------------------------------------------------------------------
# the int8 inference graph's ops (contrib/quantization.py's rewrite)
# ---------------------------------------------------------------------------


def _div(a, b):
    """a / b, truly divided on every device: a Python number on either
    side becomes a 0-dim tensor of the other's dtype and device."""
    like = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = like.new_full((), float(a))
    if not isinstance(b, torch.Tensor):
        b = like.new_full((), float(b))
    return a / b


def _range(v, like):
    """A range bound as a float32 tensor beside `like`."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def _amax(min_range, max_range, like):
    return torch.maximum(_range(min_range, like).abs(),
                         _range(max_range, like).abs())


def _q_scale(min_range, max_range, like):
    """127 / max(|min|, |max|, 1e-12)."""
    return _div(_INT8_RANGE,
                torch.clamp(_amax(min_range, max_range, like), min=1e-12))


@register("_contrib_quantize", num_outputs=3, differentiable=False,
          aliases=("quantize",))
def quantize(data, min_range, max_range, out_type="int8"):
    """float -> int8 with symmetric scaling: (quantized, min_output,
    max_output)."""
    if out_type != "int8":
        raise MXNetError("quantize: only out_type='int8' is supported, "
                         "got %r" % (out_type,))
    scale = _q_scale(min_range, max_range, data)
    q = torch.clamp(torch.round(data.float() * scale), -127, 127)
    amax = _div(_INT8_RANGE, scale)
    return q.to(torch.int8), -amax, amax


@register("_contrib_dequantize", differentiable=False,
          aliases=("dequantize",))
def dequantize(data, min_range, max_range, out_type="float32"):
    """int8 / int32 -> float32. An int8 value counts amax / 127; an int32
    accumulator of s8 x s8 products counts amax / 127^2, the range of a
    product carrying amax_a * amax_b (`_int32_range_of_product`)."""
    amax = _amax(min_range, max_range, data)
    if data.dtype == torch.int8:
        scale = _div(amax, _INT8_RANGE)
    else:
        scale = _div(amax, _INT8_RANGE * _INT8_RANGE)
    return data.to(torch.float32) * scale


@register("_contrib_requantize", num_outputs=3, differentiable=False,
          aliases=("requantize",))
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 -> int8 over the calibrated range, or without one over the
    data's own min and max."""
    real = dequantize(data, min_range, max_range)
    if min_calib_range is not None and max_calib_range is not None:
        lo = _range(min_calib_range, real)
        hi = _range(max_calib_range, real)
    else:
        lo, hi = real.min(), real.max()
    return quantize(real, lo, hi)


def _int32_range_of_product(min_a, max_a, min_b, max_b, like):
    """The (min, max) of an int32 accumulator of s8 x s8 products: it
    carries amax_a * amax_b, so that `dequantize`'s int32 branch gives
    scale_a * scale_b a count."""
    real_per_unit = _div(1.0, _q_scale(min_a, max_a, like)
                         * _q_scale(min_b, max_b, like))
    amax = real_per_unit * (_INT8_RANGE * _INT8_RANGE)
    return -amax, amax


def _bias_int32(bias, min_data, max_data, min_weight, max_weight,
                min_bias, max_bias, like):
    """An int8 bias rescaled into the product's units, in int32."""
    rescale = _div(_q_scale(min_data, max_data, like)
                   * _q_scale(min_weight, max_weight, like),
                   _q_scale(min_bias, max_bias, like))
    return torch.round(bias.to(torch.float32) * rescale).to(torch.int32)


@register("_contrib_quantized_fully_connected", num_outputs=3,
          differentiable=False, aliases=("quantized_fully_connected",))
def quantized_fully_connected(data, weight, min_data, max_data,
                              min_weight, max_weight, bias=None,
                              min_bias=None, max_bias=None, num_hidden=0,
                              no_bias=False, flatten=True):
    """int8 x int8 -> int32 FullyConnected (weight (O, I)); an int8 bias
    with its own range is rescaled into the product's units and added in
    int32. Any O and I: `torch._int_mm`'s extents are padded."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    lead = x.shape[:-1]
    # a float tensor holding integers (a quantized weight in Module's
    # float arrays) casts exactly
    x2 = x.reshape(-1, x.shape[-1]).to(torch.int8)
    w = weight.to(torch.int8)
    if x2.device.type == "meta":  # shape inference
        out = x2.new_empty((x2.shape[0], w.shape[0]), dtype=torch.int32)
    else:
        out = _int8_matmul(x2, w.t(), pad=True)
    out = out.reshape(*lead, w.shape[0])
    if bias is not None and not no_bias:
        out = out + _bias_int32(bias, min_data, max_data, min_weight,
                                max_weight, min_bias, max_bias, data)
    lo, hi = _int32_range_of_product(min_data, max_data, min_weight,
                                     max_weight, data)
    return out, lo, hi


@register("_contrib_quantized_conv", num_outputs=3, differentiable=False,
          aliases=("quantized_conv",))
def quantized_conv(data, weight, min_data, max_data, min_weight,
                   max_weight, bias=None, min_bias=None, max_bias=None,
                   kernel=(), stride=(), dilate=(), pad=(), num_filter=0,
                   num_group=1, no_bias=False, layout="NCHW"):
    """int8 convolution accumulating in int32: computed from the integer
    values in float32 and rounded (the reference's route)."""
    from .nn import Convolution
    out_f = Convolution(data.to(torch.float32), weight.to(torch.float32),
                        None, kernel=kernel, stride=stride, dilate=dilate,
                        pad=pad, num_filter=num_filter, num_group=num_group,
                        no_bias=True)
    out = torch.round(out_f).to(torch.int32)
    if bias is not None and not no_bias:
        b = _bias_int32(bias, min_data, max_data, min_weight, max_weight,
                        min_bias, max_bias, data)
        out = out + b.reshape((1, -1) + (1,) * (out.dim() - 2))
    lo, hi = _int32_range_of_product(min_data, max_data, min_weight,
                                     max_weight, data)
    return out, lo, hi


@register("_contrib_quantized_pooling", num_outputs=3,
          differentiable=False, aliases=("quantized_pooling",))
def quantized_pooling(data, min_data, max_data, kernel=(), stride=(),
                      pad=(), pool_type="max", global_pool=False,
                      pooling_convention="valid"):
    """Pooling on int8, keeping the input's range; an average rounds."""
    from .nn import Pooling
    out = Pooling(data.to(torch.float32), kernel=kernel, stride=stride,
                  pad=pad, pool_type=pool_type, global_pool=global_pool,
                  pooling_convention=pooling_convention)
    if pool_type != "max":
        out = torch.clamp(torch.round(out), -127, 127)
    return out.to(torch.int8), min_data, max_data


@register("_contrib_quantized_flatten", num_outputs=3,
          differentiable=False, aliases=("quantized_flatten",))
def quantized_flatten(data, min_data, max_data):
    return data.reshape(data.shape[0], -1), min_data, max_data
