"""Neural-network ops of the ResNet training path (port of the matching
share of `mxnet_tpu/ops/nn.py`): Activation, softmax / log_softmax,
FullyConnected, Convolution, Pooling, BatchNorm and
_contrib_BatchNormAddRelu.

Convolutions, fully connected layers and pooling run outside any Pallas
kernel in the reference (lax.conv_general_dilated, jnp.matmul,
lax.reduce_window); here they are torch's conv / linear / pooling
functions, in the reference's layouts (NCHW data, OIHW weights; a
channels-last layout is permuted around the channels-first call). The
BatchNorm ops keep the reference's selection rule: with
MXNET_FUSED_BN_EPILOGUE=1, in training mode, for channel axis 1, float32
or bfloat16 data and (for the residual op) an addend of the same shape,
they call `ops.fused_bn.fused_bn_act`, whose K3a-d kernels run on the
card; everything else composes the same math from torch ops, exactly as
the reference composes it from XLA ops. The rest of the reference file is
listed in ROADMAP.md, queue 1.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import autograd
from . import fused_bn
from .registry import register

# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": F.softplus, "softsign": F.softsign,
}

for _name in ("relu", "sigmoid", "softrelu", "softsign"):
    def _mka(fn):
        def act_op(data):
            return fn(data)
        return act_op
    register(_name)(_mka(_ACTIVATIONS[_name]))


@register("Activation")
def Activation(data, act_type="relu"):
    if act_type not in _ACTIVATIONS:
        raise ValueError("unknown act_type %s" % act_type)
    return _ACTIVATIONS[act_type](data)


# ---------------------------------------------------------------------------
# softmax family
# ---------------------------------------------------------------------------


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    x = data / temperature if temperature else data
    if length is None:
        return torch.softmax(x, dim=axis)
    steps = torch.arange(data.shape[axis], device=data.device)
    mask = steps[None, :] < length.long()[:, None]
    shape = [1] * data.dim()
    shape[0] = data.shape[0]
    shape[axis] = data.shape[axis]
    mask = mask.reshape(shape)
    out = torch.softmax(x.masked_fill(~mask, float("-inf")), dim=axis)
    return out.masked_fill(~mask, 0.0)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


# ---------------------------------------------------------------------------
# FullyConnected, Convolution, Pooling
# ---------------------------------------------------------------------------


@register("FullyConnected")
def FullyConnected(data, weight, bias=None, num_hidden=0, no_bias=False,
                   flatten=True):
    """weight: (num_hidden, in_units), as the reference's."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


_CHANNELS_LAST = ("NWC", "NHWC", "NDHWC")
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _tup(v, nd, default):
    if not v:
        return (default,) * nd
    if np.isscalar(v):
        return (int(v),) * nd
    return tuple(int(x) for x in v)


def _to_first(x):
    """Channels-last [N, *S, C] -> channels-first [N, C, *S]."""
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_last(x):
    return x.permute(0, *range(2, x.dim()), 1)


@register("Convolution", aliases=("Convolution_v1",))
def Convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, workspace=1024,
                no_bias=False, cudnn_tune=None, cudnn_off=False, layout=None):
    """Channels-first data with (O, I/groups, *kernel) weights; a
    channels-last layout stores the weight as (O, *kernel, I), as the
    reference does."""
    nd = len(kernel)
    last = layout in _CHANNELS_LAST
    x = _to_first(data) if last else data
    w = _to_first(weight) if last else weight
    b = bias if (bias is not None and not no_bias) else None
    out = _CONV[nd](x, w, b, stride=_tup(stride, nd, 1),
                    padding=_tup(pad, nd, 0), dilation=_tup(dilate, nd, 1),
                    groups=num_group)
    return _to_last(out) if last else out


_POOL = {"max": {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d},
         "avg": {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}}


@register("Pooling", aliases=("Pooling_v1",))
def Pooling(data, kernel=(), pool_type="max", global_pool=False,
            cudnn_off=False, pooling_convention="valid", stride=(), pad=(),
            p_value=2, count_include_pad=True, layout=None):
    """max / avg / sum / lp pooling with the reference's padding rule: the
    padded border is -inf for max and 0 otherwise; "full" adds the extra
    right padding that lets the last window fit (ceil mode)."""
    last = layout in _CHANNELS_LAST
    x = _to_first(data) if last else data
    nd = x.dim() - 2
    if global_pool:
        ax = tuple(range(2, 2 + nd))
        if pool_type == "max":
            out = torch.amax(x, dim=ax, keepdim=True)
        elif pool_type in ("avg", "sum"):
            out = torch.sum(x, dim=ax, keepdim=True)
            if pool_type == "avg":
                out = out / float(np.prod([x.shape[a] for a in ax]))
        elif pool_type == "lp":
            out = torch.pow(torch.sum(torch.pow(torch.abs(x), p_value),
                                      dim=ax, keepdim=True), 1.0 / p_value)
        else:
            raise ValueError("unknown pool_type %s" % pool_type)
        return _to_last(out) if last else out
    kernel = _tup(kernel, nd, 1)
    stride = _tup(stride, nd, 1)
    pad = _tup(pad, nd, 0)
    extra = [0] * nd
    if pooling_convention == "full":
        for i in range(nd):
            size = x.shape[2 + i] + 2 * pad[i]
            n_out = int(np.ceil((size - kernel[i]) / stride[i])) + 1
            extra[i] = max(0, (n_out - 1) * stride[i] + kernel[i] - size)
    native = not any(extra) and all(2 * p <= k for p, k in zip(pad, kernel))
    if pool_type == "max" and native:
        out = _POOL["max"][nd](x, kernel, stride, pad)
    elif pool_type == "avg" and native and count_include_pad:
        out = _POOL["avg"][nd](x, kernel, stride, pad,
                               count_include_pad=True)
    else:
        out = _pool_padded(x, kernel, stride, pad, extra, pool_type,
                           p_value, count_include_pad)
    return _to_last(out) if last else out


def _pool_padded(x, kernel, stride, pad, extra, pool_type, p_value,
                 count_include_pad):
    """Pooling over an explicitly padded input (padding torch's pooling
    functions do not take: wider than half the window, or ceil mode)."""
    nd = len(kernel)
    widths = []
    for p, e in reversed(list(zip(pad, extra))):
        widths += [p, p + e]

    def windows(t, fill):
        t = F.pad(t, widths, value=fill)
        for i in range(nd):
            t = t.unfold(2 + i, kernel[i], stride[i])
        return t.flatten(-nd)

    if pool_type == "max":
        return torch.amax(windows(x, float("-inf")), dim=-1)
    if pool_type in ("avg", "sum"):
        summed = torch.sum(windows(x, 0.0), dim=-1)
        if pool_type == "sum":
            return summed
        if count_include_pad:
            return summed / float(np.prod(kernel))
        counts = torch.sum(windows(torch.ones_like(x), 0.0), dim=-1)
        return summed / torch.clamp(counts, min=1)
    if pool_type == "lp":
        summed = torch.sum(windows(torch.pow(torch.abs(x), p_value), 0.0),
                           dim=-1)
        return torch.pow(summed, 1.0 / p_value)
    raise ValueError("unknown pool_type %s" % pool_type)


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


def _fused_selected(data, axis, addend=None):
    """The reference's selection rule for the fused kernels: the flag on,
    a shape, dtype and channel axis the fused path takes, and an addend
    (if any) of data's shape."""
    return (fused_bn.fuse_enabled()
            and fused_bn.fused_bn_supported(data, axis)
            and (addend is None or tuple(addend.shape) == tuple(data.shape)))


def _stat_dtype(dtype):
    """float32, or float64 for float64 data (jnp.promote_types(dt, f32))."""
    return torch.float64 if dtype == torch.float64 else torch.float32


@register("BatchNorm", num_outputs=3, aliases=("BatchNorm_v1",))
def BatchNorm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
              momentum=0.9, fix_gamma=True, use_global_stats=False,
              output_mean_var=False, axis=1, cudnn_off=False):
    """Returns (out, batch_mean, batch_var), the stats in gamma's dtype;
    the moving-stat update is the caller's (gluon.nn.BatchNorm)."""
    ax = axis % data.dim()
    red_ax = tuple(a for a in range(data.dim()) if a != ax)
    shape = [1] * data.dim()
    shape[ax] = data.shape[ax]
    g = torch.ones_like(gamma) if fix_gamma else gamma
    training = autograd.is_training() and not use_global_stats
    if training:
        if _fused_selected(data, axis):
            out, mean, var = fused_bn.fused_bn_act(data, g, beta, eps=eps)
            return out, mean.to(gamma.dtype), var.to(gamma.dtype)
        # one-pass statistics in float32 (float64 for float64 data):
        # E[x] and E[x^2] in one read of the activation, as the reference
        xf = data.to(_stat_dtype(data.dtype))
        mean = torch.mean(xf, dim=red_ax)
        var = torch.clamp(torch.mean(torch.square(xf), dim=red_ax)
                          - torch.square(mean), min=0.0)
        mean_b, var_b = mean, var
    else:
        mean, var = moving_mean, moving_var
        mean_b, var_b = mean.detach(), var.detach()
    # fold into one per-channel affine in >= float32, apply in data's dtype
    sdt = _stat_dtype(data.dtype)
    inv = torch.rsqrt(var_b.to(sdt) + eps)
    scale = g.to(sdt) * inv
    offset = beta.to(sdt) - mean_b.to(sdt) * scale
    out = (data * scale.reshape(shape).to(data.dtype)
           + offset.reshape(shape).to(data.dtype))
    return out, mean.to(gamma.dtype), var.to(gamma.dtype)


@register("_contrib_BatchNormAddRelu", num_outputs=3,
          aliases=("BatchNormAddRelu",))
def BatchNormAddRelu(data, gamma, beta, moving_mean, moving_var, addend=None,
                     eps=1e-3, momentum=0.9, fix_gamma=True,
                     use_global_stats=False, axis=1, act_type="relu"):
    """act(BN(data) + addend) as one op: (out, batch_mean, batch_var). With
    MXNET_FUSED_BN_EPILOGUE=1 the training-mode chain runs through the
    fused kernels; otherwise it composes BatchNorm, the add and the relu.
    act_type: "relu" or None."""
    if act_type not in (None, "None", "relu"):
        raise ValueError("BatchNormAddRelu supports act_type 'relu' or "
                         "None, got %r" % (act_type,))
    relu = act_type == "relu"
    training = autograd.is_training() and not use_global_stats
    if training and _fused_selected(data, axis, addend):
        g = torch.ones_like(gamma) if fix_gamma else gamma
        out, mean, var = fused_bn.fused_bn_act(
            data, g, beta, eps=eps, act="relu" if relu else None,
            residual=addend)
        return out, mean.to(gamma.dtype), var.to(gamma.dtype)
    out, mean, var = BatchNorm(data, gamma, beta, moving_mean, moving_var,
                               eps=eps, momentum=momentum,
                               fix_gamma=fix_gamma,
                               use_global_stats=use_global_stats, axis=axis)
    if addend is not None:
        out = out + addend.to(out.dtype)
    if relu:
        out = torch.relu(out)
    return out, mean, var
