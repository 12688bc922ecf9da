"""Neural-network ops (port of `mxnet_tpu/ops/nn.py`, all of it):
Activation, LeakyReLU (leaky, prelu, elu, selu, rrelu), hard_sigmoid,
softmax / log_softmax / softmin / SoftmaxActivation, the loss heads the
symbolic models end in (SoftmaxOutput, the regression outputs,
SVMOutput, make_loss), FullyConnected, Convolution, Deconvolution,
Pooling, BatchNorm, _contrib_BatchNormAddRelu, LayerNorm, InstanceNorm,
LRN, Dropout, the fused multi-layer RNN op, UpSampling and the resizing
ops, the spatial transforms (GridGenerator, BilinearSampler,
SpatialTransformer), ROIPooling, Correlation, Crop,
IdentityAttachKLSparseReg and the image ops.

Convolutions, fully connected layers and pooling run outside any Pallas
kernel in the reference (lax.conv_general_dilated, jnp.matmul,
lax.reduce_window); here they are torch's conv / linear / pooling
functions, in the reference's layouts (NCHW data, OIHW weights; a
channels-last layout is permuted around the channels-first call), and
Deconvolution is torch's transposed convolution, whose weight layout
(C_in, C_out / groups, *kernel) is the reference's. The
BatchNorm ops keep the reference's selection rule: with
MXNET_FUSED_BN_EPILOGUE=1, in training mode, for channel axis 1, float32
or bfloat16 data and (for the residual op) an addend of the same shape,
they call `ops.fused_bn.fused_bn_act`, whose K3a-d kernels run on the
card; everything else composes the same math from torch ops, exactly as
the reference composes it from XLA ops.

Inside a segment of TrainStep(remat="io") a Convolution's output, a
FullyConnected's product and a training BatchNorm's batch statistics are
kept from the segment's first run and not computed again in its
recompute (ops/remat.py): those three then run through the autograd
Functions `_KeptConv`, `_KeptLinear` and `_KeptStats`, whose backward is
the one torch's autograd computes for the plain call.

The RNN op keeps the reference's structure: each layer-direction hoists
its input projection out of the recurrence as one matmul (`_scan_layer`),
and the recurrence itself runs either as the composite loop (one
`h @ wh.T` a step, the reference's lax.scan and the card's oracle) or,
with MXNET_FUSED_RNN=1 (or `fused=True`) for lstm, rnn_relu and rnn_tanh,
through `ops.fused_rnn`, whose K4a-b kernels run on the card. Dropout and
the RNN op's inter-layer dropout draw their masks from the port's
generators (`mxnet_tpu_torch.random`).

The resizing ops keep jax.image.resize's sampling: half-pixel centres,
and a triangle filter widened when an axis shrinks, which is torch's
antialiased bilinear interpolation in either direction; its "nearest" is
torch's "nearest-exact".
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import autograd
from ..random import generator
from . import fused_bn
from . import fused_rnn
from . import remat as _remat
from .registry import register

# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------

def _promote(data):
    """Integer and bool data as float32, the dtype jax's float functions
    (softplus, softmax, log_softmax) return for them."""
    return data if data.is_floating_point() else data.float()


_ACTIVATIONS = {
    "relu": torch.relu, "sigmoid": torch.sigmoid, "tanh": torch.tanh,
    "softrelu": lambda x: F.softplus(_promote(x)), "softsign": F.softsign,
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


_SELU_ALPHA, _SELU_SCALE = 1.6732632423543772, 1.0507009873554805


@register("LeakyReLU", stochastic=True)
def LeakyReLU(data, gamma=None, act_type="leaky", slope=0.25,
              lower_bound=0.125, upper_bound=0.334):
    """The leaky family: leaky (x < 0 scaled by slope), prelu (by the
    learned gamma, one per channel of axis 1 when 1-D), elu, selu, and
    rrelu, whose negative slopes are drawn uniformly from [lower_bound,
    upper_bound) in training (from the device's generator) and are their
    mean otherwise."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            data > 0, data, _SELU_ALPHA * torch.expm1(data))
    if act_type == "rrelu":
        if autograd.is_training():
            dev = data.device
            slopes = torch.rand(data.shape, generator=generator(dev),
                                device=dev, dtype=data.dtype)
            slopes = lower_bound + (upper_bound - lower_bound) * slopes
        else:
            slopes = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, slopes * data)
    raise ValueError("unknown act_type %s" % act_type)


# ---------------------------------------------------------------------------
# softmax family
# ---------------------------------------------------------------------------


@register("softmax")
def softmax(data, axis=-1, temperature=None, length=None):
    data = _promote(data)
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
    data = _promote(data)
    x = data / temperature if temperature else data
    return torch.log_softmax(x, dim=axis)


# ---------------------------------------------------------------------------
# loss heads (parity: the reference's custom-VJP heads, ops/nn.py:141-262)
#
# Each head's backward is the reference's hand-written gradient, not the
# derivative of its forward: it ignores the head gradient that reaches it
# (the executor feeds ones), and the label's gradient is zero.
# ---------------------------------------------------------------------------


def _one_hot(label, k, axis, dtype):
    """one_hot(label, k) inserted at `axis`; ids outside [0, k) give a
    zero row, as jax.nn.one_hot does."""
    ids = label.long().unsqueeze(axis)
    shape = [1] * ids.dim()
    shape[axis] = k
    classes = torch.arange(k, device=label.device).reshape(shape)
    return (ids == classes).to(dtype)


def _zero_label_grad(ctx, label):
    return torch.zeros_like(label) if ctx.needs_input_grad[1] else None


class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, p):
        ctx.save_for_backward(data, label)
        ctx.p = p
        return torch.softmax(data, dim=p["axis"])

    @staticmethod
    def backward(ctx, _head_grad):
        d, lab = ctx.saved_tensors
        p = ctx.p
        axis = p["axis"] % d.dim()
        k = d.shape[axis]
        onehot = _one_hot(lab, k, axis, d.dtype)
        if p["smooth_alpha"]:
            onehot = onehot * (1.0 - p["smooth_alpha"]) \
                + p["smooth_alpha"] / (k - 1)
        grad = torch.softmax(d, dim=axis) - onehot
        keep = lab.long() != int(p["ignore_label"])
        if p["use_ignore"]:
            grad = grad * keep.unsqueeze(axis).to(d.dtype)
        scale = p["grad_scale"]
        if p["normalization"] == "batch":
            scale = scale / d.shape[0]
        elif p["normalization"] == "valid":
            if p["use_ignore"]:
                scale = scale / torch.clamp(keep.to(d.dtype).sum(), min=1.0)
            else:
                scale = scale / float(np.prod(lab.shape))
        return grad * scale, _zero_label_grad(ctx, lab), None


@register("SoftmaxOutput", aliases=("Softmax",))
def SoftmaxOutput(data, label, grad_scale=1.0, ignore_label=-1.0,
                  use_ignore=False, normalization="null", multi_output=False,
                  preserve_shape=False, out_grad=False, smooth_alpha=0.0):
    """Softmax over the last axis (axis 1 with multi_output and more than
    two dims); its gradient is (softmax - onehot(label)) * grad_scale,
    smoothed by smooth_alpha, masked by ignore_label under use_ignore and
    divided by the batch ("batch") or the valid labels ("valid")."""
    p = {"axis": 1 if (multi_output and data.dim() > 2) else -1,
         "grad_scale": grad_scale, "ignore_label": ignore_label,
         "use_ignore": use_ignore, "normalization": normalization,
         "smooth_alpha": smooth_alpha}
    return _SoftmaxOutput.apply(data, label, p)


class _RegressionHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = torch.sigmoid(data) if kind == "logistic" else data
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, lab = ctx.saved_tensors
        num_out = float(np.prod(out.shape[1:])) if out.dim() > 1 else 1.0
        diff = out - lab
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        return (diff * (ctx.grad_scale / num_out),
                _zero_label_grad(ctx, lab), None, None)


def _regression_head(kind):
    def head(data, label, grad_scale=1.0):
        return _RegressionHead.apply(data, label.reshape(data.shape), kind,
                                     grad_scale)
    return head


register("LinearRegressionOutput")(_regression_head("linear"))
register("MAERegressionOutput")(_regression_head("mae"))
register("LogisticRegressionOutput")(_regression_head("logistic"))


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.args = (margin, coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, _head_grad):
        d, lab = ctx.saved_tensors
        margin, coef, use_linear = ctx.args
        onehot = _one_hot(lab, d.shape[-1], d.dim() - 1, d.dtype)
        score_correct = torch.sum(d * onehot, dim=-1, keepdim=True)
        gap = margin - (score_correct - d)
        wrong = (gap > 0) & (onehot == 0)
        zero = torch.zeros((), dtype=d.dtype, device=d.device)
        gwrong = torch.where(wrong, torch.ones_like(d) if use_linear
                             else 2.0 * gap, zero)
        gright = -torch.sum(gwrong, dim=-1, keepdim=True) * onehot
        return ((gwrong + gright) * coef, _zero_label_grad(ctx, lab), None,
                None, None)


@register("SVMOutput")
def SVMOutput(data, label, margin=1.0, regularization_coefficient=1.0,
              use_linear=False):
    """Identity forward; the (squared, or linear) hinge gradient."""
    return _SVMOutput.apply(data, label, margin, regularization_coefficient,
                            use_linear)


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, scale):
        ctx.scale = scale
        return data.clone()

    @staticmethod
    def backward(ctx, head_grad):
        return torch.full_like(head_grad, ctx.scale), None


@register("make_loss", aliases=("MakeLoss",))
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Identity forward whose gradient is grad_scale (divided by the batch
    under normalization="batch"), whatever the head gradient."""
    scale = grad_scale / data.shape[0] if normalization == "batch" \
        else grad_scale
    return _MakeLoss.apply(data, scale)


# ---------------------------------------------------------------------------
# FullyConnected, Convolution, Pooling
# ---------------------------------------------------------------------------


@register("FullyConnected")
def FullyConnected(data, weight, bias=None, num_hidden=0, no_bias=False,
                   flatten=True):
    """weight: (num_hidden, in_units), as the reference's."""
    x = data.reshape(data.shape[0], -1) if flatten else data
    if _remat.keeping():
        x2 = x.reshape(-1, x.shape[-1])
        out = _KeptLinear.apply(x2, weight).reshape(
            tuple(x.shape[:-1]) + (weight.shape[0],))
    else:
        out = torch.matmul(x, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


_CHANNELS_LAST = ("NWC", "NHWC", "NDHWC")
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


class _KeptLinear(torch.autograd.Function):
    """x2 @ w.T tagged "fc_out" (remat "io"), with autograd's gradients
    of `torch.mm(x2, w.t())`."""

    @staticmethod
    def forward(ctx, x2, w):
        out = _remat.kept("fc_out")
        if out is None:
            out = _remat.checkpoint_name(torch.mm(x2, w.t()), "fc_out")
        ctx.save_for_backward(x2, w)
        return out

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gx = g.mm(w) if ctx.needs_input_grad[0] else None
        gw = x2.t().mm(g).t() if ctx.needs_input_grad[1] else None
        return gx, gw


class _KeptConv(torch.autograd.Function):
    """A convolution tagged "conv_out" (remat "io"; the bias, if any,
    inside, as the plain call adds it), with the gradients of aten's
    convolution_backward, which autograd calls for the plain
    convolution."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation, groups):
        out = _remat.kept("conv_out")
        if out is None:
            out = _remat.checkpoint_name(
                _CONV[x.dim() - 2](x, w, b, stride=stride, padding=padding,
                                   dilation=dilation, groups=groups),
                "conv_out")
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups,
                    None if b is None else [b.shape[0]])
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, bias_sizes = ctx.conf
        need = ctx.needs_input_grad
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g, x, w, bias_sizes, list(stride), list(padding),
            list(dilation), False, [0] * len(stride), groups,
            [need[0], need[1], bias_sizes is not None and need[2]])
        return gx, gw, gb, None, None, None, None


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
    conf = (_tup(stride, nd, 1), _tup(pad, nd, 0), _tup(dilate, nd, 1))
    if _remat.keeping():
        out = _KeptConv.apply(x, w, b, *conf, num_group)
    else:
        out = _CONV[nd](x, w, b, stride=conf[0], padding=conf[1],
                        dilation=conf[2], groups=num_group)
    return _to_last(out) if last else out


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution")
def Deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=0, num_group=1,
                  workspace=512, no_bias=True, cudnn_tune=None,
                  cudnn_off=False, layout=None):
    """The transposed convolution of channels-first data with the
    reference's (C_in, num_filter / num_group, *kernel) weights: each
    spatial size out = (in - 1) * stride - 2 * pad + dilate * (kernel - 1)
    + adj + 1. target_shape is accepted and ignored, as the reference's
    is."""
    if layout in _CHANNELS_LAST:
        raise NotImplementedError(
            "Deconvolution supports channel-first layouts only; transpose "
            "the data or use the default NCHW layout")
    nd = len(kernel)
    b = bias if (bias is not None and not no_bias) else None
    return _CONV_T[nd](data, weight, b, stride=_tup(stride, nd, 1),
                       padding=_tup(pad, nd, 0),
                       output_padding=_tup(adj, nd, 0), groups=num_group,
                       dilation=_tup(dilate, nd, 1))


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
    sizes = [(x.shape[2 + i] + 2 * pad[i] + extra[i] - kernel[i])
             // stride[i] + 1 for i in range(nd)]
    if not nd:
        # no spatial axis: each window is one element (the reference's
        # reduce_window over an empty window), so max / avg / sum give
        # the input back
        if pool_type == "lp":
            return torch.pow(torch.pow(torch.abs(data), p_value),
                             1.0 / p_value)
        return data
    if min(sizes) <= 0:
        # a window wider than the padded input: an empty result, as the
        # reference's reduce_window gives (still attached to the graph)
        out = x.flatten()[:0].reshape(
            tuple(x.shape[:2]) + tuple(max(0, n) for n in sizes))
        return _to_last(out) if last else out
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


def _batch_stats(xf, red_ax):
    """(E[x], max(E[x^2] - E[x]^2, 0)) over red_ax."""
    mean = torch.mean(xf, dim=red_ax)
    var = torch.clamp(torch.mean(torch.square(xf), dim=red_ax)
                      - torch.square(mean), min=0.0)
    return mean, var


class _KeptStats(torch.autograd.Function):
    """`_batch_stats` tagged "bn_stats" (remat "io"), with the gradients
    autograd takes through its ops (clamp's mask from the first run)."""

    @staticmethod
    def forward(ctx, xf, red_ax):
        mean, var = _remat.kept("bn_stats"), _remat.kept("bn_stats")
        if mean is None:
            mean = torch.mean(xf, dim=red_ax)
            pre = torch.mean(torch.square(xf), dim=red_ax) \
                - torch.square(mean)
            ctx.mask = pre >= 0.0
            var = torch.clamp(pre, min=0.0)
            _remat.checkpoint_name(mean, "bn_stats")
            _remat.checkpoint_name(var, "bn_stats")
        ctx.save_for_backward(xf, mean)
        ctx.red_ax = red_ax
        return mean, var

    @staticmethod
    def backward(ctx, gm, gv):
        xf, mean = ctx.saved_tensors
        shape = [1] * xf.dim()
        for a in range(xf.dim()):
            if a not in ctx.red_ax:
                shape[a] = xf.shape[a]
        count = xf.numel() // mean.numel()
        gm = torch.zeros_like(mean) if gm is None else gm
        gv = torch.zeros_like(mean) if gv is None else gv
        gv = torch.where(ctx.mask, gv, torch.zeros_like(gv))
        g_sq = (gv / count).reshape(shape)
        g_mean = ((gm - 2.0 * mean * gv) / count).reshape(shape)
        return g_sq * (2.0 * xf) + g_mean, None


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
        if _remat.keeping():
            mean, var = _KeptStats.apply(xf, red_ax)
        else:
            mean, var = _batch_stats(xf, red_ax)
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


# ---------------------------------------------------------------------------
# LayerNorm, InstanceNorm
# ---------------------------------------------------------------------------


def _normalized(data, axes, eps):
    """(data - mean) / sqrt(var + eps) over `axes` (population
    variance)."""
    mean = torch.mean(data, dim=axes, keepdim=True)
    var = torch.var(data, dim=axes, keepdim=True, unbiased=False)
    return (data - mean) * torch.rsqrt(var + eps)


@register("LayerNorm")
def LayerNorm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    """Normalized over `axis`, then scaled by gamma and shifted by beta
    along it."""
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = _normalized(data, (axis,), eps)
    return out * gamma.reshape(shape) + beta.reshape(shape)


@register("InstanceNorm")
def InstanceNorm(data, gamma, beta, eps=1e-3):
    """Normalized over the spatial axes of each sample and channel, then
    scaled and shifted per channel (axis 1)."""
    out = _normalized(data, tuple(range(2, data.dim())), eps)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


# ---------------------------------------------------------------------------
# Dropout (parity: src/operator/nn/dropout-inl.h)
# ---------------------------------------------------------------------------


def _dropped(data, keep, shape):
    """data with each element kept with probability `keep` (one Bernoulli
    draw per element of `shape`, broadcast against data, from the
    device's generator) and scaled by 1 / keep, the rest zero."""
    dev = data.device
    mask = torch.rand(tuple(shape), generator=generator(dev), device=dev) \
        < keep
    return torch.where(mask, data / keep,
                       torch.zeros((), dtype=data.dtype, device=dev))


@register("Dropout", stochastic=True)
def Dropout(data, p=0.5, mode="training", axes=()):
    """Zero each element with probability p and scale the rest by
    1 / (1 - p), in training mode (always with mode="always"); `axes`
    share one mask draw along those axes."""
    if mode != "always" and not autograd.is_training():
        return data
    if p <= 0.0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    return _dropped(data, 1.0 - p, shape)


# ---------------------------------------------------------------------------
# fused RNN (parity: src/operator/rnn-inl.h:49 + cudnn_rnn-inl.h)
# ---------------------------------------------------------------------------


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    ngates = _gates(mode)
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * ngates * state_size * (in_sz + state_size + 2)
    return size


def _unpack_rnn_params(params, num_layers, input_size, state_size,
                       bidirectional, mode):
    """Slice the flat parameter vector into per-layer/direction weights,
    the reference's layout: for each layer, for each direction: W_i2h
    (G*H, in), W_h2h (G*H, H), b_i2h (G*H), b_h2h (G*H)."""
    ngates = _gates(mode)
    dirs = 2 if bidirectional else 1
    out = []
    off = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        layer_params = []
        for _ in range(dirs):
            gh = ngates * state_size
            wi = params[off:off + gh * in_sz].reshape(gh, in_sz)
            off += gh * in_sz
            wh = params[off:off + gh * state_size].reshape(gh, state_size)
            off += gh * state_size
            bi = params[off:off + gh]
            off += gh
            bh = params[off:off + gh]
            off += gh
            layer_params.append((wi, wh, bi, bh))
        out.append(layer_params)
    return out


def _cell_step(mode, px, h, c, wh, bh):
    """One recurrence step from a pre-projected input px (x @ wi.T plus
    the input-side bias, computed for the whole sequence outside the loop
    — see _scan_layer)."""
    if mode in ("rnn_relu", "rnn_tanh"):
        pre = px + h @ wh.t()
        return (torch.relu(pre) if mode == "rnn_relu" else torch.tanh(pre)), c
    if mode == "lstm":
        pre = px + h @ wh.t()
        i, f, g, o = torch.chunk(pre, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        g = torch.tanh(g)
        c2 = f * c + i * g
        return o * torch.tanh(c2), c2
    if mode == "gru":
        gh = h @ wh.t() + bh
        ir, iz, inn = torch.chunk(px, 3, dim=-1)
        hr, hz, hn = torch.chunk(gh, 3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        return (1 - z) * n + z * h, c
    raise ValueError(mode)


def _scan_layer(mode, xs, h0, c0, wi, wh, bi, bh, reverse=False,
                fused=None):
    """One (direction of one) RNN layer over [T, N, C]: (ys, hT, cT).

    The input projection of all T steps is hoisted out of the recurrence
    as one (T*N, C) @ (C, G*H) matmul, as the reference (and cuDNN's
    fused RNN) do. With MXNET_FUSED_RNN=1 (read at each call) or
    fused=True, an lstm, rnn_relu or rnn_tanh recurrence runs through
    `fused_rnn.fused_scan_layer` (K4a-b on the card; a layer outside its
    gate raises); gru always takes the loop below, as in the reference.
    Otherwise the loop runs one `h @ wh.T` a step: the reference's
    lax.scan, and the oracle of the fused path."""
    T, N = xs.shape[0], xs.shape[1]
    # the input-side bias folds into the hoisted projection; for gru the
    # hidden-side bias stays inside (it feeds the reset gate's product)
    bias = bi if mode == "gru" else bi + bh
    dt = torch.promote_types(xs.dtype, wi.dtype)
    pxs = (xs.to(dt).reshape(T * N, -1) @ wi.to(dt).t()
           + bias.to(dt)).reshape(T, N, -1)
    if mode != "gru" and fused_rnn.use_fused(fused):
        return fused_rnn.fused_scan_layer(mode, pxs, h0, c0, wh,
                                          reverse=reverse)
    # mixed dtypes (float32 states against bfloat16 data) promote, as in
    # the reference's lax.scan: the recurrence then runs in float32
    for t in (h0, c0, wh, bh):
        dt = torch.promote_types(dt, t.dtype)
    pxs, wh, bh = pxs.to(dt), wh.to(dt), bh.to(dt)
    h, c = h0.to(dt), c0.to(dt)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = _cell_step(mode, pxs[t], h, c, wh, bh)
        ys[t] = h
    return torch.stack(ys), h, c


@register("RNN", num_outputs=-1, stochastic=True)
def RNN(data, parameters, state, state_cell=None, state_size=0, num_layers=1,
        mode="lstm", bidirectional=False, p=0.0, state_outputs=False,
        projection_size=None, lstm_state_clip_min=None,
        lstm_state_clip_max=None, lstm_state_clip_nan=False, fused=None):
    """Fused multi-layer (bi)RNN over time-major [T, N, C] input.

    `fused`: None (default) honours MXNET_FUSED_RNN; True / False force
    the fused kernels on / off for this call (lstm, rnn_relu, rnn_tanh;
    gru always composes). States of another dtype than the data promote
    the composite recurrence, as the reference's do (float32 states
    against bfloat16 data run it in float32); the fused kernels take one
    dtype and raise on mixed ones. The projection and state-clip
    arguments are accepted and ignored, as the reference's are."""
    T, N, C = data.shape
    dirs = 2 if bidirectional else 1
    layers = _unpack_rnn_params(parameters, num_layers, C, state_size,
                                bidirectional, mode)
    h0 = state  # [L*dirs, N, H]
    c0 = state_cell if state_cell is not None else torch.zeros_like(h0)
    xs = data
    hTs, cTs = [], []
    for li, layer_params in enumerate(layers):
        outs = []
        for di in range(dirs):
            wi, wh, bi, bh = layer_params[di]
            idx = li * dirs + di
            ys, hT, cT = _scan_layer(mode, xs, h0[idx], c0[idx], wi, wh, bi,
                                     bh, reverse=(di == 1), fused=fused)
            outs.append(ys)
            hTs.append(hT)
            cTs.append(cT)
        xs = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
        if p > 0.0 and li < num_layers - 1 and autograd.is_training():
            xs = _dropped(xs, 1.0 - p, xs.shape)
    out = xs
    hT = torch.stack(hTs)
    if state_outputs:
        if mode == "lstm":
            return out, hT, torch.stack(cTs)
        return out, hT
    return out


# ---------------------------------------------------------------------------
# the rest of the activations and softmax family
# ---------------------------------------------------------------------------


@register("hard_sigmoid")
def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


@register("softmin")
def softmin(data, axis=-1, temperature=None):
    x = _promote(data)
    x = x / temperature if temperature else x
    return torch.softmax(-x, dim=axis)


@register("SoftmaxActivation")
def SoftmaxActivation(data, mode="instance"):
    """softmax over the channel axis ("channel") or over everything but
    the batch axis ("instance")."""
    x = _promote(data)
    if mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


@register("LRN")
def LRN(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels (NCHW)."""
    sq = torch.square(data)
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    windows = padded[:, 0:data.shape[1]]
    for i in range(1, nsize):
        windows = windows + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + (alpha / nsize) * windows, beta)


# ---------------------------------------------------------------------------
# UpSampling and resizing: jax.image.resize's "bilinear" samples at
# half-pixel centres and widens its triangle filter when it shrinks (an
# antialiased resize), which is F.interpolate(mode="bilinear",
# align_corners=False, antialias=True) whichever way each axis goes; its
# "nearest" is half-pixel nearest, torch's "nearest-exact"
# ---------------------------------------------------------------------------


def _resize_bilinear(x, h, w):
    return F.interpolate(x, size=(int(h), int(w)), mode="bilinear",
                         align_corners=False, antialias=True)


@register("UpSampling")
def UpSampling(*data, scale=1, sample_type="nearest", num_filter=0,
               multi_input_mode="concat", num_args=1, workspace=512):
    """Each input enlarged `scale` times (nearest: repeated pixels, or
    bilinear); several inputs are resized (half-pixel nearest) to the
    largest and concatenated on the channels or summed."""
    outs = []
    for d in data:
        if sample_type == "nearest":
            o = torch.repeat_interleave(torch.repeat_interleave(
                d, scale, dim=2), scale, dim=3)
        else:
            o = _resize_bilinear(d, d.shape[2] * scale, d.shape[3] * scale)
        outs.append(o)
    if len(outs) == 1:
        return outs[0]
    maxh = max(o.shape[2] for o in outs)
    maxw = max(o.shape[3] for o in outs)
    outs = [F.interpolate(o, size=(maxh, maxw), mode="nearest-exact")
            if tuple(o.shape[2:]) != (maxh, maxw) else o for o in outs]
    if multi_input_mode == "sum":
        total = outs[0]
        for o in outs[1:]:
            total = total + o
        return total
    return torch.cat(outs, dim=1)


@register("_contrib_BilinearResize2D")
def BilinearResize2D(data, height=1, width=1, scale_height=None,
                     scale_width=None):
    _, _, h, w = data.shape
    if scale_height is not None:
        height, width = int(h * scale_height), int(w * scale_width)
    return _resize_bilinear(data, height, width)


@register("_contrib_AdaptiveAvgPooling2D")
def AdaptiveAvgPooling2D(data, output_size=()):
    """The mean over (H / oh) x (W / ow) tiles: H and W must divide by the
    output size, as the reference's reshape needs (torch's
    adaptive_avg_pool2d takes other windows where they do not)."""
    if not output_size:
        oh = ow = 1
    elif np.isscalar(output_size):
        oh = ow = int(output_size)
    else:
        oh, ow = (int(x) for x in output_size)
    n, c, h, w = data.shape
    if h % oh or w % ow:
        raise TypeError("cannot reshape array of shape %s into shape %s"
                        % (tuple(data.shape),
                           (n, c, oh, h // oh, ow, w // ow)))
    x = data.reshape(n, c, oh, h // oh, ow, w // ow)
    return torch.mean(x, dim=(3, 5))


# ---------------------------------------------------------------------------
# spatial transforms, ROI pooling and correlation
# ---------------------------------------------------------------------------


@register("GridGenerator")
def GridGenerator(data, transform_type="affine", target_shape=(0, 0)):
    """An affine (N, 6) transform applied to the [-1, 1] target grid:
    (N, 2, H, W) source x, y; "warp" data is already the flow."""
    H, W = int(target_shape[0]), int(target_shape[1])
    if transform_type != "affine":
        return data
    n = data.shape[0]
    theta = data.reshape(n, 2, 3)
    ys = torch.linspace(-1, 1, H, dtype=data.dtype, device=data.device)
    xs = torch.linspace(-1, 1, W, dtype=data.dtype, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx.reshape(-1), gy.reshape(-1),
                        torch.ones_like(gx).reshape(-1)])  # [3, H*W]
    out = torch.einsum("nij,jk->nik", theta, grid)
    return out.reshape(n, 2, H, W)


def _bilinear_sample(data, grid):
    """data [N, C, Hi, Wi] at grid [N, 2, H, W] (x, y in [-1, 1]): each
    of the four corners weighted and masked by its own in-bounds test,
    its index truncated and clipped, as the reference samples."""
    N, C, Hi, Wi = data.shape
    gx = (grid[:, 0] + 1.0) * (Wi - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (Hi - 1) / 2.0
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x1 = x0 + 1
    y1 = y0 + 1
    wx1 = gx - x0
    wy1 = gy - y0
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    batch = torch.arange(N, device=data.device).reshape(N, 1, 1)

    def gather(yy, xx):
        yi = torch.clamp(yy.to(torch.int32), 0, Hi - 1).long()
        xi = torch.clamp(xx.to(torch.int32), 0, Wi - 1).long()
        return data[batch, :, yi, xi].permute(0, 3, 1, 2)

    def inb(yy, xx):
        return ((yy >= 0) & (yy <= Hi - 1) & (xx >= 0)
                & (xx <= Wi - 1)).to(data.dtype)

    return (gather(y0, x0) * (wy0 * wx0 * inb(y0, x0))[:, None]
            + gather(y0, x1) * (wy0 * wx1 * inb(y0, x1))[:, None]
            + gather(y1, x0) * (wy1 * wx0 * inb(y1, x0))[:, None]
            + gather(y1, x1) * (wy1 * wx1 * inb(y1, x1))[:, None])


@register("BilinearSampler")
def BilinearSampler(data, grid, cudnn_off=False):
    return _bilinear_sample(data, grid)


@register("SpatialTransformer")
def SpatialTransformer(data, loc, target_shape=(0, 0),
                       transform_type="affine", sampler_type="bilinear",
                       cudnn_off=False):
    grid = GridGenerator(loc, transform_type="affine",
                         target_shape=target_shape)
    return _bilinear_sample(data, grid)


@register("ROIPooling")
def ROIPooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """Max over each ROI's PH x PW bins. rois [R, 5]: (batch index, x1,
    y1, x2, y2), scaled and rounded half to even (jnp.round); a bin no
    pixel falls in gives 0."""
    PH, PW = int(pooled_size[0]), int(pooled_size[1])
    N, C, H, W = data.shape
    R = rois.shape[0]
    b = rois[:, 0].to(torch.int32).long()
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale)
                      .to(torch.int32) for i in range(1, 5))
    rh = torch.clamp(y2 - y1 + 1, min=1).to(torch.float32)
    rw = torch.clamp(x2 - x1 + 1, min=1).to(torch.float32)
    ys = torch.arange(H, device=data.device, dtype=torch.int32)
    xs = torch.arange(W, device=data.device, dtype=torch.int32)
    py = torch.clamp((ys[None] - y1[:, None]).to(torch.float32) * PH
                     / rh[:, None], 0, PH - 1).to(torch.int32)   # [R, H]
    px = torch.clamp((xs[None] - x1[:, None]).to(torch.float32) * PW
                     / rw[:, None], 0, PW - 1).to(torch.int32)   # [R, W]
    valid_y = (ys[None] >= y1[:, None]) & (ys[None] <= y2[:, None])
    valid_x = (xs[None] >= x1[:, None]) & (xs[None] <= x2[:, None])
    mask = valid_y[:, :, None] & valid_x[:, None, :]             # [R,H,W]
    neg = torch.full((), float("-inf"), dtype=data.dtype,
                     device=data.device)
    src = torch.where(mask[:, None], data[b], neg)               # [R,C,H,W]
    cell = (py[:, :, None] * PW + px[:, None, :]).long()         # [R,H,W]
    seg = cell.reshape(R, 1, H * W).expand(R, C, H * W)
    out = torch.full((R, C, PH * PW), float("-inf"), dtype=data.dtype,
                     device=data.device)
    out = out.scatter_reduce(2, seg, src.reshape(R, C, H * W), "amax")
    out = torch.where(torch.isfinite(out), out,
                      torch.zeros((), dtype=data.dtype, device=data.device))
    return out.reshape(R, C, PH, PW)


@register("Correlation")
def Correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """The channel mean of data1 times (or minus, absolute) data2 shifted
    by each displacement up to max_displacement; the shift wraps around
    (jnp.roll), the reference's simplification of upstream's."""
    d = max_displacement
    pads = (pad_size, pad_size, pad_size, pad_size)
    p1 = F.pad(data1, pads)
    p2 = F.pad(data2, pads)
    outs = []
    for dy in range(-d, d + 1, stride2):
        for dx in range(-d, d + 1, stride2):
            shifted = torch.roll(p2, (-dy, -dx), dims=(2, 3))
            if is_multiply:
                corr = torch.mean(p1 * shifted, dim=1)
            else:
                corr = torch.mean(torch.abs(p1 - shifted), dim=1)
            outs.append(corr)
    out = torch.stack(outs, dim=1)
    if pad_size:
        out = out[:, :, pad_size:-pad_size, pad_size:-pad_size]
    return out[:, :, ::stride1, ::stride1]


# ---------------------------------------------------------------------------
# legacy Crop, the KL sparsity identity and the image ops
# ---------------------------------------------------------------------------


@register("Crop")
def Crop(*inputs, offset=(0, 0), h_w=(0, 0), center_crop=False, num_args=1):
    """An (h, w) window of NCHW data at `offset` (y, x) or centred; a
    second input gives the window its own H and W."""
    data = inputs[0]
    if len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    if y0 < 0 or x0 < 0 or y0 + th > H or x0 + tw > W:
        raise ValueError("Crop window [%d:%d, %d:%d] exceeds input %dx%d"
                         % (y0, y0 + th, x0, x0 + tw, H, W))
    return data[:, :, y0:y0 + th, x0:x0 + tw]


class _KLSparseIdentity(torch.autograd.Function):
    """Identity forward; the backward adds the KL sparsity penalty's
    gradient at the batch's mean activation per unit."""

    @staticmethod
    def forward(ctx, data, target, penalty):
        ctx.save_for_backward(data)
        ctx.target = target
        ctx.penalty = penalty
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        data, = ctx.saved_tensors
        rho = torch.clamp(torch.mean(data, dim=0, keepdim=True), 1e-6,
                          1 - 1e-6)
        kl = ctx.penalty * (-ctx.target / rho
                            + (1.0 - ctx.target) / (1.0 - rho))
        return g + torch.broadcast_to(kl, g.shape), None, None


@register("IdentityAttachKLSparseReg")
def IdentityAttachKLSparseReg(data, sparseness_target=0.1, penalty=0.001,
                              momentum=0.9):
    """Identity whose gradient carries the KL sparsity penalty (the
    batch's mean activation stands for the reference's moving average,
    its momentum-0 case)."""
    return _KLSparseIdentity.apply(data, float(sparseness_target),
                                   float(penalty))


@register("_image_to_tensor")
def _image_to_tensor(data):
    """HWC (NHWC) [0, 255] to CHW (NCHW) float32 in [0, 1]."""
    out = data.to(torch.float32) / 255.0
    if data.dim() == 3:
        return out.permute(2, 0, 1)
    return out.permute(0, 3, 1, 2)


@register("_image_normalize")
def _image_normalize(data, mean=(0.0,), std=(1.0,)):
    """(x - mean) / std by channel, on CHW or NCHW images."""
    shape = (-1, 1, 1) if data.dim() == 3 else (1, -1, 1, 1)
    mean = torch.tensor(mean, dtype=data.dtype, device=data.device)
    std = torch.tensor(std, dtype=data.dtype, device=data.device)
    return (data - mean.reshape(shape)) / std.reshape(shape)
