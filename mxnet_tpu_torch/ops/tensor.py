"""Tensor ops (port of the ResNet training path's share of
`mxnet_tpu/ops/tensor.py`): elementwise and broadcast arithmetic with
tensors and scalars, comparisons, unary math, Cast, reductions, Reshape
(with the reference's special codes), Flatten, transpose, expand_dims,
squeeze, pick and the zeros/ones creators.

Each op is a function of torch tensors with static keyword parameters;
gradients come from torch.autograd through its body. A scalar operand is
cast to the tensor's dtype first, as the reference's `jnp.asarray(scalar,
dtype=data.dtype)` does. The rest of the reference file is listed in
ROADMAP.md, queue 1.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import torch_dtype
from .registry import register


def _scalar(scalar, data):
    """The scalar as a 0-d tensor of data's dtype (torch treats a 0-d CPU
    tensor as a scalar on any device)."""
    return torch.tensor(scalar, dtype=data.dtype)


# ---------------------------------------------------------------------------
# elementwise and broadcast binary (torch broadcasts like jnp)
# ---------------------------------------------------------------------------

for _names, _fn in [
    (("elemwise_add", "_plus", "_add", "broadcast_add", "broadcast_plus"),
     torch.add),
    (("elemwise_sub", "_minus", "_sub", "broadcast_sub", "broadcast_minus"),
     torch.sub),
    (("elemwise_mul", "_mul", "broadcast_mul"), torch.mul),
    (("elemwise_div", "_div", "broadcast_div"), torch.div),
    (("_power", "pow", "broadcast_power"), torch.pow),
    (("_maximum", "broadcast_maximum"), torch.maximum),
    (("_minimum", "broadcast_minimum"), torch.minimum),
]:
    def _mkb(fn):
        def binary_op(lhs, rhs):
            return fn(lhs, rhs)
        return binary_op
    register(_names[0], aliases=_names[1:])(_mkb(_fn))

# comparisons: non-differentiable, in the lhs dtype
for _names, _fn in [
    (("_equal", "broadcast_equal"), torch.eq),
    (("_not_equal", "broadcast_not_equal"), torch.ne),
    (("_greater", "broadcast_greater"), torch.gt),
    (("_greater_equal", "broadcast_greater_equal"), torch.ge),
    (("_lesser", "broadcast_lesser"), torch.lt),
    (("_lesser_equal", "broadcast_lesser_equal"), torch.le),
]:
    def _mkc(fn):
        def cmp_op(lhs, rhs):
            return fn(lhs, rhs).to(lhs.dtype)
        return cmp_op
    register(_names[0], aliases=_names[1:], differentiable=False)(_mkc(_fn))


# ---------------------------------------------------------------------------
# scalar variants (the scalar stays a static parameter)
# ---------------------------------------------------------------------------

for _name, _fn in [
    ("_plus_scalar", lambda d, s: d + s),
    ("_minus_scalar", lambda d, s: d - s),
    ("_rminus_scalar", lambda d, s: s - d),
    ("_mul_scalar", lambda d, s: d * s),
    ("_div_scalar", lambda d, s: d / s),
    ("_rdiv_scalar", lambda d, s: s / d),
    ("_power_scalar", torch.pow),
    ("_rpower_scalar", lambda d, s: torch.pow(s, d)),
    ("_maximum_scalar", torch.maximum),
    ("_minimum_scalar", torch.minimum),
]:
    def _mks(fn):
        def scalar_op(data, scalar=0.0):
            return fn(data, _scalar(scalar, data))
        return scalar_op
    register(_name)(_mks(_fn))

for _name, _fn in [
    ("_equal_scalar", torch.eq), ("_not_equal_scalar", torch.ne),
    ("_greater_scalar", torch.gt), ("_greater_equal_scalar", torch.ge),
    ("_lesser_scalar", torch.lt), ("_lesser_equal_scalar", torch.le),
]:
    def _mkcs(fn):
        def cmp_scalar(data, scalar=0.0):
            return fn(data, _scalar(scalar, data)).to(data.dtype)
        return cmp_scalar
    register(_name, differentiable=False)(_mkcs(_fn))


# ---------------------------------------------------------------------------
# elementwise unary
# ---------------------------------------------------------------------------

for _name, _fn in {
    "abs": torch.abs, "sign": torch.sign, "square": torch.square,
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "tanh": torch.tanh, "negative": torch.neg,
    "reciprocal": torch.reciprocal, "rsqrt": torch.rsqrt,
}.items():
    def _mku(fn):
        def unary_op(data):
            return fn(data)
        return unary_op
    register(_name)(_mku(_fn))


@register("_copy", aliases=("identity",))
def _copy(data):
    return data.clone()


@register("BlockGrad", aliases=("stop_gradient",))
def BlockGrad(data):
    return data.detach()


@register("clip")
def clip(data, a_min=0.0, a_max=1.0):
    return torch.clamp(data, a_min, a_max)


@register("Cast", aliases=("cast",), differentiable=False)
def Cast(data, dtype="float32"):
    return data.to(torch_dtype(dtype))


# ---------------------------------------------------------------------------
# reductions (axis, keepdims, exclude as the reference's)
# ---------------------------------------------------------------------------

def _axes(data, axis, exclude):
    """The reduced axes as a tuple, or None for all of them."""
    if axis is None or axis == ():
        return None
    ax = (int(axis),) if np.isscalar(axis) else tuple(int(a) for a in axis)
    ax = tuple(a % data.dim() for a in ax)
    if exclude:
        ax = tuple(a for a in range(data.dim()) if a not in ax)
    return ax


def _make_reduce(fn):
    def reduce_op(data, axis=None, keepdims=False, exclude=False):
        ax = _axes(data, axis, exclude)
        if ax is None:
            ax = tuple(range(data.dim()))
        if not ax:
            return data
        return fn(data, ax, bool(keepdims))
    return reduce_op


for _name, _fn in [
    ("sum", lambda d, ax, k: torch.sum(d, dim=ax, keepdim=k)),
    ("mean", lambda d, ax, k: torch.mean(d, dim=ax, keepdim=k)),
    ("max", lambda d, ax, k: torch.amax(d, dim=ax, keepdim=k)),
    ("min", lambda d, ax, k: torch.amin(d, dim=ax, keepdim=k)),
]:
    register(_name)(_make_reduce(_fn))


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


@register("Reshape", aliases=("reshape",))
def Reshape(data, shape=(), reverse=False):
    return torch.reshape(data, _infer_reshape(tuple(data.shape), shape,
                                              reverse))


def _infer_reshape(dshape, tshape, reverse=False):
    """mxnet's reshape special codes 0, -1, -2, -3, -4 (copied from the
    reference's `_infer_reshape`, matrix_op-inl.h InferReshapeShape)."""
    tshape = list(tshape)
    if reverse:
        dshape = tuple(reversed(dshape))
        tshape = list(reversed(tshape))
    out = []
    src = list(dshape)
    i = 0  # index into src
    j = 0
    while j < len(tshape):
        t = tshape[j]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            a, b = tshape[j + 1], tshape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(int(t))
            if i < len(src):
                i += 1
        j += 1
    if out.count(-1) == 1:
        known = int(np.prod([x for x in out if x != -1])) or 1
        total = int(np.prod(dshape)) if dshape else 1
        out[out.index(-1)] = total // known
    if reverse:
        out = list(reversed(out))
    return tuple(out)


@register("Flatten", aliases=("flatten",))
def Flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("transpose")
def transpose(data, axes=()):
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("expand_dims")
def expand_dims(data, axis=0):
    return torch.unsqueeze(data, axis)


@register("squeeze")
def squeeze(data, axis=None):
    if axis is None:
        return torch.squeeze(data)
    axis = (axis,) if np.isscalar(axis) else tuple(axis)
    return torch.squeeze(data, axis)


# ---------------------------------------------------------------------------
# indexing and creation
# ---------------------------------------------------------------------------


@register("pick")
def pick(data, index, axis=-1, keepdims=False, mode="clip"):
    """data's elements at `index` along `axis` (indices clipped)."""
    idx = torch.clamp(index.long(), 0, data.shape[axis] - 1)
    out = torch.take_along_dim(data, torch.unsqueeze(idx, axis), dim=axis)
    if not keepdims:
        out = torch.squeeze(out, axis)
    return out


@register("zeros_like", differentiable=False)
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like", differentiable=False)
def ones_like(data):
    return torch.ones_like(data)
