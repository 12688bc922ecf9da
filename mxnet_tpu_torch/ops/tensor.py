"""Tensor ops (port of the ResNet and word-LM training paths' share of
`mxnet_tpu/ops/tensor.py`): elementwise and broadcast arithmetic with
tensors and scalars, comparisons, unary math, Cast, reductions, Reshape
(with the reference's special codes), reshape_like, Flatten, transpose,
expand_dims, squeeze, Concat, stack, SliceChannel, swapaxes, Pad, pick,
take, SequenceMask, Embedding, the creation ops (`_zeros`, `_ones`,
`_full`, `_arange`, `_eye`, `zeros_like`, `ones_like`), and `where`,
`argmax`, `norm`, `broadcast_to`, `slice_axis`, `tile` and `one_hot`.

Each op is a function of torch tensors with static keyword parameters;
gradients come from torch.autograd through its body. A scalar operand is
cast to the tensor's dtype first, as the reference's `jnp.asarray(scalar,
dtype=data.dtype)` does. The rest of the reference file is listed in
ROADMAP.md, queue 1.

A creation op takes the device to make its tensor on as `device=`
(registry.py). In a Symbol a 0 in its `shape` is a dimension resolved when
the graph is bound (the batch of an RNN's begin state, as upstream
MXNet's `sym.zeros((L, 0, H))`); see symbol/__init__.py.
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

# (name, function, the reference's default scalar: 1.0 for the
# multiplicative family, 0.0 for the rest)
for _name, _fn, _default in [
    ("_plus_scalar", lambda d, s: d + s, 0.0),
    ("_minus_scalar", lambda d, s: d - s, 0.0),
    ("_rminus_scalar", lambda d, s: s - d, 0.0),
    ("_mul_scalar", lambda d, s: d * s, 1.0),
    ("_div_scalar", lambda d, s: d / s, 1.0),
    ("_rdiv_scalar", lambda d, s: s / d, 1.0),
    ("_power_scalar", torch.pow, 1.0),
    ("_rpower_scalar", lambda d, s: torch.pow(s, d), 1.0),
    ("_maximum_scalar", torch.maximum, 0.0),
    ("_minimum_scalar", torch.minimum, 0.0),
]:
    def _mks(fn, default):
        def scalar_op(data, scalar=default):
            return fn(data, _scalar(scalar, data))
        return scalar_op
    register(_name)(_mks(_fn, _default))

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


def _sum_dtype(data):
    """jnp.sum's result dtype: an int32 sum stays int32 (bool and the
    narrower signed integers widen to it) instead of torch's int64."""
    if data.is_floating_point() or data.is_complex():
        return None
    return data.dtype if data.dtype in (torch.int32, torch.int64) \
        else torch.int32


def _mean_input(data):
    """jnp.mean's promotion: integer and bool data average in float32."""
    return data if data.is_floating_point() or data.is_complex() \
        else data.float()


for _name, _fn in [
    ("sum", lambda d, ax, k: torch.sum(d, dim=ax, keepdim=k,
                                       dtype=_sum_dtype(d))),
    ("mean", lambda d, ax, k: torch.mean(_mean_input(d), dim=ax,
                                         keepdim=k)),
    ("max", lambda d, ax, k: torch.amax(d, dim=ax, keepdim=k)),
    ("min", lambda d, ax, k: torch.amin(d, dim=ax, keepdim=k)),
]:
    register(_name)(_make_reduce(_fn))


@register("argmax", differentiable=False)
def argmax(data, axis=None, keepdims=False):
    """The index of the largest element along `axis` (of the flattened
    data when None), as float32, as the reference's."""
    if axis is None:
        return torch.argmax(data).to(torch.float32)
    out = torch.argmax(data, dim=int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("norm")
def norm(data, ord=2, axis=None, keepdims=False):
    """The L1 norm (ord=1) or the L2 norm (otherwise) over `axis` (every
    axis when None)."""
    ax = _axes(data, axis, False)
    if ax is None:
        ax = tuple(range(data.dim()))
    if ord == 1:
        return torch.sum(torch.abs(data), dim=ax, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(torch.square(data), dim=ax,
                                keepdim=bool(keepdims)))


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


@register("reshape_like")
def reshape_like(lhs, rhs):
    """lhs with rhs's shape (the gradient reaches lhs only)."""
    return torch.reshape(lhs, rhs.shape)


@register("Flatten", aliases=("flatten",))
def Flatten(data):
    return torch.reshape(data, (data.shape[0], -1))


@register("transpose")
def transpose(data, axes=()):
    if not axes:
        axes = tuple(reversed(range(data.dim())))
    return data.permute(*axes)


@register("Concat", aliases=("concat",))
def Concat(*data, dim=1):
    return torch.cat(data, dim=dim)


@register("stack")
def stack(*data, axis=0):
    return torch.stack(data, dim=axis)


@register("SliceChannel", aliases=("split",), num_outputs=-1)
def SliceChannel(data, num_outputs=1, axis=1, squeeze_axis=False):
    """num_outputs equal parts along axis (an uneven split raises, as
    jnp.split does)."""
    size = data.shape[axis]
    if size % num_outputs:
        raise ValueError("array split does not result in an equal division: "
                         "%d along axis %d into %d" % (size, axis,
                                                       num_outputs))
    parts = torch.split(data, size // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [torch.squeeze(p, axis) for p in parts]
    return tuple(parts) if num_outputs > 1 else parts[0]


@register("broadcast_to")
def broadcast_to(data, shape=()):
    """data broadcast to `shape`; a 0 keeps data's dimension there."""
    shape = tuple(int(t) if int(t) != 0 else int(d)
                  for t, d in zip(shape, data.shape))
    return torch.broadcast_to(data, shape)


@register("slice_axis")
def slice_axis(data, axis=0, begin=0, end=None):
    """data[begin:end] along `axis` (Python slice rules; end None runs to
    the end)."""
    idx = [slice(None)] * data.dim()
    idx[axis] = slice(begin, None if end is None else int(end))
    return data[tuple(idx)]


@register("tile")
def tile(data, reps=()):
    return torch.tile(data, tuple(int(r) for r in reps))


def _pad_index(n, before, after, mode):
    """The source index of each position of an axis of size n padded by
    (before, after): numpy's "edge" (the end values repeated) or
    "reflect" (mirrored about the end values, which are not repeated)."""
    idx = np.arange(-before, n + after)
    if mode == "edge":
        return np.clip(idx, 0, n - 1)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx > n - 1, period - idx, idx)


@register("Pad", aliases=("pad",))
def Pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """data padded by pad_width, (before, after) pairs for every axis in
    order: with constant_value ("constant"), the edge values ("edge") or
    the mirrored interior ("reflect"), as numpy.pad's modes."""
    pw = np.asarray(pad_width, dtype=np.int64).reshape(-1, 2)
    if mode == "constant":
        widths = []
        for before, after in reversed(pw.tolist()):
            widths += [before, after]
        return torch.nn.functional.pad(data, widths, value=constant_value)
    if mode not in ("edge", "reflect"):
        raise ValueError("unknown pad mode %s" % mode)
    out = data
    for axis, (before, after) in enumerate(pw.tolist()):
        if before or after:
            idx = torch.from_numpy(_pad_index(
                data.shape[axis], before, after, mode)).to(data.device)
            out = torch.index_select(out, axis, idx)
    return out


@register("swapaxes", aliases=("SwapAxis",))
def swapaxes(data, dim1=0, dim2=0):
    return torch.swapaxes(data, dim1, dim2)


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


@register("take")
def take(a, indices, axis=0, mode="clip"):
    """a's slices at `indices` along axis; indices clipped to the axis
    (mode "clip") or wrapped (otherwise)."""
    n = a.shape[axis]
    idx = indices.long()
    idx = torch.clamp(idx, 0, n - 1) if mode == "clip" else torch.remainder(
        idx, n)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(tuple(a.shape[:axis]) + tuple(indices.shape)
                       + tuple(a.shape[axis + 1:]))


@register("SequenceMask")
def SequenceMask(data, sequence_length=None, use_sequence_length=False,
                 value=0.0, axis=0):
    """data with the steps at or past each sequence's length set to
    `value`: time along axis 0 ([T, N, ...]) or axis 1 ([N, T, ...])."""
    if not use_sequence_length or sequence_length is None:
        return data
    steps = torch.arange(data.shape[axis], device=data.device)
    lengths = sequence_length.to(torch.int32)
    if axis == 0:
        mask = steps[:, None] < lengths[None, :]
    else:
        mask = steps[None, :] < lengths[:, None]
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    return torch.where(mask, data, _scalar(value, data).to(data.device))


@register("Embedding", aliases=("_contrib_SparseEmbedding",))
def Embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """weight's rows at the ids in data (any float or integer dtype; float
    ids truncate toward zero, as the reference's astype(int32)). An id
    outside [0, input_dim) gives a row of NaN, as jnp.take's default fill
    does. Gradients are dense (sparse_grad is accepted, as the reference
    accepts it)."""
    idx = data.to(torch.int64)
    n = weight.shape[0]
    bad = (idx < 0) | (idx >= n)
    out = torch.nn.functional.embedding(torch.clamp(idx, 0, n - 1), weight)
    return torch.where(bad[..., None], torch.full(
        (), float("nan"), dtype=out.dtype, device=out.device), out)


@register("where")
def where(condition, x, y):
    """x where condition is nonzero, else y."""
    return torch.where(condition.bool(), x, y)


@register("one_hot", differentiable=False)
def one_hot(indices, depth=0, on_value=1.0, off_value=0.0, dtype="float32"):
    """A depth-wide one-hot row per index (float ids truncate; an index
    outside [0, depth) gives a row of off_value, as jax.nn.one_hot's)."""
    idx = indices.to(torch.int32).long()
    hot = (idx[..., None] == torch.arange(depth, device=idx.device)).to(
        torch.float32)
    return (hot * (on_value - off_value) + off_value).to(torch_dtype(dtype))


@register("zeros_like", differentiable=False)
def zeros_like(data):
    return torch.zeros_like(data)


@register("ones_like", differentiable=False)
def ones_like(data):
    return torch.ones_like(data)


def _dims(shape):
    return tuple(int(d) for d in shape)


@register("_zeros", differentiable=False, creation=True)
def _zeros(shape=(), dtype="float32", device=None):
    return torch.zeros(_dims(shape), dtype=torch_dtype(dtype), device=device)


@register("_ones", differentiable=False, creation=True)
def _ones(shape=(), dtype="float32", device=None):
    return torch.ones(_dims(shape), dtype=torch_dtype(dtype), device=device)


@register("_full", differentiable=False, creation=True)
def _full(shape=(), value=0.0, dtype="float32", device=None):
    return torch.full(_dims(shape), value, dtype=torch_dtype(dtype),
                      device=device)


@register("_arange", differentiable=False, creation=True)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None):
    """[start, stop) by step (stop None: [0, start)), each value repeated
    `repeat` times."""
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                       device=device)
    if repeat > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out


@register("_eye", differentiable=False, creation=True)
def _eye(N=0, M=0, k=0, dtype="float32", device=None):
    """N x M (M 0: N x N) with ones on the k-th diagonal."""
    N = int(N)
    M = int(M) if M else N
    rows = torch.arange(N, device=device)[:, None]
    cols = torch.arange(M, device=device)[None, :]
    return (cols - rows == int(k)).to(torch_dtype(dtype))
