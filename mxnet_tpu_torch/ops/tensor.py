"""Tensor ops (port of `mxnet_tpu/ops/tensor.py`, all of it):
elementwise and broadcast arithmetic with tensors and scalars, mod and
hypot, comparisons and the logical ops, the unary math functions, Cast,
reductions, products (dot, batch_dot, the @ operator, add_n), ordering
(sort, argsort, topk, argmin), Reshape (with the reference's special
codes) and the other shape ops, slicing with any step and the functional
slice assignment, gather / scatter, the sequence ops, Embedding, the
creation ops (`_zeros`, `_ones`, `_full`, `_arange`, `_eye`, `zeros_like`,
`ones_like`), the two losses and the ten `linalg_*` ops.

Each op is a function of torch tensors with static keyword parameters;
gradients come from torch.autograd through its body. A body is tensor
ops only: it reads nothing on the host (no `.item()`, no branch on a
value), as the reference's bodies trace under jit, so Symbol shape
inference runs it on the "meta" device. A scalar operand is cast to the
tensor's dtype first, as the reference's `jnp.asarray(scalar,
dtype=data.dtype)` does; index tensors arrive in any integer or float
dtype and are cast to int64 inside the op. Where torch's call differs
from jnp's, the op composes jnp's: `_mod` is `torch.remainder` (the
divisor's sign), `round` rounds half away from zero where `rint` rounds
half to even, `gamma` is exp(lgamma), the orderings run on torch's stable
sort (a descending order the flip of the ascending one, topk's ties lower
index first), and a negative-step slice is a positive-step slice of the
flipped axis.

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


@register("BlockGrad", aliases=("stop_gradient", "make_loss_identity"))
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


# ---------------------------------------------------------------------------
# the rest of the elementwise ops: mod and hypot, the logical ops, the
# NaN / Inf tests and the unary math functions
# ---------------------------------------------------------------------------

# jnp.mod follows the divisor's sign, which is torch.remainder (not fmod)
for _names, _fn in [(("_mod", "broadcast_mod"), torch.remainder),
                    (("_hypot", "broadcast_hypot"), torch.hypot)]:
    for _n in _names:
        register(_n)(_mkb(_fn))

for _name, _fn, _default in [
    ("_mod_scalar", torch.remainder, 1.0),
    ("_rmod_scalar", lambda d, s: torch.remainder(s, d), 1.0),
    ("_hypot_scalar", torch.hypot, 0.0),
]:
    register(_name)(_mks(_fn, _default))

# the binary logical ops treat nonzero as true and return the lhs dtype
for _names, _fn in [
    (("_logical_and", "broadcast_logical_and"), torch.logical_and),
    (("_logical_or", "broadcast_logical_or"), torch.logical_or),
    (("_logical_xor", "broadcast_logical_xor"), torch.logical_xor),
]:
    for _n in _names:
        register(_n, differentiable=False)(_mkc(_fn))

for _name, _fn in [("_logical_and_scalar", torch.logical_and),
                   ("_logical_or_scalar", torch.logical_or),
                   ("_logical_xor_scalar", torch.logical_xor)]:
    def _mkl(fn):
        def logical_scalar(data, scalar=0.0):
            """(data != 0) against bool(scalar), in data's dtype."""
            return fn(data != 0, torch.tensor(bool(scalar))).to(data.dtype)
        return logical_scalar
    register(_name, differentiable=False)(_mkl(_fn))


@register("logical_not", differentiable=False)
def logical_not(data):
    return torch.logical_not(data).to(data.dtype)


@register("isnan", differentiable=False)
def isnan(data):
    """A bool array, as the reference's."""
    return torch.isnan(data)


@register("isinf", differentiable=False)
def isinf(data):
    return torch.isinf(data)


def _cbrt(x):
    # torch has no cbrt: the real cube root, odd in x
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


for _name, _fn in {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "arcsinh": torch.asinh,
    "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "floor": torch.floor, "ceil": torch.ceil, "trunc": torch.trunc,
    "fix": torch.trunc,
    # rint rounds half to even (jnp.rint, torch.round); round rounds half
    # away from zero (mshadow's round)
    "rint": torch.round,
    "round": lambda x: torch.sign(x) * torch.floor(torch.abs(x) + 0.5),
    "erf": torch.erf, "erfinv": torch.erfinv,
    # the reference's gamma is exp(gammaln(x)): |Gamma(x)|
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
    "expm1": torch.expm1, "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
}.items():
    register(_name)(_mku(_fn))


@register("quadratic", aliases=("_contrib_quadratic",))
def quadratic(data, a=0.0, b=0.0, c=0.0):
    return a * torch.square(data) + b * data + c


# ---------------------------------------------------------------------------
# the rest of the reductions
# ---------------------------------------------------------------------------


def _prod(d, ax, keep):
    # torch.prod takes one axis at a time; an int32 product stays int32
    for a in sorted(ax, reverse=True):
        d = torch.prod(d, dim=a, keepdim=keep, dtype=_sum_dtype(d))
    return d


def _nansum(d, ax, keep):
    if not d.is_floating_point():
        return torch.sum(d, dim=ax, keepdim=keep, dtype=_sum_dtype(d))
    return torch.nansum(d, dim=ax, keepdim=keep)


def _nanprod(d, ax, keep):
    if d.is_floating_point():
        d = torch.where(torch.isnan(d), torch.ones((), dtype=d.dtype,
                                                   device=d.device), d)
    return _prod(d, ax, keep)


for _name, _fn in [("prod", _prod), ("nansum", _nansum),
                   ("nanprod", _nanprod)]:
    register(_name)(_make_reduce(_fn))


@register("square_sum", aliases=("_square_sum",))
def square_sum(data, axis=None, keepdims=False):
    ax = _axes(data, axis, False)
    if ax is None:
        ax = tuple(range(data.dim()))
    return torch.sum(torch.square(data), dim=ax, keepdim=bool(keepdims))


@register("L2Normalization")
def L2Normalization(data, eps=1e-10, mode="instance"):
    """data over sqrt(sum of squares + eps), the sum over every axis but
    the batch ("instance"), the channel axis ("channel") or the spatial
    axes ("spatial")."""
    if mode == "instance":
        ax = tuple(range(1, data.dim()))
    elif mode == "channel":
        ax = (1,)
    elif mode == "spatial":
        ax = tuple(range(2, data.dim()))
    else:
        raise ValueError("unknown mode %s" % mode)
    nrm = torch.sqrt(torch.sum(torch.square(data), dim=ax, keepdim=True)
                     + eps)
    return data / nrm


@register("argmin", differentiable=False)
def argmin(data, axis=None, keepdims=False):
    """The index of the smallest element along `axis` (of the flattened
    data when None), as float32."""
    if axis is None:
        return torch.argmin(data).to(torch.float32)
    out = torch.argmin(data, dim=int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax_channel", differentiable=False)
def argmax_channel(data):
    return torch.argmax(data, dim=-1).to(torch.float32)


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------


def _rev(x):
    """x.T as jnp's: every axis reversed."""
    return x.permute(*reversed(range(x.dim())))


@register("dot")
def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """lhs's last axis contracted with rhs's first (a tensordot); the
    transposes reverse every axis."""
    a = _rev(lhs) if transpose_a else lhs
    b = _rev(rhs) if transpose_b else rhs
    if a.dim() == 1 and b.dim() == 1:
        return torch.dot(a, b)
    return torch.tensordot(a, b, dims=([a.dim() - 1], [0]))


@register("_matmul")
def _matmul(lhs, rhs):
    """The @ operator: numpy matmul (batched above rank 2)."""
    if lhs.dim() < 2 or rhs.dim() < 2:
        raise TypeError("@ needs operands of rank >= 2; got %s @ %s"
                        % (tuple(lhs.shape), tuple(rhs.shape)))
    return torch.matmul(lhs, rhs)


def _t(x, flag):
    return torch.swapaxes(x, -1, -2) if flag else x


@register("batch_dot")
def batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    return torch.matmul(_t(lhs, transpose_a), _t(rhs, transpose_b))


@register("add_n", aliases=("ElementWiseSum", "_sum"))
def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


# ---------------------------------------------------------------------------
# ordering: jnp.sort / argsort are stable, a descending order is the flip
# of the ascending one, and lax.top_k puts the lower index first among
# ties, so each runs on torch's stable sort
# ---------------------------------------------------------------------------


@register("sort")
def sort(data, axis=-1, is_ascend=True):
    out = torch.sort(data, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", differentiable=False)
def argsort(data, axis=-1, is_ascend=True, dtype="float32"):
    out = torch.sort(data, dim=axis, stable=True).indices
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(torch_dtype(dtype))


@register("topk", differentiable=False, num_outputs=-1)
def topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The k largest (smallest with is_ascend) along `axis`, the lower
    index first among ties: "indices", "value", "both" (values, indices)
    or "mask" (ones at the chosen places, in data's dtype)."""
    srt = torch.sort(data, dim=axis, descending=not is_ascend, stable=True)
    vals = torch.narrow(srt.values, axis, 0, k)
    pos = torch.narrow(srt.indices, axis, 0, k)
    if ret_typ == "indices":
        return pos.to(torch_dtype(dtype))
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, pos.to(torch_dtype(dtype))
    if ret_typ == "mask":
        return torch.zeros_like(data).scatter(axis, pos, 1.0)
    raise ValueError("unknown ret_typ %s" % ret_typ)


# ---------------------------------------------------------------------------
# shape and index
# ---------------------------------------------------------------------------


def _int_or_none(v):
    return None if v is None else int(v)


def _slices(shape, begin, end, step):
    """(flip axes, positive-step index tuple): the slice
    begin:end:step along the leading axes, an axis with a negative step
    taken as a positive-step slice of that axis flipped."""
    step = tuple(step) if step else (None,) * len(begin)
    flips, idx = [], []
    for axis, (b, e, s) in enumerate(zip(begin, end, step)):
        sl = slice(_int_or_none(b), _int_or_none(e), _int_or_none(s))
        start, stop, st = sl.indices(shape[axis])
        if st < 0:
            n = shape[axis]
            flips.append(axis)
            sl = slice(n - 1 - start, n - 1 - stop, -st)
        idx.append(sl)
    return tuple(flips), tuple(idx)


@register("slice", aliases=("crop",))
def slice_op(data, begin=(), end=(), step=()):
    """data[begin:end:step] (Python slice rules, None an open end; a
    negative step walks the axis backwards)."""
    flips, idx = _slices(data.shape, begin, end, step)
    src = torch.flip(data, flips) if flips else data
    return src[idx]


@register("_slice_assign", aliases=("_crop_assign",))
def _slice_assign(lhs, rhs, begin=(), end=(), step=()):
    """lhs with rhs written into lhs[begin:end:step]; lhs itself is left
    as it was."""
    flips, idx = _slices(lhs.shape, begin, end, step)
    out = torch.flip(lhs, flips) if flips else lhs.clone()
    out[idx] = rhs
    return torch.flip(out, flips) if flips else out


@register("_slice_assign_scalar", aliases=("_crop_assign_scalar",))
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=()):
    flips, idx = _slices(data.shape, begin, end, step)
    out = torch.flip(data, flips) if flips else data.clone()
    out[idx] = scalar
    return torch.flip(out, flips) if flips else out


@register("slice_like")
def slice_like(data, shape_like, axes=()):
    axes = tuple(axes) if axes else tuple(range(shape_like.dim()))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("broadcast_axis", aliases=("broadcast_axes",))
def broadcast_axis(data, axis=(), size=()):
    axis = (axis,) if np.isscalar(axis) else tuple(axis)
    size = (size,) if np.isscalar(size) else tuple(size)
    shape = list(data.shape)
    for a, s in zip(axis, size):
        shape[a] = int(s)
    return torch.broadcast_to(data, tuple(shape))


@register("broadcast_like")
def broadcast_like(lhs, rhs):
    return torch.broadcast_to(lhs, rhs.shape)


@register("repeat")
def repeat(data, repeats=1, axis=None):
    """Each element `repeats` times along `axis` (of the flattened data
    when None)."""
    return torch.repeat_interleave(data, int(repeats), dim=axis)


@register("flip", aliases=("reverse",))
def flip(data, axis=0):
    ax = _axes(data, axis, False)
    return torch.flip(data, ax if ax is not None else
                      tuple(range(data.dim())))


def _index_tuple(indices):
    """(M, ...) indices as M int64 index tensors, one per leading axis."""
    return tuple(indices.to(torch.int64))


@register("gather_nd")
def gather_nd(data, indices):
    """data at the points indices[:, ...] (indices[i] the coordinates
    along axis i)."""
    return data[_index_tuple(indices)]


@register("scatter_nd")
def scatter_nd(data, indices, shape=()):
    """Zeros of `shape` with data added at the points of indices
    (duplicates add up)."""
    out = torch.zeros(_dims(shape), dtype=data.dtype, device=data.device)
    return out.index_put(_index_tuple(indices), data, accumulate=True)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, rhs, indices, shape=()):
    return lhs.index_put(_index_tuple(indices), rhs)


@register("batch_take")
def batch_take(a, indices):
    """a[i, indices[i]] for every row i."""
    idx = indices.to(torch.int64)
    return torch.take_along_dim(a, idx[:, None], dim=1)[:, 0]


@register("shape_array", differentiable=False)
def shape_array(data):
    """data's shape as int32 (the reference asks for int64, which its
    jax narrows)."""
    return torch.tensor(tuple(data.shape), dtype=torch.int32,
                        device=data.device)


@register("size_array", differentiable=False)
def size_array(data):
    return torch.tensor((data.numel(),), dtype=torch.int32,
                        device=data.device)


@register("diag")
def diag(data, k=0):
    """A 1-D input's k-th diagonal matrix, else the k-th diagonal of the
    last two axes."""
    if data.dim() == 1:
        return torch.diag(data, k)
    return torch.diagonal(data, offset=k, dim1=-2, dim2=-1)


@register("depth_to_space")
def depth_to_space(data, block_size=1):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, b, b, c // (b * b), h, w)
    x = x.permute(0, 3, 4, 1, 5, 2)
    return x.reshape(n, c // (b * b), h * b, w * b)


@register("space_to_depth")
def space_to_depth(data, block_size=1):
    n, c, h, w = data.shape
    b = block_size
    x = data.reshape(n, c, h // b, b, w // b, b)
    x = x.permute(0, 3, 5, 1, 2, 4)
    return x.reshape(n, c * b * b, h // b, w // b)


@register("SequenceLast")
def SequenceLast(data, sequence_length=None, use_sequence_length=False,
                 axis=0):
    """Each sequence's last valid step: time along axis 0 or 1."""
    if not use_sequence_length or sequence_length is None:
        return torch.select(data, axis, -1)
    last = sequence_length.to(torch.int32).to(torch.int64) - 1
    if axis == 0:
        idx = last.reshape((1, -1) + (1,) * (data.dim() - 2))
        return torch.take_along_dim(data, idx, dim=0)[0]
    idx = last.reshape((-1, 1) + (1,) * (data.dim() - 2))
    return torch.take_along_dim(data, idx, dim=1)[:, 0]


@register("SequenceReverse")
def SequenceReverse(data, sequence_length=None, use_sequence_length=False,
                    axis=0):
    """Each sequence's valid steps reversed in place along axis 0, the
    reference's axis whatever `axis` says."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    steps = torch.arange(data.shape[0], device=data.device)[:, None]
    L = sequence_length.to(torch.int32).to(torch.int64)[None, :]
    src = torch.where(steps < L, L - 1 - steps, steps)
    src = src.reshape(tuple(src.shape) + (1,) * (data.dim() - 2))
    return torch.take_along_dim(data, src.expand(data.shape), dim=0)


# ---------------------------------------------------------------------------
# assignment and the legacy index ops
# ---------------------------------------------------------------------------

# dense storage makes the _scatter_* ops the plain elementwise ops (the
# reference's row_sparse outputs write only their stored rows)
register("_scatter_plus_scalar")(_mks(lambda d, s: d + s, 0.0))
register("_scatter_minus_scalar")(_mks(lambda d, s: d - s, 0.0))
register("_scatter_elemwise_div")(_mkb(torch.div))
register("_grad_add")(_mkb(torch.add))


@register("_identity_with_attr_like_rhs")
def _identity_with_attr_like_rhs(lhs, rhs):
    """lhs (rhs only lends its attributes in the reference's passes)."""
    return lhs


@register("choose_element_0index")
def choose_element_0index(lhs, rhs):
    """lhs[i, rhs[i]] (pick along axis 1)."""
    return pick(lhs, rhs, axis=1)


@register("fill_element_0index")
def fill_element_0index(lhs, mhs, rhs):
    """lhs with lhs[i, rhs[i]] set to mhs[i] (indices clipped)."""
    idx = torch.clamp(rhs.to(torch.int64), 0, lhs.shape[1] - 1)
    rows = torch.arange(lhs.shape[0], device=lhs.device)
    return lhs.index_put((rows, idx), mhs.to(lhs.dtype))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@register("smooth_l1")
def smooth_l1(data, scalar=1.0):
    """0.5 s^2 x^2 where |x| < 1/s^2, else |x| - 0.5/s^2."""
    s2 = scalar * scalar
    return torch.where(torch.abs(data) < 1.0 / s2,
                       0.5 * s2 * torch.square(data),
                       torch.abs(data) - 0.5 / s2)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """The softmax cross-entropy against integer labels, summed over the
    batch, of shape (1,)."""
    logz = torch.logsumexp(data, dim=1)
    picked = torch.take_along_dim(
        data, label.to(torch.int32).to(torch.int64)[:, None], dim=1)[:, 0]
    return torch.sum(logz - picked).reshape(1)


# ---------------------------------------------------------------------------
# linalg (the reference's semantics: potri takes the Cholesky factor L and
# gives inv(L L^T); gelqf is the QR of A^T transposed back, (L, Q); syevd
# gives (V^T, w))
# ---------------------------------------------------------------------------


@register("linalg_gemm", aliases=("_linalg_gemm",))
def linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                beta=1.0):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b)) \
        + beta * C


@register("linalg_gemm2", aliases=("_linalg_gemm2",))
def linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    return alpha * torch.matmul(_t(A, transpose_a), _t(B, transpose_b))


@register("linalg_potrf", aliases=("_linalg_potrf",))
def linalg_potrf(A):
    return torch.linalg.cholesky(A)


@register("linalg_potri", aliases=("_linalg_potri",))
def linalg_potri(A):
    return torch.linalg.inv(torch.matmul(A, torch.swapaxes(A, -1, -2)))


@register("linalg_trsm", aliases=("_linalg_trsm",))
def linalg_trsm(A, B, transpose=False, rightside=False, alpha=1.0,
                lower=True):
    """X with op(A) X = alpha B (X op(A) = alpha B with rightside), op(A)
    A or A^T, A lower (or upper) triangular."""
    a = _t(A, transpose)
    low = bool(lower) != bool(transpose)
    return torch.linalg.solve_triangular(a, alpha * B, upper=not low,
                                         left=not rightside)


@register("linalg_trmm", aliases=("_linalg_trmm",))
def linalg_trmm(A, B, transpose=False, rightside=False, alpha=1.0):
    a = _t(A, transpose)
    return alpha * (torch.matmul(B, a) if rightside else torch.matmul(a, B))


@register("linalg_sumlogdiag", aliases=("_linalg_sumlogdiag",))
def linalg_sumlogdiag(A):
    return torch.sum(torch.log(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)


@register("linalg_syrk", aliases=("_linalg_syrk",))
def linalg_syrk(A, transpose=False, alpha=1.0):
    at = torch.swapaxes(A, -1, -2)
    return alpha * (torch.matmul(at, A) if transpose else torch.matmul(A, at))


@register("linalg_gelqf", num_outputs=2, aliases=("_linalg_gelqf",))
def linalg_gelqf(A):
    q, r = torch.linalg.qr(torch.swapaxes(A, -1, -2))
    return torch.swapaxes(r, -1, -2), torch.swapaxes(q, -1, -2)


@register("linalg_syevd", num_outputs=2, aliases=("_linalg_syevd",))
def linalg_syevd(A):
    w, v = torch.linalg.eigh(A)
    return torch.swapaxes(v, -1, -2), w
