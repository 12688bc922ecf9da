"""mx.nd: the imperative op namespace (port of `mxnet_tpu/ndarray/`).

One function per registered op (aliases included) is generated from the
registry, as the reference's namespace is, plus the creation functions
and the scalar-or-array arithmetic helpers. Generated names shadow
builtins (`sum`, `max`, `abs`): never call bare builtins in this module.
The sampling namespace is `nd.random`; its functions also populate
`mxnet_tpu_torch.random` (`mx.random.uniform`, ...), as the reference's
do. `load` reads the named .npz container and MXNet's own binary .params
format (utils/legacy.py). The optimizer update ops (`sgd_update`,
`adam_update`, ...) write their state arguments in place and honour
`out=`, as the reference's do. The sub-namespaces `nd.linalg` (the
`linalg_*` ops without their prefix), `nd.contrib` (every `_contrib_*`
op under its short name, `quadratic`, `rand_zipfian` and `foreach`) and
`nd.op` (this namespace again) are the reference's. Not ported yet:
sparse arrays (ROADMAP.md, queue 1). `nd.Custom` runs a registered
Python op (`operator.invoke`).
"""
from __future__ import annotations

import numpy as _np
import torch as _torch

from ..base import torch_dtype as _torch_dtype
from ..context import current_context
from ..ops import contrib as _ops_contrib  # noqa: F401  (registers ops)
from ..ops import custom as _ops_custom  # noqa: F401
from ..ops import nn as _ops_nn  # noqa: F401
from ..ops import optimizer_ops as _ops_optimizer
from ..ops import quantization as _ops_quantization  # noqa: F401
from ..ops import random_ops as _ops_random  # noqa: F401
from ..ops import sparse as _ops_sparse  # noqa: F401
from ..ops import registry as _registry
from ..ops import tensor as _ops_tensor  # noqa: F401
from .ndarray import NDArray, _apply_op, make_nd_func
from . import sparse
from .sparse import BaseSparseNDArray, CSRNDArray, RowSparseNDArray

for _name in list(_registry.OPS):
    globals()[_name] = make_nd_func(_registry.OPS[_name])


def _make_update_op(opname, state_pos):
    """nd.<opname> with the reference's call semantics: the new values of
    the state arguments at `state_pos` are written into those NDArrays,
    the new weight into `out=` when given (else returned)."""
    opdef = _registry.get(opname)

    def update_op(*args, **kwargs):
        out = kwargs.pop("out", None)
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, BaseSparseNDArray):
                # the reference's op multiplies the sparse object by a
                # float and fails with this TypeError
                raise TypeError(
                    "%s takes dense arrays, got a %s argument (densify it "
                    "with .tostype('default'); an optimizer's update "
                    "takes row_sparse gradients)" % (opname, a.stype))
        res = _apply_op(opdef, args, kwargs)
        res = res if isinstance(res, tuple) else (res,)
        for pos, new_state in zip(state_pos, res[1:]):
            if isinstance(args[pos], NDArray):
                args[pos]._data = new_state._data
        if out is not None:
            out._data = res[0]._data
            return out
        return res[0]

    update_op.__name__ = opname
    update_op.__doc__ = opdef.doc
    return update_op


for _uname, _upos in _ops_optimizer.UPDATE_OP_STATES.items():
    globals()[_uname] = _make_update_op(_uname, _upos)


def Custom(*data, **kwargs):
    """Run a registered custom op (operator.invoke): auxiliary states
    are zeros each call, as in the reference's imperative path."""
    from .. import operator as _operator
    return _operator.Custom(*data, **kwargs)


def _device(ctx):
    return (ctx if ctx is not None else current_context()).torch_device()


def array(source_array, ctx=None, dtype=None):
    if isinstance(source_array, NDArray):
        return NDArray(source_array._data.detach(), ctx=ctx, dtype=dtype)
    if dtype is None and not isinstance(source_array, _np.ndarray):
        dtype = "float32"  # python lists default to float32 (mxnet parity)
    return NDArray(_np.asarray(source_array), ctx=ctx, dtype=dtype)


def _shape(shape):
    return (int(shape),) if _np.isscalar(shape) else tuple(shape)


def cast_storage(data, stype="default"):
    """data in storage type `stype` ("default", "row_sparse", "csr")."""
    return data.tostype(stype)


def zeros(shape, ctx=None, dtype=None, stype=None, **kwargs):
    if stype and stype != "default":
        return sparse.zeros(stype, shape, ctx=ctx, dtype=dtype)
    return NDArray(_torch.zeros(_shape(shape), dtype=_torch_dtype(dtype),
                                device=_device(ctx)), ctx=ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):
    return NDArray(_torch.ones(_shape(shape), dtype=_torch_dtype(dtype),
                               device=_device(ctx)), ctx=ctx)


def full(shape, val, ctx=None, dtype=None, out=None):
    res = NDArray(_torch.full(_shape(shape), val, dtype=_torch_dtype(dtype),
                              device=_device(ctx)), ctx=ctx)
    if out is not None:
        out._data = res._data
        return out
    return res


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    """[start, stop) by step, each value `repeat` times, made on ctx's
    device (the `_arange` op)."""
    return _apply_op(_registry.get("_arange"), (),
                     dict(start=start, stop=stop, step=step, repeat=repeat,
                          dtype=dtype or "float32", ctx=ctx))


def eye(N, M=0, k=0, ctx=None, dtype=None):
    """N x M (M 0: N x N) with ones on the k-th diagonal (the `_eye`
    op)."""
    return _apply_op(_registry.get("_eye"), (),
                     dict(N=N, M=M, k=k, dtype=dtype or "float32", ctx=ctx))


def waitall():
    """Block until all launched work completes (parity: mx.nd.waitall)."""
    from .. import engine
    engine.wait_all()


def save(fname, data):
    """Write an NDArray, a list or a {name: NDArray} dict (the named .npz
    container the reference writes)."""
    from ..utils import serialization
    serialization.save_ndarrays(fname, data)


def load(fname, ctx=None):
    """A dict or list of NDArrays from a file `save` (of either package)
    or MXNet's `save_legacy_ndarrays` wrote, on `ctx` (the current context
    by default)."""
    from ..utils import serialization
    return serialization.load_ndarrays(fname, ctx=ctx)


def load_frombuffer(buf, ctx=None):
    """`load` from the file's bytes."""
    if not isinstance(buf, (bytes, bytearray)):
        raise TypeError("load_frombuffer expects bytes, got %s"
                        % type(buf).__name__)
    from ..utils import serialization
    return serialization.load_ndarrays(buf, ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """Join NDArrays along `axis`."""
    return NDArray(_torch.cat([a._data.detach() for a in arrays], dim=axis),
                   ctx=arrays[0].context)


def moveaxis(data, source, destination):
    """data with axis `source` moved to `destination`."""
    return NDArray(_torch.movedim(data._data.detach(), source, destination),
                   ctx=data.context)


def split_v2(ary, indices_or_sections, axis=0, squeeze_axis=False):
    """numpy.split: `indices_or_sections` equal parts (an uneven split
    raises) or the parts between the given indices."""
    t = ary._data.detach()
    if _np.isscalar(indices_or_sections) and \
            t.shape[axis] % int(indices_or_sections):
        raise ValueError("array split does not result in an equal division")
    parts = _torch.tensor_split(
        t, indices_or_sections if _np.isscalar(indices_or_sections)
        else [int(i) for i in indices_or_sections], dim=axis)
    if squeeze_axis:
        parts = [_torch.squeeze(p, axis) for p in parts]
    return [NDArray(p, ctx=ary.context) for p in parts]


def onehot_encode(indices, out):
    """One-hot rows of indices written into `out` (depth out.shape[1])."""
    res = globals()["one_hot"](indices, depth=out.shape[1])
    out._data = res._data
    return out


def _mixed_binary(tensor_op, scalar_op, rscalar_op=None):
    """nd.add and friends: array or scalar on either side."""
    def fn(lhs, rhs):
        if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
            return _apply_op(_registry.get(tensor_op), (lhs, rhs), {})
        if isinstance(lhs, NDArray):
            return _apply_op(_registry.get(scalar_op), (lhs,),
                             {"scalar": float(rhs)})
        if isinstance(rhs, NDArray):
            return _apply_op(_registry.get(rscalar_op or scalar_op), (rhs,),
                             {"scalar": float(lhs)})
        return {"broadcast_add": _np.add, "broadcast_sub": _np.subtract,
                "broadcast_mul": _np.multiply, "broadcast_div": _np.divide,
                "broadcast_power": _np.power,
                "broadcast_maximum": _np.maximum,
                "broadcast_minimum": _np.minimum}[tensor_op](lhs, rhs)
    fn.__name__ = tensor_op
    return fn


power = _mixed_binary("broadcast_power", "_power_scalar", "_rpower_scalar")
maximum = _mixed_binary("broadcast_maximum", "_maximum_scalar")
minimum = _mixed_binary("broadcast_minimum", "_minimum_scalar")
add = _mixed_binary("broadcast_add", "_plus_scalar")
subtract = _mixed_binary("broadcast_sub", "_minus_scalar", "_rminus_scalar")
multiply = _mixed_binary("broadcast_mul", "_mul_scalar")
divide = _mixed_binary("broadcast_div", "_div_scalar", "_rdiv_scalar")
true_divide = divide


# sub-namespaces (parity: mxnet.ndarray.random / .linalg / .contrib /
# .op), and mx.random.* from the first
from . import random  # noqa: E402
from . import linalg  # noqa: E402
from . import contrib  # noqa: E402
from . import op  # noqa: E402
from .. import random as _random_mod  # noqa: E402

for _name in ("uniform", "normal", "randn", "gamma", "exponential",
              "poisson", "negative_binomial",
              "generalized_negative_binomial", "randint", "multinomial",
              "shuffle"):
    setattr(_random_mod, _name, getattr(random, _name))
