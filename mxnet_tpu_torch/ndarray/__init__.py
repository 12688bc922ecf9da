"""mx.nd: the imperative op namespace (port of `mxnet_tpu/ndarray/`).

One function per registered op (aliases included) is generated from the
registry, as the reference's namespace is, plus the creation functions
and the scalar-or-array arithmetic helpers. Generated names shadow
builtins (`sum`, `max`, `abs`): never call bare builtins in this module.
Not ported yet: sparse arrays, the optimizer update ops, random, linalg,
contrib and serialization (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import numpy as _np
import torch as _torch

from ..base import torch_dtype as _torch_dtype
from ..context import current_context as _current_context
from ..ops import nn as _ops_nn  # noqa: F401  (registers the ops)
from ..ops import registry as _registry
from ..ops import tensor as _ops_tensor  # noqa: F401
from .ndarray import NDArray, _apply_op, make_nd_func

for _name in list(_registry.OPS):
    globals()[_name] = make_nd_func(_registry.OPS[_name])


def _device(ctx):
    return (ctx if ctx is not None else _current_context()).torch_device()


def array(source_array, ctx=None, dtype=None):
    if isinstance(source_array, NDArray):
        return NDArray(source_array._data.detach(), ctx=ctx, dtype=dtype)
    if dtype is None and not isinstance(source_array, _np.ndarray):
        dtype = "float32"  # python lists default to float32 (mxnet parity)
    return NDArray(_np.asarray(source_array), ctx=ctx, dtype=dtype)


def _shape(shape):
    return (int(shape),) if _np.isscalar(shape) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):
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
    vals = _np.arange(start, stop, step).astype(_np.float32 if dtype is None
                                                else dtype)
    if repeat > 1:
        vals = _np.repeat(vals, repeat)
    return NDArray(vals, ctx=ctx)


def waitall():
    """Block until all launched work completes (parity: mx.nd.waitall)."""
    if _torch.cuda.is_available() and _torch.cuda.is_initialized():
        _torch.cuda.synchronize()


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
