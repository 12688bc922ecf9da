"""NDArray: the imperative tensor (port of `mxnet_tpu/ndarray/ndarray.py`).

An NDArray wraps a torch.Tensor on its context's device. Ops go through
`_apply_op`, which unwraps the NDArray arguments, runs the registered op
function with torch's grad mode on while `autograd.record()` is active
(off otherwise), and wraps the results. Mutation (in-place arithmetic,
setitem, optimizer and running-stat updates) rebinds `_data`, as in the
reference; an NDArray marked by `attach_grad` stays a leaf of the graph
across rebinding.

torch runs eagerly, so the reference's per-op jit cache and dependency
engine have no counterpart: `wait_to_read` synchronises the device.
`tostype` converts to the sparse arrays of `ndarray/sparse.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import engine as _engine
from ..base import NARROW, MXNetError, numpy_dtype, torch_dtype
from ..context import Context, context_of, current_context


class _AdhocOp:
    """Op definition for a function made at a call site (getitem)."""
    __slots__ = ("fn", "differentiable")

    def __init__(self, fn):
        self.fn = fn
        self.differentiable = True


def _as_tensor(source, ctx, dtype):
    """A tensor of `source` (array-like or tensor) on ctx's device, int64
    and float64 narrowed to int32 and float32: the reference runs jax with
    x64 off, so none of its arrays is 64-bit, whatever dtype was asked."""
    if isinstance(source, torch.Tensor):
        t = source
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        if t.dtype in NARROW:
            t = t.to(NARROW[t.dtype])
        return t if ctx is None else t.to(ctx.torch_device())
    arr = np.asarray(source)
    want = torch_dtype(dtype) if dtype is not None else None
    if arr.dtype == np.bool_ or arr.dtype.kind in "iuf":
        t = torch.from_numpy(np.array(arr))
    else:
        raise MXNetError("cannot make an NDArray of numpy dtype %s"
                         % arr.dtype)
    want = want if want is not None else t.dtype
    ctx = ctx if ctx is not None else current_context()
    return t.to(device=ctx.torch_device(), dtype=NARROW.get(want, want))


class NDArray:
    __slots__ = ("_data_buf", "_ctx", "_grad", "_grad_req", "__weakref__")

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        self._grad = None
        self._grad_req = None
        self._data_buf = _as_tensor(data, ctx, dtype)
        self._ctx = ctx if ctx is not None else context_of(
            self._data_buf.device)

    @property
    def _data(self):
        return self._data_buf

    @_data.setter
    def _data(self, value):
        # the one rebind point: a marked variable stays a leaf with grad
        if self._grad_req not in (None, "null"):
            value = value.detach().requires_grad_(True)
        self._data_buf = value

    # -- basic properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """The numpy dtype; bfloat16, which numpy lacks, is the port's
        `base.bfloat16`, which compares equal to 'bfloat16'."""
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def T(self):
        from . import transpose
        return transpose(self)

    @property
    def grad(self):
        return self._grad

    # -- host interop -------------------------------------------------------
    def asnumpy(self):
        """A numpy copy; bfloat16 widens to float32 (exactly), where the
        reference gives ml_dtypes' bfloat16 (a deliberate deviation:
        numpy has no bfloat16 of its own)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        # a CPU tensor's numpy() shares its memory, which an in-place
        # update (TrainStep's) would change under the caller
        return arr.copy() if t.device.type == "cpu" else arr

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        """Block until the value is computed (parity: MXNDArrayWaitToRead)."""
        if self._data.device.type == "cuda":
            torch.cuda.synchronize(self._data.device)
        return self

    # -- context / copy -----------------------------------------------------
    def as_in_context(self, ctx):
        if ctx == self._ctx:
            return self
        return NDArray(self._data, ctx=ctx)

    def copyto(self, other):
        if isinstance(other, NDArray):
            if other is self:
                raise MXNetError("cannot copy an array onto itself")
            other._data = self._data.detach().to(
                device=other._data.device, dtype=other._data.dtype)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach(), ctx=other)
        raise TypeError("copyto does not support type %s" % type(other))

    def copy(self):
        return NDArray(self._data.detach().clone(), ctx=self._ctx)

    def astype(self, dtype, copy=True):
        from . import Cast
        return Cast(self, dtype=dtype)

    @property
    def stype(self):
        return "default"

    def tostype(self, stype):
        """This array in storage type `stype`: itself for "default", else
        a RowSparseNDArray or CSRNDArray of its nonzero rows or entries."""
        if stype == "default":
            return self
        from . import sparse as _sp
        if stype == "row_sparse":
            return _sp.RowSparseNDArray.from_dense(self)
        if stype == "csr":
            return _sp.CSRNDArray.from_dense(self)
        raise ValueError("unknown stype %s" % stype)

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Mark this array for gradients; the gradient is dense whatever
        `stype` asks, as the reference's."""
        grad = NDArray(torch.zeros_like(self._data.detach()), ctx=self._ctx)
        autograd.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach(), ctx=self._ctx)

    # -- indexing -----------------------------------------------------------
    def _norm_index(self, key):
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, tuple):
            return tuple(self._norm_index(k) if isinstance(k, NDArray) else k
                         for k in key)
        if isinstance(key, (list, np.ndarray)):
            return torch.as_tensor(np.asarray(key), dtype=torch.long,
                                   device=self._data.device)
        return key

    def __getitem__(self, key):
        idx = self._norm_index(key)
        return _apply_op(_AdhocOp(lambda data: data[idx]),
                         (self,), {})

    def __setitem__(self, key, value):
        idx = self._norm_index(key)
        if isinstance(value, NDArray):
            value = value._data
        data = self._data.detach().clone()
        data[idx] = torch.as_tensor(value, dtype=data.dtype,
                                    device=data.device)
        self._data = data

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- python numerics ----------------------------------------------------
    def __bool__(self):
        if self.size != 1:
            raise ValueError("The truth value of an NDArray with multiple "
                             "elements is ambiguous")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __index__(self):
        return int(self.asscalar())

    def __hash__(self):
        return id(self)

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self._ctx)

    # -- arithmetic (through the op registry) -------------------------------
    def _binary(self, other, op, scalar_op):
        from ..ops import registry
        if isinstance(other, NDArray):
            return _apply_op(registry.get(op), (self, other), {})
        return _apply_op(registry.get(scalar_op), (self,),
                         {"scalar": float(other)})

    def __add__(self, other):
        return self._binary(other, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, other):
        return self._binary(other, "broadcast_sub", "_rminus_scalar")

    def __mul__(self, other):
        return self._binary(other, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, other):
        return self._binary(other, "broadcast_div", "_rdiv_scalar")

    __div__ = __truediv__
    __rdiv__ = __rtruediv__

    def __mod__(self, other):
        return self._binary(other, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, other):
        return self._binary(other, "broadcast_mod", "_rmod_scalar")

    def __and__(self, other):
        return self._binary(other, "broadcast_logical_and",
                            "_logical_and_scalar")

    __rand__ = __and__

    def __or__(self, other):
        return self._binary(other, "broadcast_logical_or",
                            "_logical_or_scalar")

    __ror__ = __or__

    def __xor__(self, other):
        return self._binary(other, "broadcast_logical_xor",
                            "_logical_xor_scalar")

    __rxor__ = __xor__

    def __invert__(self):
        from . import logical_not
        return logical_not(self)

    def __matmul__(self, other):
        if not isinstance(other, NDArray):
            return NotImplemented
        from . import _matmul
        return _matmul(self, other)

    def __pow__(self, other):
        return self._binary(other, "broadcast_power", "_power_scalar")

    def __rpow__(self, other):
        return self._binary(other, "broadcast_power", "_rpower_scalar")

    def __neg__(self):
        from . import negative
        return negative(self)

    def __abs__(self):
        from . import abs as _abs
        return _abs(self)

    def __eq__(self, other):
        return self._binary(other, "broadcast_equal", "_equal_scalar")

    def __ne__(self, other):
        return self._binary(other, "broadcast_not_equal",
                            "_not_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "broadcast_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def _inplace(self, other, op, scalar_op):
        self._data = self._binary(other, op, scalar_op)._data
        return self

    def __iadd__(self, other):
        return self._inplace(other, "broadcast_add", "_plus_scalar")

    def __isub__(self, other):
        return self._inplace(other, "broadcast_sub", "_minus_scalar")

    def __imul__(self, other):
        return self._inplace(other, "broadcast_mul", "_mul_scalar")

    def __itruediv__(self, other):
        return self._inplace(other, "broadcast_div", "_div_scalar")

    # -- method-style op dispatch ------------------------------------------
    def __getattr__(self, name):
        # x.sum(), x.mean(), ... through the registry-generated namespace
        if name.startswith("_"):
            raise AttributeError(name)
        from . import __dict__ as nd_ns
        fn = nd_ns.get(name)
        if fn is None or not callable(fn):
            raise AttributeError("NDArray has no attribute %r" % name)
        arr = self

        def method(*args, **kwargs):
            return fn(arr, *args, **kwargs)

        return method

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        from . import reshape as _reshape
        return _reshape(self, shape=shape, **kwargs)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        from . import transpose as _transpose
        return _transpose(self, axes=axes)

    def flatten(self):
        from . import Flatten
        return Flatten(self)


# ---------------------------------------------------------------------------
# the invoke path (parity: Imperative::Invoke)
# ---------------------------------------------------------------------------


def _apply_op(opdef, args, kwargs):
    """Unwrap the NDArrays, run the op with torch's grad mode on while
    recording (a non-differentiable op never builds a graph), and wrap the
    outputs on the first input's context (a creation op makes its tensor
    on `ctx=`, the current context by default)."""
    kwargs = dict(kwargs)
    out = kwargs.pop("out", None)
    ctx = kwargs.pop("ctx", None)
    args = [a._data if isinstance(a, NDArray) else a for a in args]
    first = next((a for a in args if isinstance(a, torch.Tensor)), None)
    for k, v in kwargs.items():
        if isinstance(v, NDArray):
            kwargs[k] = v._data
            first = v._data if first is None else first
    if ctx is None:
        ctx = context_of(first.device) if first is not None \
            else current_context()
    if getattr(opdef, "creation", False):
        kwargs["device"] = ctx.torch_device()
    grad = autograd.is_recording() and opdef.differentiable
    if grad == torch.is_grad_enabled():
        res = opdef.fn(*args, **kwargs)
    else:
        # a grad-mode switch only where it changes the mode: a graph that
        # torch.export traces then holds no grad-mode region an op
        with torch.set_grad_enabled(grad):
            res = opdef.fn(*args, **kwargs)
    if _engine.NAIVE:
        _engine.sync_outputs(res)
    if isinstance(res, (tuple, list)):
        return tuple(NDArray(r, ctx=ctx) for r in res)
    out_nd = NDArray(res, ctx=ctx)
    if out is not None:
        out._data = out_nd._data
        return out
    return out_nd


def make_nd_func(opdef):
    """Generate the mx.nd.<op> function (parity: ndarray/register.py)."""

    def nd_func(*args, **kwargs):
        return _apply_op(opdef, args, kwargs)

    nd_func.__name__ = opdef.name
    nd_func.__doc__ = opdef.doc
    return nd_func
