"""Custom operators written in Python (port of `mxnet_tpu/operator.py`):
`CustomOp`, `CustomOpProp`, `register`, `get`, `invoke` / `Custom`
(mx.nd.Custom), and the deprecated `PythonOp`, `NumpyOp` and `NDArrayOp`
adapters onto them.

A custom op runs as one node of torch's graph, a `torch.autograd.Function`
whose forward and backward call the user's `CustomOp.forward` and
`.backward` on NDArrays of the inputs' device (ops/custom.py). The same
node serves `nd.Custom`, a bound Symbol's executor (`sym.Custom`) and a
hybridized block. One `CustomOp` instance serves a call's forward and
its backward. The callbacks run with the inputs' device as the current
context, so an array the op makes with `mx.nd.array` lands beside its
inputs; `assign` moves a value made elsewhere to its destination's
device. As in the reference, `nd.Custom` gives a prop's auxiliary states
as zeros each call, while the graph paths raise on them.
"""
from __future__ import annotations

import numpy as np

from .base import MXNetError
from .ndarray import NDArray

_REGISTRY = {}


class CustomOp:
    """Base class of a custom op's computation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write src into dst by req ('null', 'write', 'inplace' or
        'add'), on dst's device."""
        if req == "null":
            return
        value = src if isinstance(src, NDArray) else NDArray(
            np.asarray(src), ctx=dst.context)
        value = value._data.to(dst._data.device)
        if req in ("write", "inplace"):
            dst._data = value
        elif req == "add":
            dst._data = dst._data + value
        else:
            raise MXNetError("unknown req %r" % (req,))


class CustomOpProp:
    """A custom op's metadata: arguments, outputs, shapes and types."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Register a CustomOpProp subclass under `reg_name`."""

    def do_register(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls

    return do_register


def get(name):
    if name not in _REGISTRY:
        raise MXNetError("custom op %s not registered" % name)
    return _REGISTRY[name]


def invoke(op_type, *inputs, **params):
    """Run a registered custom op on NDArrays (mx.nd.Custom): its output,
    or a list of them; recorded for autograd while recording."""
    from .ndarray.ndarray import _AdhocOp, _apply_op
    from .ops.custom import run_custom

    def fn(*tensors):
        return run_custom(op_type, params, tensors, allow_aux=True)

    res = _apply_op(_AdhocOp(fn), inputs, {})
    return list(res) if isinstance(res, tuple) else res


def Custom(*inputs, op_type=None, **params):
    if op_type is None:
        raise MXNetError("Custom: op_type is required")
    return invoke(op_type, *inputs, **params)


# ---------------------------------------------------------------------------
# the deprecated interfaces, kept as adapters onto CustomOp
# ---------------------------------------------------------------------------

_DEPRECATED_SEQ = [0]


class PythonOp:
    """Deprecated base. Subclass NumpyOp or NDArrayOp; get_symbol(*args)
    builds the graph node."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def get_symbol(self, *args, **kwargs):
        raise NotImplementedError("use NumpyOp or NDArrayOp")

    def forward(self, in_data, out_data):
        raise NotImplementedError

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs())

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def need_top_grad(self):
        return self.need_top_grad_

    def _register_as_custom(self, shim_cls):
        """Register a CustomOpProp delegating to this instance, once per
        instance (repeated get_symbol calls reuse it)."""
        cached = getattr(self, "_custom_reg_name", None)
        if cached is not None:
            return cached
        op = self
        _DEPRECATED_SEQ[0] += 1
        reg_name = "_deprecated_pyop_%d" % _DEPRECATED_SEQ[0]

        class _Prop(CustomOpProp):
            def __init__(self):
                super().__init__(need_top_grad=op.need_top_grad())

            def list_arguments(self):
                return op.list_arguments()

            def list_outputs(self):
                return op.list_outputs()

            def infer_shape(self, in_shape):
                ins, outs = op.infer_shape(in_shape)
                return ins, outs, []

            def create_operator(self, ctx, shapes, dtypes):
                return shim_cls()

        register(reg_name)(_Prop)
        self._custom_reg_name = reg_name
        return reg_name

    def _build(self, shim_cls, args, kwargs):
        from . import symbol
        reg_name = self._register_as_custom(shim_cls)
        kwargs.pop("name", None)
        return symbol.Custom(*args, op_type=reg_name, **kwargs)


class NumpyOp(PythonOp):
    """Deprecated numpy custom op: forward / backward take numpy arrays
    and fill the outputs in place."""

    def get_symbol(self, *args, **kwargs):
        op = self

        class _Shim(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                ins = [d.asnumpy() for d in in_data]
                outs = [np.zeros(d.shape, dtype=np.float32)
                        for d in out_data]
                op.forward(in_data=ins, out_data=outs)
                for i, (dst, src) in enumerate(zip(out_data, outs)):
                    self.assign(dst, req[i], NDArray(src, ctx=dst.context))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                grads = [np.zeros(g.shape, dtype=np.float32)
                         for g in in_grad]
                op.backward(out_grad=[g.asnumpy() for g in out_grad],
                            in_data=[d.asnumpy() for d in in_data],
                            out_data=[d.asnumpy() for d in out_data],
                            in_grad=grads)
                for i, (dst, src) in enumerate(zip(in_grad, grads)):
                    self.assign(dst, req[i], NDArray(src, ctx=dst.context))

        return self._build(_Shim, args, kwargs)


class NDArrayOp(PythonOp):
    """Deprecated NDArray custom op: forward / backward take NDArrays
    and write the outputs in place with framework ops."""

    def get_symbol(self, *args, **kwargs):
        op = self

        class _Shim(CustomOp):
            def forward(self, is_train, req, in_data, out_data, aux):
                op.forward(in_data=list(in_data), out_data=list(out_data))

            def backward(self, req, out_grad, in_data, out_data, in_grad,
                         aux):
                op.backward(out_grad=list(out_grad), in_data=list(in_data),
                            out_data=list(out_data), in_grad=list(in_grad))

        return self._build(_Shim, args, kwargs)
