"""The `Custom` operator (port of `mxnet_tpu/ops/custom.py`): a Python
op registered with `operator.register`, run as one node of torch's graph.

`run_custom` builds the prop, infers the outputs' shapes and types from
it, and calls `_CustomNode`, a `torch.autograd.Function` whose forward
runs the user's `CustomOp.forward` and whose backward runs its
`.backward` on NDArrays of the inputs' device, the same instance for
both. On "meta" tensors (Symbol shape inference) the prop's shapes are
the answer and no user code runs. The registered op serves `sym.Custom`
(an executor, a hybridized block's graph) and raises on auxiliary
states, which no graph path persists, as the reference's does;
`nd.Custom` (operator.invoke) passes them as zeros.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, numpy_dtype, torch_dtype
from .registry import register


def make_prop(op_type, params):
    from .. import operator
    return operator.get(op_type)(**params)


def _shapes_types(prop, tensors):
    in_shapes = [tuple(t.shape) for t in tensors]
    _, out_shapes, aux_shapes = prop.infer_shape(list(in_shapes))
    try:
        _, out_types, _ = prop.infer_type(
            [numpy_dtype(t.dtype) for t in tensors])
    except NotImplementedError:
        out_types = [tensors[0].dtype if tensors else torch.float32] \
            * len(out_shapes)
    return (in_shapes, [tuple(s) for s in out_shapes],
            [tuple(s) for s in aux_shapes],
            [torch_dtype(t) for t in out_types])


class _CustomNode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prop, train, out_specs, aux_shapes, *tensors):
        from .. import autograd
        from ..context import context_of
        from ..ndarray import NDArray
        dev = tensors[0].device
        device_ctx = context_of(dev)
        op = prop.create_operator(device_ctx, [tuple(t.shape)
                                               for t in tensors],
                                  [numpy_dtype(t.dtype) for t in tensors])
        ins = [NDArray(t.detach()) for t in tensors]
        outs = [NDArray(torch.zeros(s, dtype=dt, device=dev))
                for s, dt in out_specs]
        aux = [NDArray(torch.zeros(s, device=dev)) for s in aux_shapes]
        with autograd.pause(), device_ctx:
            op.forward(train, ["write"] * len(outs), ins, outs, aux)
        ctx.op, ctx.ins, ctx.outs, ctx.aux = op, ins, outs, aux
        ctx.device_ctx = device_ctx
        return tuple(o._data.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        from .. import autograd
        from ..ndarray import NDArray
        in_grads = [NDArray(torch.zeros_like(i._data)) for i in ctx.ins]
        with autograd.pause(), ctx.device_ctx:
            ctx.op.backward(["write"] * len(in_grads),
                            [NDArray(g) for g in grads], ctx.ins, ctx.outs,
                            in_grads, ctx.aux)
        out = []
        for g, i in zip(in_grads, ctx.ins):
            t = i._data
            out.append(g._data.to(device=t.device, dtype=t.dtype)
                       if t.is_floating_point() else None)
        return (None, None, None, None) + tuple(out)


def run_custom(op_type, params, tensors, allow_aux):
    """The outputs of custom op `op_type` (with its prop's `params`) on
    `tensors`: one tensor, or a tuple of them."""
    prop = make_prop(op_type, params)
    _, out_shapes, aux_shapes, out_types = _shapes_types(prop, tensors)
    if aux_shapes and not allow_aux:
        raise MXNetError(
            "symbolic Custom op %r declares auxiliary states, which the "
            "graph path does not persist: carry state through out_data "
            "or use the imperative nd.Custom" % op_type)
    if any(t.device.type == "meta" for t in tensors):
        outs = tuple(torch.empty(s, dtype=dt, device="meta")
                     for s, dt in zip(out_shapes, out_types))
    else:
        from .. import autograd
        outs = _CustomNode.apply(prop, autograd.is_training(),
                                 list(zip(out_shapes, out_types)),
                                 aux_shapes, *tensors)
    return outs if len(outs) > 1 else outs[0]


@register("Custom", num_outputs=-1)
def Custom(*inputs, op_type=None, **params):
    """A registered Python custom op on `inputs` (graph paths)."""
    if op_type is None:
        raise MXNetError("Custom: op_type is required")
    return run_custom(op_type, params, inputs, allow_aux=False)
