"""mx.sym: symbolic graphs (port of `mxnet_tpu/symbol/__init__.py`).

A Symbol is a Python DAG of op nodes over the port's op registry; one
`sym.<op>` function is generated per registered name, as the reference's
are. Binding it (`simple_bind` / `bind`) makes an `Executor`
(executor.py) that interprets the DAG on torch tensors.

Shape inference keeps the reference's two parts: the parameter-variable
rules (`_OP_INPUT_NAMES`, `_param_shape`, with the batch-guess retry for
0 dims) and, for everything else, the op itself: the reference evaluates
each node under `jax.eval_shape`, the port runs it on torch's "meta"
device, which computes shapes and dtypes without data. Shape inference
runs the ops in inference mode (BatchNorm from its moving statistics),
whose shapes are the training mode's.

The JSON format is the reference's (`nodes` / `heads` /
`mxnet_tpu_version`, op attributes as `repr` strings, variables' `shape`
hints), so a graph written by either package loads in the other, and so
does an older MXNet layout (`utils/legacy.upgrade_json`, with the
BatchNorm aux inputs pre-nnvm files omit). The creation ops (`zeros`,
`ones`, `full`, `arange`, `eye`) make their tensors on the executor's
device; a 0 in their shape is solved at bind time like a variable's. The
optimizer update ops (`sgd_update`, `adam_update`, ...) are Symbol ops
too, their outputs the new weight and states. The sub-namespaces
`sym.random`, `sym.linalg` and `sym.contrib` are the reference's; a
`sym.random` node is a creation op too, so it samples on the executor's
device from that device's generator each time the graph runs, and shape
inference (on "meta") draws nothing. A HybridBlock traces into a Symbol
when called on one (gluon/block.py), which is how `hybridize`, `export`
and SymbolBlock reach this module.
"""
from __future__ import annotations

import inspect
import json
import math

import numpy as np
import torch

from .. import attribute as _attr_mod
from .. import autograd as _autograd
from .. import name as _name_mod
from ..base import MXNetError, NotImplementedForSymbol, torch_dtype
from ..ops import contrib as _ops_contrib  # noqa: F401  (registers ops)
from ..ops import custom as _ops_custom
from ..ops import nn as _ops_nn  # noqa: F401
from ..ops import optimizer_ops as _ops_optimizer  # noqa: F401
from ..ops import quantization as _ops_quantization  # noqa: F401
from ..ops import random_ops as _ops_random  # noqa: F401
from ..ops import sparse as _ops_sparse  # noqa: F401
from ..ops import registry as _registry
from ..ops import tensor as _ops_tensor  # noqa: F401
from ..ops.nn import rnn_param_size


def _opdef(op_name):
    """The registry entry of `op_name`; an op the port lacks raises,
    naming it."""
    if op_name not in _registry.OPS:
        raise MXNetError("operator %r is not in the port's op registry "
                         "(ported ops: mxnet_tpu_torch.ops.registry."
                         "list_ops())" % (op_name,))
    return _registry.OPS[op_name]


# ---------------------------------------------------------------------------
# graph nodes
# ---------------------------------------------------------------------------

class SymNode:
    __slots__ = ("op", "name", "inputs", "kwargs", "attr", "is_aux",
                 "shape_hint", "dtype_hint", "init_hint", "num_outputs")

    def __init__(self, op, name, inputs, kwargs, attr=None, is_aux=False,
                 shape_hint=None, dtype_hint=None, init_hint=None):
        self.op = op                      # OpDef, or None for a variable
        self.name = name
        self.inputs = inputs              # list of (SymNode, out_idx)
        self.kwargs = kwargs
        self.attr = attr or {}
        self.is_aux = is_aux
        self.shape_hint = shape_hint
        self.dtype_hint = dtype_hint
        self.init_hint = init_hint
        self.num_outputs = _static_num_outputs(op, kwargs) if op else 1


def _static_num_outputs(opdef, kwargs):
    # generated op names (max, sum, abs) shadow builtins in this module:
    # no bare builtin of those names here
    name = opdef.name
    if name == "SliceChannel":
        return int(kwargs.get("num_outputs", 1))
    if name == "RNN":
        if kwargs.get("state_outputs"):
            return 3 if kwargs.get("mode", "lstm") == "lstm" else 2
        return 1
    if name == "BatchNorm":
        return 3
    if name == "_sample_multinomial":
        return 2 if kwargs.get("get_prob") else 1
    if name == "topk":
        return 2 if kwargs.get("ret_typ") == "both" else 1
    if name == "Custom":
        return len(_custom_prop(kwargs).list_outputs())
    return opdef.num_outputs if opdef.num_outputs > 1 else 1


def _custom_prop(kwargs):
    """The CustomOpProp a Custom node's parameters make."""
    return _ops_custom.make_prop(kwargs["op_type"], {
        k: v for k, v in kwargs.items()
        if k != "op_type" and not isinstance(v, Symbol)})


# tensor-input names of the ops that create their parameter variables when
# the caller omits them; aux entries mirror list_auxiliary_states
_OP_INPUT_NAMES = {
    "FullyConnected": (("data", "weight", "bias"), ()),
    "Convolution": (("data", "weight", "bias"), ()),
    "Deconvolution": (("data", "weight", "bias"), ()),
    "BatchNorm": (("data", "gamma", "beta"), ("moving_mean", "moving_var")),
    "LayerNorm": (("data", "gamma", "beta"), ()),
    "InstanceNorm": (("data", "gamma", "beta"), ()),
    "Embedding": (("data", "weight"), ()),
    "RNN": (("data", "parameters", "state", "state_cell"), ()),
    "LeakyReLU": (("data", "gamma"), ()),
    "SoftmaxOutput": (("data", "label"), ()),
    "LinearRegressionOutput": (("data", "label"), ()),
    "MAERegressionOutput": (("data", "label"), ()),
    "LogisticRegressionOutput": (("data", "label"), ()),
    "SVMOutput": (("data", "label"), ()),
}


class Symbol:
    """An output list over the DAG."""

    def __init__(self, outputs):
        self._outputs = list(outputs)  # list of (SymNode, out_idx)

    @property
    def name(self):
        return self._outputs[0][0].name

    def __repr__(self):
        return "<Symbol %s>" % ", ".join(n.name for n, _ in self._outputs)

    def __iter__(self):
        for out in self._outputs:
            yield Symbol([out])

    def __len__(self):
        return len(self._outputs)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index in names:
                return Symbol([self._outputs[names.index(index)]])
            for out in self._outputs:
                if out[0].name == index:
                    return Symbol([out])
            raise ValueError("cannot find output %s" % index)
        return Symbol([self._outputs[index]])

    # -- graph traversal ----------------------------------------------------
    def _topo(self):
        order, seen = [], set()
        stack = [(n, False) for n, _ in reversed(self._outputs)]
        while stack:
            node, done = stack.pop()
            if done:
                order.append(node)
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            stack.append((node, True))
            for inp, _ in reversed(node.inputs):
                if id(inp) not in seen:
                    stack.append((inp, False))
        return order

    def list_arguments(self):
        return [n.name for n in self._topo() if n.op is None and not n.is_aux]

    def list_auxiliary_states(self):
        return [n.name for n in self._topo() if n.op is None and n.is_aux]

    def list_outputs(self):
        return ["%s_output%d" % (node.name, idx) if node.num_outputs > 1
                else "%s_output" % node.name
                for node, idx in self._outputs]

    def list_inputs(self):
        return [n.name for n in self._topo() if n.op is None]

    def get_internals(self):
        return Symbol([(n, i) for n in self._topo()
                       for i in range(n.num_outputs)])

    def get_children(self):
        node = self._outputs[0][0]
        return Symbol(list(node.inputs)) if node.inputs else None

    def attr(self, key):
        return self._outputs[0][0].attr.get(key)

    def attr_dict(self):
        return {n.name: dict(n.attr) for n in self._topo() if n.attr}

    def _set_attr(self, **kwargs):
        self._outputs[0][0].attr.update({k: str(v)
                                         for k, v in kwargs.items()})

    def list_attr(self, recursive=False):
        """This symbol's own attributes (recursive=True is deprecated, as
        in the reference: use attr_dict())."""
        if recursive:
            raise DeprecationWarning(
                "list_attr(recursive=True) is deprecated; use attr_dict()")
        return dict(self._outputs[0][0].attr)

    def astype(self, dtype):
        return create("Cast", self, dtype=np.dtype(dtype).name)

    def gradient(self, wrt):
        raise MXNetError(
            "Symbol.gradient is the deprecated pre-autograd API; bind() "
            "the symbol and call backward(), or use mx.autograd")

    # NDArray-only APIs raise as the reference's do
    def wait_to_read(self, *args, **kwargs):
        raise NotImplementedForSymbol(self.wait_to_read)

    def asnumpy(self, *args, **kwargs):
        raise NotImplementedForSymbol(self.asnumpy)

    def asscalar(self, *args, **kwargs):
        raise NotImplementedForSymbol(self.asscalar)

    def copy(self, *args, **kwargs):
        raise NotImplementedForSymbol(self.copy)

    def as_in_context(self, *args, **kwargs):
        raise NotImplementedForSymbol(self.as_in_context)

    def detach(self, *args, **kwargs):
        raise NotImplementedForSymbol(self.detach)

    def backward(self, *args, **kwargs):
        raise NotImplementedForSymbol(self.backward)

    # -- arithmetic ---------------------------------------------------------
    def _binary(self, other, op, scalar_op):
        if isinstance(other, Symbol):
            return create(op, self, other)
        return create(scalar_op, self, scalar=float(other))

    def __add__(self, other):
        return self._binary(other, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, other):
        return create("_rminus_scalar", self, scalar=float(other))

    def __mul__(self, other):
        return self._binary(other, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binary(other, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, other):
        return create("_rdiv_scalar", self, scalar=float(other))

    __div__ = __truediv__

    def __matmul__(self, other):
        if not isinstance(other, Symbol):
            return NotImplemented
        return create("_matmul", self, other)

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
        return create("logical_not", self)

    def __pow__(self, other):
        return self._binary(other, "_power", "_power_scalar")

    def __neg__(self):
        return create("negative", self)

    def __eq__(self, other):
        return self._binary(other, "_equal", "_equal_scalar")

    def __ne__(self, other):
        return self._binary(other, "_not_equal", "_not_equal_scalar")

    def __gt__(self, other):
        return self._binary(other, "_greater", "_greater_scalar")

    def __ge__(self, other):
        return self._binary(other, "_greater_equal", "_greater_equal_scalar")

    def __lt__(self, other):
        return self._binary(other, "_lesser", "_lesser_scalar")

    def __le__(self, other):
        return self._binary(other, "_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def __getattr__(self, name):
        # x.relu(), x.sum(axis=1), ... through the generated namespace
        if name.startswith("_"):
            raise AttributeError(name)
        fn = globals().get(name)
        if fn is None or not callable(fn):
            raise AttributeError("Symbol has no attribute %r" % name)
        this = self

        def method(*args, **kwargs):
            return fn(this, *args, **kwargs)

        return method

    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return create("Reshape", self, shape=shape, **kwargs)

    # -- shape / dtype inference -------------------------------------------
    def infer_shape(self, *args, **kwargs):
        """(arg_shapes, out_shapes, aux_shapes) from the given input
        shapes, by name."""
        return self._solve_shapes(kwargs)[0]

    def infer_shape_partial(self, *args, **kwargs):
        try:
            return self._solve_shapes(kwargs, partial=True)[0]
        except Exception:
            return None, None, None

    def _has_deferred(self):
        """Whether a creation node's shape holds a 0 (a dim bound later)."""
        return any(_is_deferred(n) for n in self._topo())

    def _deferred_batch(self, known):
        """The size that fills the deferred (0) dims of the graph's creation
        nodes at the given variable shapes (None when it has none)."""
        return self._solve_shapes(known)[1] if self._has_deferred() \
            else None

    def _solve_shapes(self, known, partial=False):
        """((arg_shapes, out_shapes, aux_shapes), the batch guess that
        resolved the deferred (0) dims, None when there were none).

        A 0 in a variable's shape hint (an RNN cell's begin state) or in a
        creation node's shape (`sym.zeros((L, 0, H))`) is an unknown dim:
        batch candidates from the known shapes are tried, data-named
        inputs' dims first, until the whole graph checks out."""
        has_unknown = any(
            n.op is None and n.name not in known and
            n.shape_hint is not None and 0 in tuple(n.shape_hint)
            for n in self._topo()) or self._has_deferred()
        if not has_unknown:
            return self._infer_shape_once(known, partial, None), None
        primary, fallback = [], []
        for name, shp in known.items():
            bucket = primary if "data" in name else fallback
            for d in (shp or ()):
                if d and d not in bucket:
                    bucket.append(d)
        fallback = [d for d in fallback if d not in primary]
        last_err = None
        for guess in primary:
            try:
                return self._infer_shape_once(known, partial, guess), guess
            except Exception as e:  # a wrong guess: try the next dim
                last_err = e
        # weight dims are the last resort; every candidate is probed and
        # the survivors must agree, so a weight dim that happens to
        # type-check cannot resolve the graph to a wrong shape
        successes = []
        for guess in fallback or [None]:
            try:
                successes.append(
                    (guess, self._infer_shape_once(known, partial, guess)))
            except Exception as e:
                last_err = e
        if successes:
            disagreeing = [g for g, res in successes[1:]
                           if res != successes[0][1]]
            if disagreeing and not partial:
                raise MXNetError(
                    "ambiguous deferred (0) dims: guesses %s all "
                    "type-check but yield different shapes; pass an "
                    "explicit shape for the deferred input(s)"
                    % ([successes[0][0]] + disagreeing))
            return successes[0][1], successes[0][0]
        if partial:
            return (None, None, None), None
        raise MXNetError(
            "could not resolve deferred (0) dims from the provided shapes: "
            "%s" % last_err)

    def _infer_shape_once(self, known, partial, batch_guess):
        metas = {}     # node id -> tuple of meta tensors, one per output
        var_shape = {}

        def meta(shape, dtype_hint):
            return torch.empty(tuple(shape), dtype=torch_dtype(dtype_hint),
                               device="meta")

        for node in self._topo():
            if node.op is None:
                shp = known.get(node.name, node.shape_hint)
                if shp is not None and 0 in tuple(shp):
                    shp = tuple(batch_guess if d == 0 else d for d in shp) \
                        if batch_guess else None
                if shp is not None:
                    metas[id(node)] = (meta(shp, node.dtype_hint),)
                    var_shape[node.name] = tuple(shp)
                continue
            # parameter inputs without a shape take the op's rule
            ins = []
            for pos, (inp, oidx) in enumerate(node.inputs):
                if id(inp) not in metas:
                    if inp.op is not None:
                        raise MXNetError("graph order violation")
                    rule = _param_shape(node, pos, metas)
                    if rule is None:
                        if partial:
                            ins = None
                            break
                        raise MXNetError(
                            "cannot infer shape of argument '%s' for op "
                            "%s" % (inp.name, node.op.name))
                    metas[id(inp)] = (meta(rule, inp.dtype_hint),)
                    var_shape[inp.name] = tuple(rule)
                ins.append(metas[id(inp)][oidx])
            if ins is None:
                continue
            try:
                with _autograd._RecordingStateScope(False, False), \
                        torch.no_grad():
                    out = node.op.fn(*ins, **_op_kwargs(node, "meta",
                                                        batch_guess))
            except Exception as e:  # noqa: BLE001
                if partial:
                    continue
                raise MXNetError("shape inference failed at op %s(%s): %s"
                                 % (node.op.name, node.name, e)) from e
            metas[id(node)] = tuple(out) if isinstance(out, (tuple, list)) \
                else (out,)

        arg_shapes = [var_shape.get(n) for n in self.list_arguments()]
        aux_shapes = [var_shape.get(n) for n in self.list_auxiliary_states()]
        out_shapes = []
        for node, idx in self._outputs:
            m = metas.get(id(node))
            out_shapes.append(tuple(m[idx].shape) if m else None)
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """float32 for every argument, output and aux state, as the
        reference reports."""
        return ([np.float32] * len(self.list_arguments()),
                [np.float32] * len(self.list_outputs()),
                [np.float32] * len(self.list_auxiliary_states()))

    # -- evaluation (shared by the Executor and eval()) --------------------
    def _eval(self, values, train=False, zero_missing_aux=False,
              device=None, batch=None):
        """Interpret the DAG on {variable name: tensor}: (outputs,
        aux_updates), aux_updates mapping a BatchNorm's moving-statistic
        variable to its new value (a functional update, detached from the
        graph). Gradients flow wherever torch's grad mode and the inputs'
        requires_grad let them; the caller sets both. With
        `zero_missing_aux`, an RNN's begin state that `values` lacks (an
        aux variable read only as an RNN's state input, which the executor
        would allocate as zeros) is zeros of the shape the op's rule gives
        from its data, in the data's dtype; any other missing variable
        raises. A node's outputs are dropped after their last use (what
        autograd saved for the backward stays alive through it), so the
        forward's peak memory is the eager forward's. Creation nodes make
        their tensors on `device` (by default the first value's), their
        deferred (0) dims filled by `batch` (by default solved from the
        values' shapes)."""
        order = self._topo()
        if device is None:
            device = next((v.device for v in values.values()), None) or \
                _current_device()
        if batch is None and any(_is_deferred(n) for n in order):
            batch = self._deferred_batch(
                {k: tuple(v.shape) for k, v in values.items()})
        uses, states, others = {}, set(), set()
        for node in order:
            for pos, (inp, _) in enumerate(node.inputs):
                uses[id(inp)] = uses.get(id(inp), 0) + 1
                rnn_state = node.op.name == "RNN" and pos >= 2
                (states if rnn_state else others).add(id(inp))
        for node, _ in self._outputs:
            uses[id(node)] = uses.get(id(node), 0) + 1
        computed = {}
        aux_updates = {}
        with _autograd._RecordingStateScope(False, train):
            for node in order:
                if node.op is None:
                    if node.name not in values:
                        if zero_missing_aux and node.is_aux and \
                                id(node) in states and id(node) not in others:
                            continue
                        raise MXNetError("missing argument '%s'" % node.name)
                    computed[id(node)] = (values[node.name],)
                    continue
                ins = []
                for pos, (inp, oidx) in enumerate(node.inputs):
                    if id(inp) not in computed:
                        computed[id(inp)] = (_zero_state(node, pos, inp,
                                                         computed),)
                    ins.append(computed[id(inp)][oidx])
                out = node.op.fn(*ins, **_op_kwargs(node, device, batch))
                outs = tuple(out) if isinstance(out, (tuple, list)) \
                    else (out,)
                if node.op.name == "BatchNorm" and train and \
                        not node.kwargs.get("use_global_stats", False):
                    momentum = node.kwargs.get("momentum", 0.9)
                    with torch.no_grad():
                        for slot, stat in ((3, outs[1]), (4, outs[2])):
                            var = node.inputs[slot][0]
                            if var.op is None:
                                aux_updates[var.name] = (
                                    momentum * ins[slot]
                                    + (1 - momentum) * stat.detach())
                computed[id(node)] = outs
                for inp, _ in node.inputs:
                    uses[id(inp)] -= 1
                    if not uses[id(inp)]:
                        computed.pop(id(inp), None)
        outputs = []
        for node, idx in self._outputs:
            o = computed[id(node)]
            outputs.append(o[idx] if idx < len(o) else o[0])
        return outputs, aux_updates

    def eval(self, ctx=None, **kwargs):
        """Inference outputs for {argument name: NDArray}."""
        from ..ndarray import NDArray
        vals = {k: v._data for k, v in kwargs.items()}
        with torch.no_grad():
            outs, _ = self._eval(vals, train=False, device=None if ctx is None
                                 else ctx.torch_device())
        return [NDArray(o, ctx=ctx) for o in outs]

    # -- binding -----------------------------------------------------------
    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    stype_dict=None, group2ctx=None, shared_arg_names=None,
                    shared_exec=None, shared_buffer=None, **kwargs):
        from ..executor import Executor
        return Executor.simple_bind(self, ctx, grad_req=grad_req,
                                    type_dict=type_dict, **kwargs)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        from ..executor import Executor
        return Executor(self, ctx, args, args_grad, grad_req, aux_states)

    # -- serialization -----------------------------------------------------
    def tojson(self):
        order = self._topo()
        node_index = {id(n): i for i, n in enumerate(order)}

        def _ser(v):
            # numpy scalars repr as 'np.float32(0.3)' under numpy >= 2,
            # which no loader can eval: plain Python scalars first
            if isinstance(v, np.generic):
                v = v.item()
            if isinstance(v, (list, tuple)):
                return repr(type(v)(x.item() if isinstance(x, np.generic)
                                    else x for x in v))
            return repr(v)

        nodes = []
        for n in order:
            spec = {
                "op": "null" if n.op is None else n.op.name,
                "name": n.name,
                "attrs": {k: _ser(v) for k, v in n.kwargs.items()}
                if n.op else {},
                "inputs": [[node_index[id(i)], oi, 0] for i, oi in n.inputs],
                "is_aux": n.is_aux,
            }
            if n.op is None and n.shape_hint is not None:
                spec["shape"] = list(n.shape_hint)
            nodes.append(spec)
        heads = [[node_index[id(n)], i, 0] for n, i in self._outputs]
        return json.dumps({"nodes": nodes, "heads": heads,
                           "mxnet_tpu_version": 1}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def get_backend_symbol(self, backend):
        return self

    def debug_str(self):
        lines = []
        for n in self._topo():
            if n.op is None:
                lines.append("Variable:%s" % n.name)
            else:
                ins = ", ".join(i.name for i, _ in n.inputs)
                lines.append("%s(%s) -> %s" % (n.op.name, ins, n.name))
        return "\n".join(lines)


def _creation_shape(node):
    """A creation node's `shape` argument as a tuple (a sampler's may be
    None or one int)."""
    shape = node.kwargs.get("shape")
    if shape is None:
        return ()
    return (int(shape),) if np.isscalar(shape) else \
        tuple(int(d) for d in shape)


def _is_deferred(node):
    """A creation node whose shape holds a 0: a dim the bound data sets."""
    return node.op is not None and node.op.creation and \
        0 in _creation_shape(node)


def _op_kwargs(node, device, batch):
    """The node's op arguments; a creation op (a sampler included) also
    gets the device to make its tensor on, and `batch` in place of each 0
    of its shape."""
    if not node.op.creation:
        return node.kwargs
    kw = dict(node.kwargs, device=device)
    if batch and _is_deferred(node):
        kw["shape"] = tuple(batch if d == 0 else d
                            for d in _creation_shape(node))
    return kw


def _current_device():
    from ..context import current_context
    return current_context().torch_device()


def _zero_state(node, pos, var, computed):
    """Zeros for the aux variable `var` at input `pos` of `node`, from the
    op's shape rule over its data input, in the data's dtype."""
    shape = _param_shape(node, pos, computed)
    if shape is None:
        raise MXNetError("missing argument '%s'" % var.name)
    inp, oidx = node.inputs[0]
    data = computed[id(inp)][oidx]
    return torch.zeros(shape, dtype=data.dtype, device=data.device)


# ---------------------------------------------------------------------------
# parameter shape rules
# ---------------------------------------------------------------------------

def _param_shape(node, pos, metas):
    """The shape of the parameter variable at input `pos` of `node`, from
    its data input's shape and the op's arguments; None if no rule."""
    op = node.op.name
    kw = node.kwargs
    inp, oidx = node.inputs[0]
    m = metas.get(id(inp))
    if m is None:
        return None
    data_shape = tuple(m[oidx].shape)
    names = _OP_INPUT_NAMES.get(op)
    pname = names[0][pos] if names and pos < len(names[0]) else None
    if op == "FullyConnected":
        num_hidden = int(kw.get("num_hidden"))
        in_units = int(np.prod(data_shape[1:])) if kw.get("flatten", True) \
            else data_shape[-1]
        if pname == "weight":
            return (num_hidden, in_units)
        if pname == "bias":
            return (num_hidden,)
    if op in ("Convolution", "Deconvolution"):
        nf = int(kw.get("num_filter"))
        g = int(kw.get("num_group", 1))
        kernel = tuple(int(k) for k in kw.get("kernel", ()))
        if pname == "weight":
            if op == "Deconvolution":   # (C_in, num_filter / groups, *k)
                return (data_shape[1], nf // g) + kernel
            return (nf, data_shape[1] // g) + kernel
        if pname == "bias":
            return (nf,)
    if op in ("BatchNorm", "LayerNorm", "InstanceNorm"):
        axis = int(kw.get("axis", -1 if op == "LayerNorm" else 1))
        return (data_shape[axis],)
    if op == "LeakyReLU":
        return (data_shape[1],)
    if op == "Embedding":
        return (int(kw.get("input_dim")), int(kw.get("output_dim")))
    if op == "RNN":
        H = int(kw.get("state_size"))
        L = int(kw.get("num_layers", 1))
        bi = bool(kw.get("bidirectional", False))
        if pname == "parameters":
            return (rnn_param_size(L, data_shape[2], H, bi,
                                   kw.get("mode", "lstm")),)
        if pname in ("state", "state_cell"):
            return (L * (2 if bi else 1), data_shape[1], H)
    if op in ("SoftmaxOutput", "SVMOutput") and pname == "label":
        return tuple(data_shape[:-1])
    if op in ("LinearRegressionOutput", "MAERegressionOutput",
              "LogisticRegressionOutput") and pname == "label":
        return tuple(data_shape)
    return None


# ---------------------------------------------------------------------------
# symbol construction
# ---------------------------------------------------------------------------


def Variable(name, attr=None, shape=None, lr_mult=None, wd_mult=None,
             dtype=None, init=None, stype=None, **kwargs):
    attr = _attr_mod.current().get(attr)
    if lr_mult is not None:
        attr["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        attr["__wd_mult__"] = str(wd_mult)
    node = SymNode(None, name, [], {}, attr=attr, shape_hint=shape,
                   dtype_hint=dtype, init_hint=init)
    return Symbol([(node, 0)])


var = Variable


def aux_variable(name, shape=None):
    """A Variable flagged as an aux state (a layer-mutated statistic, an
    RNN's begin state): list_auxiliary_states names it, and neither
    init_params nor a gradient touches it."""
    v = Variable(name, shape=shape)
    v._outputs[0][0].is_aux = True
    return v


def Group(symbols):
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def _bind_positional_params(opdef, args, kwargs):
    """A positional argument that is neither a Symbol nor None (the
    `0, 6` of `F.clip(x, 0, 6)`) is the op's parameter at that position,
    as the ndarray namespace passes it; bind it by name into `kwargs`."""
    params = None
    for i, a in enumerate(args):
        if a is None or isinstance(a, Symbol):
            continue
        if params is None:
            params = list(inspect.signature(opdef.fn).parameters.values())
        if i >= len(params) or params[i].kind not in (
                params[i].POSITIONAL_ONLY, params[i].POSITIONAL_OR_KEYWORD):
            raise MXNetError("op %s: positional argument %d (%r) has no "
                             "parameter" % (opdef.name, i, a))
        if params[i].name in kwargs:
            raise MXNetError("op %s got %s twice" % (opdef.name,
                                                     params[i].name))
        kwargs[params[i].name] = a


#: the broadcasting arithmetic ops that the reference registers apart from
#: their elemwise twins, so that their nodes are named after the
#: broadcast_* name (broadcast_sub0, not elemwise_sub0); the port's
#: registry makes them aliases of one op
_BROADCAST_NAMES = frozenset(
    "broadcast_" + n for n in (
        "add", "plus", "sub", "minus", "mul", "div", "power", "maximum",
        "minimum", "equal", "not_equal", "greater", "greater_equal",
        "lesser", "lesser_equal"))


def create(op_name, *args, name=None, attr=None, **kwargs):
    """An op node over the Symbol arguments; parameter inputs the caller
    omits become variables named `<name>_<input>`."""
    opdef = _opdef(op_name)
    hint = op_name if op_name in _BROADCAST_NAMES else opdef.name
    name = _name_mod.current().get(name, hint.lower().lstrip("_"))
    attr = _attr_mod.current().get(attr)
    inputs = [a._outputs[0] for a in args if isinstance(a, Symbol)]
    _bind_positional_params(opdef, args, kwargs)

    names = _OP_INPUT_NAMES.get(opdef.name)
    if opdef.name == "Custom":
        # inputs bind to the prop's declared arguments, whatever the
        # order of the keywords
        names = (tuple(_custom_prop(kwargs).list_arguments()), ())
    if names is not None:
        input_names, aux_names = names
        want = list(input_names)
        if opdef.name in ("FullyConnected", "Convolution",
                          "Deconvolution") \
                and kwargs.get("no_bias", False):
            want.remove("bias")
        if opdef.name == "RNN" and kwargs.get("mode", "lstm") != "lstm":
            want.remove("state_cell")
        if opdef.name == "LeakyReLU" \
                and kwargs.get("act_type", "leaky") != "prelu":
            want.remove("gamma")  # only prelu has a parameter
        # declared inputs by keyword (weight=some_sym), else new variables
        for i, nm in enumerate(want):
            if i < len(inputs):
                continue
            if nm in kwargs and isinstance(kwargs[nm], Symbol):
                inputs.append(kwargs.pop(nm)._outputs[0])
            else:
                inputs.append(Variable("%s_%s" % (name, nm))._outputs[0])
        base = len(want)
        for j, nm in enumerate(aux_names):
            # aux-ness is positional: whether the state variable was made
            # here, passed positionally or by keyword, its slot marks it
            if base + j < len(inputs):
                node = inputs[base + j][0]
                if node.op is None:
                    node.is_aux = True
                continue
            if nm in kwargs and isinstance(kwargs[nm], Symbol):
                out = kwargs.pop(nm)._outputs[0]
            else:
                out = Variable("%s_%s" % (name, nm))._outputs[0]
            if out[0].op is None:
                out[0].is_aux = True
            inputs.append(out)
        leftover = [k for k, v in kwargs.items() if isinstance(v, Symbol)]
        if leftover:
            raise MXNetError(
                "op %s got unexpected tensor keyword(s) %s; its declared "
                "inputs are %s" % (opdef.name, leftover,
                                   list(want) + list(aux_names)))
    else:
        for k in list(kwargs):
            if isinstance(kwargs[k], Symbol):
                inputs.append(kwargs.pop(k)._outputs[0])

    node = SymNode(opdef, name, inputs, kwargs, attr=attr)
    if node.num_outputs > 1 and opdef.name != "BatchNorm":
        return Symbol([(node, i) for i in range(node.num_outputs)])
    return Symbol([(node, 0)])


def _make_sym_func(opname):
    def sym_func(*args, **kwargs):
        return create(opname, *args, **kwargs)

    sym_func.__name__ = opname
    sym_func.__doc__ = _registry.OPS[opname].doc
    return sym_func


for _n in list(_registry.OPS):
    globals()[_n] = _make_sym_func(_n)


def zeros(shape, dtype=None, **kwargs):
    """A `_zeros` node; a 0 in `shape` is a dim the bound data sets."""
    return create("_zeros", shape=tuple(shape), dtype=dtype or "float32",
                  **kwargs)


def ones(shape, dtype=None, **kwargs):
    return create("_ones", shape=tuple(shape), dtype=dtype or "float32",
                  **kwargs)


def arange(start, stop=None, step=1.0, repeat=1, dtype=None, **kwargs):
    return create("_arange", start=start, stop=stop, step=step,
                  repeat=repeat, dtype=dtype or "float32", **kwargs)


def full(shape, val, dtype=None, **kwargs):
    return create("_full", shape=tuple(shape), value=float(val),
                  dtype=dtype or "float32", **kwargs)


def eye(N, M=0, k=0, dtype=None, **kwargs):
    return create("_eye", N=N, M=M, k=k, dtype=dtype or "float32", **kwargs)


def _sym_or_scalar(lhs, rhs, both_op, lscalar_op, rscalar_op):
    lsym, rsym = isinstance(lhs, Symbol), isinstance(rhs, Symbol)
    if lsym and rsym:
        return create(both_op, lhs, rhs)
    if lsym:
        return create(lscalar_op, lhs, scalar=float(rhs))
    if rsym:
        return create(rscalar_op, rhs, scalar=float(lhs))
    raise TypeError("expected at least one Symbol argument")


def pow(base, exp):  # noqa: A001  (the reference's name)
    return _sym_or_scalar(base, exp, "_power", "_power_scalar",
                          "_rpower_scalar")


def maximum(lhs, rhs):
    return _sym_or_scalar(lhs, rhs, "_maximum", "_maximum_scalar",
                          "_maximum_scalar")


def minimum(lhs, rhs):
    return _sym_or_scalar(lhs, rhs, "_minimum", "_minimum_scalar",
                          "_minimum_scalar")


def hypot(lhs, rhs):
    return _sym_or_scalar(lhs, rhs, "_hypot", "_hypot_scalar",
                          "_hypot_scalar")


class _SubNS:
    """A sub-namespace of Symbol functions: {public name: op name}."""

    def __init__(self, mapping):
        for pub, opname in mapping.items():
            setattr(self, pub, _make_sym_func(opname))


random = _SubNS({
    "uniform": "_random_uniform", "normal": "_random_normal",
    "gamma": "_random_gamma", "exponential": "_random_exponential",
    "poisson": "_random_poisson", "randint": "_random_randint",
    "multinomial": "_sample_multinomial", "shuffle": "_shuffle",
})
linalg = _SubNS({n: "linalg_" + n for n in (
    "gemm", "gemm2", "potrf", "potri", "trsm", "trmm", "sumlogdiag",
    "syrk", "gelqf", "syevd")})
# every registered `_contrib_*` op under its short name, and quadratic
contrib = _SubNS(dict(
    {n[len("_contrib_"):]: n for n in _registry.list_ops()
     if n.startswith("_contrib_")}, quadratic="quadratic"))


def _rand_zipfian(true_classes, num_sampled, range_max):
    """The log-uniform candidate sampler as a graph: the same math as
    `nd.contrib.rand_zipfian`, composed from registered ops."""
    log_range = math.log(range_max + 1)
    rand = random.uniform(low=0, high=log_range, shape=(num_sampled,))
    sampled = create("_mod_scalar", create(
        "Cast", create("exp", rand) - 1, dtype="int32"), scalar=range_max)

    def expected_count(cls_sym):
        prob = create("log", (cls_sym + 2.0) / (cls_sym + 1.0))
        return prob * (float(num_sampled) / log_range)

    return (sampled,
            expected_count(create("Cast", true_classes, dtype="float32")),
            expected_count(create("Cast", sampled, dtype="float32")))


contrib.rand_zipfian = _rand_zipfian


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


_ACCEPTED_PARAMS_CACHE = {}


def _accepted_params(opdef):
    """The parameter names the op accepts, or None when it takes
    **kwargs (cached per op)."""
    key = id(opdef)
    if key not in _ACCEPTED_PARAMS_CACHE:
        sig = inspect.signature(opdef.fn)
        if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
            _ACCEPTED_PARAMS_CACHE[key] = None
        else:
            _ACCEPTED_PARAMS_CACHE[key] = frozenset(sig.parameters)
    return _ACCEPTED_PARAMS_CACHE[key]


def _parse_attr_value(v):
    """Attribute values are repr() strings ('(5, 5)', 'True', 'None',
    "'relu'"): evaluate what evaluates, keep the rest as strings."""
    if not isinstance(v, str):
        return v
    try:
        # empty namespaces: a bare word such as 'relu' must not resolve
        # to this module's generated op functions
        return eval(v, {"__builtins__": {}}, {})  # noqa: S307
    except Exception:
        return v


# pre-nnvm symbol JSON omits the auxiliary-state inputs nnvm later made
# explicit; loading adds them under the reference's aux names (parity:
# legacy_json_util.cc's upgrade pass)
_LEGACY_AUX_INPUTS = {
    "BatchNorm": ("moving_mean", "moving_var"),
    "batch_norm_v1": ("moving_mean", "moving_var"),
}


def load_json(json_str):
    """A Symbol from JSON in the reference's format, or an older MXNet
    layout (`legacy.upgrade_json`). An op the port lacks raises, naming
    it."""
    from ..utils import legacy
    data = legacy.upgrade_json(json.loads(json_str))
    nodes = []
    for spec in data["nodes"]:
        inputs = [(nodes[i], oi) for i, oi, _ in spec["inputs"]]
        aux_names = _LEGACY_AUX_INPUTS.get(spec["op"])
        if aux_names and len(inputs) == 5 - len(aux_names):
            for an in aux_names:
                inputs.append((SymNode(None, "%s_%s" % (spec["name"], an),
                                       [], {}, is_aux=True), 0))
        node_attr = dict(spec.get("attr") or {})
        if spec["op"] == "null":
            shp = spec.get("shape")
            node = SymNode(None, spec["name"], [], {}, attr=node_attr,
                           is_aux=spec.get("is_aux", False),
                           shape_hint=tuple(shp) if shp is not None
                           else None)
        else:
            opdef = _opdef(spec["op"])
            kwargs = {k: _parse_attr_value(v)
                      for k, v in spec.get("attrs", {}).items()}
            # an attribute the op does not take (ctx_group, lr_mult) is a
            # node attribute
            accepted = _accepted_params(opdef)
            if accepted is not None:
                node_attr.update({k: v for k, v in kwargs.items()
                                  if k not in accepted})
                kwargs = {k: v for k, v in kwargs.items() if k in accepted}
            node = SymNode(opdef, spec["name"], inputs, kwargs,
                           attr=node_attr)
        nodes.append(node)
    return Symbol([(nodes[i], oi) for i, oi, _ in data["heads"]])
