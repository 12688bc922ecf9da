"""Executor: a bound symbolic graph (port of `mxnet_tpu/executor.py`).

The reference compiles the graph's interpreter with jax.jit and, in
`backward`, traces it again under jax.vjp. Here the graph runs eagerly on
torch tensors, and torch.autograd is the backward: a training `forward`
evaluates each node once with grad mode on, from leaves made of the
arguments whose grad_req is not "null", and keeps that autograd graph;
`backward` runs `torch.autograd.grad` over it with the head gradients
(ones by default) and writes or adds the results into `grad_dict` by
grad_req. So a training step evaluates each node once forward and once
backward, and a dropout mask is never replayed. A `backward` without a
kept graph (after an inference forward, or a second backward) evaluates
the graph again in training mode first, as the reference's re-trace does,
leaving the aux states alone. An inference `forward` runs under
`torch.no_grad()`. BatchNorm's moving statistics are updated
functionally after a training forward (Symbol._eval). Creation nodes
(`sym.zeros`, ...) make their tensors on the executor's device. `bind`
shares the caller's argument and aux arrays, as the reference's does;
an array on another device than the executor's (a host batch from an
iterator, say) is copied to the executor's device into an array of the
executor's own, where the reference's runtime places it itself.
"""
from __future__ import annotations

import torch

from .base import MXNetError, torch_dtype
from .context import current_context
from .ndarray import NDArray


def _grad_req_map(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    return {n: grad_req.get(n, "null") for n in arg_names}


class Executor:
    def __init__(self, symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        self._symbol = symbol
        self._ctx = ctx or current_context()
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, dict):
            missing = [n for n in arg_names if n not in args]
            if missing:
                raise MXNetError("bind missing arguments: %s" % missing)
            self.arg_dict = {n: args[n] for n in arg_names}
        else:
            args = list(args or [])
            if len(args) != len(arg_names):
                raise MXNetError("bind expects %d args, got %d"
                                 % (len(arg_names), len(args)))
            self.arg_dict = dict(zip(arg_names, args))
        aux_states = aux_states if aux_states is not None else []
        if isinstance(aux_states, dict):
            self.aux_dict = {n: aux_states[n] for n in aux_names}
        else:
            self.aux_dict = dict(zip(aux_names, aux_states))
        dev = self._ctx.torch_device()
        for d in (self.arg_dict, self.aux_dict):
            for n, a in d.items():
                if isinstance(a, NDArray) and a._data.device != dev:
                    d[n] = NDArray(a._data.detach().to(dev), ctx=self._ctx)
        self._grad_req = _grad_req_map(grad_req, arg_names)
        for n, req in self._grad_req.items():
            if req not in ("write", "add", "null"):
                raise MXNetError("grad_req of %s must be write, add or null, "
                                 "got %r" % (n, req))
        if args_grad is None:
            self.grad_dict = {}
        elif isinstance(args_grad, dict):
            self.grad_dict = dict(args_grad)
        else:
            self.grad_dict = dict(zip(arg_names, args_grad))
        self._arg_names = arg_names
        self._aux_names = aux_names
        self._grad_names = [n for n in arg_names
                            if self._grad_req.get(n, "null") != "null"]
        self.outputs = []
        self._graph = None      # (output tensors, {name: leaf}) to backward
        self._monitor_callback = None
        # creation nodes with a 0 in their shape (an RNN cell's begin
        # state, `sym.zeros((L, 0, H))`): the dim solved once per set of
        # argument shapes
        self._deferred = symbol._has_deferred()
        self._batches = {}

    # -- the surface --------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def set_monitor_callback(self, callback, monitor_all=False):
        """callback(output name, NDArray) after each forward."""
        self._monitor_callback = callback

    def debug_str(self):
        """The bound graph, one line a node."""
        lines = ["Symbol outputs: %s" % ", ".join(
            self._symbol.list_outputs())]
        for node in self._symbol._topo():
            if node.op is None:
                arr = self.arg_dict.get(node.name,
                                        self.aux_dict.get(node.name))
                lines.append("  var %s%s %s" % (
                    node.name, " (aux)" if node.is_aux else "",
                    "x".join(str(d) for d in arr.shape) if arr is not None
                    else "?"))
            else:
                lines.append("  %s %s(%s)" % (
                    node.name, node.op.name,
                    ", ".join(n.name for n, _ in node.inputs)))
        return "\n".join(lines)

    # -- compute ------------------------------------------------------------
    def _run(self, train, grad):
        """Evaluate the graph: (output tensors, aux updates, leaves)."""
        values = {n: a._data for n, a in self.arg_dict.items()}
        leaves = {}
        if grad:
            for n in self._grad_names:
                leaves[n] = values[n] = \
                    values[n].detach().requires_grad_(True)
        values.update({n: a._data for n, a in self.aux_dict.items()})
        batch = None
        if self._deferred:
            shapes = {n: tuple(v.shape) for n, v in values.items()}
            key = tuple(sorted(shapes.items()))
            if key not in self._batches:
                self._batches[key] = self._symbol._deferred_batch(shapes)
            batch = self._batches[key]
        with torch.set_grad_enabled(grad):
            outs, aux_up = self._symbol._eval(
                values, train=train, device=self._ctx.torch_device(),
                batch=batch)
        return outs, aux_up, leaves

    def forward(self, is_train=False, **kwargs):
        """Run the graph; `kwargs` feed arguments by name first (copied to
        the argument's device and dtype)."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown forward argument %s" % k)
            dst = self.arg_dict[k]
            t = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
            dst._data = t.detach().to(device=dst._data.device,
                                      dtype=dst._data.dtype)
        grad = bool(is_train) and bool(self._grad_names)
        outs, aux_up, leaves = self._run(bool(is_train), grad)
        for n, v in aux_up.items():
            self.aux_dict[n]._data = v
        self._graph = (outs, leaves) if grad else None
        self.outputs = [NDArray(o.detach(), ctx=self._ctx) for o in outs]
        if self._monitor_callback is not None:
            for name, out in zip(self._symbol.list_outputs(), self.outputs):
                self._monitor_callback(name, out)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs (head gradients `out_grads`, ones by
        default) into grad_dict, by each argument's grad_req."""
        if not self._grad_names:
            return
        graph, self._graph = self._graph, None
        if graph is None:
            outs, _, leaves = self._run(True, True)
        else:
            outs, leaves = graph
        if out_grads is None:
            heads = [None] * len(outs)
        else:
            heads = [out_grads] if isinstance(out_grads, NDArray) \
                else list(out_grads)
        tensors, grads = [], []
        for o, g in zip(outs, heads):
            if not o.requires_grad:
                continue
            tensors.append(o)
            grads.append(torch.ones_like(o) if g is None else
                         g._data.to(device=o.device, dtype=o.dtype))
        names = list(leaves)
        got = torch.autograd.grad(tensors, [leaves[n] for n in names],
                                  grads, allow_unused=True) \
            if tensors else [None] * len(names)
        for n, g in zip(names, got):
            # an argument the outputs do not reach gets a zero gradient
            g = torch.zeros_like(leaves[n]) if g is None else g.detach()
            tgt = self.grad_dict.get(n)
            if tgt is None:
                tgt = self.grad_dict[n] = NDArray(torch.zeros_like(g),
                                                  ctx=self._ctx)
            if self._grad_req[n] == "add":
                tgt._data = tgt._data + g
            else:
                tgt._data = g

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for src, dst, what in ((arg_params, self.arg_dict, "parameter"),
                               (aux_params or {}, self.aux_dict,
                                "aux state")):
            for n, v in src.items():
                if n in dst:
                    dst[n]._data = v._data.detach().to(
                        device=dst[n]._data.device,
                        dtype=dst[n]._data.dtype).clone()
                elif not allow_extra_params:
                    raise MXNetError("unknown %s %s" % (what, n))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor whose named arguments take the given shapes
        (zeros); the others, the grads and the aux states are shared."""
        new_args = {}
        for n, a in self.arg_dict.items():
            new_args[n] = NDArray(torch.zeros(
                kwargs[n], dtype=a._data.dtype, device=a._data.device),
                ctx=self._ctx) if n in kwargs else a
        return Executor(self._symbol, self._ctx, new_args,
                        self.grad_dict or None, self._grad_req,
                        self.aux_dict)

    @staticmethod
    def simple_bind(symbol, ctx=None, grad_req="write", type_dict=None,
                    **shapes):
        """Infer every shape from the given ones, allocate the argument,
        gradient and aux arrays on ctx's device, and bind."""
        ctx = ctx or current_context()
        dev = ctx.torch_device()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
        arg_names = symbol.list_arguments()
        type_dict = type_dict or {}
        args = {}
        for n, s in zip(arg_names, arg_shapes):
            if s is None:
                raise MXNetError("simple_bind could not infer shape of %s" % n)
            args[n] = NDArray(torch.zeros(
                s, dtype=torch_dtype(type_dict.get(n, "float32")),
                device=dev), ctx=ctx)
        aux = {}
        for n, s in zip(symbol.list_auxiliary_states(), aux_shapes):
            fill = torch.ones if n.endswith("_var") else torch.zeros
            aux[n] = NDArray(fill(s, device=dev), ctx=ctx)
        req = _grad_req_map(grad_req, arg_names)
        grads = {n: NDArray(torch.zeros_like(args[n]._data), ctx=ctx)
                 for n in arg_names if req.get(n) != "null"}
        return Executor(symbol, ctx, args, grads, req, aux)
