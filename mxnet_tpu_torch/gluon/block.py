"""Gluon Block, HybridBlock and SymbolBlock (port of
`mxnet_tpu/gluon/block.py`).

Blocks name their parameters as the reference's do (`resnetv10_conv0_`,
...), so weights carry across by name. A Symbol input makes
`HybridBlock.forward` trace `hybrid_forward` with the symbol namespace
and the parameters as Variables, which is what `export` writes.

`hybridize()` runs the block as one graph: the reference jit-compiles the
eager forward and its vjp; the port traces the block once with Symbol
inputs into a cached Symbol (`_build_cache`) and evaluates that graph on
each call (`_call_cached`, through `Symbol._eval`) with torch's grad mode
on while recording, so `backward` reaches the parameters as it does
eagerly. BatchNorm's moving statistics come back from the graph as aux
updates and are written into the parameters after a training forward.
The traced graph keeps the reference's export composition of ResNet's
epilogue (a BatchNorm node, then the add and the relu) where the eager
path with MXNET_FUSED_BN_EPILOGUE=1 folds them into one op; its
BatchNorm nodes reach the fused kernels all the same.
"""
from __future__ import annotations

import re
import threading

import torch

from .. import autograd
from .. import name as name_mod
from .. import ndarray as nd_mod
from .. import symbol as symbol_mod
from ..base import MXNetError, torch_dtype
from ..ndarray import NDArray
from ..symbol import Symbol
from .parameter import DeferredInitializationError, Parameter, ParameterDict


class _BlockScope:
    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        """(prefix, ParameterDict) of a new block: from the name manager's
        counters at top level, else from the enclosing block's."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                from .. import name as name_mod
                prefix = name_mod.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        from .. import name as name_mod
        self._name_scope = name_mod.Prefix(self._block.prefix)
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


class Block:
    """Base class for all layers and models."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = {}
        self._reg_params = {}
        self._forward_hooks = {}
        self._forward_pre_hooks = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = "\n".join("  ({key}): {block}".format(
            key=key, block=_indent(repr(block), 2))
            for key, block in self._children.items())
        return "{name}(\n{modstr}\n)".format(name=self.__class__.__name__,
                                             modstr=modstr)

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError("Changing attribute type for {name} from "
                                "{type1} to {type2} is not allowed.".format(
                                    name=name, type1=type(existing),
                                    type2=type(value)))
        if isinstance(value, Block):
            self.register_child(value, name)
        elif isinstance(value, Parameter):
            if name in self._reg_params and self._reg_params[name] is not \
                    value:
                raise MXNetError("Overriding Parameter attribute %s is not "
                                 "allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        """This block's and its children's parameters, optionally those
        whose names match the regular expression `select`."""
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for child in self._children.values():
            ret.update(child.collect_params(select=select))
        return ret

    def register_child(self, block, name=None):
        if name is None:
            name = str(len(self._children))
        self._children[name] = block

    def register_forward_hook(self, hook):
        handle = len(self._forward_hooks)
        self._forward_hooks[handle] = hook
        return handle

    def register_forward_pre_hook(self, hook):
        handle = len(self._forward_pre_hooks)
        self._forward_pre_hooks[handle] = hook
        return handle

    def apply(self, fn):
        for child in self._children.values():
            child.apply(fn)
        fn(self)
        return self

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children.values():
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    # -- persistence ---------------------------------------------------------
    def save_params(self, filename):
        """Write the parameters, names stripped of this block's prefix
        (the reference's container, so either package loads the file)."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    save_parameters = save_params

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, self.prefix)

    load_parameters = load_params

    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Print each layer's output shapes and parameter count for one
        forward of `inputs`; returns the total parameter count."""
        from ..visualization import block_summary
        return block_summary(self, *inputs)


def _indent(s_, num_spaces):
    lines = s_.split("\n")
    first = lines.pop(0)
    return first + ("\n" + " " * num_spaces).join([""] + lines) \
        if lines else first


class HybridBlock(Block):
    """A block written against `F`: the ndarray namespace eagerly, the
    symbol namespace when traced (by `export`, `hybridize` or a Symbol
    input)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}
        self._cached_graph = None

    def hybridize(self, active=True, **kwargs):
        """Run this block (and every child) as one traced graph from the
        next call on; `hybridize(False)` goes back to eager calls."""
        self._active = active
        self._flags = kwargs
        self._cached_graph = None
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._cached_graph = None
        super().cast(dtype)

    def infer_shape(self, *args):
        """Finish deferred parameter init by one forward of the inputs."""
        self.forward(*args)

    def infer_type(self, *args):
        """Finish deferred init from the inputs (probed in float32, the
        parameters' dtype), then cast the floating parameters to the
        inputs' floating dtype when they share one (the reference's
        rule)."""
        self.infer_shape(*[a.astype("float32") if isinstance(a, NDArray)
                           and torch_dtype(a.dtype).is_floating_point
                           else a for a in args])
        floats = {a.dtype for a in args if isinstance(a, NDArray)
                  and torch_dtype(a.dtype).is_floating_point}
        if len(floats) == 1:
            want = next(iter(floats))
            for p in self.collect_params().values():
                if p._data is not None and \
                        p._data._data.is_floating_point() and \
                        p._data._data.dtype != torch_dtype(want):
                    p.cast(want)

    def forward(self, x, *args):
        """hybrid_forward with the ndarray namespace and the parameters'
        arrays; a first call with deferred parameters infers their shapes
        from the inputs first. A Symbol input traces the block instead:
        hybrid_forward with the symbol namespace and the parameters as
        Variables."""
        if isinstance(x, Symbol):
            return self.hybrid_forward(symbol_mod, x, *args,
                                       **self._trace_param_symbols())
        try:
            params = {name: p.data() for name, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred_init(x, *args)
            params = {name: p.data() for name, p in self._reg_params.items()}
        return self.hybrid_forward(nd_mod, x, *args, **params)

    def _finish_deferred_init(self, *args):
        self._shape_probe(*args)
        for p in self._reg_params.values():
            if p._deferred_init:
                raise DeferredInitializationError(
                    "Could not infer shape for %s" % p.name)

    def _shape_probe(self, x, *args):
        # layers with parameters override this with their shape rule
        raise DeferredInitializationError(
            "%s has uninitialized parameters and no shape rule" % self.name)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _trace_param_symbols(self):
        """This block's parameters as Variables for a trace: a shape hint
        only when the shape is fully known (a deferred shape holds 0s and
        leaves bind-time inference in charge), the aux flag on
        layer-mutated states."""
        params = {}
        for name, p in self._reg_params.items():
            shape = p.shape if p.shape and all(d > 0 for d in p.shape) \
                else None
            make = symbol_mod.aux_variable if p._is_aux \
                else symbol_mod.Variable
            params[name] = make(p.name, shape=shape)
        return params

    # -- the cached graph ----------------------------------------------------
    def __call__(self, *args):
        if self._active and args and not isinstance(args[0], Symbol):
            try:
                return self._call_cached(*args)
            except DeferredInitializationError:
                # a first call with deferred parameters runs eagerly once
                return super().__call__(*args)
        return super().__call__(*args)

    def _build_cache(self, fmt, n_in):
        """Trace the block once with `n_in` Variable inputs laid out as
        `fmt` into the cached graph: (Symbol, input names, output layout, {variable
        name: Parameter}). A parameter still deferred raises
        DeferredInitializationError, which sends the call down the eager
        path."""
        params = self.collect_params()
        for p in params.values():
            if p._data is None:
                raise DeferredInitializationError(
                    "hybridize: parameter %s is not initialized" % p.name)
        names = ["data"] if n_in == 1 else ["data%d" % i
                                            for i in range(n_in)]
        # a fresh NameManager: the trace's op names must not move the
        # counters that name the caller's next blocks
        with name_mod.NameManager():
            ins = _regroup(iter(symbol_mod.Variable(n) for n in names), fmt)
            out = self(*ins)
        flat_out, out_fmt = _flatten(out, Symbol)
        graph = symbol_mod.Group(flat_out)
        by_name = {p.name: p for p in params.values()}
        return graph, names, out_fmt, by_name

    def _call_cached(self, *args):
        """Evaluate the cached graph on the inputs: torch's grad mode
        follows autograd.record() so gradients reach the parameters,
        the mode (training or not) follows autograd.is_training(), and a
        training forward writes BatchNorm's moving statistics back."""
        flat, fmt = _flatten(args, NDArray)
        if self._cached_graph is None or self._cached_graph[0] != fmt:
            self._cached_graph = (fmt, self._build_cache(fmt, len(flat)))
        graph, names, out_fmt, by_name = self._cached_graph[1]
        values = {n: a._data for n, a in zip(names, flat)}
        for n, p in by_name.items():
            values[n] = p.data()._data
        outs, aux = _run_graph(graph, values, autograd.is_training())
        for n, v in aux.items():
            by_name[n].set_data(v)
        ctx = flat[0].context if flat else None
        return _regroup(iter(NDArray(o, ctx=ctx) for o in outs), out_fmt)

    def export(self, path, epoch=0, inputs=("data",)):
        """Write `path-symbol.json` and `path-%04d.params` (parameters
        under 'arg:' / 'aux:' keys with their own names), so
        `model.load_checkpoint` with Module, or `SymbolBlock.imports`,
        load the model. The graph is this block traced with one Variable
        an input (`inputs` names them, for blocks of several inputs);
        hybridize is inactive while it traces, across the tree, since a
        Symbol input never takes a cached graph (`__call__`)."""
        from ..utils import serialization
        if isinstance(inputs, str):
            inputs = (inputs,)
        try:
            out = self(*[symbol_mod.Variable(n) for n in inputs])
        except TypeError as e:
            raise TypeError(
                "export could not trace %s with inputs %s; pass the "
                "block's input names as export(..., inputs=(...)): %s"
                % (self.name, list(inputs), e)) from None
        if isinstance(out, (list, tuple)):
            out = symbol_mod.Group(_flatten(out, Symbol)[0])
        out.save("%s-symbol.json" % path)
        save_dict = {}
        for name, p in self.collect_params().items():
            save_dict["%s:%s" % ("aux" if p._is_aux else "arg", name)] = \
                p.data()
        serialization.save_ndarrays("%s-%04d.params" % (path, epoch),
                                    save_dict)


def _flatten(obj, leaf):
    """(the `leaf` instances of a nest of lists and tuples, in order; its
    layout)."""
    if isinstance(obj, leaf):
        return [obj], 0
    if not isinstance(obj, (list, tuple)):
        raise TypeError("a hybridized block takes and returns %ss and lists "
                        "or tuples of them, not %s"
                        % (leaf.__name__, type(obj).__name__))
    flat, fmts = [], []
    for o in obj:
        f, fm = _flatten(o, leaf)
        flat += f
        fmts.append(fm)
    return flat, (type(obj), tuple(fmts))


def _regroup(leaves, fmt):
    """The nest of layout `fmt` over the iterator `leaves`."""
    if fmt == 0:
        return next(leaves)
    return fmt[0](_regroup(leaves, f) for f in fmt[1])


def _run_graph(graph, values, train):
    """(outputs, aux updates) of `graph` on {name: tensor}, torch's grad
    mode on while autograd records; begin states the values lack are
    zeros (aux variables an op fills at its data's shape)."""
    grad = autograd.is_recording()
    if grad == torch.is_grad_enabled():
        return graph._eval(values, train=train, zero_missing_aux=True)
    with torch.set_grad_enabled(grad):
        return graph._eval(values, train=train, zero_missing_aux=True)


class SymbolBlock(HybridBlock):
    """A Symbol with its parameters as a Block (parity: reference
    gluon/block.py SymbolBlock). The symbol's arguments other than the
    inputs, and its aux states, become this block's parameters, named
    with its prefix; shapes left open are inferred from the first
    inputs."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        if isinstance(outputs, (list, tuple)):
            outputs = symbol_mod.Group(outputs)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._symbol = outputs
        self._input_names = [i.name for i in inputs]
        aux_names = outputs.list_auxiliary_states()
        self._sym_name_of = {}
        for name in outputs.list_arguments() + aux_names:
            if name not in self._input_names:
                p = self.params.get(name, allow_deferred_init=True,
                                    grad_req="null" if name in aux_names
                                    else "write")
                p._is_aux = name in aux_names
                self._sym_name_of[p.name] = name
        self._param_of_sym = {s: p for p, s in self._sym_name_of.items()}
        self._n_out = len(outputs.list_outputs())

    def forward(self, *args):
        if len(args) != len(self._input_names):
            raise MXNetError(
                "SymbolBlock expects %d inputs (%s), got %d"
                % (len(self._input_names), self._input_names, len(args)))
        if any(p._data is None and p._deferred_init
               for p in self.params.values()):
            self._finish_symbol_deferred_init(args)
        arrays = [a if isinstance(a, NDArray) else NDArray(a) for a in args]
        values = {n: a._data for n, a in zip(self._input_names, arrays)}
        for pname, p in self.params.items():
            if p._data is not None:
                values[self._sym_name_of.get(pname, pname)] = p.data()._data
        outs, aux = _run_graph(self._symbol, values, autograd.is_training())
        for sname, v in aux.items():
            pname = self._param_of_sym.get(sname)
            if pname in self.params:
                self.params[pname].set_data(v)
        outs = [NDArray(o, ctx=arrays[0].context) for o in outs]
        return outs[0] if self._n_out == 1 else outs

    def _call_cached(self, *args):
        # the symbol is the graph already
        return Block.__call__(self, *args)

    def _finish_symbol_deferred_init(self, args):
        """Deferred parameter shapes from the symbol's shape inference
        over the input shapes."""
        in_shapes = {n: a.shape for n, a in zip(self._input_names, args)}
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**in_shapes)
        shape_of = dict(zip(self._symbol.list_arguments(), arg_shapes))
        shape_of.update(zip(self._symbol.list_auxiliary_states(),
                            aux_shapes))
        for pname, p in self.params.items():
            sname = self._sym_name_of.get(pname, pname)
            if p._data is None and p._deferred_init and \
                    shape_of.get(sname) is not None:
                p._finish_deferred_init(shape_of[sname])

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of a saved symbol and, optionally, its parameters
        (keys 'arg:' / 'aux:'-prefixed, as export and Module write them,
        or plain names), placed on `ctx` when given."""
        s = symbol_mod.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        block = SymbolBlock(s, [symbol_mod.Variable(n) for n in input_names])
        if param_file:
            from ..utils import serialization
            if isinstance(ctx, (list, tuple)):
                ctx = ctx[0]
            raw = serialization.load_ndarrays(param_file, ctx=ctx)
            params = block.collect_params()
            for key, arr in raw.items():
                pname = block._param_of_sym.get(key.split(":", 1)[-1])
                if pname is not None and pname in params:
                    params[pname].set_data(arr)
        return block
