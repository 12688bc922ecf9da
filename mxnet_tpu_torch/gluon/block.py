"""Gluon Block and HybridBlock (port of `mxnet_tpu/gluon/block.py`).

Blocks name their parameters as the reference's do (`resnetv10_conv0_`,
...), so weights carry across by name. `HybridBlock.hybridize()` is
accepted and the block runs eagerly: the reference compiles the traced
forward with jax.jit; the port has no compiled path until `symbol/` is
ported (ROADMAP.md, queue 1). Not ported yet: SymbolBlock, export,
save_params/load_params and summary.
"""
from __future__ import annotations

import re
import threading

from .. import ndarray as nd_mod
from ..base import MXNetError
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

    def __call__(self, *args):
        for hook in self._forward_pre_hooks.values():
            hook(self, args)
        out = self.forward(*args)
        for hook in self._forward_hooks.values():
            hook(self, args, out)
        return out

    def forward(self, *args):
        raise NotImplementedError


def _indent(s_, num_spaces):
    lines = s_.split("\n")
    first = lines.pop(0)
    return first + ("\n" + " " * num_spaces).join([""] + lines) \
        if lines else first


class HybridBlock(Block):
    """A block written against `F` (the ndarray namespace here)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = {}

    def hybridize(self, active=True, **kwargs):
        """Accepted for parity; the block keeps running eagerly (there is
        no compiled path until `symbol/` is ported)."""
        self._active = active
        self._flags = kwargs
        super().hybridize(active, **kwargs)

    def infer_shape(self, *args):
        """Finish deferred parameter init by one forward of the inputs."""
        self.forward(*args)

    def forward(self, x, *args):
        """hybrid_forward with the ndarray namespace and the parameters'
        arrays; a first call with deferred parameters infers their shapes
        from the inputs first."""
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
