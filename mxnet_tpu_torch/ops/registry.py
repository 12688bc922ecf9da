"""Operator registry (port of `mxnet_tpu/ops/registry.py`).

An op is a function of torch tensors: positional arguments are tensors,
keyword arguments are static parameters (the reference's dmlc::Parameter
structs). Gradients come from torch.autograd through the op's body, or
from a `torch.autograd.Function` where the op wraps a kernel. The
imperative namespace `mxnet_tpu_torch.ndarray` is generated from this
table, as the reference's is.
"""
from __future__ import annotations

import inspect

OPS = {}


class OpDef:
    __slots__ = ("name", "fn", "num_inputs", "num_outputs", "differentiable",
                 "aliases", "doc")

    def __init__(self, name, fn, num_inputs, num_outputs, differentiable,
                 aliases, doc):
        self.name = name
        self.fn = fn
        self.num_inputs = num_inputs  # -1 = variadic (list input)
        self.num_outputs = num_outputs
        self.differentiable = differentiable
        self.aliases = aliases
        self.doc = doc

    def __repr__(self):
        return "OpDef(%s)" % self.name


def register(name=None, *, num_outputs=1, differentiable=True, aliases=()):
    """Register an op function `fn(*tensors, **params)`."""

    def deco(fn):
        opname = name or fn.__name__
        npos = 0
        variadic = False
        for p in inspect.signature(fn).parameters.values():
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD) \
                    and p.default is p.empty:
                npos += 1
            elif p.kind == p.VAR_POSITIONAL:
                variadic = True
        od = OpDef(opname, fn, -1 if variadic else npos, num_outputs,
                   differentiable, tuple(aliases), fn.__doc__ or "")
        OPS[opname] = od
        for a in aliases:
            OPS[a] = od
        return fn

    return deco


def get(name):
    try:
        return OPS[name]
    except KeyError:
        raise KeyError("Operator '%s' is not registered" % name) from None


def list_ops():
    return sorted(set(od.name for od in OPS.values()))
