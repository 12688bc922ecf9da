"""Gluon Parameter and ParameterDict (port of
`mxnet_tpu/gluon/parameter.py`): deferred initialization, grad_req wired
into autograd through mark_variables, the aux flag of layer-mutated
states, and lr_mult / wd_mult.

One buffer per parameter, on the context it was initialized on. Not
ported yet: Constant, save/load (serialization), row_sparse data and
reset_ctx (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

from .. import autograd
from .. import initializer as init_mod
from ..base import MXNetError, torch_dtype
from ..context import current_context
from ..ndarray import NDArray


class DeferredInitializationError(MXNetError):
    pass


class Parameter:
    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._grad_req = None
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._is_aux = False
        self._data = None
        self._grad = None
        self._deferred_init = ()
        self.grad_req = grad_req if differentiable else "null"

    def __repr__(self):
        return "Parameter {name} (shape={shape}, dtype={dtype})".format(
            name=self.name, shape=self.shape, dtype=self.dtype)

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        if not self._differentiable:
            req = "null"
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == "null":
            self._grad = None
            if self._data is not None:
                self._data._grad_req = None
                self._data._grad = None
                self._data._data = self._data._data.detach()
        elif self._data is not None:
            self._init_grad()

    def _needs_shape(self):
        return self.shape is None or any(s == 0 for s in self.shape)

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        default_init = default_init or init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if self._needs_shape():
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                "Cannot initialize Parameter '%s' because it has invalid "
                "shape: %s." % (self.name, str(self.shape)))
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        ctx = ctx if ctx is not None else current_context()
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]  # one buffer; several devices are a later slice
        data = NDArray(torch.zeros(self.shape, dtype=torch_dtype(self.dtype),
                                   device=ctx.torch_device()), ctx=ctx)
        initializer = init if init is not None else (self.init or
                                                     default_init)
        initializer(init_mod.InitDesc(self.name), data)
        self._data = data
        self._deferred_init = ()
        if self._grad_req != "null":
            self._init_grad()

    def _finish_deferred_init(self, shape):
        if not self._deferred_init:
            return
        if self._needs_shape():
            inferred = list(self.shape) if self.shape else list(shape)
            for i, s in enumerate(inferred):
                if s == 0:
                    inferred[i] = shape[i]
            self.shape = tuple(inferred) if self.shape else tuple(shape)
        init, ctx, default_init = self._deferred_init
        self._finish_init(init, ctx, default_init)

    def _init_grad(self):
        self._grad = NDArray(torch.zeros_like(self._data._data.detach()),
                             ctx=self._data.context)
        autograd.mark_variables([self._data], [self._grad], self._grad_req)

    # -- accessors ----------------------------------------------------------
    def _check_initialized(self):
        if self._data is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "Parameter '%s' has not been initialized yet because "
                    "initialization was deferred. Actual initialization "
                    "happens during the first forward pass." % self.name)
            raise MXNetError(
                "Parameter '%s' has not been initialized. You should first "
                "call block.collect_params().initialize() before using it."
                % self.name)

    def data(self, ctx=None):
        self._check_initialized()
        return self._data

    def list_data(self):
        self._check_initialized()
        return [self._data]

    def grad(self, ctx=None):
        self._check_initialized()
        if self._grad is None:
            raise MXNetError(
                "Cannot get gradient array for Parameter '%s' because "
                "grad_req='null'" % self.name)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        self._check_initialized()
        return [self._data.context]

    def set_data(self, data):
        """Rebind the value (cast to the parameter's dtype and shape)."""
        value = data._data if isinstance(data, NDArray) \
            else torch.as_tensor(data)
        if self._data is None:
            # set before init (a load path) when the shape is known
            self.shape = tuple(value.shape)
            self._data = NDArray(value.detach(), ctx=current_context())
            if self._grad_req != "null":
                self._init_grad()
            return
        cur = self._data._data
        self._data._data = value.detach().to(
            device=cur.device, dtype=cur.dtype).reshape(cur.shape)

    def zero_grad(self):
        if self._grad is not None:
            self._grad._data = torch.zeros_like(self._grad._data)

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            want = torch_dtype(dtype)
            self._data._data = self._data._data.detach().to(want)
            if self._grad is not None:
                self._grad._data = self._grad._data.to(want)


class ParameterDict:
    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = {}  # ordered by insertion
        self._shared = shared

    @property
    def prefix(self):
        return self._prefix

    def __repr__(self):
        name = self._prefix + " " if self._prefix else ""
        return "{name}(\n{content}\n)".format(name=name, content="\n".join(
            "  " + repr(v) for v in self.values()))

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """The parameter `prefix + name`, made on first request; a later
        request merges a partial shape and fills unset attributes."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                setattr(param, k, v)
            elif k == "shape" and v is not None:
                v = (v,) if isinstance(v, int) else tuple(v)
                if len(v) == len(existing):
                    param.shape = tuple(a if a else b
                                        for a, b in zip(existing, v))
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params:
                if self._params[k] is not v:
                    raise MXNetError(
                        "Cannot update self with other because they have "
                        "different Parameters with the same name '%s'" % k)
            else:
                self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        default = init if init is not None else init_mod.Uniform()
        for _, v in self.items():
            v.initialize(None, ctx, default, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self.values():
            v.zero_grad()

    def setattr(self, name, value):
        for v in self.values():
            setattr(v, name, value)
