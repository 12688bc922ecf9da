"""Device contexts (port of `mxnet_tpu/context.py`).

A Context names a torch device. Two things differ from the reference on
purpose: `gpu(i)` is CUDA device i and raises without CUDA (the reference
falls back to the CPU, `context.py:44-51`), and the default context is
`gpu(0)` (the reference's is `cpu(0)`, `context.py:86`), so the port's
entry points run on the card unless the caller enters `with mx.cpu():` or
passes `ctx=mx.cpu()`, as the CPU tests do.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError, resolve_device


class Context:
    """A device context: 'cpu' or 'gpu' (a CUDA device)."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError("unknown device type %r (the port has cpu "
                                 "and gpu)" % (device_type,))
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return Context.devtype2str[self.device_typeid]

    def torch_device(self):
        """The torch.device; a gpu context raises without CUDA."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        return resolve_device("cuda:%d" % self.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = current_context()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx


def context_of(device):
    """The Context of a torch.device."""
    if device.type == "cuda":
        return Context("gpu", device.index or 0)
    return Context("cpu", 0)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    """CUDA device `device_id`; raises when there is no CUDA device."""
    ctx = Context("gpu", device_id)
    ctx.torch_device()
    return ctx


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The innermost `with ctx:` context, else gpu(0)."""
    if not hasattr(Context._default_ctx, "value"):
        Context._default_ctx.value = Context("gpu", 0)
    return Context._default_ctx.value
