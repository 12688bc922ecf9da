"""Contrib containers (port of `mxnet_tpu/gluon/contrib/nn.py`):
Concurrent, HybridConcurrent and Identity.

HybridConcurrent concatenates through `hybrid_forward`, with the `F` its
caller gives, so a hybridized one traces into one Concat node of the
graph (the reference overrides `forward` with `nd.Concat`, which its jit
traces; the port's trace runs on Symbols, which `nd.Concat` does not
take)."""
from __future__ import annotations

from ..block import HybridBlock
from ..nn.basic_layers import Sequential, HybridSequential


class Concurrent(Sequential):
    """Runs every child on the same input and concatenates their outputs
    along `axis`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        from ... import ndarray as F
        out = [block(x) for block in self._children.values()]
        return F.Concat(*out, dim=self.axis)


class HybridConcurrent(HybridSequential):
    """Concurrent as a HybridBlock."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    forward = HybridBlock.forward

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.Concat(*out, dim=self.axis)


class Identity(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def hybrid_forward(self, F, x):
        return x
