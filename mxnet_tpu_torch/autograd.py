"""Imperative autograd: record/pause scopes, mark_variables, backward and
grad (port of `mxnet_tpu/autograd.py`).

The reference records each op on a tape of its own and runs jax.vjp per
node in backward. Here torch's graph is the tape: an op applied while
recording runs with torch's grad mode on (ndarray/ndarray.py
`_apply_op`), so its result carries torch's graph back to the leaves that
`attach_grad` / `mark_variables` made; outside a record scope ops run
with grad mode off and build no graph. `backward` differentiates the
heads with respect to every live marked variable through
`torch.autograd.grad` and writes or adds the results into their grad
buffers by grad_req, as the reference's tape walk does.

Not ported yet: the custom `Function` class and `get_symbol`.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError


class _Scope(threading.local):
    def __init__(self):
        super().__init__()
        self.recording = False
        self.training = False


_SCOPE = _Scope()
#: the live NDArrays marked by attach_grad / mark_variables
_VARIABLES = weakref.WeakSet()


def is_recording():
    return _SCOPE.recording


def is_training():
    return _SCOPE.training


def set_recording(is_record):
    prev = _SCOPE.recording
    _SCOPE.recording = bool(is_record)
    return prev


def set_training(train_mode):
    prev = _SCOPE.training
    _SCOPE.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    """Set (recording, training) for a scope; None leaves one as it is."""

    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, *exc):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Scope whose ops build the graph that `backward` differentiates."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Make each variable a leaf of the graph with `gradients` as its grad
    buffer (parity: autograd.mark_variables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null, got %r"
                             % (req,))
        var._grad = grad
        var._grad_req = req
        var._data = var._data.detach()
        _VARIABLES.add(var)


def _head_grads(heads, head_grads):
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    tensors = [h._data for h in heads]
    if not any(t.requires_grad for t in tensors):
        raise MXNetError("cannot differentiate: outputs are not on the tape "
                         "(call inside autograd.record())")
    grads = [torch.ones_like(t) if g is None else g._data.to(t.dtype)
             for t, g in zip(tensors, head_grads)]
    return tensors, grads


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Differentiate `heads` into the grad buffers of the marked variables
    they depend on, by each one's grad_req (parity: autograd.backward).
    `train_mode` is accepted for parity: torch's backward replays no
    forward op, so no op sees it."""
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    tensors, grads = _head_grads(heads, head_grads)
    variables = [v for v in list(_VARIABLES)
                 if v._grad_req != "null" and v._grad is not None
                 and v._data.requires_grad]
    if not variables:
        return
    got = torch.autograd.grad(tensors, [v._data for v in variables], grads,
                              retain_graph=retain_graph, allow_unused=True)
    for v, g in zip(variables, got):
        if g is None:
            continue  # not reached from the heads: the buffer keeps its value
        g = g.detach().to(v._grad._data.dtype).reshape(v._grad.shape)
        if v._grad_req == "add":
            v._grad._data = v._grad._data + g
        else:
            v._grad._data = g


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of heads with respect to variables, as new NDArrays
    (parity: autograd.grad); the variables' grad buffers are untouched."""
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if isinstance(variables, NDArray):
        variables = [variables]
    tensors, grads = _head_grads(heads, head_grads)
    got = torch.autograd.grad(
        tensors, [v._data for v in variables], grads,
        retain_graph=create_graph if retain_graph is None else retain_graph,
        create_graph=create_graph, allow_unused=True)
    return [NDArray(torch.zeros_like(v._data) if g is None else g,
                    ctx=v.context) for v, g in zip(variables, got)]
