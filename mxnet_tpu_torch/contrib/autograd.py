"""The legacy contrib autograd surface (port of
`mxnet_tpu/contrib/autograd.py`): training and test sections,
`mark_variables`, `backward`, `compute_gradient`, `grad_and_loss` and
`grad`, over the port's `autograd`."""
from __future__ import annotations

from .. import autograd as _ag


def set_is_training(is_train):
    """Set training mode; returns the mode before."""
    prev = _ag.is_training()
    _ag.set_training(is_train)
    return prev


train_section = _ag.record
test_section = _ag.pause


def mark_variables(variables, gradients, grad_reqs="write"):
    return _ag.mark_variables(variables, gradients, grad_reqs)


def backward(outputs, out_grads=None, retain_graph=False):
    return _ag.backward(outputs, head_grads=out_grads,
                        retain_graph=retain_graph)


def compute_gradient(outputs):
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """A function of func's arguments returning (the gradients of func's
    output with respect to the arguments numbered `argnum`, all by
    default; func's output)."""
    def wrapped(*args):
        from ..ndarray import NDArray, zeros_like
        variables = list(args) if argnum is None else \
            [args[i] for i in ([argnum] if isinstance(argnum, int)
                               else argnum)]
        grads = [zeros_like(v) for v in variables]
        mark_variables(variables, grads)
        with train_section():
            out = func(*args)
        compute_gradient([out] if isinstance(out, NDArray) else out)
        return grads, out

    return wrapped


def grad(func, argnum=None):
    """`grad_and_loss` without the output."""
    g_and_l = grad_and_loss(func, argnum)

    def wrapped(*args):
        return g_and_l(*args)[0]

    return wrapped
