"""Optimizer updates as registered operators (port of
`mxnet_tpu/ops/optimizer_ops.py`).

The reference exposes its fused optimizer kernels as ops (sgd_update,
sgd_mom_update, mp_sgd_update, mp_sgd_mom_update, signsgd_update,
signum_update, adam_update, rmsprop_update, rmspropalex_update,
ftml_update, ftrl_update, _sparse_adagrad_update), so that frontends and
the KVStore can update without an optimizer object. Each op here is a
pure function of torch tensors returning (new weight, new states...);
the `mx.nd` wrappers (ndarray/__init__.py) write the state arguments in
place and honour `out=`, which gives the reference's call style,
`nd.sgd_mom_update(w, g, mom, out=w, lr=...)`.

The op contracts differ from the optimizer classes where the reference's
do: `adam_update` applies no bias correction (the Adam class folds it
into lr), and the preambles differ by family. `_prep` rescales, clips,
then adds wd * weight (the SGD family); `_prep_wd_first` adds wd * weight
before clipping (Adam and RMSProp). So these ops do not reuse
optimizer_rules.py.

`_sparse_adagrad_update` (alias `adagrad_update`) is its dense form: a
row whose gradient is zero keeps its weight either way, so one body
serves both storage types. The `mx.nd` wrappers take dense arrays only:
a row_sparse argument raises TypeError there, as it does in the
reference, whose ops multiply it by a float. Row-sparse gradients and
the lazy updates over their rows go through the optimizer classes
(optimizer.py).
"""
from __future__ import annotations

import torch

from .registry import register


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _prep(grad, wd, weight, rescale_grad, clip_gradient):
    """rescale, clip, then fold in weight decay: the SGD-family preamble
    (wd applied after clipping)."""
    return _clip(grad * rescale_grad, clip_gradient) + wd * weight


def _prep_wd_first(grad, wd, weight, rescale_grad, clip_gradient):
    """rescale, fold in weight decay, then clip: the Adam / RMSProp
    preamble."""
    return _clip(grad * rescale_grad + wd * weight, clip_gradient)


@register("sgd_update")
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    return weight - lr * g


@register("sgd_mom_update", num_outputs=2)
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * g
    return weight + mom, mom


@register("mp_sgd_update", num_outputs=2)
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0, lazy_update=True):
    """Multi-precision SGD: the update runs on the float32 master copy;
    the weight is its cast back."""
    g = _prep(grad.float(), wd, weight32, rescale_grad, clip_gradient)
    w32 = weight32 - lr * g
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", num_outputs=3)
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                      lazy_update=True):
    g = _prep(grad.float(), wd, weight32, rescale_grad, clip_gradient)
    mom = momentum * mom - lr * g
    w32 = weight32 + mom
    return w32.to(weight.dtype), mom, w32


@register("signsgd_update")
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    return (1 - lr * wd) * weight - lr * torch.sign(g)


@register("signum_update", num_outputs=2)
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    g = _prep(grad, wd, weight, rescale_grad, clip_gradient)
    mom = momentum * mom - (1 - momentum) * g
    return (1 - lr * wd_lh) * weight + lr * torch.sign(mom), mom


@register("adam_update", num_outputs=3)
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                lazy_update=True):
    g = _prep_wd_first(grad, wd, weight, rescale_grad, clip_gradient)
    mean = beta1 * mean + (1 - beta1) * g
    var = beta2 * var + (1 - beta2) * torch.square(g)
    return weight - lr * mean / (torch.sqrt(var) + epsilon), mean, var


def _clip_weights(w, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w


@register("rmsprop_update", num_outputs=2)
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    g = _prep_wd_first(grad, wd, weight, rescale_grad, clip_gradient)
    n = (1 - gamma1) * torch.square(g) + gamma1 * n
    w = weight - lr * g / torch.sqrt(n + epsilon)
    return _clip_weights(w, clip_weights), n


@register("rmspropalex_update", num_outputs=4)
def rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                       gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                       clip_gradient=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves 2013), the reference's rmspropalex."""
    gr = _prep_wd_first(grad, wd, weight, rescale_grad, clip_gradient)
    n = (1 - gamma1) * torch.square(gr) + gamma1 * n
    g = (1 - gamma1) * gr + gamma1 * g
    delta = gamma2 * delta - lr * gr / torch.sqrt(
        n - torch.square(g) + epsilon)
    return _clip_weights(weight + delta, clip_weights), n, g, delta


@register("ftml_update", num_outputs=4)
def ftml_update(weight, grad, d, v, z, lr=0.001, beta1=0.6, beta2=0.999,
                epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                clip_grad=-1.0):
    g = _clip(grad * rescale_grad + wd * weight, clip_grad)
    v = beta2 * v + (1 - beta2) * torch.square(g)
    d_t = (1 - beta1 ** t) / lr * (torch.sqrt(v / (1 - beta2 ** t))
                                   + epsilon)
    sigma = d_t - beta1 * d
    z = beta1 * z + (1 - beta1) * g - sigma * weight
    return -z / d_t, d_t, v, z


@register("ftrl_update", num_outputs=3)
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    g = _clip(grad * rescale_grad, clip_gradient)
    sigma = (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) / lr
    z = z + g - sigma * weight
    n = n + torch.square(g)
    w = torch.where(torch.abs(z) <= lamda1, torch.zeros_like(z),
                    -(z - torch.sign(z) * lamda1)
                    / ((beta + torch.sqrt(n)) / lr + wd))
    return w.to(weight.dtype), z, n


@register("_sparse_adagrad_update", num_outputs=2,
          aliases=("adagrad_update",))
def _sparse_adagrad_update(weight, grad, history, lr=0.01, epsilon=1e-7,
                           wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """AdaGrad, dense form (the module docstring says why one body
    serves both storage types)."""
    g = _clip(grad * rescale_grad, clip_gradient) + wd * weight
    history = history + torch.square(g)
    return weight - lr * g / (torch.sqrt(history) + epsilon), history


#: op name -> positions of the state arguments its nd wrapper writes in
#: place (the reference's ndarray/__init__.py table, with the two
#: stateless ops, which write only `out=`)
UPDATE_OP_STATES = {
    "sgd_update": (), "signsgd_update": (),
    "sgd_mom_update": (2,), "mp_sgd_update": (2,),
    "mp_sgd_mom_update": (2, 3), "signum_update": (2,),
    "adam_update": (2, 3), "rmsprop_update": (2,),
    "rmspropalex_update": (2, 3, 4), "ftml_update": (2, 3, 4),
    "ftrl_update": (2, 3), "_sparse_adagrad_update": (2,),
    "adagrad_update": (2,),
}
