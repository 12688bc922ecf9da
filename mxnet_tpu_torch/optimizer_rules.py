"""Pure optimizer update rules (port of `mxnet_tpu/optimizer_rules.py`):
one implementation per optimizer, shared by the eager optimizer classes
(optimizer.py) and the fused TrainStep (parallel/trainer.py).

Signatures, as the reference's:
    init(w, h)                                 -> tuple of state tensors
    apply(w, g, state, lr, wd, t, h, key=None) -> (new_w, new_state)

`g` arrives with rescale and clipping applied but not weight decay; each
rule applies wd the way its reference class does. `t` is the 1-based
update count and `h` a dict of static hyper-parameters.

Where the reference's semantics differ from upstream MXNet, the port
keeps the reference's:
- Nadam's m_schedule is per-parameter state (the third entry of its
  state), where upstream keeps one Python float shared by every
  parameter;
- LBSGD's warm-up reads the optimizer's global update count
  (optimizer.py passes it as `t`), as the reference's class does.

SGLD is the one stochastic rule (`STOCHASTIC`). Its `key` is a
`torch.Generator` where the reference's is a PRNG key: the reference
folds the parameter's index into a per-step key, which has no torch
counterpart, so the port draws each parameter's noise from the
generator of the parameter's device (`mxnet_tpu_torch.random`), in
parameter order. The eager and the fused paths then draw the same noise
when the generators are seeded alike.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

#: the group a rule's whole-tensor norms sum over while it updates one
#: shard of a tensor (TrainStep's sharded update), or None
_NORM_AXIS = contextvars.ContextVar("mxnet_tpu_torch_norm_axis",
                                    default=None)


@contextlib.contextmanager
def sharded_norms(ax):
    """Inside the block a rule's whole-tensor norm of a shard is the norm
    of the whole tensor: its squared partials summed over `ax` (a
    `parallel.collectives` axis group; None changes nothing)."""
    token = _NORM_AXIS.set(ax)
    try:
        yield
    finally:
        _NORM_AXIS.reset(token)


def _tensor_norm(t):
    """||t|| over the whole tensor, whichever shard of it t is."""
    ax = _NORM_AXIS.get()
    if ax is None:
        return torch.linalg.norm(t)
    from .parallel.collectives import all_reduce_raw
    return torch.sqrt(all_reduce_raw(torch.sum(torch.square(t)), ax))


def _zeros(w):
    return torch.zeros_like(w)


def _sqrt(v):
    """math.sqrt of a number; torch.sqrt of a 0-d tensor, which is what a
    traced step's lr and t are (predict.export_train_step)."""
    return torch.sqrt(v) if isinstance(v, torch.Tensor) else math.sqrt(v)


def _sgd_init(w, h):
    return (_zeros(w),) if h.get("momentum", 0.0) else ()


def _sgd_apply(w, g, state, lr, wd, t, h, key=None):
    """MXNet's order: g += wd * w; m = momentum * m - lr * g; w += m."""
    g = g + wd * w
    if state:
        m = h["momentum"] * state[0] - lr * g
        return w + m, (m,)
    return w - lr * g, state


def _signum_init(w, h):
    return (_zeros(w),) if h.get("momentum", 0.0) else ()


def _signum_apply(w, g, state, lr, wd, t, h, key=None):
    wd_lh = h.get("wd_lh", 0.0)
    if state:
        m = h["momentum"] * state[0] - (1 - h["momentum"]) * (g + wd * w)
        return (1 - lr * wd_lh) * w + lr * torch.sign(m), (m,)
    return (1 - lr * (wd + wd_lh)) * w - lr * torch.sign(g), state


def _ftml_init(w, h):
    return (_zeros(w), _zeros(w), _zeros(w))  # d, v, z


def _ftml_apply(w, g, state, lr, wd, t, h, key=None):
    b1, b2, eps = h.get("beta1", 0.6), h.get("beta2", 0.999), \
        h.get("epsilon", 1e-8)
    g = g + wd * w
    d, v, z = state
    v_t = b2 * v + (1 - b2) * torch.square(g)
    d_t = (1 - b1 ** t) / lr * (torch.sqrt(v_t / (1 - b2 ** t)) + eps)
    sigma_t = d_t - b1 * d
    z_t = b1 * z + (1 - b1) * g - sigma_t * w
    return -z_t / d_t, (d_t, v_t, z_t)


def _lbsgd_init(w, h):
    return (_zeros(w),)


def _lbsgd_apply(w, g, state, lr, wd, t, h, key=None):
    """Linear warm-up over warmup_epochs x updates_per_epoch updates of
    the global count `t`, then the LARS-style layer-wise scale."""
    warm_steps = h.get("warmup_epochs", 5) * h.get("updates_per_epoch", 32)
    lr = lr * min(t / max(1, warm_steps), 1.0)
    wnorm = _tensor_norm(w)
    gnorm = _tensor_norm(g)
    phi = torch.where((wnorm > 0) & (gnorm > 0),
                      wnorm / (gnorm + wd * wnorm + 1e-12),
                      torch.ones_like(wnorm))
    g = g + wd * w
    m = h.get("momentum", 0.0) * state[0] - lr * phi * g
    return w + m, (m,)


def _dcasgd_init(w, h):
    mom = (_zeros(w),) if h.get("momentum", 0.0) else ()
    return mom + (w.clone(),)  # (momentum?, previous weight)


def _dcasgd_apply(w, g, state, lr, wd, t, h, key=None):
    lamda = h.get("lamda", 0.04)
    prev = state[-1]
    comp = g + wd * w + lamda * g * g * (w - prev)
    if len(state) == 2:
        m = h["momentum"] * state[0] - lr * comp
        return w + m, (m, w)
    return w - lr * comp, (w,)


def _nag_init(w, h):
    return (_zeros(w),) if h.get("momentum", 0.0) else ()


def _nag_apply(w, g, state, lr, wd, t, h, key=None):
    g = g + wd * w
    if state:
        m = h["momentum"] * state[0] + g
        return w - lr * (g + h["momentum"] * m), (m,)
    return w - lr * g, state


def _sgld_init(w, h):
    return ()


def _sgld_apply(w, g, state, lr, wd, t, h, key=None):
    """Langevin step: w - lr/2 (g + wd w) + N(0, lr). `key` is the
    torch.Generator to draw from (the device generator of w when None)."""
    if key is None:
        from . import random as _random
        key = _random.generator(w.device)
    g = g + wd * w
    noise = torch.randn(w.shape, generator=key, dtype=w.dtype,
                        device=w.device) * _sqrt(lr)
    return w - lr / 2 * g + noise, state


def _adam_init(w, h):
    return (_zeros(w), _zeros(w))  # mean, var


def _adam_apply(w, g, state, lr, wd, t, h, key=None):
    """m, v moving averages; the bias correction folded into the step
    size, as the reference's rule does."""
    b1, b2, eps = h.get("beta1", 0.9), h.get("beta2", 0.999), \
        h.get("epsilon", 1e-8)
    g = g + wd * w
    m, v = state
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    lr_t = lr * _sqrt(1 - b2 ** t) / (1 - b1 ** t)
    return w - lr_t * m / (torch.sqrt(v) + eps), (m, v)


def _adagrad_init(w, h):
    return (_zeros(w),)


def _adagrad_apply(w, g, state, lr, wd, t, h, key=None):
    eps = h.get("eps", 1e-7)
    g = g + wd * w
    n = state[0] + torch.square(g)
    return w - lr * g / torch.sqrt(n + eps), (n,)


def _rmsprop_init(w, h):
    if h.get("centered", False):
        return (_zeros(w), _zeros(w), _zeros(w))  # n, g_bar, delta
    return (_zeros(w),)


def _rmsprop_apply(w, g, state, lr, wd, t, h, key=None):
    """Tieleman's RMSProp, or Graves's centered form; the new weight
    clipped to [-clip_weights, clip_weights] when that is set."""
    g1, g2 = h.get("gamma1", 0.9), h.get("gamma2", 0.9)
    eps = h.get("epsilon", 1e-8)
    clip_w = h.get("clip_weights", None)
    g = g + wd * w
    if h.get("centered", False):
        n, gbar, delta = state
        n = (1 - g1) * torch.square(g) + g1 * n
        gbar = (1 - g1) * g + g1 * gbar
        delta = g2 * delta - lr * g / torch.sqrt(
            n - torch.square(gbar) + eps)
        new_w, new_state = w + delta, (n, gbar, delta)
    else:
        n = (1 - g1) * torch.square(g) + g1 * state[0]
        new_w, new_state = w - lr * g / torch.sqrt(n + eps), (n,)
    if clip_w:
        new_w = torch.clamp(new_w, -clip_w, clip_w)
    return new_w, new_state


def _adadelta_init(w, h):
    return (_zeros(w), _zeros(w))  # acc_g, acc_delta


def _adadelta_apply(w, g, state, lr, wd, t, h, key=None):
    rho, eps = h.get("rho", 0.90), h.get("epsilon", 1e-5)
    g = g + wd * w
    acc_g, acc_d = state
    acc_g = rho * acc_g + (1 - rho) * torch.square(g)
    delta = torch.sqrt(acc_d + eps) / torch.sqrt(acc_g + eps) * g
    acc_d = rho * acc_d + (1 - rho) * torch.square(delta)
    return w - delta, (acc_g, acc_d)


def _ftrl_init(w, h):
    return (_zeros(w), _zeros(w))  # z, n


def _ftrl_apply(w, g, state, lr, wd, t, h, key=None):
    lamda1, beta = h.get("lamda1", 0.01), h.get("beta", 1)
    z, n = state
    sigma = (torch.sqrt(n + torch.square(g)) - torch.sqrt(n)) / lr
    z = z + g - sigma * w
    n = n + torch.square(g)
    new_w = torch.where(
        torch.abs(z) <= lamda1, torch.zeros_like(z),
        -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(n)) / lr + wd))
    return new_w, (z, n)


def _adamax_init(w, h):
    return (_zeros(w), _zeros(w))  # m, u


def _adamax_apply(w, g, state, lr, wd, t, h, key=None):
    b1, b2 = h.get("beta1", 0.9), h.get("beta2", 0.999)
    lr = lr / (1.0 - b1 ** t)
    g = g + wd * w
    m, u = state
    m = b1 * m + (1 - b1) * g
    u = torch.maximum(b2 * u, torch.abs(g))
    return w - lr * m / (u + 1e-8), (m, u)


def _nadam_init(w, h):
    # m_schedule per parameter (the module docstring says why)
    return (_zeros(w), _zeros(w), torch.ones((), dtype=w.dtype,
                                             device=w.device))


def _nadam_apply(w, g, state, lr, wd, t, h, key=None):
    b1, b2, eps = h.get("beta1", 0.9), h.get("beta2", 0.999), \
        h.get("epsilon", 1e-8)
    sd = h.get("schedule_decay", 0.004)
    g = g + wd * w
    m, v, m_sched = state
    mom_t = b1 * (1.0 - 0.5 * 0.96 ** (t * sd))
    mom_tp1 = b1 * (1.0 - 0.5 * 0.96 ** ((t + 1) * sd))
    m_sched = m_sched * mom_t
    m_sched_next = m_sched * mom_tp1
    gp = g / (1.0 - m_sched)
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    m_hat = m / (1.0 - m_sched_next)
    v_hat = v / (1.0 - b2 ** t)
    m_bar = (1.0 - mom_t) * gp + mom_tp1 * m_hat
    return w - lr * m_bar / (torch.sqrt(v_hat) + eps), (m, v, m_sched)


def _test_init(w, h):
    return (_zeros(w),)


def _test_apply(w, g, state, lr, wd, t, h, key=None):
    new_w = w + g
    return new_w, (new_w,)


RULES = {
    "sgd": (_sgd_init, _sgd_apply),
    "ccsgd": (_sgd_init, _sgd_apply),
    "signum": (_signum_init, _signum_apply),
    "ftml": (_ftml_init, _ftml_apply),
    "lbsgd": (_lbsgd_init, _lbsgd_apply),
    "dcasgd": (_dcasgd_init, _dcasgd_apply),
    "nag": (_nag_init, _nag_apply),
    "sgld": (_sgld_init, _sgld_apply),
    "adam": (_adam_init, _adam_apply),
    "adagrad": (_adagrad_init, _adagrad_apply),
    "rmsprop": (_rmsprop_init, _rmsprop_apply),
    "adadelta": (_adadelta_init, _adadelta_apply),
    "ftrl": (_ftrl_init, _ftrl_apply),
    "adamax": (_adamax_init, _adamax_apply),
    "nadam": (_nadam_init, _nadam_apply),
    "test": (_test_init, _test_apply),
}

STOCHASTIC = {"sgld"}


def get(name):
    """(init, apply) of a registered optimizer name."""
    key = name.lower()
    if key not in RULES:
        raise ValueError("no pure update rule for optimizer %r" % name)
    return RULES[key]
