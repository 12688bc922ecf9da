"""Pure optimizer update rules (port of `mxnet_tpu/optimizer_rules.py`):
one implementation per optimizer, shared by the eager optimizer classes
(optimizer.py) and the fused TrainStep (parallel/trainer.py).

Signatures, as the reference's:
    init(w, h)                               -> tuple of state tensors
    apply(w, g, state, lr, wd, t, h, key=None) -> (new_w, new_state)

`g` arrives with rescale and clipping applied but not weight decay; each
rule applies wd the way its reference class does. Only SGD is ported so
far; the other rules are listed in ROADMAP.md, queue 1.
"""
from __future__ import annotations

import torch


def _sgd_init(w, h):
    return (torch.zeros_like(w),) if h.get("momentum", 0.0) else ()


def _sgd_apply(w, g, state, lr, wd, t, h, key=None):
    """MXNet's order: g += wd * w; m = momentum * m - lr * g; w += m."""
    g = g + wd * w
    if state:
        m = h["momentum"] * state[0] - lr * g
        return w + m, (m,)
    return w - lr * g, state


RULES = {
    "sgd": (_sgd_init, _sgd_apply),
}
STOCHASTIC = set()


def get(name):
    """(init, apply) of a registered optimizer name."""
    key = name.lower()
    if key not in RULES:
        raise ValueError("no update rule for optimizer %r in the port yet "
                         "(it has %s)" % (name, ", ".join(sorted(RULES))))
    return RULES[key]
