"""Optimizers (port of `mxnet_tpu/optimizer.py`): the Optimizer base with
its lr / wd bookkeeping, the registry, and SGD. Every optimizer's math is
its pure rule in optimizer_rules.py, shared with the fused TrainStep. Not
ported yet: the other optimizers, lazy row_sparse updates,
multi-precision state and the Updater (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import torch

from . import optimizer_rules as _rules


class Optimizer:
    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict if param_dict else {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- registry ----------------------------------------------------------
    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    # -- lr / wd bookkeeping ------------------------------------------------
    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """No decay for parameters other than weights and gammas named in
        idx2name, then the explicit multipliers."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.learning_rate
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def _preprocess_grad(self, grad):
        g = grad._data * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    # -- the pure rule -------------------------------------------------------
    rule_name = None  # subclasses set their optimizer_rules key

    def rule_hyper(self):
        """Static hyper-parameters passed to the pure rule."""
        return {}

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _dense_update(self, index, weight, grad, states):
        """Apply the pure rule to (weight, grad, states), rebinding the
        weight and the state buffers (NDArrays)."""
        _, apply_rule = _rules.get(self.rule_name)
        lr, wd = self._get_lr(index), self._get_wd(index)
        with torch.no_grad():
            new_w, new_vals = apply_rule(
                weight._data, self._preprocess_grad(grad),
                tuple(s._data for s in states), lr, wd,
                self._index_update_count[index], self.rule_hyper())
        for s, v in zip(states, new_vals):
            s._data = v
        weight._data = new_w.to(weight._data.dtype)


register = Optimizer.register
create = Optimizer.create_optimizer


@register
class SGD(Optimizer):
    """SGD with momentum (parity: optimizer.py SGD; dense updates)."""

    rule_name = "sgd"

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update  # row_sparse grads: a later slice

    def rule_hyper(self):
        return {"momentum": self.momentum}

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        from .ndarray import NDArray
        return NDArray(torch.zeros_like(weight._data.detach()),
                       ctx=weight.context)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._dense_update(index, weight, grad,
                           () if state is None else (state,))
