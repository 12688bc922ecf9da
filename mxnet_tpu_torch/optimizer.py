"""Optimizers (port of `mxnet_tpu/optimizer.py`): the Optimizer base with
its lr / wd bookkeeping, the registry, the reference's 16 optimizers
(SGD, Signum, FTML, LBSGD, DCASGD, NAG, SGLD, ccSGD, Adam, AdaGrad,
RMSProp, AdaDelta, Ftrl, Adamax, Nadam, Test), and the Updater that holds
per-index state for `gluon.Trainer`, `Module` and the KVStore. Every
optimizer's math is its pure rule in optimizer_rules.py, shared with the
fused TrainStep. `sym=` reads the `__lr_mult__` / `__wd_mult__`
attributes of a Symbol's arguments, and `multi_precision=True` keeps a
float32 master copy of each float16 or bfloat16 weight (the reference's
covers float16 only; bfloat16 is this port's training dtype too).

A row_sparse gradient (`ndarray.sparse.RowSparseNDArray`) updates only
its stored rows under SGD and Adam with `lazy_update` (the default):
each reads, updates and writes back the weight's and the state's rows
at the gradient's ids, which are sorted and unique, so the row writes
are well defined; every other row stays as it was, bit for bit. Every
other optimizer, and these two with `lazy_update=False`, densifies the
gradient and takes its dense rule.
"""
from __future__ import annotations

import math
import pickle

import numpy as np
import torch

from . import optimizer_rules as _rules
from .ndarray.sparse import RowSparseNDArray


class Optimizer:
    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
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
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ({}, [])
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

    def _sym_mults(self, key):
        """{argument name: float(attr[key])} over the symbol's arguments
        that carry the attribute."""
        attr, arg_names = self.sym_info
        return {n: float(attr[n][key]) for n in arg_names
                if n in attr and key in attr[n]}

    def set_lr_scale(self, args_lrscale):  # pylint: disable=unused-argument
        """Deprecated (the reference raises too): use set_lr_mult."""
        raise DeprecationWarning("use set_lr_mult instead")

    def set_lr_mult(self, args_lr_mult):
        """The symbol's `__lr_mult__` attributes, then the explicit
        multipliers."""
        self.lr_mult = self._sym_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """No decay for parameters other than weights and gammas named in
        idx2name, then the symbol's `__wd_mult__` attributes, then the
        explicit multipliers."""
        self.wd_mult = {n: 0.0 for n in self.idx2name.values()
                        if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._sym_mults("__wd_mult__"))
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

    def _rescale_clip(self, g):
        g = g * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def _preprocess_grad(self, grad):
        """The dense gradient, rescaled and clipped; a row_sparse one is
        densified first."""
        if isinstance(grad, RowSparseNDArray):
            return self._rescale_clip(grad.todense()._data)
        return self._rescale_clip(grad._data)

    def _sparse_rows(self, grad):
        """(row ids as int64, the stored rows rescaled and clipped) of a
        row_sparse gradient, else None."""
        if isinstance(grad, RowSparseNDArray):
            return grad._indices.long(), self._rescale_clip(grad._values)
        return None

    # -- the pure rule -------------------------------------------------------
    rule_name = None  # subclasses set their optimizer_rules key

    def rule_hyper(self):
        """Static hyper-parameters passed to the pure rule."""
        return {}

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def _master(self, weight):
        return self.multi_precision and weight._data.dtype in _HALF

    def create_state_multi_precision(self, index, weight):
        """(float32 master weight, its state) for a float16 / bfloat16
        weight under multi_precision, else `create_state`."""
        if self._master(weight):
            from .ndarray import NDArray
            master = NDArray(weight._data.detach().float(),
                             ctx=weight.context)
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    def update_multi_precision(self, index, weight, grad, state):
        """Update the float32 master with a float32 gradient and round it
        back into the weight; otherwise `update`."""
        if self._master(weight):
            from .ndarray import NDArray
            master, st = state
            if isinstance(grad, RowSparseNDArray):
                g32 = RowSparseNDArray(grad._indices, grad._values.float(),
                                       grad.shape, ctx=grad.context)
            else:
                g32 = NDArray(grad._data.float(), ctx=grad.context)
            self.update(index, master, g32, st)
            weight._data = master._data.to(weight._data.dtype)
        else:
            self.update(index, weight, grad, state)

    def _dense_update(self, index, weight, grad, states, t=None):
        """Apply the pure rule to (weight, grad, states), rebinding the
        weight and the state buffers (NDArrays). `t` defaults to the
        index's update count."""
        _, apply_rule = _rules.get(self.rule_name)
        lr, wd = self._get_lr(index), self._get_wd(index)
        if t is None:
            t = self._index_update_count[index]
        with torch.no_grad():
            new_w, new_vals = apply_rule(
                weight._data, self._preprocess_grad(grad),
                tuple(s._data for s in states), lr, wd, t,
                self.rule_hyper())
        for s, v in zip(states, new_vals):
            s._data = v
        weight._data = new_w.to(weight._data.dtype)


_HALF = (torch.float16, torch.bfloat16)
register = Optimizer.register
create = create_optimizer = Optimizer.create_optimizer


def _zeros(weight):
    """A zero state buffer like `weight`, on its context."""
    from .ndarray import NDArray
    return NDArray(torch.zeros_like(weight._data.detach()),
                   ctx=weight.context)


class _MomentumOptimizer(Optimizer):
    """An optimizer whose only state is a momentum buffer, kept when
    momentum is nonzero (SGD, Signum, NAG)."""

    def rule_hyper(self):
        return {"momentum": self.momentum}

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._dense_update(index, weight, grad,
                           () if state is None else (state,))


class _OneStateOptimizer(Optimizer):
    """An optimizer whose state is one zero buffer (LBSGD, AdaGrad,
    Test)."""

    def create_state(self, index, weight):
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._dense_update(index, weight, grad, (state,))


class _TupleStateOptimizer(Optimizer):
    """An optimizer whose state is a tuple of zero buffers, `n_states`
    of them, in its rule's state order."""

    n_states = 2

    def create_state(self, index, weight):
        return tuple(_zeros(weight) for _ in range(self.n_states))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._dense_update(index, weight, grad, state)


@register
class SGD(_MomentumOptimizer):
    """SGD with momentum (parity: optimizer.py SGD), lazy over a
    row_sparse gradient's rows."""

    rule_name = "sgd"

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def update(self, index, weight, grad, state):
        sparse = self._sparse_rows(grad)
        if sparse is None or not self.lazy_update:
            return super().update(index, weight, grad, state)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        rows, g = sparse
        with torch.no_grad():
            w = weight._data.detach()
            g = g + wd * w.index_select(0, rows)
            if state is not None:
                m_rows = self.momentum * state._data.index_select(0, rows) \
                    - lr * g
                state._data = state._data.index_copy(0, rows, m_rows)
                new_w = w.index_add(0, rows, m_rows.to(w.dtype))
            else:
                new_w = w.index_add(0, rows, (-lr * g).to(w.dtype))
        weight._data = new_w


@register
class Signum(_MomentumOptimizer):
    """signSGD, and its momentum form (parity: optimizer.py Signum)."""

    rule_name = "signum"

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def rule_hyper(self):
        return {"momentum": self.momentum, "wd_lh": self.wd_lh}


@register
class FTML(_TupleStateOptimizer):
    """Follow The Moving Leader (parity: optimizer.py FTML); state
    (d, v, z)."""

    rule_name = "ftml"
    n_states = 3

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def rule_hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}


@register
class LBSGD(_OneStateOptimizer):
    """Large-batch SGD with the LARS-style layer-wise scale (parity:
    optimizer.py LBSGD: the linear warm-up only, driven by the global
    update count, as the reference's)."""

    rule_name = "lbsgd"

    def __init__(self, momentum=0.0, multi_precision=False,
                 warmup_strategy="linear", warmup_epochs=5, batch_scale=1,
                 updates_per_epoch=32, begin_epoch=0, num_epochs=60,
                 **kwargs):
        super().__init__(multi_precision=multi_precision, **kwargs)
        self.momentum = momentum
        self.warmup_epochs = warmup_epochs
        self.batch_scale = batch_scale
        self.updates_per_epoch = updates_per_epoch

    def rule_hyper(self):
        return {"momentum": self.momentum,
                "warmup_epochs": self.warmup_epochs,
                "updates_per_epoch": self.updates_per_epoch}

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._dense_update(index, weight, grad, (state,),
                           t=self.num_update)


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (parity: optimizer.py DCASGD);
    state (momentum or None, previous weight)."""

    rule_name = "dcasgd"

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def rule_hyper(self):
        return {"momentum": self.momentum, "lamda": self.lamda}

    def create_state(self, index, weight):
        from .ndarray import NDArray
        mom = None if self.momentum == 0.0 else _zeros(weight)
        return (mom, NDArray(weight._data.detach().clone(),
                             ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        mom, prev = state
        self._dense_update(index, weight, grad,
                           (prev,) if mom is None else (mom, prev))


@register
class NAG(_MomentumOptimizer):
    """Nesterov accelerated SGD (parity: optimizer.py NAG)."""

    rule_name = "nag"

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (parity: optimizer.py SGLD).
    The noise comes from the weight's device generator
    (optimizer_rules.py says why)."""

    rule_name = "sgld"

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._dense_update(index, weight, grad, ())


@register
class ccSGD(SGD):
    """The reference's alias of SGD, kept for old scripts."""


@register
class Adam(_TupleStateOptimizer):
    """Adam (parity: optimizer.py Adam), lazy over a row_sparse
    gradient's rows; state (mean, var)."""

    rule_name = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lazy_update = lazy_update

    def rule_hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon}

    def update(self, index, weight, grad, state):
        sparse = self._sparse_rows(grad)
        if sparse is None or not self.lazy_update:
            return super().update(index, weight, grad, state)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = lr * math.sqrt(1.0 - self.beta2 ** t) / \
            (1.0 - self.beta1 ** t)
        mean, var = state
        rows, g = sparse
        with torch.no_grad():
            w = weight._data.detach()
            g = g + wd * w.index_select(0, rows)
            m_r = self.beta1 * mean._data.index_select(0, rows) \
                + (1 - self.beta1) * g
            v_r = self.beta2 * var._data.index_select(0, rows) \
                + (1 - self.beta2) * torch.square(g)
            mean._data = mean._data.index_copy(0, rows, m_r)
            var._data = var._data.index_copy(0, rows, v_r)
            upd = lr_t * m_r / (torch.sqrt(v_r) + self.epsilon)
            new_w = w.index_add(0, rows, (-upd).to(w.dtype))
        weight._data = new_w


@register
class AdaGrad(_OneStateOptimizer):
    """AdaGrad (parity: optimizer.py AdaGrad)."""

    rule_name = "adagrad"

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def rule_hyper(self):
        return {"eps": self.float_stable_eps}


@register
class RMSProp(Optimizer):
    """RMSProp (parity: optimizer.py RMSProp): Tieleman's with
    centered=False, Graves's with centered=True; clip_weights clips the
    new weight."""

    rule_name = "rmsprop"

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def rule_hyper(self):
        return {"gamma1": self.gamma1, "gamma2": self.gamma2,
                "epsilon": self.epsilon, "centered": self.centered,
                "clip_weights": self.clip_weights}

    def create_state(self, index, weight):
        return tuple(_zeros(weight)
                     for _ in range(3 if self.centered else 1))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._dense_update(index, weight, grad, state)


@register
class AdaDelta(_TupleStateOptimizer):
    """AdaDelta (parity: optimizer.py AdaDelta); state (acc_g,
    acc_delta)."""

    rule_name = "adadelta"

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def rule_hyper(self):
        return {"rho": self.rho, "epsilon": self.epsilon}


@register
class Ftrl(_TupleStateOptimizer):
    """FTRL-proximal (parity: optimizer.py Ftrl); state (z, n)."""

    rule_name = "ftrl"

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def rule_hyper(self):
        return {"lamda1": self.lamda1, "beta": self.beta}


@register
class Adamax(_TupleStateOptimizer):
    """Adamax (parity: optimizer.py Adamax); state (m, u)."""

    rule_name = "adamax"

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def rule_hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2}


@register
class Nadam(Optimizer):
    """Nadam (parity: optimizer.py Nadam); state (m, v, m_schedule), the
    schedule per parameter as in the reference (optimizer_rules.py)."""

    rule_name = "nadam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay

    def rule_hyper(self):
        return {"beta1": self.beta1, "beta2": self.beta2,
                "epsilon": self.epsilon,
                "schedule_decay": self.schedule_decay}

    def create_state(self, index, weight):
        from .ndarray import NDArray
        return (_zeros(weight), _zeros(weight),
                NDArray(torch.ones((), dtype=weight._data.dtype,
                                   device=weight._data.device),
                        ctx=weight.context))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        self._dense_update(index, weight, grad, state)


@register
class Test(_OneStateOptimizer):
    """The reference's trivial optimizer of its unit tests: w += g, the
    state the new weight."""

    rule_name = "test"


class Updater:
    """Per-index optimizer state, made on an index's first update (parity:
    optimizer.py Updater / get_updater)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        """Restore states from `get_states`'s bytes (a pickle: pass only
        bytes this program wrote) or from its dict."""
        from .ndarray import NDArray
        states = pickle.loads(states) if isinstance(states, bytes) else states
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states

        def to_device(v):
            if isinstance(v, np.ndarray):
                return NDArray(v)
            if isinstance(v, (tuple, list)):
                return type(v)(to_device(x) for x in v)
            return v
        self.states = {k: to_device(v) for k, v in self.states.items()}

    def get_states(self, dump_optimizer=False):
        """The states as pickled host arrays (with the optimizer when
        dump_optimizer)."""
        from .ndarray import NDArray

        def to_host(v):
            if isinstance(v, NDArray):
                return v.asnumpy()
            if isinstance(v, (tuple, list)):
                return type(v)(to_host(x) for x in v)
            return v
        host = {k: to_host(v) for k, v in self.states.items()}
        return pickle.dumps((host, self.optimizer) if dump_optimizer
                            else host)


def get_updater(optimizer):
    return Updater(optimizer)
