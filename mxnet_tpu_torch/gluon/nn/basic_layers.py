"""Basic Gluon layers of the ResNet path (port of the matching share of
`mxnet_tpu/gluon/nn/basic_layers.py`): Sequential, HybridSequential,
Dense, Activation, Flatten and BatchNorm with `fused_call` and the
moving-stat update. Not ported yet: Dropout, Embedding, LayerNorm,
InstanceNorm, Lambda, HybridLambda and the activation layers
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

import math

from ..block import Block, HybridBlock


class Sequential(Block):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, key):
        layers = list(self._children.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __iter__(self):
        return iter(self._children.values())


class HybridSequential(HybridBlock):
    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    add = Sequential.add
    __len__ = Sequential.__len__
    __getitem__ = Sequential.__getitem__
    __iter__ = Sequential.__iter__

    def forward(self, x):
        for block in self._children.values():
            x = block(x)
        return x

    def hybrid_forward(self, F, x):
        return self.forward(x)


class Dense(HybridBlock):
    """weight: (units, in_units), as the reference's, so checkpoints carry
    across by name."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units), dtype=dtype,
                init=_init(weight_initializer), allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(units,), dtype=dtype,
                    init=_init(bias_initializer), allow_deferred_init=True)
            else:
                self.bias = None

    def _shape_probe(self, x, *args):
        in_units = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        self.weight.shape = (self._units, in_units)
        self.weight._finish_deferred_init(self.weight.shape)
        if self.bias is not None and self.bias._deferred_init:
            self.bias._finish_deferred_init(self.bias.shape)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               flatten=self._flatten,
                               no_bias=(bias is None))
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation  # before super(): _alias() needs it
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class BatchNorm(HybridBlock):
    """Running stats are updated after each training-mode forward from the
    batch statistics the op returns (parity: basic_layers.py BatchNorm)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._center = center
        self._scale = scale
        self._use_global_stats = use_global_stats
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init(gamma_initializer),
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init(beta_initializer),
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                "running_mean", grad_req="null", shape=(in_channels,),
                init=_init(running_mean_initializer),
                allow_deferred_init=True, differentiable=False)
            self.running_var = self.params.get(
                "running_var", grad_req="null", shape=(in_channels,),
                init=_init(running_variance_initializer),
                allow_deferred_init=True, differentiable=False)
            # auxiliary states (mutated by the layer), not merely frozen
            self.running_mean._is_aux = True
            self.running_var._is_aux = True

    def _shape_probe(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta, self.running_mean, self.running_var):
            p.shape = (c,)
            if p._deferred_init:
                p._finish_deferred_init(p.shape)

    def _op_kwargs(self):
        return dict(eps=self._epsilon, momentum=self._momentum,
                    fix_gamma=not self._scale,
                    use_global_stats=self._use_global_stats, axis=self._axis)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        out, mean, var = F.BatchNorm(x, gamma, beta, running_mean,
                                     running_var, **self._op_kwargs())
        self._update_moving_stats(mean, var)
        return out

    def _update_moving_stats(self, mean, var):
        from ... import autograd
        if autograd.is_training() and not self._use_global_stats:
            m = self._momentum
            self.running_mean.set_data(
                m * self.running_mean.data() + (1 - m) * mean.detach())
            self.running_var.set_data(
                m * self.running_var.data() + (1 - m) * var.detach())

    def fused_call(self, x, act=None, residual=None):
        """BN with the ReLU / residual epilogue folded into one op
        (`_contrib_BatchNormAddRelu`: MXNET_FUSED_BN_EPILOGUE=1 routes it
        through the fused kernels, flag off it composes the same math).
        Same deferred-init and moving-stat semantics as the plain
        forward; the model-zoo ResNet blocks use it for their
        relu(BN(x) + residual) tails."""
        from ... import ndarray as F
        from ..parameter import DeferredInitializationError
        try:
            params = {n: p.data() for n, p in self._reg_params.items()}
        except DeferredInitializationError:
            self._finish_deferred_init(x)
            params = {n: p.data() for n, p in self._reg_params.items()}
        out, mean, var = F._contrib_BatchNormAddRelu(
            x, params["gamma"], params["beta"], params["running_mean"],
            params["running_var"], addend=residual, act_type=act,
            **self._op_kwargs())
        self._update_moving_stats(mean, var)
        return out


class Flatten(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


def _init(spec):
    if spec is None or not isinstance(spec, str):
        return spec
    from ... import initializer
    return initializer.create(spec)
