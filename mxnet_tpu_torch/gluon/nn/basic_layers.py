"""Basic Gluon layers (port of `mxnet_tpu/gluon/nn/basic_layers.py`):
Sequential, HybridSequential, Dense, Activation, Dropout, Flatten,
Embedding, BatchNorm with `fused_call` and the moving-stat update,
LayerNorm, InstanceNorm, Lambda, HybridLambda and the activation layers
LeakyReLU, PReLU, ELU, SELU, Swish and GELU.
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


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


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
        res = F.BatchNorm(x, gamma, beta, running_mean, running_var,
                          **self._op_kwargs())
        if not isinstance(res, tuple):
            # a trace: the node's normalized output; the moving statistics
            # come back from the graph's evaluation (Symbol._eval)
            return res
        out, mean, var = res
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


class Embedding(HybridBlock):
    """weight: (input_dim, output_dim), as the reference's; gradients are
    dense (sparse_grad is accepted, as the reference accepts it)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self._sparse_grad = sparse_grad
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(input_dim, output_dim), dtype=dtype,
                init=_init(weight_initializer))

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self._input_dim,
                           output_dim=self._output_dim,
                           sparse_grad=self._sparse_grad)


class Flatten(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class LayerNorm(HybridBlock):
    """Normalizes over `axis` (the last by default), with a gamma and a
    beta of that axis's size."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                "gamma", grad_req="write" if scale else "null",
                shape=(in_channels,), init=_init(gamma_initializer),
                allow_deferred_init=True)
            self.beta = self.params.get(
                "beta", grad_req="write" if center else "null",
                shape=(in_channels,), init=_init(beta_initializer),
                allow_deferred_init=True)

    def _shape_probe(self, x, *args):
        c = x.shape[self._axis]
        for p in (self.gamma, self.beta):
            p.shape = (c,)
            if p._deferred_init:
                p._finish_deferred_init(p.shape)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class InstanceNorm(LayerNorm):
    """Normalizes each sample's channel over its spatial axes, with a
    gamma and a beta a channel (axis 1). Unlike LayerNorm, scale is off
    by default."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(1, epsilon, center, scale, beta_initializer,
                         gamma_initializer, in_channels, **kwargs)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._epsilon)


class Lambda(Block):
    """Wraps a function of NDArrays, or the name of an `nd` function."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd
            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """Wraps a function of (F, *inputs), or the name of an op that both
    namespaces have, so that it traces under hybridize."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_name = function if isinstance(function, str) else None
        self._func = function

    def hybrid_forward(self, F, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(*args)
        return self._func(F, *args)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """A leaky ReLU whose one slope, `alpha` (0.25 at first), is
    learned."""

    def __init__(self, alpha_initializer=None, **kwargs):
        super().__init__(**kwargs)
        from ... import initializer
        with self.name_scope():
            self.alpha = self.params.get(
                "alpha", shape=(1,),
                init=alpha_initializer or initializer.Constant(0.25))

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    """The tanh approximation, as the reference's."""

    def hybrid_forward(self, F, x):
        return 0.5 * x * (1.0 + F.tanh(0.7978845608028654 *
                                       (x + 0.044715 * x * x * x)))


def _init(spec):
    if spec is None or not isinstance(spec, str):
        return spec
    from ... import initializer
    return initializer.create(spec)
