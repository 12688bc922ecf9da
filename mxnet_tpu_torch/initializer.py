"""Weight initializers (port of `mxnet_tpu/initializer.py`): the InitDesc
protocol, Zero, One, Constant, Uniform, Normal and Xavier.

The reference draws from numpy's global generator; each initializer here
owns an explicit `torch.Generator` on the CPU, seeded by its `seed`
argument (0 by default), so one seed gives the same weights on any device.
The two frameworks' generators give different numbers from one seed:
parity tests carry weights across by name instead
(`models.convert.gluon_params_from_numpy`). Not ported yet: MSRAPrelu,
Orthogonal, Bilinear, LSTMBias, FusedRNN, Load, Mixed and the string
registry beyond these names.
"""
from __future__ import annotations

import json
import math

import torch


class InitDesc(str):
    """Name + attrs descriptor passed to initializers (parity: InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    def __init__(self, seed=0, **kwargs):
        self._kwargs = kwargs
        self._generator = torch.Generator().manual_seed(int(seed))

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        """Fill the NDArray `arr` by the rule its name's suffix selects."""
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        init = desc.attrs.get("__init__", "") \
            if isinstance(desc, InitDesc) else ""
        if init:
            create(init)._init_weight(desc, arr)
            return
        name = desc.lower()
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith(("moving_mean", "running_mean", "moving_inv_var",
                            "moving_avg")):
            self._init_zero(desc, arr)
        elif name.endswith(("moving_var", "running_var")):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    def _set(self, arr, value):
        """Write a CPU float32 tensor into arr, on its device and dtype."""
        arr._data = value.to(device=arr._data.device, dtype=arr._data.dtype)

    def _draw(self, shape, kind, a, b):
        t = torch.empty(tuple(shape), dtype=torch.float32)
        if kind == "uniform":
            return t.uniform_(a, b, generator=self._generator)
        return t.normal_(a, b, generator=self._generator)

    def _init_zero(self, _, arr):
        self._set(arr, torch.zeros(arr.shape))

    def _init_one(self, _, arr):
        self._set(arr, torch.ones(arr.shape))

    def _init_bias(self, desc, arr):
        self._init_zero(desc, arr)

    def _init_gamma(self, desc, arr):
        self._init_one(desc, arr)

    def _init_beta(self, desc, arr):
        self._init_zero(desc, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError

    def _init_default(self, name, arr):
        self._init_weight(name, arr)


class Zero(Initializer):
    def _init_weight(self, desc, arr):
        self._init_zero(desc, arr)


class One(Initializer):
    def _init_weight(self, desc, arr):
        self._init_one(desc, arr)


class Constant(Initializer):
    def __init__(self, value=0.0, seed=0):
        super().__init__(seed=seed, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._set(arr, torch.full(arr.shape, float(self.value)))


class Uniform(Initializer):
    def __init__(self, scale=0.07, seed=0):
        super().__init__(seed=seed, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._set(arr, self._draw(arr.shape, "uniform", -self.scale,
                                  self.scale))


class Normal(Initializer):
    def __init__(self, sigma=0.01, seed=0):
        super().__init__(seed=seed, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._set(arr, self._draw(arr.shape, "normal", 0.0, self.sigma))


class Xavier(Initializer):
    """Parity: initializer.py Xavier (gaussian/uniform; avg/in/out)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 seed=0):
        super().__init__(seed=seed, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires at least 2d shape for %s"
                             % name)
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, self._draw(shape, "uniform", -scale, scale))
        else:
            self._set(arr, self._draw(shape, "normal", 0.0, scale))


_REGISTRY = {"zero": Zero, "zeros": Zero, "one": One, "ones": One,
             "constant": Constant, "uniform": Uniform, "normal": Normal,
             "xavier": Xavier}


def create(name, **kwargs):
    """An initializer by its registered name (parity: mx.init.create)."""
    if isinstance(name, Initializer):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise ValueError("unknown initializer %r (the port has %s)"
                         % (name, ", ".join(sorted(_REGISTRY))))
    return _REGISTRY[key](**kwargs)
