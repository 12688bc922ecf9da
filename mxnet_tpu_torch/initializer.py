"""Weight initializers (port of `mxnet_tpu/initializer.py`): the InitDesc
protocol, the registry (`register`, `alias`, `create`), and Zero, One,
Constant, Uniform, Normal, Xavier, MSRAPrelu, Orthogonal, Bilinear,
LSTMBias, FusedRNN, Load and Mixed.

The reference draws from numpy's global generator; each initializer here
owns an explicit `torch.Generator` on the CPU, seeded by its `seed`
argument (0 by default), so one seed gives the same weights on any device.
The two frameworks' generators give different numbers from one seed:
parity tests carry weights across by name instead
(`models.convert.gluon_params_from_numpy`) and hold the random
initializers to their moments.

`FusedRNN` walks the flat `RNN` parameter vector by layer, direction and
gate, as upstream MXNet's does (the reference's only delegates to its
inner initializer): each gate's weight block through the inner
initializer, every bias zero but the LSTM forget gate's, `forget_bias`.
"""
from __future__ import annotations

import json
import math
import re

import torch

from .registry import get_alias_func, get_create_func, get_register_func


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
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        self._print_func = print_func
        return self

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        """Fill the NDArray `arr` by the rule its name's suffix selects."""
        if not isinstance(desc, str):
            raise TypeError("desc must be a string or InitDesc")
        if isinstance(desc, InitDesc) and desc.global_init is None:
            desc.global_init = self
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

    def init_weight(self, name, arr):
        self._init_weight(name, arr)

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


register = get_register_func(Initializer, "initializer")
alias = get_alias_func(Initializer, "initializer")
create = get_create_func(Initializer, "initializer")


@register
@alias("zeros")
class Zero(Initializer):
    def _init_weight(self, desc, arr):
        self._init_zero(desc, arr)


@register
@alias("ones")
class One(Initializer):
    def _init_weight(self, desc, arr):
        self._init_one(desc, arr)


@register
class Constant(Initializer):
    def __init__(self, value=0.0, seed=0):
        super().__init__(seed=seed, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        self._set(arr, torch.full(arr.shape, float(self.value)))


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07, seed=0):
        super().__init__(seed=seed, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        self._set(arr, self._draw(arr.shape, "uniform", -self.scale,
                                  self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01, seed=0):
        super().__init__(seed=seed, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        self._set(arr, self._draw(arr.shape, "normal", 0.0, self.sigma))


@register
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


@register
class MSRAPrelu(Xavier):
    """Xavier's gaussian at magnitude 2 / (1 + slope²) (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25, seed=0):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         seed=seed)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """`scale` times an orthonormal basis from the SVD of a uniform [-1, 1]
    (or, rand_type "normal", a standard normal) draw."""

    def __init__(self, scale=1.414, rand_type="uniform", seed=0):
        super().__init__(seed=seed, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(math.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = self._draw((nout, nin), "uniform", -1.0, 1.0)
        else:
            tmp = self._draw((nout, nin), "normal", 0.0, 1.0)
        u, _, v = torch.linalg.svd(tmp.double(), full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        self._set(arr, (self.scale * q).float().reshape(arr.shape))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a deconvolution weight
    [C_out, C_in, H, W]."""

    def _init_weight(self, _, arr):
        shape = arr.shape
        i = torch.arange(math.prod(shape), dtype=torch.float64)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.remainder(i, shape[3])
        y = torch.remainder(torch.div(i, shape[3], rounding_mode="floor"),
                            shape[2])
        weight = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        self._set(arr, weight.float().reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter (gate order i, f, c, o) set to
    `forget_bias`."""

    def __init__(self, forget_bias=1.0, seed=0):
        super().__init__(seed=seed, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape)
        num_hidden = arr.shape[0] // 4
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)


#: gate names of each RNN mode, in the parameter vector's order (upstream
#: rnn_cell.py FusedRNNCell._gate_names)
RNN_GATES = {"rnn_relu": ("",), "rnn_tanh": ("",),
             "lstm": ("_i", "_f", "_c", "_o"), "gru": ("_r", "_z", "_o")}


def rnn_param_blocks(size, num_hidden, num_layers, mode, bidirectional):
    """[(name, offset, shape)] of each gate block of an `RNN` op's flat
    parameter vector of `size` elements, in its layout (for each layer,
    for each direction: i2h weight, h2h weight, i2h bias, h2h bias, each
    the gates' blocks in order), named as upstream's
    `FusedRNNCell.unpack_weights` names them (`l0_i2h_f_weight`, `r1_...`
    for the reverse direction)."""
    G = len(RNN_GATES[mode])
    dirs = 2 if bidirectional else 1
    H, L = num_hidden, num_layers
    later = (L - 1) * dirs * G * H * (dirs * H + H + 2)
    first, rem = divmod(size - later, dirs * G * H)
    input_size = first - H - 2
    if rem or input_size < 1:
        raise ValueError("%d parameters do not fit a %d-layer %s RNN of "
                         "hidden size %d" % (size, L, mode, H))
    blocks, off = [], 0
    for layer in range(L):
        in_sz = input_size if layer == 0 else dirs * H
        for d in ("l", "r")[:dirs]:
            for group, cols in (("i2h", in_sz), ("h2h", H)):
                for gate in RNN_GATES[mode]:
                    blocks.append(("%s%d_%s%s_weight" % (d, layer, group,
                                                         gate),
                                   off, (H, cols)))
                    off += H * cols
            for group in ("i2h", "h2h"):
                for gate in RNN_GATES[mode]:
                    blocks.append(("%s%d_%s%s_bias" % (d, layer, group, gate),
                                   off, (H,)))
                    off += H
    return blocks


@register
class FusedRNN(Initializer):
    """The flat parameter vector of an `RNN` op, gate block by gate block:
    weights through `init` (an initializer, its name or its JSON; the
    caller's global initializer when None), biases zero, the LSTM forget
    gate's `forget_bias`. With num_hidden 0 the whole vector goes through
    `init`, as the reference's FusedRNN does."""

    def __init__(self, init=None, num_hidden=0, num_layers=1, mode="lstm",
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = create(init)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .ndarray import NDArray
        from .context import cpu
        inner = self._init if self._init is not None else \
            getattr(desc, "global_init", None) or Uniform()
        if not self._num_hidden:
            inner._init_weight(desc, arr)
            return
        flat = torch.zeros(arr.size)
        for name, off, shape in rnn_param_blocks(
                arr.size, self._num_hidden, self._num_layers, self._mode,
                self._bidirectional):
            n = math.prod(shape)
            if name.endswith("bias"):
                if self._mode == "lstm" and name.endswith("_f_bias"):
                    flat[off:off + n] = self._forget_bias
                continue
            block = NDArray(torch.zeros(shape), ctx=cpu())
            inner(InitDesc(name, global_init=desc.global_init
                           if isinstance(desc, InitDesc) else None), block)
            flat[off:off + n] = block._data.reshape(-1).float()
        self._set(arr, flat.reshape(arr.shape))


@register
class Load(Initializer):
    """Parameters by name from a dict of NDArrays or a file `nd.load`
    reads ('arg:' / 'aux:' prefixes dropped); a name it lacks goes to
    `default_init`, else raises."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        if isinstance(param, str):
            from .ndarray import load
            param = load(param)
        self.param = {k.split(":", 1)[-1]: v for k, v in param.items()}
        self.default_init = default_init
        self._verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            arr._data = self.param[name]._data.detach().reshape(
                arr.shape).to(device=arr._data.device,
                              dtype=arr._data.dtype).clone()
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise ValueError("Cannot Initialize parameter: %s" % name)


@register
class Mixed(Initializer):
    """The first initializer whose regular expression matches the name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise ValueError("Mixed needs one initializer a pattern")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise ValueError("no initializer matches %s: add a '.*' pattern "
                         "for a default" % name)
