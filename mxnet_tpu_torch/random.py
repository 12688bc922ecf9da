"""Global random state (port of `mxnet_tpu/random.py`).

The reference keeps one JAX PRNG key that ops split from (and threads a
traced key through jit traces). Here each device has one explicit
`torch.Generator`, made on first use from the seed `seed()` recorded (or
from numpy's global generator when none was), and every stochastic op of
the port (Dropout, the RNN op's inter-layer dropout, the samplers) draws
from the generator of the device it samples on. `seed` also seeds numpy,
as the reference's does. torch runs eagerly, so the reference's trace-key
machinery (`trace_key_scope`, `next_key`) has no counterpart; where the
reference passes a key to one call (`functionalize`'s apply function),
the port passes a generator, which `generator_scope` puts in front of
its device's. `snapshot` / `restore` save and put back every
generator's state (TrainStep's remat replays and its probe).

The imperative samplers (`uniform`, `normal`, `randint`, ...) are
attached to this module by `mxnet_tpu_torch.ndarray`, as the reference
populates `mx.random.*` from its `nd.random` namespace.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch


class _RandomState(threading.local):
    """Per-thread generators, one per device, made lazily."""

    def __init__(self):
        super().__init__()
        self.seed_value = None    # pending integer seed, if seed() ran
        self.generators = {}      # str(torch.device) -> torch.Generator
        self.override = None      # a generator_scope's generator


_STATE = _RandomState()


def _key(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device, str(device)


#: `generator_scope`'s value under which every device's draws come from
#: torch's default generator of the device (`generator()` returns None)
_DEFAULT = object()


def generator(device="cpu"):
    """The generator that stochastic ops on `device` draw from; None (torch's
    default generator of the device) inside `default_generator_scope`."""
    device, key = _key(device)
    ov = _STATE.override
    if ov is _DEFAULT:
        return None
    if ov is not None and _key(ov.device)[1] == key:
        return ov
    g = _STATE.generators.get(key)
    if g is None:
        seed_val = _STATE.seed_value if _STATE.seed_value is not None \
            else int(np.random.randint(0, 2**31 - 1))
        g = torch.Generator(device=device).manual_seed(seed_val)
        _STATE.generators[key] = g
    return g


def seed(seed_state, ctx="all"):
    """Seed the generators (parity: mx.random.seed): every device's with
    ctx="all" (generators are remade on next use), else only the device of
    the Context `ctx`. Seeds numpy's global generator too."""
    value = int(seed_state) & 0x7FFFFFFF
    if isinstance(ctx, str) and ctx == "all":
        _STATE.seed_value = value
        _STATE.generators = {}
    else:
        device, key = _key(ctx.torch_device())
        _STATE.generators[key] = torch.Generator(device=device).manual_seed(
            value)
    np.random.seed(int(seed_state) & 0xFFFFFFFF)


def get_state():
    """Snapshot of every generator made so far, {device name: uint8 numpy
    state}, for checkpoint and resume (the reference returns its key)."""
    return {key: g.get_state().numpy().copy()
            for key, g in _STATE.generators.items()}


def set_state(states):
    """Restore a snapshot taken by `get_state()`."""
    gens = {}
    for key, state in states.items():
        g = torch.Generator(device=torch.device(key))
        g.set_state(torch.from_numpy(np.asarray(state, dtype=np.uint8)))
        gens[key] = g
    _STATE.generators = gens
    _STATE.seed_value = None


@contextlib.contextmanager
def generator_scope(gen):
    """Within the scope, stochastic ops on `gen`'s device draw from
    `gen`."""
    prev = _STATE.override
    _STATE.override = gen
    try:
        yield gen
    finally:
        _STATE.override = prev


def default_generator_scope():
    """Within the scope, stochastic ops draw from torch's default generator
    of their device, passing no generator: a traced step then holds no
    Generator object, and whoever runs it seeds the default generator
    (predict.export_train_step)."""
    return generator_scope(_DEFAULT)


def snapshot():
    """Every generator made so far with its state, and the pending seed,
    for `restore`."""
    return (_STATE.seed_value,
            {key: (g, g.get_state()) for key, g in
             _STATE.generators.items()})


def restore(snap):
    """Put back the generators of `snapshot()` in the states they had
    then; generators made since are dropped."""
    seed_value, gens = snap
    for g, state in gens.values():
        g.set_state(state)
    _STATE.generators = {key: g for key, (g, _) in gens.items()}
    _STATE.seed_value = seed_value
