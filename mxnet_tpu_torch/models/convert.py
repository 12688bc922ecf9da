"""Weights carried across from the JAX reference.

`jax.random` and torch's generators draw different numbers from one seed,
so the parity tests (and anyone moving a trained model over) hand the
reference's parameters across as numpy arrays: the transformer's flat
params dict (`params_from_numpy`) or a Gluon net's parameters by name
(`gluon_params_from_numpy`). No jax import here: the caller does the
`np.asarray` on the JAX side."""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, resolve_device
from .transformer import param_shapes


def params_from_numpy(params, cfg, device):
    """{name: np.ndarray} in the reference's flat naming -> {name: tensor}
    of `cfg.dtype` on `device`. Every name and shape the config needs must
    be present, and nothing else: a mismatch raises instead of serving a
    half-loaded model."""
    want = param_shapes(cfg)
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
        raise MXNetError("params do not match the config: missing %r, "
                         "unexpected %r" % (missing, extra))
    device = resolve_device(device)
    out = {}
    for name, shape in want.items():
        arr = np.asarray(params[name])
        if tuple(arr.shape) != tuple(shape):
            raise MXNetError("param %r has shape %r, the config needs %r"
                             % (name, tuple(arr.shape), tuple(shape)))
        # a float32 copy (numpy has no bfloat16; a bf16 array widens to
        # f32 exactly), so no tensor aliases the caller's array
        out[name] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(
            device=device, dtype=cfg.dtype)
    return out


def gluon_params_from_numpy(net, arrays):
    """Set every parameter of the Gluon `net` from {name: np.ndarray},
    keyed by the reference's parameter names (`resnetv10_conv2d0_weight`,
    ...). Each value is cast to the parameter's dtype on its device. A
    missing, extra or mis-shaped name raises before anything is written.
    The net's parameters must be initialized (one forward materializes
    deferred shapes)."""
    params = net.collect_params()
    missing = sorted(set(params.keys()) - set(arrays))
    extra = sorted(set(arrays) - set(params.keys()))
    if missing or extra:
        raise MXNetError("arrays do not match the net's parameters: missing "
                         "%r, unexpected %r" % (missing, extra))
    values = {}
    for name, p in params.items():
        arr = np.asarray(arrays[name])
        if p._data is None:
            raise MXNetError("parameter %r is not initialized (run one "
                             "forward first)" % name)
        if tuple(arr.shape) != tuple(p._data.shape):
            raise MXNetError("param %r has shape %r, the net needs %r"
                             % (name, tuple(arr.shape), tuple(p._data.shape)))
        # a float32 copy (numpy has no bfloat16; a bf16 array widens to
        # f32 exactly), so no tensor aliases the caller's array
        values[name] = torch.from_numpy(np.array(arr, dtype=np.float32))
    for name, p in params.items():
        p.set_data(values[name])
