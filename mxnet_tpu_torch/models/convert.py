"""Weights carried across from the JAX reference.

`jax.random` and torch's generators draw different numbers from one seed,
so the parity tests (and anyone moving a trained model over) hand the
reference's parameters across as numpy arrays: the transformer's flat
params dict (`params_from_numpy`), a Gluon net's parameters by name
(`gluon_params_from_numpy`) or a bound Module's arguments and aux states
(`module_params_from_numpy`). No jax import here: the caller does the
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


def module_params_from_numpy(mod, arg_arrays, aux_arrays=None):
    """Set a bound Module's parameters from {name: np.ndarray} (and its
    aux states from `aux_arrays`), keyed by the symbol's argument names;
    a BucketingModule's go to its current bucket, which the others copy
    at their next switch. An `RNN` op's flat parameter vector
    (`lstm_parameters`, `*_rnn_parameters`) crosses as one 1-D array: the
    two packages share its layout (for each layer and direction: i2h
    weight, h2h weight, i2h bias, h2h bias). Every parameter (and, when
    aux_arrays is given, every aux state) must be there with its bound
    shape, and nothing else: a mismatch raises before anything is
    written."""
    from ..ndarray import NDArray
    from ..context import cpu
    bound = getattr(mod, "_curr_module", None) or mod
    if getattr(bound, "_exec", None) is None:
        raise MXNetError("module_params_from_numpy needs a bound Module or "
                         "BucketingModule")
    want = {"arg": {n: bound._exec.arg_dict[n].shape
                    for n in bound._param_names},
            "aux": {n: bound._exec.aux_dict[n].shape
                    for n in bound._aux_names}}
    given = {"arg": arg_arrays, "aux": aux_arrays}
    out = {}
    for kind in ("arg", "aux"):
        arrays = given[kind]
        if arrays is None:
            out[kind] = None
            continue
        missing = sorted(set(want[kind]) - set(arrays))
        extra = sorted(set(arrays) - set(want[kind]))
        if missing or extra:
            raise MXNetError("%s arrays do not match the module: missing "
                             "%r, unexpected %r" % (kind, missing, extra))
        out[kind] = {}
        for name, shape in want[kind].items():
            arr = np.array(arrays[name], dtype=np.float32)
            if tuple(arr.shape) != tuple(shape):
                raise MXNetError("%s %r has shape %r, the module needs %r"
                                 % (kind, name, arr.shape, tuple(shape)))
            out[kind][name] = NDArray(torch.from_numpy(arr), ctx=cpu())
    mod.set_params(out["arg"], out["aux"] or {})
