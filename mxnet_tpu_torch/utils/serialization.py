"""NDArray (de)serialization (port of `mxnet_tpu/utils/serialization.py`).

The reference's container: a named .npz archive. A saved dict loads as a
dict and a saved list as a list (keys tagged `__list__:<i>`); bfloat16,
which numpy lacks, is stored as its uint16 bits under a `__bf16__:` tag.
So `.params` files cross between the two packages both ways. A file in
MXNet's own binary format (the list magic 0x112) is detected first and
read by `legacy.py`, as the reference's loader does.
"""
from __future__ import annotations

import io
import zipfile

import numpy as np
import torch

_BF16_TAG = "__bf16__:"
_LIST_TAG = "__list__:"


def _to_np(arr):
    """(numpy array, is_bf16) of an NDArray, tensor or array-like."""
    from ..ndarray import NDArray
    t = arr._data if isinstance(arr, NDArray) else arr
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(t), False


def save_ndarrays(fname, data):
    """Write an NDArray, a list or a {name: NDArray} dict to `fname`."""
    from ..ndarray import NDArray
    if isinstance(data, NDArray):
        data = [data]
    arrays = {}
    if isinstance(data, dict):
        for k, v in data.items():
            npd, bf16 = _to_np(v)
            arrays[(_BF16_TAG if bf16 else "") + k] = npd
    elif isinstance(data, (list, tuple)):
        for i, v in enumerate(data):
            npd, bf16 = _to_np(v)
            arrays[(_BF16_TAG if bf16 else "") + _LIST_TAG + str(i)] = npd
    else:
        raise TypeError("save expects NDArray, list, or dict")
    with open(fname, "wb") as f:  # a file handle: savez appends no '.npz'
        np.savez(f, **arrays)


def load_ndarrays(fname, ctx=None):
    """A dict or list of NDArrays from a path or from the file's bytes,
    on `ctx` (the current context by default). MXNet's binary format is
    detected by its framing and read by `legacy.load_legacy_ndarrays`."""
    from ..context import current_context
    from ..ndarray import NDArray
    from . import legacy
    ctx = ctx if ctx is not None else current_context()
    if legacy.is_legacy_ndarray_file(fname):
        return legacy.load_legacy_ndarrays(fname, ctx=ctx)
    src = io.BytesIO(bytes(fname)) if isinstance(fname, (bytes, bytearray)) \
        else fname
    try:
        archive = np.load(src, allow_pickle=False)
    except (zipfile.BadZipFile, ValueError):
        raise IOError("not an mxnet_tpu .params/.npz archive: %s"
                      % (fname if isinstance(fname, str) else "<bytes>"))
    items = {}
    is_list = False
    for key in archive.files:
        name, arr = key, archive[key]
        bf16 = name.startswith(_BF16_TAG)
        if bf16:
            name = name[len(_BF16_TAG):]
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        value = NDArray(t, ctx=ctx)
        if name.startswith(_LIST_TAG):
            is_list = True
            items[int(name[len(_LIST_TAG):])] = value
        else:
            items[name] = value
    if is_list:
        return [items[i] for i in sorted(items)]
    return items


def split_arg_aux(payload, unprefixed=None):
    """({name: arg}, {name: aux}) from a checkpoint dict keyed 'arg:<name>'
    / 'aux:<name>'; unprefixed='arg' keeps bare keys as args, None drops
    them (the reference's load_checkpoint)."""
    arg_params, aux_params = {}, {}
    for k, v in payload.items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
        elif unprefixed == "arg":
            arg_params[k] = v
    return arg_params, aux_params
