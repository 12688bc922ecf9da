"""Errors, device resolution and dtype names shared by every module of the
port."""
from __future__ import annotations

import numpy as np
import torch


class MXNetError(Exception):
    """Error raised by the framework (the reference's MXNetError)."""


def resolve_device(device=None):
    """The torch.device an entry point runs on.

    `None` means the card (`cuda`): the port serves on the GPU unless the
    caller asks for something else by name, as the CPU tests do with
    `device="cpu"`. A CUDA request on a machine without a usable CUDA
    device raises; nothing quietly falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU" % (str(dev),))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype):
    """A user dtype spec (None, a name, a numpy dtype or a torch dtype) as a
    torch dtype; None is float32, the reference's default."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and dtype in _TORCH_DTYPES:
        return _TORCH_DTYPES[dtype]
    name = np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return _TORCH_DTYPES[name]


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16, which numpy lacks, stays
    the torch dtype."""
    if dtype == torch.bfloat16:
        return torch.bfloat16
    return np.dtype(str(dtype).replace("torch.", ""))
