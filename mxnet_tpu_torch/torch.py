"""Torch interop surface (port of `mxnet_tpu/torch.py`; parity:
python/mxnet/torch.py, which exposed the torch plugin's ops): the
`plugin.TorchBlock` bridge and array converters.

The converters keep the array's device and share its memory (the
reference copies through the host both ways): an NDArray already holds a
torch.Tensor."""
from __future__ import annotations

from .ndarray import NDArray
from .plugin import TorchBlock  # noqa: F401 — re-export


def to_torch(arr):
    """NDArray (or array-like) -> torch.Tensor on the array's device,
    sharing its memory, detached from the tape."""
    if isinstance(arr, NDArray):
        return arr._data.detach()
    return NDArray(arr)._data


def from_torch(tensor):
    """torch.Tensor -> NDArray on the tensor's device, sharing its memory
    (int64 and float64 narrow to 32 bits, as every NDArray does)."""
    return NDArray(tensor.detach())
