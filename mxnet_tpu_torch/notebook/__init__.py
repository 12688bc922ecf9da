"""Notebook helpers (port of `mxnet_tpu/notebook/`)."""
from . import callback  # noqa: F401
