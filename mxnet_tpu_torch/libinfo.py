"""Library and version info (port of `mxnet_tpu/libinfo.py`; parity:
python/mxnet/libinfo.py — find_lib_path + __version__). The port's
libraries are the kernels' shared objects, built by `ops/_cuda.py` under
`mxnet_tpu_torch/_build/` at first use."""
from __future__ import annotations

import glob
import os

# the single source of the version string; mxnet_tpu_torch/__init__
# imports it from here, as the reference's does
__version__ = "0.1.0"


def find_lib_path():
    """The built kernel libraries (`_build/*.so`); [] before any kernel
    was built (the port builds on the card, at first use)."""
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
    return sorted(glob.glob(os.path.join(build, "*.so")))
