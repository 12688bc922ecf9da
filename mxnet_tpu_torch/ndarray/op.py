"""mx.nd.op: the flat op namespace again (port of
`mxnet_tpu/ndarray/op.py`)."""
from . import *  # noqa: F401,F403
