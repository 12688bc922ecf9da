"""The imperative contrib namespace (port of
`mxnet_tpu/contrib/ndarray.py`): `mx.nd.contrib` re-exported."""
from ..ndarray.contrib import *  # noqa: F401,F403
