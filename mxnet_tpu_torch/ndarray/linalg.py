"""mx.nd.linalg (port of `mxnet_tpu/ndarray/linalg.py`): the
`linalg_*` ops under their names without the prefix."""
from ..ops import registry as _registry
from .ndarray import make_nd_func

for _name in ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm",
              "sumlogdiag", "syrk", "gelqf", "syevd"):
    globals()[_name] = make_nd_func(_registry.get("linalg_" + _name))
    globals()[_name].__name__ = _name
del _name
