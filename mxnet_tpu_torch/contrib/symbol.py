"""The symbolic contrib namespace (port of
`mxnet_tpu/contrib/symbol.py`): `mx.sym.contrib`'s names."""
from ..symbol import contrib as _contrib_ns


def __getattr__(name):
    return getattr(_contrib_ns, name)
