"""mx.contrib (port of `mxnet_tpu/contrib/`): int8 `quantization`
(`quantize_model`), the legacy `autograd` helpers, `onnx` import,
`tensorboard` logging, `text` (vocabularies and token embeddings), `io`
(`DataLoaderIter`), and the `ndarray` and `symbol` contrib namespaces."""
from . import quantization
from . import autograd
from . import onnx
from . import tensorboard
from . import text
from . import io
from . import ndarray
from . import symbol
