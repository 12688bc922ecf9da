"""mx.contrib (port of `mxnet_tpu/contrib/`): the `ndarray` and `symbol`
contrib namespaces and int8 `quantization` (`quantize_model`). Text,
ONNX, TensorBoard, io and the autograd helpers are listed in ROADMAP.md,
queue 1."""
from . import ndarray
from . import quantization
from . import symbol
