"""mx.contrib (port of `mxnet_tpu/contrib/`): the `ndarray` and `symbol`
contrib namespaces. Quantization, text, ONNX, TensorBoard, io and the
autograd helpers are listed in ROADMAP.md, queue 1."""
from . import ndarray
from . import symbol
