"""Plugin bridges (port of `mxnet_tpu/plugin/`; parity: the reference's
`plugin/` — caffe/torch op bridges, `plugin/torch/torch_module.cc`). The
torch bridge is the one provided: `TorchBlock` runs a torch.nn.Module as
a Gluon block."""
from . import torch_module  # noqa: F401
from .torch_module import TorchBlock  # noqa: F401
