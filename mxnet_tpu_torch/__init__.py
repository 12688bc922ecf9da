"""mxnet_tpu_torch: the PyTorch/CUDA port of `mxnet_tpu`, for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module
names and imports `torch` and numpy only (never `jax`, never
`mxnet_tpu`). Entry points run on the card unless the caller asks for the
CPU (`device="cpu"`, or `with mx.cpu():` for the framework core). Every
TPU kernel the ported paths run has a hand-written Hopper kernel here
(`ops/csrc/`), with a plain PyTorch version beside it that the CPU tests
use and the card checks compare against.

Ported so far: the transformer LM served through the paged KV-cache
engine (`models.transformer`, `serving`), on the paged-attention kernel
(`ops.paged_attention`), and trained with single-device SGD
(`models.lm_loss`, `models.make_transformer_train_step`), on the flash
attention forward and backward kernels (`ops.flash_attention`); and the
imperative framework core (`nd`, `autograd`, `init`, `gluon`,
`optimizer`, `parallel.TrainStep`) training the model zoo's ResNets, on
the fused BatchNorm / ReLU / residual kernels (`ops.fused_bn`).
"""
from .base import MXNetError, resolve_device
from .context import Context, cpu, current_context, gpu, num_gpus
from . import autograd
from . import initializer
from . import initializer as init
from . import name
from . import ndarray
from . import ndarray as nd
from .ndarray import NDArray
from . import optimizer
from . import gluon

__all__ = ["MXNetError", "resolve_device", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "autograd", "initializer", "init",
           "name", "ndarray", "nd", "NDArray", "optimizer", "gluon"]
