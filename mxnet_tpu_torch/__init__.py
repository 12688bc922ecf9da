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
`optimizer`, `parallel.TrainStep`) training the model zoo's nets, on
the fused BatchNorm / ReLU / residual kernels (`ops.fused_bn`); and the
word-LM LSTM (`models.RNNModel` over `gluon.rnn`, `gluon.Trainer`, the
stochastic ops and `random`) on the persistent fused-RNN kernels
(`ops.fused_rnn`); and BASELINE config 1, LeNet and the MLP on MNIST,
through the symbolic stack (`sym`, the executor, `mod.Module`, `io`,
`metric`, `kv`, `callback`, `lr_scheduler`, `model`) and through Gluon
with `gluon.data`; an executor's training-mode BatchNorm reaches the
fused BatchNorm kernels as the imperative one does; and the symbolic
RNN workflow (`rnn`: the cells, `BucketSentenceIter`; `mod.BucketingModule`,
`SequentialModule`, `PythonModule`, `monitor`, `executor_manager`), whose
`FusedRNNCell` reaches the fused-RNN kernels through the executor; and
the rest of Gluon (the model zoo's other families, the remaining layers,
losses and recurrent cells, `gluon.contrib`), whose BatchNorms reach the
fused BatchNorm kernels eagerly and hybridized; and the rest of the
dense op library with its namespaces (`nd.linalg`, `nd.contrib`,
`sym.random`, `sym.linalg`, `sym.contrib`, `contrib.ndarray` /
`contrib.symbol`), whose `_contrib_PagedAttention` reaches the
paged-attention kernel from the op registry; and distributed training
on torch.distributed, one process a rank (`parallel`: the mesh, the
collectives, ring attention, GPipe, `TrainStep`'s mesh options; the
transformer's dp / tp / sp / ep step; the `tpu` / `nccl` / `dist_*`
kvstores, `gluon.Trainer(kvstore=)`, `Module(mesh=)`); and deployment
(`predict`: `Predictor`, `export_model` / `load_exported` on
torch.export, whose graphs keep the fused-RNN forward as the op
`mxnet_tpu_torch::rnn_fwd`; `rtc.CudaModule`, user CUDA kernels compiled
by NVRTC; `plugin.TorchBlock`; `torch`; `contrib.onnx`; `engine`,
`libinfo`, `log`, `misc`).
"""
from .libinfo import __version__  # single-sourced version
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
from . import random
from .random import seed
from . import attribute
from .attribute import AttrScope
from . import symbol
from . import symbol as sym
from .symbol import Symbol
from . import executor
from . import lr_scheduler
from . import metric
from . import kvstore
from . import kvstore as kv
from . import io
from . import recordio
from . import image
from . import gluon
from . import model
from .model import FeedForward
from . import symbol_doc
from . import module
from . import module as mod
from . import callback
from . import executor_manager
from . import monitor
from . import monitor as mon
from . import rnn
from . import models
from . import test_utils
from . import profiler
from . import utils
from . import visualization
from . import contrib
from . import operator
from .operator import CustomOp, CustomOpProp
from . import engine
from . import libinfo
from . import log
from . import misc
from . import plugin
from . import rtc
from . import predict
from .predict import Predictor

__all__ = ["MXNetError", "resolve_device", "Context", "cpu", "gpu",
           "current_context", "num_gpus", "autograd", "initializer", "init",
           "name", "ndarray", "nd", "NDArray", "optimizer", "random", "seed",
           "attribute", "AttrScope", "symbol", "sym", "Symbol", "executor",
           "lr_scheduler", "metric", "kvstore", "kv", "io", "gluon",
           "model", "FeedForward", "symbol_doc", "module", "mod",
           "callback", "executor_manager", "monitor", "mon", "rnn",
           "models", "test_utils", "profiler", "utils", "visualization",
           "contrib", "recordio", "image", "operator", "CustomOp",
           "CustomOpProp", "engine", "libinfo", "log", "misc", "plugin",
           "rtc", "predict", "Predictor", "__version__"]
