"""Gluon, the imperative high-level API (port of `mxnet_tpu/gluon/`):
Parameter, Block / HybridBlock, the ResNet and word-LM paths' layers, the
fused recurrent layers (`rnn`), losses, the model zoo's ResNets, the
single-process Trainer and `utils`. Not ported yet: data, contrib, the
rnn cells, SymbolBlock and Constant (ROADMAP.md, queue 1)."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock
from .trainer import Trainer
from . import nn
from . import rnn
from . import loss
from . import model_zoo
from . import utils
from .utils import split_and_load, split_data
