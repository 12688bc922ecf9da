"""Gluon, the imperative high-level API (port of `mxnet_tpu/gluon/`):
Parameter, Block / HybridBlock, the ResNet path's layers, losses and the
model zoo's ResNets. Not ported yet: Trainer, rnn, data, utils, contrib,
SymbolBlock and Constant (ROADMAP.md, queue 1)."""
from .parameter import Parameter, ParameterDict, DeferredInitializationError
from .block import Block, HybridBlock
from . import nn
from . import loss
from . import model_zoo
