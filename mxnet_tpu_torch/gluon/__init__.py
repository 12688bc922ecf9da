"""Gluon, the imperative high-level API (port of `mxnet_tpu/gluon/`):
Parameter and Constant, Block / HybridBlock (hybridize, export) and
SymbolBlock, the `nn` layers, the recurrent layers and cells (`rnn`), the
losses, the model zoo, the single-process Trainer, `data`, `contrib` and
`utils`."""
from .parameter import (Parameter, Constant, ParameterDict,
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock
from .trainer import Trainer
from . import nn
from . import data
from . import rnn
from . import loss
from . import model_zoo
from . import utils
from . import contrib
from .utils import split_and_load, split_data
