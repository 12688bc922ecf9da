"""Gluon contrib (port of `mxnet_tpu/gluon/contrib/`): the concurrent
containers, the experimental recurrent cells and the language-model
datasets."""
from .nn import Concurrent, HybridConcurrent, Identity
from . import nn
from . import rnn
from . import data
