"""Models of the port: the functional transformer LM and its training
step, the word-LM RNN (`RNNModel`), LeNet and the MLP of BASELINE
config 1 (`get_mlp`, `get_lenet`, `LeNet`, `get_resnetish`), SSDLite
(BASELINE config 4), the sparse linear model and the factorization
machine (BASELINE config 5: `SparseLinear`, `FactorizationMachine`), and
the
weight converters from the JAX reference (the Gluon model zoo's
families are `gluon.model_zoo.vision`)."""
from .transformer import (TransformerConfig, gather_transformer_params,
                          init_transformer_params, lm_loss,
                          shard_transformer_params, transformer_apply,
                          transformer_shardings)
from .transformer import make_train_step as make_transformer_train_step
from .convert import (gluon_params_from_numpy, module_params_from_numpy,
                      params_from_numpy)
from .lenet import LeNet, get_lenet, get_mlp, get_resnetish
from .word_lm import RNNModel
from .ssd import SSDLite
from .sparse_linear import SparseLinear
from .fm import FactorizationMachine

__all__ = ["TransformerConfig", "init_transformer_params",
           "transformer_apply", "lm_loss", "make_transformer_train_step",
           "transformer_shardings", "shard_transformer_params",
           "gather_transformer_params",
           "params_from_numpy", "gluon_params_from_numpy",
           "module_params_from_numpy", "RNNModel", "LeNet", "get_lenet",
           "get_mlp", "get_resnetish", "SSDLite", "SparseLinear",
           "FactorizationMachine"]
