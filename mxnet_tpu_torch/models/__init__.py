"""Models of the port: the functional transformer LM and its training
step, and the weight converters from the JAX reference (the Gluon model
zoo's ResNets are `gluon.model_zoo.vision`)."""
from .transformer import (TransformerConfig, init_transformer_params,
                          lm_loss, transformer_apply)
from .transformer import make_train_step as make_transformer_train_step
from .convert import gluon_params_from_numpy, params_from_numpy

__all__ = ["TransformerConfig", "init_transformer_params",
           "transformer_apply", "lm_loss", "make_transformer_train_step",
           "params_from_numpy", "gluon_params_from_numpy"]
