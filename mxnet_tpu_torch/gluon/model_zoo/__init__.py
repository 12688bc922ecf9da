"""Gluon model zoo (port of `mxnet_tpu/gluon/model_zoo/`): the vision
families and `model_store`, which resolves `pretrained=True` to a local
parameter file."""
from . import vision
from . import model_store
from .vision import get_model
