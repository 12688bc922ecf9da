"""Gluon model zoo (port of `mxnet_tpu/gluon/model_zoo/`: the ResNets;
`pretrained=True` waits for model_store)."""
from . import vision
from .vision import get_model
