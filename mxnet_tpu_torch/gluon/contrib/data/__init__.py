"""Contrib data helpers (port of `mxnet_tpu/gluon/contrib/data/`)."""
from ...data.sampler import IntervalSampler
from .text import WikiText2, WikiText103
