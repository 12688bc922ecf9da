"""Gluon neural-network layers of the ResNet path (port of
`mxnet_tpu/gluon/nn/`)."""
from .basic_layers import (Sequential, HybridSequential, Dense, Activation,
                           BatchNorm, Flatten)
from .conv_layers import Conv2D, MaxPool2D, GlobalAvgPool2D
