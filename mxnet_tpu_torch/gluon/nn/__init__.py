"""Gluon neural-network layers (port of `mxnet_tpu/gluon/nn/`)."""
from .basic_layers import (Sequential, HybridSequential, Dense, Activation,
                           Dropout, BatchNorm, Embedding, Flatten, LayerNorm,
                           InstanceNorm, Lambda, HybridLambda, LeakyReLU,
                           PReLU, ELU, SELU, Swish, GELU)
from .conv_layers import (Conv1D, Conv2D, Conv3D, Conv1DTranspose,
                          Conv2DTranspose, Conv3DTranspose, MaxPool1D,
                          MaxPool2D, MaxPool3D, AvgPool1D, AvgPool2D,
                          AvgPool3D, GlobalMaxPool1D, GlobalMaxPool2D,
                          GlobalMaxPool3D, GlobalAvgPool1D, GlobalAvgPool2D,
                          GlobalAvgPool3D, ReflectionPad2D)
