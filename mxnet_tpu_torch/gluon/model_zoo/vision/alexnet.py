"""AlexNet (port of `mxnet_tpu/gluon/model_zoo/vision/alexnet.py`).

The architecture is the reference Gluon model zoo's, unchanged, over the
port's layers, so parameter names (`alexnet0_conv0_weight`, ...) and
checkpoints carry across.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                            padding=2, activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Flatten())
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_params(get_model_file("alexnet", root=root), ctx=ctx)
    return net
