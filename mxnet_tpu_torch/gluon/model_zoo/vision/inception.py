"""Inception V3 (port of `mxnet_tpu/gluon/model_zoo/vision/inception.py`).

The architecture is the reference Gluon model zoo's, unchanged, over the
port's layers, so parameter names (`inception30_A1_conv0_weight`, ...)
and checkpoints carry across. Its 94 BatchNorm layers (epsilon 1e-3, each
followed by its own ReLU) reach the fused K3 kernels under
MXNET_FUSED_BN_EPILOGUE=1 in training; at 299x299 most of them see an odd
spatial size (35x35, 17x17, 8x8). `_Concurrent` concatenates its branches
through `hybrid_forward`, so a hybridized net traces each into one Concat
node.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {}
        for i, value in enumerate(setting):
            if value is not None:
                kwargs[setting_names[i]] = value
        out.add(_make_basic_conv(**kwargs))
    return out


class _Concurrent(HybridBlock):
    """Concatenating parallel branches (gluon.contrib HybridConcurrent)."""

    def __init__(self, axis=1, **kwargs):
        super().__init__(**kwargs)
        self.axis = axis

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._children.values()]
        return F.Concat(*out, dim=self.axis)


def _make_A(pool_features, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (64, 1, None, None)))
        out.add(_make_branch(None, (48, 1, None, None), (64, 5, None, 2)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, None, 1)))
        out.add(_make_branch("avg", (pool_features, 1, None, None)))
    return out


def _make_B(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (384, 3, 2, None)))
        out.add(_make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                             (96, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


def _make_C(channels_7x7, prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None)))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


def _make_D(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (192, 1, None, None), (320, 3, 2, None)))
        out.add(_make_branch(None, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max"))
    return out


class _BranchE2(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.stem = _make_basic_conv(channels=384, kernel_size=1)
        self.a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                  padding=(0, 1))
        self.b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                  padding=(1, 0))

    def hybrid_forward(self, F, x):
        x = self.stem(x)
        return F.Concat(self.a(x), self.b(x), dim=1)


class _BranchE3(HybridBlock):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.stem = nn.HybridSequential(prefix="")
        self.stem.add(_make_basic_conv(channels=448, kernel_size=1))
        self.stem.add(_make_basic_conv(channels=384, kernel_size=3, padding=1))
        self.a = _make_basic_conv(channels=384, kernel_size=(1, 3),
                                  padding=(0, 1))
        self.b = _make_basic_conv(channels=384, kernel_size=(3, 1),
                                  padding=(1, 0))

    def hybrid_forward(self, F, x):
        x = self.stem(x)
        return F.Concat(self.a(x), self.b(x), dim=1)


def _make_E(prefix):
    out = _Concurrent(prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, (320, 1, None, None)))
        out.add(_BranchE2())
        out.add(_BranchE3())
        out.add(_make_branch("avg", (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                               strides=2))
            self.features.add(_make_basic_conv(channels=32, kernel_size=3))
            self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                               padding=1))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_basic_conv(channels=80, kernel_size=1))
            self.features.add(_make_basic_conv(channels=192, kernel_size=3))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
            self.features.add(_make_A(32, "A1_"))
            self.features.add(_make_A(64, "A2_"))
            self.features.add(_make_A(64, "A3_"))
            self.features.add(_make_B("B_"))
            self.features.add(_make_C(128, "C1_"))
            self.features.add(_make_C(160, "C2_"))
            self.features.add(_make_C(160, "C3_"))
            self.features.add(_make_C(192, "C4_"))
            self.features.add(_make_D("D_"))
            self.features.add(_make_E("E1_"))
            self.features.add(_make_E("E2_"))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_params(get_model_file("inceptionv3", root=root), ctx=ctx)
    return net
