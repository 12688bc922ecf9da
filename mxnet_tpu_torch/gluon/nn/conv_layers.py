"""Convolution and pooling Gluon layers of the ResNet path (port of the
matching share of `mxnet_tpu/gluon/nn/conv_layers.py`): Conv2D, MaxPool2D
and GlobalAvgPool2D. Not ported yet: AvgPool2D, GlobalMaxPool2D, the 1-D
and 3-D layers, the transposed convolutions and ReflectionPad2D
(ROADMAP.md, queue 1).
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import _init

_CHANNELS_LAST = ("NWC", "NHWC", "NDHWC")


def _pair(v, n):
    if isinstance(v, (tuple, list)):
        return tuple(v)
    return (v,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self._act_type = activation
        self._channels_last = layout in _CHANNELS_LAST
        with self.name_scope():
            cin = in_channels // groups if in_channels else 0
            # channels-last stores the weight as (O, *k, I)
            wshape = (channels,) + kernel_size + (cin,) \
                if self._channels_last else (channels, cin) + kernel_size
            self.weight = self.params.get(
                "weight", shape=wshape, init=_init(weight_initializer),
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=_init(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None

    def _shape_probe(self, x, *args):
        cin = x.shape[-1] if self._channels_last else x.shape[1]
        g = self._kwargs["num_group"]
        k = tuple(self._kwargs["kernel"])
        self.weight.shape = (self._channels,) + k + (cin // g,) \
            if self._channels_last else (self._channels, cin // g) + k
        self.weight._finish_deferred_init(self.weight.shape)
        if self.bias is not None and self.bias._deferred_init:
            self.bias._finish_deferred_init(self.bias.shape)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.Convolution(x, weight, bias, **self._kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(channels, _pair(kernel_size, 2), _pair(strides, 2),
                         _pair(padding, 2), _pair(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "layout": layout,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        super().__init__(_pair(pool_size, 2),
                         _pair(strides, 2) if strides is not None else None,
                         _pair(padding, 2), ceil_mode, False, "max",
                         layout=layout, **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, "avg",
                         layout=layout, **kwargs)
