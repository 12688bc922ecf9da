"""Convolution and pooling Gluon layers (port of
`mxnet_tpu/gluon/nn/conv_layers.py`): Conv1D/2D/3D, the transposed
convolutions Conv1D/2D/3DTranspose (the Deconvolution op), the max and
average pools in 1-3 dimensions and their global forms, and
ReflectionPad2D, with the reference's defaults (`count_include_pad`
True, `ceil_mode` False, channels-first layouts).
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
    """A convolution (op "Convolution", weight (O, I / groups, *k), or
    (O, *k, I) channels-last) or a transposed one (op "Deconvolution",
    weight (I, O / groups, *k), with `adj` its output padding)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        self._act_type = activation
        self._channels_last = layout in _CHANNELS_LAST
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=self._weight_shape(in_channels),
                init=_init(weight_initializer), allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    "bias", shape=(channels,), init=_init(bias_initializer),
                    allow_deferred_init=True)
            else:
                self.bias = None

    def _weight_shape(self, cin):
        """The weight's shape for `cin` input channels (0: deferred)."""
        g = self._kwargs["num_group"]
        k = tuple(self._kwargs["kernel"])
        if self._op_name == "Deconvolution":
            return (cin, self._channels // g) + k
        if self._channels_last:
            return (self._channels,) + k + (cin // g,)
        return (self._channels, cin // g) + k

    def _shape_probe(self, x, *args):
        cin = x.shape[-1] if self._channels_last else x.shape[1]
        self.weight.shape = self._weight_shape(cin)
        self.weight._finish_deferred_init(self.weight.shape)
        if self.bias is not None and self.bias._deferred_init:
            self.bias._finish_deferred_init(self.bias.shape)

    def hybrid_forward(self, F, x, weight, bias=None):
        out = getattr(F, self._op_name)(x, weight, bias, **self._kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


def _conv_class(name, nd, layout, transposed):
    """Conv{nd}D or Conv{nd}DTranspose with the reference's signature."""
    one = (1,) * nd if nd > 1 else 1
    zero = (0,) * nd if nd > 1 else 0

    if transposed:
        def __init__(self, channels, kernel_size, strides=one, padding=zero,
                     output_padding=zero, dilation=one, groups=1,
                     layout=layout, activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kwargs):
            _Conv.__init__(
                self, channels, _pair(kernel_size, nd), _pair(strides, nd),
                _pair(padding, nd), _pair(dilation, nd), groups, layout,
                in_channels, activation, use_bias, weight_initializer,
                bias_initializer, op_name="Deconvolution",
                adj=_pair(output_padding, nd), **kwargs)
    else:
        def __init__(self, channels, kernel_size, strides=one, padding=zero,
                     dilation=one, groups=1, layout=layout, activation=None,
                     use_bias=True, weight_initializer=None,
                     bias_initializer="zeros", in_channels=0, **kwargs):
            _Conv.__init__(
                self, channels, _pair(kernel_size, nd), _pair(strides, nd),
                _pair(padding, nd), _pair(dilation, nd), groups, layout,
                in_channels, activation, use_bias, weight_initializer,
                bias_initializer, **kwargs)
    return type(name, (_Conv,), {"__init__": __init__})


Conv1D = _conv_class("Conv1D", 1, "NCW", False)
Conv2D = _conv_class("Conv2D", 2, "NCHW", False)
Conv3D = _conv_class("Conv3D", 3, "NCDHW", False)
Conv1DTranspose = _conv_class("Conv1DTranspose", 1, "NCW", True)
Conv2DTranspose = _conv_class("Conv2DTranspose", 2, "NCHW", True)
Conv3DTranspose = _conv_class("Conv3DTranspose", 3, "NCDHW", True)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, count_include_pad=None, layout=None, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "layout": layout,
            "pooling_convention": "full" if ceil_mode else "valid"}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


def _pool_class(name, nd, layout, pool_type):
    """MaxPool{nd}D / AvgPool{nd}D with the reference's defaults (pool 2,
    stride = pool, no padding, no ceil mode; average pools count the
    padding)."""
    if pool_type == "max":
        def __init__(self, pool_size=(2,) * nd if nd > 1 else 2,
                     strides=None, padding=0, layout=layout,
                     ceil_mode=False, **kwargs):
            _Pooling.__init__(
                self, _pair(pool_size, nd),
                _pair(strides, nd) if strides is not None else None,
                _pair(padding, nd), ceil_mode, False, "max", layout=layout,
                **kwargs)
    else:
        def __init__(self, pool_size=(2,) * nd if nd > 1 else 2,
                     strides=None, padding=0, layout=layout,
                     ceil_mode=False, count_include_pad=True, **kwargs):
            _Pooling.__init__(
                self, _pair(pool_size, nd),
                _pair(strides, nd) if strides is not None else None,
                _pair(padding, nd), ceil_mode, False, "avg",
                count_include_pad, layout=layout, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__})


def _global_pool_class(name, nd, layout, pool_type):
    def __init__(self, layout=layout, **kwargs):
        _Pooling.__init__(self, (1,) * nd, None, (0,) * nd, False, True,
                          pool_type, layout=layout, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__})


MaxPool1D = _pool_class("MaxPool1D", 1, "NCW", "max")
MaxPool2D = _pool_class("MaxPool2D", 2, "NCHW", "max")
MaxPool3D = _pool_class("MaxPool3D", 3, "NCDHW", "max")
AvgPool1D = _pool_class("AvgPool1D", 1, "NCW", "avg")
AvgPool2D = _pool_class("AvgPool2D", 2, "NCHW", "avg")
AvgPool3D = _pool_class("AvgPool3D", 3, "NCDHW", "avg")
GlobalMaxPool1D = _global_pool_class("GlobalMaxPool1D", 1, "NCW", "max")
GlobalMaxPool2D = _global_pool_class("GlobalMaxPool2D", 2, "NCHW", "max")
GlobalMaxPool3D = _global_pool_class("GlobalMaxPool3D", 3, "NCDHW", "max")
GlobalAvgPool1D = _global_pool_class("GlobalAvgPool1D", 1, "NCW", "avg")
GlobalAvgPool2D = _global_pool_class("GlobalAvgPool2D", 2, "NCHW", "avg")
GlobalAvgPool3D = _global_pool_class("GlobalAvgPool3D", 3, "NCDHW", "avg")


class ReflectionPad2D(HybridBlock):
    """Pads the two spatial axes of NCHW data by `padding` on each side,
    mirroring the interior (the Pad op's "reflect" mode)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)
