"""ONNX graph -> symbol DAG translation (port of
`mxnet_tpu/contrib/onnx/importer.py`, onto the port's Symbol).

Parity: reference ``python/mxnet/contrib/onnx/_import`` (import_model.py,
import_onnx.py GraphProto, op_translations.py). Redesigned: the reference
leans on the onnx python package; here the model file is decoded with the
wire-level codec in ``wire.py`` and translated straight into the native
Symbol DAG, so ONNX import works with zero extra dependencies.

Supported op set matches the reference's ``_convert_map``
(import_helper.py:38-100): generators (Constant, RandomUniform/Normal[Like]),
arithmetic (Add/Sub/Mul/Div/Sum/Abs/Neg/Ceil/Floor/Max/Min), NN (Conv,
ConvTranspose, BatchNormalization/SpatialBN, FC/Gemm/MatMul, LRN, Pad,
pooling incl. global, Relu/Sigmoid/Tanh/LeakyRelu/Elu/PRelu, Softmax,
Dropout), shape/type (Reshape, Cast, Split, Slice, Transpose, Squeeze,
Flatten, Concat, Identity), powers (Reciprocal/Sqrt/Pow/Exp/Log), reductions
(ReduceMax/Mean/Min/Sum/Prod), search (ArgMax/ArgMin).
"""
from __future__ import annotations

import struct

import numpy as np

from . import wire


# onnx.proto3 TensorProto.DataType values
_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 9: np.bool_,
           10: np.float16, 11: np.float64}


class _Tensor:
    """Decoded TensorProto."""

    def __init__(self, buf):
        g = wire.collect(buf)
        self.name = wire.first_str(g, 8)
        self.dims = tuple(wire.ints(g, 1))
        code = wire.first_int(g, 2, 1)
        if code not in _DTYPES:
            raise ValueError("unsupported ONNX tensor dtype code %d" % code)
        dtype = _DTYPES[code]
        raw = wire.first_bytes(g, 9)
        if raw:
            arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder("<"))
        elif code == 1:
            arr = np.asarray(wire.floats(g, 4), dtype=np.float32)
        elif code == 7:
            arr = np.asarray([wire.signed(v) for v in wire.ints(g, 7)],
                             dtype=np.int64)
        elif code == 6:
            arr = np.asarray([wire.signed(v, 32) for v in wire.ints(g, 5)],
                             dtype=np.int32)
        elif int(np.prod(self.dims)) == 0:
            arr = np.zeros(self.dims, dtype=dtype)
        else:
            raise NotImplementedError(
                "tensor %r: typed (non-raw_data) storage for dtype code %d "
                "is not supported" % (self.name, code))
        self.array = np.asarray(arr, dtype=dtype).reshape(self.dims)


class _Attr:
    """Decoded AttributeProto (value exposed by kind)."""

    def __init__(self, buf):
        g = wire.collect(buf)
        self.name = wire.first_str(g, 1)
        kind = wire.first_int(g, 20, 0)
        if kind == 1:      # FLOAT
            self.value = struct.unpack(
                "<f", wire.first_int(g, 2).to_bytes(4, "little"))[0]
        elif kind == 2:    # INT
            self.value = wire.signed(wire.first_int(g, 3))
        elif kind == 3:    # STRING
            self.value = wire.first_str(g, 4)
        elif kind == 4:    # TENSOR
            self.value = _Tensor(wire.first_bytes(g, 5)).array
        elif kind == 6:    # FLOATS
            self.value = wire.floats(g, 7)
        elif kind == 7:    # INTS
            self.value = [wire.signed(v) for v in wire.ints(g, 8)]
        else:
            self.value = None


class _Node:
    """Decoded NodeProto."""

    def __init__(self, buf):
        g = wire.collect(buf)
        self.inputs = [bytes(b).decode() for b in wire.submessages(g, 1)]
        self.outputs = [bytes(b).decode() for b in wire.submessages(g, 2)]
        self.name = wire.first_str(g, 3)
        self.op_type = wire.first_str(g, 4)
        self.attrs = {a.name: a.value
                      for a in (_Attr(b) for b in wire.submessages(g, 5))}


def _value_info(buf):
    """ValueInfoProto -> (name, shape tuple with 0 for symbolic dims)."""
    g = wire.collect(buf)
    name = wire.first_str(g, 1)
    shape = ()
    type_g = g.get(2)
    if type_g:
        tt = wire.collect(type_g[0][1])
        tensor = tt.get(1)
        if tensor:
            tg = wire.collect(tensor[0][1])
            shp = tg.get(2)
            if shp:
                dims = []
                for dim_buf in wire.submessages(wire.collect(shp[0][1]), 1):
                    dims.append(wire.first_int(wire.collect(dim_buf), 1, 0))
                shape = tuple(dims)
    return name, shape


class OnnxModel:
    """Decoded ModelProto: nodes, initializers, graph inputs/outputs."""

    def __init__(self, data):
        top = wire.collect(data)
        graphs = wire.submessages(top, 7)
        if not graphs:
            raise ValueError("not an ONNX ModelProto (no graph field)")
        self.opset = 1
        for op_buf in wire.submessages(top, 8):
            og = wire.collect(op_buf)
            if wire.first_str(og, 1) == "":  # default (ai.onnx) domain
                self.opset = wire.first_int(og, 2, 1)
        g = wire.collect(graphs[0])
        self.name = wire.first_str(g, 2)
        self.nodes = [_Node(b) for b in wire.submessages(g, 1)]
        self.initializers = {t.name: t.array for t in
                             (_Tensor(b) for b in wire.submessages(g, 5))}
        self.inputs = [_value_info(b) for b in wire.submessages(g, 11)]
        self.outputs = [_value_info(b) for b in wire.submessages(g, 12)]


# -- translation ------------------------------------------------------------


class _Graph:
    """Translation state: ONNX tensor name -> Symbol, plus param arrays."""

    def __init__(self, model):
        from ... import symbol as sym
        self.sym = sym
        self.model = model
        self.tensors = {}
        self.arg_params = {}
        self.aux_params = {}
        init = model.initializers
        for name, shape in model.inputs:
            if name not in init:
                self.tensors[name] = sym.Variable(
                    name, shape=tuple(int(d) for d in shape) or None)

    def symbol_of(self, name, aux=False):
        """The Symbol carrying ONNX tensor `name`; initializers become
        parameter Variables on first use."""
        if name not in self.tensors:
            arr = self.model.initializers[name]
            v = self.sym.Variable(name, shape=arr.shape)
            store = self.aux_params if aux else self.arg_params
            store[name] = np.asarray(arr)
            self.tensors[name] = v
        return self.tensors[name]

    def const_of(self, name):
        """The static value of an initializer input (e.g. Reshape shape)."""
        if name not in self.model.initializers:
            raise ValueError(
                "input %r must be a constant initializer for this op" % name)
        return self.model.initializers[name]

    def new_param(self, name, array):
        """Bind a transformed parameter array under `name` (or a derived
        unique name if `name` is already taken by another consumer)."""
        unique = name
        n = 0
        while unique in self.tensors or unique in self.arg_params:
            n += 1
            unique = "%s_%d" % (name, n)
        v = self.sym.Variable(unique, shape=array.shape)
        self.arg_params[unique] = np.asarray(array)
        # do NOT record in self.tensors: the original ONNX tensor name must
        # keep resolving to the untransformed initializer for other nodes
        return v


_TRANSLATORS = {}


def _translates(*op_types):
    def deco(fn):
        for t in op_types:
            _TRANSLATORS[t] = fn
        return fn
    return deco


def _conv_geometry(attrs, spatial_rank):
    auto_pad = attrs.get("auto_pad", "NOTSET")
    if auto_pad not in ("NOTSET", ""):
        raise NotImplementedError(
            "auto_pad=%r is not supported; export with explicit pads"
            % auto_pad)
    if attrs.get("ceil_mode", 0):
        raise NotImplementedError("ceil_mode=1 is not supported")
    kernel = tuple(attrs["kernel_shape"])
    stride = tuple(attrs.get("strides", (1,) * spatial_rank))
    dilate = tuple(attrs.get("dilations", (1,) * spatial_rank))
    pads = tuple(attrs.get("pads", (0,) * (2 * spatial_rank)))
    begin, end = pads[:spatial_rank], pads[spatial_rank:]
    if begin != end:
        raise NotImplementedError(
            "asymmetric ONNX pads %s are not supported" % (pads,))
    return kernel, stride, dilate, begin


@_translates("Conv")
def _conv(g, node):
    data = g.symbol_of(node.inputs[0])
    weight = g.symbol_of(node.inputs[1])
    w_arr = g.model.initializers.get(node.inputs[1])
    if w_arr is None:
        raise NotImplementedError("Conv weights must be initializers")
    kernel, stride, dilate, pad = _conv_geometry(node.attrs, w_arr.ndim - 2)
    kwargs = dict(kernel=kernel, stride=stride, dilate=dilate, pad=pad,
                  num_filter=int(w_arr.shape[0]),
                  num_group=int(node.attrs.get("group", 1)),
                  weight=weight, name=node.name or None)
    if len(node.inputs) > 2:
        kwargs["bias"] = g.symbol_of(node.inputs[2])
    else:
        kwargs["no_bias"] = True
    return g.sym.Convolution(data, **kwargs)


@_translates("BatchNormalization", "SpatialBN")  # SpatialBN: deprecated alias
def _batchnorm(g, node):
    return g.sym.BatchNorm(
        g.symbol_of(node.inputs[0]),
        gamma=g.symbol_of(node.inputs[1]),
        beta=g.symbol_of(node.inputs[2]),
        moving_mean=g.symbol_of(node.inputs[3], aux=True),
        moving_var=g.symbol_of(node.inputs[4], aux=True),
        eps=float(node.attrs.get("epsilon", 1e-5)),
        momentum=float(node.attrs.get("momentum", 0.9)),
        fix_gamma=False, name=node.name or None)


@_translates("Relu", "Sigmoid", "Tanh")
def _activation(g, node):
    act = {"Relu": "relu", "Sigmoid": "sigmoid", "Tanh": "tanh"}
    return g.sym.Activation(g.symbol_of(node.inputs[0]),
                            act_type=act[node.op_type],
                            name=node.name or None)


@_translates("LeakyRelu")
def _leaky(g, node):
    return g.sym.LeakyReLU(g.symbol_of(node.inputs[0]), act_type="leaky",
                           slope=float(node.attrs.get("alpha", 0.01)),
                           name=node.name or None)


@_translates("MaxPool", "AveragePool")
def _pool(g, node):
    kernel, stride, _, pad = _conv_geometry(
        node.attrs, len(node.attrs["kernel_shape"]))
    return g.sym.Pooling(
        g.symbol_of(node.inputs[0]), kernel=kernel, stride=stride, pad=pad,
        pool_type="max" if node.op_type == "MaxPool" else "avg",
        count_include_pad=bool(node.attrs.get("count_include_pad", 0)),
        name=node.name or None)


@_translates("GlobalAveragePool", "GlobalMaxPool")
def _global_pool(g, node):
    return g.sym.Pooling(
        g.symbol_of(node.inputs[0]), global_pool=True, kernel=(1, 1),
        pool_type="avg" if "Average" in node.op_type else "max",
        name=node.name or None)


@_translates("Gemm")
def _gemm(g, node):
    if node.attrs.get("transA", 0):
        raise NotImplementedError("Gemm with transA=1")
    alpha = float(node.attrs.get("alpha", 1.0))
    beta = float(node.attrs.get("beta", 1.0))
    w = np.asarray(g.const_of(node.inputs[1]), dtype=np.float32)
    if not node.attrs.get("transB", 0):
        w = w.T
    w = np.ascontiguousarray(alpha * w)  # FC expects (out, in)
    kwargs = dict(weight=g.new_param(node.inputs[1], w),
                  num_hidden=int(w.shape[0]), name=node.name or None)
    if len(node.inputs) > 2:
        b = beta * np.asarray(g.const_of(node.inputs[2]),
                              dtype=np.float32).reshape(-1)
        kwargs["bias"] = g.new_param(node.inputs[2], b)
    else:
        kwargs["no_bias"] = True
    return g.sym.FullyConnected(g.symbol_of(node.inputs[0]), **kwargs)


@_translates("MatMul")
def _matmul(g, node):
    return g.sym.dot(g.symbol_of(node.inputs[0]),
                     g.symbol_of(node.inputs[1]), name=node.name or None)


@_translates("Reshape")
def _reshape(g, node):
    if len(node.inputs) > 1:             # opset >= 5: shape is an input
        shape = tuple(int(v) for v in g.const_of(node.inputs[1]))
    else:                                # opset < 5: shape attribute
        shape = tuple(int(v) for v in node.attrs["shape"])
    return g.sym.Reshape(g.symbol_of(node.inputs[0]), shape=shape,
                         name=node.name or None)


@_translates("Transpose")
def _transpose(g, node):
    axes = node.attrs.get("perm")
    kwargs = {"axes": tuple(axes)} if axes else {}
    return g.sym.transpose(g.symbol_of(node.inputs[0]),
                           name=node.name or None, **kwargs)


@_translates("Concat")
def _concat(g, node):
    parts = [g.symbol_of(i) for i in node.inputs]
    return g.sym.Concat(*parts, dim=int(node.attrs.get("axis", 1)),
                        name=node.name or None)


@_translates("Add", "Sum")
def _add(g, node):
    return _fold_broadcast(g, node, "broadcast_add")


@_translates("Mul")
def _mul(g, node):
    return _fold_broadcast(g, node, "broadcast_mul")


@_translates("Flatten")
def _flatten(g, node):
    if int(node.attrs.get("axis", 1)) != 1:
        raise NotImplementedError("Flatten with axis != 1")
    return g.sym.Flatten(g.symbol_of(node.inputs[0]), name=node.name or None)


@_translates("Softmax")
def _softmax(g, node):
    data = g.symbol_of(node.inputs[0])
    if g.model.opset >= 13:
        return g.sym.softmax(data, axis=int(node.attrs.get("axis", -1)),
                             name=node.name or None)
    # opset < 13: softmax is defined on the input COERCED to 2-D at `axis`
    # (default 1) — normalize over everything from `axis` on, jointly
    axis = int(node.attrs.get("axis", 1))
    if axis == -1:  # coercion at the last axis == plain last-axis softmax
        return g.sym.softmax(data, axis=-1, name=node.name or None)
    if axis < 0:
        raise NotImplementedError(
            "Softmax axis < -1 on opset<13 needs the input rank; "
            "re-export with a non-negative axis or opset>=13")
    flat = g.sym.Reshape(data, shape=(0,) * axis + (-1,))
    return g.sym.reshape_like(g.sym.softmax(flat, axis=-1), data)


@_translates("Dropout", "Identity")
def _identity(g, node):
    # Dropout at inference is identity; training-mode import re-applies it
    return g.sym.identity(g.symbol_of(node.inputs[0]))


# -- generators -------------------------------------------------------------


@_translates("Constant")
def _constant(g, node):
    arr = node.attrs.get("value")
    if arr is None:
        raise NotImplementedError(
            "Constant without a `value` tensor attribute")
    # also visible to const_of() consumers (Reshape shapes etc.)
    g.model.initializers.setdefault(node.outputs[0], np.asarray(arr))
    return g.new_param(node.name or node.outputs[0], np.asarray(arr))


def _like_shape(g, name):
    """Static shape of ONNX tensor `name` for the Random*Like ops."""
    if name in g.model.initializers:
        return g.model.initializers[name].shape
    for n, shape in g.model.inputs:
        if n == name and shape and all(int(d) > 0 for d in shape):
            return tuple(int(d) for d in shape)
    raise NotImplementedError(
        "Random*Like needs a static shape for %r (initializer or typed "
        "graph input)" % name)


@_translates("RandomUniform", "RandomUniformLike")
def _random_uniform(g, node):
    shape = (tuple(node.attrs["shape"]) if "Like" not in node.op_type
             else _like_shape(g, node.inputs[0]))
    return g.sym.uniform(low=float(node.attrs.get("low", 0.0)),
                         high=float(node.attrs.get("high", 1.0)),
                         shape=shape, name=node.name or None)


@_translates("RandomNormal", "RandomNormalLike")
def _random_normal(g, node):
    shape = (tuple(node.attrs["shape"]) if "Like" not in node.op_type
             else _like_shape(g, node.inputs[0]))
    return g.sym.normal(loc=float(node.attrs.get("mean", 0.0)),
                        scale=float(node.attrs.get("scale", 1.0)),
                        shape=shape, name=node.name or None)


# -- arithmetic / elementwise -----------------------------------------------


def _fold_broadcast(g, node, op_name):
    out = g.symbol_of(node.inputs[0])
    fn = getattr(g.sym, op_name)
    for name in node.inputs[1:]:
        out = fn(out, g.symbol_of(name))
    return out


@_translates("Sub")
def _sub(g, node):
    return _fold_broadcast(g, node, "broadcast_sub")


@_translates("Div")
def _div(g, node):
    return _fold_broadcast(g, node, "broadcast_div")


@_translates("Max")
def _elem_max(g, node):
    return _fold_broadcast(g, node, "broadcast_maximum")


@_translates("Min")
def _elem_min(g, node):
    return _fold_broadcast(g, node, "broadcast_minimum")


@_translates("Abs", "Neg", "Ceil", "Floor", "Reciprocal", "Sqrt", "Exp",
             "Log")
def _unary(g, node):
    fn = {"Abs": "abs", "Neg": "negative", "Ceil": "ceil", "Floor": "floor",
          "Reciprocal": "reciprocal", "Sqrt": "sqrt", "Exp": "exp",
          "Log": "log"}[node.op_type]
    return getattr(g.sym, fn)(g.symbol_of(node.inputs[0]),
                              name=node.name or None)


@_translates("Pow")
def _pow(g, node):
    return g.sym.broadcast_power(g.symbol_of(node.inputs[0]),
                                 g.symbol_of(node.inputs[1]),
                                 name=node.name or None)


# -- NN ---------------------------------------------------------------------


@_translates("ConvTranspose")
def _conv_transpose(g, node):
    if "output_shape" in node.attrs:
        raise NotImplementedError(
            "ConvTranspose with output_shape (implicit padding); re-export "
            "with explicit pads/output_padding")
    w_arr = g.model.initializers.get(node.inputs[1])
    if w_arr is None:
        raise NotImplementedError("ConvTranspose weights must be initializers")
    spatial = w_arr.ndim - 2
    kernel, stride, dilate, pad = _conv_geometry(node.attrs, spatial)
    adj = tuple(node.attrs.get("output_padding", (0,) * spatial))
    group = int(node.attrs.get("group", 1))
    kwargs = dict(kernel=kernel, stride=stride, dilate=dilate, pad=pad,
                  adj=adj, num_filter=int(w_arr.shape[1]) * group,
                  num_group=group, weight=g.symbol_of(node.inputs[1]),
                  name=node.name or None)
    if len(node.inputs) > 2:
        kwargs["bias"] = g.symbol_of(node.inputs[2])
    else:
        kwargs["no_bias"] = True
    return g.sym.Deconvolution(g.symbol_of(node.inputs[0]), **kwargs)


@_translates("Elu")
def _elu(g, node):
    return g.sym.LeakyReLU(g.symbol_of(node.inputs[0]), act_type="elu",
                           slope=float(node.attrs.get("alpha", 1.0)),
                           name=node.name or None)


@_translates("PRelu")
def _prelu(g, node):
    return g.sym.LeakyReLU(g.symbol_of(node.inputs[0]),
                           gamma=g.symbol_of(node.inputs[1]),
                           act_type="prelu", name=node.name or None)


@_translates("FC")
def _fc(g, node):
    w_arr = g.model.initializers.get(node.inputs[1])
    if w_arr is None:
        raise NotImplementedError("FC weights must be initializers")
    kwargs = dict(weight=g.symbol_of(node.inputs[1]),
                  num_hidden=int(w_arr.shape[0]), name=node.name or None)
    if len(node.inputs) > 2:
        kwargs["bias"] = g.symbol_of(node.inputs[2])
    else:
        kwargs["no_bias"] = True
    return g.sym.FullyConnected(g.symbol_of(node.inputs[0]), **kwargs)


@_translates("LRN")
def _lrn(g, node):
    return g.sym.LRN(g.symbol_of(node.inputs[0]),
                     nsize=int(node.attrs["size"]),
                     alpha=float(node.attrs.get("alpha", 1e-4)),
                     beta=float(node.attrs.get("beta", 0.75)),
                     knorm=float(node.attrs.get("bias", 1.0)),
                     name=node.name or None)


def _ints_from_attr_or_input(g, node, attr, input_pos):
    """Integer list that newer opsets move from an attribute to an input;
    the input form resolves when it is a constant initializer. A skipped
    optional input is encoded as the empty string — treated as absent."""
    if attr in node.attrs:
        return [int(v) for v in node.attrs[attr]]
    if len(node.inputs) > input_pos and node.inputs[input_pos]:
        return [int(v) for v in g.const_of(node.inputs[input_pos])]
    return None


@_translates("Pad")
def _pad(g, node):
    mode = node.attrs.get("mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    if mode not in ("constant", "reflect", "edge"):
        raise NotImplementedError("Pad mode %r" % mode)
    pads = _ints_from_attr_or_input(g, node, "pads", 1)
    if pads is None:
        raise NotImplementedError(
            "Pad without pads (attribute or constant input)")
    value = float(node.attrs.get("value", 0.0))
    if "value" not in node.attrs and len(node.inputs) > 2 and node.inputs[2]:
        value = float(np.asarray(g.const_of(node.inputs[2])).reshape(()))
    rank = len(pads) // 2
    # ONNX: [b_0..b_n, e_0..e_n] -> pad op: (b_0, e_0, b_1, e_1, ...)
    width = []
    for i in range(rank):
        width += [pads[i], pads[rank + i]]
    return g.sym.pad(g.symbol_of(node.inputs[0]), mode=mode,
                     pad_width=tuple(width), constant_value=value,
                     name=node.name or None)


# -- shape / type -----------------------------------------------------------


@_translates("Cast")
def _cast(g, node):
    to = node.attrs["to"]
    if isinstance(to, str):                # pre-opset-6 string form
        dtype = to.lower()
    else:
        if int(to) not in _DTYPES:
            raise NotImplementedError("Cast to dtype code %d" % to)
        dtype = np.dtype(_DTYPES[int(to)]).name
    return g.sym.cast(g.symbol_of(node.inputs[0]), dtype=dtype,
                      name=node.name or None)


@_translates("Split")
def _split(g, node):
    data = g.symbol_of(node.inputs[0])
    axis = int(node.attrs.get("axis", 0))
    sizes = _ints_from_attr_or_input(g, node, "split", 1)
    if sizes is None or len(set(sizes)) == 1:
        return g.sym.split(data, num_outputs=len(node.outputs), axis=axis,
                           name=node.name or None)
    # unequal sections: consecutive slice_axis windows
    outs, start = [], 0
    for sz in sizes:
        outs.append(g.sym.slice_axis(data, axis=axis, begin=start,
                                     end=start + int(sz)))
        start += int(sz)
    return g.sym.Group(outs)


@_translates("Slice")
def _slice(g, node):
    begin = _ints_from_attr_or_input(g, node, "starts", 1)
    end = _ints_from_attr_or_input(g, node, "ends", 2)
    if begin is None or end is None:
        raise NotImplementedError(
            "Slice needs starts/ends as attributes or constant inputs")
    steps = _ints_from_attr_or_input(g, node, "steps", 4)
    if steps and any(int(s) != 1 for s in steps):
        raise NotImplementedError("Slice with steps != 1")
    axes = _ints_from_attr_or_input(g, node, "axes", 3)
    if axes is None:
        axes = list(range(len(begin)))
    out = g.symbol_of(node.inputs[0])
    for ax, b, e in zip(axes, begin, end):
        out = g.sym.slice_axis(out, axis=ax, begin=b,
                               end=None if e >= 2**31 - 1 else e)
    return out


@_translates("Squeeze")
def _squeeze(g, node):
    axes = _ints_from_attr_or_input(g, node, "axes", 1)
    kwargs = {"axis": tuple(int(a) for a in axes)} if axes else {}
    return g.sym.squeeze(g.symbol_of(node.inputs[0]),
                         name=node.name or None, **kwargs)


# -- reductions / search ----------------------------------------------------


@_translates("ReduceMax", "ReduceMean", "ReduceMin", "ReduceSum",
             "ReduceProd")
def _reduce(g, node):
    fn = {"ReduceMax": "max", "ReduceMean": "mean", "ReduceMin": "min",
          "ReduceSum": "sum", "ReduceProd": "prod"}[node.op_type]
    axes = _ints_from_attr_or_input(g, node, "axes", 1)
    if not axes and node.attrs.get("noop_with_empty_axes", 0):
        # opset>=13: empty axes + this flag means "return input unchanged"
        return g.sym.identity(g.symbol_of(node.inputs[0]))
    kwargs = {"axis": tuple(int(a) for a in axes)} if axes else {}
    return getattr(g.sym, fn)(g.symbol_of(node.inputs[0]),
                              keepdims=bool(node.attrs.get("keepdims", 1)),
                              name=node.name or None, **kwargs)


@_translates("ArgMax", "ArgMin")
def _arg_reduce(g, node):
    fn = "argmax" if node.op_type == "ArgMax" else "argmin"
    out = getattr(g.sym, fn)(g.symbol_of(node.inputs[0]),
                             axis=int(node.attrs.get("axis", 0)),
                             keepdims=bool(node.attrs.get("keepdims", 1)))
    # ONNX mandates int64 indices; the framework's index dtype is int32
    # (JAX x64 is off on TPU), so cast to the widest available int
    return g.sym.cast(out, dtype="int32", name=node.name or None)


def translate(model):
    """Translate a decoded OnnxModel into (Symbol, arg_params, aux_params).

    Params come back as numpy arrays keyed by the symbol's argument names
    (the ONNX initializer names are preserved).
    """
    g = _Graph(model)
    consumed = {n for node in model.nodes for n in node.inputs}
    consumed.update(name for name, _ in model.outputs)
    for node in model.nodes:
        fn = _TRANSLATORS.get(node.op_type)
        if fn is None:
            raise NotImplementedError(
                "ONNX op %r has no translation (supported: %s)"
                % (node.op_type, ", ".join(sorted(_TRANSLATORS))))
        out = fn(g, node)
        outs = list(out) if len(out) > 1 else [out]
        extra = [n for n in node.outputs[len(outs):] if n in consumed]
        if extra:
            raise NotImplementedError(
                "%s: secondary output(s) %s are consumed downstream but "
                "have no translation" % (node.op_type, extra))
        for name, s in zip(node.outputs, outs):
            g.tensors[name] = s
    result = [g.tensors[name] for name, _ in model.outputs]
    symbol = result[0] if len(result) == 1 else g.sym.Group(result)
    return symbol, g.arg_params, g.aux_params
