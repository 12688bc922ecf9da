"""Port parity for ONNX import (`mxnet_tpu_torch.contrib.onnx`) against
the JAX package's importer on the CPU.

Each model of tests/test_onnx.py is hand-encoded with the wire codec (no
onnx package), imported by both packages' `import_model`, bound by both
executors with the same numpy inputs, and the outputs compared: values
within rtol 1e-5 / atol 1e-6 (convolutions and sums run in another order
in torch than in XLA), integer outputs (argmax, casts) exactly, dtypes
alike. The random generators are held by their moments, since torch's and
jax.random's generators give different numbers. The port also goes
through its own wire codec: the bytes it decodes and encodes are the
reference's.
"""
import numpy as np
import pytest

import jax

import mxnet_tpu as mx
from mxnet_tpu import random as ref_random
from mxnet_tpu.contrib import onnx as ref_onnx
from mxnet_tpu.contrib.onnx import importer as ref_importer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import onnx as port_onnx
from mxnet_tpu_torch.contrib.onnx import importer as port_importer
from mxnet_tpu_torch.contrib.onnx import wire as port_wire

from test_onnx import model_proto, node_proto, t_proto

_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    # both importers name their nodes from the current NameManager's
    # counters: fresh ones keep the compared names independent of what
    # other tests in the process built (tests/test_onnx.py imports the
    # same models into the reference alone)
    with tmx.cpu(), mx.name.NameManager(), tmx.name.NameManager():
        yield


def _mlp_gemm_softmax(rng):
    w = rng.randn(5, 8).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    blob = model_proto(
        nodes=[node_proto("Flatten", ["x"], ["flat"]),
               node_proto("Gemm", ["flat", "w", "b"], ["fc"], transB=1),
               node_proto("Softmax", ["fc"], ["y"], axis=-1)],
        initializers={"w": w, "b": b},
        inputs=[("x", (2, 8)), ("w", (5, 8)), ("b", (5,))],
        outputs=[("y", (2, 5))])
    return blob, {"x": rng.randn(2, 8).astype(np.float32)}


def _gemm_alpha_beta(rng):
    w = rng.randn(8, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    blob = model_proto(
        nodes=[node_proto("Gemm", ["x", "w", "b"], ["y"],
                          alpha=2.0, beta=0.5)],
        initializers={"w": w, "b": b},
        inputs=[("x", (3, 8))], outputs=[("y", (3, 5))])
    return blob, {"x": rng.randn(3, 8).astype(np.float32)}


def _resnet_block(rng, C=4):
    """tests/test_onnx.py:125's residual unit: Conv-Relu, Conv-BN-Relu,
    Conv, identity add, Relu, global pool, Flatten, Gemm."""
    inits = {"c0w": (rng.randn(C, 3, 3, 3) * 0.2).astype(np.float32),
             "c1w": (rng.randn(C, C, 3, 3) * 0.2).astype(np.float32),
             "c2w": (rng.randn(C, C, 3, 3) * 0.2).astype(np.float32),
             "g": rng.rand(C).astype(np.float32) + 0.5,
             "be": rng.randn(C).astype(np.float32),
             "mu": rng.randn(C).astype(np.float32) * 0.1,
             "va": rng.rand(C).astype(np.float32) + 0.5,
             "fw": rng.randn(10, C).astype(np.float32),
             "fb": rng.randn(10).astype(np.float32)}
    conv = dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1])
    blob = model_proto(
        nodes=[node_proto("Conv", ["x", "c0w"], ["t0"], **conv),
               node_proto("Relu", ["t0"], ["r0"]),
               node_proto("Conv", ["r0", "c1w"], ["t1"], **conv),
               node_proto("BatchNormalization",
                          ["t1", "g", "be", "mu", "va"], ["bn1"],
                          epsilon=1e-5),
               node_proto("Relu", ["bn1"], ["r1"]),
               node_proto("Conv", ["r1", "c2w"], ["t2"], **conv),
               node_proto("Add", ["t2", "r0"], ["sum"]),
               node_proto("Relu", ["sum"], ["r2"]),
               node_proto("GlobalAveragePool", ["r2"], ["gap"]),
               node_proto("Flatten", ["gap"], ["flat"]),
               node_proto("Gemm", ["flat", "fw", "fb"], ["y"], transB=1)],
        initializers=inits,
        inputs=[("x", (2, 3, 8, 8))], outputs=[("y", (2, 10))])
    return blob, {"x": rng.randn(2, 3, 8, 8).astype(np.float32)}


def _pool_concat_reshape_mul(rng):
    blob = model_proto(
        nodes=[node_proto("MaxPool", ["x"], ["mp"], kernel_shape=[2, 2],
                          strides=[2, 2]),
               node_proto("AveragePool", ["x"], ["ap"], kernel_shape=[2, 2],
                          strides=[2, 2]),
               node_proto("Concat", ["mp", "ap"], ["cat"], axis=1),
               node_proto("Mul", ["cat", "s"], ["m"]),
               node_proto("Reshape", ["m", "shp"], ["y"])],
        initializers={"s": rng.rand(1, 2, 1, 1).astype(np.float32),
                      "shp": np.array([2, -1], np.int64)},
        inputs=[("x", (2, 1, 4, 4))], outputs=[("y", (2, 8))])
    return blob, {"x": rng.randn(2, 1, 4, 4).astype(np.float32)}


def _shared_gemm_weight(rng):
    w = rng.randn(6, 6).astype(np.float32)
    blob = model_proto(
        nodes=[node_proto("Gemm", ["x", "w"], ["a"], transB=1),
               node_proto("Gemm", ["a", "w"], ["y"], transB=0)],
        initializers={"w": w},
        inputs=[("x", (2, 6))], outputs=[("y", (2, 6))])
    return blob, {"x": rng.randn(2, 6).astype(np.float32)}


def _arith_unary_chain(rng):
    blob = model_proto(
        nodes=[node_proto("Sub", ["x", "y"], ["d"]),
               node_proto("Abs", ["d"], ["a"]),
               node_proto("Sqrt", ["a"], ["sq"]),
               node_proto("Exp", ["sq"], ["e"]),
               node_proto("Log", ["e"], ["l"]),
               node_proto("Div", ["l", "y"], ["dv"]),
               node_proto("Neg", ["dv"], ["n"]),
               node_proto("Floor", ["n"], ["f"]),
               node_proto("Ceil", ["f"], ["c"]),
               node_proto("Reciprocal", ["y"], ["r"]),
               node_proto("Pow", ["y", "p"], ["pw"]),
               node_proto("Max", ["c", "r"], ["mx_"]),
               node_proto("Min", ["mx_", "pw"], ["z"])],
        initializers={"p": np.full((1,), 2.0, np.float32)},
        inputs=[("x", (2, 3)), ("y", (2, 3))], outputs=[("z", (2, 3))])
    return blob, {"x": (rng.rand(2, 3).astype(np.float32) + 0.5) * 3,
                  "y": rng.rand(2, 3).astype(np.float32) + 0.5}


def _reduce_and_arg(rng):
    blob = model_proto(
        nodes=[node_proto("ReduceSum", ["x"], ["s"], axes=[1], keepdims=1),
               node_proto("ReduceMean", ["x"], ["m"], axes=[0, 2],
                          keepdims=0),
               node_proto("ReduceMax", ["x"], ["mx_"], axes=[2], keepdims=0),
               node_proto("ReduceMin", ["x"], ["mn"], axes=[2], keepdims=0),
               node_proto("ReduceProd", ["x"], ["p"], axes=[0], keepdims=1),
               node_proto("ArgMax", ["x"], ["am"], axis=2, keepdims=0),
               node_proto("ArgMin", ["x"], ["an"], axis=1)],
        initializers={}, inputs=[("x", (2, 3, 4))],
        outputs=[("s", (2, 1, 4)), ("m", (3,)), ("mx_", (2, 3)),
                 ("mn", (2, 3)), ("p", (1, 3, 4)), ("am", (2, 3)),
                 ("an", (2, 1, 4))])
    return blob, {"x": rng.randn(2, 3, 4).astype(np.float32)}


def _slice_split_squeeze_cast_pad(rng):
    blob = model_proto(
        nodes=[node_proto("Slice", ["x"], ["sl"], starts=[0, 1],
                          ends=[2, 5], axes=[0, 1]),
               node_proto("Split", ["sl"], ["s0", "s1"], axis=1),
               node_proto("Sub", ["s0", "s1"], ["d"]),
               node_proto("Pad", ["d"], ["pd"], mode="constant",
                          pads=[0, 0, 1, 0, 0, 1], value=2.5),
               node_proto("Cast", ["pd"], ["ci"], to=6),
               node_proto("Cast", ["ci"], ["y"], to=1),
               node_proto("Squeeze", ["one"], ["sq"], axes=[0, 2]),
               node_proto("Add", ["y", "sq"], ["z"])],
        initializers={"one": np.full((1, 6, 1), 0.25, np.float32)},
        inputs=[("x", (2, 6, 4))], outputs=[("z", (2, 2, 6))])
    return blob, {"x": rng.randn(2, 6, 4).astype(np.float32)}


def _unequal_split(rng):
    blob = model_proto(
        nodes=[node_proto("Split", ["x"], ["a", "b", "c"], axis=1,
                          split=[2, 4, 6]),
               node_proto("Concat", ["c", "b", "a"], ["y"], axis=1)],
        initializers={}, inputs=[("x", (2, 12))], outputs=[("y", (2, 12))])
    return blob, {"x": np.arange(24, dtype=np.float32).reshape(2, 12)}


def _convtranspose_prelu_elu_lrn(rng):
    blob = model_proto(
        nodes=[node_proto("ConvTranspose", ["x", "w"], ["ct"],
                          kernel_shape=[2, 2], strides=[2, 2]),
               node_proto("PRelu", ["ct", "g"], ["pr"]),
               node_proto("Elu", ["pr"], ["el"], alpha=0.5),
               node_proto("LRN", ["el"], ["y"], size=3, alpha=1e-4,
                          beta=0.75, bias=2.0)],
        initializers={"w": (rng.randn(3, 2, 2, 2) * 0.3).astype(np.float32),
                      "g": np.array([0.1, 0.3], np.float32)},
        inputs=[("x", (1, 3, 4, 4))], outputs=[("y", (1, 2, 8, 8))])
    return blob, {"x": rng.randn(1, 3, 4, 4).astype(np.float32)}


def _constant_reshape_fc(rng):
    blob = model_proto(
        nodes=[node_proto("Constant", [], ["shp"],
                          value=np.array([2, 8], np.int64)),
               node_proto("Reshape", ["x", "shp"], ["flat"]),
               node_proto("FC", ["flat", "w"], ["y"])],
        initializers={"w": rng.randn(5, 8).astype(np.float32)},
        inputs=[("x", (2, 2, 4))], outputs=[("y", (2, 5))])
    return blob, {"x": rng.randn(2, 2, 4).astype(np.float32)}


def _softmax_old_opset(rng):
    blob = model_proto(
        nodes=[node_proto("Softmax", ["x"], ["y"])],
        initializers={}, inputs=[("x", (2, 3, 4))],
        outputs=[("y", (2, 3, 4))], opset=9)
    return blob, {"x": rng.randn(2, 3, 4).astype(np.float32)}


def _opset13_attrs_as_inputs(rng):
    blob = model_proto(
        nodes=[node_proto("ReduceSum", ["x", "rax"], ["s"], keepdims=1),
               node_proto("Pad", ["s", "pds"], ["pd"], mode="constant"),
               node_proto("Slice", ["pd", "sts", "ens", "sax"], ["sl"]),
               node_proto("Split", ["sl", "spl"], ["a", "b"], axis=2),
               node_proto("ReduceSum", ["b"], ["bm"], axes=[2], keepdims=1),
               node_proto("Sub", ["a", "bm"], ["y"])],
        initializers={"rax": np.array([1], np.int64),
                      "pds": np.array([0, 0, 1, 0, 0, 1], np.int64),
                      "sts": np.array([0], np.int64),
                      "ens": np.array([1], np.int64),
                      "sax": np.array([1], np.int64),
                      "spl": np.array([2, 6], np.int64)},
        inputs=[("x", (2, 4, 6))], outputs=[("y", (2, 1, 2))])
    return blob, {"x": rng.randn(2, 4, 6).astype(np.float32)}


def _spatialbn_alias(rng, C=3):
    blob = model_proto(
        nodes=[node_proto("SpatialBN", ["x", "g", "be", "mu", "va"],
                          ["y"], epsilon=1e-5)],
        initializers={"g": rng.rand(C).astype(np.float32) + 0.5,
                      "be": rng.randn(C).astype(np.float32),
                      "mu": rng.randn(C).astype(np.float32) * 0.1,
                      "va": rng.rand(C).astype(np.float32) + 0.5},
        inputs=[("x", (2, C, 4, 4))], outputs=[("y", (2, C, 4, 4))])
    return blob, {"x": rng.randn(2, C, 4, 4).astype(np.float32)}


#: the deterministic models of tests/test_onnx.py, one maker each
MODELS = {
    "mlp_gemm_softmax": _mlp_gemm_softmax,
    "gemm_untransposed_alpha_beta": _gemm_alpha_beta,
    "resnet_block": _resnet_block,
    "pool_concat_reshape_mul": _pool_concat_reshape_mul,
    "shared_gemm_weight": _shared_gemm_weight,
    "arith_and_unary_chain": _arith_unary_chain,
    "reduce_and_arg_ops": _reduce_and_arg,
    "slice_split_squeeze_cast_pad": _slice_split_squeeze_cast_pad,
    "unequal_split_sections": _unequal_split,
    "convtranspose_prelu_elu_lrn": _convtranspose_prelu_elu_lrn,
    "constant_feeds_reshape_and_fc": _constant_reshape_fc,
    "softmax_old_opset": _softmax_old_opset,
    "opset13_attrs_as_inputs": _opset13_attrs_as_inputs,
    "spatialbn_alias": _spatialbn_alias,
}


def _write(tmp_path, blob):
    p = tmp_path / "model.onnx"
    p.write_bytes(blob)
    return str(p)


def run_reference(path, inputs):
    sym, args, auxs = ref_onnx.import_model(path)
    ex = sym.bind(mx.cpu(), {**{k: mx.nd.array(v) for k, v in inputs.items()},
                             **args}, aux_states=auxs)
    with ref_random.trace_key_scope(jax.random.PRNGKey(0)):
        return sym, [o.asnumpy() for o in ex.forward(is_train=False)]


def run_port(path, inputs, ctx=None):
    """The port's import, bound on `ctx` (the CPU by default): (symbol,
    arg params, aux params, outputs as numpy)."""
    ctx = ctx or tmx.cpu()
    sym, args, auxs = port_onnx.import_model(path)
    ex = sym.bind(ctx, {**{k: tmx.nd.array(v, ctx=ctx)
                           for k, v in inputs.items()},
                        **{k: v.as_in_context(ctx) for k, v in args.items()}},
                  aux_states={k: v.as_in_context(ctx)
                              for k, v in auxs.items()})
    return sym, args, auxs, [o.asnumpy() for o in ex.forward(is_train=False)]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_import_matches_reference(tmp_path, name):
    blob, inputs = MODELS[name](np.random.RandomState(3))
    path = _write(tmp_path, blob)
    ref_sym, want = run_reference(path, inputs)
    sym, args, auxs, got = run_port(path, inputs)
    assert sym.list_arguments() == ref_sym.list_arguments()
    assert sym.list_auxiliary_states() == ref_sym.list_auxiliary_states()
    assert sym.list_outputs() == ref_sym.list_outputs()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape,
                                                           g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **_TOL)


def test_random_generators_by_moments(tmp_path):
    """RandomUniform [2, 3) plus RandomNormalLike N(10, 0.5): both
    packages' sums have the mean 12.5 and the spread sqrt(1/12 + 0.25)
    within 5 standard errors; the draws themselves differ (torch's
    generator is not jax.random's)."""
    blob = model_proto(
        nodes=[node_proto("RandomUniform", [], ["u"], shape=[64, 8],
                          low=2.0, high=3.0),
               node_proto("RandomNormalLike", ["x"], ["n"], mean=10.0,
                          scale=0.5),
               node_proto("Add", ["u", "n"], ["y"])],
        initializers={}, inputs=[("x", (64, 8))], outputs=[("y", (64, 8))])
    path = _write(tmp_path, blob)
    inputs = {"x": np.zeros((64, 8), np.float32)}
    tmx.random.seed(0)
    outs = {"reference": run_reference(path, inputs)[1][0],
            "port": run_port(path, inputs)[3][0]}
    sd = np.sqrt(1 / 12 + 0.25)
    for what, out in outs.items():
        assert out.shape == (64, 8), what
        assert abs(out.mean() - 12.5) < 5 * sd / np.sqrt(out.size), what
        assert abs(out.std() - sd) < 0.15, (what, out.std())


def test_metadata_and_unsupported_op(tmp_path):
    blob = model_proto(
        nodes=[node_proto("NotARealOp", ["x"], ["y"])],
        initializers={}, inputs=[("x", (1, 3))], outputs=[("y", (1, 3))])
    path = _write(tmp_path, blob)
    assert port_onnx.get_model_metadata(path) == \
        ref_onnx.get_model_metadata(path)
    with pytest.raises(NotImplementedError, match="NotARealOp"):
        port_onnx.import_model(path)


def test_unsupported_geometry_raises(tmp_path):
    blob = model_proto(
        nodes=[node_proto("MaxPool", ["x"], ["y"], kernel_shape=[2, 2],
                          ceil_mode=1)],
        initializers={}, inputs=[("x", (1, 1, 4, 4))],
        outputs=[("y", (1, 1, 2, 2))])
    with pytest.raises(NotImplementedError, match="ceil_mode"):
        port_onnx.import_model(_write(tmp_path, blob))


def test_translators_match_reference():
    """The port translates every ONNX op type the reference does (the
    reference's own test holds that set to upstream's _convert_map)."""
    assert sorted(port_importer._TRANSLATORS) == \
        sorted(ref_importer._TRANSLATORS)


def test_wire_codec_round_trip():
    """The port's codec decodes what the reference's encoder wrote, and
    encodes the same bytes."""
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    blob = t_proto("w", arr)
    assert port_wire.packed_varints(1, [2, 3]) == \
        ref_importer.wire.packed_varints(1, [2, 3])
    tensor = port_importer._Tensor(blob)
    assert tensor.name == "w" and tensor.dims == (2, 3)
    np.testing.assert_array_equal(tensor.array, arr)
    assert port_wire.signed(port_wire.read_uvarint(
        port_wire.field_varint(1, -5), 1)[0]) == -5


@pytest.mark.parametrize("op", [
    "broadcast_add", "broadcast_plus", "broadcast_sub", "broadcast_minus",
    "broadcast_mul", "broadcast_div", "broadcast_power",
    "broadcast_maximum", "broadcast_minimum", "broadcast_equal",
    "broadcast_not_equal", "broadcast_greater", "broadcast_greater_equal",
    "broadcast_lesser", "broadcast_lesser_equal"])
def test_broadcast_op_names_match_reference(op):
    """A broadcast_* node takes the broadcast name, as the reference's,
    which registers each apart from its elemwise twin (the port's
    registry makes them aliases; its nodes were named elemwise_sub0,
    minimum0, ..., which the ONNX import's outputs showed)."""
    with tmx.name.NameManager():
        got = getattr(tmx.sym, op)(tmx.sym.Variable("a"),
                                   tmx.sym.Variable("b"))
    with mx.name.NameManager():
        want = getattr(mx.sym, op)(mx.sym.Variable("a"), mx.sym.Variable("b"))
    assert got.list_outputs() == want.list_outputs() == [op + "0_output"]


def test_chip_smoke_encodes_the_residual_block_as_the_tests_do():
    """chip_smoke.py phase 29e encodes tests/test_onnx.py:125's residual
    block with its own helpers (the card has no tests/ to import): the
    same bytes and input as this file's maker, which the reference
    imports."""
    import chip_smoke as cs
    blob, x = cs.onnx_resnet_block(np, port_wire)
    want_blob, inputs = _resnet_block(np.random.RandomState(3))
    assert blob == want_blob
    np.testing.assert_array_equal(x, inputs["x"])
