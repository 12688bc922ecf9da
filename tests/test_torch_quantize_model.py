"""int8 post-training quantization on the port (the 7 ops of
mxnet_tpu_torch/ops/quantization.py and contrib/quantization.py's
`quantize_model`) against the JAX reference on the CPU, with the same
numpy inputs from a seed. Mirrors tests/test_quantization.py case by
case, and holds each to the reference as well as to the float graph.

Tolerances: int8 and int32 outputs, quantized parameters and the graph's
argument names identical; float outputs (dequantized, ranges) 1e-5
relative (one float32 multiply each); the reference test's own bounds
against the float graph (5 % of the largest output).
"""
import io
import contextlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as ref_q
from mxnet_tpu.ops import quantization as ref_ops
from mxnet_tpu.ops import registry as ref_registry

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.contrib import quantization as port_q
from mxnet_tpu_torch.ops import quantization as port_ops
from mxnet_tpu_torch.ops import registry as port_registry

from chip_smoke import load_example

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def rand(rng, *shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _run(pkg, sym, args, x):
    exe = sym.bind(pkg.cpu(), args={**args, "data": pkg.nd.array(x)},
                   grad_req="null")
    with _ref_scope():
        exe.forward()
    return exe.outputs[0].asnumpy()


def _both_args(args):
    return ({k: tmx.nd.array(v) for k, v in args.items()},
            {k: mx.nd.array(v) for k, v in args.items()})


def _same_qargs(port, ref):
    """Quantized parameters and their ranges identical; a calibrated
    range (the float graph's min / max, summed in each package's order)
    within 1e-5."""
    assert sorted(port) == sorted(ref)
    for k in ref:
        p, r = port[k].asnumpy(), ref[k].asnumpy()
        assert p.dtype == r.dtype, k
        if k.endswith(("_calib_min", "_calib_max")):
            np.testing.assert_allclose(p, r, err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(p, r, err_msg=k)


def _rel(got, ref):
    return np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

def test_quantize_dequantize_roundtrip():
    x = rand(np.random.RandomState(0), 4, 5) * 3
    lo = np.float32(x.min()).reshape(())
    hi = np.float32(x.max()).reshape(())
    q, qmin, qmax = tmx.nd.contrib.quantize(tmx.nd.array(x),
                                            tmx.nd.array(lo),
                                            tmx.nd.array(hi))
    rq, rmin, rmax = mx.nd.contrib.quantize(mx.nd.array(x), mx.nd.array(lo),
                                            mx.nd.array(hi))
    assert q.dtype == np.int8
    np.testing.assert_array_equal(q.asnumpy(), rq.asnumpy())
    np.testing.assert_array_equal(qmax.asnumpy(), rmax.asnumpy())
    back = tmx.nd.contrib.dequantize(q, qmin, qmax).asnumpy()
    np.testing.assert_allclose(
        back, mx.nd.contrib.dequantize(rq, rmin, rmax).asnumpy(), **TOL)
    assert np.abs(back - x).max() <= np.abs(x).max() / 127 + 1e-6


def test_quantize_saturates():
    x = np.array([[-10.0, 0.0, 10.0]], np.float32)
    q, _, _ = tmx.nd.contrib.quantize(
        tmx.nd.array(x), tmx.nd.array(np.float32(-1.0).reshape(())),
        tmx.nd.array(np.float32(1.0).reshape(())))
    qa = q.asnumpy()
    assert qa[0, 0] == -127 and qa[0, 2] == 127 and qa[0, 1] == 0
    with pytest.raises(tmx.base.MXNetError):
        port_ops.quantize(torch.zeros(2), -1.0, 1.0, out_type="uint8")


def _op_cases(rng):
    """(name, input arrays, params) for the 7 ops: ranges as 0-dim
    float32 arrays, int8 tensors drawn in [-127, 127]."""
    def r(v):
        return np.float32(v).reshape(())

    def i8(*shape):
        return rng.randint(-127, 128, shape).astype(np.int8)
    x = rand(rng, 3, 4, 5) * 2.5
    return [
        ("_contrib_quantize", [x, r(-2.0), r(1.5)], {}),
        ("_contrib_quantize", [x * 100, r(-0.1), r(0.1)], {}),
        ("_contrib_dequantize", [i8(6, 7), r(-0.5), r(3.0)], {}),
        ("_contrib_dequantize", [rng.randint(-40000, 40000, (5, 3))
                                 .astype(np.int32), r(-1.0), r(2.0)], {}),
        ("_contrib_requantize", [rng.randint(-9000, 9000, (4, 6))
                                 .astype(np.int32), r(-3.0), r(3.0)], {}),
        ("_contrib_requantize", [rng.randint(-9000, 9000, (4, 6))
                                 .astype(np.int32), r(-3.0), r(3.0)],
         dict(min_calib_range=-0.02, max_calib_range=0.03)),
        ("_contrib_quantized_fully_connected",
         [i8(5, 12), i8(10, 12), r(-1), r(1), r(-0.5), r(0.5)],
         dict(num_hidden=10, no_bias=True)),
        ("_contrib_quantized_fully_connected",
         [i8(4, 2, 3), i8(7, 6), r(-2), r(1), r(-0.3), r(0.5), i8(7),
          r(-0.1), r(0.2)], dict(num_hidden=7)),
        ("_contrib_quantized_conv",
         [i8(2, 3, 7, 7), i8(4, 3, 3, 3), r(-1), r(2), r(-0.5), r(0.5),
          i8(4), r(-1), r(1)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), num_filter=4)),
        ("_contrib_quantized_conv",
         [i8(1, 4, 6, 6), i8(4, 2, 3, 3), r(-1), r(1), r(-1), r(1)],
         dict(kernel=(3, 3), num_filter=4, num_group=2, no_bias=True)),
        ("_contrib_quantized_pooling", [i8(2, 3, 6, 6), r(-1), r(1)],
         dict(kernel=(2, 2), stride=(2, 2), pool_type="max")),
        ("_contrib_quantized_pooling", [i8(2, 3, 7, 7), r(-1), r(1)],
         dict(kernel=(3, 3), stride=(2, 2), pool_type="avg")),
        ("_contrib_quantized_flatten", [i8(2, 3, 4), r(-1), r(1)], {}),
    ]


@pytest.mark.parametrize("case", range(13))
def test_quantization_op_names(case):
    """Each op through mx.nd.<name> in both packages: integer outputs
    identical, float outputs within 1e-5, dtypes equal; and its alias."""
    name, arrays, params = _op_cases(np.random.RandomState(case))[case]
    ref_out = getattr(mx.nd, name)(*[mx.nd.array(a, dtype=a.dtype)
                                     for a in arrays], **params)
    for fname in (name, ref_registry.get(name).aliases[0]):
        got = getattr(tmx.nd, fname)(*[tmx.nd.array(a, dtype=a.dtype)
                                       for a in arrays], **params)
        got = got if isinstance(got, tuple) else (got,)
        want = ref_out if isinstance(ref_out, tuple) else (ref_out,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g, w = g.asnumpy(), w.asnumpy()
            assert g.dtype == w.dtype and g.shape == w.shape, fname
            if w.dtype.kind in "iu":
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, **TOL)
    assert ref_registry.get(name).aliases == \
        port_registry.get(name).aliases


def test_quantized_ops_infer_shapes_like_the_reference():
    """The ops run on "meta" in shape inference: a quantize -> FC ->
    dequantize graph infers the reference's shapes."""
    shapes = []
    for pkg in (tmx, mx):
        s = pkg.sym
        data = s.Variable("data")
        q = s._contrib_quantize(data, s.Variable("lo", shape=()),
                                s.Variable("hi", shape=()), name="q")
        fc = s._contrib_quantized_fully_connected(
            q[0], s.Variable("w", shape=(10, 12)), q[1], q[2],
            s.Variable("wlo", shape=()), s.Variable("whi", shape=()),
            num_hidden=10, no_bias=True, name="fc")
        out = s._contrib_dequantize(fc[0], fc[1], fc[2], name="deq")
        shapes.append(out.infer_shape(data=(5, 12)))
    assert shapes[0] == shapes[1]


def test_dequantize_int32_uses_product_of_scales():
    rng = np.random.RandomState(0)
    a = rng.uniform(-3, 3, (64,)).astype(np.float32)
    b = rng.uniform(-2, 2, (64,)).astype(np.float32)
    qa, amin, amax = port_ops.quantize(torch.from_numpy(a), -3.0, 3.0)
    qb, bmin, bmax = port_ops.quantize(torch.from_numpy(b), -2.0, 2.0)
    acc = torch.sum(qa.int() * qb.int())
    omin, omax = port_ops._int32_range_of_product(amin, amax, bmin, bmax,
                                                  qa)
    got = float(port_ops.dequantize(acc[None], omin, omax)[0])
    want = float(np.dot(a, b))
    assert abs(got - want) < 1e-2 * float(np.sum(np.abs(a * b))), \
        (got, want)
    assert 0.5 < abs(got) / abs(want) < 2.0, (got, want)
    rqa, ramin, ramax = ref_ops.quantize(jnp.asarray(a), -3.0, 3.0)
    rqb, rbmin, rbmax = ref_ops.quantize(jnp.asarray(b), -2.0, 2.0)
    np.testing.assert_array_equal(qa.numpy(), np.asarray(rqa))
    romin, romax = ref_ops._int32_range_of_product(ramin, ramax, rbmin,
                                                   rbmax, len(a))
    np.testing.assert_allclose(float(omax), float(romax), **TOL)
    racc = jnp.sum(rqa.astype(jnp.int32) * rqb.astype(jnp.int32))
    assert int(acc) == int(racc)
    np.testing.assert_allclose(
        got, float(ref_ops.dequantize(racc[None], romin, romax)[0]), **TOL)


def test_quantized_pooling_and_flatten():
    x8 = np.random.RandomState(5).randint(-127, 128, (1, 2, 4, 4)) \
        .astype(np.int8)
    out, mn, mx_ = port_ops.quantized_pooling(
        torch.from_numpy(x8), torch.tensor(-1.0), torch.tensor(1.0),
        kernel=(2, 2), stride=(2, 2), pool_type="max")
    assert out.dtype == torch.int8
    ref = x8.reshape(1, 2, 2, 2, 2, 2).max(axis=(3, 5))
    np.testing.assert_array_equal(out.numpy(), ref)
    flat, _, _ = port_ops.quantized_flatten(torch.from_numpy(x8),
                                            torch.tensor(-1.0),
                                            torch.tensor(1.0))
    assert tuple(flat.shape) == (1, 32)


# ---------------------------------------------------------------------------
# quantize_model
# ---------------------------------------------------------------------------

def test_quantized_fc_matches_fp32():
    rng = np.random.RandomState(1)
    x, w, b = rand(rng, 8, 6), rand(rng, 4, 6), rand(rng, 4)
    outs = []
    for pkg, q in ((tmx, port_q), (mx, ref_q)):
        with pkg.name.NameManager():
            fp32 = pkg.sym.FullyConnected(pkg.sym.Variable("data"),
                                          name="fc", num_hidden=4)
        args = {"fc_weight": pkg.nd.array(w), "fc_bias": pkg.nd.array(b)}
        ref = _run(pkg, fp32, args, x)
        qsym, qargs, _ = q.quantize_model(fp32, args)
        got = _run(pkg, qsym, qargs, x)
        assert _rel(got, ref) < 0.05, _rel(got, ref)
        outs.append((got, qargs, qsym.list_arguments()))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    _same_qargs(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2]


def test_quantized_conv_matches_fp32():
    rng = np.random.RandomState(2)
    x, w = rand(rng, 2, 3, 8, 8), rand(rng, 4, 3, 3, 3)
    outs = []
    for pkg, q in ((tmx, port_q), (mx, ref_q)):
        fp32 = pkg.sym.Convolution(pkg.sym.Variable("data"), name="conv",
                                   kernel=(3, 3), num_filter=4, no_bias=True)
        args = {"conv_weight": pkg.nd.array(w)}
        ref = _run(pkg, fp32, args, x)
        qsym, qargs, _ = q.quantize_model(fp32, args)
        got = _run(pkg, qsym, qargs, x)
        assert _rel(got, ref) < 0.05, _rel(got, ref)
        outs.append((got, qargs))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    _same_qargs(outs[0][1], outs[1][1])


def _mlp(pkg):
    s = pkg.sym
    data = s.Variable("data")
    fc1 = s.FullyConnected(data, name="fc1", num_hidden=16)
    act = s.Activation(fc1, name="relu", act_type="relu")
    return s.FullyConnected(act, name="fc2", num_hidden=4)


def _mlp_args(rng):
    return {"fc1_weight": rand(rng, 16, 8), "fc1_bias": rand(rng, 16),
            "fc2_weight": rand(rng, 4, 16), "fc2_bias": rand(rng, 4)}


@pytest.mark.parametrize("mode", ["naive", "entropy", "none"])
def test_quantize_model_calibration(mode):
    """naive (ranges baked in as params), entropy (the KL threshold over
    peaked data) and none (dynamic min / max nodes) as the reference."""
    rng = np.random.RandomState(0)
    raw = _mlp_args(rng)
    x = (rng.randn(64, 8) ** 3 / 3).astype(np.float32) \
        if mode == "entropy" else rand(rng, 32, 8)
    outs = []
    for pkg, q, args in zip((tmx, mx), (port_q, ref_q), _both_args(raw)):
        net = _mlp(pkg)
        ref = _run(pkg, net, args, x)
        calib = pkg.io.NDArrayIter(x, np.zeros(len(x), np.float32),
                                   batch_size=16)
        with _ref_scope():
            qsym, qargs, _ = q.quantize_model(
                net, args, calib_mode=mode,
                calib_data=None if mode == "none" else calib)
        got = _run(pkg, qsym, qargs, x)
        if mode != "entropy":
            assert _rel(got, ref) < 0.05, _rel(got, ref)
        assert np.isfinite(got).all()
        outs.append((got, qargs, qsym.list_arguments(),
                     [n.name for n in qsym._topo()]))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    _same_qargs(outs[0][1], outs[1][1])
    assert outs[0][2] == outs[1][2] and outs[0][3] == outs[1][3]
    if mode == "naive":
        assert any(k.endswith("_calib_min") for k in outs[0][1])
    if mode == "none":
        assert "fc1_dyn_min" in outs[0][3]


def test_quantize_model_excluded_layers_and_calib_layer():
    rng = np.random.RandomState(3)
    raw = _mlp_args(rng)
    x = rand(rng, 8, 8)
    outs = []
    for pkg, q, args in zip((tmx, mx), (port_q, ref_q), _both_args(raw)):
        qsym, qargs, _ = q.quantize_model(_mlp(pkg), args,
                                          excluded_sym_names=["fc2"])
        assert "fc2_weight" in qargs and "fc1_weight_quantized" in qargs
        got = _run(pkg, qsym, qargs, x)
        assert got.shape == (8, 4)
        calib = pkg.io.NDArrayIter(x, np.zeros(8, np.float32), batch_size=4)
        with _ref_scope():
            qsym2, qargs2, _ = q.quantize_model(
                _mlp(pkg), args, calib_mode="naive", calib_data=calib,
                calib_layer=lambda name: name == "relu_output")
        outs.append((got, qargs, qargs2, _run(pkg, qsym2, qargs2, x)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    _same_qargs(outs[0][1], outs[1][1])
    _same_qargs(outs[0][2], outs[1][2])
    assert "fc2_calib_min" in outs[0][2] and \
        "fc1_calib_min" not in outs[0][2]
    np.testing.assert_allclose(outs[0][3], outs[1][3], **TOL)


def test_quantize_model_shared_weight():
    rng = np.random.RandomState(4)
    w = rand(rng, 4, 6)
    x = rand(rng, 8, 6)
    ref = x @ w.T * 2
    results = []
    for pkg, q in ((tmx, port_q), (mx, ref_q)):
        s = pkg.sym
        data = s.Variable("data")
        shared = s.Variable("shared_weight")
        fc1 = s.FullyConnected(data, weight=shared, name="fca",
                               num_hidden=4, no_bias=True)
        fc2 = s.FullyConnected(data, weight=shared, name="fcb",
                               num_hidden=4, no_bias=True)
        out = fc1 + fc2
        args = {"shared_weight": pkg.nd.array(w)}
        qsym, qargs, _ = q.quantize_model(out, args)
        assert "shared_weight_quantized" in qargs
        assert "shared_weight" not in qargs
        got = _run(pkg, qsym, qargs, x)
        assert _rel(got, ref) < 0.05
        qsym2, qargs2, _ = q.quantize_model(out, args,
                                            excluded_sym_names=["fcb"])
        assert "shared_weight_quantized" in qargs2
        assert "shared_weight" in qargs2
        got2 = _run(pkg, qsym2, qargs2, x)
        assert _rel(got2, ref) < 0.05
        results.append((got, got2, qargs, qargs2))
    for g, w_ in zip(results[0][:2], results[1][:2]):
        np.testing.assert_allclose(g, w_, **TOL)
    _same_qargs(results[0][2], results[1][2])
    _same_qargs(results[0][3], results[1][3])


def test_quantized_model_binds_via_module():
    """simple_bind over a quantized graph (Module's deployment flow): the
    quantized and range variables carry shape hints. Trained on the port;
    both packages quantize the same parameters."""
    np.random.seed(8)
    tmx.random.seed(8)
    train, val = tmx.test_utils.get_mnist_iterator(batch_size=100,
                                                   input_shape=(784,))
    mod = tmx.mod.Module(tmx.models.get_mlp(), context=tmx.cpu())
    mod.fit(train, optimizer="sgd", initializer=tmx.init.Xavier(),
            optimizer_params={"learning_rate": 0.1}, num_epoch=1)
    arg, aux = mod.get_params()
    qsym, qarg, qaux = port_q.quantize_model(
        sym=mod._symbol, arg_params=arg, aux_params=aux,
        calib_mode="naive", calib_data=val, num_calib_examples=200)
    _, rval = mx.test_utils.get_mnist_iterator(batch_size=100,
                                               input_shape=(784,))
    with _ref_scope():
        _, rqarg, _ = ref_q.quantize_model(
            sym=mx.models.get_mlp(),
            arg_params={k: mx.nd.array(v.asnumpy()) for k, v in arg.items()},
            aux_params={}, calib_mode="naive", calib_data=rval,
            num_calib_examples=200)
    _same_qargs(qarg, rqarg)
    qmod = tmx.mod.Module(qsym, context=tmx.cpu())
    qmod.bind(data_shapes=[("data", (100, 784))],
              label_shapes=[("softmax_label", (100,))], for_training=False)
    qmod.init_params(arg_params=qarg, aux_params=qaux, force_init=True)
    val.reset()
    correct = total = 0
    for b in val:
        qmod.forward(b, is_train=False)
        p = qmod.get_outputs()[0].asnumpy().argmax(1)
        correct += (p == b.label[0].asnumpy()).sum()
        total += len(p)
    assert correct / total > 0.85, correct / total


def test_kl_threshold_does_not_collapse_on_spiky_relu_dist():
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(200000), 0).astype(np.float32)
    t = port_q._kl_optimal_threshold([x])
    assert t == ref_q._kl_optimal_threshold([x])
    frac_clipped = float((x > t).mean())
    assert frac_clipped < 0.10, (t, frac_clipped)
    assert t > np.percentile(x[x > 0], 75), t


def test_quantize_int8_example_prints_the_reference_figures():
    printed = []
    for pkg in (tmx, mx):
        module = load_example("quantize_int8.py", pkg)
        argv = sys.argv
        sys.argv = ["quantize_int8.py", "--num-calib-batches", "2"]
        np.random.seed(9)
        pkg.random.seed(9)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf), _ref_scope():
                rc = module.main()
        finally:
            sys.argv = argv
        assert rc == 0
        printed.append(buf.getvalue())
    assert "int8 accuracy" in printed[0]
    assert printed[0] == printed[1], printed
