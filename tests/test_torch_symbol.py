"""Port parity for the symbolic graph (mxnet_tpu_torch.symbol) against the
JAX reference on the CPU: the argument, aux and output lists,
infer_shape (the parameter-shape rules and the batch-guess retry),
infer_type, eval, the JSON format both ways, the attribute scope, the
operators, and the loss heads' forward and hand-written backward.

The nets are get_mlp, get_lenet and chip_smoke's BatchNorm conv net
(`bn_convnet`), each built from either package's `sym` under a fresh
NameManager. Weights and inputs are numpy arrays from a seed.

Tolerances: float32 outputs and gradients 1e-5 (the same arithmetic,
sums in another order); shapes, names and JSON exact.
"""
import json

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import registry

import chip_smoke

_FWD = dict(rtol=1e-5, atol=1e-5)


def _models(sym):
    return mx.models if sym is mx.sym else tmx.models


NETS = {
    "mlp": (lambda sym: _models(sym).get_mlp(), (8, 784)),
    "lenet": (lambda sym: _models(sym).get_lenet(), (8, 1, 28, 28)),
    "bn_convnet": (chip_smoke.bn_convnet, (8, 1, 28, 28)),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _twin(which):
    make, shape = NETS[which]
    with mx.name.NameManager():
        ref = make(mx.sym)
    with tmx.name.NameManager():
        port = make(tmx.sym)
    return ref, port, shape


def _values(sym, data_shape, seed=0):
    """{argument / aux name: numpy array} for sym at data_shape."""
    rng = np.random.RandomState(seed)
    args, _, aux = sym.infer_shape(data=data_shape)
    out = {}
    for n, s in zip(sym.list_arguments(), args):
        if n == "softmax_label":
            out[n] = rng.randint(0, 10, s).astype(np.float32)
        else:
            out[n] = (0.1 * rng.randn(*s)).astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux):
        out[n] = (rng.rand(*s) + (0.5 if n.endswith("var") else 0.0)) \
            .astype(np.float32)
    return out


@pytest.mark.parametrize("which", sorted(NETS))
def test_lists_match_reference(which):
    ref, port, _ = _twin(which)
    assert port.list_arguments() == ref.list_arguments()
    assert port.list_auxiliary_states() == ref.list_auxiliary_states()
    assert port.list_outputs() == ref.list_outputs()
    assert port.list_inputs() == ref.list_inputs()
    assert port.get_internals().list_outputs() == \
        ref.get_internals().list_outputs()


@pytest.mark.parametrize("which", sorted(NETS))
def test_infer_shape_and_type_match_reference(which):
    ref, port, shape = _twin(which)
    assert port.infer_shape(data=shape) == ref.infer_shape(data=shape)
    assert port.infer_type(data=np.float32) == \
        ref.infer_type(data=np.float32)
    # the label's shape given too, and a partial inference without data
    label = {"softmax_label": (shape[0],)}
    assert port.infer_shape(data=shape, **label) == \
        ref.infer_shape(data=shape, **label)
    assert port.infer_shape_partial() == ref.infer_shape_partial()


def test_infer_shape_batch_guess_retry_matches_reference():
    """A variable with a 0 dim (an RNN begin state) takes its batch from
    the data's dims, as the reference's retry does."""
    def make(sym):
        data = sym.Variable("data")
        state = sym.Variable("state", shape=(1, 0, 16))
        return sym.RNN(data, state=state, state_size=16, num_layers=1,
                       mode="rnn_tanh", name="rnn")
    with mx.name.NameManager():
        ref = make(mx.sym)
    with tmx.name.NameManager():
        port = make(tmx.sym)
    assert port.infer_shape(data=(5, 3, 8)) == ref.infer_shape(data=(5, 3, 8))


@pytest.mark.parametrize("which", sorted(NETS))
def test_eval_matches_reference(which):
    ref, port, shape = _twin(which)
    vals = _values(port, shape)
    ref_vals = {k: mx.nd.array(v) for k, v in vals.items()}
    port_vals = {k: tmx.nd.array(v) for k, v in vals.items()}
    with mx.random.trace_key_scope(jax.random.PRNGKey(0)):
        want = ref.eval(ctx=mx.cpu(), **ref_vals)
    got = port.eval(ctx=tmx.cpu(), **port_vals)
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(), **_FWD)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("which", sorted(NETS))
def test_json_crosses_between_packages(which, writer, tmp_path):
    """A graph one package saves, the other loads: the same lists, shapes
    and outputs."""
    ref, port, shape = _twin(which)
    path = str(tmp_path / "net-symbol.json")
    (port if writer == "port" else ref).save(path)
    if writer == "port":
        ref = mx.sym.load(path)
    else:
        port = tmx.sym.load(path)
    assert port.list_arguments() == ref.list_arguments()
    assert port.list_auxiliary_states() == ref.list_auxiliary_states()
    assert port.infer_shape(data=shape) == ref.infer_shape(data=shape)
    assert json.loads(port.tojson()) == json.loads(ref.tojson())
    vals = _values(port, shape, seed=1)
    with mx.random.trace_key_scope(jax.random.PRNGKey(0)):
        want = ref.eval(ctx=mx.cpu(), **{k: mx.nd.array(v)
                                          for k, v in vals.items()})
    got = port.eval(ctx=tmx.cpu(), **{k: tmx.nd.array(v)
                                       for k, v in vals.items()})
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(), **_FWD)


@pytest.mark.parametrize("value", [(5, 5), [1, 2], True, False, None,
                                   np.float32(0.25), np.int64(7), 0.9,
                                   "tanh", (np.int32(2), np.int32(3))])
def test_json_attribute_values_round_trip(value):
    """repr strings for tuples, lists, booleans, None, numpy scalars,
    floats and strings: each package reads back what the other wrote."""
    def make(sym):
        return sym.Activation(sym.Variable("data"), name="act",
                              act_type="relu", probe=value)
    with mx.name.NameManager():
        ref = make(mx.sym)
    with tmx.name.NameManager():
        port = make(tmx.sym)
    want = value.item() if isinstance(value, np.generic) else value
    if isinstance(value, tuple):
        want = tuple(v.item() if isinstance(v, np.generic) else v
                     for v in value)
    node_port = port.get_internals()._outputs[-1][0]
    node_ref = ref.get_internals()._outputs[-1][0]
    assert json.loads(port.tojson()) == json.loads(ref.tojson())
    # "probe" is not an Activation parameter: the loader keeps it as a
    # node attribute, parsed
    back_in_ref = mx.sym.load_json(port.tojson()).get_internals()
    back_in_port = tmx.sym.load_json(ref.tojson()).get_internals()
    assert back_in_ref._outputs[-1][0].attr["probe"] == want
    assert back_in_port._outputs[-1][0].attr["probe"] == want
    assert node_port.kwargs["probe"] == node_ref.kwargs["probe"]


def test_json_of_an_op_the_port_lacks_names_it():
    # the port registers every reference op, so the JSON names an op
    # that neither registry has (a newer MXNet's, say)
    text = mx.sym.Activation(mx.sym.Variable("data"), act_type="relu",
                             name="act").tojson()
    graph = json.loads(text)
    for node in graph["nodes"]:
        if node["op"] == "Activation":
            node["op"] = "_contrib_not_an_op"
    with pytest.raises(MXNetError, match="'_contrib_not_an_op'"):
        tmx.sym.load_json(json.dumps(graph))
    with pytest.raises(MXNetError, match="'_contrib_not_an_op'"):
        tmx.sym.create("_contrib_not_an_op", tmx.sym.Variable("data"))


def test_attribute_scope_and_multipliers_match_reference():
    def make(sym, attr_mod):
        with attr_mod.AttrScope(ctx_group="dev1"):
            w = sym.Variable("fc_weight", lr_mult=2.0, wd_mult=0.5)
        net = sym.FullyConnected(sym.Variable("data"), weight=w,
                                 num_hidden=4, name="fc")
        return net
    with mx.name.NameManager():
        ref = make(mx.sym, mx.attribute)
    with tmx.name.NameManager():
        port = make(tmx.sym, tmx.attribute)
    assert port.attr_dict() == ref.attr_dict()
    assert port.list_arguments() == ref.list_arguments()
    assert port.get_internals()["fc_weight_output"].attr("__lr_mult__") \
        == "2.0"


@pytest.mark.parametrize("op", ["add", "sub", "rsub", "mul", "div", "rdiv",
                                "pow", "neg", "maximum", "minimum", "gt",
                                "le", "eq", "relu_method"])
def test_operators_match_reference(op):
    def make(sym):
        a, b = sym.Variable("a"), sym.Variable("b")
        return {"add": lambda: a + b, "sub": lambda: a - 2.0,
                "rsub": lambda: 3.0 - a, "mul": lambda: a * b,
                "div": lambda: a / b, "rdiv": lambda: 2.0 / a,
                "pow": lambda: sym.pow(a, 2.0), "neg": lambda: -a,
                "maximum": lambda: sym.maximum(a, b),
                "minimum": lambda: sym.minimum(0.5, b),
                "gt": lambda: a > b, "le": lambda: a <= 0.5,
                "eq": lambda: a == b, "relu_method": lambda: a.relu()}[op]()
    rng = np.random.RandomState(3)
    a = (rng.rand(4, 5) + 0.5).astype(np.float32)
    b = (rng.rand(4, 5) + 0.5).astype(np.float32)
    b[0, 0] = a[0, 0]
    with mx.name.NameManager():
        ref = make(mx.sym)
    with tmx.name.NameManager():
        port = make(tmx.sym)
    assert port.list_arguments() == ref.list_arguments()
    feed = {k: v for k, v in (("a", a), ("b", b))
            if k in port.list_arguments()}
    want = ref.eval(**{k: mx.nd.array(v) for k, v in feed.items()})
    got = port.eval(**{k: tmx.nd.array(v) for k, v in feed.items()})
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(), **_FWD)


HEADS = {
    "softmax": ("SoftmaxOutput", {}, (6, 5), "class"),
    "softmax_batch": ("SoftmaxOutput", {"normalization": "batch",
                                        "grad_scale": 2.0}, (6, 5),
                      "class"),
    "softmax_valid_ignore": ("SoftmaxOutput", {
        "normalization": "valid", "use_ignore": True, "ignore_label": 2},
        (6, 5), "class"),
    "softmax_smooth": ("SoftmaxOutput", {"smooth_alpha": 0.1}, (6, 5),
                       "class"),
    "softmax_multi_output": ("SoftmaxOutput", {"multi_output": True},
                             (3, 4, 5), "multi"),
    "linear": ("LinearRegressionOutput", {"grad_scale": 0.5}, (6, 3),
               "real"),
    "mae": ("MAERegressionOutput", {}, (6, 3), "real"),
    "logistic": ("LogisticRegressionOutput", {}, (6, 3), "real"),
    "svm": ("SVMOutput", {"margin": 0.5}, (6, 5), "class"),
    "svm_linear": ("SVMOutput", {"use_linear": True}, (6, 5), "class"),
    "make_loss": ("make_loss", {"grad_scale": 3.0,
                                "normalization": "batch"}, (6, 3), None),
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_loss_heads_forward_and_gradient_match_reference(head):
    """Each head's forward, and its hand-written gradient through a bound
    executor (head gradients of ones, which the heads ignore): the data's
    gradient and the label's zero gradient."""
    op, kw, shape, label_kind = HEADS[head]
    rng = np.random.RandomState(5)
    data = rng.randn(*shape).astype(np.float32)
    vals = {"data": data}
    if label_kind == "class":
        vals["label"] = rng.randint(0, shape[-1], shape[:-1]).astype(
            np.float32)
    elif label_kind == "multi":
        vals["label"] = rng.randint(0, shape[1], (shape[0],) + shape[2:]) \
            .astype(np.float32)
    elif label_kind == "real":
        vals["label"] = rng.rand(*shape).astype(np.float32)

    def run(pkg, ctx):
        sym = pkg.sym
        args = [sym.Variable("data")]
        if label_kind:
            args.append(sym.Variable("label"))
        net = getattr(sym, op)(*args, name="head", **kw)
        arrs = {k: pkg.nd.array(v) for k, v in vals.items()}
        grads = {k: pkg.nd.zeros(v.shape) for k, v in vals.items()}
        ex = net.bind(ctx, args=arrs, args_grad=grads)
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        return out, {k: g.asnumpy() for k, g in ex.grad_dict.items()}

    with mx.random.trace_key_scope(jax.random.PRNGKey(0)):
        want_out, want_g = run(mx, mx.cpu())
    got_out, got_g = run(tmx, tmx.cpu())
    np.testing.assert_allclose(got_out, want_out, **_FWD)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        np.testing.assert_allclose(got_g[k], want_g[k], err_msg=k, **_FWD)


def test_softmax_output_gradient_is_not_autograds():
    """An autograd-derived softmax cross-entropy would divide by the
    batch and flow through the head gradient; SoftmaxOutput's gradient is
    softmax - onehot, whatever head gradient reaches it."""
    x = torch.tensor(np.random.RandomState(0).randn(4, 3), dtype=torch.float32,
                     requires_grad=True)
    lab = torch.tensor([0.0, 2.0, 1.0, 2.0])
    out = registry.get("SoftmaxOutput").fn(x, lab)
    out.backward(torch.full_like(out, 7.0))
    want = torch.softmax(x.detach(), -1) - torch.nn.functional.one_hot(
        lab.long(), 3).float()
    torch.testing.assert_close(x.grad, want, rtol=1e-6, atol=1e-6)


def test_variable_shape_hint_binds_without_data_shape():
    """A variable's shape hint stands in for a missing input shape, and
    survives the JSON round trip."""
    net = tmx.sym.FullyConnected(tmx.sym.Variable("data", shape=(2, 7)),
                                 num_hidden=3, name="fc")
    back = tmx.sym.load_json(net.tojson())
    assert back.infer_shape()[0] == [(2, 7), (3, 7), (3,)]
    assert mx.sym.load_json(net.tojson()).infer_shape()[0] == \
        [(2, 7), (3, 7), (3,)]


def test_symbol_ndarray_only_apis_raise_and_symbol_doc_shapes():
    s = tmx.sym.Variable("x")
    with pytest.raises(tmx.base.NotImplementedForSymbol):
        s.asnumpy()
    assert tmx.symbol_doc.SymbolDoc.get_output_shape(
        tmx.sym.Flatten(s, name="flat"), x=(2, 3, 4)) == \
        {"flat_output": (2, 12)}


#: the ops the symbolic path reaches by name, with non-default keywords,
#: as (op, kwargs, data shape, extra parameter inputs' shapes)
REGISTRY_CASES = {
    "act_relu": ("Activation", {"act_type": "relu"}, (2, 3, 5, 5)),
    "act_sigmoid": ("Activation", {"act_type": "sigmoid"}, (2, 3, 5, 5)),
    "act_tanh": ("Activation", {"act_type": "tanh"}, (2, 3, 5, 5)),
    "act_softrelu": ("Activation", {"act_type": "softrelu"}, (2, 3, 5, 5)),
    "act_softsign": ("Activation", {"act_type": "softsign"}, (2, 3, 5, 5)),
    "fc": ("FullyConnected", {"num_hidden": 4}, (2, 3, 5, 5)),
    "fc_no_flatten": ("FullyConnected", {"num_hidden": 4, "flatten": False,
                                         "no_bias": True}, (2, 3, 5)),
    "conv": ("Convolution", {"kernel": (3, 3), "num_filter": 4,
                             "stride": (2, 1), "pad": (1, 0),
                             "dilate": (1, 2)}, (2, 4, 9, 9)),
    "conv_group": ("Convolution", {"kernel": (3, 3), "num_filter": 4,
                                   "num_group": 2, "no_bias": True},
                   (2, 4, 7, 7)),
    "conv1d": ("Convolution", {"kernel": (3,), "num_filter": 2},
               (2, 3, 8)),
    "pool_max": ("Pooling", {"kernel": (3, 3), "stride": (2, 2),
                             "pool_type": "max"}, (2, 3, 8, 8)),
    "pool_max_full": ("Pooling", {"kernel": (3, 3), "stride": (2, 2),
                                  "pool_type": "max",
                                  "pooling_convention": "full"},
                      (2, 3, 8, 8)),
    "pool_avg_pad": ("Pooling", {"kernel": (3, 3), "pad": (1, 1),
                                 "pool_type": "avg",
                                 "count_include_pad": False},
                     (2, 3, 6, 6)),
    "pool_sum": ("Pooling", {"kernel": (2, 2), "pool_type": "sum"},
                 (2, 3, 6, 6)),
    "pool_lp": ("Pooling", {"kernel": (2, 2), "pool_type": "lp",
                            "p_value": 3}, (2, 3, 6, 6)),
    "pool_global": ("Pooling", {"global_pool": True, "pool_type": "avg",
                                "kernel": (1, 1)}, (2, 3, 6, 6)),
    "flatten": ("Flatten", {}, (2, 3, 4, 5)),
    "bn_global": ("BatchNorm", {"use_global_stats": True, "fix_gamma": False,
                                "eps": 1e-4}, (2, 3, 4, 4)),
    "bn_inference": ("BatchNorm", {}, (2, 3, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_ops_through_reference_json_match_reference(case):
    """The port's registrations of the ops a Symbol reaches by name, fed
    the keyword arguments the reference's JSON parses back: outputs
    equal to the reference's (inference forward)."""
    op, kw, shape = REGISTRY_CASES[case]

    def make(sym):
        return getattr(sym, op)(sym.Variable("data"), name="op", **kw)
    with mx.name.NameManager():
        ref = make(mx.sym)
    port = tmx.sym.load_json(ref.tojson())
    assert port.list_arguments() == ref.list_arguments()
    assert port.infer_shape(data=shape) == ref.infer_shape(data=shape)
    vals = _values(port, shape, seed=2)
    vals["data"] = np.random.RandomState(3).randn(*shape).astype(np.float32)
    with mx.random.trace_key_scope(jax.random.PRNGKey(0)):
        want = ref.eval(**{k: mx.nd.array(v) for k, v in vals.items()})
    got = port.eval(**{k: tmx.nd.array(v) for k, v in vals.items()})
    np.testing.assert_allclose(got[0].asnumpy(), want[0].asnumpy(), **_FWD)


@pytest.mark.parametrize("op", ["Activation", "FullyConnected", "Convolution",
                                "Pooling", "Flatten", "BatchNorm",
                                "SoftmaxOutput", "LinearRegressionOutput",
                                "MAERegressionOutput",
                                "LogisticRegressionOutput", "SVMOutput",
                                "make_loss"])
def test_registration_matches_reference(op):
    """Keyword names and defaults, input and output counts and aliases of
    the ops a Symbol reaches by name, as the reference registers them."""
    import inspect
    from mxnet_tpu.ops import registry as ref_registry

    def spec(od):
        sig = inspect.signature(od.fn)
        return ({k: (None if v.default is v.empty else repr(v.default))
                 for k, v in sig.parameters.items()},
                od.num_inputs, od.num_outputs, tuple(od.aliases))
    assert spec(registry.get(op)) == spec(ref_registry.get(op))
