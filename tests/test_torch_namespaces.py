"""The namespaces and operators of ROADMAP item 2 on the port, against
the JAX reference on the CPU: `nd.linalg`, `nd.contrib` (with
`rand_zipfian` and `foreach`), `nd.op`, `mxnet_tpu_torch.contrib.ndarray`
and `.symbol`, `sym.random`, `sym.linalg`, `sym.contrib`, `sym.hypot`,
`mx.seed`, and the logical, invert and matmul operators of Symbol.

A `sym.random` node samples on its executor's device from that device's
generator each time the graph runs, and Symbol shape inference (on the
"meta" device) draws nothing. A hybridized block that calls
`F.random.uniform` draws anew at every call in the order the eager block
would: `examples/stochastic_depth.py`'s net, hybridized, repeats the
eager net's losses under one seed. The reference's `symbol.create` drops
positional scalars, so its traced gate is `()`; the port binds them (F9)
and keeps the example's (1, 1, 1, 1); the net's outputs have one shape in
both.

The coverage tests pin the op registry: every name of the reference's
(aliases included) is the port's, the 13 of ops/quantization.py and
ops/sparse.py among them; and no module of `mxnet_tpu_torch` imports jax
or `mxnet_tpu`. Mirrors
tests/test_contrib.py::test_rand_zipfian_nd_and_sym.

Tolerances: 1e-6 (the same arithmetic) unless a line says otherwise.
"""
import functools
import json
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import jax

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as ref_registry

import mxnet_tpu_torch as tmx
import torch
from mxnet_tpu_torch.ops import registry as port_registry

from chip_smoke import load_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOL = dict(rtol=1e-6, atol=1e-6)

#: the reference's registered names (aliases included) that ROADMAP item
#: 13 ported last: the 7 of ops/quantization.py and the 6 of
#: ops/sparse.py, with their aliases
ITEM_13 = {
    # ops/quantization.py
    "_contrib_quantize", "quantize", "_contrib_dequantize", "dequantize",
    "_contrib_requantize", "requantize",
    "_contrib_quantized_fully_connected", "quantized_fully_connected",
    "_contrib_quantized_conv", "quantized_conv",
    "_contrib_quantized_pooling", "quantized_pooling",
    "_contrib_quantized_flatten", "quantized_flatten",
    # ops/sparse.py
    "_rsp_to_dense", "_dense_to_rsp", "_csr_to_dense", "sparse_retain",
    "_sparse_retain", "_csr_dot_dense", "_rsp_dot_dense",
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# coverage
# ---------------------------------------------------------------------------


def _ref_ops():
    import mxnet_tpu.ops.contrib  # noqa: F401  (registers the ops)
    import mxnet_tpu.ops.custom  # noqa: F401
    import mxnet_tpu.ops.quantization  # noqa: F401
    import mxnet_tpu.ops.sparse  # noqa: F401
    return ref_registry.OPS


def test_op_coverage_leaves_item_13():
    """Item 13's last 13 names (quantization and sparse storage) are in
    the port's registry, each under the reference's primary name."""
    ref_ops = _ref_ops()
    assert ITEM_13 <= set(port_registry.OPS), \
        sorted(ITEM_13 - set(port_registry.OPS))
    for n in ITEM_13:
        assert port_registry.OPS[n].name == ref_ops[n].name, n
    assert len({ref_ops[n].name for n in ITEM_13}) == 13


def test_op_coverage_complete():
    """The port registers every name of the reference's 294 ops and
    their aliases, and none of its own."""
    ref_ops = _ref_ops()
    assert set(ref_ops) == set(port_registry.OPS), (
        sorted(set(ref_ops) - set(port_registry.OPS)),
        sorted(set(port_registry.OPS) - set(ref_ops)))
    assert len(ref_registry.list_ops()) == 294


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|mxnet_tpu)(?:\.|\s|$)",
                     re.M)


def test_port_imports_neither_jax_nor_the_reference():
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    if _IMPORT.search(fh.read()):
                        offenders.append(os.path.relpath(path, ROOT))
    for script in ("chip_smoke.py", "chip_smoke_faults.py"):
        with open(os.path.join(ROOT, script)) as fh:
            if _IMPORT.search(fh.read()):
                offenders.append(script)
    assert not offenders
    code = ("import sys, mxnet_tpu_torch as m; m.nd.contrib; m.sym.random;"
            " m.contrib.symbol; m.contrib.text; m.viz; m.test_utils;"
            " import mxnet_tpu_torch.notebook.callback;"
            " print(sorted(k for k in sys.modules if "
            "k.split('.')[0] in ('jax', 'mxnet_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


#: the reference's operator tools as they stood before the port began
#: (tools/*.py then); those that import jax or mxnet_tpu need a port
#: counterpart under mxnet_tpu_torch/tools/, the others drive the port as
#: they are
PRE_PORT_TOOLS = ("aot_warm.py", "bandwidth.py", "bench_sentinel.py",
                  "chaos_serve.py", "chaos_train.py", "diagnose.py",
                  "fleet_top.py", "im2rec.py", "kill_jobs.py", "launch.py",
                  "parse_log.py", "postmortem.py", "rec2idx.py",
                  "rollout.py", "serve.py", "train_supervise.py",
                  "train_top.py")


def test_reference_tools_have_port_counterparts():
    needs, shared = [], []
    for name in PRE_PORT_TOOLS:
        with open(os.path.join(ROOT, "tools", name)) as fh:
            (needs if _IMPORT.search(fh.read()) else shared).append(name)
    assert len(needs) == 8 and len(shared) == 9, (needs, shared)
    missing = [n for n in needs if not os.path.isfile(
        os.path.join(ROOT, "mxnet_tpu_torch", "tools", n))]
    assert not missing, missing


#: the reference's .py files with no port file at the same path: item
#: 11's three, still to port, and five covered under other names (the
#: Pallas kernels' Hopper counterparts under ops/csrc/ with their
#: wrappers, and IntervalSampler in gluon/data/sampler.py)
COVERED_ELSEWHERE = {"ops/pallas_paged.py", "ops/pallas_attention.py",
                     "ops/pallas_fused.py", "ops/pallas_rnn.py",
                     "gluon/contrib/data/sampler.py"}


def _py_files(pkg):
    root = os.path.join(ROOT, pkg)
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files
            if f.endswith(".py")}


def test_module_coverage_leaves_item_11_only():
    """Every reference file has a port file but the five covered
    elsewhere: item 11's three, once the only ones left, are ported too
    (the name is kept from when they were)."""
    missing = _py_files("mxnet_tpu") - _py_files("mxnet_tpu_torch")
    assert missing == COVERED_ELSEWHERE, (
        sorted(missing - COVERED_ELSEWHERE),
        sorted(COVERED_ELSEWHERE - missing))
    assert hasattr(tmx.gluon.data.sampler, "IntervalSampler")


def _public_names(relpath):
    """The top-level public names a reference file defines (functions,
    classes, assignments, and in a package's __init__ what it imports
    from its own submodules)."""
    import ast
    with open(os.path.join(ROOT, "mxnet_tpu", relpath)) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.ImportFrom) and node.level > 0 \
                and relpath.endswith("__init__.py"):
            names.update(a.asname or a.name for a in node.names)
    return sorted(n for n in names if not n.startswith("_"))


TOOLING_FILES = ("test_utils.py", "visualization.py", "ndarray_doc.py",
                 "contrib/__init__.py", "contrib/autograd.py",
                 "contrib/io.py", "contrib/tensorboard.py",
                 "contrib/text/__init__.py", "contrib/text/vocab.py",
                 "contrib/text/utils.py", "contrib/text/embedding.py",
                 "notebook/__init__.py", "notebook/callback.py")


@pytest.mark.parametrize("relpath", TOOLING_FILES)
def test_tooling_public_names_are_ported(relpath):
    import importlib
    mod = relpath[:-3].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[:-len(".__init__")]
    port = importlib.import_module("mxnet_tpu_torch." + mod)
    names = _public_names(relpath)
    assert names
    assert [n for n in names if not hasattr(port, n)] == []


ITEM11_FILES = ("serving/engine.py", "serving/server.py",
                "serving/__init__.py", "serving/spec.py",
                "telemetry/__init__.py", "telemetry/introspect.py",
                "aot/__init__.py", "aot/cache.py")


@pytest.mark.parametrize("relpath", ITEM11_FILES)
def test_item11_public_names_are_ported(relpath):
    """Every public name of the watchdog, the AOT cache and the serving
    files that carry the full-forward adapters is the port's."""
    test_tooling_public_names_are_ported(relpath)


def test_top_level_tooling_names_match_the_reference():
    for name in ("viz", "print_summary", "ndarray_doc", "test_utils",
                 "visualization", "contrib"):
        assert hasattr(mx, name) and hasattr(tmx, name), name
    assert tmx.viz is tmx.visualization
    assert len(_public_names("test_utils.py")) == 53


# ---------------------------------------------------------------------------
# nd namespaces
# ---------------------------------------------------------------------------

_LINALG_NAMES = ("gemm", "gemm2", "potrf", "potri", "trsm", "trmm",
                 "sumlogdiag", "syrk", "gelqf", "syevd")


def test_nd_linalg_names():
    for n in _LINALG_NAMES:
        assert hasattr(mx.nd.linalg, n)
        assert getattr(tmx.nd.linalg, n).__name__ == n
    a = np.random.RandomState(0).rand(2, 3, 4).astype(np.float32)
    b = np.random.RandomState(1).rand(2, 4, 5).astype(np.float32)
    ref = mx.nd.linalg.gemm2(mx.nd.array(a), mx.nd.array(b), alpha=2.0)
    port = tmx.nd.linalg.gemm2(tmx.nd.array(a), tmx.nd.array(b), alpha=2.0)
    np.testing.assert_allclose(port.asnumpy(), ref.asnumpy(), rtol=1e-5,
                               atol=1e-5)


def _public(ns):
    return {n for n in dir(ns) if not n.startswith("_")
            and callable(getattr(ns, n))}


def test_nd_contrib_names():
    ref = _public(mx.nd.contrib)
    port = _public(tmx.nd.contrib)
    assert port == ref - {"NDArray"}, sorted(port ^ ref)
    for n in ("AdaptiveAvgPooling2D", "BilinearResize2D", "div_sqrt_dim",
              "PagedAttention", "quadratic", "rand_zipfian", "foreach",
              "MultiBoxPrior", "box_nms", "ctc_loss", "CTCLoss",
              "quantize", "dequantize", "quantized_conv"):
        assert n in port
    assert tmx.contrib.ndarray.PagedAttention is \
        tmx.nd.contrib.PagedAttention
    assert tmx.nd.contrib.CTCLoss is tmx.nd.contrib.ctc_loss


def test_nd_op_is_the_flat_namespace():
    for n in ("dot", "topk", "slice", "linalg_gemm", "Convolution",
              "PagedAttention"):
        assert getattr(tmx.nd.op, n) is getattr(tmx.nd, n)
        assert hasattr(mx.nd.op, n)


def test_nd_contrib_quadratic():
    x = np.random.RandomState(2).rand(3, 4).astype(np.float32)
    ref = mx.nd.contrib.quadratic(mx.nd.array(x), a=2.0, b=3.0, c=1.0)
    port = tmx.nd.contrib.quadratic(tmx.nd.array(x), a=2.0, b=3.0, c=1.0)
    np.testing.assert_allclose(port.asnumpy(), ref.asnumpy(), **TOL)


def test_foreach_matches_reference():
    x = np.random.RandomState(3).rand(5, 2, 3).astype(np.float32)
    s0 = np.ones((2, 3), np.float32)

    def body(pkg):
        def step(d, states):
            new = states[0] * 0.5 + d
            return pkg.nd.tanh(new), [new]
        return step

    rout, rst = mx.nd.contrib.foreach(body(mx), mx.nd.array(x),
                                      [mx.nd.array(s0)])
    pout, pst = tmx.nd.contrib.foreach(body(tmx), tmx.nd.array(x),
                                       tmx.nd.array(s0))
    np.testing.assert_allclose(pout.asnumpy(), rout.asnumpy(), **TOL)
    np.testing.assert_allclose(pst[0].asnumpy(), rst[0].asnumpy(), **TOL)


def _zipfian_checks(samples, exp_true, exp_sampled, true_cls, N, R):
    s = samples
    assert s.shape == (N,) and s.min() >= 0 and s.max() < R
    want = np.log((true_cls + 2) / (true_cls + 1)) / math.log(R + 1) * N
    np.testing.assert_allclose(exp_true, want, rtol=1e-5)
    want_s = np.log((s + 2.0) / (s + 1.0)) / math.log(R + 1) * N
    np.testing.assert_allclose(exp_sampled, want_s, rtol=1e-5)
    counts = np.bincount(s.astype(np.int64), minlength=R)
    probs = np.log((np.arange(R) + 2.0) / (np.arange(R) + 1.0)) \
        / math.log(R + 1)
    sigma = np.sqrt(N * probs * (1 - probs))
    assert (np.abs(counts - N * probs) < 5 * sigma + 5).all()


def test_rand_zipfian_nd_and_sym():
    R, N = 50, 20000
    true_cls = np.array([0.0, 3.0, 49.0], np.float32)
    tmx.seed(7)
    out = tmx.nd.contrib.rand_zipfian(tmx.nd.array(true_cls), N, R)
    assert out[0].dtype == np.int32
    _zipfian_checks(*[o.asnumpy() for o in out], true_cls, N, R)
    with tmx.name.NameManager():
        sym = tmx.sym.contrib.rand_zipfian(tmx.sym.Variable("t"), N, R)
    ex = tmx.sym.Group(list(sym)).bind(
        tmx.cpu(), {"t": tmx.nd.array(true_cls)}, grad_req="null")
    outs = [o.asnumpy() for o in ex.forward()]
    _zipfian_checks(*outs, true_cls, N, R)
    with mx.name.NameManager():
        rsym = mx.sym.contrib.rand_zipfian(mx.sym.Variable("t"), N, R)
    shapes = [mx.sym.Group(list(rsym)).infer_shape(t=(3,))[1],
              tmx.sym.Group(list(sym)).infer_shape(t=(3,))[1]]
    assert [tuple(s) for s in shapes[1]] == [tuple(s) for s in shapes[0]]
    with pytest.raises(ValueError):
        tmx.nd.contrib.rand_zipfian(tmx.nd.array(true_cls), 4, 1 << 25)


# ---------------------------------------------------------------------------
# mx.seed and sym.random
# ---------------------------------------------------------------------------

_RANDOM = {
    "uniform": dict(low=-1.0, high=2.0, shape=(3, 4)),
    "normal": dict(loc=1.0, scale=2.0, shape=(3, 4)),
    "gamma": dict(alpha=2.0, beta=1.5, shape=(3, 4)),
    "exponential": dict(lam=2.0, shape=(3, 4)),
    "poisson": dict(lam=3.0, shape=(3, 4)),
    "randint": dict(low=0, high=7, shape=(3, 4)),
}


def test_top_level_seed():
    assert tmx.seed is tmx.random.seed and mx.seed is mx.random.seed
    tmx.seed(11)
    a = tmx.nd.random.uniform(shape=(5,)).asnumpy()
    tmx.seed(11)
    b = tmx.nd.random.uniform(shape=(5,)).asnumpy()
    np.testing.assert_array_equal(a, b)


def test_sym_random_names():
    for n in ("uniform", "normal", "gamma", "exponential", "poisson",
              "randint", "multinomial", "shuffle"):
        assert hasattr(mx.sym.random, n) and hasattr(tmx.sym.random, n)


def _gen_state():
    return tmx.random.generator("cpu").get_state().clone()


@pytest.mark.parametrize("name", sorted(_RANDOM))
def test_sym_random_node(name):
    """Its shape is the reference's; shape inference leaves the device
    generator as it was; the bound graph draws anew each run, on the
    executor's device, and a reseed repeats the draw."""
    params = _RANDOM[name]
    with tmx.name.NameManager():
        s = getattr(tmx.sym.random, name)(**params) + tmx.sym.Variable("x")
    with mx.name.NameManager():
        r = getattr(mx.sym.random, name)(**params) + mx.sym.Variable("x")
    tmx.seed(5)
    before = _gen_state()
    pshape = s.infer_shape(x=(3, 4))
    assert torch.equal(_gen_state(), before)
    assert pshape[1] == r.infer_shape(x=(3, 4))[1]
    ex = s.bind(tmx.cpu(), {"x": tmx.nd.zeros((3, 4))}, grad_req="null")
    first = ex.forward()[0].asnumpy()
    assert not torch.equal(_gen_state(), before)
    second = ex.forward()[0].asnumpy()
    assert not np.array_equal(first, second)
    tmx.seed(5)
    again = ex.forward()[0].asnumpy()
    np.testing.assert_array_equal(again, first)
    if name == "uniform":
        assert first.min() >= -1.0 and first.max() < 2.0


def test_sym_random_node_samples_on_the_executor_device(monkeypatch):
    """The node gets the executor's device (a creation op's `device=`),
    not the current context's."""
    seen = []
    opdef = port_registry.get("_random_uniform")
    orig = opdef.fn

    @functools.wraps(orig)
    def spy(*args, **kwargs):
        seen.append(str(kwargs.get("device")))
        return orig(*args, **kwargs)

    monkeypatch.setattr(opdef, "fn", spy)
    s = tmx.sym.random.uniform(shape=(2,))
    s.infer_shape()
    ex = s.bind(tmx.cpu(), {}, grad_req="null")
    ex.forward()
    assert seen == ["meta", "cpu"]


def test_sym_random_multinomial_and_shuffle():
    p = np.array([[0.1, 0.0, 0.9], [0.5, 0.5, 0.0]], np.float32)
    with tmx.name.NameManager():
        s = tmx.sym.random.multinomial(tmx.sym.Variable("p"), shape=(50,))
    out = s.bind(tmx.cpu(), {"p": tmx.nd.array(p)},
                 grad_req="null").forward()[0].asnumpy()
    assert out.shape == (2, 50)
    assert (out[0] != 1).all() and (out[1] != 2).all()
    x = np.arange(10, dtype=np.float32)
    with tmx.name.NameManager():
        sh = tmx.sym.random.shuffle(tmx.sym.Variable("x"))
    got = sh.bind(tmx.cpu(), {"x": tmx.nd.array(x)},
                  grad_req="null").forward()[0].asnumpy()
    np.testing.assert_array_equal(np.sort(got), x)


# ---------------------------------------------------------------------------
# sym.linalg, sym.contrib, sym.hypot and the Symbol operators
# ---------------------------------------------------------------------------


def _run_sym(pkg, build, arrays):
    names = ["a", "b"][:len(arrays)]
    with pkg.name.NameManager():
        s = build(pkg, *[pkg.sym.Variable(n) for n in names])
    if pkg is mx:
        with _ref_scope():
            ex = s.bind(mx.cpu(), {n: mx.nd.array(a)
                                   for n, a in zip(names, arrays)},
                        grad_req="null")
            return ex.forward()[0].asnumpy(), s
    ex = s.bind(tmx.cpu(), {n: tmx.nd.array(a)
                            for n, a in zip(names, arrays)}, grad_req="null")
    return ex.forward()[0].asnumpy(), s


_SYM_EXPR = {
    "and": lambda pkg, a, b: a & b, "rand": lambda pkg, a, b: 1.0 & a,
    "or": lambda pkg, a, b: a | b, "xor": lambda pkg, a, b: a ^ b,
    "rxor_scalar": lambda pkg, a, b: 0.0 ^ a,
    "invert": lambda pkg, a, b: ~a,
    "matmul": lambda pkg, a, b: a @ pkg.sym.transpose(b),
    "div": lambda pkg, a, b: a.__div__(b),
    "hypot": lambda pkg, a, b: pkg.sym.hypot(a, b),
    "hypot_scalar": lambda pkg, a, b: pkg.sym.hypot(a, 2.0),
    "rhypot_scalar": lambda pkg, a, b: pkg.sym.hypot(3.0, a),
    "linalg": lambda pkg, a, b: pkg.sym.linalg.gemm2(
        a, b, transpose_b=True),
    "contrib": lambda pkg, a, b: pkg.sym.contrib.div_sqrt_dim(a),
    "contrib_quadratic": lambda pkg, a, b: pkg.sym.contrib.quadratic(
        a, a=1.0, b=2.0, c=0.5),
}


@pytest.mark.parametrize("expr", sorted(_SYM_EXPR))
def test_symbol_operator(expr):
    rs = np.random.RandomState(4)
    a = rs.choice([0.0, 1.5, -2.0, 3.0], (3, 4)).astype(np.float32)
    b = rs.choice([1.0, -2.5, 4.0], (3, 4)).astype(np.float32)
    ref, rsym = _run_sym(mx, _SYM_EXPR[expr], [a, b])
    port, psym = _run_sym(tmx, _SYM_EXPR[expr], [a, b])
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
    ref_ops = [n["op"] for n in json.loads(rsym.tojson())["nodes"]]
    port_ops = [n["op"] for n in json.loads(psym.tojson())["nodes"]]
    assert port_ops == ref_ops


def test_sym_namespaces_names():
    for n in _LINALG_NAMES:
        assert hasattr(tmx.sym.linalg, n)
    assert _public(tmx.sym.contrib) == _public(mx.sym.contrib)
    for n in ("AdaptiveAvgPooling2D", "BilinearResize2D", "div_sqrt_dim",
              "PagedAttention", "quadratic", "rand_zipfian", "quantize",
              "quantized_fully_connected"):
        assert hasattr(tmx.sym.contrib, n) and hasattr(mx.sym.contrib, n)
        assert getattr(tmx.contrib.symbol, n) is getattr(tmx.sym.contrib, n)


# ---------------------------------------------------------------------------
# a hybridized random op: examples/stochastic_depth.py
# ---------------------------------------------------------------------------


def _sd_batches(n, batch):
    rs = np.random.RandomState(9)
    return [(rs.rand(batch, 1, 28, 28).astype(np.float32),
             rs.randint(0, 10, batch).astype(np.float32)) for _ in range(n)]


def _sd_run(module, hybridize, batches, seed=1, record=None):
    """Adam steps of the example's net (seeded weights) under one seed:
    the losses, and each step's uniform draws when `record` collects."""
    tmx.seed(0)
    net = module.build(4, 0.5)
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.array(batches[0][0]))  # finish deferred init
    for i, (_, p) in enumerate(sorted(net.collect_params().items())):
        p.set_data(tmx.nd.array(np.random.RandomState(i).uniform(
            -0.1, 0.1, p.shape).astype(np.float32)))
    if hybridize:
        net.hybridize()
    trainer = tmx.gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": 0.001})
    ce = tmx.gluon.loss.SoftmaxCrossEntropyLoss()
    tmx.seed(seed)
    losses = []
    for x, y in batches:
        if record is not None:
            record.append([])
        with tmx.autograd.record():
            loss = ce(net(tmx.nd.array(x)), tmx.nd.array(y))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))
    return losses, net


def test_hybridized_stochastic_depth(monkeypatch):
    module = load_example("stochastic_depth.py", tmx)
    draws = []
    opdef = port_registry.get("_random_uniform")
    orig = opdef.fn

    @functools.wraps(orig)
    def spy(*args, **kwargs):
        out = orig(*args, **kwargs)
        if out.device.type != "meta" and draws:
            draws[-1].append((tuple(out.shape), float(out.reshape(-1)[0])))
        return out

    monkeypatch.setattr(opdef, "fn", spy)
    batches = _sd_batches(4, 8)
    eager, _ = _sd_run(module, False, batches)
    hyb, net = _sd_run(module, True, batches, record=draws)
    assert net._cached_graph is not None
    np.testing.assert_allclose(hyb, eager, rtol=1e-5, atol=1e-6)
    # four gates a step, (1, 1, 1, 1) each, fresh at every step
    assert [len(d) for d in draws] == [4, 4, 4, 4]
    assert all(shape == (1, 1, 1, 1) for d in draws for shape, _ in d)
    assert len({tuple(v for _, v in d) for d in draws}) == 4
    again = []
    draws[:] = []
    hyb2, _ = _sd_run(module, True, batches, record=again)
    assert hyb2 == hyb


def test_stochastic_depth_output_shape_matches_reference():
    """The traced gate's shape differs ((1, 1, 1, 1) here, () in the
    reference, whose symbol.create drops positional scalars); the net's
    output shape is one."""
    port_mod = load_example("stochastic_depth.py", tmx)
    ref_mod = load_example("stochastic_depth.py", mx)
    shapes = []
    for pkg, module in ((mx, ref_mod), (tmx, port_mod)):
        with pkg.name.NameManager():
            net = module.build(2, 0.5)
            with pkg.autograd.train_mode():
                out = net(pkg.sym.Variable("data"))
        arg, o, _ = out.infer_shape(data=(4, 1, 28, 28))
        shapes.append(o)
        gates = [n for n in json.loads(out.tojson())["nodes"]
                 if n["op"] == "_random_uniform"]
        assert len(gates) == 2
        if pkg is tmx:
            assert all(eval(g["attrs"]["shape"]) == (1, 1, 1, 1)
                       for g in gates)
    assert [tuple(s) for s in shapes[1]] == [tuple(s) for s in shapes[0]]


def test_chip_smoke_phase_21_rehearses_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's phase 21 at a tiny size on the CPU (the card's
    wrappers replaced by the plain versions, a counting K1 wrapper): its
    checks pass where the card and the CPU are one device."""
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import paged_attention as pa
    for name, value in dict(ITEM2_N=(64, 64), ITEM2_M=(32, 32),
                            ITEM2_LOGITS=(4, 300), ITEM2_BATCH=(2, 8, 8),
                            ITEM2_MM=(2, 16, 16), ITEM2_IMAGES=1,
                            ITEM2_ROIS=4, ITEM2_CORR=(1, 8, 12, 16),
                            SD_BATCH=4, SD_STEPS=2).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "time_ms", lambda torch, fn, **kw: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(tmx, "gpu", lambda i=0: tmx.cpu())
    plain = pa.paged_attention

    @functools.wraps(plain)
    def counting(q, *args, **kwargs):
        out = plain(q, *args, **kwargs)
        counting.launches += 1
        return out

    counting.launches = 0
    monkeypatch.setattr(pa, "paged_attention", counting)
    dev = torch.device("cpu")
    out = cs.phase_item2_ops(torch, np, dev, "cpu")
    assert out["names"] == 119 and out["aliases"]["count"] == 20
    assert cs.phase_paged_op(torch, np, dev, "cpu") == 5
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    assert cs.phase_nce_example(torch, np, dev, "cpu")["rc"] == 0
    sd = cs.phase_stochastic_depth(torch, np, dev, "cpu")
    assert sd["losses"] == sd["eager_losses"]
