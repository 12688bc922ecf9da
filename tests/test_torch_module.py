"""Port parity for the executor, the optimizer repair, the kvstore, the
Module API and the checkpoints (mxnet_tpu_torch.executor / optimizer /
kvstore / module / model), and for SequentialModule, PythonModule /
PythonLossModule, Monitor and executor_manager, against the JAX
reference on the CPU.

Both packages get the same numpy parameters and batches from a seed
(`models.module_params_from_numpy` on the port's side, `set_params` on
the reference's); Xavier itself draws from jax.random there and from
torch here, so it is compared by its moments only. Every reference
Executor / Module call runs inside `mxnet_tpu.random.trace_key_scope`,
as its eager forward needs on a jax without `jax.core.trace_state_clean`.

Tolerances: float32 outputs, gradients and parameters after three
updates 1e-5; the BatchNorm net's flag-on gradients against flag off
1e-4 (tests/test_torch_fused_bn.py's tolerance for the BatchNorm ops'
gradients); metric values exact up to 1e-6; float16 master-weight
updates 1e-3 (one float16 rounding).
"""
import os

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import module_params_from_numpy

import chip_smoke

_FWD = dict(rtol=1e-5, atol=1e-5)
_BN_FLAG = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _make(which, sym):
    if which == "bn_convnet":
        return chip_smoke.bn_convnet(sym)
    models = mx.models if sym is mx.sym else tmx.models
    return getattr(models, "get_" + which)()


SHAPES = {"mlp": (8, 784), "lenet": (8, 1, 28, 28),
          "bn_convnet": (8, 1, 28, 28)}


def _twin(which):
    with mx.name.NameManager():
        ref = _make(which, mx.sym)
    with tmx.name.NameManager():
        port = _make(which, tmx.sym)
    return ref, port


def _arrays(sym, data_shape, seed=0):
    """({param name: array}, {aux name: array}, data, label) from a seed."""
    rng = np.random.RandomState(seed)
    args, _, aux = sym.infer_shape(data=data_shape)
    params = {}
    for n, s in zip(sym.list_arguments(), args):
        if n not in ("data", "softmax_label"):
            scale = 1.0 / np.sqrt(np.prod(s[1:])) if len(s) > 1 else 0.1
            params[n] = (scale * rng.randn(*s)).astype(np.float32)
    auxs = {n: (rng.rand(*s) + (0.5 if n.endswith("var") else 0.0))
            .astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux)}
    data = rng.rand(*data_shape).astype(np.float32)
    label = rng.randint(0, 10, data_shape[0]).astype(np.float32)
    return params, auxs, data, label


# ---------------------------------------------------------------------------
# the optimizer repair
# ---------------------------------------------------------------------------


def test_optimizer_takes_sym_and_multi_precision_and_reads_lr_mult():
    """optimizer.create(..., sym=, multi_precision=) is accepted, and the
    symbol's __lr_mult__ / __wd_mult__ scale the update as in the
    reference."""
    def make(sym):
        w = sym.Variable("fc_weight", lr_mult=3.0, wd_mult=0.0)
        return sym.FullyConnected(sym.Variable("data"), weight=w,
                                  num_hidden=4, name="fc")
    with mx.name.NameManager():
        ref_sym = make(mx.sym)
    with tmx.name.NameManager():
        port_sym = make(tmx.sym)
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01,
              multi_precision=True,
              param_idx2name={0: "fc_weight", 1: "fc_bias"})
    ref_opt = mx.optimizer.create("sgd", sym=ref_sym, **kw)
    port_opt = tmx.optimizer.create("sgd", sym=port_sym, **kw)
    assert port_opt.lr_mult == ref_opt.lr_mult == {"fc_weight": 3.0}
    assert port_opt.wd_mult == ref_opt.wd_mult
    rng = np.random.RandomState(0)
    w0, g = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3).astype(
        np.float32)
    ref_w, port_w = mx.nd.array(w0), tmx.nd.array(w0)
    ref_up, port_up = mx.optimizer.get_updater(ref_opt), \
        tmx.optimizer.get_updater(port_opt)
    for _ in range(3):
        ref_up(0, mx.nd.array(g), ref_w)
        port_up(0, tmx.nd.array(g), port_w)
    np.testing.assert_allclose(port_w.asnumpy(), ref_w.asnumpy(), **_FWD)
    # lr_mult 3 moved the weight three times as far as lr_mult 1 would
    plain = tmx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9)
    plain_w = tmx.nd.array(w0)
    up = tmx.optimizer.get_updater(plain)
    for _ in range(3):
        up(0, tmx.nd.array(g), plain_w)
    np.testing.assert_allclose(port_w.asnumpy() - w0,
                               3.0 * (plain_w.asnumpy() - w0), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_multi_precision_float16_matches_reference(name):
    """A float16 weight updated through a float32 master copy, as the
    reference's."""
    rng = np.random.RandomState(1)
    w0 = rng.randn(5, 6).astype(np.float16)
    grads = [rng.randn(5, 6).astype(np.float16) for _ in range(3)]
    kw = dict(learning_rate=0.05, multi_precision=True)
    if name == "sgd":
        kw["momentum"] = 0.9
    ref_up = mx.optimizer.get_updater(mx.optimizer.create(name, **kw))
    port_up = tmx.optimizer.get_updater(tmx.optimizer.create(name, **kw))
    ref_w, port_w = mx.nd.array(w0, dtype="float16"), \
        tmx.nd.array(w0, dtype="float16")
    for g in grads:
        ref_up(0, mx.nd.array(g, dtype="float16"), ref_w)
        port_up(0, tmx.nd.array(g, dtype="float16"), port_w)
    assert port_w.dtype == np.float16
    master = port_up.states[0][0]
    assert master.dtype == np.float32
    np.testing.assert_allclose(master.asnumpy(),
                               ref_up.states[0][0].asnumpy(), **_FWD)
    np.testing.assert_allclose(port_w.asnumpy().astype(np.float32),
                               ref_w.asnumpy().astype(np.float32),
                               rtol=1e-3, atol=1e-3)


def test_multi_precision_bfloat16_keeps_a_float32_master():
    opt = tmx.optimizer.create("sgd", learning_rate=0.5,
                               multi_precision=True)
    up = tmx.optimizer.get_updater(opt)
    w = tmx.nd.array(np.ones((4,), np.float32), dtype="bfloat16")
    for _ in range(4):  # 1e-3 steps vanish in bfloat16 alone
        up(0, tmx.nd.array(np.full((4,), 1e-3, np.float32),
                           dtype="bfloat16"), w)
    master = up.states[0][0]
    assert master._data.dtype == torch.float32
    g = float(torch.tensor(1e-3).bfloat16())
    np.testing.assert_allclose(master.asnumpy(), 1 - 4 * 0.5 * g, rtol=1e-6)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _bind_pair(which, req, seed=0):
    ref_sym, port_sym = _twin(which)
    params, auxs, data, label = _arrays(port_sym, SHAPES[which], seed)
    vals = dict(params, data=data, softmax_label=label)

    def bind(pkg, sym, ctx):
        args = {k: pkg.nd.array(v) for k, v in vals.items()}
        grads = {k: pkg.nd.zeros(v.shape) for k, v in vals.items()}
        aux = {k: pkg.nd.array(v) for k, v in auxs.items()}
        return sym.bind(ctx, args=args, args_grad=grads, grad_req=req,
                        aux_states=aux)
    with _ref_scope():
        ref = bind(mx, ref_sym, mx.cpu())
    return ref, bind(tmx, port_sym, tmx.cpu())


@pytest.mark.parametrize("req", ["write", "add", "null"])
@pytest.mark.parametrize("which", sorted(SHAPES))
def test_executor_forward_backward_match_reference(which, req):
    """Two training forward / backward passes: outputs, every gradient by
    grad_req (add accumulates both passes, null leaves the zeros) and the
    moving statistics; then an inference forward."""
    ref, port = _bind_pair(which, req)
    for _ in range(2):
        with _ref_scope():
            want = ref.forward(is_train=True)[0].asnumpy()
            ref.backward()
        got = port.forward(is_train=True)[0].asnumpy()
        port.backward()
        np.testing.assert_allclose(got, want, **_FWD)
    assert sorted(port.grad_dict) == sorted(ref.grad_dict)
    for n, g in ref.grad_dict.items():
        np.testing.assert_allclose(port.grad_dict[n].asnumpy(), g.asnumpy(),
                                   err_msg=n, **_FWD)
    for n, a in ref.aux_dict.items():
        np.testing.assert_allclose(port.aux_dict[n].asnumpy(), a.asnumpy(),
                                   err_msg=n, **_FWD)
    with _ref_scope():
        want = ref.forward(is_train=False)[0].asnumpy()
    np.testing.assert_allclose(port.forward(is_train=False)[0].asnumpy(),
                               want, **_FWD)


def test_executor_backward_with_head_gradient_and_without_kept_graph():
    """An explicit head gradient reaches a non-head graph; a backward after
    an inference forward evaluates the graph again in training mode, as
    the reference's re-trace does."""
    def make(sym):
        x = sym.Variable("x")
        return sym.FullyConnected(x, num_hidden=3, name="fc") * 2.0
    with mx.name.NameManager():
        ref_sym = make(mx.sym)
    with tmx.name.NameManager():
        port_sym = make(tmx.sym)
    rng = np.random.RandomState(2)
    vals = {"x": rng.randn(4, 5), "fc_weight": rng.randn(3, 5),
            "fc_bias": rng.randn(3)}
    head = rng.randn(4, 3).astype(np.float32)

    def run(pkg, sym):
        ex = sym.simple_bind(pkg.cpu(), x=(4, 5))
        ex.copy_params_from({k: pkg.nd.array(v) for k, v in vals.items()})
        ex.forward(is_train=False)
        ex.backward(out_grads=[pkg.nd.array(head)])
        return {k: v.asnumpy() for k, v in ex.grad_dict.items()}
    with _ref_scope():
        want = run(mx, ref_sym)
    got = run(tmx, port_sym)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **_FWD)


def test_executor_surface():
    port_sym = tmx.models.get_mlp()
    ex = port_sym.simple_bind(tmx.cpu(), data=(2, 784))
    assert [a.shape for a in ex.arg_arrays][:2] == [(2, 784), (128, 784)]
    assert len(ex.grad_arrays) == len(ex.arg_arrays)
    seen = []
    ex.set_monitor_callback(lambda name, arr: seen.append(name))
    ex.forward()
    assert seen == ["softmax_output"]
    assert list(ex.output_dict) == ["softmax_output"]
    assert "FullyConnected" in ex.debug_str()
    ex2 = ex.reshape(data=(5, 784), softmax_label=(5,))
    assert ex2.forward()[0].shape == (5, 10)
    with pytest.raises(MXNetError):
        ex.forward(nope=np.zeros(1))


# ---------------------------------------------------------------------------
# kvstore
# ---------------------------------------------------------------------------


def test_kvstore_local_push_pull_and_optimizer():
    kv = tmx.kv.create("local")
    assert kv.type == "local" and kv.rank == 0 and kv.num_workers == 1
    kv.init(3, tmx.nd.ones((2, 2)))
    kv.push(3, [tmx.nd.ones((2, 2)), tmx.nd.ones((2, 2))])
    out = tmx.nd.zeros((2, 2))
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 3.0))
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.5))
    kv.push(3, tmx.nd.ones((2, 2)))
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 2.5))
    assert tmx.kv.create("device").type == "device"


@pytest.mark.parametrize("kind", ["nccl", "dist_sync", "tpu"])
def test_kvstore_distributed_types_raise_naming_slice_5(kind):
    """The distributed types are stores now (distributed training): with
    no world and no launcher variables, a world of one worker, as the
    reference's, whose row-sparse pull gathers the asked rows. (The name
    is kept from the slice that made them stores.)"""
    kv = tmx.kv.create(kind)
    assert kv.type == kind and kv.rank == 0 and kv.num_workers == 1
    kv.init(3, tmx.nd.ones((2, 2)))
    kv.push(3, [tmx.nd.ones((2, 2)), tmx.nd.ones((2, 2))])
    out = tmx.nd.zeros((2, 2))
    kv.pull(3, out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 3.0))
    kv.row_sparse_pull(3, out=out, row_ids=tmx.nd.array([1]))
    np.testing.assert_array_equal(out.asnumpy(), [[0, 0], [3, 3]])
    rsp = tmx.nd.sparse.zeros("row_sparse", (2, 2))
    kv.row_sparse_pull(3, out=rsp, row_ids=tmx.nd.array([0]))
    np.testing.assert_array_equal(rsp.indices.asnumpy(), [0])
    np.testing.assert_array_equal(rsp.data.asnumpy(), [[3, 3]])


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------


def _module_pair(which, kvstore="local", seed=0):
    """Bound, initialized twin Modules at batch 8 with the same numpy
    parameters and SGD-momentum optimizers (rescale 1/batch by default),
    and the numpy batch."""
    ref_sym, port_sym = _twin(which)
    shape = SHAPES[which]
    params, auxs, data, label = _arrays(port_sym, shape, seed)
    opt = {"learning_rate": 0.1, "momentum": 0.9}
    with _ref_scope():
        ref = mx.mod.Module(ref_sym, context=mx.cpu())
        ref.bind(data_shapes=[("data", shape)],
                 label_shapes=[("softmax_label", (shape[0],))])
        ref.init_params(mx.init.Xavier())
        ref.set_params({k: mx.nd.array(v) for k, v in params.items()},
                       {k: mx.nd.array(v) for k, v in auxs.items()})
        ref.init_optimizer(kvstore=kvstore, optimizer="sgd",
                           optimizer_params=opt)
    port = tmx.mod.Module(port_sym, context=tmx.cpu())
    port.bind(data_shapes=[("data", shape)],
              label_shapes=[("softmax_label", (shape[0],))])
    port.init_params(tmx.init.Xavier())
    module_params_from_numpy(port, params, auxs)
    port.init_optimizer(kvstore=kvstore, optimizer="sgd",
                        optimizer_params=opt)
    return ref, port, data, label


def _batches(data, label, n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        perm = rng.permutation(len(data))
        out.append((data[perm] + 0.01 * rng.randn(*data.shape).astype(
            np.float32), label[perm]))
    return out


@pytest.mark.parametrize("kvstore", ["local", None])
@pytest.mark.parametrize("which", sorted(SHAPES))
def test_module_three_updates_match_reference(which, kvstore):
    """Three SGD-momentum updates (rescale_grad 1/batch): every parameter,
    aux state and output, and score, as the reference's."""
    ref, port, data, label = _module_pair(which, kvstore)
    assert port._param_names == ref._param_names
    for x, y in _batches(data, label, 3, seed=1):
        with _ref_scope():
            ref.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                                 [mx.nd.array(y)]))
            ref.update()
        port.forward_backward(tmx.io.DataBatch([tmx.nd.array(x)],
                                               [tmx.nd.array(y)]))
        port.update()
        np.testing.assert_allclose(port.get_outputs()[0].asnumpy(),
                                   ref.get_outputs()[0].asnumpy(), **_FWD)
    assert port._optimizer.rescale_grad == ref._optimizer.rescale_grad \
        == 1.0 / 8
    ref_args, ref_aux = ref.get_params()
    port_args, port_aux = port.get_params()
    for n in ref_args:
        np.testing.assert_allclose(port_args[n].asnumpy(),
                                   ref_args[n].asnumpy(), err_msg=n, **_FWD)
    for n in ref_aux:
        np.testing.assert_allclose(port_aux[n].asnumpy(),
                                   ref_aux[n].asnumpy(), err_msg=n, **_FWD)
    val_x, val_y = _batches(data, label, 1, seed=9)[0]
    with _ref_scope():
        want = ref.score(mx.io.NDArrayIter(val_x, val_y, batch_size=8),
                         ["acc", "ce"])
    got = port.score(tmx.io.NDArrayIter(val_x, val_y, batch_size=8),
                     ["acc", "ce"])
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("which", ["mlp", "bn_convnet"])
def test_checkpoint_crosses_between_packages(which, writer, tmp_path):
    """save_checkpoint by one package, load_checkpoint (and Module.load)
    by the other: the same symbol, parameters and outputs."""
    ref, port, data, label = _module_pair(which)
    prefix = str(tmp_path / which)
    with _ref_scope():
        (port if writer == "port" else ref).save_checkpoint(prefix, 3)
    sym, args, aux = (mx.model.load_checkpoint if writer == "port" else
                      tmx.model.load_checkpoint)(prefix, 3)
    src_args, src_aux = (port if writer == "port" else ref).get_params()
    assert sorted(args) == sorted(src_args) and sorted(aux) == \
        sorted(src_aux)
    for n in src_args:
        np.testing.assert_array_equal(args[n].asnumpy(),
                                      src_args[n].asnumpy())
    batch_x = data[:8]
    it_args = (batch_x, label[:8])
    if writer == "port":
        with _ref_scope():
            loaded = mx.mod.Module.load(prefix, 3, context=mx.cpu())
            loaded.bind(data_shapes=[("data", SHAPES[which])],
                        label_shapes=[("softmax_label", (8,))],
                        for_training=False)
            got = loaded.predict(mx.io.NDArrayIter(*it_args, batch_size=8))
        want = port.predict(tmx.io.NDArrayIter(*it_args, batch_size=8))
    else:
        loaded = tmx.mod.Module.load(prefix, 3, context=tmx.cpu())
        loaded.bind(data_shapes=[("data", SHAPES[which])],
                    label_shapes=[("softmax_label", (8,))],
                    for_training=False)
        got = loaded.predict(tmx.io.NDArrayIter(*it_args, batch_size=8))
        with _ref_scope():
            want = ref.predict(mx.io.NDArrayIter(*it_args, batch_size=8))
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **_FWD)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_params_files_cross_between_packages(writer, tmp_path):
    """nd.save by one package, nd.load by the other: dicts and lists,
    float32, int32 and bfloat16 (as uint16 bits)."""
    path = str(tmp_path / "x.params")
    rng = np.random.RandomState(4)
    f32 = rng.randn(3, 4).astype(np.float32)
    i32 = rng.randint(0, 9, (5,)).astype(np.int32)
    if writer == "port":
        tmx.nd.save(path, {"a": tmx.nd.array(f32), "b": tmx.nd.array(i32),
                           "c": tmx.nd.array(f32, dtype="bfloat16")})
        back = mx.nd.load(path)
    else:
        mx.nd.save(path, {"a": mx.nd.array(f32), "b": mx.nd.array(i32),
                          "c": mx.nd.array(f32, dtype="bfloat16")})
        back = tmx.nd.load(path)
    np.testing.assert_array_equal(back["a"].asnumpy(), f32)
    np.testing.assert_array_equal(back["b"].asnumpy(), i32)
    bf16 = torch.from_numpy(f32).bfloat16().float().numpy()
    np.testing.assert_array_equal(back["c"].asnumpy().astype(np.float32),
                                  bf16)
    lpath = str(tmp_path / "l.params")
    (tmx if writer == "port" else mx).nd.save(
        lpath, [(tmx if writer == "port" else mx).nd.array(f32)])
    loaded = (mx if writer == "port" else tmx).nd.load(lpath)
    assert isinstance(loaded, list) and len(loaded) == 1
    with open(lpath, "rb") as f:
        from_buf = (mx if writer == "port" else tmx).nd.load_frombuffer(
            f.read())
    np.testing.assert_array_equal(from_buf[0].asnumpy(), f32)


@pytest.mark.parametrize("which", ["mlp", "lenet"])
def test_module_fit_reaches_accuracy(which, tmp_path):
    """Module.fit on the synthetic MNIST (one epoch at batch 100, SGD lr
    0.1 momentum 0.9, Xavier) passes 0.9 accuracy; do_checkpoint and
    Module.load give the trained outputs bit for bit."""
    np.random.seed(0)
    shape = (784,) if which == "mlp" else (1, 28, 28)
    train, val = tmx.test_utils.get_mnist_iterator(batch_size=100,
                                                   input_shape=shape)
    mod = tmx.mod.Module(_make(which, tmx.sym))
    prefix = str(tmp_path / which)
    mod.fit(train, eval_data=val, optimizer="sgd",
            initializer=tmx.init.Xavier(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            num_epoch=1, epoch_end_callback=tmx.callback.do_checkpoint(
                prefix),
            batch_end_callback=tmx.callback.Speedometer(100, 20))
    assert mod.score(val, "acc")[0][1] > 0.9
    want = mod.predict(val)
    loaded = tmx.mod.Module.load(prefix, 1)
    loaded.bind(data_shapes=val.provide_data,
                label_shapes=val.provide_label, for_training=False)
    np.testing.assert_array_equal(loaded.predict(val).asnumpy(),
                                  want.asnumpy())


def test_xavier_moments_match_reference():
    """Xavier draws from jax.random there and torch here: the same bound
    and moments, not the same numbers."""
    ref_sym, port_sym = _twin("lenet")
    with _ref_scope():
        ref = mx.mod.Module(ref_sym, context=mx.cpu())
        ref.bind(data_shapes=[("data", (8, 1, 28, 28))])
        ref.init_params(mx.init.Xavier())
    port = tmx.mod.Module(port_sym)
    port.bind(data_shapes=[("data", (8, 1, 28, 28))])
    port.init_params(tmx.init.Xavier())
    for n in ("conv2_weight", "fc1_weight"):
        r, p = ref.get_params()[0][n].asnumpy(), port.get_params()[0][n] \
            .asnumpy()
        bound = np.sqrt(3.0 / ((r.shape[0] + r.shape[1]) / 2.0
                               * np.prod(r.shape[2:])))
        assert np.abs(p).max() <= bound and np.abs(r).max() <= bound
        np.testing.assert_allclose(p.std(), r.std(), rtol=0.05)
        assert abs(p.mean()) < 0.05 * bound
    for n in ("conv1_bias", "fc2_bias"):
        assert not port.get_params()[0][n].asnumpy().any()


def test_bn_convnet_flag_on_matches_flag_off_and_reference():
    """The executor's BatchNorm through the fused path (its plain versions
    here) against the composite, and both against the reference: the first
    step's outputs and gradients, and the moving statistics after one
    update."""
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    results = {}
    try:
        for flag in ("1", "0"):
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = flag
            ref, port, data, label = _module_pair("bn_convnet")
            batch = (data, label)
            port.forward_backward(tmx.io.DataBatch(
                [tmx.nd.array(batch[0])], [tmx.nd.array(batch[1])]))
            out = port.get_outputs()[0].asnumpy()
            grads = {n: g.asnumpy() for n, g in
                     port._exec.grad_dict.items()}
            port.update()
            results[flag] = (out, grads, {n: a.asnumpy() for n, a in
                                          port.get_params()[1].items()})
        os.environ["MXNET_FUSED_BN_EPILOGUE"] = "0"
        with _ref_scope():
            ref.forward_backward(mx.io.DataBatch([mx.nd.array(data)],
                                                 [mx.nd.array(label)]))
            want_out = ref.get_outputs()[0].asnumpy()
            want_g = {n: g.asnumpy() for n, g in
                      ref._exec.grad_dict.items()}
            ref.update()
        want_aux = {n: a.asnumpy() for n, a in ref.get_params()[1].items()}
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    on, off = results["1"], results["0"]
    np.testing.assert_allclose(on[0], off[0], **_FWD)
    np.testing.assert_allclose(off[0], want_out, **_FWD)
    assert sorted(on[1]) == sorted(want_g)
    for n in want_g:
        np.testing.assert_allclose(on[1][n], off[1][n], err_msg=n,
                                   **_BN_FLAG)
        np.testing.assert_allclose(off[1][n], want_g[n], err_msg=n, **_FWD)
    assert sorted(on[2]) == ["bn1_moving_mean", "bn1_moving_var",
                             "bn2_moving_mean", "bn2_moving_var"]
    for n in want_aux:
        np.testing.assert_allclose(on[2][n], off[2][n], err_msg=n, **_FWD)
        np.testing.assert_allclose(off[2][n], want_aux[n], err_msg=n,
                                   **_FWD)


def test_module_rebind_keeps_parameters_and_optimizer_states(tmp_path):
    ref, port, data, label = _module_pair("mlp", kvstore=None)
    port.forward_backward(tmx.io.DataBatch([tmx.nd.array(data)],
                                           [tmx.nd.array(label)]))
    port.update()
    before = port.get_params()[0]
    port.reshape(data_shapes=[("data", (4, 784))],
                 label_shapes=[("softmax_label", (4,))])
    after = port.get_params()[0]
    for n in before:
        np.testing.assert_array_equal(after[n].asnumpy(),
                                      before[n].asnumpy())
    assert port.output_shapes == [("softmax_output", (4, 10))]
    f = str(tmp_path / "opt.states")
    port.save_optimizer_states(f)
    port.load_optimizer_states(f)
    other = tmx.mod.Module(tmx.models.get_mlp())
    other.bind(data_shapes=[("data", (4, 784))],
               label_shapes=[("softmax_label", (4,))])
    other.init_params()
    other.borrow_optimizer(port)
    assert other._updater is port._updater
    outs = list(port.iter_predict(tmx.io.NDArrayIter(
        data[:6], label[:6], batch_size=4)))
    assert [o[0][0].shape for o in outs] == [(4, 10), (2, 10)]


def test_feedforward_fits_and_scores():
    np.random.seed(1)
    train, val = tmx.test_utils.get_mnist_iterator(batch_size=100,
                                                   input_shape=(784,))
    ff = tmx.model.FeedForward(tmx.models.get_mlp(), ctx=tmx.cpu(),
                               num_epoch=1, initializer=tmx.init.Xavier(),
                               optimizer_params={"learning_rate": 0.1})
    ff.fit(train)
    assert ff.score(val) > 0.9


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_save_params_cross_and_optimizer_states_preload(writer, tmp_path):
    """BaseModule.save_params by one package, load_params by the other;
    Module.load(load_optimizer_states=True) restores the momentum."""
    ref, port, data, label = _module_pair("mlp", kvstore=None)
    path = str(tmp_path / "mlp.params")
    with _ref_scope():
        (port if writer == "port" else ref).save_params(path)
        dst = ref if writer == "port" else port
        dst.set_params({n: (mx if dst is ref else tmx).nd.zeros(a.shape)
                        for n, a in dst.get_params()[0].items()}, {})
        dst.load_params(path)
    src_args = (port if writer == "port" else ref).get_params()[0]
    for n, a in dst.get_params()[0].items():
        np.testing.assert_array_equal(a.asnumpy(), src_args[n].asnumpy())
    port.forward_backward(tmx.io.DataBatch([tmx.nd.array(data)],
                                           [tmx.nd.array(label)]))
    port.update()
    prefix = str(tmp_path / "ck")
    port.save_checkpoint(prefix, 1, save_optimizer_states=True)
    loaded = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True)
    loaded.bind(data_shapes=[("data", (8, 784))],
                label_shapes=[("softmax_label", (8,))])
    loaded.init_optimizer(kvstore=None, optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1,
                                            "momentum": 0.9})
    for i, st in port._updater.states.items():
        np.testing.assert_array_equal(loaded._updater.states[i].asnumpy(),
                                      st.asnumpy())


# ---------------------------------------------------------------------------
# SequentialModule, PythonLossModule, Monitor, executor_manager
# ---------------------------------------------------------------------------


def _sequential(pkg, head="module"):
    """get_mlp as a SequentialModule: chip_smoke.mlp_halves' features,
    then its head Module (taking the labels) or, head="python", a
    PythonLossModule whose gradient is softmax(scores) - onehot(label)."""
    with pkg.name.NameManager():
        features, top = chip_smoke.mlp_halves(pkg.sym)
        if head == "python":
            features = pkg.sym.FullyConnected(features, name="fc3",
                                              num_hidden=10)
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(features, label_names=None, context=pkg.cpu()))
    if head == "python":
        seq.add(pkg.mod.PythonLossModule(grad_func=_softmax_grad),
                take_labels=True, auto_wiring=True)
    else:
        seq.add(pkg.mod.Module(top, context=pkg.cpu()), take_labels=True,
                auto_wiring=True)
    return seq


def _softmax_grad(scores, labels):
    """The softmax cross-entropy gradient, from the host arrays."""
    s = scores.asnumpy().astype(np.float64)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(len(p)), labels.asnumpy().astype(np.int64)] -= 1.0
    return p.astype(np.float32)


@pytest.mark.parametrize("head", ["module", "python"])
def test_sequential_module_matches_reference(head):
    """Three SGD updates through the chained modules: outputs, the input
    gradients the head hands back, and every parameter."""
    shape = (8, 784)
    ref, port = _sequential(mx, head), _sequential(tmx, head)
    rng = np.random.RandomState(3)
    data_shapes = [("data", shape)]
    label_shapes = [("softmax_label", (8,))]
    with _ref_scope():
        ref.bind(data_shapes, label_shapes)
        ref.init_params(mx.init.Zero())
        args, _ = ref.get_params()
        params = {n: (0.05 * rng.randn(*a.shape)).astype(np.float32)
                  for n, a in sorted(args.items())}
        ref.set_params({n: mx.nd.array(v) for n, v in params.items()}, {})
        ref.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
    port.bind(data_shapes, label_shapes)
    port.init_params(tmx.init.Zero())
    port.set_params({n: tmx.nd.array(v) for n, v in params.items()}, {})
    port.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1})
    assert port.output_shapes == ref.output_shapes
    assert port.data_names == ref.data_names == ["data"]
    for x, y in _batches(rng.rand(*shape).astype(np.float32),
                         rng.randint(0, 10, 8).astype(np.float32), 3, 2):
        with _ref_scope():
            ref.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                                 [mx.nd.array(y)]))
            ref.update()
            want = ref.get_outputs()[0].asnumpy()
            want_g = ref._modules[1].get_input_grads()[0].asnumpy()
        port.forward_backward(tmx.io.DataBatch([tmx.nd.array(x)],
                                               [tmx.nd.array(y)]))
        port.update()
        np.testing.assert_allclose(port.get_outputs()[0].asnumpy(), want,
                                   **_FWD)
        np.testing.assert_allclose(
            port._modules[1].get_input_grads()[0].asnumpy(), want_g, **_FWD)
    with _ref_scope():
        ref_args, _ = ref.get_params()
    port_args, _ = port.get_params()
    assert sorted(port_args) == sorted(ref_args)
    for n in ref_args:
        np.testing.assert_allclose(port_args[n].asnumpy(),
                                   ref_args[n].asnumpy(), err_msg=n, **_FWD)


def test_sequential_module_fit_reaches_accuracy():
    """fit's own initializer sets the chained modules (Xavier here), and
    one epoch passes 0.9 on the synthetic MNIST."""
    np.random.seed(0)
    train, val = tmx.test_utils.get_mnist_iterator(batch_size=100,
                                                   input_shape=(784,))
    seq = _sequential(tmx)
    seq.fit(train, optimizer="sgd", initializer=tmx.init.Xavier(),
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            num_epoch=1)
    assert seq.score(val, "acc")[0][1] > 0.9
    args, _ = seq.get_params()
    bound = np.sqrt(6.0 / (784 + 128))
    w = args["fc1_weight"].asnumpy()
    assert 0.5 * bound < np.abs(w).max()  # Xavier's, not Uniform(0.01)
    assert seq.get_input_grads is not None and seq.label_shapes
    with pytest.raises(AssertionError, match="Unknown meta"):
        tmx.mod.SequentialModule().add(seq, take_label=True)


def test_python_module_surface():
    loss = tmx.mod.PythonLossModule(grad_func=_softmax_grad)
    assert loss.get_params() == ({}, {})
    loss.bind([("data", (4, 10))], [("softmax_label", (4,))])
    assert loss.output_shapes == [("pyloss_output", (4, 10))]
    loss.init_params()
    loss.init_optimizer()
    scores = tmx.nd.array(np.random.RandomState(0).randn(4, 10)
                          .astype(np.float32))
    labels = tmx.nd.array(np.array([1, 2, 3, 4], np.float32))
    loss.forward(tmx.io.DataBatch([scores], [labels]), is_train=True)
    assert loss.get_outputs()[0] is scores
    loss.backward()
    grad = loss.get_input_grads()[0]
    np.testing.assert_allclose(grad.asnumpy(),
                               _softmax_grad(scores, labels), rtol=1e-6)
    assert grad.context == scores.context
    metric = tmx.metric.Accuracy()
    loss.update_metric(metric, [labels])
    assert metric.num_inst == 4
    with pytest.raises(NotImplementedError):
        tmx.mod.PythonModule(["data"], None, ["out"]).bind(
            [("data", (2,))])


def test_monitor_matches_reference():
    """interval 2, pattern over fc weights and outputs: the same steps,
    names and statistics (mean |x|)."""
    ref, port, data, label = _module_pair("mlp")
    got = []
    for pkg, mod in ((mx, ref), (tmx, port)):
        mon = pkg.mon.Monitor(2, pattern="fc.*|softmax.*", sort=True)
        mod.install_monitor(mon)
        rows = []
        for x, y in _batches(data, label, 3, seed=5):
            mon.tic()
            with _ref_scope():
                mod.forward_backward(pkg.io.DataBatch([pkg.nd.array(x)],
                                                      [pkg.nd.array(y)]))
                mod.update()
            rows.append(mon.toc())
        got.append(rows)
    ref_rows, port_rows = got
    assert [len(r) for r in port_rows] == [len(r) for r in ref_rows] == \
        [8, 0, 8]
    for pr, rr in zip(port_rows, ref_rows):
        assert [(s, n) for s, n, _ in pr] == [(s, n) for s, n, _ in rr]
        np.testing.assert_allclose([float(v) for _, _, v in pr],
                                   [float(v) for _, _, v in rr], **_FWD)


def test_executor_manager_matches_reference():
    """DataParallelExecutorManager over [cpu(0), cpu(1)] with the
    caller-side update of tests/test_module.py: five steps against the
    reference, then an epoch to accuracy > 0.9."""
    from mxnet_tpu.executor_manager import DataParallelExecutorManager as R
    from mxnet_tpu_torch.executor_manager import (
        DataParallelExecutorManager, _split_input_slice)
    import mxnet_tpu.executor_manager as ref_em
    for args in ((10, [1, 1]), (9, [2, 1]), (7, [1, 1, 1])):
        assert _split_input_slice(*args) == ref_em._split_input_slice(*args)
    with pytest.raises(MXNetError, match="too many slices"):
        _split_input_slice(2, [1, 1, 1])
    np.random.seed(0)
    train, val = tmx.test_utils.get_mnist_iterator(batch_size=32,
                                                   input_shape=(784,))
    mgrs = []
    for pkg, cls in ((mx, R), (tmx, DataParallelExecutorManager)):
        with pkg.name.NameManager():
            sym = pkg.models.get_mlp()
        names = sym.list_arguments()
        params = [n for n in names if n not in ("data", "softmax_label")]
        with _ref_scope():
            mgrs.append(cls(sym, [pkg.cpu(0), pkg.cpu(1)], train, names,
                            params, sym.list_auxiliary_states()))
    ref, port = mgrs
    rng = np.random.RandomState(1)
    init = {n: (0.05 * rng.randn(*a[0].shape)).astype(np.float32)
            for n, a in zip(port.param_names, port.param_arrays)}
    ref.set_params({n: mx.nd.array(v) for n, v in init.items()}, {})
    port.set_params({n: tmx.nd.array(v) for n, v in init.items()}, {})

    def step(pkg, mgr, batch):
        mgr.load_data_batch(batch)
        mgr.forward(is_train=True)
        mgr.backward()
        for p_devs, g_devs in zip(mgr.param_arrays, mgr.grad_arrays):
            total = sum(g.asnumpy() for g in g_devs) / 32.0
            for p in p_devs:
                p._data = pkg.nd.array(p.asnumpy() - 0.1 * total)._data

    train.reset()
    for i, batch in enumerate(train):
        if i == 5:
            break
        rbatch = mx.io.DataBatch([mx.nd.array(batch.data[0].asnumpy())],
                                 [mx.nd.array(batch.label[0].asnumpy())])
        with _ref_scope():
            step(mx, ref, rbatch)
        step(tmx, port, batch)
        for rp, pp in zip(ref.param_arrays, port.param_arrays):
            for r, p in zip(rp, pp):
                np.testing.assert_allclose(p.asnumpy(), r.asnumpy(), **_FWD)
    metric = tmx.metric.Accuracy()
    train.reset()
    for batch in train:
        step(tmx, port, batch)
        port.update_metric(metric, batch.label)
    assert metric.get()[1] > 0.9, metric.get()
    out_args, out_aux = {}, {}
    port.copy_to(out_args, out_aux)
    assert sorted(out_args) == sorted(port.param_names) and not out_aux
    np.testing.assert_array_equal(out_args["fc1_weight"].asnumpy(),
                                  port.param_arrays[0][0].asnumpy())
    mon = tmx.mon.Monitor(1)
    port.install_monitor(mon)
    assert all(e._monitor_callback is not None
               for e in port.execgrp.train_execs)
