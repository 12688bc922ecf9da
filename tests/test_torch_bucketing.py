"""Port parity for the bucketed symbolic RNN workflow: mx.rnn's
BucketSentenceIter and BucketingModule (mxnet_tpu_torch.rnn /
module.bucketing_module) against the JAX reference on the CPU.

Both packages get the same numpy parameters (`module_params_from_numpy`
on the port's side, `set_params` on the reference's) and the same
batches; every reference Module call runs inside
`mxnet_tpu.random.trace_key_scope`. The models: examples/lstm_bucketing.py
at its own width (vocab 32), its `sym_gen` run unchanged against each
package, and `chip_smoke.bucketing_sym_gen` (phase 15's FusedRNNCell
graph; the port's begin states' batch left to the bound data, the
reference's given, as the reference needs it).

Tolerances: iterators, bucket keys, names and shapes exact; float32
outputs, losses and parameters after Adam steps 1e-5.
"""
import importlib.util
import os
import random

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import module_params_from_numpy

import chip_smoke

_TOL = dict(rtol=1e-5, atol=1e-5)
#: examples/lstm_bucketing.py's initializer
_MIXED = tmx.init.Mixed([".*lstm_parameters", ".*"],
                        [tmx.init.Uniform(0.1), tmx.init.Xavier()])
_EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "lstm_bucketing.py")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _example(pkg):
    """examples/lstm_bucketing.py loaded anew, its `mx` the given
    package (its functions look `mx` up when called)."""
    spec = importlib.util.spec_from_file_location("lstm_bucketing_%s"
                                                  % pkg.__name__, _EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.mx = pkg
    return module


def _iters(sentences, batch, buckets, **kw):
    """The two packages' BucketSentenceIter from the same seeds."""
    out = []
    for pkg in (mx, tmx):
        random.seed(3)
        np.random.seed(3)
        out.append(pkg.rnn.BucketSentenceIter(sentences, batch,
                                              buckets=buckets, **kw))
    return out


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_reference(layout):
    sentences = chip_smoke.bucketing_corpus(np, 90, 50, (3, 13), seed=1)
    ref, port = _iters(sentences, 4, [5, 9, 13], layout=layout,
                       invalid_label=0)
    assert port.default_bucket_key == ref.default_bucket_key == 13
    assert port.provide_data == ref.provide_data
    assert port.provide_label == ref.provide_label
    for _ in range(2):  # an epoch, then after reset
        n = 0
        for rb, pb in zip(ref, port):
            assert pb.bucket_key == rb.bucket_key
            assert pb.provide_data == rb.provide_data
            np.testing.assert_array_equal(pb.data[0].asnumpy(),
                                          rb.data[0].asnumpy())
            np.testing.assert_array_equal(pb.label[0].asnumpy(),
                                          rb.label[0].asnumpy())
            assert pb.data[0].context == tmx.cpu()
            n += 1
        assert n == len(ref._plan) == len(port._plan) > 10
        with pytest.raises(StopIteration):
            port.next()
        for it in (ref, port):
            random.seed(4)
            np.random.seed(4)
            it.reset()


def test_bucket_sentence_iter_default_buckets_and_drops():
    sentences = [[1, 2]] * 3 + [[1, 2, 3]] * 2 + [[5] * 9]
    ref, port = _iters(sentences, 2, None)
    assert port.buckets == ref.buckets == [2, 3]
    assert [len(d) for d in port.data] == [len(d) for d in ref.data]
    with pytest.raises(ValueError, match="layout"):
        tmx.rnn.BucketSentenceIter(sentences, 2, layout="NTC")


def _ref_batch(batch):
    return mx.io.DataBatch(
        data=[mx.nd.array(b.asnumpy()) for b in batch.data],
        label=[mx.nd.array(b.asnumpy()) for b in batch.label],
        bucket_key=batch.bucket_key, provide_data=batch.provide_data,
        provide_label=batch.provide_label)


def _alternating(it, steps):
    """`steps` batches of `it` taking the buckets in turn."""
    by_key = {}
    for b in it:
        by_key.setdefault(b.bucket_key, []).append(b)
    keys = sorted(by_key)
    return [by_key[keys[i % len(keys)]][i // len(keys)]
            for i in range(steps)]


def _twin_modules(ref_gen, port_gen, default_key, data_shape):
    """Both packages' BucketingModule bound at the default bucket, with
    the same numpy parameters (0.1 x standard normal draws from a
    seed)."""
    ref = mx.mod.BucketingModule(ref_gen, default_bucket_key=default_key,
                                 context=mx.cpu())
    port = tmx.mod.BucketingModule(port_gen, default_bucket_key=default_key,
                                   context=tmx.cpu())
    shapes = [("data", data_shape)]
    labels = [("softmax_label", data_shape)]
    with _ref_scope():
        ref.bind(shapes, labels)
        ref.init_params(mx.init.Zero())
    port.bind(shapes, labels)
    port.init_params(tmx.init.Zero())
    rng = np.random.RandomState(0)
    ref_args, _ = ref.get_params()
    arrays = {n: (0.1 * rng.randn(*a.shape)).astype(np.float32)
              for n, a in sorted(ref_args.items())}
    with _ref_scope():
        ref.set_params({n: mx.nd.array(a) for n, a in arrays.items()}, {})
    module_params_from_numpy(port, arrays)
    return ref, port


def _train_both(ref, port, batches, optimizer_params):
    with _ref_scope():
        ref.init_optimizer(optimizer="adam",
                           optimizer_params=optimizer_params)
    port.init_optimizer(optimizer="adam", optimizer_params=optimizer_params)
    for step, batch in enumerate(batches):
        with _ref_scope():
            ref.forward_backward(_ref_batch(batch))
            ref.update()
            want = ref.get_outputs()[0].asnumpy()
        port.forward_backward(batch)
        port.update()
        got = port.get_outputs()[0].asnumpy()
        assert port._curr_bucket_key == batch.bucket_key
        np.testing.assert_allclose(got, want, err_msg="step %d" % step,
                                   **_TOL)
    with _ref_scope():
        ref_args, _ = ref.get_params()
    port_args, _ = port.get_params()
    assert sorted(port_args) == sorted(ref_args)
    for n in ref_args:
        np.testing.assert_allclose(port_args[n].asnumpy(),
                                   ref_args[n].asnumpy(), err_msg=n, **_TOL)


def test_lstm_bucketing_example_matches_reference():
    """examples/lstm_bucketing.py's own sym_gen on each package: 8 Adam
    steps (lr 0.01) over batches that alternate between its three
    buckets."""
    ref_ex, port_ex = _example(mx), _example(tmx)
    batch = 16
    _, port_it = _iters(port_ex.make_corpus(), batch, [8, 12, 16])
    batches = _alternating(port_it, 8)
    assert len({b.bucket_key for b in batches}) == 3
    ref, port = _twin_modules(ref_ex.sym_gen_factory(batch),
                              port_ex.sym_gen_factory(batch), 16,
                              (batch, 16))
    _train_both(ref, port, batches, {"learning_rate": 0.01})
    assert sorted(port._buckets) == [8, 12, 16]


@pytest.mark.parametrize("fused", ["0", "1"])
def test_fused_cell_bucketing_matches_reference(fused, monkeypatch):
    """Phase 15's graph at a small width: FusedRNNCell's begin states
    deferred in the port (batch_size 0) and given in the reference, 6
    Adam steps over alternating buckets with padded sentences, the fused
    flag on (the kernels' plain versions on the CPU) and off."""
    monkeypatch.setenv("MXNET_FUSED_RNN", fused)
    vocab, batch = 40, 4
    sentences = chip_smoke.bucketing_corpus(np, 60, vocab, (3, 12))
    _, port_it = _iters(sentences, batch, [6, 12], invalid_label=0)
    batches = _alternating(port_it, 6)
    ref_gen = chip_smoke.bucketing_sym_gen(mx, vocab, 8, 10, 2,
                                           batch_size=batch)
    port_gen = chip_smoke.bucketing_sym_gen(tmx, vocab, 8, 10, 2)
    ref, port = _twin_modules(ref_gen, port_gen, 12, (batch, 12))
    assert port.symbol.list_arguments() == ref.symbol.list_arguments()
    _train_both(ref, port, batches, {"learning_rate": 0.01})


def test_unrolled_cell_bucketing_matches_reference():
    """Phase 15b's graph (a SequentialRNNCell of LSTMCells, begin states
    aux variables whose batch shape inference fills) at a small width."""
    vocab, batch = 30, 3
    sentences = chip_smoke.bucketing_corpus(np, 40, vocab, (2, 8))
    _, port_it = _iters(sentences, batch, [4, 8], invalid_label=0)
    batches = _alternating(port_it, 4)
    ref_gen = chip_smoke.bucketing_sym_gen(mx, vocab, 6, 7, 2,
                                           cell="unrolled")
    port_gen = chip_smoke.bucketing_sym_gen(tmx, vocab, 6, 7, 2,
                                            cell="unrolled")
    ref, port = _twin_modules(ref_gen, port_gen, 8, (batch, 8))
    assert port.symbol.list_auxiliary_states() == \
        ref.symbol.list_auxiliary_states()
    _train_both(ref, port, batches, {"learning_rate": 0.02})


def _small_module(buckets=(6, 12), batch=4):
    gen = chip_smoke.bucketing_sym_gen(tmx, 40, 8, 10, 2)
    sentences = chip_smoke.bucketing_corpus(np, 60, 40, (3, 12))
    random.seed(0)
    np.random.seed(0)
    it = tmx.rnn.BucketSentenceIter(sentences, batch, buckets=list(buckets),
                                    invalid_label=0)
    mod = tmx.mod.BucketingModule(gen, default_bucket_key=it.default_bucket_key,
                                  context=tmx.cpu())
    return mod, it


def test_buckets_share_one_optimizer_and_copy_params_exactly():
    mod, it = _small_module()
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(_MIXED)
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.01})
    for batch in _alternating(it, 4):
        mod.forward_backward(batch)
        mod.update()
    owner = mod._opt_owner
    assert len(mod._buckets) == 2
    for m in mod._buckets.values():
        assert m._kvstore is owner._kvstore
        assert m._optimizer is owner._optimizer
    # 4 updates of each of the 4 parameters went through one Adam state
    assert sorted(owner._kvstore._updater.states) == [0, 1, 2, 3]
    assert owner._kvstore._optimizer.num_update == 4
    current, _ = mod.get_params()
    it.reset()
    for batch in it:
        if batch.bucket_key != mod._curr_bucket_key:
            mod.forward(batch, is_train=False)
            break
    switched, _ = mod.get_params()
    for n in current:
        assert torch.equal(switched[n]._data, current[n]._data), n


def test_bucketing_fit_learns_and_monitor_reaches_every_bucket():
    """fit drives prepare / switch / update over an epoch; a Monitor
    installed before the other buckets bind reaches them too."""
    mod, it = _small_module()
    mon = tmx.mon.Monitor(1, pattern=".*")
    mod.bind(it.provide_data, it.provide_label)
    mod.install_monitor(mon)
    metric = tmx.metric.Perplexity(ignore_label=0)
    mod.fit(it, eval_metric=metric, optimizer="adam",
            optimizer_params={"learning_rate": 0.05},
            initializer=_MIXED,
            num_epoch=3)
    assert sorted(mod._buckets) == [6, 12]
    for m in mod._buckets.values():
        assert m._exec._monitor_callback == mon.stat_helper
    it.reset()
    metric.reset()
    mod.score(it, metric)
    assert metric.get()[1] < 40 / 2  # chance is the vocab, 40
    it.reset()
    batch = next(iter(it))
    mon.tic()
    mod.forward(batch, is_train=False)
    stats = mon.toc()
    names = {k for _, k, _ in stats}
    assert "softmax_output" in names and "lstm_parameters" in names
    assert all(np.isfinite(float(v)) for _, _, v in stats)


def test_module_params_from_numpy_sets_a_bucketing_module():
    mod, it = _small_module()
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(tmx.init.Zero())
    args, _ = mod.get_params()
    assert args["lstm_parameters"].shape == (
        tmx.ops.nn.rnn_param_size(2, 8, 10, False, "lstm"),)
    arrays = {n: np.full(a.shape, i + 1, np.float32)
              for i, (n, a) in enumerate(sorted(args.items()))}
    module_params_from_numpy(mod, arrays, {})
    got, _ = mod.get_params()
    for n, a in arrays.items():
        np.testing.assert_array_equal(got[n].asnumpy(), a)
    bad = dict(arrays, lstm_parameters=np.zeros(3, np.float32))
    with pytest.raises(tmx.MXNetError, match="lstm_parameters"):
        module_params_from_numpy(mod, bad, {})
