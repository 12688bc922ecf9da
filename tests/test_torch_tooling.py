"""Port parity for the tooling tail: `test_utils` (contexts, comparison,
the symbolic checks, the statistical checks, the data fetchers),
`visualization` (`print_summary`, `plot_network`), `contrib.text`,
`contrib.tensorboard`, `contrib.autograd`, `contrib.io`,
`notebook.callback` and `ndarray_doc`, each against the JAX reference on
the same seeded numpy inputs, on the CPU.

The cases mirror tests/test_contrib.py, tests/test_misc.py (the summary
and plot, the notebook callbacks, the test_utils helpers),
tests/test_gluon_contrib.py's DataLoaderIter and the check_* uses of
tests/test_operator.py. Reference executors run inside
`mxnet_tpu.random.trace_key_scope`, as their eager forward needs on a
jax without `jax.core.trace_state_clean`.

Tolerances: printed text, graph sources, vocabularies, token indices,
embedding vectors, JSONL records (but wall_time), DataLoaderIter
batches, PandasLogger frames (but their clock columns) and data files
exactly; contrib.autograd gradients 1e-6; the symbolic checks' values
1e-5; the chi-square checks at the reference's defaults.
"""
import collections
import gzip
import json
import os
import pickle
import random
import re
import zipfile

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import test_utils as rtu

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import test_utils as tu
from mxnet_tpu_torch.base import MXNetError

import chip_smoke

_VALS = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    # fresh NameManagers: symbols made here must not move either
    # package's default name counters, which later tests in the process
    # compare between the packages
    with tmx.cpu(), mx.name.NameManager(), tmx.name.NameManager():
        yield


def _ref_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


def _twin(build):
    """build(pkg) under a fresh NameManager of each package: (ref, port)."""
    out = []
    for pkg in (mx, tmx):
        with pkg.name.NameManager():
            out.append(build(pkg))
    return tuple(out)


NETS = {"mlp": (lambda pkg: pkg.models.get_mlp(), (1, 784)),
        "lenet": (lambda pkg: pkg.models.get_lenet(), (1, 1, 28, 28)),
        "bn_convnet": (lambda pkg: chip_smoke.bn_convnet(pkg.sym),
                       (1, 1, 28, 28))}


# ---------------------------------------------------------------------------
# visualization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("with_shape", [True, False])
def test_print_summary_prints_the_reference_text(net, with_shape, capsys):
    build, shape = NETS[net]
    ref, port = _twin(build)
    kw = {"shape": {"data": shape}} if with_shape else {}
    want_total = mx.viz.print_summary(ref, **kw)
    want = capsys.readouterr().out
    got_total = tmx.viz.print_summary(port, **kw)
    got = capsys.readouterr().out
    assert got == want
    assert got_total == want_total
    if with_shape:
        assert "Total params: %d" % want_total in got and want_total > 0


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("hide_weights", [True, False])
def test_plot_network_has_the_reference_graph(net, hide_weights):
    build, shape = NETS[net]
    ref, port = _twin(build)
    kw = dict(shape={"data": shape}, hide_weights=hide_weights,
              node_attrs={"fixedsize": "false"})
    want = mx.viz.plot_network(ref, **kw)
    got = tmx.viz.plot_network(port, **kw)
    assert got.source == want.source
    assert got.body and any("->" in line for line in got.body)


def test_viz_namespace_matches_the_reference():
    assert tmx.viz is tmx.visualization
    assert tmx.print_summary is tmx.visualization.print_summary
    assert tmx.ndarray_doc.NDArrayDoc.__name__ == "NDArrayDoc"


# ---------------------------------------------------------------------------
# contrib.text
# ---------------------------------------------------------------------------

VOCAB_CASES = {
    "min_freq_reserved": (["a", "b", "b", "c", "c", "c", "rare"],
                          dict(min_freq=2, reserved_tokens=["<pad>"])),
    "most_freq_count": ({"w%d" % i: 10 - i for i in range(8)},
                        dict(most_freq_count=3)),
    "ties_sorted": ({"z": 2, "y": 2, "x": 2, "q": 1},
                    dict(unknown_token="<UNK>")),
    "none": (None, dict(reserved_tokens=["<s>", "</s>"])),
}


@pytest.mark.parametrize("case", sorted(VOCAB_CASES))
def test_vocabulary_indexes_as_the_reference(case):
    tokens, kw = VOCAB_CASES[case]
    counter = None if tokens is None else collections.Counter(tokens)
    ref = mx.contrib.text.Vocabulary(counter, **kw)
    port = tmx.contrib.text.Vocabulary(counter, **kw)
    assert port.idx_to_token == ref.idx_to_token
    assert port.token_to_idx == ref.token_to_idx
    assert len(port) == len(ref)
    assert port.unknown_token == ref.unknown_token
    assert port.reserved_tokens == ref.reserved_tokens
    probe = list(ref.idx_to_token) + ["nope", "c"]
    assert port.to_indices(probe) == ref.to_indices(probe)
    assert port.to_indices("nope") == ref.to_indices("nope") == 0
    idx = list(range(len(ref)))
    assert port.to_tokens(idx) == ref.to_tokens(idx)
    with pytest.raises(ValueError):
        port.to_tokens(len(port))


@pytest.mark.parametrize("kw", [dict(min_freq=0),
                                dict(reserved_tokens=["<unk>"]),
                                dict(reserved_tokens=["a", "a"])])
def test_vocabulary_rejects_what_the_reference_rejects(kw):
    for pkg in (mx, tmx):
        with pytest.raises(ValueError):
            pkg.contrib.text.Vocabulary(collections.Counter("ab"), **kw)


@pytest.mark.parametrize("text,kw", [
    ("Life is great!\nlife is good.", dict(to_lower=True)),
    ("Life is great!\nlife is good.", {}),
    ("a,b,,c;d;a", dict(token_delim=",", seq_delim=";")),
    ("  spaced   out\n\nlines  ", {}),
])
def test_count_tokens_from_str_matches_the_reference(text, kw):
    want = mx.contrib.text.utils.count_tokens_from_str(text, **kw)
    got = tmx.contrib.text.utils.count_tokens_from_str(text, **kw)
    assert got == want
    base = collections.Counter({"a": 5})
    assert tmx.contrib.text.utils.count_tokens_from_str(
        text, counter_to_update=collections.Counter(base), **kw) == \
        mx.contrib.text.utils.count_tokens_from_str(
            text, counter_to_update=collections.Counter(base), **kw)


def _emb_file(tmp_path, rows, name="emb.txt"):
    p = tmp_path / name
    p.write_text("".join(rows))
    return str(p)


EMB_FILES = {
    "plain": ["hello 1.0 2.0 3.0\n", "world 4.0 5.0 6.0\n",
              "Caps 0.5 0.25 -1\n"],
    "duplicates": ["foo 1 2 3\n", "bar 4 5 6\n", "foo 7 8 9\n"],
    "unknown_row": ["<unk> 7 7 7\n", "hello 1 2 3\n"],
    "fasttext_header": ["2 3\n", "foo 1 1 1\n", "bar 2 2 2\n"],
}


def _embedding_state(emb):
    return (list(emb.idx_to_token), dict(emb.token_to_idx), emb.vec_len,
            emb.idx_to_vec.asnumpy())


def _same_embedding(got, want):
    g, w = _embedding_state(got), _embedding_state(want)
    assert g[:3] == w[:3]
    np.testing.assert_array_equal(g[3], w[3])


@pytest.mark.parametrize("case", sorted(EMB_FILES))
def test_custom_embedding_matches_the_reference(case, tmp_path):
    path = _emb_file(tmp_path, EMB_FILES[case])
    ref = mx.contrib.text.embedding.create("customembedding",
                                           pretrained_file_path=path)
    port = tmx.contrib.text.embedding.create("customembedding",
                                             pretrained_file_path=path)
    _same_embedding(port, ref)
    probe = ["hello", "nope", "caps", "foo", "bar", "world"]
    for lower in (False, True):
        np.testing.assert_array_equal(
            port.get_vecs_by_tokens(probe, lower_case_backup=lower)
            .asnumpy(),
            ref.get_vecs_by_tokens(probe, lower_case_backup=lower)
            .asnumpy())
    np.testing.assert_array_equal(port.get_vecs_by_tokens("nope").asnumpy(),
                                  ref.get_vecs_by_tokens("nope").asnumpy())
    token = port.idx_to_token[-1]
    new = np.array([9.0, 8.0, 7.0], np.float32)
    ref.update_token_vectors(token, mx.nd.array(new))
    port.update_token_vectors(token, tmx.nd.array(new))
    _same_embedding(port, ref)
    with pytest.raises(ValueError):
        port.update_token_vectors("never-seen", new)


def test_custom_embedding_delimiter_and_composite(tmp_path):
    path = _emb_file(tmp_path, ["hello\t1\t2\n", "world\t3\t4\n"], "t.txt")
    path2 = _emb_file(tmp_path, EMB_FILES["plain"])
    counter = collections.Counter(["hello", "hello", "world", "other"])
    states = []
    for pkg in (mx, tmx):
        e1 = pkg.contrib.text.embedding.CustomEmbedding(path,
                                                        elem_delim="\t")
        e2 = pkg.contrib.text.embedding.CustomEmbedding(path2)
        vocab = pkg.contrib.text.Vocabulary(counter)
        comp = pkg.contrib.text.embedding.CompositeEmbedding(vocab, [e1, e2])
        one = pkg.contrib.text.embedding.CompositeEmbedding(vocab, e2)
        states.append((_embedding_state(e1), _embedding_state(comp),
                       _embedding_state(one)))
    for (w1, wc, wo), (g1, gc, go) in [states]:
        for w, g in ((w1, g1), (wc, gc), (wo, go)):
            assert g[:3] == w[:3]
            np.testing.assert_array_equal(g[3], w[3])
    assert states[1][1][2] == 5


def test_pretrained_embeddings_read_local_files_only(tmp_path):
    for pkg in (mx, tmx):
        emb = pkg.contrib.text.embedding
        with pytest.raises(IOError):
            emb.create("glove", pretrained_file_name="glove.6B.50d.txt",
                       embedding_root=str(tmp_path))
        with pytest.raises(KeyError):
            emb.create("word2vec")
        with pytest.raises(ValueError):
            emb.GloVe()
    assert tmx.contrib.text.embedding.get_pretrained_file_names() == \
        mx.contrib.text.embedding.get_pretrained_file_names()
    assert tmx.contrib.text.embedding.get_pretrained_file_names("GloVe") == \
        mx.contrib.text.embedding.get_pretrained_file_names("GloVe")
    root = tmp_path / "root"
    (root / "glove").mkdir(parents=True)
    (root / "glove" / "glove.6B.50d.txt").write_text("the 1 2\nof 3 4\n")
    (root / "fasttext").mkdir()
    (root / "fasttext" / "wiki.simple.vec").write_text("2 2\nthe 5 6\n"
                                                       "of 7 8\n")
    for name, fname in (("glove", "glove.6B.50d.txt"),
                        ("fasttext", "wiki.simple.vec")):
        ref = mx.contrib.text.embedding.create(
            name, pretrained_file_name=fname, embedding_root=str(root))
        port = tmx.contrib.text.embedding.create(
            name, pretrained_file_name=fname, embedding_root=str(root))
        _same_embedding(port, ref)


# ---------------------------------------------------------------------------
# contrib.tensorboard, contrib.io, notebook.callback
# ---------------------------------------------------------------------------

def _accuracy(pkg, labels, probs):
    m = pkg.metric.Accuracy()
    m.update([pkg.nd.array(np.asarray(labels, np.float32))],
             [pkg.nd.array(np.asarray(probs, np.float32))])
    return m


BATCHES = [([0, 1], [[0.9, 0.1], [0.2, 0.8]]),
           ([1, 1], [[0.9, 0.1], [0.2, 0.8]]),
           ([0, 0, 1], [[0.3, 0.7], [0.6, 0.4], [0.1, 0.9]])]


@pytest.mark.parametrize("prefix", [None, "train"])
def test_log_metrics_callback_writes_the_reference_records(prefix, tmp_path,
                                                           monkeypatch):
    records = []
    for pkg, mod in ((mx, mx.contrib.tensorboard),
                     (tmx, tmx.contrib.tensorboard)):
        # the JSONL sink on both sides: the SummaryWriter's event files
        # carry their own clocks and host names
        monkeypatch.setattr(mod, "_make_writer", mod._JsonlWriter)
        logs = tmp_path / pkg.__name__
        cb = mod.LogMetricsCallback(str(logs), prefix=prefix)

        class P:
            eval_metric = None
        cb(P())
        for labels, probs in BATCHES:
            P.eval_metric = _accuracy(pkg, labels, probs)
            cb(P())
        cb.summary_writer.close()
        lines = [json.loads(l) for l in
                 (logs / "metrics.jsonl").read_text().splitlines()]
        for line in lines:
            assert isinstance(line.pop("wall_time"), float)
        records.append(lines)
    assert records[1] == records[0]
    assert len(records[0]) == len(BATCHES)


def test_tensorboard_writer_falls_back_without_tensorboard(tmp_path,
                                                          monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    cb = tmx.contrib.tensorboard.LogMetricsCallback(str(tmp_path))
    assert isinstance(cb.summary_writer, tmx.contrib.tensorboard._JsonlWriter)


@pytest.mark.parametrize("n,batch", [(45, 10), (40, 10), (7, 3)])
def test_dataloader_iter_pads_as_the_reference(n, batch):
    data = np.arange(2 * n, dtype=np.float32).reshape(n, 2)
    label = np.arange(n, dtype=np.float32)
    out = []
    for pkg in (mx, tmx):
        from importlib import import_module
        cio = import_module(pkg.__name__ + ".contrib.io")
        gdata = pkg.gluon.data
        it = cio.DataLoaderIter(gdata.DataLoader(
            gdata.ArrayDataset(data, label), batch_size=batch))
        epochs = []
        for _ in range(2):
            epochs.append([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                           for b in it])
            it.reset()
        out.append((epochs, [tuple(d) for d in it.provide_data],
                    [tuple(d) for d in it.provide_label], it.batch_size))
    (want, wd, wl, wb), (got, gd, gl, gb) = out
    assert (gd, gl, gb) == (wd, wl, wb)
    assert len(got[0]) == len(want[0]) == -(-n // batch)
    for ge, we in zip(got, want):
        for (gx, gy, gp), (wx, wy, wp) in zip(ge, we):
            assert gp == wp
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    assert got[0][-1][2] == (-n) % batch


def test_dataloader_iter_batches_are_host_arrays():
    from mxnet_tpu_torch.contrib.io import DataLoaderIter
    gdata = tmx.gluon.data
    it = DataLoaderIter(gdata.DataLoader(gdata.ArrayDataset(
        np.ones((5, 3), np.float32), np.zeros(5, np.float32)), batch_size=2),
        dtype="float32")
    batch = next(iter(it))
    assert batch.data[0].context == tmx.cpu()
    assert batch.data[0]._data.device.type == "cpu"


def _notebook_run(pkg, frequent):
    cb = __import__(pkg.__name__ + ".notebook.callback",
                    fromlist=["PandasLogger"])
    Param = collections.namedtuple("Param", ["epoch", "nbatch",
                                             "eval_metric"])
    logger = cb.PandasLogger(batch_size=4, frequent=frequent)
    curve = cb.LiveLearningCurve(metric_name="accuracy", frequent=frequent)
    for epoch in range(2):
        for i, (labels, probs) in enumerate(BATCHES):
            p = Param(epoch=epoch, nbatch=i,
                      eval_metric=_accuracy(pkg, labels, probs))
            logger.train_cb(p)
            curve.train_cb(p)
        p = Param(epoch=epoch, nbatch=0,
                  eval_metric=_accuracy(pkg, *BATCHES[2]))
        logger.eval_cb(p)
        curve.eval_cb(p)
        logger.epoch_cb()
    logger.train_cb(Param(epoch=2, nbatch=0, eval_metric=None))
    return logger, curve, cb.args_wrapper(logger, curve)


@pytest.mark.parametrize("frequent", [1, 2])
def test_notebook_callbacks_give_the_reference_frames(frequent):
    (rl, rc, rw), (pl, pc, pw) = (_notebook_run(mx, frequent),
                                  _notebook_run(tmx, frequent))
    clock = ["elapsed", "samples/sec"]
    for which in ("train", "eval", "epoch"):
        want = rl.all_dataframes[which]
        got = pl.all_dataframes[which]
        assert list(got.columns) == list(want.columns)
        assert got.shape == want.shape
        keep = [c for c in want.columns if c not in clock]
        assert got[keep].equals(want[keep])
        for c in clock:
            if c in want.columns:
                assert (got[c] >= 0).all()
    assert len(pl.train_df) == len(rl.train_df) > 0
    assert dict(pc.train_series) == dict(rc.train_series)
    assert dict(pc.eval_series) == dict(rc.eval_series)
    assert sorted(pw) == sorted(rw)
    assert all(len(pw[k]) == len(rw[k]) for k in rw)
    fig = pc.figure()
    assert len(fig.axes) == 1 and len(fig.axes[0].lines) == 2


def test_notebook_logger_in_module_fit():
    from mxnet_tpu_torch.notebook.callback import (PandasLogger,
                                                   LiveLearningCurve,
                                                   args_wrapper)
    np.random.seed(0)
    x = np.random.randn(64, 20).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float32)
    train = tmx.io.NDArrayIter(x, y, 16)
    logger = PandasLogger(batch_size=16, frequent=1)
    curve = LiveLearningCurve(metric_name="accuracy", frequent=1)
    with tmx.name.NameManager():
        net = tmx.sym.SoftmaxOutput(tmx.sym.FullyConnected(
            tmx.sym.Variable("data"), num_hidden=2, name="fc"),
            name="softmax")
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.fit(train, eval_data=train, optimizer="sgd", num_epoch=2,
            optimizer_params={"learning_rate": 0.1},
            initializer=tmx.init.Xavier(), **args_wrapper(logger, curve))
    assert len(logger.train_df) == 8 and len(logger.eval_df) == 2
    assert len(logger.epoch_df) == 2
    assert "accuracy" in logger.train_df.columns
    assert len(curve.train_series) == 8 and len(curve.eval_series) == 2


def test_bokeh_charts_need_bokeh():
    from mxnet_tpu_torch.notebook import callback
    try:
        import bokeh  # noqa: F401
        pytest.skip("bokeh is installed")
    except ImportError:
        pass
    with pytest.raises(ImportError):
        callback.LiveBokehChart(None, "accuracy", batch_size=4)
    with pytest.raises(ImportError):
        callback.LiveTimeSeries(batch_size=4)


# ---------------------------------------------------------------------------
# contrib.autograd and ndarray_doc
# ---------------------------------------------------------------------------

FUNCS = {
    "square_sum": (lambda pkg, x: (x * x).sum(), None, 1),
    "two_args": (lambda pkg, x, w: (pkg.nd.dot(x, w) ** 2).sum(), None, 2),
    "argnum_1": (lambda pkg, x, w: (pkg.nd.tanh(pkg.nd.dot(x, w))).sum(),
                 1, 2),
    "argnum_list": (lambda pkg, x, w: (pkg.nd.exp(x).sum() *
                                       pkg.nd.sigmoid(w).sum()), [0, 1], 2),
}


@pytest.mark.parametrize("case", sorted(FUNCS))
def test_contrib_autograd_grads_match_the_reference(case):
    fn, argnum, nargs = FUNCS[case]
    rng = np.random.RandomState(3)
    shapes = [(4, 3), (3, 5)][:nargs]
    inputs = [rng.randn(*s).astype(np.float32) for s in shapes]
    out = []
    for pkg in (mx, tmx):
        cag = __import__(pkg.__name__ + ".contrib.autograd",
                         fromlist=["grad"])
        args = [pkg.nd.array(a) for a in inputs]
        grads, loss = cag.grad_and_loss(lambda *a: fn(pkg, *a), argnum)(*args)
        only = cag.grad(lambda *a: fn(pkg, *a), argnum)(
            *[pkg.nd.array(a) for a in inputs])
        out.append(([g.asnumpy() for g in grads], float(loss.asnumpy()),
                    [g.asnumpy() for g in only]))
    (wg, wl, wo), (gg, gl, go) = out
    assert len(gg) == len(wg)
    assert abs(gl - wl) <= 1e-6 * max(1.0, abs(wl))
    for g, w in zip(gg + go, wg + wo):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_contrib_autograd_sections_and_manual_backward():
    from mxnet_tpu_torch.contrib import autograd as cag
    prev = cag.set_is_training(True)
    assert tmx.autograd.is_training()
    assert cag.set_is_training(prev) is True
    x = tmx.nd.array(np.array([1.0, -2.0, 3.0], np.float32))
    g = tmx.nd.zeros_like(x)
    cag.mark_variables([x], [g])
    with cag.train_section():
        assert tmx.autograd.is_recording()
        y = (x * x * x).sum()
        with cag.test_section():
            assert not tmx.autograd.is_recording()
    cag.backward([y])
    np.testing.assert_allclose(g.asnumpy(), 3 * np.array([1., 4., 9.]),
                               rtol=1e-6)
    with cag.train_section():
        y = (x * 2).sum()
    cag.compute_gradient([y])
    np.testing.assert_allclose(g.asnumpy(), [2, 2, 2], rtol=1e-6)


def test_ndarray_doc_attaches_docs_as_the_reference():
    args = ("relu", "Rectified linear unit.", ["data", "out"],
            ["NDArray", "NDArray, optional"])
    assert tmx.ndarray_doc._build_doc(*args) == mx.ndarray_doc._build_doc(
        *args)
    from mxnet_tpu_torch.ops import registry
    before_reg, before_fn = registry.get("relu").doc, tmx.nd.relu.__doc__

    class reluDoc(tmx.ndarray_doc.NDArrayDoc):
        """relu(data): max(data, 0), documented."""

    class notAnOpDoc(tmx.ndarray_doc.NDArrayDoc):
        """skipped"""

    try:
        tmx.ndarray_doc.attach()
        assert registry.get("relu").doc == reluDoc.__doc__
        assert tmx.nd.relu.__doc__ == reluDoc.__doc__
    finally:
        registry.get("relu").doc = before_reg
        tmx.nd.relu.__doc__ = before_fn


# ---------------------------------------------------------------------------
# test_utils: the symbolic checks
# ---------------------------------------------------------------------------

def _rand(*shape):
    return np.random.uniform(-1, 1, shape).astype(np.float32)


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "exp", "square",
                                  "softsign", "softrelu"])
def test_check_numeric_gradient_passes_as_in_the_reference(name):
    x = _rand(3, 3)
    for pkg, t in ((mx, rtu), (tmx, tu)):
        s = getattr(pkg.sym, name)(pkg.sym.Variable("data"))
        with _ref_scope():
            t.check_numeric_gradient(s, [x], rtol=5e-2, atol=1e-3)


def test_check_numeric_gradient_catches_a_wrong_gradient():
    x = _rand(3, 3)
    s = tmx.sym.BlockGrad(tmx.sym.Variable("data")) * 2
    with pytest.raises(AssertionError, match="analytic_data"):
        tu.check_numeric_gradient(s, [x], rtol=5e-2, atol=1e-3)


def test_check_numeric_gradient_by_name_and_grad_nodes():
    a, b = _rand(2, 1, 3), _rand(1, 4, 3)
    for pkg, t in ((mx, rtu), (tmx, tu)):
        s = pkg.sym.broadcast_mul(pkg.sym.Variable("a"),
                                  pkg.sym.Variable("b"))
        with _ref_scope():
            t.check_numeric_gradient(s, {"a": a, "b": b}, rtol=5e-2,
                                     atol=1e-3)
            t.check_numeric_gradient(s, {"a": a, "b": b}, rtol=5e-2,
                                     atol=1e-3, grad_nodes=["b"])


# products and short sums at a step of 0.1: central differences are exact
# for these quadratic and bilinear functions, and a last-bit difference
# of a sum (the packages add in other orders) moves a difference by
# ~1e-6 at this step
NUMERIC = {
    "broadcast_mul": (lambda sym: sym.broadcast_mul(sym.Variable("a"),
                                                    sym.Variable("b")),
                      {"a": (2, 1, 3), "b": (1, 4, 3)}),
    "square_sum": (lambda sym: sym.sum(sym.square(sym.Variable("a")),
                                       axis=1), {"a": (3, 4)}),
    "concat": (lambda sym: sym.Concat(sym.Variable("a"), sym.Variable("b"),
                                      dim=1), {"a": (2, 2), "b": (2, 3)}),
}


@pytest.mark.parametrize("case", sorted(NUMERIC))
def test_numeric_grad_matches_the_reference(case):
    build, shapes = NUMERIC[case]
    loc = {k: _rand(*s) for k, s in shapes.items()}
    out, after = [], []
    for pkg, t in ((mx, rtu), (tmx, tu)):
        with pkg.name.NameManager():
            s = build(pkg.sym)
        with _ref_scope():
            exe = s.simple_bind(pkg.cpu(), grad_req="null", **shapes)
            out.append(t.numeric_grad(exe, loc, eps=0.1))
            after.append({k: exe.arg_dict[k].asnumpy() for k in loc})
    for k in loc:
        np.testing.assert_allclose(out[1][k], out[0][k], **_VALS)
        # the steps of +eps/2, -eps, +eps/2 round alike in both
        np.testing.assert_array_equal(after[1][k], after[0][k])
        np.testing.assert_allclose(after[1][k], loc[k], rtol=1e-6)


def test_check_symbolic_forward_and_backward_match_the_reference():
    x = _rand(4, 5) * 2
    og = np.ones_like(x)
    a, b, og2 = _rand(2, 2), _rand(2, 3), _rand(2, 5)
    got = []
    for pkg, t in ((mx, rtu), (tmx, tu)):
        sym = pkg.sym
        clip = sym.clip(sym.Variable("data"), a_min=-0.5, a_max=0.5)
        with _ref_scope():
            fwd = t.check_symbolic_forward(clip, [x], [np.clip(x, -.5, .5)],
                                           rtol=1e-6, atol=1e-6)
            bwd = t.check_symbolic_backward(
                clip, [x], [og], [og * ((x > -0.5) & (x < 0.5))],
                rtol=1e-6, atol=1e-6)
            s = sym.sum(sym.Variable("data"), axis=1)
            bsum = t.check_symbolic_backward(
                s, [x], [np.ones((4,), np.float32)], [np.ones_like(x)],
                rtol=1e-6, atol=1e-6)
            cat = sym.Concat(sym.Variable("a"), sym.Variable("b"), dim=1)
            bcat = t.check_symbolic_backward(
                cat, {"a": a, "b": b}, [og2],
                {"a": og2[:, :2], "b": og2[:, 2:]}, rtol=1e-6, atol=1e-6)
            fd = t.check_symbolic_forward(cat, {"a": a, "b": b},
                                          {cat.list_outputs()[0]:
                                           np.concatenate([a, b], 1)})
        got.append([fwd[0].asnumpy(), bwd[0].asnumpy(), bsum[0].asnumpy(),
                    bcat[0].asnumpy(), bcat[1].asnumpy(), fd[0].asnumpy()])
    for g, w in zip(got[1], got[0]):
        np.testing.assert_allclose(g, w, **_VALS)


def test_check_symbolic_checks_catch_a_wrong_expectation():
    x = _rand(3, 4)
    s = tmx.sym.relu(tmx.sym.Variable("data"))
    with pytest.raises(AssertionError):
        tu.check_symbolic_forward(s, [x], [x])
    with pytest.raises(AssertionError):
        tu.check_symbolic_backward(s, [x], [np.ones_like(x)],
                                   [np.ones_like(x)])
    with pytest.raises(AssertionError, match="not in arguments"):
        tu.check_symbolic_forward(s, {"nope": x}, [x])


# (the symbol, its input shapes, check_consistency's scale): bn_convnet
# at scale 0.1, since at 1.0 its logits reach ~20 and the two packages'
# BatchNorm statistics, summed in other orders, move its softmax by 1e-3
# relative
CONSISTENCY = {
    "mlp": (lambda pkg: pkg.models.get_mlp(), {"data": (4, 784)}, 1.0),
    "bn_convnet": (lambda pkg: chip_smoke.bn_convnet(pkg.sym),
                   {"data": (4, 1, 28, 28)}, 0.1),
    "fc_relu": (lambda pkg: pkg.sym.relu(pkg.sym.FullyConnected(
        pkg.sym.Variable("data"), num_hidden=7, name="fc")),
        {"data": (5, 6)}, 1.0),
    "lstm": (lambda pkg: pkg.sym.RNN(pkg.sym.Variable("data"), mode="lstm",
                                     state_size=6, num_layers=2,
                                     name="lstm"),
             {"data": (5, 3, 4)}, 1.0),
}


@pytest.mark.parametrize("case", sorted(CONSISTENCY))
@pytest.mark.parametrize("grad_req", ["write", "null"])
def test_check_consistency_gives_the_reference_outputs(case, grad_req):
    build, shapes, scale = CONSISTENCY[case]
    ref, port = _twin(build)
    with _ref_scope():
        want = rtu.check_consistency(
            ref, [dict(shapes, ctx=mx.cpu()), dict(shapes, ctx=mx.cpu())],
            scale=scale, grad_req=grad_req)
    errors = {}
    got = tu.check_consistency(
        port, [dict(shapes, ctx=tmx.cpu()), dict(shapes, ctx=tmx.cpu())],
        scale=scale, grad_req=grad_req, errors=errors)
    assert errors == {"outputs": 0.0, "grads": 0.0}
    assert len(got) == len(want) == 2
    for go, wo in zip(got, want):
        assert len(go) == len(wo)
        for g, w in zip(go, wo):
            np.testing.assert_allclose(g, w, **_VALS)


def test_check_consistency_arg_params_and_ground_truth():
    build, shapes, _ = CONSISTENCY["fc_relu"]
    ref, port = _twin(build)
    rng = np.random.RandomState(5)
    params = {"fc_weight": rng.randn(7, 6).astype(np.float32),
              "fc_bias": rng.randn(7).astype(np.float32)}
    specs = lambda pkg: [dict(shapes, ctx=pkg.cpu())] * 2  # noqa: E731
    with _ref_scope():
        want = rtu.check_consistency(ref, specs(mx), arg_params=params)
    got = tu.check_consistency(port, specs(tmx), arg_params=params,
                               ground_truth=want[0])
    np.testing.assert_allclose(got[1][0], want[1][0], **_VALS)
    with pytest.raises(AssertionError):
        tu.check_consistency(port, specs(tmx), arg_params=params,
                             ground_truth=[want[0][0] + 1.0])


def test_check_consistency_holds_gradients_too(capsys):
    """Two symbols with the same outputs and different gradients: the
    port holds gradients as well as outputs (raise_on_err=False prints
    instead of raising)."""
    data = tmx.sym.Variable("data")
    syms = [data * 2, tmx.sym.BlockGrad(data) * 2]
    specs = [{"ctx": tmx.cpu(), "data": (3, 4)}] * 2
    tu.check_consistency(syms, specs, grad_req="null")
    with pytest.raises(AssertionError, match="gradient of data"):
        tu.check_consistency(syms, specs)
    errors = {}
    tu.check_consistency(syms, specs, raise_on_err=False, errors=errors)
    assert errors["outputs"] == 0.0 and errors["grads"] > 1.0
    assert "gradient of data" in capsys.readouterr().out


def test_check_consistency_on_a_card_that_cannot_run_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    spec = {"ctx": tmx.Context("gpu", 0), "data": (3, 4)}
    with pytest.raises(MXNetError):
        tu.check_consistency(tmx.sym.relu(tmx.sym.Variable("data")),
                             [{"ctx": tmx.cpu(), "data": (3, 4)}, spec])
    with pytest.raises(MXNetError):
        tmx.gpu(0)


def test_simple_forward_and_check_speed():
    x = _rand(3, 4)
    outs = []
    for pkg, t in ((mx, rtu), (tmx, tu)):
        s = pkg.sym.relu(pkg.sym.Variable("data"))
        with _ref_scope():
            outs.append(t.simple_forward(s, pkg.cpu(), data=x))
    np.testing.assert_array_equal(outs[1], outs[0])
    np.testing.assert_array_equal(outs[1], np.maximum(x, 0))
    s = tmx.sym.FullyConnected(tmx.sym.Variable("data"), num_hidden=3,
                               name="fc")
    for typ in ("whole", "forward"):
        sec = tu.check_speed(s, location={"data": x}, ctx=tmx.cpu(), N=2,
                             typ=typ)
        assert 0 < sec < 10
    with pytest.raises(ValueError):
        tu.check_speed(s, location={"data": x}, ctx=tmx.cpu(), typ="bad")


# ---------------------------------------------------------------------------
# test_utils: helpers
# ---------------------------------------------------------------------------

def _both(fn):
    """fn(test_utils module) for the reference and the port, from the same
    numpy seed."""
    out = []
    for t in (rtu, tu):
        np.random.seed(7)
        random.seed(7)
        out.append(fn(t))
    return out


@pytest.mark.parametrize("draw", [
    lambda t: t.rand_shape_2d(), lambda t: t.rand_shape_3d(4, 5, 6),
    lambda t: t.rand_shape_nd(5, 3), lambda t: t.random_arrays((2, 3)),
    lambda t: t.random_arrays((2,), (), (1, 4)),
    lambda t: t.random_sample(list(range(20)), 6),
    lambda t: t.default_dtype(),
    lambda t: t.np_reduce(np.arange(24.).reshape(2, 3, 4), (0, 2), True,
                          np.sum),
    lambda t: t.np_reduce(np.arange(24.).reshape(2, 3, 4), 1, False,
                          np.max),
    lambda t: t.np_reduce(np.arange(6.).reshape(2, 3), None, False,
                          np.sum),
    lambda t: t.find_max_violation(np.array([1., 2., 3.]),
                                   np.array([1., 2.5, 3.]), 1e-3, 1e-3),
    lambda t: t.gen_buckets_probs_with_ppf(lambda q: 2 * q - 1, 4),
    lambda t: (t.get_rtol(), t.get_rtol(None, np.float16),
               t.get_atol(None, np.float64), t.get_atol(0.5)),
], ids=["shape2d", "shape3d", "shapend", "arrays", "arrays3", "sample",
        "dtype", "reduce_keep", "reduce_max", "reduce_all", "violation",
        "buckets", "tols"])
def test_helpers_give_the_reference_values(draw):
    want, got = _both(draw)

    def flat(v):
        if isinstance(v, (list, tuple)):
            return [flat(x) for x in v]
        return np.asarray(v).tolist() if isinstance(v, np.ndarray) else v
    assert flat(got) == flat(want)


@pytest.mark.parametrize("a,b,kw,ok", [
    (np.array([1., 2.]), np.array([1., 2. + 1e-6]), {}, True),
    (np.array([1., 2.]), np.array([1., 2.1]), {}, False),
    (np.array([1., 2.]), np.array([1., 2.1]), dict(rtol=0.1), True),
    (np.array([np.nan, 1.]), np.array([np.nan, 1.]), {}, False),
    (np.array([np.nan, 1.]), np.array([np.nan, 1.]), dict(equal_nan=True),
     True),
    (np.array([1, 2], np.int32), np.array([1, 2], np.int64), {}, True),
])
def test_comparisons_decide_as_the_reference(a, b, kw, ok):
    assert rtu.almost_equal(a, b, **kw) is ok
    assert tu.almost_equal(a, b, **kw) is ok
    assert tu.almost_equal(tmx.nd.array(a), b, **kw) is ok or \
        a.dtype.kind == "i"
    if not ok:
        with pytest.raises(AssertionError, match="Error"):
            tu.assert_almost_equal(a, b, names=("got", "want"), **kw)
    assert tu.same(a, a.copy()) is rtu.same(a, a.copy())
    assert not tu.same(a, a + 1)


def test_nan_ignoring_pair_and_exceptions():
    a = np.array([np.nan, 1.0, 2.0], np.float32)
    b = np.array([3.0, np.nan, 2.0], np.float32)
    for t in (rtu, tu):
        assert t.almost_equal_ignore_nan(a, b)
        assert not t.almost_equal_ignore_nan(a, b + 1)
        t.assert_almost_equal_ignore_nan(a, b)
        with pytest.raises(AssertionError):
            t.assert_almost_equal_ignore_nan(a, b + 1, names=("x", "y"))
        t.assert_exception(lambda: 1 / 0, ZeroDivisionError)
        with pytest.raises(AssertionError):
            t.assert_exception(lambda: 1, ZeroDivisionError)


def test_array_helpers():
    x = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert tu.same_array(x, x)
    assert not tu.same_array(x, x.copy())
    np.testing.assert_array_equal(x.asnumpy(),
                                  np.arange(6).reshape(2, 3))
    sq = tu.assign_each(x, lambda v: v * v)
    want = rtu.assign_each(mx.nd.array(x.asnumpy()), lambda v: v * v)
    np.testing.assert_array_equal(sq.asnumpy(), want.asnumpy())
    both = tu.assign_each2(x, sq, lambda u, v: u + v)
    want2 = rtu.assign_each2(mx.nd.array(x.asnumpy()), want,
                             lambda u, v: u + v)
    np.testing.assert_array_equal(both.asnumpy(), want2.asnumpy())
    assert sq.context == tmx.cpu()


def test_context_env_and_retry_helpers():
    assert tu.default_context() == tmx.cpu()
    prior = tu.default_context()
    try:
        tu.set_default_context(tmx.Context("gpu", 0))
        assert tu.default_context() == tmx.Context("gpu", 0)
    finally:
        tu.set_default_context(prior)
    assert tu.default_context() == tmx.cpu()
    assert tu.list_gpus() == list(range(torch.cuda.device_count()))
    key = "MXTT_TOOLING_TEST_VAR"
    assert tu.set_env_var(key, "1", "unset") == "unset"
    assert tu.set_env_var(key, "2") == "1"
    del os.environ[key]
    calls = []

    @tu.retry(3)
    def flaky():
        calls.append(1)
        assert len(calls) >= 2

    flaky()
    assert len(calls) == 2
    with pytest.raises(ValueError):
        tu.retry(0)

    @tu.retry(2)
    def broken():
        assert False, "always"

    with pytest.raises(AssertionError, match="always"):
        broken()
    with tu.discard_stderr():
        os.write(2, b"discarded\n")


def test_dummy_iter_repeats_the_first_batch():
    data = np.arange(20, dtype=np.float32).reshape(10, 2)
    its = [tu.DummyIter(tmx.io.NDArrayIter(data, np.zeros(10), 4)),
           rtu.DummyIter(mx.io.NDArrayIter(data, np.zeros(10), 4))]
    for it in its:
        first = next(it)
        for _ in range(5):
            assert next(it) is first
        it.reset()
        assert it.batch_size == 4
    np.testing.assert_array_equal(next(its[0]).data[0].asnumpy(),
                                  next(its[1]).data[0].asnumpy())
    assert [tuple(d) for d in its[0].provide_data] == \
        [tuple(d) for d in its[1].provide_data]


# ---------------------------------------------------------------------------
# test_utils: statistical checks on the port's samplers
# ---------------------------------------------------------------------------

def test_statistical_checks_on_a_known_generator():
    """tests/test_misc.py's use of the checks on numpy's generator: both
    packages' checks give the same p-values on the same draws."""
    out = []
    for t in (rtu, tu):
        rng = np.random.RandomState(0)
        assert t.mean_check(lambda n: rng.normal(0, 1, n), 0, 1,
                            nsamples=200000)
        assert t.var_check(lambda n: rng.normal(0, 1, n), 1,
                           nsamples=200000)
        buckets, probs = t.gen_buckets_probs_with_ppf(
            lambda q: float(np.clip(2 * q - 1, -0.9999, 0.9999)), 4)
        p, obs, exp = t.chi_square_check(lambda n: rng.uniform(-1, 1, n),
                                         buckets, probs, nsamples=50000)
        ps = t.verify_generator(lambda n: rng.uniform(-1, 1, n), buckets,
                                probs, nsamples=50000, nrepeat=2)
        out.append((p, obs.tolist(), exp.tolist(), ps))
    assert out[1] == out[0]
    with pytest.raises(AssertionError, match="no sample landed"):
        tu.chi_square_check(lambda n: np.full(n, 5.0), [(0, 1), (1, 2)],
                            [0.5, 0.5], nsamples=100)
    with pytest.raises(AssertionError, match="chi-square"):
        tu.verify_generator(lambda n: np.zeros(n), [(-1, 0.5), (0.5, 1)],
                            [0.5, 0.5], nsamples=1000, nrepeat=2)


def _port_sampler(kind, **params):
    def gen(n):
        fn = getattr(tmx.nd.random, kind)
        return fn(shape=(n,), ctx=tmx.cpu(), **params).asnumpy()
    return gen


@pytest.mark.parametrize("kind,params,ppf", [
    ("uniform", dict(low=-1.0, high=3.0), "uniform"),
    ("normal", dict(loc=0.5, scale=2.0), "norm"),
])
def test_verify_generator_passes_on_the_port_samplers(kind, params, ppf):
    from scipy import stats
    tmx.random.seed(11)
    if ppf == "uniform":
        dist = stats.uniform(loc=params["low"],
                             scale=params["high"] - params["low"])
        mu, sigma = dist.mean(), dist.std()
    else:
        dist = stats.norm(loc=params["loc"], scale=params["scale"])
        mu, sigma = params["loc"], params["scale"]
    buckets, probs = tu.gen_buckets_probs_with_ppf(
        lambda q: float(dist.ppf(min(max(q, 1e-6), 1 - 1e-6))), 10)
    gen = _port_sampler(kind, **params)
    tu.verify_generator(gen, buckets, probs, nsamples=100000, nrepeat=3)
    assert tu.mean_check(gen, mu, sigma, nsamples=200000)
    assert tu.var_check(gen, sigma, nsamples=200000)


def test_chi_square_check_on_a_discrete_port_sampler():
    tmx.random.seed(12)
    probs = [0.1, 0.2, 0.3, 0.4]

    def gen(n):
        return tmx.nd.random.multinomial(
            tmx.nd.array(np.array(probs, np.float32), ctx=tmx.cpu()),
            shape=(n,)).asnumpy()
    p, obs, _ = tu.chi_square_check(gen, [0, 1, 2, 3], probs,
                                    nsamples=50000)
    assert p > 1e-4 and obs.sum() == 50000


# ---------------------------------------------------------------------------
# test_utils: the data fetchers
# ---------------------------------------------------------------------------

def test_mnist_fetchers_write_the_reference_files(tmp_path):
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    assert rtu.get_mnist_ubyte(ref_dir) == ref_dir
    assert tu.get_mnist_ubyte(port_dir) == port_dir
    names = sorted(os.listdir(ref_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) == 4
    for n in names:
        with open(os.path.join(ref_dir, n), "rb") as f:
            want = f.read()
        with open(os.path.join(port_dir, n), "rb") as f:
            assert f.read() == want
    loaded = []
    for t, d in ((rtu, ref_dir), (tu, port_dir)):
        path = t.get_mnist_pkl(d)
        assert path == os.path.join(d, "mnist.pkl.gz")
        with gzip.open(path, "rb") as f:
            loaded.append(pickle.load(f))
        assert t.get_mnist_pkl(d) == path
    assert len(loaded[1]) == len(loaded[0]) == 3
    for (gx, gy), (wx, wy) in zip(loaded[1], loaded[0]):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_cifar10_fetcher_writes_the_reference_records(tmp_path):
    got = tu.get_cifar10(str(tmp_path / "port"))
    want = rtu.get_cifar10(str(tmp_path / "ref"))
    assert os.path.basename(got) == os.path.basename(want) == "cifar"
    for split in ("train.rec", "test.rec"):
        with open(os.path.join(want, split), "rb") as f:
            w = f.read()
        with open(os.path.join(got, split), "rb") as f:
            assert f.read() == w
    rec = tmx.recordio.MXRecordIO(os.path.join(got, "test.rec"), "r")
    header, _ = tmx.recordio.unpack(rec.read())
    assert header.label == 0.0 and header.id == 0


def test_local_fetchers_read_local_files(tmp_path):
    """download, get_bz2_data and get_zip_data on files already there:
    nothing is fetched (the url is not reachable)."""
    url = "http://example.invalid/data/file.txt"
    d = tmp_path / "dl"
    d.mkdir()
    (d / "file.txt").write_text("here")
    assert tu.download(url, dirname=str(d)) == str(d / "file.txt")
    assert tu.download(url, fname=str(d / "file.txt")) == \
        rtu.download(url, fname=str(d / "file.txt"))
    (d / "out.txt").write_text("unpacked")
    assert tu.get_bz2_data(str(d), "out.txt", url, "out.txt.bz2") == \
        str(d / "out.txt")
    for t, sub in ((rtu, "ref"), (tu, "port")):
        z = tmp_path / sub
        z.mkdir()
        with zipfile.ZipFile(z / "a.zip", "w") as f:
            f.writestr("inner/x.txt", "zipped")
        assert t.get_zip_data(str(z), url, "a.zip") == str(z)
        assert (z / "inner" / "x.txt").read_text() == "zipped"
    # the port's own tool, which imports neither jax nor the reference
    path = tu.get_im2rec_path()
    assert path == os.path.join(os.path.dirname(tmx.__file__), "tools",
                                "im2rec.py")
    assert os.path.basename(path) == os.path.basename(rtu.get_im2rec_path())
    with open(path) as f:
        assert not re.search(r"^\s*(?:import|from)\s+(jax|mxnet_tpu)"
                             r"(?:\.|\s|$)", f.read(), re.M)
