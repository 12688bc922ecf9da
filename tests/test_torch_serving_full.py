"""Port parity for the full-forward serving adapters (mxnet_tpu_torch/
serving/engine.py `BlockLM`, `ExportedLM`, and `serve()`'s model
resolution in server.py) against the JAX reference, on the CPU.

The word LM (`models.RNNModel`, time-major LSTM) is built in both packages
with the reference's weights carried across as numpy. The reference's
engine over its `BlockLM` (what its `serve(net, vocab=, max_len=,
time_major=True)` runs) is the oracle: the port's
`serve()` over the same net (BlockLM, with MXNET_FUSED_RNN on and off, the
flag on running K4a's plain version here), over a batch-major wrapper of
it exported to a `.mxtpu` (ExportedLM) and over the adapters passed
directly must give identical greedy tokens. The watchdog sites
`serving.step_full` / `serving.exported_call` and the engine's counters
are pinned as the reference's test_introspect.py pins them.
"""
import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import random as ref_random

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.telemetry import introspect

_VOCAB, _EMB, _HID, _LAYERS = 40, 16, 16, 2
_MAX_LEN = 16
PROMPTS = ([3, 7, 1, 9], [5, 2], [11, 4, 8, 8, 2, 6, 1])
_NEW = 6
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _fresh():
    introspect.reset()
    with tmx.cpu():
        yield
    introspect.reset()


def _nets():
    """(reference RNNModel, port RNNModel, the weights as numpy)."""
    kw = dict(mode="lstm", vocab_size=_VOCAB, num_embed=_EMB,
              num_hidden=_HID, num_layers=_LAYERS, dropout=0.0)
    with mx.name.NameManager():
        ref = mx.models.RNNModel(**kw)
    with tmx.name.NameManager():
        port = tmx.models.RNNModel(**kw)
    ref.initialize(mx.init.Xavier())
    port.initialize(tmx.init.Xavier())
    with ref_random.trace_key_scope(jax.random.PRNGKey(0)):
        ref(mx.nd.zeros((4, 2)))
    port(tmx.nd.zeros((4, 2)))
    arrays = [np.asarray(p.data()._data)
              for p in ref.collect_params().values()]
    _set_by_order(port, arrays)
    return ref, port, arrays


def _set_by_order(net, arrays):
    params = list(net.collect_params().values())
    assert len(params) == len(arrays)
    for p, a in zip(params, arrays):
        assert tuple(p.shape) == a.shape
        p.set_data(tmx.nd.array(a))


@pytest.fixture(scope="module")
def reference_tokens():
    """The reference engine over its BlockLM (what its serve() runs),
    driven on this thread inside `trace_key_scope` (this jax lacks the
    API its eager RNN op asks for otherwise): greedy tokens per
    prompt."""
    with tmx.cpu():
        ref, _, arrays = _nets()
    toks = []
    with ref_random.trace_key_scope(jax.random.PRNGKey(0)):
        eng = mx.serving.Engine(
            mx.serving.BlockLM(ref, _VOCAB, _MAX_LEN, time_major=True),
            max_batch=4)
        for p in PROMPTS:
            seq = eng.start(list(p), max_new=_NEW)
            while not seq.done:
                eng.decode_step([seq])
            toks.append(list(seq.generated))
    return arrays, toks


def _port_tokens(model, **kw):
    srv = tserving.serve(model, max_batch=4, **kw)
    try:
        return [srv.generate(list(p), max_new_tokens=_NEW, timeout=TIMEOUT)
                for p in PROMPTS], srv
    finally:
        srv.close()


@pytest.mark.parametrize("fused", ["0", "1"])
def test_block_lm_tokens_match_reference_serve(reference_tokens,
                                               monkeypatch, fused):
    arrays, want = reference_tokens
    monkeypatch.setenv("MXNET_FUSED_RNN", fused)
    _, port, _ = _nets()
    _set_by_order(port, arrays)
    got, srv = _port_tokens(port, vocab=_VOCAB, max_len=_MAX_LEN,
                            time_major=True, device="cpu")
    assert got == want
    assert isinstance(srv.engine.model, tserving.BlockLM)
    assert srv.engine.cache is None and srv.engine.paged is False
    evs = introspect.compile_events("serving.step_full")
    assert evs and evs[0]["reason"].startswith(
        "first compilation at this site")
    assert all("(timed with first execution)" in e["reason"] for e in evs)
    assert any("tokens: shape" in e["reason"] for e in evs[1:]), \
        [e["reason"] for e in evs]
    assert srv.engine.prefill_compilations + \
        srv.engine.decode_compilations == len(evs)


class _BatchMajor(tmx.gluon.Block):
    """(B, S) token ids -> (B, S, V) logits over a time-major RNNModel."""

    def __init__(self):
        super().__init__(prefix="bm_")
        with self.name_scope():
            self.lm = tmx.models.RNNModel(
                mode="lstm", vocab_size=_VOCAB, num_embed=_EMB,
                num_hidden=_HID, num_layers=_LAYERS, dropout=0.0)

    def forward(self, x):
        N, T = x.shape
        out = self.lm(x.T)
        return out.reshape((T, N, -1)).transpose((1, 0, 2))


def _exported(tmp_path, arrays, batch=2):
    with tmx.name.NameManager():
        net = _BatchMajor()
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.zeros((batch, _MAX_LEN)))
    _set_by_order(net, arrays)
    path = str(tmp_path / "lm.mxtpu")
    tmx.predict.export_model(net, [("data", (batch, _MAX_LEN))], path,
                             input_dtypes={"data": "int32"})
    return path


@pytest.mark.parametrize("fused", ["0", "1"])
def test_exported_lm_tokens_match_reference_serve(reference_tokens,
                                                  monkeypatch, tmp_path,
                                                  fused):
    """The batch-major twin exported (flag on: the graph holds the op
    mxnet_tpu_torch::rnn_fwd) and served from its path: the reference's
    tokens, with the exported batch (2) smaller than the decode batch."""
    arrays, want = reference_tokens
    monkeypatch.setenv("MXNET_FUSED_RNN", fused)
    path = _exported(tmp_path, arrays)
    got, srv = _port_tokens(path, device="cpu")
    assert got == want
    assert isinstance(srv.engine.model, tserving.ExportedLM)
    assert srv.engine.model.vocab == _VOCAB
    evs = introspect.compile_events("serving.exported_call")
    assert len(evs) == 1 and evs[0]["reason"].startswith(
        "first compilation at this site")


def test_adapters_pass_through_serve(reference_tokens, tmp_path):
    arrays, want = reference_tokens
    _, port, _ = _nets()
    _set_by_order(port, arrays)
    adapter = tserving.BlockLM(port, vocab=_VOCAB, max_len=_MAX_LEN,
                               time_major=True)
    got, srv = _port_tokens(adapter)
    assert got == want and srv.engine.model is adapter
    exported = tserving.ExportedLM(_exported(tmp_path, arrays),
                                   device="cpu")
    got, srv = _port_tokens(exported)
    assert got == want and srv.engine.model is exported


def test_block_without_vocab_raises():
    _, port, _ = _nets()
    with pytest.raises(MXNetError, match="vocab= and max_len="):
        tserving.serve(port, device="cpu")
    with pytest.raises(MXNetError, match="don't know how to serve"):
        tserving.serve(object(), device="cpu")


def test_no_cache_family_records_fallbacks():
    """The reference's test_no_cache_family_records_both_fallbacks, plus
    the options that need the pool."""
    _, port, _ = _nets()
    eng = tserving.Engine(
        tserving.BlockLM(port, vocab=_VOCAB, max_len=_MAX_LEN,
                         time_major=True),
        max_batch=2, kv_quant=True, weight_quant="int8", prefix_cache=True,
        paged=True, tp=2)
    try:
        assert not eng.kv_quant and eng.kv_quant_fallback is not None
        assert eng.weight_quant is None
        assert eng.weight_quant_fallback is not None
        assert eng.prefix_cache is None and eng.prefix_cache_fallback
        assert eng.tp == 1 and "no cache hooks" in eng.tp_fallback
        assert eng.paged is False and eng.kv_bytes_per_token() == 0
        assert eng.cache_utilization() is None
    finally:
        eng.close()


def test_shared_adapter_counters_stay_per_engine():
    """The reference's test_introspect.py case: two engines over ONE
    BlockLM adapter count only the first runs their own calls paid, and a
    warm shared adapter reads as zero new compiles."""
    _, port, _ = _nets()
    adapter = tserving.BlockLM(port, vocab=_VOCAB, max_len=8,
                               time_major=True)
    e1 = tserving.Engine(adapter, max_batch=2)
    e2 = tserving.Engine(adapter, max_batch=2)
    seq = e1.start([1, 2, 3], max_new=4)
    while not seq.done:
        e1.decode_step([seq])
    assert e1.prefill_compilations >= 1
    assert e1.decode_compilations >= 1
    assert e2.prefill_compilations == 0 and e2.decode_compilations == 0
    p1, d1 = e1.prefill_compilations, e1.decode_compilations
    seq = e2.start([1, 2, 3], max_new=4)
    while not seq.done:
        e2.decode_step([seq])
    assert e2.prefill_compilations == 0 and e2.decode_compilations == 0
    assert (e1.prefill_compilations, e1.decode_compilations) == (p1, d1)
    assert e1.warm_loads == e2.warm_loads == 0


def test_block_lm_logits_match_reference_blocklm():
    """One full-forward step of both packages' BlockLM on the same
    (B, S) batch: float32 logits at lengths-1 within 1e-5."""
    ref, port, _ = _nets()
    toks = np.array([[3, 7, 1, 9], [5, 2, 0, 0]], np.int32)
    lens = np.array([4, 2], np.int32)
    with ref_random.trace_key_scope(jax.random.PRNGKey(0)):
        want = np.asarray(mx.serving.BlockLM(
            ref, _VOCAB, _MAX_LEN, time_major=True).step_full(toks, lens))
    got = tserving.BlockLM(port, _VOCAB, _MAX_LEN,
                           time_major=True).step_full(toks, lens)
    assert got.dtype == torch.float32 and got.shape == (2, _VOCAB)
    err = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert err < 1e-5, err
