"""Port parity for deployment (`mxnet_tpu_torch.predict`) against the JAX
package on the CPU: the eight cases of tests/test_predict.py (Predictor
from a checkpoint, from param bytes, reshape, batched predict; export of a
Symbol and of a Gluon block, variable-length predict, the self-contained
artifact), each run by both packages on the same numpy inputs and
weights; then what the port adds: the word LM exported with
MXNET_FUSED_RNN=1 keeps K4a as the op `mxnet_tpu_torch::rnn_fwd` in its
graph, an export whose graph reaches K1-K3 raises naming the kernel, an
artifact replays in a process that imports only torch, the entry points
default to the card, and the op's registrations pass torch's opcheck.

Tolerances: float32 outputs within rtol 1e-5 / atol 1e-6 of the
reference's (the reference's own test tolerance; sums in another order);
the signature lines equal.
"""
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import predict as ref_pred
from mxnet_tpu import random as ref_random

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import predict as port_pred
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import gluon_params_from_numpy
from mxnet_tpu_torch.ops import fused_rnn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _on_cpu():
    """The port on the CPU; the reference's executor draws its key through
    a jax API this jax lacks unless a trace key is installed."""
    with tmx.cpu(), ref_random.trace_key_scope(jax.random.PRNGKey(0)):
        yield


def _mlp_checkpoint(tmp_path):
    """The reference test's MLP, saved by the reference: (prefix, input,
    the reference executor's output)."""
    x = mx.sym.Variable("data")
    h = mx.sym.FullyConnected(x, num_hidden=8, name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    y = mx.sym.softmax(mx.sym.FullyConnected(h, num_hidden=3, name="fc2"))
    ex = y.simple_bind(ctx=mx.cpu(), data=(2, 5))
    rng = np.random.RandomState(0)
    arg_params = {}
    for n, a in ex.arg_dict.items():
        if n == "data":
            continue
        a[:] = rng.randn(*a.shape).astype(np.float32) * 0.3
        arg_params[n] = a.copy()
    prefix = str(tmp_path / "m")
    mx.model.save_checkpoint(prefix, 1, y, arg_params, {})
    ex.arg_dict["data"][:] = rng.randn(2, 5).astype(np.float32)
    ref_out = ex.forward(is_train=False)[0].asnumpy()
    return prefix, ex.arg_dict["data"].asnumpy(), ref_out


def _twins(build, init_shape):
    """The same Gluon net in both packages with the reference's weights:
    (reference net, port net)."""
    with mx.name.NameManager():
        ref = build(mx)
    ref.initialize(mx.init.Xavier())
    ref(mx.nd.array(np.zeros(init_shape, np.float32)))
    with tmx.name.NameManager():
        port = build(tmx)
    port.initialize()
    port(tmx.nd.array(np.zeros(init_shape, np.float32)))
    gluon_params_from_numpy(port, {n: p.data().asnumpy() for n, p in
                                   ref.collect_params().items()})
    return ref, port


def _mlp_block(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(4, in_units=6, activation="relu"))
    net.add(pkg.gluon.nn.Dense(2, in_units=4))
    return net


def test_predictor_from_checkpoint(tmp_path):
    prefix, x, ref = _mlp_checkpoint(tmp_path)
    with open(prefix + "-symbol.json") as f:
        symbol_json = f.read()
    pred = tmx.Predictor(symbol_json, prefix + "-0001.params",
                         {"data": (2, 5)})
    pred.set_input("data", x)
    pred.forward()
    np.testing.assert_allclose(pred.get_output(0).asnumpy(), ref, **_TOL)


def test_predictor_from_param_bytes(tmp_path):
    prefix, x, ref = _mlp_checkpoint(tmp_path)
    with open(prefix + "-symbol.json") as f:
        symbol_json = f.read()
    with open(prefix + "-0001.params", "rb") as f:
        raw = f.read()
    out = tmx.Predictor(symbol_json, raw, {"data": (2, 5)}).forward(
        data=x)[0].asnumpy()
    np.testing.assert_allclose(out, ref, **_TOL)


def test_predictor_reshape(tmp_path):
    prefix, _, _ = _mlp_checkpoint(tmp_path)
    with open(prefix + "-symbol.json") as f:
        symbol_json = f.read()
    x = np.random.RandomState(2).randn(7, 5).astype(np.float32)
    outs = []
    for pkg in (mx, tmx):
        pred = pkg.Predictor(symbol_json, prefix + "-0001.params",
                             {"data": (2, 5)})
        pred.reshape({"data": (7, 5)})
        outs.append(pred.forward(data=x)[0].asnumpy())
    assert outs[1].shape == (7, 3)
    np.testing.assert_allclose(outs[1], outs[0], **_TOL)


def test_export_symbol_round_trip(tmp_path):
    prefix, x, ref = _mlp_checkpoint(tmp_path)
    art = str(tmp_path / "m.mxtpu")
    sym, _, _ = tmx.model.load_checkpoint(prefix, 1)
    port_pred.export_model(sym, {"data": (2, 5)}, art,
                           params=prefix + "-0001.params")
    served = port_pred.load_exported(art, ctx=tmx.cpu())
    assert served.input_descs[0]["name"] == "data"
    np.testing.assert_allclose(served.forward(data=x)[0].asnumpy(), ref,
                               **_TOL)


def test_export_gluon_block(tmp_path):
    ref_net, net = _twins(_mlp_block, (1, 6))
    x = np.random.RandomState(1).randn(3, 6).astype(np.float32)
    ref_art, art = str(tmp_path / "r.mxtpu"), str(tmp_path / "g.mxtpu")
    ref_pred.export_model(ref_net, [("x", (3, 6))], ref_art)
    port_pred.export_model(net, [("x", (3, 6))], art)
    want = ref_pred.load_exported(ref_art).forward(x=x)[0].asnumpy()
    got = port_pred.load_exported(art).forward(x=x)[0].asnumpy()
    np.testing.assert_allclose(got, want, **_TOL)
    np.testing.assert_allclose(got, net(tmx.nd.array(x)).asnumpy(), **_TOL)


def test_predictor_predict_batches_and_pads(tmp_path):
    prefix, _, _ = _mlp_checkpoint(tmp_path)
    with open(prefix + "-symbol.json") as f:
        symbol_json = f.read()
    rng = np.random.RandomState(3)
    samples = [rng.randn(5).astype(np.float32) for _ in range(5)]
    outs = [pkg.Predictor(symbol_json, prefix + "-0001.params",
                          {"data": (2, 5)}).predict(samples)
            for pkg in (mx, tmx)]
    assert len(outs[1]) == 5
    for got, want in zip(outs[1], outs[0]):
        np.testing.assert_allclose(got, want, **_TOL)


def test_exported_predict_variable_length(tmp_path):
    ref_net, net = _twins(
        lambda pkg: pkg.gluon.nn.Dense(3, in_units=4, flatten=False),
        (1, 4))
    ref_art, art = str(tmp_path / "r.mxtpu"), str(tmp_path / "v.mxtpu")
    ref_pred.export_model(ref_net, [("x", (2, 6, 4))], ref_art)
    port_pred.export_model(net, [("x", (2, 6, 4))], art)
    served = port_pred.load_exported(art)
    rng = np.random.RandomState(5)
    samples = [rng.randn(n, 4).astype(np.float32) for n in (3, 6, 2)]
    outs = served.predict(samples)
    assert [o.shape for o in outs] == [(3, 3), (6, 3), (2, 3)]
    for got, want in zip(outs, ref_pred.load_exported(ref_art).predict(
            samples)):
        np.testing.assert_allclose(got, want, **_TOL)
    with pytest.raises(MXNetError):
        served.predict([rng.randn(7, 4).astype(np.float32)])  # too long
    with pytest.raises(MXNetError):
        served.predict([rng.randn(3, 5).astype(np.float32)])  # bad width


def test_exported_artifact_is_self_contained(tmp_path):
    """The artifact replays through torch.export alone, its meta.json and
    signature.txt are the reference's."""
    import io
    ref_net, net = _twins(lambda pkg: pkg.gluon.nn.Dense(2, in_units=3),
                          (1, 3))
    x = np.ones((1, 3), np.float32)
    ref_art, art = str(tmp_path / "r.mxtpu"), str(tmp_path / "d.mxtpu")
    ref_pred.export_model(ref_net, [("x", (1, 3))], ref_art)
    port_pred.export_model(net, [("x", (1, 3))], art)
    with zipfile.ZipFile(art) as z, zipfile.ZipFile(ref_art) as rz:
        assert {"meta.json", "signature.txt", "model.pt2"} <= set(
            z.namelist())
        blob = z.read("model.pt2")
        meta = json.loads(z.read("meta.json"))
        assert z.read("signature.txt") == rz.read("signature.txt")
        assert meta["inputs"] == json.loads(rz.read("meta.json"))["inputs"]
    program = torch.export.load(io.BytesIO(blob))
    out = program.module()(torch.from_numpy(x))[0].detach().numpy()
    np.testing.assert_allclose(out, ref_net(mx.nd.array(x)).asnumpy(),
                               **_TOL)


def _lm_block(pkg, vocab=20, layers=2):
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        net.add(pkg.gluon.nn.Embedding(vocab, 8))
        net.add(pkg.gluon.rnn.LSTM(16, layout="NTC", num_layers=layers))
        net.add(pkg.gluon.nn.Dense(vocab, flatten=False))
    return net


def _rnn_nodes(program):
    return [n for n in program.graph.nodes
            if n.target is torch.ops.mxnet_tpu_torch.rnn_fwd.default]


@pytest.mark.parametrize("hybridize", [False, True])
def test_word_lm_export_keeps_k4a(tmp_path, monkeypatch, hybridize):
    """The word LM exported with MXNET_FUSED_RNN=1 holds one
    `mxnet_tpu_torch::rnn_fwd` node a layer, and its replay matches the
    reference's exported word LM (the same weights, its fused path on)
    within 1e-5."""
    monkeypatch.setenv("MXNET_FUSED_RNN", "1")
    ref_net, net = _twins(_lm_block, (2, 6))
    tok = np.random.RandomState(0).randint(0, 20, (2, 6)).astype(np.float32)
    if hybridize:
        net.hybridize()
        net(tmx.nd.array(tok))
    ref_art, art = str(tmp_path / "r.mxtpu"), str(tmp_path / "lm.mxtpu")
    ref_pred.export_model(ref_net, [("data", (2, 6))], ref_art)
    port_pred.export_model(net, [("data", (2, 6))], art)
    served = port_pred.load_exported(art)
    assert len(_rnn_nodes(served.program)) == 2
    want = ref_pred.load_exported(ref_art).forward(data=tok)[0].asnumpy()
    got = served.forward(data=tok)[0].asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    eager = net(tmx.nd.array(tok)).asnumpy()
    np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-6)


def test_word_lm_export_flag_off_has_no_k4a(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_RNN", "0")
    with tmx.name.NameManager():
        net = _lm_block(tmx)
    net.initialize(tmx.init.Xavier())
    port_pred.export_model(net, [("data", (2, 6))], str(tmp_path / "a"))
    assert not _rnn_nodes(port_pred.load_exported(str(tmp_path / "a"))
                          .program)


class _CallsKernel(tmx.gluon.HybridBlock):
    """A block whose forward calls one kernel's wrapper directly."""

    def __init__(self, kernel):
        super().__init__()
        self._kernel = kernel

    def forward(self, x):
        from mxnet_tpu_torch.ops import flash_attention, fused_bn, \
            paged_attention
        t = x._data
        if self._kernel == "K1":
            q = t.reshape(1, 1, 1, 4)
            pool = t.reshape(1, 4, 1, 1).expand(1, 4, 1, 4).contiguous()
            out = paged_attention.paged_attention(
                q, pool, pool, torch.zeros((1, 1), dtype=torch.int32),
                torch.zeros((1,), dtype=torch.int32), 4)
        elif self._kernel == "K2":
            q = t.reshape(1, 1, 4)
            out = flash_attention.flash_attention(q, q, q)
        else:
            out = fused_bn.fused_bn_act(t.reshape(1, 4, 1, 1),
                                        torch.ones(4), torch.zeros(4))[0]
        return tmx.nd.NDArray(out.reshape(-1))


@pytest.mark.parametrize("kernel,name", [
    ("K1", "paged_attention"), ("K2", "flash_attention"),
    ("K3a", "fused_bn stats")])
def test_export_refuses_k1_to_k3(tmp_path, kernel, name):
    """K1-K3 launch through ctypes, which no exported program can hold;
    an export whose graph reaches one raises, naming it (eagerly the same
    block runs, on the CPU through the plain versions)."""
    blk = _CallsKernel(kernel)
    blk.initialize()
    blk(tmx.nd.array(np.arange(4, dtype=np.float32)))
    with pytest.raises(MXNetError, match="%s \\(%s" % (kernel, name)):
        port_pred.export_model(blk, [("x", (4,))], str(tmp_path / "k"))


def test_artifact_replays_in_a_process_that_imports_only_torch(tmp_path):
    """A net without kernels replays from model.pt2 in a fresh process
    that imports torch and nothing of either package."""
    with tmx.name.NameManager():
        net = _mlp_block(tmx)
    net.initialize(tmx.init.Xavier())
    x = np.random.RandomState(4).randn(3, 6).astype(np.float32)
    want = net(tmx.nd.array(x)).asnumpy()
    art = str(tmp_path / "g.mxtpu")
    port_pred.export_model(net, [("x", (3, 6))], art)
    np.save(str(tmp_path / "x.npy"), x)
    code = (
        "import io, sys, zipfile, numpy as np, torch\n"
        "z = zipfile.ZipFile(sys.argv[1])\n"
        "p = torch.export.load(io.BytesIO(z.read('model.pt2')))\n"
        "x = torch.from_numpy(np.load(sys.argv[2]))\n"
        "np.save(sys.argv[3], p.module()(x)[0].detach().numpy())\n"
        "bad = [m for m in sys.modules if m.startswith(('mxnet', 'jax'))]\n"
        "assert not bad, bad\n")
    out = str(tmp_path / "out.npy")
    subprocess.run([sys.executable, "-c", code, art,
                    str(tmp_path / "x.npy"), out], check=True, cwd=str(
                        tmp_path), env=dict(os.environ, PYTHONPATH=""),
                   timeout=300)
    np.testing.assert_allclose(np.load(out), want, **_TOL)


def test_entry_points_default_to_the_card(tmp_path):
    """Outside a CPU scope, load_exported and Predictor ask for the card,
    and without one they raise rather than fall back to the CPU."""
    prefix, _, _ = _mlp_checkpoint(tmp_path)
    art = str(tmp_path / "m.mxtpu")
    sym, _, _ = tmx.model.load_checkpoint(prefix, 1)
    port_pred.export_model(sym, {"data": (2, 5)}, art,
                           params=prefix + "-0001.params")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with tmx.Context("gpu", 0):  # the default context, unresolved
        with pytest.raises(MXNetError, match="cuda"):
            port_pred.load_exported(art)
        with pytest.raises(MXNetError, match="cuda"):
            tmx.Predictor(open(prefix + "-symbol.json").read(),
                          prefix + "-0001.params", {"data": (2, 5)})


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("reverse", [False, True])
def test_rnn_fwd_op_passes_opcheck(mode, reverse):
    """torch.library.opcheck on K4a's op: its schema, its fake (the saved
    cs and ys included) against the real outputs, and its registered
    autograd (K4b)."""
    T, N, H = 3, 2, 4
    G = 4 if mode == "lstm" else 1
    rng = np.random.RandomState(1)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.randn(*s) * 0.5).astype(np.float32)).requires_grad_(True)
    c0 = mk(N, H) if mode == "lstm" else None
    args = (mode, mk(T, N, G * H), mk(N, H), c0, mk(G * H, H), reverse)
    torch.library.opcheck(fused_rnn.rnn_fwd_op, args)


def test_rnn_op_gradients_match_composite(monkeypatch):
    """The op's registered backward (K4b's plain version on the CPU) gives
    the composite scan's gradients, through the RNN op."""
    from mxnet_tpu_torch.ops import nn as port_nn
    rng = np.random.RandomState(2)
    T, N, C, H = 4, 3, 5, 6
    x = torch.from_numpy(rng.randn(T, N, C).astype(np.float32))
    n_params = 4 * H * (C + H + 2)
    flat = torch.from_numpy((rng.randn(n_params) * 0.3).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(1, N, H).astype(np.float32))
    c0 = torch.from_numpy(rng.randn(1, N, H).astype(np.float32))
    grads = {}
    for fused in (True, False):
        ins = [t.clone().requires_grad_(True) for t in (x, flat, h0, c0)]
        out, hT, cT = port_nn.RNN(*ins, state_size=H, num_layers=1,
                                  mode="lstm", state_outputs=True,
                                  fused=fused)
        (out.sum() + hT.square().sum() + cT.sum()).backward()
        grads[fused] = [t.grad for t in ins]
    for got, want in zip(grads[True], grads[False]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_chip_smoke_phase_29_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 29 at a tiny width on the CPU, the user
    kernels computed by a stand-in (no NVRTC here): every check holds but
    the launch counts of K4a, which the CPU's plain version does not
    launch."""
    import chip_smoke as cs
    from mxnet_tpu_torch import rtc
    failed = []
    monkeypatch.setattr(cs, "check", lambda c, msg: c or failed.append(msg))
    for name, value in dict(DEPLOY_BATCH=2, DEPLOY_SAMPLES=3, DEPLOY_TIMED=1,
                            R50_IMAGE=32, LM_VOCAB=50, LM_EMBED=8,
                            LM_HIDDEN=8, LM_BPTT=5, LM_BATCH=3,
                            RTC_N=1 << 12, RTC_ROWS=4, RTC_TILE=256,
                            TORCHBLOCK_BATCH=4).items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "time_ms", lambda torch, fn, n=50, flush=None,
                        sleep=True: (fn(), 0.0)[1])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(tmx, "gpu", lambda i=0: tmx.cpu())

    class Kernel:
        def __init__(self, name):
            self.name, self.launches = name, 0

        def launch(self, args, ctx, grid, block, shared_mem=0):
            self.launches += 1
            x = args[0]._data
            if self.name == "double_it":
                args[1]._data = x * 2
            elif self.name == "saxpy":
                args[1]._data = args[2] * x + args[1]._data
            elif self.name == "tile_reverse":
                args[1]._data = x.view(-1, args[3]).flip(-1).reshape(-1)
            else:
                args[1]._data = x.view(args[1].shape[0], -1,
                                       args[3]).sum(-1)

    class Module:
        def __init__(self, source):
            assert "block_sum" in source

        def get_kernel(self, name, signature):
            rtc.parse_signature(signature)
            return Kernel(name)

    monkeypatch.setattr(rtc, "CudaModule", Module)
    launches, rows, out = cs.phase_deploy(torch, np, torch.device("cpu"),
                                          "cpu")
    assert [r["name"] for r in rows] == ["rtc_double_it", "rtc_saxpy",
                                         "rtc_block_sum",
                                         "rtc_tile_reverse"]
    assert all(r["launches"] == 1 for r in rows)
    assert launches == (0, 0)
    assert failed and all("launched K4a/K4b" in m for m in failed), failed
    assert out["29b"]["rnn_fwd_nodes"] == 2
