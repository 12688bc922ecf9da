"""The port's C++ deployment half on the CPU (mxnet_tpu_torch/cpp_package/):
the tree built with g++ against torch's libraries, artifacts compiled for
the CPU by `predict.compile_for_cpp` (AOTInductor), `mxtpu_predict`, the
C predict API, and K4a's C++ op (`mxnet_tpu_torch::rnn_fwd` in
libmxtpu_torch_ops.so), whose CPU scan serves the packages here.

The C++ libraries link libtorch and register the op's namespace, which
the port registers in Python too, so they run in processes of their own:
the binaries, or `chip_smoke.C_API_CLIENT` / a torch-only script loading
them through ctypes / `torch.ops.load_library`. The tree and the packages
are made once per module. Tolerances: the C++ outputs against the Python
replay of the same artifact within 1e-5 of the largest output (the CPU
package runs Inductor's fused kernels where the replay runs torch's ops,
float32 either way; they read bit-equal here), and against the JAX
reference's net on the same weights within 1e-5 of the largest.
"""
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import chip_smoke as cs
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cpp_package
from mxnet_tpu_torch import predict as port_pred
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import gluon_params_from_numpy
from mxnet_tpu_torch.ops import fused_rnn

_REL = 1e-5
MODES = ("lstm", "rnn_tanh", "rnn_relu")
LAYERS, HIDDEN, VOCAB, T, N = 2, 16, 20, 6, 3


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


@pytest.fixture(scope="module")
def tree():
    return cpp_package.build("cpu")


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _run(argv, ok=True):
    p = subprocess.run(argv, capture_output=True, text=True, timeout=300)
    if ok:
        assert p.returncode == 0, p.stderr[-3000:]
    return p


def _mlp(pkg):
    net = pkg.gluon.nn.HybridSequential()
    net.add(pkg.gluon.nn.Dense(5, in_units=7, activation="relu"))
    net.add(pkg.gluon.nn.Dense(4, in_units=5))
    return net


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    """The 3 x 7 MLP in both packages on the reference's weights, the
    port's export compiled for the CPU: (artifact, x, the reference's
    output, the replay's output)."""
    with tmx.cpu():
        with mx.name.NameManager():
            ref = _mlp(mx)
        ref.initialize(mx.init.Xavier())
        ref(mx.nd.zeros((3, 7)))
        with tmx.name.NameManager():
            net = _mlp(tmx)
        net.initialize()
        net(tmx.nd.zeros((3, 7)))
        gluon_params_from_numpy(net, {n: p.data().asnumpy() for n, p in
                                      ref.collect_params().items()})
        x = np.random.RandomState(0).randn(3, 7).astype(np.float32)
        art = str(tmp_path_factory.mktemp("mlp") / "mlp.mxtpu")
        port_pred.export_model(net, [("data", (3, 7))], art)
        port_pred.compile_for_cpp(art, ctx=tmx.cpu())
        replay = port_pred.load_exported(art, ctx=tmx.cpu())
        return (art, x, ref(mx.nd.array(x)).asnumpy(),
                replay.forward(data=x)[0].asnumpy())


def test_cpu_build_makes_every_product_once(tree):
    for path in (tree.predict_lib, tree.ops_lib, tree.mxtpu_predict,
                 tree.mxtpu_train):
        assert os.path.exists(path), path
    assert tree.device == "cpu"
    assert os.path.basename(tree.dir).startswith("cpp-cpu-")
    assert cpp_package.build("cpu") == tree  # the cached tree


def test_compile_for_cpp_adds_the_package(mlp):
    art = mlp[0]
    with zipfile.ZipFile(art) as z:
        names = z.namelist()
        infos = z.infolist()
        meta = json.loads(z.read("meta.json"))
    assert "aoti/cpu.pt2" in names and "model.pt2" in names
    assert all(i.compress_type == zipfile.ZIP_STORED for i in infos)
    assert meta["aoti"]["cpu"]["torch"] == torch.__version__


def test_mxtpu_predict_matches_replay_and_reference(tree, mlp, tmp_path):
    art, x, want_ref, want = mlp
    x.tofile(tmp_path / "x.bin")
    p = _run([tree.mxtpu_predict, art, "--device", "cpu", "--input",
              "0=%s" % (tmp_path / "x.bin"), "--output-dir", str(tmp_path),
              "--repeat", "2"])
    assert "platform: cpu" in p.stdout
    assert "output 0: f32 [3,4]" in p.stdout
    assert cs.cpp_line(p.stdout, "forward ms:") > 0
    got = np.fromfile(tmp_path / "out0.bin", np.float32).reshape(want.shape)
    assert _rel(got, want) <= _REL
    assert _rel(got, want_ref) <= _REL


def test_c_api_through_a_fresh_process(tree, mlp, tmp_path):
    """The 13 functions in the reference's order (chip_smoke.C_API_CLIENT,
    ctypes in a process that imports neither torch nor the port):
    platform "cpu", the shapes, -1 with a message for a short input, an
    index past the inputs, a forward before any input and a wrong output
    size, and the output equal to the replay's."""
    art, x, want_ref, want = mlp
    xp, yp = str(tmp_path / "x.bin"), str(tmp_path / "y.bin")
    x.tofile(xp)
    p = _run([sys.executable, "-c", cs.C_API_CLIENT, tree.predict_lib, art,
              "cpu", xp, yp, "2"])
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["platform"] == "cpu" and got["modules"] == []
    assert (got["inputs"], got["outputs"]) == (1, 1)
    assert got["input_shape"] == [3, 7] and got["input_dtype"] == "f32"
    assert got["output_shape"] == [3, 4] and got["output_dtype"] == "f32"
    errs = got["errors"]
    assert set(errs) == {"short_input", "input_index",
                         "forward_before_input", "output_size"}
    for rc, msg in errs.values():
        assert rc == -1 and msg
    assert "expects 21 f32 elements, got 20" in errs["short_input"][1]
    assert "never set" in errs["forward_before_input"][1]
    y = np.fromfile(yp, np.float32).reshape(want.shape)
    assert _rel(y, want) <= _REL and _rel(y, want_ref) <= _REL


#: a fresh process: MXTPUPredCreate on an artifact and a device, printing
#: the return code and the message
_CREATE = r"""
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
lib.MXTPUPredGetLastError.restype = ctypes.c_char_p
h = ctypes.c_void_p()
rc = lib.MXTPUPredCreate(sys.argv[2].encode(), sys.argv[3].encode(), None,
                         0, ctypes.byref(h))
print(rc, lib.MXTPUPredGetLastError().decode())
"""


def test_missing_package_names_compile_for_cpp(tree, mlp, tmp_path):
    """An artifact without the device's package fails in the CLI and the C
    API with a message naming compile_for_cpp: one never compiled, and
    the CPU-compiled one asked for the card."""
    with tmx.name.NameManager():
        net = _mlp(tmx)
    net.initialize()
    bare = str(tmp_path / "bare.mxtpu")
    port_pred.export_model(net, [("data", (3, 7))], bare)
    p = _run([tree.mxtpu_predict, bare, "--device", "cpu"], ok=False)
    assert p.returncode == 1
    assert "aoti/cpu.pt2" in p.stderr and "compile_for_cpp" in p.stderr
    for art, device, entry in ((bare, "cpu", "aoti/cpu.pt2"),
                               (mlp[0], "cuda:0", "aoti/cuda.pt2")):
        out = _run([sys.executable, "-c", _CREATE, tree.predict_lib, art,
                    device]).stdout
        assert out.startswith("-1 ") and entry in out and \
            "compile_for_cpp" in out


def test_cuda_build_without_cuda_raises(monkeypatch):
    """No fallback: a CUDA build with this CPU-only torch raises, naming
    it; with a torch that says CUDA but no nvcc, it raises naming nvcc."""
    with pytest.raises(MXNetError, match="without CUDA"):
        cpp_package.build("cuda")
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    with pytest.raises(MXNetError, match="nvcc"):
        cpp_package.build("cuda")


class _ThreeLMs(tmx.gluon.HybridBlock):
    """A tiny word LM in each fused mode over one embedding: three
    2-layer RNNs of hidden 16, each with its decoder."""

    def __init__(self):
        super().__init__()
        with self.name_scope():
            self.emb = tmx.gluon.nn.Embedding(VOCAB, 8)
            self.rnns = [tmx.gluon.rnn.LSTM(HIDDEN, num_layers=LAYERS),
                         tmx.gluon.rnn.RNN(HIDDEN, num_layers=LAYERS,
                                           activation="tanh"),
                         tmx.gluon.rnn.RNN(HIDDEN, num_layers=LAYERS,
                                           activation="relu")]
            self.decs = [tmx.gluon.nn.Dense(VOCAB, flatten=False)
                         for _ in MODES]
            for i, (r, d) in enumerate(zip(self.rnns, self.decs)):
                self.register_child(r, "rnn%d" % i)
                self.register_child(d, "dec%d" % i)

    def forward(self, x):
        e = self.emb(x)
        return tuple(d(r(e)) for r, d in zip(self.rnns, self.decs))


@pytest.fixture(scope="module")
def lms(tree, tmp_path_factory):
    """The three word LMs exported with MXNET_FUSED_RNN=1 and compiled for
    the CPU, run once by mxtpu_predict --verbose: (the replay's outputs,
    the C++ outputs, mxtpu_predict's stdout, the graph's rnn_fwd nodes)."""
    d = tmp_path_factory.mktemp("lms")
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    try:
        with tmx.cpu():
            tmx.random.seed(25)
            with tmx.name.NameManager():
                net = _ThreeLMs()
            net.initialize(tmx.init.Xavier())
            x = np.random.RandomState(1).randint(0, VOCAB, (T, N)).astype(
                np.float32)
            net(tmx.nd.array(x))
            art = str(d / "lms.mxtpu")
            port_pred.export_model(net, [("data", (T, N))], art)
            port_pred.compile_for_cpp(art, ctx=tmx.cpu())
            served = port_pred.load_exported(art, ctx=tmx.cpu())
            want = [o.asnumpy() for o in served.forward(data=x)]
            nodes = sum(1 for n in served.program.graph.nodes
                        if n.target is torch.ops.mxnet_tpu_torch.rnn_fwd
                        .default)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior
    x.tofile(d / "x.bin")
    p = _run([tree.mxtpu_predict, art, "--device", "cpu", "--input",
              "0=%s" % (d / "x.bin"), "--output-dir", str(d), "--verbose"])
    got = [np.fromfile(d / ("out%d.bin" % i), np.float32).reshape(w.shape)
           for i, w in enumerate(want)]
    return want, got, p.stdout, nodes


@pytest.mark.parametrize("mode", MODES)
def test_word_lm_through_the_cpp_op(lms, mode):
    """Each mode's logits through the C++ op's CPU scan against the Python
    replay (the port's plain scan) within 1e-5; the op is called once a
    layer of each LM and launches no kernel on the CPU."""
    want, got, stdout, nodes = lms
    i = MODES.index(mode)
    assert nodes == LAYERS * len(MODES)
    assert _rel(got[i], want[i]) <= _REL
    assert cs.cpp_counts(stdout) == (LAYERS * len(MODES), 0)


#: a fresh process that imports torch and not the port: the C++ op loaded
#: by torch.ops.load_library, run on the inputs of each .npz given (mode,
#: reverse and the tensors), its four outputs saved beside it
_OP_CALL = r"""
import sys, numpy as np, torch
torch.ops.load_library(sys.argv[1])
for path in sys.argv[2:]:
    a = np.load(path)
    mode, rev = str(a["mode"]), bool(a["reverse"])
    t = {k: torch.from_numpy(a[k]) for k in ("px", "h0", "c0", "wh")}
    out = torch.ops.mxnet_tpu_torch.rnn_fwd(
        mode, t["px"], t["h0"], t["c0"] if mode == "lstm" else None,
        t["wh"], rev)
    np.savez(path + ".out.npz", *[o.numpy() for o in out])
print(sorted(m for m in sys.modules if m.startswith("mxnet")))
"""
SCAN_CASES = [(m, r) for m in MODES for r in (False, True)]


def _scan_inputs(mode):
    return fused_rnn.check_inputs(mode, 5, 3, 8, torch.float32, seed=7,
                                  device="cpu")


@pytest.fixture(scope="module")
def scans(tree, tmp_path_factory):
    """Every (mode, reverse) case through the C++ op in one fresh process:
    {case: its four outputs}."""
    d = tmp_path_factory.mktemp("scan")
    paths = []
    for mode, reverse in SCAN_CASES:
        a = _scan_inputs(mode)
        paths.append(str(d / ("%s_%d.npz" % (mode, reverse))))
        np.savez(paths[-1], mode=mode, reverse=reverse,
                 **{k: a[k].numpy() for k in ("px", "h0", "c0", "wh")})
    p = _run([sys.executable, "-c", _OP_CALL, tree.ops_lib] + paths)
    assert p.stdout.strip() == "[]"
    return {case: np.load(path + ".out.npz")
            for case, path in zip(SCAN_CASES, paths)}


@pytest.mark.parametrize("mode,reverse", SCAN_CASES)
def test_cpp_scan_equals_the_plain_version(scans, mode, reverse):
    """The C++ op's CPU scan is `fused_rnn.rnn_fwd_plain` op for op: the
    same bits for ys, cs, hT, cT (cs and cT empty outside lstm)."""
    a = _scan_inputs(mode)
    got = scans[mode, reverse]
    want = fused_rnn.rnn_fwd_plain(mode, a["px"], a["h0"], a["c0"], a["wh"],
                                   reverse)
    for i, w in enumerate(want):
        g = got["arr_%d" % i]
        if w is None:
            assert g.shape == (0,)
        else:
            np.testing.assert_array_equal(g, w.numpy())


def test_lcg_batch_is_mxtpu_trains():
    """`lcg_batch` is the reference's LCG (train_cli.cc): its first draws
    at step 1, recomputed here from the constants."""
    s = (1 * 6364136223846793005 + 1) % 2 ** 64
    draws = []
    for _ in range(6):
        s = (s * 6364136223846793005 + 1442695040888963407) % 2 ** 64
        draws.append(s >> 33)
    x, y = cpp_package.lcg_batch(1, (2, 2), (2,), "int32", 7)
    want_x = np.float32(np.array(draws[:4], np.float64)) / np.float32(
        2147483648.0) - np.float32(1.0)
    np.testing.assert_array_equal(x.ravel(), want_x)
    np.testing.assert_array_equal(y, np.array(draws[4:]) % 7)
    assert x.dtype == np.float32 and y.dtype == np.int32
