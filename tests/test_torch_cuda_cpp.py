"""The C++ half's card tests (mxnet_tpu_torch/cpp_package/): K4a as the
C++ op on CUDA tensors, the C++ rnn_design against Python's, and a card
artifact without its AOTInductor package. A CUDA kernel has no CPU mode,
so every test here needs a GPU and skips here (marker `cuda`); on a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_cpp.py -q

(`--noconftest`: tests/conftest.py imports jax). This file imports
neither jax nor mxnet_tpu. The C++ libraries run in processes of their
own: the op's namespace is the one ops/fused_rnn.py registers here.
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


#: a fresh process that imports torch and not the port: the C++ op loaded
#: by torch.ops.load_library, run on CUDA tensors from an .npz, its
#: outputs and K4a's launches saved; a layer past the limit must raise
_CPP_OP_CUDA = r"""
import ctypes, json, sys, numpy as np, torch
torch.ops.load_library(sys.argv[1])
lib = ctypes.CDLL(sys.argv[1])
lib.mxtpu_rnn_fwd_launches.restype = ctypes.c_longlong
a = np.load(sys.argv[2])
mode, rev = str(a["mode"]), bool(a["reverse"])
t = {k: torch.from_numpy(a[k]).cuda() for k in ("px", "h0", "c0", "wh")}
op = torch.ops.mxnet_tpu_torch.rnn_fwd
out = op(mode, t["px"], t["h0"], t["c0"] if mode == "lstm" else None,
         t["wh"], rev)
np.savez(sys.argv[3], *[o.cpu().numpy() for o in out])
big = torch.zeros(2, 2, 1025, device="cuda")
try:
    op("rnn_tanh", big, torch.zeros(2, 1025, device="cuda"), None,
       torch.zeros(1025, 1025, device="cuda"), False)
    refused = None
except RuntimeError as e:
    refused = str(e).splitlines()[0]
print(json.dumps({"launches": lib.mxtpu_rnn_fwd_launches(),
                  "refused": refused}))
"""


@pytest.fixture(scope="module")
def cpp_tree():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from mxnet_tpu_torch import cpp_package
    return cpp_package.build("cuda")


@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh"])
def test_cpp_op_launches_k4a_as_python_does(dev, cpp_tree, tmp_path, mode):
    """The C++ op on CUDA tensors launches K4a once at the design Python
    picks (the same bits as `fused_rnn.rnn_fwd`), and a layer past K4a's
    limit raises there too."""
    import subprocess
    import sys
    from mxnet_tpu_torch.ops import fused_rnn as fr
    a = fr.check_inputs(mode, 9, 40, 200, torch.float32, seed=3, device=dev)
    np.savez(tmp_path / "in.npz", mode=mode, reverse=True,
             **{k: a[k].cpu().numpy() for k in ("px", "h0", "c0", "wh")})
    p = subprocess.run([sys.executable, "-c", _CPP_OP_CUDA, cpp_tree.ops_lib,
                        str(tmp_path / "in.npz"), str(tmp_path / "o.npz")],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["launches"] == 1
    assert res["refused"] and "H=1025" in res["refused"]
    want = fr.rnn_fwd(mode, a["px"], a["h0"], a["c0"] if mode == "lstm"
                      else None, a["wh"], True)
    got = np.load(tmp_path / "o.npz")
    for i, w in enumerate(want):
        g = got["arr_%d" % i]
        if w is None:
            assert g.shape == (0,)
        else:
            np.testing.assert_array_equal(g, w.cpu().numpy())


def test_cpp_rnn_design_matches_python(dev, cpp_tree):
    """The C++ rnn_design (asked in a process without torch) against
    `fused_rnn.rnn_design` at phase 30a's layers."""
    import subprocess
    import sys
    from mxnet_tpu_torch.ops import fused_rnn as fr
    cases = [(fr._MODE_CODE[m], N, H, fr._DTYPE_CODE[getattr(torch, d)])
             for m, N, H, d in cs.CPP_DESIGN_CASES]
    p = subprocess.run([sys.executable, "-c", cs.CPP_DESIGN_QUERY,
                        cpp_tree.ops_lib, json.dumps(cases)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.strip().splitlines()[-1])["designs"]
    for (m, N, H, d), cpp in zip(cs.CPP_DESIGN_CASES, got):
        py = fr.rnn_design(m, N, H, getattr(torch, d))
        assert [py.P, py.rows, py.blocks] == cpp, (m, N, H, d)


def test_cpp_card_artifact_without_package_raises(dev, cpp_tree, tmp_path):
    """No fallback: an artifact without aoti/cuda.pt2, asked for on the
    card, fails naming compile_for_cpp."""
    import subprocess
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import predict
    with mx.gpu(0):
        net = mx.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        art = str(tmp_path / "d.mxtpu")
        predict.export_model(net, [("data", (2, 4))], art)
    p = subprocess.run([cpp_tree.mxtpu_predict, art, "--device", "cuda:0"],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 1
    assert "aoti/cuda.pt2" in p.stderr and "compile_for_cpp" in p.stderr
