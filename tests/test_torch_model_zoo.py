"""Port parity for the model zoo's families (mxnet_tpu_torch/gluon/
model_zoo/vision/: AlexNet, VGG, SqueezeNet, DenseNet, MobileNet V1/V2,
Inception V3, and the ResNets) against the JAX reference on the CPU.

- The registry: all 34 names build, under the reference's dotted keys,
  and each net's `collect_params()` names equal the reference's, in
  order (constructed, not run).
- Forwards at the sizes of the reference's test_gluon.py:336-351
  (Inception V3 at 299, batch 1): the same seeded numpy weights in both
  packages (the reference's set before its first call, the port's through
  `gluon_params_from_numpy`), BatchNorm at inference on seeded moving
  statistics; the reference's forward is its hybridized (jit) one, whose
  first call compiles once instead of once an op. Logits within 1e-5 of
  the largest. (densenet121 at 64 reaches its 7x7 average pool with a
  2x2 map; both packages give an empty pool and logits equal to the
  bias.)
- `pretrained=True` through model_store: the reference's message without
  the file, a local file, a file:// repository (gluon.utils.download and
  check_sha1), and an http(s) repository refused.
"""
import os

import numpy as np
import pytest

import jax

import mxnet_tpu as mx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.models import gluon_params_from_numpy

_REL = 1e-5


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _key_scope():
    return mx.random.trace_key_scope(jax.random.PRNGKey(0))


NAMES = sorted(mx.gluon.model_zoo.vision._models)


def test_registry_has_the_reference_names():
    assert sorted(tmx.gluon.model_zoo.vision._models) == NAMES
    assert len(NAMES) == 34
    with pytest.raises(ValueError, match="not supported"):
        tmx.gluon.model_zoo.vision.get_model("mobilenet0_25")
    assert isinstance(tmx.gluon.model_zoo.get_model("SqueezeNet1.1"),
                      tmx.gluon.model_zoo.vision.SqueezeNet)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_names_match_reference(name):
    with mx.name.NameManager():
        ref = mx.gluon.model_zoo.vision.get_model(name)
    with tmx.name.NameManager():
        port = tmx.gluon.model_zoo.vision.get_model(name)
    names = list(port.collect_params())
    assert names == list(ref.collect_params())
    prefix = {"inceptionv3": "inception30_", "alexnet": "alexnet0_"}
    assert names[0].startswith(prefix.get(name, ""))
    if name.startswith("densenet"):
        assert any("_stage1_" in n for n in names)


def _seeded_arrays(port, seed=0):
    """{name: array} of the port net's shapes: weights ~ N(0, 2 / fan_in),
    biases and betas small, gammas near 1, moving means small and moving
    variances near 1."""
    rng = np.random.RandomState(seed)
    out = {}
    for n, p in port.collect_params().items():
        shape = p.data().shape
        if n.endswith("_weight"):
            fan_in = int(np.prod(shape[1:])) or 1
            v = rng.randn(*shape) * np.sqrt(2.0 / fan_in)
        elif n.endswith(("_gamma", "_running_var")):
            v = 1.0 + 0.2 * np.abs(rng.randn(*shape))
        else:
            v = 0.1 * rng.randn(*shape)
        out[n] = v.astype(np.float32)
    return out


def _twin(make, size, seed=0):
    """(reference net, port net, arrays): the port's net materialized by a
    zeros forward, seeded arrays for its shapes, set on the reference
    before its first call and carried to the port by name."""
    with tmx.name.NameManager():
        port = make(tmx)
    port.initialize(tmx.init.Xavier())
    port(tmx.nd.zeros((1, 3, size, size)))
    arrays = _seeded_arrays(port, seed)
    with mx.name.NameManager():
        ref = make(mx)
    params = ref.collect_params()
    assert list(params) == list(port.collect_params())
    for n, p in params.items():
        p.set_data(mx.nd.array(arrays[n]))
    gluon_params_from_numpy(port, arrays)
    return ref, port, arrays


FORWARDS = [("alexnet", 224), ("densenet121", 64), ("inceptionv3", 299),
            ("mobilenet0.25", 32), ("mobilenetv2_0.25", 32),
            ("resnet18_v1", 32), ("resnet18_v2", 32), ("squeezenet1.0", 64),
            ("squeezenet1.1", 64), ("vgg11", 32), ("vgg11_bn", 32)]


@pytest.mark.parametrize("name,size", FORWARDS)
def test_forward_matches_reference(name, size):
    def make(pkg):
        return pkg.gluon.model_zoo.vision.get_model(name, classes=10)
    ref, port, _ = _twin(make, size)
    x = np.random.RandomState(1).uniform(-1, 1, (1, 3, size, size)).astype(
        np.float32)
    ref.hybridize()
    with _key_scope():
        want = ref(mx.nd.array(x)).asnumpy()
    got = port(tmx.nd.array(x)).asnumpy()
    assert got.shape == want.shape == (1, 10)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=_REL * float(np.abs(want).max()))


def test_pretrained_through_model_store(tmp_path, monkeypatch):
    from mxnet_tpu_torch.gluon.model_zoo import model_store
    vision = tmx.gluon.model_zoo.vision
    monkeypatch.delenv("MXNET_GLUON_REPO", raising=False)
    root = str(tmp_path / "models")
    with pytest.raises(IOError, match="squeezenet1.1.params not found"):
        vision.squeezenet1_1(pretrained=True, root=root)
    with tmx.name.NameManager():
        src = vision.squeezenet1_1(classes=10)
    src.initialize(tmx.init.Xavier())
    x = tmx.nd.array(np.random.RandomState(2).uniform(
        -1, 1, (1, 3, 64, 64)).astype(np.float32))
    want = src(x).asnumpy()
    repo = tmp_path / "repo"
    repo.mkdir()
    src.save_params(str(repo / "squeezenet1.1.params"))
    # a local directory named by MXNET_GLUON_REPO
    monkeypatch.setenv("MXNET_GLUON_REPO", str(repo))
    with tmx.name.NameManager():
        net = vision.get_model("squeezenet1.1", classes=10, pretrained=True,
                               root=root)
    np.testing.assert_array_equal(net(x).asnumpy(), want)
    # a file:// repository: copied into root
    monkeypatch.setenv("MXNET_GLUON_REPO", "file://" + str(repo))
    path = model_store.get_model_file("squeezenet1.1", root=root)
    assert path == os.path.join(root, "squeezenet1.1.params")
    with open(path, "rb") as f, open(repo / "squeezenet1.1.params",
                                     "rb") as g:
        assert f.read() == g.read()
    monkeypatch.setenv("MXNET_GLUON_REPO", "https://example.invalid/m")
    with pytest.raises(IOError, match="file:// repository only"):
        model_store.get_model_file("alexnet", root=root)
    model_store.purge(root)
    assert not os.listdir(root)
    with pytest.raises(ValueError):
        model_store.short_hash("alexnet")


def test_download_and_check_sha1(tmp_path):
    import hashlib
    from mxnet_tpu_torch.gluon.utils import check_sha1, download
    src = tmp_path / "src.bin"
    src.write_bytes(b"model bytes" * 1000)
    digest = hashlib.sha1(src.read_bytes()).hexdigest()
    assert check_sha1(str(src), digest)
    assert not check_sha1(str(src), "0" * 40)
    out = download("file://" + str(src), path=str(tmp_path / "dl"),
                   sha1_hash=digest)
    assert out == str(tmp_path / "dl")
    assert check_sha1(out, digest)
    # a directory takes the URL's last component; an existing good file
    # is kept
    d = tmp_path / "dir"
    d.mkdir()
    out2 = download("file://" + str(src), path=str(d))
    assert out2 == str(d / "src.bin")
    assert download("file://" + str(src), path=str(d)) == out2
    with pytest.raises(IOError, match="failed after 2 attempts"):
        download("file://" + str(src), path=str(tmp_path / "bad"),
                 sha1_hash="0" * 40, retries=2)
    assert not os.path.exists(tmp_path / "bad")
    with pytest.raises(IOError):
        download("file://" + str(tmp_path / "missing"),
                 path=str(tmp_path / "m"), retries=1)
