"""The port's AOT cache (mxnet_tpu_torch/aot) against the reference's
contract (tests/test_aot.py), on the CPU.

Mirrors the reference's cases for the key (any input change misses),
the fingerprint, store / load with first-writer-wins, concurrent writers,
truncated and bit-flipped entries, and `configure`; the reference's own
AOTCache reads the port's entries (the same layout). The end-to-end case
compiles a small MLP's artifact for the CPU twice through one cache: the
second `compile_for_cpp` runs no AOTInductor compile, its package bytes
equal the first's, and `mxtpu_predict` gives bit-equal outputs; a
corrupted entry is quarantined and compiled again, never raised. The
kernel-library route (`ops/_cuda.library`) needs nvcc and runs on the
card (tests/test_torch_cuda.py); here its seam `aot.fetch` is driven
with a stand-in build.
"""
import os
import pickle
import shutil
import subprocess
import threading

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import aot, cpp_package, telemetry
from mxnet_tpu_torch import predict as port_pred
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.telemetry import introspect


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Own watchdog + registry per test, and the process-wide cache back
    under env control afterwards: a leaked override would warm every
    later test of this process."""
    monkeypatch.delenv("MXNET_AOT_CACHE_DIR", raising=False)
    introspect.reset()
    telemetry.default_registry().reset()
    aot.configure()
    with tmx.cpu():
        yield
    aot.configure()
    introspect.reset()
    telemetry.default_registry().reset()


# ---------------------------------------------------------------------------
# key anatomy: any input change is a different key
# ---------------------------------------------------------------------------


def test_key_for_content_sensitivity(monkeypatch):
    sig = (("tokens", "i64[2,8]"),)
    base = aot.key_for("kernels.fused_rnn", sig, b"source",
                       variant="library", placement=("sm_90a",))
    assert base == aot.key_for("kernels.fused_rnn", sig, b"source",
                               variant="library", placement=("sm_90a",))
    others = [
        aot.key_for("kernels.paged_attention", sig, b"source",
                    variant="library", placement=("sm_90a",)),
        aot.key_for("kernels.fused_rnn", (("tokens", "i64[4,8]"),),
                    b"source", variant="library", placement=("sm_90a",)),
        aot.key_for("kernels.fused_rnn", sig, b"source changed",
                    variant="library", placement=("sm_90a",)),
        aot.key_for("kernels.fused_rnn", sig, b"source", variant="aoti",
                    placement=("sm_90a",)),
        aot.key_for("kernels.fused_rnn", sig, b"source",
                    variant="library", placement=("cuda:1",)),
    ]
    assert len(set(others) | {base}) == len(others) + 1
    assert aot.key_for("kernels.fused_rnn", sig, "source",
                       variant="library", placement=("sm_90a",)) == base
    # what nvcc or Inductor is asked to build is in the fingerprint
    monkeypatch.setenv("TORCHINDUCTOR_MAX_AUTOTUNE", "1")
    assert aot.key_for("kernels.fused_rnn", sig, b"source",
                       variant="library", placement=("sm_90a",)) != base
    monkeypatch.delenv("TORCHINDUCTOR_MAX_AUTOTUNE")
    # a kernel switch picks which kernel runs, not what is built
    monkeypatch.setenv("MXNET_FUSED_RNN", "1")
    assert aot.key_for("kernels.fused_rnn", sig, b"source",
                       variant="library", placement=("sm_90a",)) == base


def test_fingerprint_names_versions_and_topology():
    fp = aot.fingerprint()
    for field in ("torch", "cuda", "framework", "nvcc", "cxx",
                  "nvcc_flags", "platform", "device_kind", "capability",
                  "device_count", "env"):
        assert field in fp, fp
    assert fp["platform"] == "cpu" and fp["nvcc"] is None
    assert "sm_90a" in fp["nvcc_flags"] and "CXX" in fp["env"]


def test_placement_key():
    import torch
    assert aot.placement_key(("cpu",)) == ("cpu",)
    assert aot.placement_key([torch.ones(2), {"a": torch.zeros(1)}]) == \
        ("cpu",)
    assert aot.placement_key(()) == ("cpu",)


def test_program_digest_ignores_the_serialization_id(tmp_path):
    import zipfile
    net = tmx.gluon.nn.Dense(3, in_units=4)
    net.initialize()
    net(tmx.nd.ones((2, 4)))
    a, b = str(tmp_path / "a.mxtpu"), str(tmp_path / "b.mxtpu")
    port_pred.export_model(net, [("data", (2, 4))], a)
    port_pred.export_model(net, [("data", (2, 4))], b)
    blobs = [zipfile.ZipFile(p).read("model.pt2") for p in (a, b)]
    assert aot.program_digest(blobs[0]) == aot.program_digest(blobs[1])
    net.weight.set_data(net.weight.data() + 1)
    c = str(tmp_path / "c.mxtpu")
    port_pred.export_model(net, [("data", (2, 4))], c)
    assert aot.program_digest(zipfile.ZipFile(c).read("model.pt2")) != \
        aot.program_digest(blobs[0])


# ---------------------------------------------------------------------------
# entry store/load/verify
# ---------------------------------------------------------------------------


def test_store_load_roundtrip_first_wins(tmp_path):
    cache = aot.AOTCache(tmp_path)
    payload, trees = aot.serialize_executable_blob(b"\x01" * 64, "aoti",
                                                   "model.pt2")
    assert cache.store("predict_compile_for_cpp", "k" * 40, payload, trees,
                       extra={"variant": "aoti"})
    assert not cache.store("predict_compile_for_cpp", "k" * 40, b"other",
                           trees)
    got, kind, name, meta = cache.load("predict_compile_for_cpp", "k" * 40)
    assert got == payload and (kind, name) == ("aoti", "model.pt2")
    assert meta["variant"] == "aoti" and meta["payload_sha256"]
    assert cache.load("predict_compile_for_cpp", "x" * 40) is None
    assert cache.entries() and cache.entries()[0].endswith(".mxaot")
    with pytest.raises(MXNetError, match="unknown AOT entry kind"):
        aot.serialize_executable_blob(b"", "xla", "m")


def test_reference_reads_the_port_entry_layout(tmp_path):
    """The same zip layout and digests: the reference's AOTCache verifies
    and loads an entry the port wrote."""
    from mxnet_tpu import aot as ref_aot
    cache = aot.AOTCache(tmp_path)
    payload, trees = aot.serialize_executable_blob(b"\x05" * 32, "library",
                                                   "fused_rnn.cu")
    cache.store("kernels_fused_rnn", "e" * 40, payload, trees)
    ref = ref_aot.AOTCache(tmp_path)
    assert ref.verify() == cache.verify()
    got, kind, name, _ = ref.load("kernels_fused_rnn", "e" * 40)
    assert got == payload and (kind, name) == ("library", "fused_rnn.cu")


def test_concurrent_writers_publish_one_entry(tmp_path):
    cache = aot.AOTCache(tmp_path)
    trees = pickle.dumps(("aoti", "model.pt2"))
    wins, errs = [], []

    def writer(i):
        try:
            wins.append(cache.store("train_step", "r" * 40,
                                    b"payload-%d" % i, trees))
        except Exception as e:                      # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=writer, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert sum(1 for w in wins if w) >= 1
    assert len(cache.entries()) == 1
    ok, bad = cache.verify()
    assert len(ok) == 1 and not bad


def test_truncated_entry_quarantined(tmp_path):
    cache = aot.AOTCache(tmp_path)
    trees = pickle.dumps(("aoti", "model.pt2"))
    cache.store("serving_prefill", "t" * 40, b"\x02" * 256, trees)
    path = os.path.join(cache.path, cache.entries()[0])
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(aot.CorruptEntry):
        cache.load("serving_prefill", "t" * 40)
    assert not cache.entries()
    assert cache.load("serving_prefill", "t" * 40) is None


def test_bitflipped_entry_fails_sha256(tmp_path):
    cache = aot.AOTCache(tmp_path)
    trees = pickle.dumps(("aoti", "model.pt2"))
    cache.store("serving_decode", "b" * 40, b"\x03" * 512, trees)
    path = os.path.join(cache.path, cache.entries()[0])
    blob = bytearray(open(path, "rb").read())
    idx = blob.find(b"\x03\x03\x03\x03")
    assert idx > 0
    blob[idx] ^= 0x40
    open(path, "wb").write(bytes(blob))
    ok, bad = cache.verify()
    assert bad and not ok
    with pytest.raises(aot.CorruptEntry):
        cache.load("serving_decode", "b" * 40)


def test_configure_and_cache_dir(tmp_path, monkeypatch):
    aot.configure(str(tmp_path))
    assert aot.cache_dir() == str(tmp_path)
    assert aot.cache().path == str(tmp_path)
    aot.configure(None)
    assert aot.cache_dir() is None and aot.cache() is None
    monkeypatch.setenv("MXNET_AOT_CACHE_DIR", str(tmp_path))
    aot.configure()                       # back under env control
    assert aot.cache_dir() == str(tmp_path)


def test_atomic_publish_is_the_utils_one():
    from mxnet_tpu_torch import utils
    assert aot.atomic_publish is utils.atomic_publish


# ---------------------------------------------------------------------------
# the load-or-build seam
# ---------------------------------------------------------------------------


def _fetch(key, built):
    def build():
        with introspect.compile_region("kernels.probe", phase="build"):
            built.append(1)
        return b"\x7fELF-like payload"
    return aot.fetch("kernels.probe", key, "library", "probe.cu", build)


def test_fetch_builds_once_then_warm_loads(tmp_path):
    built = []
    assert _fetch("f" * 40, built) == (b"\x7fELF-like payload", False)
    aot.configure(str(tmp_path))
    mark, wmark = introspect.dispatch_mark(), introspect.dispatch_warm_mark()
    assert _fetch("f" * 40, built) == (b"\x7fELF-like payload", False)
    assert _fetch("f" * 40, built) == (b"\x7fELF-like payload", True)
    assert len(built) == 2
    assert introspect.dispatch_compiles_since(mark) == 1
    assert introspect.dispatch_warm_loads_since(wmark) == 1
    site = introspect.watchdog().site("kernels.probe")
    assert site.compiles == 2 and site.cache_hits == 1
    reg = telemetry.default_registry()
    assert reg.counter("compile_cache_stores").value == 1
    assert reg.counter("compile_cache_misses").value == 1
    # a stored payload its loader refuses is quarantined and built again
    seen = []

    def load(payload):
        seen.append(payload)
        if len(seen) == 1:
            raise OSError("cannot load")
        return payload

    assert aot.fetch("kernels.probe", "f" * 40, "library", "probe.cu",
                     lambda: b"rebuilt", load=load) == (b"rebuilt", False)
    assert seen == [b"\x7fELF-like payload", b"rebuilt"]
    assert reg.counter("compile_cache_corrupt_total").value == 1
    assert _fetch("f" * 40, built) == (b"rebuilt", True)


def test_engine_aot_cache_configures_the_process(tmp_path):
    from test_torch_introspect import tiny_lm
    from mxnet_tpu_torch import serving
    params, cfg = tiny_lm()
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=2,
                         block_size=8, device="cpu",
                         aot_cache=str(tmp_path))
    assert eng.aot_cache == str(tmp_path) == aot.cache_dir()
    with pytest.raises(MXNetError, match="fixed at construction"):
        eng.aot_cache = None
    seq = eng.start([1, 2, 3], max_new=2)
    while not seq.done:
        eng.decode_step([seq])
    assert eng.warm_loads == eng.prefill_warm_loads == 0


# ---------------------------------------------------------------------------
# the acceptance gate: a second compile_for_cpp loads, bit-equal
# ---------------------------------------------------------------------------


def _mlp_artifact(tmp_path, name):
    net = tmx.gluon.nn.HybridSequential()
    with tmx.name.NameManager():
        net.add(tmx.gluon.nn.Dense(5, in_units=7, activation="relu"))
        net.add(tmx.gluon.nn.Dense(4, in_units=5))
    tmx.random.seed(3)
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.zeros((3, 7)))
    art = str(tmp_path / name)
    port_pred.export_model(net, [("data", (3, 7))], art)
    return art


def _package(art):
    import zipfile
    with zipfile.ZipFile(art) as z:
        return z.read("aoti/cpu.pt2")


def _predict(tree, art, tmp_path, tag):
    x = np.random.RandomState(0).randn(3, 7).astype(np.float32)
    out = tmp_path / tag
    out.mkdir()
    x.tofile(out / "x.bin")
    p = subprocess.run([tree.mxtpu_predict, art, "--device", "cpu",
                        "--input", "0=%s" % (out / "x.bin"),
                        "--output-dir", str(out)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return np.fromfile(out / "out0.bin", np.float32)


def test_second_compile_for_cpp_loads_bit_equal(tmp_path):
    art = _mlp_artifact(tmp_path, "a.mxtpu")
    copy = str(tmp_path / "b.mxtpu")
    shutil.copy(art, copy)
    aot.configure(str(tmp_path / "cache"))
    site = "predict.compile_for_cpp"
    port_pred.compile_for_cpp(art, ctx=tmx.cpu())
    wd = introspect.watchdog()
    assert wd.site(site).compiles == 1 and wd.site(site).cache_hits == 0
    mark = introspect.dispatch_mark()
    port_pred.compile_for_cpp(copy, ctx=tmx.cpu())
    assert introspect.dispatch_compiles_since(mark) == 0
    assert wd.site(site).compiles == 1 and wd.site(site).cache_hits == 1
    assert _package(copy) == _package(art)
    tree = cpp_package.build("cpu")
    a = _predict(tree, art, tmp_path, "a")
    b = _predict(tree, copy, tmp_path, "b")
    assert a.shape == (12,) and np.array_equal(a, b)
    # a bit-flipped entry: quarantined and compiled again, never raised
    cache = aot.cache()
    name, = cache.entries()
    path = os.path.join(cache.path, name)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0x10
    open(path, "wb").write(bytes(blob))
    third = str(tmp_path / "c.mxtpu")
    shutil.copy(art, third)
    port_pred.compile_for_cpp(third, ctx=tmx.cpu())
    assert wd.site(site).compiles == 2
    assert telemetry.default_registry().counter(
        "compile_cache_corrupt_total").value == 1
    assert cache.verify() == ([name], [])
    assert np.array_equal(_predict(tree, third, tmp_path, "c"), a)
