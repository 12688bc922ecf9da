"""The port's CheckpointManager (mxnet_tpu_torch/utils/recovery.py) held to
the reference's (mxnet_tpu/utils/recovery.py): the same behaviours
(round trip, retention, async publication, torn-file and corrupt-manifest
fallback, publish retries, the kill during a save), and one on-disk
format, so a checkpoint written by either package restores bit-equal in
the other, sharded ones included."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu.utils import chaos as jchaos
from mxnet_tpu.utils.recovery import CheckpointManager as RefManager

from mxnet_tpu_torch.utils import chaos
from mxnet_tpu_torch.utils.recovery import CheckpointManager

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True)
def _chaos_clean():
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


def _tree():
    rng = np.random.RandomState(0)
    return {"t": np.int64(7),
            "params": (rng.randn(6).astype(np.float32),
                       rng.randn(2, 3).astype(np.float32)),
            "nested": {"a": [np.zeros(2), np.full(3, 5.0)],
                       "ids": np.arange(4, dtype=np.int32)},
            "empty_t": (), "empty_l": [], "empty_d": {}}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_tree_equal(a, b)
    else:
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_save_restore_round_trip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    tree = _tree()
    mgr.save(7, tree)
    step, out = mgr.restore_latest()
    assert step == 7
    _assert_tree_equal(out, tree)


def test_torch_leaves_are_host_copies(tmp_path):
    """Tensor leaves are copied to host memory inside save(): a later
    in-place update cannot reach the checkpoint; bfloat16 comes back as
    float32."""
    w = torch.arange(6, dtype=torch.float32)
    b = torch.ones(3, dtype=torch.bfloat16)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(1, {"w": w, "b": b,
                 "gens": {"cpu": np.arange(3, dtype=np.uint8)}})
    w.add_(100.0)                     # the next step, in place
    mgr.wait()
    _, out = mgr.restore_latest()
    np.testing.assert_array_equal(out["w"], np.arange(6, dtype=np.float32))
    assert out["b"].dtype == np.float32 and (out["b"] == 1).all()
    np.testing.assert_array_equal(out["gens"]["cpu"], np.arange(3))


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": np.full(4, float(s))})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    assert mgr.restore_latest()[1]["x"][0] == 4.0


def test_async_save_publishes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"x": np.ones(128)})
    mgr.wait()
    assert mgr.all_steps() == [1]
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]
    rec = list(mgr.save_log)[-1]
    assert rec["step"] == 1 and rec["copy_s"] >= 0 and rec["write_s"] > 0


def test_torn_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(1, {"x": np.full(3, 1.0)})
    mgr.save(2, {"x": np.full(3, 2.0)})
    with open(tmp_path / "ckpt-2.npz", "r+b") as f:
        f.truncate(10)
    with pytest.warns(UserWarning, match="corrupt"):
        step, out = mgr.restore_latest()
    assert step == 1 and out["x"][0] == 1.0


@pytest.mark.parametrize("damage", ["manifest_json", "checksum"])
def test_corrupt_manifest_or_checksum_falls_back(tmp_path, damage):
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(1, {"x": np.full(8, 1.0)})
    mgr.save(2, {"x": np.full(8, 2.0)})
    if damage == "manifest_json":
        (tmp_path / "ckpt-2.manifest.json").write_text("{not json")
    else:
        # a same-size flip only the sha256 catches
        blob = bytearray((tmp_path / "ckpt-2.npz").read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        (tmp_path / "ckpt-2.npz").write_bytes(bytes(blob))
    with pytest.warns(UserWarning):
        step, out = mgr.restore_latest()
    assert step == 1 and out["x"][0] == 1.0


def test_missing_manifest_tolerated(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(3, {"x": np.ones(2)})
    os.remove(tmp_path / "ckpt-3.manifest.json")
    assert mgr.restore_latest()[0] == 3


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_format_interop(tmp_path, writer):
    """A checkpoint written by one package restores bit-equal in the
    other, and both write the same manifest (but for the sha256, which
    covers the zip's timestamps)."""
    tree = _tree()
    a, b = tmp_path / "ref", tmp_path / "port"
    RefManager(str(a), keep=3, async_save=False).save(7, tree)
    CheckpointManager(str(b), keep=3, async_save=False).save(7, tree)
    src = a if writer == "reference" else b
    reader = (CheckpointManager if writer == "reference" else RefManager)(
        str(src), process_count=1)
    step, out = reader.restore_latest()
    assert step == 7
    _assert_tree_equal(out, tree)
    ma = json.load(open(a / "ckpt-7.manifest.json"))
    mb = json.load(open(b / "ckpt-7.manifest.json"))
    assert sorted(ma) == sorted(mb)
    for k in ("step", "file", "size", "arrays"):
        assert ma[k] == mb[k], k
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


def _ref_mesh_tree(n=4):
    """The reference's ZeRO-shaped state on the 8-device virtual mesh: a
    replicated weight, a dp-sharded moment, host scalars."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from mxnet_tpu.parallel.mesh import build_mesh
    mesh = build_mesh({"dp": n}, jax.devices()[:n])
    w = jax.device_put(np.arange(32, dtype=np.float32).reshape(8, 4),
                       NamedSharding(mesh, P()))
    m = jax.device_put(np.arange(64, dtype=np.float32).reshape(16, 4),
                       NamedSharding(mesh, P("dp")))
    return {"w": w, "opt": (m, np.int64(7)), "t": np.int64(5)}


def test_reference_sharded_checkpoint_restores_in_the_port(tmp_path):
    """Two emulated hosts of the reference write a sharded step from the
    virtual mesh; the port reassembles the same global arrays."""
    tree = _ref_mesh_tree()
    for i in range(2):
        RefManager(str(tmp_path), keep=5, sharded=True, process_index=i,
                   process_count=2).save(5, tree, block=True)
    g = json.load(open(tmp_path / "ckpt-5.manifest.json"))
    assert g["format"] == "sharded" and g["arrays"]["opt/__t__0"][
        "shards"] == 4
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.global_manifest(5) == g
    step, got = mgr.restore_latest()
    assert step == 5
    np.testing.assert_array_equal(got["w"], np.asarray(tree["w"]))
    np.testing.assert_array_equal(got["opt"][0], np.asarray(tree["opt"][0]))
    assert int(got["opt"][1]) == 7 and int(got["t"]) == 5
    assert mgr.intact_steps() == [5]
    # and an incomplete reference step is refused by the port
    RefManager(str(tmp_path), keep=5, sharded=True, process_index=0,
               process_count=2).save(8, tree, block=True)
    with pytest.warns(UserWarning, match="incomplete"):
        assert CheckpointManager(str(tmp_path)).restore_latest()[0] == 5


def test_emulated_sharded_save_is_read_by_the_reference(tmp_path):
    """The port's emulated pod (process_index / process_count set) writes
    per-host files the reference reads back into the same tree."""
    tree = {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "m": (np.ones(5, np.float32), np.int64(3)), "t": np.int64(9)}
    for i in range(3):
        CheckpointManager(str(tmp_path), keep=5, sharded=True,
                          process_index=i, process_count=3,
                          async_save=False).save(9, tree)
    names = sorted(os.listdir(tmp_path))
    assert "ckpt-9.shard2of3.npz" in names and "ckpt-9.manifest.json" in names
    step, got = RefManager(str(tmp_path), process_count=1).restore_latest()
    assert step == 9
    _assert_tree_equal(got, tree)


def test_writer_prune_spares_a_slower_hosts_write_in_flight(tmp_path):
    """Hosts of an emulated pod run at their own pace: the writer (host 0)
    prunes a step that host 1 is still writing. It removes the step's
    published files of every host but not host 1's temp file, so host
    1's write can finish."""
    tree = {"w": np.arange(6, dtype=np.float32)}
    host0 = CheckpointManager(str(tmp_path), keep=2, sharded=True,
                              process_index=0, process_count=2,
                              async_save=False)
    host0.save(1, tree)
    inflight = tmp_path / "ckpt-1.shard1of2.npz.tmp-4242"
    inflight.write_bytes(b"half a shard")
    for step in (2, 3):
        host0.save(step, tree)
    names = sorted(os.listdir(tmp_path))
    assert not [n for n in names if n.startswith("ckpt-1.") and
                ".tmp-" not in n]
    assert inflight.exists()


def test_demote_and_step_files(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(1, {"x": np.ones(2)})
    mgr.save(2, {"x": np.ones(2)})
    files = [os.path.basename(p) for p in mgr.step_files(2)]
    assert files == ["ckpt-2.manifest.json", "ckpt-2.npz"]
    assert len(mgr.demote(2, reason="test")) == 2
    assert mgr.all_steps() == [1]
    assert os.path.exists(tmp_path / "ckpt-2.npz.corrupt")


def test_publish_retry_survives_transient_io(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = os.replace

    def flaky(a, b):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient fs hiccup")
        return real(a, b)

    monkeypatch.setattr(os, "replace", flaky)
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(3, {"x": np.ones(4, np.float32)})
    assert calls["n"] >= 2
    assert mgr.restore_latest()[0] == 3


def test_publish_retry_exhaustion_surfaces_on_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    seen = []
    mgr.on_error = seen.append

    def down(a, b):
        raise OSError("filesystem down")

    monkeypatch.setattr(os, "replace", down)
    mgr.save(3, {"x": np.ones(4, np.float32)})
    with pytest.raises(OSError):
        mgr.wait(_barrier=False)
    assert len(seen) == 1 and isinstance(seen[0], OSError)


def test_kill_during_save_leaves_latest_intact(tmp_path):
    """MXNET_CHAOS_KILL_SAVE hard-exits (43) between the temp file and the
    publish; the previous step stays the restorable one and no torn temp
    file shadows it."""
    code = (
        "import numpy as np\n"
        "from mxnet_tpu_torch.utils.recovery import CheckpointManager\n"
        "m = CheckpointManager(%r, keep=5, async_save=True)\n"
        "m.save(1, {'x': np.full(64, 1.0)}); m.wait()\n"
        "m.save(2, {'x': np.full(64, 2.0)}); m.wait()\n" % str(tmp_path))
    env = dict(os.environ, MXNET_CHAOS_KILL_SAVE="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 43, proc.stderr[-2000:]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [1]
    step, out = mgr.restore_latest()
    assert step == 1 and out["x"][0] == 1.0
