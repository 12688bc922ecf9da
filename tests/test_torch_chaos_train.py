"""The training half of the port's chaos module (mxnet_tpu_torch/utils/
chaos.py) and its drill (`python -m mxnet_tpu_torch.tools.chaos_train`):
env parsing equal to the reference's `_load_env`, every training fault
fired once through the port's code paths, the rollout faults refused, and
the orchestrator drill at a tiny width on the CPU. The full pod and
supervised drills are slow-tier, as the reference marks its own."""
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import Preempted, ResilientLoop, TrainStep
from mxnet_tpu_torch.utils import chaos
from mxnet_tpu_torch.utils.recovery import CheckpointManager

from mxnet_tpu.utils import chaos as jchaos

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

TRAIN_ENV = {"MXNET_CHAOS_KILL_SAVE": "4", "MXNET_CHAOS_CORRUPT_CKPT": "6",
             "MXNET_CHAOS_NAN_STEP": "3", "MXNET_CHAOS_SPIKE_STEP": "9",
             "MXNET_CHAOS_SIGTERM_AT": "12", "MXNET_CHAOS_SIGKILL_AT": "15",
             "MXNET_CHAOS_SLOW_HOST": "2:0.25:5",
             "MXNET_CHAOS_SDC_AT": "1:8"}


@pytest.fixture(autouse=True)
def _chaos_clean():
    chaos.reset()
    jchaos.reset()
    yield
    chaos.reset()
    jchaos.reset()


def test_training_env_parsing_matches_reference(monkeypatch):
    for k, v in TRAIN_ENV.items():
        monkeypatch.setenv(k, v)
    assert chaos.active() == jchaos.active()
    assert chaos.active()["slow_host"] == ("2", 0.25, 5)
    assert chaos.active()["sdc_at"] == ("1", 8)
    for name, bad in (("MXNET_CHAOS_NAN_STEP", "x"),
                      ("MXNET_CHAOS_SLOW_HOST", "2"),
                      ("MXNET_CHAOS_SDC_AT", "1:2:3")):
        chaos.reset()
        jchaos.reset()
        monkeypatch.setenv(name, bad)
        with pytest.raises(ValueError, match=name):
            chaos.active()
        with pytest.raises(ValueError, match=name):
            jchaos.active()
        monkeypatch.setenv(name, TRAIN_ENV[name])
    chaos.reset()
    assert chaos.configure(nan_step=5, slow_host=("0", 0.1)) == dict(
        chaos.active())
    keys = ("serve_rollout_slow_canary", "serve_rollout_corrupt")
    armed = [{k: c.configure(serve_rollout_slow_canary=(0, 1),
                             serve_rollout_corrupt="3:1")[k] for k in keys}
             for c in (chaos, jchaos)]
    assert armed[0] == armed[1] == {"serve_rollout_slow_canary": (0, 1),
                                    "serve_rollout_corrupt": (3, 1)}
    with pytest.raises(ValueError, match="unknown chaos fault"):
        chaos.configure(not_a_fault=1)


def _net():
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(8, in_units=4, activation="relu"))
        net.add(tmx.gluon.nn.Dense(3, in_units=8))
        net.initialize(tmx.init.Xavier())
    return net


def _batch(i):
    rng = np.random.RandomState(i)
    return (rng.randn(6, 4).astype(np.float32),
            rng.randint(0, 3, (6,)).astype(np.float32))


def test_gradient_poisons_nan_trips_guard_spike_does_not():
    net = _net()
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": 0.1}, guard=True)
    chaos.configure(nan_step=2, spike_step=3)
    step(*_batch(0))
    clean_norm = float(step.last_grad_norm)
    before = [p.data().asnumpy().copy() for p in
              net.collect_params().values()]
    step(*_batch(1))
    assert not bool(step.last_step_ok)
    assert np.isnan(float(step.last_grad_norm))
    for p, b in zip(net.collect_params().values(), before):
        np.testing.assert_array_equal(p.data().asnumpy(), b)
    step(*_batch(2))
    assert bool(step.last_step_ok)
    assert float(step.last_grad_norm) > 1e3 * clean_norm
    assert chaos.fired() == {"nan_step", "spike_step"}
    assert chaos.grad_poison(2) == 0.0 == chaos.grad_poison(3)  # latched


def test_slow_host_sdc_and_corrupt_fire_once(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_HOST_ID", "2")
    chaos.configure(slow_host=("2", 0.01, 3), sdc_at=("2", 4),
                    corrupt_ckpt=5)
    assert not chaos.maybe_slow_host(2)
    assert chaos.maybe_slow_host(3) and chaos.maybe_slow_host(4)
    assert not chaos.sdc_poison(3) and chaos.sdc_poison(6)
    assert not chaos.sdc_poison(8)                   # latched
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(5, {"x": np.ones(64)})
    with open(tmp_path / "ckpt-5.manifest.json") as f:
        size = __import__("json").load(f)["size"]
    assert os.path.getsize(tmp_path / "ckpt-5.npz") == size // 2
    with pytest.warns(UserWarning):
        assert mgr.restore_latest() is None
    monkeypatch.setenv("MXNET_HOST_ID", "0")
    assert not chaos.maybe_slow_host(9)              # another host


def test_sigterm_at_drains_in_process(tmp_path):
    chaos.configure(sigterm_at=2)
    step = TrainStep(_net(), tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": 0.1})
    loop = ResilientLoop(step, CheckpointManager(str(tmp_path)),
                         save_every=10, verbose=False, metrics_port=False)
    try:
        loop.step(*_batch(0))
        with pytest.raises(Preempted):
            loop.step(*_batch(1))
    finally:
        loop.watcher.uninstall()
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]


@pytest.mark.parametrize("fault,rc", [("MXNET_CHAOS_SIGKILL_AT",
                                       -signal.SIGKILL),
                                      ("MXNET_CHAOS_KILL_SAVE", 43)])
def test_hard_kills_in_a_worker(tmp_path, fault, rc):
    """The drill's worker, armed by the environment only: SIGKILL after a
    step, the hard exit inside a save."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""), **{fault: "4"})
    p = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_train",
         "--worker", "--device", "cpu", "--net", "mlp", "--steps", "6",
         "--save-every", "2", "--ckpt-dir", str(tmp_path)], env=env,
        capture_output=True, text=True, timeout=180)
    assert p.returncode == rc, p.stdout[-2000:] + p.stderr[-2000:]
    # the kill inside step 4's save leaves step 2; a SIGKILL right after
    # step 4's async save loses it unless its writer already published
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore_latest()[0] in ((2, 4) if rc < 0 else (2,))


def _drill(tmp_path, *args, timeout=600):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    p = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_train",
         "--device", "cpu", "--work-dir", str(tmp_path)] + list(args),
        env=env, capture_output=True, text=True, timeout=timeout)
    assert p.returncode == 0, p.stdout[-4000:] + p.stderr[-3000:]
    return p.stdout


def test_orchestrator_drill_tiny_word_lm(tmp_path):
    """SIGTERM (83), kill during the save (43, the last step intact), NaN
    under rollback: the faulted final line and parameter sha256 equal
    the clean run's, on a word LM with dropout."""
    out = _drill(tmp_path, "--net", "lm", "--lm", "40,8,8,1,5,4",
                 "--steps", "12", "--save-every", "4")
    assert "== OK: three faults survived, final state bit-identical" in out
    assert "DRILL_STATS" in out


@pytest.mark.slow
def test_multihost_pod_drill(tmp_path):
    out = _drill(tmp_path, "--multihost", "--net", "mlp")
    assert "same-shape relaunch: bit-identical on all 2 hosts" in out
    assert "loss-curve-identical" in out


@pytest.mark.slow
def test_supervised_campaign(tmp_path):
    out = _drill(tmp_path, "--multihost", "--supervised", "--net", "mlp",
                 "--steps", "48", "--slow-s", "0.1", timeout=1200)
    for leg in "ABCD":
        assert "== leg %s OK" % leg in out


def test_hung_peer_ends_by_world_timeout_and_grace_timer(tmp_path):
    """Leg (e) of the pod drill alone: rank 1 of two gloo worlds stops
    itself (SIGSTOP). With no notice the survivor's collective fails by
    gloo's timeout within MXNET_WORLD_TIMEOUT (rc 1); under SIGTERM sent
    once it is blocked in its collective, with the world's timeout far
    off, the watcher's grace timer ends it with 83 within its grace
    window."""
    import argparse
    from mxnet_tpu_torch.tools import chaos_train as ct
    args = argparse.Namespace(
        net="mlp", steps=12, save_every=4, policy="rollback", device="cpu",
        lm=ct.LM_DEFAULT, dropout=0.0, work_dir=str(tmp_path))
    exits = ct._hung_rank(args, {
        "MXNET_WORLD_TIMEOUT": str(ct.WORLD_TIMEOUT_S),
        "MXNET_PREEMPT_GRACE_SECS": str(ct.GRACE_S)})
    assert exits["timeout"]["rc"] == 1
    assert ct.WORLD_TIMEOUT_S - 1 <= exits["timeout"]["after_hang_s"] \
        <= ct.WORLD_TIMEOUT_S + ct.EXIT_SLACK_S
    assert exits["grace"]["rc"] == ct.EXIT_PREEMPTED
    assert ct.HUNG_GRACE_S - 1 <= exits["grace"]["after_sigterm_s"] \
        <= ct.HUNG_GRACE_S + ct.EXIT_SLACK_S
