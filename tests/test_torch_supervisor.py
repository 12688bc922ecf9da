"""The port's remediation supervisor (mxnet_tpu_torch/parallel/supervisor.py)
held to the reference's: cordon roster files interchangeable between the
packages (concurrent writers, first wins), SDCProbe's digest equal to
the reference's and the quorum naming the same host, the checkpoint
auditor demoting a corrupt step (never an incomplete one), a straggler
episode cordoning and draining with 84, the cordon floor, the unchanged
`tools/train_supervise.py` relaunching a port worker through 83 / 84 /
crash codes, and `tools/train_top.py` / `tools/postmortem.py` rendering
the port's console and flight dumps."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.parallel import (CheckpointAuditor, CordonRoster,
                                      Reconfigured, ResilientLoop, SDCProbe,
                                      TrainStep, TrainSupervisor,
                                      effective_hosts)
from mxnet_tpu_torch.parallel.resilient import StragglerMonitor
from mxnet_tpu_torch.utils import chaos
from mxnet_tpu_torch.utils.recovery import CheckpointManager

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _chaos_clean():
    chaos.reset()
    yield
    chaos.reset()


def _loop(ckpt, **kw):
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(3, in_units=6)
        net.initialize(tmx.init.Xavier())
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": 0.1})
    kw.setdefault("save_every", 2)
    kw.setdefault("metrics_port", False)
    return ResilientLoop(step, CheckpointManager(str(ckpt), keep=5,
                                                 async_save=False),
                         watch_preemption=False, verbose=False, **kw)


def _batch(i):
    rng = np.random.RandomState(i)
    return (rng.randn(4, 6).astype(np.float32),
            rng.randint(0, 3, (4,)).astype(np.float32))


def test_cordon_roster_interchangeable_with_reference(tmp_path):
    from mxnet_tpu.parallel.supervisor import CordonRoster as RefRoster
    ref, port = RefRoster(str(tmp_path)), CordonRoster(str(tmp_path))
    assert port.cordon("1", reason="straggler", step=6, detail={"r": 3.1})
    assert not ref.cordon("1", reason="sdc")          # first writer won
    assert ref.cordon("host/2", reason="sdc", step=9)
    assert not port.cordon("host/2", reason="straggler")
    a, b = port.hosts(), ref.hosts()
    for entry in list(a.values()) + list(b.values()):
        entry.pop("t")
    assert a == b and sorted(a) == ["1", "host/2"]
    assert a["1"] == {"host": "1", "reason": "straggler", "step": 6,
                      "detail": {"r": 3.1}}
    assert sorted(os.listdir(tmp_path)) == ["host-1.json",
                                            "host-host_2.json"]
    assert effective_hosts(["0", "1", "2"], port) == ["0", "2"]
    assert _tool("train_supervise").read_roster(str(tmp_path)).keys() == \
        a.keys()
    assert port.uncordon("1") and not ref.is_cordoned("1")


def test_cordon_roster_concurrent_writers(tmp_path):
    """Six hosts (processes, the port's and the reference's roster in
    turn) cordon the same host at once: one file, parsing whole, and at
    least one writer saw itself first."""
    code = ("import sys, time\n"
            "from %s.parallel.supervisor import CordonRoster\n"
            "while time.time() < float(sys.argv[2]): pass\n"
            "print(CordonRoster(sys.argv[1]).cordon('7', reason=sys.argv[3]))")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    start = str(__import__("time").time() + 8.0)
    procs = [subprocess.Popen(
        [sys.executable, "-c", code % pkg, str(tmp_path), start, "r%d" % i],
        env=env, stdout=subprocess.PIPE, text=True)
        for i, pkg in enumerate(["mxnet_tpu_torch", "mxnet_tpu"] * 3)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert "True" in outs
    hosts = CordonRoster(str(tmp_path)).hosts()
    assert list(hosts) == ["7"] and hosts["7"]["reason"] in \
        {"r%d" % i for i in range(6)}
    assert [n for n in os.listdir(tmp_path) if ".tmp" not in n] == \
        ["host-7.json"]


def test_sdc_digest_and_quorum_match_reference():
    from mxnet_tpu.parallel.supervisor import SDCProbe as RefProbe
    values = {"loss": 2.302585092994046, "grad_norm": 0.1 + 0.2}
    assert SDCProbe.digest(values) == RefProbe.digest(values)
    bumped = dict(values, loss=np.nextafter(values["loss"], 3.0))
    assert SDCProbe.digest(bumped) != SDCProbe.digest(values)
    good, bad = SDCProbe.digest(values), SDCProbe.digest(bumped)
    tables = [{"0": good, "1": bad, "2": good},
              {"0": good, "1": bad},                   # 1-1: no majority
              {"0": good, "1": good, "2": good}]
    for peers in tables:
        port = SDCProbe(lambda: values, 2, host="0",
                        exchange=lambda step, d, p=peers: p)
        ref = RefProbe(lambda: values, 2, host="0",
                       exchange=lambda step, d, p=peers: p)
        assert port.run(4) == ref.run(4)
        assert port.last_clean_step == ref.last_clean_step
    assert SDCProbe(lambda: values, 2, host="0", exchange=lambda s, d: tables[
        0]).run(4) == ["1"]


def test_sdc_poison_flips_only_the_armed_host(monkeypatch):
    monkeypatch.setenv("MXNET_HOST_ID", "1")
    chaos.configure(sdc_at=("1", 4))
    seen = {}
    probe = SDCProbe(lambda: {"loss": 1.0}, 2, host="1",
                     exchange=lambda step, d: seen.setdefault(step, d) and
                     {"1": d, "0": SDCProbe.digest({"loss": 1.0}),
                      "2": SDCProbe.digest({"loss": 1.0})})
    assert probe.run(2) == []
    assert probe.run(4) == ["1"]
    assert "sdc_at" in chaos.fired()


def test_auditor_demotes_corrupt_never_incomplete(tmp_path):
    tree = {"w": np.arange(8, dtype=np.float32), "t": np.int64(1)}
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(1, tree)
    for i in range(2):                       # a complete sharded step
        CheckpointManager(str(tmp_path), keep=5, sharded=True,
                          process_index=i, process_count=2,
                          async_save=False).save(2, tree)
    CheckpointManager(str(tmp_path), keep=5, sharded=True, process_index=0,
                      process_count=2, async_save=False).save(3, tree)
    auditor = CheckpointAuditor(mgr, interval_s=60)
    assert auditor.audit_once() == []        # step 3 incomplete: kept
    assert mgr.all_steps() == [1, 2, 3]
    path = tmp_path / "ckpt-2.shard1of2.npz"
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    assert auditor.audit_once() == [2]
    assert mgr.all_steps() == [1, 3] and auditor.demoted == [2]
    assert os.path.exists(str(path) + ".corrupt")
    with pytest.warns(UserWarning, match="incomplete"):
        assert mgr.restore_latest()[0] == 1


def _straggler_loop(ckpt, times, **sup_kw):
    """A loop whose straggler monitor sees `times` (host -> seconds) every
    window, with a supervisor of host "0" over a pod of 3."""
    loop = _loop(ckpt)
    loop._straggler = StragglerMonitor(2, factor=1.5, patience=2,
                                       gather=lambda mean: dict(times))
    sup = TrainSupervisor(loop, host="0", expect_hosts=3, audit=False,
                          probe_every=0, **sup_kw)
    return loop, sup


def test_straggler_episode_cordons_and_drains_84(tmp_path):
    loop, sup = _straggler_loop(tmp_path, {"0": 0.01, "1": 0.5, "2": 0.011})
    with pytest.raises(Reconfigured) as e:
        for i in range(8):
            loop.step(*_batch(i))
    assert e.value.code == 84 and e.value.step == 4
    assert list(sup.roster.hosts()) == ["1"]
    assert sup.roster.hosts()["1"]["reason"] == "straggler"
    assert sup.reconfigure_reason == "straggler:1"
    # the drain published the boundary
    assert 4 in CheckpointManager(str(tmp_path)).all_steps()
    status = loop.statusz()["remediation"]
    assert "1" in status["cordoned"]
    assert [a["action"] for a in status["actions"]] == ["cordon",
                                                        "reconfigure"]


def test_cordon_floor_refuses(tmp_path):
    loop, sup = _straggler_loop(tmp_path, {"0": 0.01, "1": 0.5, "2": 0.011},
                                min_hosts=3)
    for i in range(6):
        loop.step(*_batch(i))
    assert not sup.reconfigure_requested and sup.roster.hosts() == {}
    assert [a["action"] for a in sup.actions] == ["cordon_refused"]


_WORKER = r"""
import os, sys, numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel import ResilientLoop, TrainStep, TrainSupervisor
from mxnet_tpu_torch.utils.recovery import CheckpointManager
state = sys.argv[1]
n = int(open(state).read()) if os.path.exists(state) else 0
open(state, "w").write(str(n + 1))
plan = sys.argv[2].split(",")[n]
with mx.cpu():
    net = mx.gluon.nn.Dense(3, in_units=6)
    net.initialize(mx.init.Xavier())
step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                 {"learning_rate": 0.1})
loop = ResilientLoop(step, CheckpointManager(sys.argv[3]), save_every=2,
                     metrics_port=False)
if plan == "84":
    TrainSupervisor(loop, audit=False, expect_hosts=2)
start = loop.restore()
rng = np.random.RandomState(0)
while loop.t < 6:
    if plan == "83" and loop.t == start + 1:
        loop.watcher.trigger()
    if plan == "84" and loop.t == start + 1:
        loop.supervisor.request_reconfigure("test")
    if plan == "crash" and loop.t == start + 1:
        raise RuntimeError("injected crash")
    loop.step(rng.randn(4, 6).astype(np.float32),
              rng.randint(0, 3, (4,)).astype(np.float32))
loop.finish()
print("FINISHED from", start)
"""


@pytest.mark.parametrize("plan,restart_max,rc,verdicts", [
    ("83,84,crash,ok", 1, 0, ["preempted", "reconfigure", "crash"]),
    ("crash,crash,ok", 1, 1, ["crash", "crash"]),
])
def test_train_supervise_relaunches_port_worker(tmp_path, plan, restart_max,
                                                rc, verdicts):
    """The reference's stdlib relauncher, unchanged, drives the port's
    worker: 83 and 84 relaunch free, a crash costs a life, and past the
    budget the circuit opens with the worker's code."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""),
               MXNET_TRAIN_RESTART_BACKOFF="0.01")
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "train_supervise.py"),
         "--restart-max", str(restart_max), "--roster",
         str(tmp_path / "ckpt" / "cordon"), "--", sys.executable,
         str(script), str(tmp_path / "n"), plan, str(tmp_path / "ckpt")],
        env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == rc, p.stdout[-3000:] + p.stderr[-3000:]
    got = [v for v in ("preempted", "reconfigure", "crash")
           for line in p.stdout.splitlines()
           if line.startswith("[supervise] " + v)]
    assert sorted(got) == sorted(verdicts), p.stdout
    if rc == 0:
        assert "FINISHED from 4" in p.stdout or "FINISHED from 2" in \
            p.stdout, p.stdout
    else:
        assert "CIRCUIT OPEN" in p.stdout


def test_train_top_and_postmortem_render_port(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR", str(tmp_path / "flight"))
    loop = _loop(tmp_path / "ckpt", metrics_port=0)
    loop._straggler = StragglerMonitor(
        2, factor=1.5, patience=1,
        gather=lambda mean: {"0": mean, "5": 10 * mean + 1.0})
    try:
        chaos.configure(spike_step=3)
        for i in range(4):
            loop.step(*_batch(i))
        url = "http://%s:%d" % loop.console_addr
        frame = _tool("train_top").render_once([url])
        assert "train console" in frame and " live " in frame
        assert "FLAGGED" in frame, frame
        z = loop.statusz()
        assert z["step"] == 4 and z["checkpoint"]["last_step"] == 4
        assert z["straggler"]["flagged"] == {"5": 1}
    finally:
        loop.close_console()
    tmx.telemetry.flight().dump("test")
    pm = _tool("postmortem")
    text = pm.render(pm.load_dumps([str(tmp_path / "flight")]))
    assert "FAULT" in text and "chaos.spike_step" in text
    assert "train.straggler" in text and "ALERT" in text
