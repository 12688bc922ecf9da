"""The port's ResilientLoop (mxnet_tpu_torch/parallel/resilient.py) held to
the reference's: the bad-step policies on the 6-16-3 MLP against the
reference's loop (1e-5, equal counters), the guard transparent when
finite, bit-exact resume inside the port (dropout MLP, LeNet, a narrow
word LM; jax's and torch's generators differ, so dropout nets are held
to the port itself), the DataLoader cursor, the elastic-dp rails, SIGTERM
in a subprocess, and sharded checkpoints on a gloo world of 2 CPU ranks.

The reference side runs inside `mxnet_tpu.random.trace_key_scope` with
its key made up front, so its steps need no `jax.core.trace_state_clean`.
Children of the gloo world import this module: jax and mxnet_tpu are
imported inside the tests only."""
import contextlib
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon.data import DataLoader
from mxnet_tpu_torch.parallel import (BadStepError, Preempted,
                                      ResilientLoop, TrainStep)
from mxnet_tpu_torch.utils import chaos
from mxnet_tpu_torch.utils.recovery import CheckpointManager

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _chaos_clean():
    chaos.reset()
    yield
    chaos.reset()


@contextlib.contextmanager
def _ref_scope():
    import jax
    import mxnet_tpu as mx
    from mxnet_tpu.utils import chaos as jchaos
    jchaos.reset()
    if mx.random._STATE.key is None:
        mx.random._STATE.key = jax.random.PRNGKey(0)
    try:
        with mx.random.trace_key_scope(jax.random.PRNGKey(0)):
            yield
    finally:
        jchaos.reset()


def dense_batch(i):
    rng = np.random.RandomState(1000 + i)
    return (rng.randn(8, 6).astype(np.float32),
            rng.randint(0, 3, (8,)).astype(np.float32))


def _mlp_weights():
    rng = np.random.RandomState(3)
    return [rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for s in ((16, 6), (16,), (3, 16), (3,))]


def _port_mlp(dropout=0.0):
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dense(16, in_units=6, activation="relu"))
        if dropout:
            net.add(tmx.gluon.nn.Dropout(dropout))
        net.add(tmx.gluon.nn.Dense(3, in_units=16))
        net.initialize(tmx.init.Xavier())
        if not dropout:
            for p, w in zip(net.collect_params().values(), _mlp_weights()):
                p.set_data(tmx.nd.array(w))
    return net


def _ref_mlp():
    import mxnet_tpu as mx
    net = mx.gluon.nn.HybridSequential()
    net.add(mx.gluon.nn.Dense(16, in_units=6, activation="relu"))
    net.add(mx.gluon.nn.Dense(3, in_units=16))
    net.initialize(mx.init.Xavier())
    for p, w in zip(net.collect_params().values(), _mlp_weights()):
        p.set_data(mx.nd.array(w))
    return net


def _params(net):
    return np.concatenate([p.data().asnumpy().ravel().copy()
                           for p in net.collect_params().values()])


def _drive(pkg, ckpt, policy, nan_steps, total=10, lr_shrink=1.0):
    """Train the MLP `total` steps through `pkg`'s ResilientLoop with NaN
    gradients at `nan_steps`; batches follow the step count (rollback
    replays them). Returns (params, bad_steps, rollbacks, error)."""
    if pkg == "port":
        net = _port_mlp()
        step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "adam", {"learning_rate": 0.01})
        loop = ResilientLoop(step, CheckpointManager(str(ckpt), keep=3),
                             save_every=2, policy=policy, rollback_after=1,
                             lr_shrink=lr_shrink, watch_preemption=False,
                             verbose=False, metrics_port=False)
        ch = chaos
    else:
        import mxnet_tpu as mx
        from mxnet_tpu.parallel.resilient import ResilientLoop as RLoop
        from mxnet_tpu.parallel.trainer import TrainStep as RStep
        from mxnet_tpu.utils import chaos as ch
        from mxnet_tpu.utils.recovery import CheckpointManager as RMgr
        net = _ref_mlp()
        step = RStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                     {"learning_rate": 0.01}, guard=True)
        loop = RLoop(step, RMgr(str(ckpt), keep=3), save_every=2,
                     policy=policy, rollback_after=1, lr_shrink=lr_shrink,
                     watch_preemption=False, verbose=False,
                     metrics_port=False)
    err = None
    fired = set()
    try:
        while loop.t < total:
            nxt = loop.t + 1
            if nxt in nan_steps and nxt not in fired:
                fired.add(nxt)
                ch.reset()
                ch.configure(nan_step=nxt)
            loop.step(*dense_batch(loop.t))
    except BadStepError as e:
        err = e
    except Exception as e:  # the reference's BadStepError is its own class
        if type(e).__name__ != "BadStepError":
            raise
        err = e
    loop._manager.wait(_barrier=False)
    if pkg == "reference":
        step.sync_params()
    return _params(net), loop.bad_steps, loop.rollbacks, err


@pytest.mark.parametrize("policy,nan_steps,lr_shrink", [
    ("skip", (3, 6), 1.0),
    ("rollback", (5,), 0.5),
    ("raise", (4,), 1.0),
])
def test_policies_match_reference(tmp_path, policy, nan_steps, lr_shrink):
    got = _drive("port", tmp_path / "port", policy, nan_steps,
                 lr_shrink=lr_shrink)
    with _ref_scope():
        want = _drive("reference", tmp_path / "ref", policy, nan_steps,
                      lr_shrink=lr_shrink)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert got[1:3] == want[1:3]
    assert (got[3] is None) == (want[3] is None)
    if policy == "raise":
        assert got[3] is not None and got[1] == 1
    if policy == "rollback":
        assert got[2] == 1


def test_guard_transparent_when_finite(tmp_path):
    net = _port_mlp()
    plain = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                      {"learning_rate": 0.01})
    for i in range(4):
        plain(*dense_batch(i))
    want = _params(net)
    net = _port_mlp()
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                     {"learning_rate": 0.01})
    loop = ResilientLoop(step, CheckpointManager(str(tmp_path)),
                         save_every=2, policy="skip",
                         watch_preemption=False, verbose=False,
                         metrics_port=False)
    assert step._guard
    for i in range(4):
        loop.step(*dense_batch(i))
    loop.finish()
    np.testing.assert_array_equal(_params(net), want)
    assert loop.bad_steps == 0 and bool(step.last_step_ok)


def _bit_exact_resume(make_step, make_batch, total, kill_at, save_every,
                      tmp_path):
    def train(ckpt, stop=None, resume=False, seed=0):
        tmx.random.seed(seed)
        np.random.seed(seed)
        net, step = make_step()
        mgr = CheckpointManager(str(ckpt), keep=3)
        loop = ResilientLoop(step, mgr, save_every=save_every,
                             policy="skip", watch_preemption=False,
                             verbose=False, metrics_port=False)
        start = loop.restore() if resume else 0
        while loop.t < (stop or total):
            loop.step(*make_batch(loop.t))
        mgr.wait(_barrier=False)
        return start, _params(net)

    _, want = train(tmp_path / "clean")
    train(tmp_path / "int", stop=kill_at)                 # the "crash"
    start, got = train(tmp_path / "int", resume=True, seed=555)
    assert start == (kill_at // save_every) * save_every
    np.testing.assert_array_equal(want, got)


def test_bit_exact_resume_dropout_mlp(tmp_path):
    def make_step():
        net = _port_mlp(dropout=0.3)
        return net, TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              "adam", {"learning_rate": 0.01})
    _bit_exact_resume(make_step, dense_batch, 7, 5, 2, tmp_path)


def test_bit_exact_resume_lenet(tmp_path):
    from mxnet_tpu_torch.models.lenet import LeNet

    def make_step():
        with tmx.cpu():
            net = LeNet(num_classes=10, dropout=0.3)
            net.initialize(tmx.init.Xavier())
            net(tmx.nd.zeros((4, 1, 28, 28)))
        return net, TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              "adam", {"learning_rate": 0.01})

    def make_batch(i):
        rng = np.random.RandomState(77 + i)
        return (rng.randn(4, 1, 28, 28).astype(np.float32),
                rng.randint(0, 10, (4,)).astype(np.float32))
    with tmx.cpu():
        _bit_exact_resume(make_step, make_batch, 6, 4, 2, tmp_path)


def test_bit_exact_resume_word_lm(tmp_path):
    """The LSTM LM with dropout 0.4: the generators' states resume, so
    the masks after the restore are the straight run's."""
    T, N, V = 6, 4, 30

    def make_step():
        with tmx.cpu():
            net = tmx.models.RNNModel(mode="lstm", vocab_size=V,
                                      num_embed=8, num_hidden=8,
                                      num_layers=1, dropout=0.4)
            net.initialize(tmx.init.Xavier())
            net(tmx.nd.zeros((T, N)))
        return net, TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                              "adam", {"learning_rate": 0.01})

    def make_batch(i):
        rng = np.random.RandomState(55 + i)
        return (rng.randint(0, V, (T, N)).astype(np.float32),
                rng.randint(0, V, (T * N,)).astype(np.float32))
    with tmx.cpu():
        _bit_exact_resume(make_step, make_batch, 6, 3, 2, tmp_path)


def _loader():
    data = [(np.full(6, i, np.float32), np.float32(i % 3))
            for i in range(24)]
    return DataLoader(data, batch_size=4, shuffle=True, seed=11)


def test_loader_cursor_resumes_mid_epoch(tmp_path):
    """batches() after restore() continues the epoch where the checkpoint
    left it: the ids seen equal a straight run's."""
    def run(ckpt, stop=None, resume=False):
        net = _port_mlp()
        step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", {"learning_rate": 0.1})
        loop = ResilientLoop(step, CheckpointManager(str(ckpt)),
                             loader=_loader(), save_every=2, epochs=2,
                             watch_preemption=False, verbose=False,
                             metrics_port=False)
        if resume:
            loop.restore()
        seen = []
        for x, y in loop.batches():
            seen.append(int(x.asnumpy()[0, 0]))
            loop.step(x, y)
            if stop is not None and loop.t == stop:
                break
        loop._manager.wait(_barrier=False)
        return seen, _params(net)

    want, want_p = run(tmp_path / "clean")
    first, _ = run(tmp_path / "int", stop=8)
    rest, got_p = run(tmp_path / "int", resume=True)
    assert len(want) == 12 and first + rest == want
    np.testing.assert_array_equal(got_p, want_p)


def test_elastic_dp_rails(tmp_path):
    """A checkpoint written at another data-parallel size with a loader
    cursor attached: 'raise' refuses it, 'rescale' warns and resumes."""
    def loop_of(ckpt, elastic):
        net = _port_mlp()
        step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", {"learning_rate": 0.1})
        return ResilientLoop(step, CheckpointManager(str(ckpt)),
                             loader=_loader(), save_every=1,
                             elastic_dp=elastic, watch_preemption=False,
                             verbose=False, metrics_port=False)

    loop = loop_of(tmp_path, None)
    for x, y in loop.batches():
        loop.step(x, y)
        break
    tree = loop.state_dict()
    blob = json.loads(bytes(tree["loop"]).decode())
    blob["dp_size"] = 2                      # written by a dp-2 world
    tree["loop"] = np.frombuffer(json.dumps(blob).encode(), np.uint8).copy()
    with pytest.raises(MXNetError, match="dp=2 but this run is dp=1"):
        loop_of(tmp_path, None).load_state_dict(tree)
    with pytest.warns(UserWarning, match="elastic resume"):
        loop_of(tmp_path, "rescale").load_state_dict(tree)
    with pytest.raises(ValueError):
        loop_of(tmp_path, "bogus")


def test_sigterm_preemption_subprocess(tmp_path):
    """SIGTERM at a step: the watcher checkpoints at the boundary and the
    process exits 83; a relaunch resumes from that step."""
    code = r"""
import sys, numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.parallel import ResilientLoop, TrainStep
from mxnet_tpu_torch.utils.recovery import CheckpointManager
with mx.cpu():
    net = mx.gluon.nn.Dense(3, in_units=6)
    net.initialize(mx.init.Xavier())
step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                 {"learning_rate": 0.1})
loop = ResilientLoop(step, CheckpointManager(sys.argv[1]), save_every=4,
                     metrics_port=False)
start = loop.restore()
rng = np.random.RandomState(0)
while loop.t < 8:
    loop.step(rng.randn(4, 6).astype(np.float32),
              rng.randint(0, 3, (4,)).astype(np.float32))
loop.finish()
print("DONE from", start)
"""
    env = dict(os.environ, MXNET_CHAOS_SIGTERM_AT="3",
               PYTHONPATH=REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=180)
    assert p.returncode == 83, p.stdout[-2000:] + p.stderr[-2000:]
    assert "preemption notice" in p.stdout
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]
    env.pop("MXNET_CHAOS_SIGTERM_AT")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                       capture_output=True, text=True, timeout=180)
    assert p.returncode == 0 and "DONE from 3" in p.stdout, p.stderr[-2000:]


def test_watcher_wakeup_arms_the_grace_timer_and_chains():
    """The signal's wakeup byte arms the grace deadline on the watcher's
    own thread (so a main thread blocked in a collective still gets its
    deadline); a watcher replaced by a later one does not arm, the byte
    reaches the earlier wakeup fd, and uninstall restores it."""
    import time as _time
    from mxnet_tpu_torch.parallel.resilient import PreemptionWatcher
    prior_r, prior_w = os.pipe()
    os.set_blocking(prior_w, False)
    os.set_blocking(prior_r, False)
    saved = signal.set_wakeup_fd(prior_w)
    first = PreemptionWatcher(signals=(signal.SIGUSR1,), grace_secs=60)
    second = PreemptionWatcher(signals=(signal.SIGUSR1,), grace_secs=60)
    try:
        first.install()
        second.install()
        os.kill(os.getpid(), signal.SIGUSR1)
        deadline = _time.monotonic() + 5
        while second._timer is None and _time.monotonic() < deadline:
            _time.sleep(0.01)
        assert second._timer is not None and second.triggered
        assert first.signal_time is None and first._timer is None
        got = b""
        while not got and _time.monotonic() < deadline:
            try:
                got = os.read(prior_r, 64)
            except BlockingIOError:
                _time.sleep(0.01)
        assert got == bytes([signal.SIGUSR1])
        second.uninstall()
        assert second._timer is None
        first.uninstall()
        assert signal.set_wakeup_fd(prior_w) == prior_w
    finally:
        second.uninstall()
        first.uninstall()
        signal.set_wakeup_fd(saved)
        os.close(prior_r)
        os.close(prior_w)


def test_preempted_in_process(tmp_path):
    net = _port_mlp()
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                     {"learning_rate": 0.1})
    loop = ResilientLoop(step, CheckpointManager(str(tmp_path)),
                         save_every=100, verbose=False, metrics_port=False)
    try:
        loop.step(*dense_batch(0))
        loop.watcher.trigger()
        with pytest.raises(Preempted) as e:
            loop.step(*dense_batch(1))
        assert e.value.code == 83 and e.value.step == 2
        assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    finally:
        loop.watcher.uninstall()


# -- a gloo world of 2 CPU ranks: sharded checkpoints -----------------------

def rank_sharded(ckpt):
    """On each rank: the MLP under {'dp': 2} with the sharded update,
    4 steps through ResilientLoop (a sync save every 2 steps, sharded
    because the optimizer state is); returns the host state and the
    parameters."""
    from mxnet_tpu_torch.parallel import build_mesh
    torch.manual_seed(0)
    mesh = build_mesh({"dp": 2})
    net = _port_mlp()
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                     {"learning_rate": 0.01}, mesh=mesh,
                     sharded_update=True)
    loop = ResilientLoop(step, CheckpointManager(ckpt, keep=5,
                                                 async_save=False),
                         save_every=2, policy="skip",
                         watch_preemption=False, verbose=False,
                         metrics_port=False)
    rng = np.random.RandomState(7)
    batches = [(rng.randn(8, 6).astype(np.float32),
                rng.randint(0, 3, (8,)).astype(np.float32))
               for _ in range(4)]
    for x, y in batches:
        loop.step(x, y)
    loop.finish()
    host = step.state_dict()
    return {"opt": [[np.asarray(v) for v in st] for st in host["opt_state"]],
            "params": _params(net)}


@pytest.fixture(scope="module")
def sharded_world(tmp_path_factory):
    from mxnet_tpu_torch.parallel.launch import run_world
    ckpt = str(tmp_path_factory.mktemp("sharded"))
    out = run_world("test_torch_resilience:rank_sharded", 2, args=(ckpt,),
                    device="cpu", timeout=300, paths=[TESTS])
    return ckpt, out


def test_sharded_world_round_trip(sharded_world):
    ckpt, ranks = sharded_world
    np.testing.assert_array_equal(ranks[0]["params"], ranks[1]["params"])
    names = sorted(os.listdir(ckpt))
    for f in ("ckpt-4.manifest.json", "ckpt-4.shard0of2.npz",
              "ckpt-4.shard1of2.npz", "ckpt-4.shard1of2.manifest.json"):
        assert f in names
    g = json.load(open(os.path.join(ckpt, "ckpt-4.manifest.json")))
    assert g["format"] == "sharded" and g["process_count"] == 2
    assert g["mesh"]["axes"] == {"dp": 2}
    sharded = [k for k, a in g["arrays"].items() if a["shards"] == 2]
    assert sharded and all(k.startswith("train/opt_state/") for k in sharded)
    # a reader alone reassembles the whole optimizer state, bit-equal to
    # what the ranks gathered
    step, tree = CheckpointManager(ckpt).restore_latest()
    assert step == 4
    for st, want in zip(tree["train"]["opt_state"], ranks[0]["opt"]):
        for a, b in zip(st, want):
            np.testing.assert_array_equal(a, b)
    # each rank wrote part of the bytes
    full = sum(os.path.getsize(os.path.join(ckpt, "ckpt-4.shard%dof2.npz"
                                            % i)) for i in range(2))
    for i in range(2):
        assert 0 < os.path.getsize(os.path.join(
            ckpt, "ckpt-4.shard%dof2.npz" % i)) < full


def test_sharded_world_elastic_restore_to_one(sharded_world, tmp_path):
    """A world of one restores the world of 2's step 4 into a plain
    TrainStep: the parameters equal the ranks' bit for bit, and training
    goes on."""
    import shutil
    ckpt = str(tmp_path / "c")
    shutil.copytree(sharded_world[0], ckpt)
    net = _port_mlp()
    step = TrainStep(net, tmx.gluon.loss.SoftmaxCrossEntropyLoss(), "adam",
                     {"learning_rate": 0.01})
    loop = ResilientLoop(step, CheckpointManager(ckpt), save_every=100,
                         policy="skip", watch_preemption=False,
                         verbose=False, metrics_port=False)
    assert loop.restore() == 4
    np.testing.assert_array_equal(_params(net), sharded_world[1][0]["params"])
    loop.step(*dense_batch(4))
    assert np.isfinite(_params(net)).all()


def test_sharded_world_incomplete_and_corrupt_steps(sharded_world,
                                                    tmp_path):
    import shutil
    ckpt = str(tmp_path / "c")
    shutil.copytree(sharded_world[0], ckpt)
    os.remove(os.path.join(ckpt, "ckpt-4.shard1of2.npz"))  # rank 1 died
    with pytest.warns(UserWarning, match="incomplete"):
        assert CheckpointManager(ckpt).restore_latest()[0] == 2
    path = os.path.join(ckpt, "ckpt-2.shard0of2.npz")
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF                          # bit rot
    open(path, "wb").write(bytes(blob))
    with pytest.warns(UserWarning):
        assert CheckpointManager(ckpt).restore_latest() is None


def test_shard_descriptor_layouts():
    """`Shard` on a 2 x 2 mesh (this process is rank 0): ZeRO's dp blocks
    and a tensor-parallel spec, each block's index in global coordinates
    and the ranks holding the same block."""
    from mxnet_tpu_torch.parallel.mesh import Mesh, P
    step = TrainStep(_port_mlp(), tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                     "sgd", {"learning_rate": 0.1})
    step._mesh = Mesh(np.arange(4).reshape(2, 2), ["dp", "tp"], False)
    t = torch.zeros(4, 4)
    zero = step._shard(("zero", 0), t, (8, 4))
    assert zero.index == ((0, 4), (0, 4)) and zero.shards == 2
    assert zero.shard == 0 and zero.holders == [0, 1]
    assert zero.spec == "P('dp', None)" and zero.mesh_axes == {"dp": 2,
                                                              "tp": 2}
    tp = step._shard(("spec", P(None, "tp")), torch.zeros(8, 2), (8, 4))
    assert tp.index == ((0, 8), (0, 2)) and tp.holders == [0, 2]
    both = step._shard(("spec", P(("dp", "tp"),)), torch.zeros(2, 4), (8, 4))
    assert both.shards == 4 and both.holders == [0] and both.index == (
        (0, 2), (0, 4))
