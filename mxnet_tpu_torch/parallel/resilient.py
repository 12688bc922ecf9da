"""Fault-tolerant training runtime: the whole fault lifecycle in one
loop (port of `mxnet_tpu/parallel/resilient.py`).

`ResilientLoop` owns the lifecycle around `TrainStep` +
`utils.recovery.CheckpointManager`:

  * **Step-exact resume** — a checkpoint holds the parameters, the
    optimizer state, the step count, the generators' states (dropout
    masks, SGLD noise), the LR schedule's state and the data cursor
    (`gluon.data.DataLoader.state_dict()`), so training N steps straight
    and training k, dying, `restore()`, training N - k give bit-identical
    parameters.
  * **Preemption watcher** — SIGTERM / SIGINT ask for a checkpoint at the
    next step boundary; the loop publishes it synchronously
    (`manager.wait()`, the barrier point) and exits with
    `EXIT_PREEMPTED` (83). `MXNET_PREEMPT_GRACE_SECS` (default 30) bounds
    the drain: a timer force-exits with 83 when no boundary comes (a
    rank blocked in a collective on a hung peer; the timer starts when
    the signal arrives, even while the rank is blocked). Without a
    notice, the world's `MXNET_WORLD_TIMEOUT` ends such a wait.
  * **Bad-step guard** — the step's guard (`TrainStep(guard=True)`,
    switched on here when a policy needs it; the port's step is eager, so
    it can be switched on after steps ran) drops a non-finite step on the
    device. Policies (`MXNET_BAD_STEP_POLICY` or `policy=`): ``skip``,
    ``rollback`` (after `rollback_after` consecutive bad steps restore
    the last checkpoint and scale the LR by `lr_shrink`), ``raise``
    (`BadStepError`), ``off``.
  * **Chaos** — every step boundary consults `utils.chaos` (SIGTERM and
    SIGKILL delivery, the slow-host sleep); the gradient poison sits in
    the step itself.
  * **Straggler detection** — `MXNET_STRAGGLER_WINDOW=k` closes a skew
    window every k steps: each host's mean step time is gathered
    (`torch.distributed.all_gather_object` over the world when one of
    several ranks is up, else the shared-directory exchange of
    `MXNET_STRAGGLER_DIR` for emulated hosts), max/median skew lands on
    gauges and a host over `MXNET_STRAGGLER_FACTOR` x the median for
    `MXNET_STRAGGLER_PATIENCE` windows is flagged (`train.straggler`).
  * **Anomaly detection** — `MXNET_ANOMALY_DETECT=1` scores each step's
    loss and grad norm with EWMA z-scores (`telemetry/anomaly.py`).
  * **Live train console** — `MXNET_TRAIN_METRICS_PORT` serves
    `/metrics`, `/statusz` and `/healthz` (`tools/train_top.py` reads
    them).

    step = TrainStep(net, loss_fn, "adam", {"learning_rate": 1e-3})
    loop = ResilientLoop(step, CheckpointManager(ckpt_dir, keep=3),
                         loader=train_loader, save_every=100,
                         policy="skip")
    start = loop.restore()          # 0 on a cold start
    for x, y in loop.batches():     # resumes mid-epoch
        loss = loop.step(x, y)
"""
from __future__ import annotations

import json
import os
import signal
import statistics
import threading
import time
import warnings

import numpy as np

from ..base import MXNetError
from .. import telemetry

#: exit code meaning "preemption drained cleanly — relaunch me"
EXIT_PREEMPTED = 83

#: exit code meaning "remediation drained cleanly — re-read the cordon
#: roster and relaunch me at the new (usually smaller) world"
EXIT_RECONFIGURE = 84

_POLICIES = ("off", "skip", "rollback", "raise")


class BadStepError(MXNetError):
    """Raised under policy='raise' when a step produces NaN/Inf loss or
    gradients."""


class Preempted(SystemExit):
    """Raised by ResilientLoop after a preemption checkpoint published.
    A SystemExit(EXIT_PREEMPTED): unhandled, the process exits with the
    relaunch code; in-process callers may catch it."""

    def __init__(self, step):
        super().__init__(EXIT_PREEMPTED)
        self.step = step


class Reconfigured(SystemExit):
    """Raised by ResilientLoop after the remediation supervisor's
    reconfigure checkpoint published: a SystemExit(EXIT_RECONFIGURE)."""

    def __init__(self, step, reason=None):
        super().__init__(EXIT_RECONFIGURE)
        self.step = step
        self.reason = reason


def _world_size():
    from .mesh import world_info
    return world_info()["world_size"]


class PreemptionWatcher:
    """SIGTERM/SIGINT handler that turns a kill notice into a checkpoint
    request at the next step boundary.

    The first signal sets `triggered` and starts the grace timer
    (`MXNET_PREEMPT_GRACE_SECS`, default 30), which force-exits with
    EXIT_PREEMPTED if no boundary publishes in time; a second signal
    exits at once. Handlers install only on the main thread (a signal
    module rule); elsewhere the watcher never triggers. The handler runs
    no collective: it only sets a flag, starts a timer and dumps the
    flight recorder.

    Python runs a signal's handler only when the main thread is back in
    the interpreter, which a rank blocked in a collective is not. So the
    watcher also takes the signal's wakeup byte (`signal.set_wakeup_fd`,
    chained to any earlier wakeup fd) on a thread of its own, which
    starts the grace timer at once: a rank blocked on a hung peer ends
    within its grace window whatever the world's timeout."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT),
                 grace_secs=None):
        if grace_secs is None:
            grace_secs = float(os.environ.get("MXNET_PREEMPT_GRACE_SECS",
                                              "30"))
        self.grace_secs = grace_secs
        self._signals = tuple(signals)
        self._saved = {}
        self._timer = None
        self._lock = threading.RLock()
        self._event = threading.Event()
        self._wakeup = None          # (read fd, write fd, the earlier fd)
        self.signal_time = None
        self.installed = False

    def install(self):
        try:
            for sig in self._signals:
                self._saved[sig] = signal.signal(sig, self._on_signal)
            self.installed = True
        except ValueError:  # not the main thread
            warnings.warn("PreemptionWatcher: not on the main thread — "
                          "signal handlers not installed, preemption "
                          "checkpointing disabled")
            return self
        r, w = os.pipe()
        os.set_blocking(w, False)
        prior = signal.set_wakeup_fd(w, warn_on_full_buffer=False)
        self._wakeup = (r, w, prior)
        threading.Thread(target=self._read_wakeups, args=(r, prior),
                         name="preempt-wakeup", daemon=True).start()
        return self

    def uninstall(self):
        for sig, old in self._saved.items():
            try:
                signal.signal(sig, old)
            except ValueError:
                pass
        self._saved.clear()
        if self._wakeup is not None:
            r, w, prior = self._wakeup
            self._wakeup = None
            try:
                signal.set_wakeup_fd(prior)
            except ValueError:
                pass
            os.close(w)              # the reader sees EOF and closes r
        self.installed = False
        self.cancel_deadline()

    def _read_wakeups(self, r, prior):
        watched = {int(s) for s in self._signals}
        try:
            while True:
                data = os.read(r, 64)
                if not data:
                    return
                if prior >= 0:
                    try:
                        os.write(prior, data)
                    except OSError:
                        pass
                # a watcher replaced by a later one leaves the notice to it
                if any(b in watched and signal.getsignal(b) == self._on_signal
                       for b in data):
                    self._arm()
        finally:
            os.close(r)

    def _arm(self):
        """Start the grace deadline, once, at the first notice."""
        with self._lock:
            if self.signal_time is not None:
                return
            self.signal_time = time.monotonic()
            if self.grace_secs and self.grace_secs > 0:
                self._timer = threading.Timer(self.grace_secs, os._exit,
                                              args=(EXIT_PREEMPTED,))
                self._timer.daemon = True
                self._timer.start()

    def _on_signal(self, signum, frame):
        if self._event.is_set():
            os._exit(EXIT_PREEMPTED)     # second notice: go now
        # the grace deadline first: if the flight dump wedges, the timer
        # still force-exits inside the window
        self._arm()
        self._event.set()
        telemetry.flight().record("fault", "train.preemption_signal",
                                  signum=signum)
        telemetry.flight().dump("sigterm")

    @property
    def triggered(self):
        return self._event.is_set()

    def remaining_grace(self):
        if self.signal_time is None:
            return None
        return max(0.0, self.grace_secs -
                   (time.monotonic() - self.signal_time))

    def cancel_deadline(self):
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    def trigger(self):
        """Test seam: a delivered signal without the OS."""
        self._on_signal(None, None)


def straggler_window_env():
    """MXNET_STRAGGLER_WINDOW — steps per skew window (0/unset = off)."""
    raw = os.environ.get("MXNET_STRAGGLER_WINDOW", "0") or "0"
    try:
        return int(raw)
    except ValueError:
        raise ValueError("MXNET_STRAGGLER_WINDOW must be an integer "
                         "step count, got %r" % (raw,))


def straggler_factor():
    """MXNET_STRAGGLER_FACTOR — flag threshold as a multiple of the pod
    median step time (default 2.0; must be > 1)."""
    raw = os.environ.get("MXNET_STRAGGLER_FACTOR", "2.0") or "2.0"
    try:
        v = float(raw)
    except ValueError:
        raise ValueError("MXNET_STRAGGLER_FACTOR must be a number > 1, "
                         "got %r" % (raw,))
    if v <= 1.0:
        raise ValueError("MXNET_STRAGGLER_FACTOR must be > 1 (a host "
                         "at the median is not a straggler), got %r"
                         % (raw,))
    return v


def straggler_patience():
    """MXNET_STRAGGLER_PATIENCE — consecutive over-factor windows before
    a host is flagged (default 2)."""
    raw = os.environ.get("MXNET_STRAGGLER_PATIENCE", "2") or "2"
    try:
        return max(1, int(raw))
    except ValueError:
        raise ValueError("MXNET_STRAGGLER_PATIENCE must be an integer "
                         "window count, got %r" % (raw,))


class _FileTimeExchange:
    """Shared-directory step-time exchange for EMULATED pods
    (MXNET_STRAGGLER_DIR): each host publishes its window mean with an
    atomic rename and reads whatever its peers last published."""

    def __init__(self, dirpath, host, max_age_s=300.0):
        self.dir = dirpath
        self.host = str(host)
        self.max_age_s = float(max_age_s)
        safe = "".join(c if c.isalnum() or c in "-_" else "_"
                       for c in self.host)
        self._path = os.path.join(dirpath, "steptime-host%s.json" % safe)

    def __call__(self, mean_s):
        now = time.time()
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self._path + ".tmp%d" % os.getpid()
            with open(tmp, "w") as f:
                json.dump({"host": self.host, "mean_s": float(mean_s),
                           "t": now}, f)
            os.replace(tmp, self._path)
        except OSError:
            pass                      # a missed publish skews one window
        out = {self.host: float(mean_s)}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("steptime-host")
                    and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.dir, name)) as f:
                    doc = json.load(f)
                # a dead host's frozen mean (or an earlier run's file)
                # must not skew every later window's median
                if now - float(doc.get("t", 0.0)) > self.max_age_s:
                    continue
                out[str(doc["host"])] = float(doc["mean_s"])
            except (OSError, ValueError, KeyError, TypeError):
                continue              # torn peer write: skip this window
        return out


def _world_gather(payload):
    """Every rank's `payload`, in rank order, through the world."""
    import torch.distributed as dist
    rows = [None] * dist.get_world_size()
    dist.all_gather_object(rows, payload)
    return rows


def _default_time_gather():
    """The per-window step-time gather: an allgather over the world when
    one of several ranks is up, the shared-directory exchange when
    MXNET_STRAGGLER_DIR names one (emulated hosts), else local only."""
    host = telemetry.metrics._host_label()
    if _world_size() > 1:
        def gather(mean_s):
            return {str(h): float(t) for h, t in
                    _world_gather((str(host), float(mean_s)))}
        return gather
    sdir = os.environ.get("MXNET_STRAGGLER_DIR")
    if sdir:
        return _FileTimeExchange(sdir, host)
    return lambda mean_s: {host: float(mean_s)}


class StragglerMonitor:
    """Windowed per-host step-time skew detection.

    `observe(step, seconds)` accumulates this host's step times; every
    `window` steps the window MEAN is exchanged (`gather`: host -> mean
    seconds), max/median skew lands on gauges, and a host over `factor`
    x the median for `patience` CONSECUTIVE windows is flagged once per
    episode (`train_stragglers_total`, a `train.straggler` flight
    event)."""

    def __init__(self, window, factor=None, patience=None, gather=None,
                 registry=None):
        self.window = int(window)
        self.factor = straggler_factor() if factor is None \
            else float(factor)
        self.patience = straggler_patience() if patience is None \
            else int(patience)
        self._gather = gather or _default_time_gather()
        self._registry = registry
        self._times = []
        self.windows = 0              # closed windows
        self._consec = {}             # host -> consecutive slow windows
        self._episode = set()         # hosts flagged in the open episode
        self.flagged = {}             # host -> times flagged (lifetime)
        self.last_window = None       # host -> mean seconds
        self.last_skew = None

    def _reg(self):
        return self._registry or telemetry.default_registry()

    def observe(self, step, seconds):
        """One step's wall time; closes the window on cadence. Returns
        the hosts newly flagged at this boundary (usually [])."""
        self._times.append(float(seconds))
        if len(self._times) < self.window:
            return []
        mean = sum(self._times) / len(self._times)
        del self._times[:]
        return self._close_window(step, mean)

    def _close_window(self, step, mean_s):
        times = self._gather(mean_s)
        self.windows += 1
        self.last_window = dict(times)
        if not times:
            return []
        median = statistics.median(times.values())
        mx = max(times.values())
        skew = (mx / median) if median > 0 else 1.0
        self.last_skew = skew
        reg = self._reg()
        reg.gauge("train_step_skew",
                  help="max/median of per-host mean step time, last "
                       "skew window").set(skew)
        reg.gauge("train_step_window_median_s",
                  help="pod-median mean step seconds, last skew window"
                  ).set(median)
        reg.gauge("train_step_window_max_s",
                  help="slowest host's mean step seconds, last skew "
                       "window").set(mx)
        newly = []
        # a host absent from this window's gather breaks its chain and
        # closes its episode
        for host in [h for h in self._consec if h not in times]:
            del self._consec[host]
            self._episode.discard(host)
        for host, t in sorted(times.items()):
            slow = median > 0 and t > self.factor * median
            if not slow:
                self._consec[host] = 0
                self._episode.discard(host)
                continue
            self._consec[host] = self._consec.get(host, 0) + 1
            if self._consec[host] < self.patience \
                    or host in self._episode:
                continue
            self._episode.add(host)
            # copy-on-write: the console's HTTP thread reads `flagged`
            self.flagged = dict(self.flagged,
                                **{host: self.flagged.get(host, 0) + 1})
            newly.append(host)
            ratio = t / median if median > 0 else float("inf")
            reg.counter(
                "train_stragglers_total", flight=True,
                help="hosts flagged over MXNET_STRAGGLER_FACTOR x the "
                     "pod-median step time for MXNET_STRAGGLER_PATIENCE "
                     "consecutive windows"
            ).inc(host=host, ratio=round(ratio, 3))
            telemetry.flight().record(
                "event", "train.straggler", host=host,
                mean_s=round(t, 6), median_s=round(median, 6),
                ratio=round(ratio, 3), window=self.windows, step=step)
        return newly

    def status(self):
        """The /statusz skew table."""
        return {"window_steps": self.window, "factor": self.factor,
                "patience": self.patience, "windows": self.windows,
                "skew": self.last_skew,
                "hosts": self.last_window,
                "flagged": dict(self.flagged)}


def _comms():
    """The /statusz comms ledger from the port's collective counters
    (the reference reads its compiled step's HLO instead): bytes and
    calls by op, and their total; no step fraction (not measured)."""
    from . import collectives
    c = collectives.counters()
    kinds = {op: {"bytes": int(c["bytes"].get(op, 0)),
                  "ops": int(c["calls"].get(op, 0))}
             for op in sorted(set(c["bytes"]) | set(c["calls"]))}
    if not kinds:
        return None
    return {"kinds": kinds,
            "total_bytes": sum(k["bytes"] for k in kinds.values()),
            "staged_bytes": int(c["staged_bytes"]), "fraction": None}


class ResilientLoop:
    """Drive a `TrainStep` through the whole fault lifecycle.

    Parameters (the reference's): step, manager, loader (a DataLoader
    whose cursor joins the checkpoint; `batches()` iterates resume-aware
    epochs), save_every, policy ('off' | 'skip' | 'rollback' | 'raise',
    default MXNET_BAD_STEP_POLICY), rollback_after, lr_shrink, epochs,
    watch_preemption, grace_secs, elastic_dp ('raise' | 'rescale', default
    MXNET_ELASTIC_DP_POLICY: what `restore()` does when the checkpoint's
    data-parallel size differs from this run's and a DataLoader cursor
    is attached), verbose, straggler_window, anomaly, metrics_port
    (False suppresses the console whatever the environment says).
    """

    def __init__(self, step, manager, loader=None, save_every=100,
                 policy=None, rollback_after=3, lr_shrink=1.0,
                 epochs=1, watch_preemption=True, grace_secs=None,
                 elastic_dp=None, verbose=True, straggler_window=None,
                 anomaly=None, metrics_port=None):
        if policy is None:
            policy = os.environ.get("MXNET_BAD_STEP_POLICY", "off") or "off"
        policy = policy.lower()
        if policy not in _POLICIES:
            raise ValueError("bad-step policy must be one of %s, got %r"
                             % ("/".join(_POLICIES), policy))
        if elastic_dp is None:
            elastic_dp = os.environ.get("MXNET_ELASTIC_DP_POLICY",
                                        "raise") or "raise"
        elastic_dp = elastic_dp.lower()
        if elastic_dp not in ("raise", "rescale"):
            raise ValueError("elastic_dp policy must be raise or rescale, "
                             "got %r" % (elastic_dp,))
        self.elastic_dp = elastic_dp
        self._step = step
        self._manager = manager
        self._loader = loader
        self.save_every = int(save_every)
        self.policy = policy
        self.rollback_after = int(rollback_after)
        self.lr_shrink = float(lr_shrink)
        self.epochs = int(epochs)
        self.verbose = verbose
        if policy != "off":
            # the port's step is eager: the guard is read at every call
            step._guard = True
        reg = telemetry.default_registry()
        self._m_step = reg.histogram(
            "train_step_seconds",
            help="host-observed train step time (dispatch + boundary)")
        self._m_data_wait = reg.histogram(
            "train_data_wait_seconds",
            help="time the loop waited on the data pipeline per batch")
        self._m_samples = reg.gauge(
            "train_samples_per_sec",
            help="batch items per second, last step")
        self._m_tokens = reg.gauge(
            "train_tokens_per_sec",
            help="tokens per second, last step (rank-2 inputs only)")
        self._m_gnorm = reg.gauge(
            "train_grad_norm",
            help="global gradient norm, last guarded step")
        self._m_bad = reg.counter(
            "train_bad_steps_total", flight=True,
            help="steps dropped by the NaN/Inf guard")
        self._m_rollbacks = reg.counter(
            "train_rollbacks_total", flight=True,
            help="checkpoint rollbacks taken by the bad-step policy")
        self._m_preempt = reg.counter(
            "train_preemptions_total", flight=True,
            help="preemption notices drained to a checkpoint")
        # fault-lifecycle counters (in the checkpoint, so a relaunch
        # keeps the history: a rollback's LR shrink must persist)
        self.consecutive_bad = 0
        self.bad_steps = 0
        self.rollbacks = 0
        self.preempted = False
        self._lr_scale = 1.0
        self._epoch = 0   # epochs batches() has fully consumed
        self._iter_invalid = False  # set by rollback: re-enter the loader
        self._base_lr_fn = None
        self._last_save = None        # (step, wall time) of last save()
        if straggler_window is None:
            straggler_window = straggler_window_env()
        self._straggler = StragglerMonitor(straggler_window) \
            if straggler_window and straggler_window > 0 else None
        from ..telemetry import anomaly as _anomaly_mod
        if anomaly is None:
            anomaly = _anomaly_mod.detect_enabled()
        self._anomaly = _anomaly_mod.AnomalyDetector() if anomaly \
            else None
        self.console_addr = None
        self._console = None
        if metrics_port is None:
            raw = os.environ.get("MXNET_TRAIN_METRICS_PORT")
            if raw not in (None, ""):
                try:
                    metrics_port = int(raw)
                except ValueError:
                    raise ValueError("MXNET_TRAIN_METRICS_PORT must be "
                                     "an integer port, got %r" % (raw,))
        # identity check: False means "no console" (False == 0 would
        # otherwise read as "ephemeral port")
        if metrics_port is not None and metrics_port is not False:
            self.serve_metrics(port=int(metrics_port))
        self.watcher = None
        if watch_preemption:
            self.watcher = PreemptionWatcher(grace_secs=grace_secs)
            self.watcher.install()
            # a drain's publish retries never sleep past the grace window
            if hasattr(manager, "deadline_fn"):
                manager.deadline_fn = self.watcher.remaining_grace
        self.supervisor = None
        from . import supervisor as _supervisor_mod
        if _supervisor_mod.remediation_enabled():
            _supervisor_mod.TrainSupervisor(self)

    # -- lr scale (rollback shrink) -----------------------------------------
    def _install_lr_scale(self):
        if self._base_lr_fn is not None:
            return
        step = self._step
        base = step._lr_schedule or step._opt.lr_scheduler
        if base is None:
            base_lr = step._opt.lr
            self._base_lr_fn = lambda t: base_lr
        else:
            self._base_lr_fn = base
        # the scheduler stays reachable for state_dict(): the wrapper is
        # stateless, the base scheduler is not
        step._lr_schedule_base = self._base_lr_fn
        step.set_lr_schedule(
            lambda t: self._base_lr_fn(t) * self._lr_scale)

    # -- state --------------------------------------------------------------
    def _dp_size(self):
        """The step's data-parallel size (1 off-mesh): in the checkpoint,
        so an elastic relaunch can tell whether the data cursor's math
        still holds (it counts GLOBAL batches)."""
        step = self._step
        mesh = getattr(step, "_mesh", None)
        axis = getattr(step, "_data_axis", None)
        if mesh is None or not axis:
            return 1
        return int(mesh.shape.get(axis, 1)) or 1

    def state_dict(self, device=False):
        """The composite checkpoint tree: the TrainStep's state and the
        loop's own (data cursor, bad-step counters, LR scale) as a JSON
        blob. device=True gives the step's live tensors, sharded state as
        `Shard`s (the sharded-checkpoint path)."""
        loop = {"consecutive_bad": self.consecutive_bad,
                "bad_steps": self.bad_steps,
                "rollbacks": self.rollbacks,
                "lr_scale": self._lr_scale,
                "epoch": self._epoch,
                "dp_size": self._dp_size()}
        if self._loader is not None and hasattr(self._loader, "state_dict"):
            loop["loader"] = self._loader.state_dict()
        blob = np.frombuffer(json.dumps(loop).encode(), np.uint8).copy()
        return {"train": self._step.state_dict(device=device), "loop": blob}

    def load_state_dict(self, tree):
        if "train" not in tree:      # a bare TrainStep checkpoint
            self._step.load_state_dict(tree)
            return
        loop = json.loads(bytes(bytearray(
            np.asarray(tree["loop"]).astype(np.uint8))).decode())
        saved_dp = int(loop.get("dp_size", 0) or 0)
        cur_dp = self._dp_size()
        if saved_dp and saved_dp != cur_dp and "loader" in loop \
                and self._loader is not None:
            # the loader cursor counts GLOBAL batches: it only stays
            # meaningful across a dp resize if the global batch is held
            if self.elastic_dp == "raise":
                raise MXNetError(
                    "checkpoint was written at dp=%d but this run is "
                    "dp=%d with a DataLoader cursor attached — a resize "
                    "silently breaks the data-cursor math unless the "
                    "GLOBAL batch size is held constant. Pass "
                    "ResilientLoop(elastic_dp='rescale') (or "
                    "MXNET_ELASTIC_DP_POLICY=rescale) to accept that "
                    "contract, or restart the data cursor."
                    % (saved_dp, cur_dp))
            warnings.warn(
                "elastic resume across dp=%d -> dp=%d: keeping the "
                "global-batch data cursor (rescale policy) — the caller "
                "must hold the global batch size constant"
                % (saved_dp, cur_dp))
        self._step.load_state_dict(tree["train"])
        self.consecutive_bad = int(loop.get("consecutive_bad", 0))
        self.bad_steps = int(loop.get("bad_steps", 0))
        self.rollbacks = int(loop.get("rollbacks", 0))
        self._lr_scale = float(loop.get("lr_scale", 1.0))
        self._epoch = int(loop.get("epoch", 0))
        if self._lr_scale != 1.0:
            self._install_lr_scale()
        if "loader" in loop and self._loader is not None:
            self._loader.load_state_dict(loop["loader"])

    def restore(self):
        """Auto-resume: load the newest intact checkpoint. Returns the
        restored step, or 0 on a cold start. In a world of several ranks
        the ranks must agree on the step (the manager already intersects
        their intact sets); a residual disagreement raises instead of
        cold-starting some ranks."""
        state = self._manager.restore_latest()
        step0 = 0
        if state is not None:
            step0, tree = state
        if _world_size() > 1:
            steps = _world_gather(int(step0))
            if min(steps) != max(steps):
                raise MXNetError(
                    "ranks disagree on the restored step (%s) — the "
                    "checkpoint directory must live on a filesystem "
                    "shared by every rank" % steps)
        if state is None:
            return 0
        self.load_state_dict(tree)
        if self.verbose:
            print("[resilient] resumed from step %d" % step0, flush=True)
        return step0

    def save(self, block=False):
        # device=True: the manager sees the sharded leaves and copies out
        # only what this rank owns; its host copies finish inside save(),
        # before the next step updates the state in place
        with telemetry.span("train.checkpoint_publish", category="train",
                            step=self._step.t, block=block):
            self._manager.save(self._step.t, self.state_dict(device=True),
                               block=block)
        self._last_save = (self._step.t, time.time())

    # -- the lifecycle ------------------------------------------------------
    @property
    def t(self):
        return self._step.t

    def step(self, x, y):
        """One guarded train step and the boundary protocol: bad-step
        policy, checkpoint cadence, chaos hooks, preemption drain.
        Returns the step's loss (a device tensor). The preemption check
        runs only after the step, so the saved data cursor always equals
        the trained-step count."""
        from ..utils import chaos as _chaos
        t_wall = time.perf_counter()
        with telemetry.span("train.step", category="train",
                            step=self._step.t + 1):
            with telemetry.span("train.device_step", category="train",
                                step=self._step.t + 1):
                loss = self._step(x, y)
            t = self._step.t
            # inside the timed step, so the straggler monitor sees it
            _chaos.maybe_slow_host(t)
            ok = True
            if self.policy != "off":
                ok = bool(self._step.last_step_ok)
                if ok:
                    self.consecutive_bad = 0
                else:
                    self._on_bad_step(t)
            dt = time.perf_counter() - t_wall
            self._m_step.observe(dt)
            shape = getattr(x, "shape", None)
            if shape and dt > 0:
                self._m_samples.set(shape[0] / dt)
                if len(shape) == 2:
                    self._m_tokens.set(shape[0] * shape[1] / dt)
            gnorm_val = None
            if self.policy != "off":
                gnorm_val = float(self._step.last_grad_norm)
                self._m_gnorm.set(gnorm_val)
            new_stragglers, anomalies = [], []
            if telemetry.enabled():
                if self._straggler is not None:
                    new_stragglers = self._straggler.observe(t, dt)
                if self._anomaly is not None:
                    anomalies = self._anomaly.observe(
                        t, loss=float(loss), grad_norm=gnorm_val)
            sup = self.supervisor
            if sup is not None:
                sup.note_batch(x, y)
                sup.on_step(t, stragglers=new_stragglers,
                            anomalies=anomalies)
            # cadence save only on GOOD steps (after a bad step or a
            # rollback the state is not step t's); an SDC quarantine
            # suppresses publishing entirely
            if ok and self.save_every and t % self.save_every == 0 \
                    and not (sup is not None and sup.suppress_saves):
                self.save()
        _chaos.maybe_sigterm(t)
        self._check_preempt()
        if sup is not None and sup.reconfigure_requested \
                and not self.preempted:
            self._check_reconfigure()
        # after the drain: a SIGKILLed host gets no drain at all
        _chaos.maybe_sigkill(t)
        return loss

    def _on_bad_step(self, t):
        self.bad_steps += 1
        self.consecutive_bad += 1
        self._m_bad.inc(step=t)
        gnorm = float(self._step.last_grad_norm)
        if self.verbose:
            print("[resilient] bad step %d (non-finite loss/grads, "
                  "|g|=%r) — policy=%s, consecutive=%d"
                  % (t, gnorm, self.policy, self.consecutive_bad),
                  flush=True)
        if self.policy == "raise":
            raise BadStepError(
                "step %d produced non-finite loss/gradients (|g|=%r)"
                % (t, gnorm))
        if self.policy == "rollback" and \
                self.consecutive_bad >= self.rollback_after:
            self._rollback()

    def _rollback(self):
        self._manager.wait(_barrier=False)  # don't race the async save
        state = self._manager.restore_latest()
        self.rollbacks += 1
        self._m_rollbacks.inc(step=self._step.t)
        self.consecutive_bad = 0
        if state is None:
            warnings.warn("rollback requested but no checkpoint exists — "
                          "continuing from current (guard-protected) state")
            return
        step0, tree = state
        # the restore rewinds model and data state; the process's fault
        # history (bad_steps, rollbacks, LR scale) survives it
        new_scale = self._lr_scale * self.lr_shrink
        keep = (self.bad_steps, self.rollbacks)
        self.load_state_dict(tree)
        self.bad_steps, self.rollbacks = keep
        self.consecutive_bad = 0
        self._lr_scale = new_scale
        if self.lr_shrink != 1.0:
            self._install_lr_scale()
        # the data cursor rewound: an in-flight batches() iterator must
        # re-enter the loader so replayed steps see the same batches
        self._iter_invalid = True
        if self.verbose:
            print("[resilient] rolled back to step %d (lr scale %.4g)"
                  % (step0, self._lr_scale), flush=True)

    def _check_preempt(self):
        w = self.watcher
        if w is None or not w.triggered or self.preempted:
            return
        self.preempted = True
        t = self._step.t
        self._m_preempt.inc(step=t)
        if self.verbose:
            print("[resilient] preemption notice — checkpointing step %d "
                  "(%.1fs grace left)" % (t, w.remaining_grace() or 0),
                  flush=True)
        self.save(block=True)
        self._manager.wait()
        w.cancel_deadline()
        if self.verbose:
            print("[resilient] checkpoint published; exiting with "
                  "relaunch code %d" % EXIT_PREEMPTED, flush=True)
        raise Preempted(t)

    def _check_reconfigure(self):
        """The remediation drain: the supervisor cordoned a host (or
        otherwise asked for a new world), so checkpoint at this boundary
        (unless an SDC quarantine forbids it), dump the black box and
        exit with EXIT_RECONFIGURE."""
        sup = self.supervisor
        t = self._step.t
        reason = sup.reconfigure_reason
        if sup.suppress_saves:
            if self.verbose:
                print("[resilient] reconfigure requested (%s) — SDC "
                      "quarantine active, exiting WITHOUT a drain "
                      "checkpoint (code %d)" % (reason,
                                                EXIT_RECONFIGURE),
                      flush=True)
        else:
            if self.verbose:
                print("[resilient] reconfigure requested (%s) — "
                      "checkpointing step %d and exiting with code %d"
                      % (reason, t, EXIT_RECONFIGURE), flush=True)
            self.save(block=True)
            self._manager.wait()
        telemetry.flight().record("event", "train.reconfigure_exit",
                                  reason=reason, step=t)
        telemetry.flight().dump("reconfigure")
        if sup.auditor is not None:
            sup.auditor.stop()
        if self.verbose and not sup.suppress_saves:
            print("[resilient] checkpoint published; exiting with "
                  "reconfigure code %d" % EXIT_RECONFIGURE, flush=True)
        raise Reconfigured(t, reason)

    # -- epochs -------------------------------------------------------------
    def batches(self):
        """Resume-aware batch stream over `epochs` passes of the loader,
        continuing mid-epoch after a restore; after a rollback the pass
        in flight is abandoned and the loader re-entered. Callers without
        a DataLoader derive each batch from the CURRENT step count
        (``while loop.t < N: loop.step(*batch(loop.t))``)."""
        if self._loader is None:
            raise MXNetError("ResilientLoop(loader=...) is required for "
                             "batches()")
        while self._epoch < self.epochs:
            self._iter_invalid = False
            it = iter(self._loader)
            exhausted = False
            while True:
                t0_us = time.perf_counter_ns() // 1000
                t0 = time.perf_counter()
                try:
                    batch = next(it)
                except StopIteration:
                    exhausted = True
                    break
                dt = time.perf_counter() - t0
                self._m_data_wait.observe(dt)
                telemetry.record_span("train.data_wait", t0_us,
                                      time.perf_counter_ns() // 1000
                                      - t0_us, category="train")
                yield batch
                if self._iter_invalid:
                    break
            if exhausted:
                self._epoch += 1

    def finish(self):
        """End of training: publish a final checkpoint and block until it
        is durable (and every rank arrived)."""
        self.save(block=True)
        self._manager.wait()
        if self.watcher is not None:
            self.watcher.uninstall()
        if self.supervisor is not None:
            self.supervisor.close()
        self.close_console()

    # -- live train console -------------------------------------------------
    def statusz(self):
        """The `/statusz` body: step-time percentiles, throughput,
        data-wait fraction, checkpoint age and bytes, the straggler skew
        table, anomaly counts, the collectives' ledger and the
        remediation block. No device work."""
        reg = telemetry.default_registry()
        snap = reg.snapshot()["metrics"]

        def hist(name):
            h = snap.get(name) or {}
            if not h.get("count"):
                return None
            return {"count": h["count"], "mean": h.get("mean"),
                    "p50": h.get("p50"), "p95": h.get("p95"),
                    "p99": h.get("p99")}

        def gauge(name):
            m = snap.get(name)
            return m.get("value") if m else None

        step_h = snap.get("train_step_seconds") or {}
        wait_h = snap.get("train_data_wait_seconds") or {}
        busy = float(step_h.get("sum") or 0.0)
        waited = float(wait_h.get("sum") or 0.0)
        wait_fraction = waited / (waited + busy) \
            if (waited + busy) > 0 else None
        step_p95 = (step_h.get("p95") if step_h.get("count") else None)
        ckpt = {"last_step": None, "age_s": None,
                "bytes_per_host": gauge("checkpoint_bytes_per_host")}
        if self._last_save is not None:
            ckpt["last_step"] = self._last_save[0]
            ckpt["age_s"] = round(time.time() - self._last_save[1], 3)
        return {
            "host": reg.labels().get("host"),
            "step": self.t,
            "epoch": self._epoch,
            "preempted": self.preempted,
            "step_seconds": hist("train_step_seconds"),
            "step_p95_ms": (round(step_p95 * 1e3, 3)
                            if step_p95 is not None else None),
            "samples_per_sec": gauge("train_samples_per_sec"),
            "tokens_per_sec": gauge("train_tokens_per_sec"),
            "data_wait_fraction": wait_fraction,
            "grad_norm": gauge("train_grad_norm"),
            "bad_steps": self.bad_steps,
            "rollbacks": self.rollbacks,
            "checkpoint": ckpt,
            "straggler": (self._straggler.status()
                          if self._straggler is not None else None),
            "anomalies": ({"count": self._anomaly.anomalies,
                           "last": {k: {"value": v[0], "z": v[1]}
                                    for k, v in
                                    self._anomaly.last.items()}}
                          if self._anomaly is not None else None),
            "comms": _comms(),
            "remediation": (self.supervisor.status()
                            if self.supervisor is not None else None),
        }

    def serve_metrics(self, port=0, host=None):
        """Start the train console: a stdlib HTTP daemon thread serving
        `/metrics` (Prometheus under `Accept: text/plain`, JSON
        otherwise), `/statusz` and `/healthz`, read-only. Binds
        MXNET_TRAIN_METRICS_HOST (default 127.0.0.1). Returns the bound
        (host, port), also kept on `console_addr`."""
        if host is None:
            host = os.environ.get("MXNET_TRAIN_METRICS_HOST",
                                  "127.0.0.1") or "127.0.0.1"
        if self._console is not None:
            return self.console_addr
        from ..serving.server import _HTTPFrontend
        loop = self

        class _TrainConsole(_HTTPFrontend):
            def submit(self, *a, **k):
                raise MXNetError("the train console is read-only "
                                 "(GET /metrics, /statusz, /healthz)")

            def snapshot(self):
                return telemetry.default_registry().snapshot()

            def prometheus_text(self):
                return telemetry.default_registry().prometheus_text()

            def health(self):
                return {"ok": True, "step": loop.t,
                        "host": telemetry.default_registry()
                        .labels().get("host"),
                        "preempted": loop.preempted}

            def statusz(self):
                return loop.statusz()

            def close(self):
                if self._httpd is not None:
                    self._httpd.shutdown()
                    self._httpd.server_close()
                    self._httpd = None

        self._console = _TrainConsole()
        self.console_addr = self._console.serve_http(host=host,
                                                     port=port,
                                                     block=False)
        if self.verbose:
            print("[resilient] train console on http://%s:%d "
                  "(/metrics /statusz /healthz)" % self.console_addr,
                  flush=True)
        return self.console_addr

    def close_console(self):
        if self._console is not None:
            self._console.close()
            self._console = None
