"""Training remediation supervisor: detect -> decide -> act (port of
`mxnet_tpu/parallel/supervisor.py`).

  * **Host cordoning + elastic restart** — a host flagged as a
    persistent straggler or an SDC suspect is written to a shared
    `CordonRoster` (a directory of atomic per-host JSON files beside the
    checkpoints; first writer wins). Every pod member's supervisor then
    asks for a RECONFIGURE: `ResilientLoop` checkpoints at the next step
    boundary, dumps its flight recorder and exits with `EXIT_RECONFIGURE`
    (84), and the relauncher (`tools/train_supervise.py`) rebuilds the
    world without the cordoned hosts through the elastic sharded restore.
    Cordoning never shrinks the pod below `MXNET_CORDON_MIN_HOSTS`.
  * **SDC parity probes** — every `MXNET_SDC_PROBE_EVERY` steps a
    deterministic probe (`TrainStep.probe`: fixed batch, fixed seed,
    nothing changed) computes this host's loss and grad norm; the hosts'
    digests are exchanged (`torch.distributed.all_gather_object` over a
    world of several ranks, an atomic-rename file exchange under
    `MXNET_SDC_PROBE_DIR` for emulated hosts) and a digest that differs
    from the strict-majority quorum names the corrupting host.
  * **Background checkpoint auditor** — `CheckpointAuditor` re-verifies
    published checkpoints against their manifests and demotes a step
    whose file no longer matches (`CheckpointManager.demote`), so no
    restore wastes its fallback walk on it. A missing file is not
    corruption (a peer may still be publishing).
  * **Signal intake** — `ResilientLoop.step` feeds straggler episodes,
    anomaly flags, host absence from the step-time exchange and
    checkpoint publish failures (`CheckpointManager.on_error`).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
import time

import numpy as np

from ..base import MXNetError
from .. import telemetry

#: metric names (the reference's)
SDC_PROBE_TOTAL = "train_sdc_probe_total"
SDC_SUSPECT_TOTAL = "train_sdc_suspect_total"
REMEDIATION_TOTAL = "train_remediation_actions_total"
CORDONS_TOTAL = "train_cordons_total"
CORDONED_GAUGE = "train_cordoned_hosts"
HOST_ABSENT_TOTAL = "train_host_absent_total"
AUDIT_TOTAL = "train_ckpt_audit_total"
AUDIT_FAILURES_TOTAL = "train_ckpt_audit_failures_total"


class CordonedHostError(MXNetError):
    """This host is on the cordon roster: the relauncher should never
    have launched it. Raised at supervisor construction so a cordoned
    host fails loudly at startup instead of rejoining the pod."""


def remediation_enabled():
    """MXNET_TRAIN_REMEDIATION=1 auto-attaches a TrainSupervisor to
    every ResilientLoop (default off: remediation acts, it does not
    just observe)."""
    return os.environ.get("MXNET_TRAIN_REMEDIATION", "0") == "1"


def _env_int(name, default, lo=0):
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        v = int(raw)
    except ValueError:
        raise ValueError("%s must be an integer, got %r" % (name, raw))
    if v < lo:
        raise ValueError("%s must be >= %d, got %r" % (name, lo, raw))
    return v


def _env_float(name, default, lo=0.0):
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    try:
        v = float(raw)
    except ValueError:
        raise ValueError("%s must be a number, got %r" % (name, raw))
    if v < lo:
        raise ValueError("%s must be >= %s, got %r" % (name, lo, raw))
    return v


def sdc_probe_every():
    """MXNET_SDC_PROBE_EVERY — steps between SDC parity probes
    (0/unset = off)."""
    return _env_int("MXNET_SDC_PROBE_EVERY", 0)


def sdc_probe_timeout():
    """MXNET_SDC_PROBE_TIMEOUT — seconds one probe waits for peer
    digests before judging with whoever answered (default 60; the
    emulated pod's hosts do not step in lockstep)."""
    return _env_float("MXNET_SDC_PROBE_TIMEOUT", 60.0)


def restart_max():
    """MXNET_TRAIN_RESTART_MAX — automatic relaunches the supervise
    relauncher grants before opening its circuit (default 3)."""
    return _env_int("MXNET_TRAIN_RESTART_MAX", 3)


def restart_backoff():
    """MXNET_TRAIN_RESTART_BACKOFF — base seconds of the relauncher's
    exponential backoff between restarts (default 0.5, mirroring the
    serving router's respawn_backoff)."""
    return _env_float("MXNET_TRAIN_RESTART_BACKOFF", 0.5)


def cordon_min_hosts():
    """MXNET_CORDON_MIN_HOSTS — the cordon floor: remediation never
    shrinks the pod below this many hosts (default 1)."""
    return _env_int("MXNET_CORDON_MIN_HOSTS", 1, lo=1)


def _frozen(v):
    """A copy of a batch that later steps cannot change, on its device."""
    import torch
    from ..ndarray import NDArray
    if isinstance(v, NDArray):
        v = v._data
    if isinstance(v, torch.Tensor):
        return v.detach().clone()
    return np.array(np.asarray(v))


def _safe_host(host):
    return "".join(c if c.isalnum() or c in "-_" else "_"
                   for c in str(host))


# ---------------------------------------------------------------------------
# cordon roster
# ---------------------------------------------------------------------------


class CordonRoster:
    """The shared cordon roster: a directory (by convention
    `<ckpt_dir>/cordon`) holding one `host-<label>.json` per cordoned
    host, each published with write-temp + atomic rename. One file per
    host makes concurrent cordons from different pod members race-free
    without a coordinator — the same medium the sharded checkpoints
    use. The relauncher reads the roster to size the next world; a
    launching worker checks it to refuse to rejoin (CordonedHostError).
    """

    def __init__(self, path):
        self.path = path

    @classmethod
    def beside(cls, ckpt_dir):
        """The conventional location: beside the checkpoints so the
        roster survives exactly as long as the run's durable state."""
        return cls(os.path.join(ckpt_dir, "cordon"))

    def _file(self, host):
        return os.path.join(self.path, "host-%s.json" % _safe_host(host))

    def cordon(self, host, reason="", step=None, detail=None):
        """Add `host` to the roster (idempotent). Returns True when this
        call created the entry (first writer), False when it already
        existed."""
        path = self._file(host)
        if os.path.exists(path):
            return False
        os.makedirs(self.path, exist_ok=True)
        tmp = path + ".tmp-%d" % os.getpid()
        entry = {"host": str(host), "reason": str(reason),
                 "step": None if step is None else int(step),
                 "detail": detail, "t": time.time()}
        with open(tmp, "w") as f:
            json.dump(entry, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return True

    def uncordon(self, host):
        """Operator override: remove `host` from the roster."""
        try:
            os.remove(self._file(host))
            return True
        except OSError:
            return False

    def is_cordoned(self, host):
        return os.path.exists(self._file(host))

    def hosts(self):
        """host -> roster entry, sorted by host label. Torn peer writes
        are skipped (the atomic rename makes them transient)."""
        out = {}
        try:
            names = os.listdir(self.path)
        except OSError:
            return out
        for name in sorted(names):
            if not (name.startswith("host-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.path, name)) as f:
                    entry = json.load(f)
                out[str(entry["host"])] = entry
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out

    def __len__(self):
        return len(self.hosts())


def effective_hosts(labels, roster):
    """The world the relauncher should build: `labels` minus the
    roster's cordoned hosts, order preserved — the "roster honored"
    contract the elastic-restart drill and the grown-world test pin."""
    cordoned = set(roster.hosts())
    return [l for l in labels if str(l) not in cordoned]


# ---------------------------------------------------------------------------
# SDC parity probes
# ---------------------------------------------------------------------------


class _FileDigestExchange:
    """Shared-directory digest exchange for EMULATED pods
    (MXNET_SDC_PROBE_DIR): each host publishes
    `sdc-<step>-host<label>.json` with an atomic rename, then POLLS
    until `expect` hosts have published for this probe step or
    `timeout_s` passes — the emulated hosts do not step in lockstep, so
    a quorum needs a wait, not a snapshot. A world of several ranks
    allgathers instead (the collective is the barrier)."""

    def __init__(self, dirpath, host, expect=2, timeout_s=None,
                 poll_s=0.05):
        self.dir = dirpath
        self.host = str(host)
        self.expect = max(1, int(expect))
        self.timeout_s = sdc_probe_timeout() if timeout_s is None \
            else float(timeout_s)
        self.poll_s = float(poll_s)
        self._last_step = None

    def _path(self, step, host):
        return os.path.join(self.dir, "sdc-%d-host%s.json"
                            % (int(step), _safe_host(host)))

    def __call__(self, step, digest):
        try:
            os.makedirs(self.dir, exist_ok=True)
            tmp = self._path(step, self.host) + ".tmp%d" % os.getpid()
            with open(tmp, "w") as f:
                json.dump({"host": self.host, "digest": str(digest),
                           "step": int(step), "t": time.time()}, f)
            os.replace(tmp, self._path(step, self.host))
            # prune this host's probe files older than the previous probe
            # (bounded litter). The previous one stays: a peer still
            # polling that probe has not read it yet (a host passes a
            # probe only once it read every digest of it, so no peer is
            # further behind)
            keep = {int(step), self._last_step}
            self._last_step = int(step)
            suffix = "host%s.json" % _safe_host(self.host)
            for name in os.listdir(self.dir):
                m = re.match(r"^sdc-(\d+)-" + re.escape(suffix) + "$",
                             name)
                if m and int(m.group(1)) not in keep:
                    try:
                        os.remove(os.path.join(self.dir, name))
                    except OSError:
                        pass
        except OSError:
            pass                      # a missed publish skews one probe
        prefix = "sdc-%d-host" % int(step)
        deadline = time.monotonic() + self.timeout_s
        out = {self.host: str(digest)}
        while True:
            try:
                names = os.listdir(self.dir)
            except OSError:
                names = []
            for name in names:
                if not (name.startswith(prefix)
                        and name.endswith(".json")):
                    continue
                try:
                    with open(os.path.join(self.dir, name)) as f:
                        doc = json.load(f)
                    out[str(doc["host"])] = str(doc["digest"])
                except (OSError, ValueError, KeyError, TypeError):
                    continue          # torn peer write: retry next poll
            if len(out) >= self.expect or time.monotonic() >= deadline:
                return out
            time.sleep(self.poll_s)


def _default_digest_exchange(host, expect, timeout_s=None):
    """The probe-digest exchange seam, mirroring the straggler
    monitor's: an allgather of (host, digest) over a world of several
    ranks; `MXNET_SDC_PROBE_DIR` for emulated hosts sharing a directory;
    otherwise local only (one host has no quorum)."""
    from .resilient import _world_gather, _world_size
    if _world_size() > 1:
        def gather(step, digest):
            return {str(h): str(d) for h, d in
                    _world_gather((str(host), str(digest)))}
        return gather
    sdir = os.environ.get("MXNET_SDC_PROBE_DIR")
    if sdir:
        return _FileDigestExchange(sdir, host, expect=expect,
                                   timeout_s=timeout_s)
    return lambda step, digest: {str(host): str(digest)}


class SDCProbe:
    """Cross-host silent-data-corruption parity probe. `run(step)`
    executes the deterministic probe function, digests its floats,
    exchanges digests with the pod, and returns the
    hosts whose digest diverges from the strict-majority quorum. The
    chaos seam `utils.chaos.sdc_poison` perturbs THIS host's values
    before digesting when `MXNET_CHAOS_SDC_AT` names it — the injected
    bad chip of the supervised drill."""

    def __init__(self, probe_fn, every, host=None, expect=2,
                 exchange=None, timeout_s=None, registry=None):
        self.every = int(every)
        self._fn = probe_fn
        self.host = str(host if host is not None
                        else telemetry.metrics._host_label())
        self._exchange = exchange or _default_digest_exchange(
            self.host, expect, timeout_s)
        self._registry = registry
        self.probes = 0
        self.suspects = {}            # host -> times flagged (lifetime)
        self.last = None              # the last probe's full verdict
        #: newest probe step at which the assembled digests (>= 2) all
        #: agreed — the restore horizon the SDC quarantine trusts
        self.last_clean_step = 0

    def _reg(self):
        return self._registry or telemetry.default_registry()

    @staticmethod
    def digest(values):
        """Canonical digest of the probe's named floats: full-precision
        %.17g rendering so two bit-identical computations digest
        identically and ANY ulp of silent corruption flips it."""
        text = ",".join("%s=%.17g" % (k, float(values[k]))
                        for k in sorted(values))
        return hashlib.sha256(text.encode()).hexdigest()

    def run(self, step):
        """One probe: compute, digest, exchange, judge. Returns the
        suspect host labels (never this probe's quorum members)."""
        from ..utils import chaos as _chaos
        with telemetry.span("train.sdc_probe", category="train",
                            step=step):
            values = dict(self._fn())
            if _chaos.sdc_poison(step):
                # finite, tiny, and fatal: one ulp would do — the digest
                # is exact — but a relative nudge keeps the flip robust
                # to any downstream rounding of the rendered floats
                values = {k: float(v) + (1e-3 * abs(float(v)) + 1e-6)
                          for k, v in values.items()}
            mine = self.digest(values)
            peers = self._exchange(step, mine)
        self.probes += 1
        if telemetry.enabled():
            self._reg().counter(
                SDC_PROBE_TOTAL,
                help="deterministic SDC parity probes run by this host"
            ).inc()
        suspects = self._judge(step, peers)
        # copy-on-write for the console's HTTP thread
        self.last = {"step": int(step), "digest": mine,
                     "hosts": dict(peers), "suspects": list(suspects)}
        return suspects

    def _judge(self, step, peers):
        if len(peers) < 2 or len(set(peers.values())) == 1:
            if len(peers) >= 2:
                self.last_clean_step = int(step)
            return []
        counts = {}
        for d in peers.values():
            counts[d] = counts.get(d, 0) + 1
        best = max(counts.values())
        majority = [d for d, c in counts.items() if c == best]
        if len(majority) != 1 or best * 2 <= len(peers):
            # divergence with no strict majority (a 2-host pod split
            # 1-1): record it — an operator page, never a guess
            telemetry.flight().record(
                "event", "train.sdc", host=None, quorum=False,
                step=int(step), hosts=len(peers),
                digests=len(counts))
            return []
        quorum = majority[0]
        suspects = sorted(h for h, d in peers.items() if d != quorum)
        reg = self._reg()
        for h in suspects:
            self.suspects = dict(self.suspects,
                                 **{h: self.suspects.get(h, 0) + 1})
            if telemetry.enabled():
                reg.counter(
                    SDC_SUSPECT_TOTAL, flight=True,
                    help="hosts whose SDC parity-probe digest diverged "
                         "from the pod quorum"
                ).inc(host=h, step=int(step))
            telemetry.flight().record(
                "event", "train.sdc", host=h, quorum=True,
                step=int(step), hosts=len(peers))
        return suspects

    def status(self):
        return {"every": self.every, "probes": self.probes,
                "suspects": dict(self.suspects),
                "last_clean_step": self.last_clean_step,
                "last": self.last}


# ---------------------------------------------------------------------------
# background checkpoint auditor
# ---------------------------------------------------------------------------


class CheckpointAuditor:
    """Low-priority re-verification of PUBLISHED checkpoints: a daemon
    thread re-reads each retained step's existing files every
    `interval_s` and re-checks size + sha256
    against the manifests — the bit-rot / torn-write window between a
    clean publish and the restore that needs it. A file that no longer
    verifies demotes its whole step (`CheckpointManager.demote`) so
    `restore_latest()` never sees it. Missing files are NOT corruption:
    a peer host may still be publishing its shard, and restore already
    refuses incomplete steps."""

    def __init__(self, manager, interval_s=5.0, reaudit_every_s=300.0,
                 registry=None):
        self._mgr = manager
        self.interval_s = float(interval_s)
        #: how long one file's clean verification is trusted before it
        #: is re-hashed. The short wake interval keeps FRESH publishes
        #: verified promptly; this cadence bounds steady-state IO —
        #: re-hashing unchanged multi-GB shards every wake would
        #: compete with the data pipeline for the whole run. A file
        #: whose size or mtime changed re-verifies immediately.
        self.reaudit_every_s = float(reaudit_every_s)
        self._registry = registry
        self._verified = {}           # path -> (size, mtime_ns, t)
        self._stop = threading.Event()
        self._thread = None
        self.audits = 0               # steps verified (lifetime)
        self.demoted = []             # steps demoted (lifetime)

    def _reg(self):
        return self._registry or telemetry.default_registry()

    def start(self):
        if self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ckpt-auditor")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.audit_once()
            except Exception:
                # the auditor must never take training down with it
                pass

    def _needs_verify(self, path):
        """True when `path` warrants a (re)hash: never verified, changed
        on disk since (size/mtime), or its clean verification aged past
        `reaudit_every_s`."""
        try:
            st = os.stat(path)
        except OSError:
            return False
        rec = self._verified.get(path)
        return not (rec is not None and rec[0] == st.st_size
                    and rec[1] == st.st_mtime_ns
                    and time.monotonic() - rec[2] < self.reaudit_every_s)

    def _mark_verified(self, path):
        try:
            st = os.stat(path)
        except OSError:
            return
        self._verified[path] = (st.st_size, st.st_mtime_ns,
                                time.monotonic())

    def _audit_step(self, step):
        """Verify every EXISTING file of `step`. Raises ValueError on a
        file that is present but fails its manifest — the only shape
        that demotes."""
        mgr = self._mgr
        g = mgr.global_manifest(step)     # corrupt JSON -> ValueError
        if g is not None and g.get("format") == "sharded":
            for fname in g.get("files", []):
                path = os.path.join(mgr.directory, fname)
                side = path[:-len(".npz")] + ".manifest.json"
                # sidecar missing = mid-publish (the npz replaces before
                # its sidecar) or an absent peer — not corruption
                if os.path.exists(path) and os.path.exists(side) \
                        and self._needs_verify(path):
                    mgr._verify_shard(path)
                    self._mark_verified(path)
            return
        path = os.path.join(mgr.directory, "ckpt-%d.npz" % step)
        if os.path.exists(path) and self._needs_verify(path):
            mgr._verify_manifest(step, path)
            self._mark_verified(path)

    def audit_once(self):
        """One audit pass over every retained step; returns the steps
        demoted by this pass."""
        demoted = []
        for step in self._mgr.all_steps():
            try:
                self._audit_step(step)
                self.audits += 1
                if telemetry.enabled():
                    self._reg().counter(
                        AUDIT_TOTAL,
                        help="published checkpoint steps re-verified by "
                             "the background auditor").inc()
            except ValueError as e:
                if not self._mgr.step_files(step):
                    continue          # pruned mid-audit, not corruption
                self._mgr.demote(step, reason=str(e))
                demoted.append(step)
                self.demoted.append(step)
                if telemetry.enabled():
                    self._reg().counter(
                        AUDIT_FAILURES_TOTAL, flight=True,
                        help="published checkpoints the auditor caught "
                             "failing re-verification (demoted before "
                             "any restore saw them)"
                    ).inc(step=int(step))
            except OSError:
                continue              # transient IO: next pass retries
        # drop cache entries for pruned/demoted files (bounded memory)
        self._verified = {p: v for p, v in self._verified.items()
                          if os.path.exists(p)}
        return demoted

    def status(self):
        return {"interval_s": self.interval_s, "audits": self.audits,
                "demoted": list(self.demoted)}


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------


class TrainSupervisor:
    """The remediation supervisor: consumes the detector signals
    at `ResilientLoop`'s step boundary and executes the bounded actions
    above. Construct it around a live loop (it attaches itself as
    `loop.supervisor`), or set MXNET_TRAIN_REMEDIATION=1 and the loop
    attaches one automatically.

    Parameters
    ----------
    loop : ResilientLoop
    roster : CordonRoster, optional
        Defaults to `CordonRoster.beside(manager.directory)`.
    probe_every : int, optional
        SDC probe cadence in steps (default MXNET_SDC_PROBE_EVERY;
        0 = no probes).
    probe_batch : (x, y), optional
        The FIXED probe batch. Must be byte-identical on every host —
        the cross-host digest contract. When omitted, the supervisor
        captures the first batch the loop trains on, which is only
        correct when the data pipeline is host-replicated (the emulated
        pod); real pods sharding a global batch per host must pass the
        common probe batch explicitly.
    probe_fn : callable, optional
        Overrides the probe entirely: () -> {name: float}. Wins over
        probe_batch.
    straggler_cordon_after : int
        Straggler EPISODES tolerated before the host is cordoned
        (default 1: the monitor's patience already debounced windows).
    publish_failure_max : int
        Consecutive checkpoint publish failures before THIS host
        cordons itself (its storage path is the broken part; default 3).
    min_hosts : int, optional
        Cordon floor (default MXNET_CORDON_MIN_HOSTS).
    audit : bool
        Start the background CheckpointAuditor (default True).
    expect_hosts : int, optional
        Pod size the SDC quorum expects (default the manager's
        process_count).
    """

    def __init__(self, loop, roster=None, probe_every=None,
                 probe_batch=None, probe_fn=None, exchange=None,
                 straggler_cordon_after=1, publish_failure_max=3,
                 min_hosts=None, audit=True, audit_interval_s=5.0,
                 expect_hosts=None, host=None, registry=None):
        self._loop = loop
        self._manager = loop._manager
        self._registry = registry
        self.host = str(host if host is not None
                        else telemetry.metrics._host_label())
        self.roster = roster if roster is not None \
            else CordonRoster.beside(self._manager.directory)
        if self.roster.is_cordoned(self.host):
            raise CordonedHostError(
                "host %r is on the cordon roster at %s (reason: %s) — "
                "the relauncher must exclude it; uncordon() to "
                "reinstate" % (self.host, self.roster.path,
                               (self.roster.hosts().get(self.host) or {})
                               .get("reason")))
        # entries already on the roster at startup belong to PREVIOUS
        # incarnations: the relauncher excluded those hosts from this
        # world, so they are (a) already outside expect_hosts — never
        # re-subtracted by the cordon floor — and (b) stale for drain
        # purposes — a fresh entry is a member of THIS world leaving
        self._initial_cordoned = set(self.roster.hosts())
        self.min_hosts = cordon_min_hosts() if min_hosts is None \
            else max(1, int(min_hosts))
        self.straggler_cordon_after = max(1, int(straggler_cordon_after))
        self.publish_failure_max = max(1, int(publish_failure_max))
        self._expect = int(expect_hosts
                           if expect_hosts is not None
                           else self._manager.process_count)
        self._probe_every = sdc_probe_every() if probe_every is None \
            else int(probe_every)
        self._probe_batch = probe_batch
        self._probe_fn = probe_fn
        self._exchange = exchange
        self.probe = None             # built lazily (needs a batch)
        self.auditor = None
        if audit:
            self.auditor = CheckpointAuditor(
                self._manager, interval_s=audit_interval_s,
                registry=registry).start()
        self.reconfigure_requested = False
        self.reconfigure_reason = None
        #: armed by the SDC quarantine: the loop must publish NOTHING
        #: further this incarnation (cadence saves and the reconfigure
        #: drain save) — the suspect window's state must not become the
        #: checkpoint the relaunch restores
        self.suppress_saves = False
        self.actions = []             # [(step, action, target, reason)]
        self.publish_failures = 0     # consecutive
        self._straggler_episodes = {}
        self._hosts_seen = set()
        self._absent = {}
        self._absent_flagged = set()
        self._last_windows = 0
        # wire the publish-outcome signals (best-effort: managers
        # without the hooks just skip them)
        if hasattr(self._manager, "on_error"):
            self._manager.on_error = self._on_publish_error
        if hasattr(self._manager, "on_success"):
            self._manager.on_success = self.on_publish_ok
        loop.supervisor = self

    def _reg(self):
        return self._registry or telemetry.default_registry()

    def _record_action(self, step, action, target, reason):
        self.actions.append({"step": int(step), "action": action,
                             "target": target, "reason": reason,
                             "t": time.time()})
        if telemetry.enabled():
            self._reg().counter(
                REMEDIATION_TOTAL, flight=True,
                help="remediation actions executed by the training "
                     "supervisor (cordon, reconfigure, self-cordon)"
            ).inc(action=action, target=target, reason=reason,
                  step=int(step))

    # -- signal intake (ResilientLoop.step calls these) ---------------------
    def note_batch(self, x, y):
        """First-batch capture for the default SDC probe (see
        `probe_batch` above for the host-replication contract)."""
        if self._probe_batch is None and self._probe_fn is None \
                and self._probe_every > 0:
            self._probe_batch = (_frozen(x), _frozen(y))

    def on_step(self, step, stragglers=(), anomalies=()):
        """One step boundary's worth of detector signals."""
        for h in stragglers:
            self.on_straggler(h, step)
        for sig in anomalies:
            # the bad-step guard + rollback policy own the numeric
            # response; the supervisor keeps the ledger so the anomaly
            # shows up beside the actions it may precede
            self.actions.append({"step": int(step), "action": "observe",
                                 "target": str(sig), "reason": "anomaly",
                                 "t": time.time()})
        self._watch_absence(step)
        if self._probe_every > 0 and step > 0 \
                and step % self._probe_every == 0:
            for h in self.run_probe(step):
                self.consider_cordon(h, "sdc", step)

    def on_straggler(self, host, step):
        """A StragglerMonitor episode onset for `host`."""
        n = self._straggler_episodes.get(str(host), 0) + 1
        self._straggler_episodes[str(host)] = n
        if n >= self.straggler_cordon_after:
            self.consider_cordon(host, "straggler", step)

    def _watch_absence(self, step):
        mon = getattr(self._loop, "_straggler", None)
        if mon is None or mon.last_window is None:
            return
        if mon.windows == self._last_windows:
            return                    # judge once per closed window
        self._last_windows = mon.windows
        present = {str(h) for h in mon.last_window}
        self._hosts_seen |= present
        for h in sorted(self._hosts_seen - present):
            self._absent[h] = self._absent.get(h, 0) + 1
            if self._absent[h] == 2 and h not in self._absent_flagged:
                # two consecutive silent windows: the peer stopped
                # publishing — dead host or severed exchange. Recorded,
                # not cordoned: relaunching the dead host is the
                # RELAUNCHER's job (it sees the exit), and cordoning a
                # host that may be mid-relaunch would evict it twice.
                self._absent_flagged.add(h)
                if telemetry.enabled():
                    self._reg().counter(
                        HOST_ABSENT_TOTAL, flight=True,
                        help="hosts that vanished from the step-time "
                             "exchange for 2+ consecutive windows"
                    ).inc(host=h, step=int(step))
                telemetry.flight().record(
                    "event", "train.host_absent", host=h,
                    step=int(step), windows=self._absent[h])
        for h in present:
            self._absent.pop(h, None)
            self._absent_flagged.discard(h)

    def _on_publish_error(self, exc):
        """CheckpointManager calls this when a (possibly async) publish
        ultimately failed. Consecutive failures past the budget cordon
        THIS host: its storage path is the broken part, and a pod
        member that cannot checkpoint is a liability to every restore."""
        self.publish_failures += 1
        telemetry.flight().record(
            "event", "train.publish_failure", host=self.host,
            consecutive=self.publish_failures, error=str(exc)[:200])
        if self.publish_failures >= self.publish_failure_max:
            self.consider_cordon(self.host, "ckpt_publish",
                                 self._loop.t,
                                 detail=str(exc)[:200])

    def on_publish_ok(self):
        self.publish_failures = 0

    # -- SDC probes ---------------------------------------------------------
    def run_probe(self, step):
        if self.probe is None:
            self.probe = self._build_probe()
        if self.probe is None:
            return []
        return self.probe.run(step)

    def _build_probe(self):
        fn = self._probe_fn
        if fn is None:
            batch = self._probe_batch
            if batch is None:
                return None           # nothing deterministic to probe
            step_obj = self._loop._step

            def fn():
                loss, gnorm = step_obj.probe(*batch)
                return {"loss": loss, "grad_norm": gnorm}
        return SDCProbe(fn, self._probe_every, host=self.host,
                        expect=self._expect, exchange=self._exchange,
                        registry=self._registry)

    # -- actions ------------------------------------------------------------
    def consider_cordon(self, host, reason, step, detail=None):
        """The cordon decision: bounded by the min-hosts floor, and
        followed by a reconfigure request when the roster actually
        gained a member — a pod with a FRESHLY cordoned host must
        shrink at the next boundary. A host already on the roster is a
        no-op: the world that excludes it is the relauncher's job, and
        a stale detector signal about it (e.g. its last straggler
        publishes surviving into the relaunched incarnation) must not
        re-drain the shrunk pod forever."""
        host = str(host)
        roster_now = self.roster.hosts()
        if host in roster_now:
            if host in self._initial_cordoned and host != self.host:
                # a PREVIOUS incarnation's entry: the relauncher already
                # excluded this host from my world, and stale detector
                # signals about it (its last straggler publishes
                # surviving the relaunch) must not re-drain the shrunk
                # pod forever
                return False
            # a FRESH entry — a peer beat me to the roster write for a
            # member of THIS world (possibly me). Every member must
            # still drain: a pod can only shrink together, and a
            # cordoned host training on is wasted (SDC-suspect) work
            # whose black box never dumps. No livelock: a fresh entry's
            # host never relaunches into the next world.
            if reason == "sdc":
                self._sdc_quarantine(step)
            self.request_reconfigure(
                "%s:%s" % (roster_now[host].get("reason", reason),
                           host), step=step)
            return True
        # cordon floor: entries from previous incarnations are already
        # outside self._expect (the relauncher shrank the world), so
        # only entries FRESH in this incarnation reduce the survivors
        fresh = [h for h in roster_now if h not in self._initial_cordoned]
        survivors = self._expect - len(fresh) - 1
        if survivors < self.min_hosts:
            telemetry.flight().record(
                "event", "train.cordon_refused", host=host,
                reason=reason, step=int(step),
                min_hosts=self.min_hosts)
            self._record_action(step, "cordon_refused", host, reason)
            return False
        created = self.roster.cordon(host, reason=reason, step=step,
                                     detail=detail)
        if created and telemetry.enabled():
            self._reg().counter(
                CORDONS_TOTAL, flight=True,
                help="hosts written to the cordon roster by this "
                     "supervisor").inc(host=host, reason=reason,
                                       step=int(step))
        telemetry.flight().record(
            "event", "train.cordon", host=host, reason=reason,
            step=int(step), first_writer=bool(created))
        self._record_action(step, "cordon", host, reason)
        if telemetry.enabled():
            self._reg().gauge(
                CORDONED_GAUGE,
                help="hosts currently on the cordon roster"
            ).set(len(self.roster.hosts()))
        if reason == "sdc":
            self._sdc_quarantine(step)
        self.request_reconfigure("%s:%s" % (reason, host), step=step)
        return True

    def _sdc_quarantine(self, step):
        """An SDC suspect means every checkpoint newer than the last
        CLEAN probe may hold finite-but-wrong shards (under sharded
        checkpoints the suspect's slice has no other copy). Response:
        stop publishing (this incarnation's saves — cadence AND the
        reconfigure drain — are suppressed) and demote the steps the
        corruption window covers, so the relaunch restores the newest
        step the quorum certified. Steps lost are bounded by the probe
        cadence — the documented price of the probes' guarantee."""
        if self.suppress_saves:
            return
        self.suppress_saves = True
        safe = self.probe.last_clean_step if self.probe is not None \
            else 0
        demoted = []
        for s in self._manager.all_steps():
            if s > safe and self._manager.demote(
                    s, reason="sdc quarantine (newer than last clean "
                              "probe %d)" % safe):
                demoted.append(s)
        telemetry.flight().record(
            "event", "train.sdc_quarantine", safe_step=int(safe),
            demoted=demoted, step=int(step))
        self._record_action(step, "sdc_quarantine",
                            "steps>%d" % safe, "sdc")

    def request_reconfigure(self, reason, step=None):
        """Arm the loop's reconfigure drain: checkpoint at the next
        step boundary, flight-dump, exit EXIT_RECONFIGURE (84)."""
        if self.reconfigure_requested:
            return
        self.reconfigure_requested = True
        self.reconfigure_reason = str(reason)
        step = self._loop.t if step is None else step
        telemetry.flight().record(
            "event", "train.reconfigure", reason=self.reconfigure_reason,
            step=int(step), cordoned=sorted(self.roster.hosts()))
        self._record_action(step, "reconfigure", self.host, reason)

    # -- console / teardown -------------------------------------------------
    def status(self):
        """The /statusz remediation block (train_top renders it)."""
        return {
            "host": self.host,
            "cordoned": {h: {"reason": e.get("reason"),
                             "step": e.get("step")}
                         for h, e in self.roster.hosts().items()},
            "min_hosts": self.min_hosts,
            "reconfigure": {"requested": self.reconfigure_requested,
                            "reason": self.reconfigure_reason},
            "publish_failures": self.publish_failures,
            "sdc": self.probe.status() if self.probe is not None
            else {"every": self._probe_every, "probes": 0,
                  "suspects": {}, "last": None},
            "audit": self.auditor.status() if self.auditor is not None
            else None,
            "actions": list(self.actions[-20:]),
        }

    def close(self):
        if self.auditor is not None:
            self.auditor.stop()
        if hasattr(self._manager, "on_error") \
                and self._manager.on_error == self._on_publish_error:
            self._manager.on_error = None
