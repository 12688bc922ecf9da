"""Fault injection for the resilience drills (port of
`mxnet_tpu/utils/chaos.py`).

Production code calls the tiny hook functions below (no-ops when chaos
is off); tests and `mxnet_tpu_torch.tools.chaos_train` arm them
programmatically (`configure(...)`) or through environment variables,
the path that lets a subprocess be faulted without code changes.

TRAINING faults are keyed by the trainer's post-increment step counter
(`TrainStep.t`, 1-based, the value `ResilientLoop` reports) and fire at
most once a process:

  MXNET_CHAOS_KILL_SAVE=<step>     hard-exit (os._exit(43)) in the middle
                                   of the checkpoint write for <step>,
                                   after the temp file holds bytes but
                                   BEFORE the atomic publish.
  MXNET_CHAOS_CORRUPT_CKPT=<step>  after checkpoint <step> publishes,
                                   truncate it to half its bytes.
  MXNET_CHAOS_NAN_STEP=<step>      add NaN to step <step>'s gradients
                                   inside the train step (the bad-step
                                   guard's quarry).
  MXNET_CHAOS_SPIKE_STEP=<step>    add a large FINITE value (1e6) to step
                                   <step>'s gradients: the guard stays
                                   green while the grad norm explodes
                                   (the anomaly detector's quarry).
  MXNET_CHAOS_SIGTERM_AT=<step>    deliver SIGTERM to this process after
                                   step <step> (a preemption notice).
  MXNET_CHAOS_SIGKILL_AT=<step>    deliver SIGKILL after step <step>: a
                                   host dying with no drain.
  MXNET_CHAOS_SLOW_HOST=<host>:<secs>[:<from_step>]
                                   sleep <secs> at EVERY step boundary
                                   (from <from_step>, default 1) on the
                                   process whose MXNET_HOST_ID is <host>:
                                   the straggler. Unlatched; the first
                                   firing records one flight event.
  MXNET_CHAOS_SDC_AT=<host>:<step> flip the SDC parity probe's digest on
                                   the process whose MXNET_HOST_ID is
                                   <host>, at the first probe with step
                                   >= <step>: silent data corruption.

SERVING faults target one replica's serving loop and are keyed
`<replica>:<iteration>` — the loop iteration counter of THAT LMServer
instance. A fault fires at the FIRST opportunity with iteration >= the
armed one (some hook sites only run under load), then latches
(serve_crash_loop excepted):

  MXNET_CHAOS_SERVE_KILL=<r>:<i>        raise inside replica r's serving
                                        loop at iteration i (outside the
                                        engine-fault isolation): the loop
                                        DIES.
  MXNET_CHAOS_SERVE_CRASH_LOOP=<r>:<i>  same, but NOT latched: every
                                        instance of replica r dies again
                                        at its iteration i.
  MXNET_CHAOS_SERVE_WEDGE=<r>:<i>[:<s>] sleep s seconds (default 2.0)
                                        inside the loop: a stale beat
                                        with the thread alive.
  MXNET_CHAOS_SERVE_POISON=<r>:<i>      poison one decode step (raises
                                        inside the engine-fault try):
                                        the batch's requests are resumed,
                                        the loop survives.
  MXNET_CHAOS_SERVE_SPEC_POISON=<r>:<i> NaN-fill one iteration's DRAFT
                                        logits on a speculating replica:
                                        the engine degrades that batch to
                                        the non-speculative path,
                                        token-identical.
  MXNET_CHAOS_SERVE_EXHAUST=<r>:<i>[:<n>] steal every free block of the
                                        replica's pool for n loop
                                        iterations (default 20):
                                        transient exhaustion, requests
                                        queue instead of failing.

  MXNET_CHAOS_SERVE_ROLLOUT_CORRUPT=<step>:<file_index>
                                        bit-flip one byte mid-file in
                                        live-rollout candidate <step>'s
                                        payload file #<file_index>,
                                        AFTER its manifest published:
                                        bitrot between publish and
                                        canary, which the rollout
                                        verification (or the parity
                                        gate's digest probe) must
                                        quarantine before any user
                                        traffic. Exact step, latched.
  MXNET_CHAOS_SERVE_ROLLOUT_SLOW_CANARY=<r>:<i>[:<secs>]
                                        sleep <secs> (default 0.05) on
                                        replica r's EVERY loop iteration
                                        >= i: a healthy-but-slow canary
                                        the rollout judge must roll back
                                        on its SLO burn instead of
                                        promoting. Unlatched like
                                        slow_host; the first firing
                                        records one flight event.
"""
from __future__ import annotations

import os
import signal
import time

_FAULTS = ("kill_save", "corrupt_ckpt", "nan_step", "sigterm_at",
           "sigkill_at", "spike_step")

#: `<host>:<secs>[:<from_step>]` — per-step sleep on one host
_HOST_FAULTS = ("slow_host",)

#: `<host>:<step>` — faults targeting one host at one step
_HOST_STEP_FAULTS = ("sdc_at",)

#: the finite gradient poison `spike_step` adds: big enough that the
#: EWMA z-score on the grad norm flags it, small enough that its square
#: in the norm stays finite (the NaN/Inf guard does NOT trip)
SPIKE_POISON = 1.0e6

#: serving faults: value is (replica, iteration[, extra]) — parsed from
#: "r:i[:x]" env strings or passed as tuples to configure()
_SERVE_FAULTS = ("serve_kill", "serve_crash_loop", "serve_wedge",
                 "serve_poison", "serve_spec_poison", "serve_exhaust",
                 "serve_rollout_corrupt", "serve_rollout_slow_canary")


class ChaosReplicaKilled(RuntimeError):
    """The injected serving-loop death (serve_kill / serve_crash_loop):
    raised from inside the loop, OUTSIDE the engine-fault isolation, so
    the loop's catch-all sees a dying thread exactly like a real bug."""

_conf = {}          # fault name -> step / (replica, iteration[, extra])
_fired = set()      # fault names that already triggered in this process
_env_loaded = False


def _parse_serve(name, val):
    """(replica, iteration[, extra]) out of an "r:i[:x]" string or a
    tuple/list; extra stays a float (wedge seconds / exhaust hold)."""
    if isinstance(val, (tuple, list)):
        parts = list(val)
    else:
        parts = str(val).split(":")
    if len(parts) not in (2, 3):
        raise ValueError(
            "%s must be <replica>:<iteration>[:<extra>], got %r"
            % (name, val))
    try:
        out = [int(parts[0]), int(parts[1])]
        if len(parts) == 3:
            out.append(float(parts[2]))
    except (TypeError, ValueError):
        raise ValueError(
            "%s must be <replica>:<iteration>[:<extra>], got %r"
            % (name, val))
    return tuple(out)


def _parse_host(name, val):
    """(host, secs[, from_step]) out of `<host>:<secs>[:<from_step>]`
    (host stays a string — MXNET_HOST_ID labels are strings)."""
    if isinstance(val, (tuple, list)):
        parts = list(val)
    else:
        parts = str(val).split(":")
    if len(parts) not in (2, 3):
        raise ValueError("%s must be <host>:<secs>[:<from_step>], got %r"
                         % (name, val))
    try:
        out = [str(parts[0]), float(parts[1])]
        if len(parts) == 3:
            out.append(int(parts[2]))
    except (TypeError, ValueError):
        raise ValueError("%s must be <host>:<secs>[:<from_step>], got %r"
                         % (name, val))
    return tuple(out)


def _parse_host_step(name, val):
    """(host, step) out of `<host>:<step>` (step is a 1-based int)."""
    if isinstance(val, (tuple, list)):
        parts = list(val)
    else:
        parts = str(val).split(":")
    if len(parts) != 2:
        raise ValueError("%s must be <host>:<step>, got %r" % (name, val))
    try:
        return (str(parts[0]), int(parts[1]))
    except (TypeError, ValueError):
        raise ValueError("%s must be <host>:<step>, got %r" % (name, val))


def _load_env():
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    for name in _FAULTS:
        val = os.environ.get("MXNET_CHAOS_" + name.upper())
        if val:
            try:
                _conf.setdefault(name, int(val))
            except ValueError:
                raise ValueError("MXNET_CHAOS_%s must be an integer step, "
                                 "got %r" % (name.upper(), val))
    for names, parse in ((_SERVE_FAULTS, _parse_serve),
                         (_HOST_FAULTS, _parse_host),
                         (_HOST_STEP_FAULTS, _parse_host_step)):
        for name in names:
            val = os.environ.get("MXNET_CHAOS_" + name.upper())
            if val:
                _conf.setdefault(name, parse(
                    "MXNET_CHAOS_" + name.upper(), val))


def configure(**faults):
    """Arm faults programmatically: configure(nan_step=7, sigterm_at=12)
    or, for serving faults, configure(serve_kill=(replica, iteration)).
    A value of None disarms. Returns the active config."""
    _load_env()
    known = _FAULTS + _SERVE_FAULTS + _HOST_FAULTS + _HOST_STEP_FAULTS
    for name, val in faults.items():
        if name not in known:
            raise ValueError("unknown chaos fault %r (know %s)"
                             % (name, ", ".join(known)))
        if val is None:
            _conf.pop(name, None)
            _fired.discard(name)
        elif name in _SERVE_FAULTS:
            _conf[name] = _parse_serve(name, val)
        elif name in _HOST_FAULTS:
            _conf[name] = _parse_host(name, val)
        elif name in _HOST_STEP_FAULTS:
            _conf[name] = _parse_host_step(name, val)
        else:
            _conf[name] = int(val)
    return dict(_conf)


def reset():
    """Disarm everything (test teardown)."""
    global _env_loaded
    _conf.clear()
    _fired.clear()
    _env_loaded = False


def active():
    _load_env()
    return dict(_conf)


def fired():
    """Fault names that have triggered in this process (crash-loop
    firings are unlatched and not listed)."""
    return set(_fired)


def _should(name, step):
    _load_env()
    if name in _fired or _conf.get(name) != int(step):
        return False
    _fired.add(name)
    # the injected fault is itself a flight-recorder event: a post-mortem
    # timeline that cannot show the fault that caused it is useless
    from .. import telemetry
    telemetry.flight().record("fault", "chaos." + name, step=int(step))
    return True


# -- training hooks (no-ops when disarmed) ----------------------------------

def maybe_kill_during_save(step):
    """CheckpointManager's writer calls this between writing the temp
    file and the atomic os.replace publish."""
    if _should("kill_save", step):
        # best-effort black box before dying, so a crash-looping worker
        # still leaves a postmortem trail (no-op without
        # MXNET_FLIGHT_RECORDER_DIR)
        from .. import telemetry
        try:
            telemetry.flight().dump("chaos_kill")
        except Exception:
            pass
        os._exit(43)  # hard exit: no atexit, no flush — a real preemption


def maybe_corrupt_checkpoint(step, path):
    """CheckpointManager's writer calls this after publishing the
    checkpoint of `step`: truncates the published file to half its
    size."""
    if _should("corrupt_ckpt", step):
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))


def grad_poison(step):
    """TrainStep adds this scalar to every gradient, ahead of the guard's
    finiteness check and grad norm: 0.0 normally, NaN on the armed
    `nan_step`, a large FINITE value on the armed `spike_step`."""
    if _should("nan_step", step):
        return float("nan")
    if _should("spike_step", step):
        return SPIKE_POISON
    return 0.0


def maybe_slow_host(step):
    """ResilientLoop calls this inside each timed step: an armed
    `slow_host` sleeps on the process whose MXNET_HOST_ID matches. Not
    latched (slow is a standing condition); the first firing records one
    flight event."""
    _load_env()
    cfg = _conf.get("slow_host")
    if cfg is None or os.environ.get("MXNET_HOST_ID", "0") != cfg[0]:
        return False
    if int(step) < (cfg[2] if len(cfg) > 2 else 1):
        return False
    if "slow_host" not in _fired:
        _fired.add("slow_host")
        from .. import telemetry
        telemetry.flight().record("fault", "chaos.slow_host",
                                  host=cfg[0], secs=cfg[1],
                                  step=int(step))
    time.sleep(cfg[1])
    return True


def sdc_poison(step):
    """SDCProbe calls this with each probe's step: an armed `sdc_at`
    whose host matches this process's MXNET_HOST_ID returns True at the
    first probe with step >= the armed one (then latches), and the probe
    perturbs its values before digesting."""
    _load_env()
    cfg = _conf.get("sdc_at")
    if cfg is None or "sdc_at" in _fired:
        return False
    if os.environ.get("MXNET_HOST_ID", "0") != cfg[0] \
            or int(step) < cfg[1]:
        return False
    _fired.add("sdc_at")
    from .. import telemetry
    telemetry.flight().record("fault", "chaos.sdc_at", host=cfg[0],
                              step=int(step))
    return True


def maybe_sigterm(step):
    """ResilientLoop calls this at each step boundary; delivers SIGTERM
    to this very process on the armed step."""
    if _should("sigterm_at", step):
        os.kill(os.getpid(), signal.SIGTERM)
        return True
    return False


def maybe_sigkill(step):
    """ResilientLoop calls this at each step boundary; delivers SIGKILL
    on the armed step: the process dies with no drain checkpoint and no
    cleanup (the dead host of the pod drill)."""
    if _should("sigkill_at", step):
        os.kill(os.getpid(), signal.SIGKILL)
        return True
    return False


# -- serving hooks ----------------------------------------------------------

def _should_serve(name, replica, iteration, latch=True):
    """Match one serving fault against (replica, loop iteration); fires
    at the FIRST opportunity with iteration >= the armed one. Latched
    unless `latch=False` (the crash-loop fault re-fires for every
    instance). Every firing lands in the flight recorder."""
    _load_env()
    cfg = _conf.get(name)
    if cfg is None or (latch and name in _fired):
        return None
    if int(replica) != cfg[0] or int(iteration) < cfg[1]:
        return None
    if latch:
        _fired.add(name)
    from .. import telemetry
    telemetry.flight().record("fault", "chaos." + name,
                              replica=int(replica), step=int(iteration))
    return cfg


def maybe_kill_serving_loop(replica, iteration):
    """LMServer's loop calls this every iteration, OUTSIDE the engine
    fault isolation: an armed serve_kill (one-shot) or serve_crash_loop
    raises — the loop dies like a real bug."""
    if _should_serve("serve_kill", replica, iteration):
        raise ChaosReplicaKilled(
            "chaos: serving loop of replica %r killed at iteration %d"
            % (replica, iteration))
    if _should_serve("serve_crash_loop", replica, iteration, latch=False):
        raise ChaosReplicaKilled(
            "chaos: replica %r crash-looping (dies every iteration %d)"
            % (replica, iteration))


def maybe_wedge_serving_loop(replica, iteration):
    """Armed serve_wedge: sleep inside the loop so the beat goes stale
    with the thread alive."""
    cfg = _should_serve("serve_wedge", replica, iteration)
    if cfg:
        time.sleep(cfg[2] if len(cfg) > 2 else 2.0)
        return True
    return False


def decode_poison(replica, iteration):
    """Armed serve_poison: the loop raises inside its decode try block,
    exercising the batch-fault path (requests resumed, loop alive)."""
    return _should_serve("serve_poison", replica, iteration) is not None


def spec_poison(replica, iteration):
    """Armed serve_spec_poison: the loop arms the engine's
    `chaos_spec_poison` flag for ONE iteration — the draft's logits come
    out NaN and the engine degrades that batch to the non-speculative
    path (token-identical, `spec_fallbacks` counted)."""
    return _should_serve("serve_spec_poison", replica,
                         iteration) is not None


def pool_exhaustion(replica, iteration):
    """Armed serve_exhaust: how many loop iterations the loop should
    hold the replica's entire free list hostage (0 = disarmed) —
    transient pool exhaustion, which must queue requests, not fail
    them."""
    cfg = _should_serve("serve_exhaust", replica, iteration)
    if cfg is None:
        return 0
    return int(cfg[2]) if len(cfg) > 2 else 20


def maybe_rollout_corrupt(step, files):
    """RolloutController's watcher calls this with a candidate step's
    published payload files BEFORE verifying them: an armed
    serve_rollout_corrupt=<step>:<file_index> bit-flips one byte in the
    middle of files[file_index % len(files)], bitrot landing after the
    manifest published, which the candidate verification (or the parity
    gate's digest probe) must quarantine before any user request reaches
    the weights. Exact-step match, latched."""
    _load_env()
    cfg = _conf.get("serve_rollout_corrupt")
    if cfg is None or "serve_rollout_corrupt" in _fired:
        return False
    if int(step) != cfg[0] or not files:
        return False
    _fired.add("serve_rollout_corrupt")
    path = files[int(cfg[1]) % len(files)]
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([(b[0] ^ 0xFF) if b else 0xFF]))
    from .. import telemetry
    telemetry.flight().record("fault", "chaos.serve_rollout_corrupt",
                              step=int(step),
                              path=os.path.basename(path))
    return True


def rollout_slow_canary(replica, iteration):
    """LMServer's loop calls this every iteration: an armed
    serve_rollout_slow_canary=<r>:<i>[:<secs>] sleeps (default 0.05 s) on
    replica r at EVERY iteration >= i: a canary whose weights are fine but
    whose latency is not, which the rollout judge must catch through its
    per-replica SLO burn and roll back. Unlatched (slow is a standing
    condition); the first firing records one flight event."""
    _load_env()
    cfg = _conf.get("serve_rollout_slow_canary")
    if cfg is None:
        return False
    if int(replica) != cfg[0] or int(iteration) < cfg[1]:
        return False
    if "serve_rollout_slow_canary" not in _fired:
        _fired.add("serve_rollout_slow_canary")
        from .. import telemetry
        telemetry.flight().record(
            "fault", "chaos.serve_rollout_slow_canary",
            replica=int(replica), step=int(iteration))
    time.sleep(cfg[2] if len(cfg) > 2 else 0.05)
    return True
