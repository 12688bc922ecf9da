"""Fault injection for the serving loop (the serving half of
`mxnet_tpu/utils/chaos.py`).

Production code calls the tiny hook functions below (no-ops when chaos
is off); tests arm them programmatically (`configure(...)`) or through
environment variables, the path that lets a subprocess be faulted
without code changes. Every serving fault targets one replica's serving
loop and is keyed `<replica>:<iteration>` — the loop iteration counter
of THAT LMServer instance. A fault fires at the FIRST opportunity with
iteration >= the armed one (some hook sites only run under load), then
latches (serve_crash_loop excepted):

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

The training faults (checkpoint kill/corrupt, NaN and spike steps,
SIGTERM/SIGKILL, slow host, SDC) and the rollout faults belong to
modules the port has not reached yet; naming one in `configure` raises.
"""
from __future__ import annotations

import os
import time

#: serving faults: value is (replica, iteration[, extra]) — parsed from
#: "r:i[:x]" env strings or passed as tuples to configure()
_SERVE_FAULTS = ("serve_kill", "serve_crash_loop", "serve_wedge",
                 "serve_poison", "serve_spec_poison", "serve_exhaust")


class ChaosReplicaKilled(RuntimeError):
    """The injected serving-loop death (serve_kill / serve_crash_loop):
    raised from inside the loop, OUTSIDE the engine-fault isolation, so
    the loop's catch-all sees a dying thread exactly like a real bug."""

_conf = {}          # fault name -> (replica, iteration[, extra])
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


def _load_env():
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    for name in _SERVE_FAULTS:
        val = os.environ.get("MXNET_CHAOS_" + name.upper())
        if val:
            _conf.setdefault(name, _parse_serve(
                "MXNET_CHAOS_" + name.upper(), val))


def configure(**faults):
    """Arm faults programmatically: configure(serve_kill=(replica,
    iteration)). A value of None disarms. Returns the active config."""
    _load_env()
    for name, val in faults.items():
        if name not in _SERVE_FAULTS:
            raise ValueError("unknown chaos fault %r (the port knows %s)"
                             % (name, ", ".join(_SERVE_FAULTS)))
        if val is None:
            _conf.pop(name, None)
            _fired.discard(name)
        else:
            _conf[name] = _parse_serve(name, val)
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


def fired():
    """Fault names that have triggered in this process (crash-loop
    firings are unlatched and not listed)."""
    return set(_fired)


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
