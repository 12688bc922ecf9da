"""SLO-driven elastic autoscaling for the replicated front door (port of
`mxnet_tpu/serving/autoscale.py`).

The SLO engine (telemetry/slo.py) computes multi-window TTFT burn rates
per replica and the router merges them fleet-wide. An `Autoscaler`
watches the fleet's merged burn and

* **scales up** — `ReplicatedLMServer.scale_up()`, one replica — when the
  two SHORTEST burn windows both run at or above `up_burn` with real
  traffic in them (the short window proves it is happening now, the
  longer one that it is not a blip), bounded by
  `MXNET_SERVING_MAX_REPLICAS`;
* **scales down** — drain + re-home, then retire one replica — only
  after the fleet has been idle (zero committed tokens) for
  `idle_retire_s` AND every burn window has cooled below `down_burn`,
  bounded by `MXNET_SERVING_MIN_REPLICAS`;
* **never flaps**: `down_burn` sits well under `up_burn` (hysteresis),
  and any two scale actions are separated by `cooldown_s`.

On a disaggregated fleet TTFT burn adds a prefill replica and ITL burn a
decode replica. `step(now)` is one synchronous decision — tests and
drills drive it with injected clocks and scripted burns; `start()` runs
it on a daemon thread every `interval_s`. A new replica's engine loads
its kernel libraries from the AOT cache when one is configured
(`serve(aot_cache=...)` / MXNET_AOT_CACHE_DIR); the router's
`serving_warm_replicas` gauge counts the replicas whose `engine.
warm_loads` is positive (read at each health sweep).
"""
from __future__ import annotations

import os
import threading
import time


def _env_float(name, default):
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    return float(raw)


def _env_int(name, default):
    raw = os.environ.get(name)
    if raw in (None, ""):
        return default
    return int(raw)


def autoscale_enabled():
    """MXNET_SERVING_AUTOSCALE — read when `serve()` builds the front
    door; `serve(autoscale=)` overrides."""
    env = os.environ.get("MXNET_SERVING_AUTOSCALE", "")
    return env not in ("", "0", "false", "off")


class AutoscaleConfig:
    """The scaling policy knobs, env-sourced by default
    (MXNET_SERVING_MIN_REPLICAS, ..._MAX_REPLICAS, ..._SCALE_*)."""

    def __init__(self, min_replicas=1, max_replicas=4, up_burn=1.0,
                 down_burn=0.1, cooldown_s=30.0, idle_retire_s=60.0,
                 interval_s=2.0):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas %d < min_replicas %d"
                             % (max_replicas, min_replicas))
        if down_burn >= up_burn:
            raise ValueError(
                "hysteresis requires down_burn (%g) < up_burn (%g) — "
                "equal thresholds would flap" % (down_burn, up_burn))
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_burn = float(up_burn)
        self.down_burn = float(down_burn)
        self.cooldown_s = float(cooldown_s)
        self.idle_retire_s = float(idle_retire_s)
        self.interval_s = float(interval_s)

    @classmethod
    def from_env(cls):
        return cls(
            min_replicas=_env_int("MXNET_SERVING_MIN_REPLICAS", 1),
            max_replicas=_env_int("MXNET_SERVING_MAX_REPLICAS", 4),
            up_burn=_env_float("MXNET_SERVING_SCALE_UP_BURN", 1.0),
            down_burn=_env_float("MXNET_SERVING_SCALE_DOWN_BURN", 0.1),
            cooldown_s=_env_float("MXNET_SERVING_SCALE_COOLDOWN_S", 30.0),
            idle_retire_s=_env_float("MXNET_SERVING_SCALE_IDLE_S", 60.0),
            interval_s=_env_float("MXNET_SERVING_SCALE_INTERVAL_S", 2.0))


class Autoscaler:
    """One scaling decision loop over one `ReplicatedLMServer`."""

    def __init__(self, router, config=None):
        self.router = router
        self.cfg = config if config is not None \
            else AutoscaleConfig.from_env()
        self._last_action_t = None
        self._breach_since = None
        self._idle_since = None
        #: breach-observed -> replica-spawned latency of the most recent
        #: scale-up (the bench's `burn_to_scale_up_s` field)
        self.last_breach_to_action_s = None
        self.scale_ups = 0
        self.scale_downs = 0
        self._thread = None
        self._stop = threading.Event()

    # -- signals -------------------------------------------------------------

    def burn_rates(self, objective="ttft"):
        """{window_seconds: {"rate", "good", "total", "span_s"}} for the
        fleet's merged default-tenant burn on `objective` (ttft by
        default; the per-role policy also reads itl) — {} when no such
        SLO is armed (the scaler then acts on idleness alone). Burn is
        recomputed from SUMMED window deltas (telemetry.slo.merge_slo),
        never averaged, so an idle replica can't dilute a burning one."""
        from ..telemetry import slo as _slo
        payloads = []
        for rep in list(self.router.replicas):
            try:
                payloads.append(rep.metrics.slo.payload())
            except Exception:
                continue
        merged = _slo.merge_slo(payloads)
        pick = None
        for m in merged:
            if m.get("objective") != objective:
                continue
            if m.get("tenant") is None:
                pick = m
                break
            if pick is None:
                pick = m
        if pick is None:
            return {}
        out = {}
        for w, b in (pick.get("burn") or {}).items():
            try:
                out[int(str(w).rstrip("s"))] = b
            except ValueError:                           # pragma: no cover
                continue
        return out

    def fleet_load_tokens(self):
        """Committed tokens across the fleet (queued + in-flight) — the
        idleness signal for scale-down."""
        total = 0
        for rep in list(self.router.replicas):
            try:
                total += rep.load_tokens()
            except Exception:
                continue
        return total

    def _hot(self, burns):
        """TTFT burn breach: the two shortest windows BOTH at/over
        `up_burn` with traffic present."""
        if not burns:
            return False
        ws = sorted(burns)[:2]
        return all(burns[w].get("rate", 0.0) >= self.cfg.up_burn
                   and burns[w].get("total", 0) > 0 for w in ws)

    def _cold(self, burns):
        """Every window below `down_burn` (the hysteresis floor); no
        SLO armed counts as cold — idleness alone then drives retire."""
        if not burns:
            return True
        return all(b.get("rate", 0.0) <= self.cfg.down_burn
                   for b in burns.values())

    # -- the decision --------------------------------------------------------

    def step(self, now=None):
        """One synchronous scaling decision. Returns "up", "down", or
        None. Drills and tests pass an explicit `now` (fake clock) and
        monkeypatch `burn_rates`/`fleet_load_tokens` to script load."""
        now = time.monotonic() if now is None else now
        r = self.router
        if r._closed:
            return None
        n = len(r.replicas)
        burns = self.burn_rates()
        hot = self._hot(burns)
        # per-role scaling on disaggregated fleets: TTFT
        # burn means admission/prompt pressure -> add a prefill
        # specialist; ITL burn means steady-state decode pressure ->
        # add a decode specialist (decode wins when both burn — the
        # in-flight users' pain is the one migration exists to fix).
        # Role-less fleets never reach this: role stays None and
        # scale_up ignores it. The TypeError guard keeps scripted
        # no-arg burn_rates stubs (tests, drills) working.
        role = None
        if getattr(r, "_roles", None) is not None:
            try:
                itl_burns = self.burn_rates("itl")
            except TypeError:
                itl_burns = {}
            hot_itl = self._hot(itl_burns)
            if hot_itl:
                role = "decode"
            elif hot:
                role = "prefill"
            hot = hot or hot_itl
        if hot:
            if self._breach_since is None:
                self._breach_since = now
        else:
            self._breach_since = None
        if self.fleet_load_tokens() > 0:
            self._idle_since = None
        elif self._idle_since is None:
            self._idle_since = now
        # the min floor is a bound, not a policy choice: restore it
        # immediately, cooldown notwithstanding (the fleet must never
        # undershoot)
        if n < self.cfg.min_replicas:
            return self._up(now, role)
        in_cooldown = (self._last_action_t is not None
                       and now - self._last_action_t < self.cfg.cooldown_s)
        if hot and not in_cooldown and n < self.cfg.max_replicas:
            return self._up(now, role)
        idle = (self._idle_since is not None
                and now - self._idle_since >= self.cfg.idle_retire_s)
        if idle and self._cold(burns) and not in_cooldown \
                and n > self.cfg.min_replicas:
            return self._down(now)
        return None

    def _up(self, now, role=None):
        # role is only ever non-None on a disaggregated router; calling
        # positionally-only scripted stand-ins (tests, drills) without
        # the kwarg keeps them working unchanged
        added = (self.router.scale_up(role=role) if role is not None
                 else self.router.scale_up())
        if added is None:
            return None
        self._last_action_t = now
        self.scale_ups += 1
        if self._breach_since is not None:
            self.last_breach_to_action_s = now - self._breach_since
            self._breach_since = None
        return "up"

    def _down(self, now):
        if self.router.scale_down() is None:
            return None
        self._last_action_t = now
        self._idle_since = None     # the idle clock restarts per retire
        self.scale_downs += 1
        return "down"

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Run `step()` every `interval_s` on a daemon thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.cfg.interval_s):
                try:
                    self.step()
                except Exception:
                    # a scaling pass must never kill the loop; the
                    # router's own counters and flight carry the evidence
                    continue

        self._thread = threading.Thread(target=loop,
                                        name="mxtt-autoscale",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout)
