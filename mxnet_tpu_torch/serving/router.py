"""The multi-replica front door: N `LMServer` replicas behind one door
(port of `mxnet_tpu/serving/router.py`).

One `LMServer` is capped by one serving thread driving one engine;
aggregate throughput needs replicas. `ReplicatedLMServer` runs N full
replicas — each with its OWN scheduler, KV block pool, serving thread and
private metrics registry (labeled `replica="<i>"`) — behind one
submit/HTTP front:

* **Least-loaded routing**: a request goes to the healthy replica with
  the lowest committed-token score (`LMServer.load_tokens`), round-robin
  on ties so equal replicas share bursts.
* **Aggregate admission**: when every healthy replica is saturated the
  router raises QueueFull, which the HTTP front maps to 503 + Retry-After
  (a saturated FLEET is a capacity signal, not a 429 retry story).
* **Wedge drain**: a replica whose loop stops beating is drained — new
  traffic routes around it, its queued requests are re-routed and its
  in-flight sequences fail over (below); `/healthz` stays 200 with
  `degraded: true` while one replica serves. A drained replica that beats
  again is RESTORED.
* **Supervision and respawn**: a *dead* replica (its loop raised,
  `LMServer._died`) is rebuilt on the same device, with exponential
  backoff between lives; after `respawn_max` lives (MXNET_REPLICA_
  RESPAWN_MAX) its circuit OPENS and the fleet serves on the survivors.
  A respawned replica that stays healthy for `respawn_reset_s` earns its
  attempts back. The corpse's device K/V is dropped at once; its pool's
  host bookkeeping stays for the leak audit.
* **In-flight failover**: sequences that already generated tokens replay
  prompt + generated-so-far as a prefill on another replica; greedy
  decoding is a pure function of the token history, so the client's one
  future resolves token-identically. Work no replica can absorb fails
  promptly (`serving_router_orphaned_total`).
* **Disaggregated prefill/decode roles**: with `roles="prefill:N,
  decode:M"` admission prefers prefill replicas and a prompt that
  finished prefilling MIGRATES to the least-loaded decode replica over
  the same replay transport (its prefix-cache hits priced in a bytes-
  saved ledger); with no decode replica to take it the source decodes
  locally.
* **Aggregated observability**: `/metrics` merges the replica registries
  and the router's own (`telemetry.merged_prometheus_text`); `/statusz`
  sums the token ledgers (retired replicas' folded in) and recomputes the
  fleet burn from summed window deltas (`telemetry.slo.merge_slo`).
* **Live weight rollout**: with a `RolloutController` attached
  (`serve(rollout=<ckpt dir>)` / MXNET_SERVING_ROLLOUT_DIR, rollout.py)
  the router tracks a weight VERSION per replica (`_version`), builds
  each replica from `_models.get(version, _model)`, shifts a weighted
  fraction of placements to the canary version mid-rollout, rebuilds
  replicas onto a version one at a time through the drain-to-completion
  `rollout_replace` seam, and never retires a version's last replica
  while a rollout is in flight. A fleet with no controller attached keeps
  its /statusz body and its exposition unchanged.

Placement: at tp=1 replica i runs on the caller's `device` when one is
given, else on `cuda:(i % torch.cuda.device_count())` — the counterpart
of the reference's `parallel.mesh.replica_devices(i, tp=1)`, whose
windows wrap modulo the device count, so on a one-card machine every
replica shares cuda:0 and each replica's loop thread launches its own
kernels there. At tp > 1 replica i gets the window
`replica_devices(i, tp, devices)` of `devices` (default: every CUDA
device; an entry may repeat, as `["cuda:0"] * 2` does to run two shards
on one card), and its one engine drives the whole window (tp.py).
"""
from __future__ import annotations

import os
import threading
import time

import torch

from ..base import MXNetError
from .. import telemetry
from .scheduler import QueueFull
from .server import LMServer, _HTTPFrontend


def serving_replicas():
    """MXNET_SERVING_REPLICAS — read when `serve()` builds the front
    door. 1/unset = single LMServer."""
    env = os.environ.get("MXNET_SERVING_REPLICAS")
    return int(env) if env else 1


def serving_respawn_max():
    """MXNET_REPLICA_RESPAWN_MAX — how many times the router rebuilds one
    dead replica before opening its crash-loop circuit;
    `ReplicatedLMServer(respawn_max=)` overrides."""
    env = os.environ.get("MXNET_REPLICA_RESPAWN_MAX")
    return int(env) if env else 3


#: role names a disaggregated fleet understands — prefill replicas absorb
#: prompt processing and hand finished prompts off; decode replicas own
#: steady-state generation
SERVING_ROLES = ("prefill", "decode")


def serving_roles(spec=None):
    """Parse a disaggregated-fleet role layout — `"prefill:N,decode:M"`
    — from `spec`, or from MXNET_SERVING_ROLES when `spec` is None.
    Returns an ordered `{"prefill": N, "decode": M}` dict, or None when
    unset/empty (the role-less fleet). A dict passes through validated.
    Unknown role names, non-integer counts and layouts naming zero
    replicas raise MXNetError."""
    if spec is None:
        spec = os.environ.get("MXNET_SERVING_ROLES")
    if spec is None:
        return None
    if isinstance(spec, dict):
        items = list(spec.items())
    else:
        spec = str(spec).strip()
        if not spec:
            return None
        items = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, count = part.partition(":")
            if not sep:
                raise MXNetError(
                    "bad role spec %r: expected role:count entries "
                    "like 'prefill:1,decode:2'" % spec)
            items.append((name.strip(), count.strip()))
    out = {}
    for name, count in items:
        if name not in SERVING_ROLES:
            raise MXNetError(
                "unknown serving role %r (known: %s)"
                % (name, ", ".join(SERVING_ROLES)))
        try:
            n = int(count)
        except (TypeError, ValueError):
            raise MXNetError("bad count %r for role %r" % (count, name))
        if n < 0:
            raise MXNetError("role %r count must be >= 0" % name)
        out[name] = out.get(name, 0) + n
    if not out:
        return None
    if sum(out.values()) < 1:
        raise MXNetError(
            "role layout %r names zero replicas" % (spec,))
    return {k: v for k, v in out.items() if v > 0}


def replica_device(i, device=None):
    """Device of serving replica `i`: `device` when the caller gave one
    (every replica shares it), else cuda:(i % device_count). Without CUDA
    it is None, and the engine's `resolve_device` raises: nothing falls
    back to the CPU unasked."""
    if device is not None:
        return device
    if torch.cuda.is_available():
        return torch.device("cuda", i % torch.cuda.device_count())
    return None


class NoHealthyReplicas(MXNetError):
    """Every replica behind the front door is drained/dead — a fleet
    outage, not a client error (the HTTP front maps this to 503)."""


class ReplicatedLMServer(_HTTPFrontend):
    """N `LMServer` replicas behind one front door. Construct via
    `serve(model, replicas=N, ...)`; per-replica kwargs (max_batch,
    block_size, paged, device, ...) pass through unchanged. `tp` (None:
    MXNET_SERVING_TP) shards each replica over a window sliced from
    `devices`."""

    saturated_status = 503          # a saturated FLEET, not one queue

    def __init__(self, model, replicas=2, tp=None, devices=None,
                 retry_after_s=1.0, max_beat_age=5.0, respawn_max=None,
                 respawn_backoff=0.5, respawn_reset_s=30.0,
                 autoscale=None, roles=None, role_kwargs=None,
                 **kwargs):
        # `roles` splits the fleet into prefill and decode specialists;
        # the replica count is then the SUM of the role counts.
        # `role_kwargs` overlays per-role LMServer kwargs on the shared
        # ones — flags switch placement and batching shape, never logits
        self._roles = serving_roles(roles) if roles is not None else None
        self._role_kwargs = dict(role_kwargs or {})
        if self._roles:
            replicas = sum(self._roles.values())
            role_seq = [nm for nm, cnt in self._roles.items()
                        for _ in range(cnt)]
        else:
            role_seq = [None] * max(int(replicas), 0)
        if replicas < 1:
            raise MXNetError("replicas must be >= 1, got %r" % replicas)
        from .tp import serving_tp
        tp_req = serving_tp() if tp is None else int(tp)
        if tp_req > 1 and replicas > 1 and not isinstance(model, tuple):
            raise MXNetError(
                "replicas>1 with tp>1 needs a re-instantiable model — "
                "pass (params, cfg), not a shared adapter (each replica "
                "lays params out on its own device window)")
        self.retry_after_s = retry_after_s
        self.max_beat_age = float(max_beat_age)
        # supervision knobs: lives per replica, backoff between them, and
        # the probation after which a respawned replica's count resets
        self.respawn_max = (serving_respawn_max() if respawn_max is None
                            else int(respawn_max))
        self.respawn_backoff = float(respawn_backoff)
        self.respawn_reset_s = float(respawn_reset_s)
        self._model = model
        self._kwargs = dict(kwargs)
        self._tp = tp_req
        self._devices = devices     # windows' source; None: every CUDA
                                    # device
        # live weight rollout: the fleet's serving checkpoint step (None
        # = the boot weights), the version -> model map replicas build
        # from, and the in-flight canary's traffic share, all managed by
        # the attached RolloutController
        self._models = {}
        self.weights_version = None
        self.rollout = None
        self._rollout_weight = None
        self._rollout_version = None
        self._rollout_retiring = set()
        self._rollout_ticket = 0
        self._closed = False
        self._lock = threading.Lock()
        self._rr = 0                # round-robin tie-break cursor
        # router-level observability rides the same merged exposition
        self.registry = telemetry.MetricsRegistry(
            labels={"replica": "router"})
        self._c_requests = self.registry.counter(
            "serving_router_requests_total",
            help="requests through the front door (placed + finally "
                 "rejected; HTTP submit retries count once)")
        self._c_rejected = self.registry.counter(
            "serving_router_rejected_total",
            help="requests bounced because every replica was saturated")
        self._c_rerouted = self.registry.counter(
            "serving_router_rerouted_total",
            help="queued requests re-routed off a drained replica")
        self._c_drained = self.registry.counter(
            "serving_router_replicas_drained_total", flight=True,
            help="replicas drained after a wedge observation")
        self._c_restored = self.registry.counter(
            "serving_router_replicas_restored_total",
            help="drained replicas restored after their loop resumed "
                 "beating (transient stall, not a dead loop)")
        self._g_healthy = self.registry.gauge(
            "serving_router_replicas_healthy",
            help="replicas currently routable")
        self._h_pick = self.registry.histogram(
            "serving_router_pick_seconds",
            help="least-loaded replica selection (routing overhead)")
        self._c_orphaned = self.registry.counter(
            "serving_router_orphaned_total", flight=True,
            help="in-flight requests a drained/dead replica abandoned "
                 "that NO healthy replica could absorb — failed "
                 "promptly with a distinct error, never left to time "
                 "out silently")
        self._c_respawn = self.registry.counter(
            "serving_respawn_total", flight=True,
            help="dead replicas rebuilt (fresh engine + pool on the "
                 "same device window) and restored to rotation")
        self._g_circuit = self.registry.gauge(
            "serving_crash_loop_open",
            help="replicas whose respawn circuit is open (crash loop: "
                 "died MXNET_REPLICA_RESPAWN_MAX times) — drained for "
                 "good until an operator intervenes")
        self._c_scale_up = self.registry.counter(
            "serving_scale_up_total",
            help="replicas added by elastic scale-up (SLO burn breach "
                 "or min-floor restore) — warm-started from the AOT "
                 "executable cache when one is configured")
        self._c_scale_down = self.registry.counter(
            "serving_scale_down_total",
            help="replicas retired by elastic scale-down after "
                 "sustained idle: drained, in-flight work re-homed, "
                 "then closed — zero lost requests")
        self._g_warm = self.registry.gauge(
            "serving_warm_replicas",
            help="replicas whose engines warm-loaded at least one "
                 "executable from the AOT cache instead of compiling")
        # per-role fleet gauges, created only on disaggregated fleets so
        # a role-less exposition keeps its metric set
        self._g_role = {}
        if self._roles is not None:
            for rn in SERVING_ROLES:
                self._g_role[rn] = self.registry.gauge(
                    "serving_role_%s_replicas" % rn,
                    help="healthy (routable) replicas currently "
                         "holding the %s role" % rn)
        self.replicas = []
        self._drained = []
        self._role = []     # per-replica role label, index-aligned
        self._version = []  # per-replica weight version, index-aligned
        # per-replica supervision state, index-aligned with `replicas`
        self._respawn_attempts = [0] * replicas
        self._respawn_next = [0.0] * replicas
        self._respawning = [False] * replicas
        self._circuit_open = [False] * replicas
        self._ok_since = [None] * replicas
        self._retired_engines = []      # crashed engines, kept for audit
        self._retired_requests = {}     # dead replicas' request ledgers
        self._retired_tokens = {}       # ... and their token ledgers
        self._retired_tenants = {}      # {tenant: {kind: tokens}}
        try:
            for i in range(replicas):
                self.replicas.append(self._build_replica(i, role_seq[i]))
                self._drained.append(False)
                self._role.append(role_seq[i])
                self._version.append(None)
        except BaseException:
            for rep in self.replicas:
                rep.close(drain=False, timeout=5.0)
            raise
        self._g_healthy.set(len(self.replicas))
        self._refresh_role_gauges()
        # elastic autoscaling: autoscale=True arms the env-configured
        # policy, an AutoscaleConfig pins one explicitly
        self.autoscaler = None
        if autoscale:
            from .autoscale import Autoscaler, AutoscaleConfig
            cfg = autoscale if isinstance(autoscale, AutoscaleConfig) \
                else None
            self.autoscaler = Autoscaler(self, config=cfg)
            self.autoscaler.start()

    def _build_replica(self, i, role=None, version=None):
        """One fresh replica on its device window — the constructor,
        respawn, scale-up and the rollout replace seam share it, so a
        rebuilt replica is placed (and role'd) exactly like the original.
        `version` selects the weight version it serves: a step the
        rollout controller registered in `_models`, or None for the
        fleet's current model. On disaggregated fleets per-role kwargs
        overlay the shared ones (a decode role may run another tp), and a
        prefill replica gets the router's migration hook."""
        from ..parallel.mesh import replica_devices
        from .tp import serving_devices
        kw = dict(self._kwargs)
        if role is not None:
            kw.update(self._role_kwargs.get(role, {}))
        tp = int(kw.pop("tp", self._tp))
        devices = kw.pop("devices", self._devices)
        device = kw.pop("device", None)
        if tp > 1:
            kw["devices"] = replica_devices(
                i, tp, serving_devices() if devices is None else devices)
        else:
            device = replica_device(i, device)
        model = self._models.get(version, self._model)
        rep = LMServer(model, replica_id=i, role=role, device=device,
                       tp=tp, **kw)
        # the death hook runs ON the dying serving thread: queued and
        # in-flight work is re-homed at once, not at the next sweep
        rep.on_death = self._on_replica_death
        if role == "prefill":
            rep.on_prefill_done = self._migrate
        return rep

    def _refresh_role_gauges(self):
        """Re-derive the per-role healthy-replica gauges (no-op on
        role-less fleets)."""
        for rn, gv in self._g_role.items():
            gv.set(sum(
                1 for j, r in enumerate(self._role)
                if r == rn and j < len(self._drained)
                and not self._drained[j]))

    # -- routing -------------------------------------------------------------

    def _sweep(self, max_beat_age=None):
        """One health pass over every replica, judging three states:

        * **wedged** (loop alive, beat stale): drain — queued requests
          re-homed, in-flight sequences failed over — and RESTORE when
          the loop beats again;
        * **dead** (the loop raised and exited, `LMServer._died`, or a
          thread that vanished without closing): drain as above, then
          RESPAWN under crash-loop accounting (backoff, circuit OPEN
          after `respawn_max` lives, attempts forgiven after
          `respawn_reset_s` of continuous health);
        * **healthy**: restored to rotation if it was drained.

        Returns this pass's per-replica health dicts, so one /healthz
        body's `drained`, `circuit_open` and `ok` always agree."""
        if max_beat_age is None:
            max_beat_age = self.max_beat_age
        healths = []
        now = time.perf_counter()
        for i in range(len(self.replicas)):
            try:
                rep = self.replicas[i]
                h = rep.health(max_beat_age=max_beat_age)
                # dead = the loop CRASHED or the thread vanished without
                # an administrative close (closed on purpose is down, not
                # respawn fodder)
                h["dead"] = bool(rep._died or (not rep._thread.is_alive()
                                               and not rep._closed))
                h["circuit_open"] = self._circuit_open[i]
                h["respawns"] = self._respawn_attempts[i]
                if self._roles is not None and i < len(self._role):
                    h["role"] = self._role[i]
                healths.append(h)
                if self._closed:
                    continue
                if h["ok"]:
                    if self._ok_since[i] is None:
                        self._ok_since[i] = now
                    elif self._respawn_attempts[i] and not \
                            self._circuit_open[i] and \
                            now - self._ok_since[i] >= \
                            self.respawn_reset_s:
                        # survived a full probation: not a crash loop
                        self._respawn_attempts[i] = 0
                else:
                    self._ok_since[i] = None
                if not self._drained[i] and not h["ok"]:
                    with self._lock:
                        if self._drained[i]:
                            continue
                        self._drained[i] = True
                    self._c_drained.inc(replica=i)
                    telemetry.record_span(
                        "serving.drain", time.perf_counter_ns() // 1000,
                        0, category="serving", to_profiler=False,
                        replica=i, dead=h["dead"])
                    self._rehome(rep)
                elif self._drained[i] and h["ok"]:
                    with self._lock:
                        if not self._drained[i]:
                            continue
                        self._drained[i] = False
                    self._c_restored.inc(replica=i)
                if h["dead"]:
                    self._maybe_respawn(i, now)
            except IndexError:
                # a concurrent scale_down retired the tail mid-pass; the
                # shrunken fleet gets a clean verdict next sweep
                break
        self._g_healthy.set(len(self.replicas) - sum(self._drained))
        self._g_circuit.set(sum(self._circuit_open))
        self._g_warm.set(sum(
            1 for rep in list(self.replicas)
            if getattr(rep.engine, "warm_loads", 0) > 0))
        self._refresh_role_gauges()
        return healths

    def _maybe_respawn(self, i, now):
        """Schedule a rebuild of dead replica i unless its circuit is
        open, its backoff window hasn't elapsed, or a rebuild is already
        in flight. The slot is reserved under the lock; the construction
        runs on a short-lived daemon thread, so a health probe never
        blocks on an engine build."""
        with self._lock:
            if self._closed or self._respawning[i] or \
                    self._circuit_open[i]:
                return
            if self._respawn_attempts[i] >= self.respawn_max:
                self._circuit_open[i] = True
                self._g_circuit.set(sum(self._circuit_open))
                telemetry.flight().record(
                    "fault", "serving.crash_loop_open", replica=i,
                    attempts=self._respawn_attempts[i])
                return
            if now < self._respawn_next[i]:
                return
            self._respawning[i] = True
            self._respawn_attempts[i] += 1
            self._respawn_next[i] = now + self.respawn_backoff \
                * (2 ** (self._respawn_attempts[i] - 1))
        threading.Thread(target=self._respawn_build,
                         args=(i, self.replicas[i]),
                         name="mxtt-respawn-%d" % i,
                         daemon=True).start()

    def _respawn_build(self, i, old):
        """The reserved rebuild of replica i: construct off the hot
        paths, swap atomically, retire the corpse (its engine is kept for
        the leak audit, its device K/V dropped)."""
        try:
            # a respawned replica keeps its slot's role AND its weight
            # version: a dead canary comes back on the candidate weights
            role = self._role[i] if i < len(self._role) else None
            ver = self._version[i] if i < len(self._version) else None
            rep = self._build_replica(i, role, version=ver)
        except Exception as e:
            with self._lock:
                self._respawning[i] = False
            telemetry.flight().record(
                "fault", "serving.respawn_failed", replica=i,
                error="%s: %s" % (type(e).__name__, e))
            return
        with self._lock:
            if self._closed or i >= len(self.replicas) \
                    or self.replicas[i] is not old:
                # raced an administrative shutdown or a scale action
                if i < len(self._respawning):
                    self._respawning[i] = False
                closed_race = True
            else:
                self.replicas[i] = rep
                self._drained[i] = False
                self._respawning[i] = False
                closed_race = False
        if closed_race:
            rep.close(drain=False, timeout=5.0)
            return
        self._ok_since[i] = None
        # fold the corpse's ledgers BEFORE discarding its registry:
        # rescued requests' `submitted` counts live only there
        self._fold_retired(old)
        # keep only a few corpses for the leak audit
        self._retired_engines.append(old.engine)
        del self._retired_engines[:-4]
        try:
            old.close(drain=False, timeout=1.0)
        except Exception:
            pass
        # the audit needs only the pool's host bookkeeping: drop the
        # device K/V (the dominant allocation), so corpses never pin
        # card memory the replacement pools need
        cache = old.engine.cache
        if cache is not None:
            cache.k = cache.v = None
            cache.k_scale = cache.v_scale = None
        self._c_respawn.inc(replica=i)
        telemetry.record_span(
            "serving.respawn", time.perf_counter_ns() // 1000, 0,
            category="serving", to_profiler=False, replica=i,
            attempt=self._respawn_attempts[i])
        self._g_healthy.set(len(self.replicas) - sum(self._drained))

    def _fold_retired(self, rep):
        """Fold a retiring replica's request and token ledgers into the
        router's retired accumulators before its registry is discarded —
        respawn and scale-down share this, so the fleet-wide submitted ==
        goodput + slow + shed + expired + failed identity survives every
        retirement."""
        try:
            for k, v in rep.snapshot()["requests"].items():
                self._retired_requests[k] = \
                    self._retired_requests.get(k, 0) + v
        except Exception:
            pass
        try:
            stz = rep.metrics.statusz()
            for k, v in stz["tokens"].items():
                self._retired_tokens[k] = self._retired_tokens.get(k, 0) + v
            for name, t in stz["tenants"].items():
                acc = self._retired_tenants.setdefault(name, {})
                for k, v in t["tokens"].items():
                    acc[k] = acc.get(k, 0) + v
        except Exception:
            pass

    def _routable(self, max_beat_age=None):
        """Indices of replicas traffic may go to, after a sweep."""
        if self._closed:
            return []
        self._sweep(max_beat_age)
        return [i for i in range(len(self.replicas))
                if not self._drained[i]]

    def _rehome(self, rep):
        """Sweep-side drain of a wedged (or dead-without-hook) replica:
        queued requests move wholesale; in-flight sequences are detached
        from the stuck loop — request unhooked, marked done so a loop
        that later RESUMES releases their blocks without serving them —
        and failed over as prefill replays. Detach-then-replay is the
        exactly-once pin: by the time a replay exists anywhere, the
        source loop can only release, never finish."""
        states = []
        with rep._failover_lock:
            for seq in (list(rep.scheduler.running)
                        + list(rep.scheduler.prefilling)):
                req = seq.request
                if req is None or req._event.is_set():
                    continue
                states.append((req, list(seq.tokens), seq.prompt_len))
                seq.request = None
                seq.done = True
        self._place_orphans(rep, rep.drain_queue(), states)

    def _on_replica_death(self, rep, queued, states):
        """LMServer's death hook — runs ON the dying serving thread,
        after it released its blocks: mark the replica drained and
        re-home everything at once."""
        try:
            i = self.replicas.index(rep)
        except ValueError:
            i = None                    # already replaced by a respawn
        if i is not None and not self._closed:
            with self._lock:
                fresh = not self._drained[i]
                self._drained[i] = True
            if fresh:
                self._c_drained.inc(replica=i)
            self._g_healthy.set(len(self.replicas) - sum(self._drained))
        self._place_orphans(rep, queued, states)

    def _place_orphans(self, rep, queued, states):
        """Re-home a drained/dead replica's abandoned work. Queued
        requests adopt wholesale (least-loaded first). In-flight states
        — (request, tokens so far, prompt_len) — replay as prefills via
        `spawn_resume`, whose stitch completes the client's original
        future token-identically. Work nobody can absorb is failed
        PROMPTLY with a distinct error and counted."""
        from .server import spawn_resume
        targets = [r for i, r in enumerate(self.replicas)
                   if not self._drained[i] and r is not rep]
        for req in queued:
            placed = False
            for tgt in sorted(targets, key=lambda r: r.load_tokens()):
                try:
                    tgt.adopt(req)
                    placed = True
                    break
                except QueueFull:
                    continue
            if placed:
                self._c_rerouted.inc()
            else:
                req._finish(error=MXNetError(
                    "replica drained and no healthy replica could "
                    "absorb request %d" % req.id))
                # the drained replica counted it submitted: close its
                # ledger there, so no phantom in-flight request lingers
                rep.metrics.request_finished(req)
        for req, tokens, prompt_len in states:
            if req.failovers >= LMServer.max_failovers:
                self._orphan(rep, req, "failover budget exhausted "
                                       "(%d hops)" % req.failovers)
                continue
            placed = False
            for tgt in sorted(targets, key=lambda r: r.load_tokens()):
                try:
                    resume, carried = spawn_resume(req, tokens, tgt)
                except QueueFull:
                    continue
                placed = True
                if resume is None:
                    # generation was already complete: finished directly
                    rep.metrics.request_finished(req)
                else:
                    tgt.metrics.request_failover(req, carried)
                    telemetry.flight().record(
                        "fault", "serving.failover", request=req.id,
                        resumed_tokens=carried,
                        target=tgt.replica_id)
                break
            if not placed:
                self._orphan(rep, req, "no healthy replica could "
                                       "absorb the failover replay")

    def _orphan(self, rep, req, why):
        """Fail one abandoned in-flight request promptly, with an error
        that names the abandonment, and count it."""
        self._c_orphaned.inc()
        req._finish(error=MXNetError(
            "in-flight request %d orphaned by replica drain/death: %s"
            % (req.id, why)))
        rep.metrics.request_finished(req)

    # -- migration (disaggregated serving) -----------------------------------

    def _migrate(self, source, req, tokens):
        """The prefill replica's hand-off hook (`on_prefill_done`),
        called on `source`'s serving thread when a prompt finishes
        prefilling (first token appended). Places the request's decode on
        the least-loaded healthy decode replica via `spawn_migrate`.

        Returns True when the request now lives on a decode replica (or
        finished outright), False when no healthy decode replica can
        absorb it — the source then keeps decoding it locally."""
        from .server import spawn_migrate
        if self._closed:
            return False
        with self._lock:
            targets = [
                r for j, r in enumerate(self.replicas)
                if j < len(self._role) and self._role[j] == "decode"
                and j < len(self._drained) and not self._drained[j]
                and r is not source]
        for tgt in sorted(targets, key=lambda r: r.load_tokens()):
            try:
                resume, carried = spawn_migrate(req, tokens, tgt)
            except QueueFull:
                continue
            if resume is None:
                # complete at the seam: the hop finished the client;
                # close the ledger where the submit was counted
                source.metrics.request_finished(req)
            else:
                tgt.metrics.request_migration(req, carried)
            return True
        return False

    def _pick_order(self, role=None):
        """Routable replicas, least-loaded first; ties broken round-robin
        from a rotating cursor so equal replicas alternate. On
        disaggregated fleets `role` PREFERS that role's replicas (a
        stable re-sort) without excluding the rest, so a fleet whose
        prefill replicas are all saturated or dead degrades to
        co-scheduled serving instead of refusing traffic."""
        t0 = time.perf_counter()
        alive = self._routable()
        # snapshot the list: a concurrent scale action must not shift
        # indices under the sort key
        reps = list(self.replicas)
        n = len(reps) or 1
        alive = [i for i in alive if i < len(reps)]
        with self._lock:
            rr = self._rr
            self._rr += 1
        order = sorted(alive, key=lambda i: (
            reps[i].load_tokens(), (i - rr) % n))
        if role is not None and self._roles is not None:
            order.sort(key=lambda i: 0 if (
                i < len(self._role) and self._role[i] == role) else 1)
        # live-rollout traffic shaping: at stage weight f, ~f of
        # placements put the canary version FIRST (a period-1/f ticket,
        # deterministic, no RNG); the rest keep it LAST, still reachable
        # when every incumbent is saturated. f <= 0 (a rollback draining
        # it) excludes the canary; f >= 1 (promoting) prefers it.
        w = self._rollout_weight
        ver = self._rollout_version
        if w is not None and ver is not None:
            canary = [i for i in order if i < len(self._version)
                      and self._version[i] == ver]
            if canary:
                rest = [i for i in order if i not in canary]
                if w <= 0.0:
                    order = rest
                elif w >= 1.0:
                    order = canary + rest
                else:
                    with self._lock:
                        t = self._rollout_ticket
                        self._rollout_ticket += 1
                    period = max(1, int(round(1.0 / w)))
                    order = (canary + rest) if t % period == 0 \
                        else (rest + canary)
        self._h_pick.observe(time.perf_counter() - t0)
        return order

    # -- elastic scaling -----------------------------------------------------

    def replica_count(self):
        return len(self.replicas)

    def scale_up(self, role=None, version=None):
        """Add one replica at the tail of the fleet. The build runs
        off-lock; the append of the replica and all its index-aligned
        supervision state happens atomically. On disaggregated fleets
        `role` says WHICH specialist to add; role-less fleets ignore it.
        `version` pins the new replica's weight version (the rollout
        controller spawns its canary so); omitted, it is the fleet's
        serving version, so an autoscale spawn during a rollout builds an
        incumbent, never a second canary. Returns the new LMServer, or
        None when closed, raced or the build failed (the Autoscaler reads
        None as "no action")."""
        if self._roles is None:
            role = None
        if version is None:
            version = self.weights_version
        with self._lock:
            if self._closed:
                return None
            i = len(self.replicas)
        t0 = time.perf_counter_ns() // 1000
        try:
            rep = self._build_replica(i, role, version=version)
        except Exception as e:
            telemetry.flight().record(
                "fault", "serving.scale_up_failed", replica=i,
                error="%s: %s" % (type(e).__name__, e))
            return None
        with self._lock:
            if self._closed or len(self.replicas) != i:
                raced = True        # shutdown or a concurrent scale
            else:
                self.replicas.append(rep)
                self._drained.append(False)
                self._role.append(role)
                self._version.append(version)
                self._respawn_attempts.append(0)
                self._respawn_next.append(0.0)
                self._respawning.append(False)
                self._circuit_open.append(False)
                self._ok_since.append(None)
                raced = False
        if raced:
            rep.close(drain=False, timeout=5.0)
            return None
        self._c_scale_up.inc(replica=i)
        telemetry.record_span(
            "serving.scale_up", t0, time.perf_counter_ns() // 1000 - t0,
            category="serving", to_profiler=False, replica=i, role=role,
            warm=bool(getattr(rep.engine, "warm_loads", 0)))
        self._g_healthy.set(len(self.replicas) - sum(self._drained))
        self._refresh_role_gauges()
        return rep

    def scale_down(self):
        """Retire one replica, drain-first: marked drained (new traffic
        routes around it), queued and in-flight work re-homed onto the
        survivors, then popped and closed — zero lost requests. The
        victim is version-aware: a rollback-pending canary goes before a
        healthy incumbent, and while a rollout is in flight no version's
        last replica is retired. The pop stays a TAIL pop (the
        supervision lists are index-aligned); a non-tail victim is first
        swapped to the tail with all its aligned state, under the lock.
        Refuses (returns None) at fleet size 1, while a respawn owns the
        slot, or when closed."""
        with self._lock:
            if self._closed or len(self.replicas) <= 1:
                return None
            tail = len(self.replicas) - 1
            i = tail
            if self._rollout_retiring:
                for j in range(tail, -1, -1):
                    if self._version[j] in self._rollout_retiring:
                        i = j
                        break
            if self._rollout_version is not None:
                v = self._version[i]
                if v not in self._rollout_retiring and \
                        sum(1 for x in self._version if x == v) <= 1:
                    return None     # last replica of an active version
            if self._respawning[i]:
                return None          # a rebuild owns the slot
            if i != tail:
                if self._respawning[tail]:
                    return None      # nor swap under a rebuild
                for lst in self._aligned():
                    lst[i], lst[tail] = lst[tail], lst[i]
                i = tail
            rep = self.replicas[i]
            self._drained[i] = True  # route new traffic around it now
        t0 = time.perf_counter_ns() // 1000
        try:
            self._rehome(rep)
        except Exception:
            pass
        with self._lock:
            if len(self.replicas) != i + 1 \
                    or self.replicas[i] is not rep:
                return None          # raced a shutdown/respawn swap
            for lst in self._aligned():
                lst.pop()
        # drain=True: anything that slipped in between the drain mark and
        # the pop still completes before the thread exits (or is rescued
        # through on_death by close()'s strand sweep)
        try:
            rep.close(drain=True, timeout=10.0)
        except Exception as e:
            telemetry.flight().record(
                "fault", "serving.scale_down_close_failed", replica=i,
                error="%s: %s" % (type(e).__name__, e))
        # a re-homed request completes on a survivor; its submit stays on
        # the retiree, whose ledgers fold into the retired accumulators
        self._fold_retired(rep)
        self._c_scale_down.inc(replica=i)
        telemetry.record_span(
            "serving.scale_down", t0, time.perf_counter_ns() // 1000 - t0,
            category="serving", to_profiler=False, replica=i)
        self._g_healthy.set(len(self.replicas) - sum(self._drained))
        self._refresh_role_gauges()
        return rep

    def _aligned(self):
        """Every per-replica list kept index-aligned with `replicas`."""
        return (self.replicas, self._drained, self._role, self._version,
                self._respawn_attempts, self._respawn_next,
                self._respawning, self._circuit_open, self._ok_since)

    # -- live weight rollout -------------------------------------------------

    def rollout_replace(self, j, version):
        """Rebuild replica j on weight `version`: the promote (and
        rollback-revert) seam. A PLANNED replace, unlike a respawn: the
        old replica is marked drained and closed with drain=True, so its
        queued and in-flight requests complete on the weights they
        started on — zero lost requests, no cross-version replay. Then
        the slot is rebuilt on `version` and swapped in. True on success
        (or when the slot already serves `version`), False when raced by
        a shutdown or respawn or when the build failed (the controller
        retries on its next pass)."""
        with self._lock:
            if self._closed or j >= len(self.replicas) \
                    or self._respawning[j]:
                return False
            old = self.replicas[j]
            if self._version[j] == version:
                return True
            self._drained[j] = True
        t0 = time.perf_counter_ns() // 1000
        try:
            old.close(drain=True, timeout=30.0)
        except Exception:
            pass
        self._fold_retired(old)
        role = self._role[j] if j < len(self._role) else None
        try:
            rep = self._build_replica(j, role, version=version)
        except Exception as e:
            telemetry.flight().record(
                "fault", "serving.rollout_replace_failed", replica=j,
                version=version, error="%s: %s" % (type(e).__name__, e))
            return False
        with self._lock:
            if self._closed or j >= len(self.replicas) \
                    or self.replicas[j] is not old:
                raced = True
            else:
                self.replicas[j] = rep
                self._drained[j] = False
                self._version[j] = version
                self._ok_since[j] = None
                raced = False
        if raced:
            rep.close(drain=False, timeout=5.0)
            return False
        # keep the corpse for the leak audit, drop its device K/V
        cache = old.engine.cache
        if cache is not None:
            cache.k = cache.v = None
            cache.k_scale = cache.v_scale = None
        self._retired_engines.append(old.engine)
        del self._retired_engines[:-4]
        telemetry.record_span(
            "serving.rollout", t0, time.perf_counter_ns() // 1000 - t0,
            category="serving", to_profiler=False, phase="replace",
            replica=j, version=version)
        self._g_healthy.set(len(self.replicas) - sum(self._drained))
        return True

    def attach_rollout(self, directory, start=False, **cfg):
        """Attach a RolloutController watching `directory` for newly
        published checkpoint steps (rollout.py). `serve()` attaches with
        start=True (a daemon watcher thread); tests and drills attach
        with start=False and drive `rollout.step()` themselves. Stages,
        window and prompt-count kwargs pass through."""
        from .rollout import RolloutController
        if self.rollout is not None:
            raise MXNetError("a rollout controller is already attached")
        self.rollout = RolloutController(self, directory, **cfg)
        if start:
            self.rollout.start()
        return self.rollout

    def rollout_command(self, cmd, step=None, reason=None):
        """Operator override dispatch (POST /v1/rollout, the reference's
        tools/rollout.py CLI): promote / rollback / reject / status."""
        if self.rollout is None:
            raise MXNetError(
                "no rollout controller attached (serve with "
                "rollout=<dir> or MXNET_SERVING_ROLLOUT_DIR)")
        if cmd == "promote":
            return self.rollout.promote()
        if cmd == "rollback":
            return self.rollout.rollback(reason or "operator override")
        if cmd == "reject":
            if step is None:
                raise MXNetError("rollout reject needs a step")
            return self.rollout.reject(int(step),
                                       reason or "operator reject")
        if cmd == "status":
            return self.rollout.status()
        raise MXNetError(
            "unknown rollout command %r (know promote, rollback, "
            "reject, status)" % (cmd,))

    # -- client API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, eos_id=None,
               count_reject=True, tenant=None, priority=None,
               deadline_ms=None, trace=None):
        """Route one request to the least-loaded healthy replica; returns
        the Request future. Raises QueueFull only when EVERY healthy
        replica is saturated (HTTP 503 + Retry-After), NoHealthyReplicas
        when the whole fleet is drained/dead (HTTP 503), MXNetError when
        the request can never be served (oversized prompt), and
        DeadlineUnmeetable when even the least-loaded replica's observed
        rate cannot meet `deadline_ms`."""
        if self._closed:
            raise MXNetError("server is closed")
        # disaggregated fleets admit at the prefill specialists first
        order = self._pick_order(
            "prefill" if self._roles is not None else None)
        if not order:
            raise NoHealthyReplicas(
                "no healthy replicas (all %d drained)" % len(self.replicas))
        for i in order:
            try:
                req = self.replicas[i].submit(
                    prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                    count_reject=False, tenant=tenant, priority=priority,
                    deadline_ms=deadline_ms, trace=trace)
                req.replica = i          # where the router placed it
                # counted on placement (or final rejection), never per
                # HTTP retry attempt
                self._c_requests.inc()
                return req
            except (QueueFull, IndexError):
                # IndexError: a scale_down retired this index between the
                # pick and the submit — fall through to the next
                continue
        if count_reject:
            self._final_reject()
        raise QueueFull(
            "all %d replicas saturated; retry after %.0fs"
            % (len(order), self.retry_after_s or 1.0))

    def generate(self, prompt, max_new_tokens=32, eos_id=None,
                 timeout=None):
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id).result(timeout)

    def _final_reject(self):
        self._c_requests.inc()
        self._c_rejected.inc()

    # -- observability -------------------------------------------------------

    def health(self, max_beat_age=None):
        """Fleet liveness for /healthz: `ok` while ANY replica serves
        (degraded-not-dead). Per-replica statuses are the dicts the
        drain/restore/respawn sweep judged; a circuit-open replica is
        reported apart from a merely drained one."""
        reps = self._sweep(max_beat_age=max_beat_age)
        for i, h in enumerate(reps):
            h["replica"] = i
            h["drained"] = self._drained[i]
            # the sweep may have opened a circuit after stamping this
            h["circuit_open"] = self._circuit_open[i]
        ok_n = sum(1 for h in reps if h["ok"])
        return {
            "ok": bool(ok_n > 0 and not self._closed),
            "degraded": bool(ok_n < len(reps)),
            "replicas_total": len(reps),
            "replicas_healthy": ok_n,
            "replicas_circuit_open": sum(self._circuit_open),
            "replicas": reps,
        }

    def snapshot(self):
        """Per-replica snapshots plus summed aggregates (the JSON
        /metrics body); retired replicas' request ledgers seed the sums."""
        snaps = [rep.snapshot() for rep in self.replicas]
        agg_req = dict(self._retired_requests)
        for s in snaps:
            for k, v in s["requests"].items():
                agg_req[k] = agg_req.get(k, 0) + v
        plook = sum(s.get("cache", {}).get("prefix", {})
                    .get("lookups", 0) for s in snaps)
        phits = sum(s.get("cache", {}).get("prefix", {})
                    .get("hits", 0) for s in snaps)
        return {
            "replicas": snaps,
            "aggregate": {
                "requests": agg_req,
                "tokens_generated": sum(
                    s["throughput"]["tokens_generated"] for s in snaps),
                "decode_steps": sum(
                    s["throughput"]["decode_steps"] for s in snaps),
                "queued": sum(s.get("scheduler", {}).get("queued", 0)
                              for s in snaps),
                "prefix_lookups": plook,
                "prefix_hits": phits,
                "prefix_hit_rate": (phits / plook) if plook else None,
                "replicas_total": len(snaps),
                "replicas_drained": sum(self._drained),
                "replicas_circuit_open": sum(self._circuit_open),
                "failovers": sum(s["requests"].get("failovers", 0)
                                 for s in snaps),
                "migrations": sum(s["requests"].get("migrations", 0)
                                  for s in snaps),
                "respawns": int(self._c_respawn.value),
                "orphaned": int(self._c_orphaned.value),
            },
            "router": self.registry.snapshot(),
        }

    def statusz(self):
        """Fleet /statusz: per-replica SLO/goodput bodies plus an exact
        aggregate — token ledgers (retired replicas' folded in), per-
        tenant sums, and fleet burn recomputed from the SUMMED window
        deltas (`telemetry.slo.merge_slo`), never averaged."""
        from ..telemetry import slo as _slo
        bodies = [rep.statusz() for rep in self.replicas]
        tokens = dict(self._retired_tokens)
        tenants = {name: {"tokens": dict(acc)}
                   for name, acc in self._retired_tenants.items()}
        for b in bodies:
            for k, v in b["tokens"].items():
                tokens[k] = tokens.get(k, 0) + v
            for name, t in b["tenants"].items():
                agg = tenants.setdefault(name, {"tokens": {}})
                for k, v in t["tokens"].items():
                    agg["tokens"][k] = agg["tokens"].get(k, 0) + v
        fleet = {
            "replicas_total": len(self.replicas),
            "replicas_drained": sum(self._drained),
            "replicas_circuit_open": sum(self._circuit_open),
            "tokens": tokens,
            "tenants": tenants,
            "slo": _slo.merge_slo([b["slo"] for b in bodies]),
        }
        if self._roles is not None:
            # per-role aggregates, on disaggregated fleets only: the live
            # layout and the migration ledger summed over replicas
            role_agg = {}
            for j, rn in enumerate(self._role):
                if rn is None:
                    continue
                acc = role_agg.setdefault(rn, {"replicas": 0, "healthy": 0})
                acc["replicas"] += 1
                if j < len(self._drained) and not self._drained[j]:
                    acc["healthy"] += 1
            fleet["roles"] = role_agg
            fleet["migrations"] = sum(
                r.metrics.migrations for r in self.replicas)
            fleet["migration_tokens"] = sum(
                r.metrics.migration_tokens for r in self.replicas)
            fleet["migration_bytes_saved"] = sum(
                r.metrics.migration_bytes_saved for r in self.replicas)
        if self.rollout is not None:
            # present only with a controller attached, so a rollout-less
            # body stays as it was
            fleet["rollout"] = self.rollout.status()
        return {"replicas": bodies, "fleet": fleet}

    def prometheus_text(self):
        """ONE Prometheus exposition over every replica registry plus the
        router's own — each sample labeled `replica="<i>"` (or
        `"router"`), HELP/TYPE once per metric name."""
        for rep in self.replicas:
            rep.metrics._refresh_gauges(rep.engine, rep.scheduler)
            rep.metrics.slo.update()
        return telemetry.merged_prometheus_text(
            [rep.metrics.registry for rep in self.replicas]
            + [self.registry])

    # -- lifecycle -----------------------------------------------------------

    def close(self, drain=True, timeout=30.0):
        """Close every replica. One replica's leak-audit raise must not
        leave the rest running and the HTTP port bound: every replica is
        closed, and the first error re-raises at the end."""
        self._closed = True
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if self.rollout is not None:
            self.rollout.stop()
        first_err = None
        for rep in list(self.replicas):
            try:
                rep.close(drain=drain, timeout=timeout)
            except Exception as e:
                if first_err is None:
                    first_err = e
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if first_err is not None:
            raise first_err

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
