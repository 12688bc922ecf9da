"""SLO engine + per-request lifecycle ledger (port of
`mxnet_tpu/telemetry/slo.py`).

Two halves of "what does the fleet owe its tenants, and is it paying?":

* **Objectives & burn rates** — declare service-level objectives (TTFT,
  inter-token latency, availability) fleet-wide or per tenant via the
  `MXNET_SLO_*` env knobs (docs/ENV_VARS.md). An `SLOTracker` rides each
  `ServingMetrics` registry and derives, FROM THE EXISTING HISTOGRAMS
  (no second measurement path): per-objective attainment (fraction of
  observations meeting the threshold), multi-window burn rates (SRE
  convention: observed bad fraction over the window divided by the
  error budget `1 - target`; a burn rate of 1.0 spends the budget
  exactly at the objective's horizon, >> 1 is an alarm), and
  error-budget-remaining gauges. All of it lands in the registry
  (`slo_<objective>_attainment`, `slo_<objective>_burn_rate_<window>s`,
  `slo_<objective>_budget_remaining`) so the merged Prometheus
  exposition carries it, and in the `/statusz` JSON endpoint both
  serving fronts expose.

* **Request lifecycle ledger** — every request's life (queued →
  shed/admitted → prefill chunks → first token → per-decode-step ITL →
  failover replay → finish/expire) streams as sampled JSONL to
  `MXNET_REQUEST_LOG` (sample fraction `MXNET_REQUEST_LOG_SAMPLE`,
  deterministic per trace id so one request's events are all-or-nothing
  even across a failover hop). The schema is pinned
  (`REQUEST_LOG_EVENTS` / `REQUEST_LOG_REQUIRED`, tests/test_slo.py).
  Failover-implicated requests additionally mirror their coarse
  lifecycle events into the crash flight recorder, so a postmortem
  timeline shows the victims' lifecycles interleaved with the faults
  that moved them.

Token accounting (the goodput ledger the /statusz identity test pins):
every request is classified EXACTLY ONCE, at its terminal state —
delivered tokens are *goodput* (met the SLO) or *slow* (delivered but
SLO-violating), refused work is *shed* (admission-time unmeetable
deadline, brownout), *expired* (deadline/queue timeout passed while
queued), or *failed* (engine fault, orphaned). `submitted` increments by
the same amount at the same moment, so
``submitted == goodput + slow + shed + expired + failed`` holds at every
instant (with no SLO configured, `slow` is zero and the four-term
identity holds verbatim). Failover replays additionally
count their salvaged tokens as *replayed* — extra work performed, not a
fifth terminal class.
"""
from __future__ import annotations

import bisect
import json
import os
import threading
import time
import zlib
from collections import deque

from .metrics import enabled

#: default burn-rate windows (seconds) — the SRE multi-window pattern:
#: a fast window pages, a slow window tickets. MXNET_SLO_WINDOWS
#: overrides ("60,300,3600").
DEFAULT_WINDOWS = (60, 300, 3600)

#: objective kinds and their histogram/counter sources + default targets
_KINDS = {
    "ttft": {"target": 0.95},
    "itl": {"target": 0.99},
    "availability": {"target": 0.999},
}

#: gauge-name templates (docs/OBSERVABILITY.md names these with
#: `<objective>`/`<window>` placeholders; the doc-drift check maps them
#: back onto these literals)
_ATTAIN = "slo_%s_attainment"
_BURN = "slo_%s_burn_rate_%ss"
_BUDGET = "slo_%s_budget_remaining"

#: the pinned request-log schema (tests/test_slo.py): every line is one
#: JSON object carrying at least REQUEST_LOG_REQUIRED, with `event` in
#: REQUEST_LOG_EVENTS
REQUEST_LOG_VERSION = 1
REQUEST_LOG_EVENTS = ("queued", "admitted", "shed", "expired",
                      "prefill_chunk", "first_token", "decode",
                      "failover", "finish")
REQUEST_LOG_REQUIRED = ("ts", "event", "request", "trace", "tenant")

#: coarse lifecycle events mirrored into the flight recorder for
#: failover-implicated requests (per-decode-step events would evict the
#: bounded ring's history — the black box keeps transitions, not tokens)
_FLIGHT_EVENTS = ("queued", "admitted", "first_token", "failover",
                  "finish", "shed", "expired")


def _sane_tenant(name):
    from .metrics import _sane
    return _sane(str(name))


class Objective:
    """One declared SLO: `kind` in ('ttft', 'itl', 'availability'),
    `threshold_s` (None for availability — its unit is outcomes, not
    latency), `target` the required good fraction, `tenant` None for
    fleet-wide."""

    def __init__(self, kind, threshold_s=None, target=None, tenant=None):
        if kind not in _KINDS:
            raise ValueError("unknown SLO kind %r (know %s)"
                             % (kind, ", ".join(sorted(_KINDS))))
        self.kind = kind
        self.threshold_s = (float(threshold_s)
                            if threshold_s is not None else None)
        self.target = float(target if target is not None
                            else _KINDS[kind]["target"])
        if not 0.0 < self.target < 1.0:
            raise ValueError("SLO target must be in (0, 1), got %r"
                             % target)
        self.tenant = str(tenant) if tenant is not None else None

    @property
    def budget(self):
        """Error budget: the tolerable bad fraction."""
        return 1.0 - self.target

    @property
    def key(self):
        """Sanitized metric-name stem: `ttft`, `itl_tenant_acme`, …"""
        if self.tenant is None:
            return self.kind
        return "%s_tenant_%s" % (self.kind, _sane_tenant(self.tenant))

    def describe(self):
        return {"objective": self.kind, "tenant": self.tenant,
                "threshold_ms": (round(self.threshold_s * 1e3, 3)
                                 if self.threshold_s is not None
                                 else None),
                "target": self.target}


def _parse_entries(name, raw, latency):
    """Entries out of one MXNET_SLO_* value: comma-separated
    `[tenant=]threshold_ms[:target]` (latency kinds) or
    `[tenant=]target` (availability). Raises naming the env var on
    malformed values — a half-armed SLO must fail loudly at
    construction, not silently report no burn."""
    out = []
    for entry in str(raw).split(","):
        entry = entry.strip()
        if not entry:
            continue
        tenant = None
        if "=" in entry:
            tenant, entry = entry.split("=", 1)
            tenant = tenant.strip() or None
        try:
            if latency:
                parts = entry.split(":")
                if len(parts) > 2:
                    raise ValueError(entry)
                threshold_s = float(parts[0]) / 1e3
                target = float(parts[1]) if len(parts) == 2 else None
            else:
                threshold_s, target = None, float(entry)
            if target is not None and not 0.0 < target < 1.0:
                # out-of-range targets fail HERE so the error names the
                # knob (99.9 is a percent, not a fraction — the most
                # likely operator slip)
                raise ValueError(entry)
            out.append((tenant, threshold_s, target))
        except ValueError:
            raise ValueError(
                "%s must be comma-separated %s entries with target a "
                "fraction in (0, 1), got %r"
                % (name, "[tenant=]<threshold_ms>[:<target>]" if latency
                   else "[tenant=]<target>", raw))
    return out


def parse_slo_env(environ=None):
    """The declared objectives: MXNET_SLO_TTFT_MS / MXNET_SLO_ITL_MS
    (comma-separated `[tenant=]threshold_ms[:target]`; default targets
    0.95 / 0.99) and MXNET_SLO_AVAILABILITY (`[tenant=]target`,
    fraction of terminal requests that must complete without error).
    Unset knobs declare nothing — the SLO layer then only keeps the
    token ledger."""
    env = os.environ if environ is None else environ
    objectives = []
    for kind, var, latency in (("ttft", "MXNET_SLO_TTFT_MS", True),
                               ("itl", "MXNET_SLO_ITL_MS", True),
                               ("availability", "MXNET_SLO_AVAILABILITY",
                                False)):
        raw = env.get(var)
        if not raw:
            continue
        for tenant, threshold_s, target in _parse_entries(var, raw,
                                                          latency):
            objectives.append(Objective(kind, threshold_s=threshold_s,
                                        target=target, tenant=tenant))
    return objectives


def burn_rate(good, total, budget):
    """Burn rate over one window: observed bad fraction / error budget
    (1.0 spends the budget exactly at the window's horizon; an empty
    window burns nothing). THE formula — gauges, /statusz payloads, and
    the fleet merge all call this one definition."""
    return ((total - good) / total / budget) if total else 0.0


def budget_remaining(good, total, budget):
    """Lifetime error budget left: 1 = untouched, <= 0 = spent (may go
    negative — overspend is information). No observations = untouched."""
    return (1.0 - (total - good) / (total * budget)) if total else 1.0


def parse_windows(environ=None):
    """Burn-rate windows in seconds (MXNET_SLO_WINDOWS, default
    60,300,3600)."""
    env = os.environ if environ is None else environ
    raw = env.get("MXNET_SLO_WINDOWS")
    if not raw:
        return DEFAULT_WINDOWS
    try:
        windows = tuple(sorted({int(w) for w in str(raw).split(",")
                                if w.strip()}))
        if not windows or any(w <= 0 for w in windows):
            raise ValueError(raw)
    except ValueError:
        raise ValueError("MXNET_SLO_WINDOWS must be comma-separated "
                         "positive seconds, got %r" % raw)
    return windows


class SLOTracker:
    """Burn-rate accounting for one ServingMetrics registry.

    `counts_fn(objective)` returns the objective's LIFETIME
    `(good, total)` — derived from the registry's own histograms and
    counters, so /statusz can never disagree with /metrics. `update()`
    (called on every read path) snapshots those counts into a bounded
    time ring and refreshes the attainment / burn-rate /
    budget-remaining gauges; `payload()` renders the /statusz block,
    including the raw per-window good/total deltas so a multi-replica
    front door can SUM trackers and recompute fleet burn exactly
    (`merge_slo`)."""

    def __init__(self, registry, counts_fn, objectives=None,
                 windows=None):
        self.registry = registry
        self.counts_fn = counts_fn
        self.objectives = (parse_slo_env() if objectives is None
                           else list(objectives))
        self.windows = tuple(parse_windows() if windows is None
                             else windows)
        self._lock = threading.Lock()
        self._ring = deque()          # (t, {key: (good, total)})
        self._gauges = {}

    def _gauge(self, name, help=""):
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = self.registry.gauge(name, help=help)
        return g

    def ttft_threshold(self, tenant):
        """The TTFT objective governing `tenant` (tenant-scoped wins
        over fleet-wide), or None — the goodput classifier's question."""
        fleet = None
        for obj in self.objectives:
            if obj.kind != "ttft":
                continue
            if obj.tenant == tenant:
                return obj.threshold_s
            if obj.tenant is None:
                fleet = obj.threshold_s
        return fleet

    def update(self, now=None):
        """Snapshot lifetime counts and refresh every SLO gauge."""
        self._refresh(now)

    def _refresh(self, now=None):
        """ONE pass per read: compute lifetime counts, append the ring
        sample, derive per-window deltas, set every gauge — and return
        {key: (good, total, {window: (good_d, total_d, span_s)})} so
        payload() never recomputes what the gauges were just set from
        (a 3600s window scraped at 1 Hz makes the ring scan real
        work)."""
        if not self.objectives:
            return {}
        now = time.time() if now is None else now
        counts = {obj.key: self.counts_fn(obj) for obj in self.objectives}
        with self._lock:
            self._ring.append((now, counts))
            horizon = now - max(self.windows) - 60.0
            while len(self._ring) > 1 and self._ring[0][0] < horizon:
                self._ring.popleft()
            ring = list(self._ring)
        # ONE ring copy per refresh, window bases found by bisecting
        # the (time-sorted) timestamps — at 1 Hz scrapes a 3600s window
        # holds ~3700 samples, and a linear scan per objective per
        # window would be real work on the serving host
        ts = [t for t, _ in ring]
        out = {}
        for obj in self.objectives:
            good, total = counts[obj.key]
            # no observations yet -> nothing violated: attainment 1.0
            # (a cold replica must not read as burning)
            attain = (good / total) if total else 1.0
            self._gauge(_ATTAIN % obj.key,
                        help="fraction of observations meeting the "
                             "%s objective" % obj.kind).set(attain)
            self._gauge(_BUDGET % obj.key,
                        help="error budget remaining (1 = untouched, "
                             "<= 0 = spent)").set(
                budget_remaining(good, total, obj.budget))
            deltas = self._window_deltas(obj, now, ring, ts)
            for w, (gd, td, _span) in deltas.items():
                self._gauge(_BURN % (obj.key, w),
                            help="error-budget burn rate over the "
                                 "window (1.0 spends the budget at the "
                                 "horizon)").set(
                    burn_rate(gd, td, obj.budget))
            out[obj.key] = (good, total, deltas)
        return out

    def _window_deltas(self, obj, now, ring=None, ts=None):
        """{window_s: (good_delta, total_delta, actual_span_s)} against
        the oldest ring sample inside each window (the ring may be
        younger than the window — the actual span is reported so
        /statusz never overstates its evidence). `ring`/`ts` are the
        caller's pre-copied snapshot (one copy per refresh, shared by
        every objective); bases are found by bisect on the time-sorted
        timestamps."""
        if ring is None:
            with self._lock:
                ring = list(self._ring)
            ts = [t for t, _ in ring]
        if not ring:
            return {w: (0, 0, 0.0) for w in self.windows}
        t_now, cur = ring[-1]
        out = {}
        for w in self.windows:
            i = bisect.bisect_left(ts, t_now - w)
            base_t, base = ring[min(i, len(ring) - 1)]
            g0, t0 = base.get(obj.key, (0, 0))
            g1, t1 = cur.get(obj.key, (0, 0))
            out[w] = (max(0.0, g1 - g0), max(0.0, t1 - t0),
                      max(0.0, t_now - base_t))
        return out

    def payload(self, now=None):
        """The /statusz `slo` block: one dict per objective with
        attainment, budget remaining, and per-window burn (carrying the
        raw good/total deltas for exact fleet merging)."""
        if not self.objectives:
            return []
        computed = self._refresh(now)
        out = []
        for obj in self.objectives:
            good, total, deltas = computed[obj.key]
            d = obj.describe()
            d.update(good=round(good, 3), total=round(total, 3),
                     attainment=(round(good / total, 6) if total
                                 else None),
                     budget_remaining=round(
                         budget_remaining(good, total, obj.budget), 6),
                     burn={})
            for w, (gd, td, span) in deltas.items():
                d["burn"]["%ss" % w] = {
                    "rate": round(burn_rate(gd, td, obj.budget), 6),
                    "good": round(gd, 3),
                    "total": round(td, 3), "span_s": round(span, 3)}
            out.append(d)
        return out


def merge_slo(payloads):
    """Fleet view over several replicas' /statusz `slo` blocks: same
    objective (kind + tenant + threshold + target) sums its lifetime
    and per-window good/total across replicas, and burn/attainment are
    recomputed from the sums — NOT averaged, so an idle replica can't
    dilute a burning one."""
    merged = {}
    for block in payloads:
        for d in block or []:
            key = (d.get("objective"), d.get("tenant"),
                   d.get("threshold_ms"), d.get("target"))
            m = merged.get(key)
            if m is None:
                m = merged[key] = {
                    "objective": d.get("objective"),
                    "tenant": d.get("tenant"),
                    "threshold_ms": d.get("threshold_ms"),
                    "target": d.get("target"),
                    "good": 0.0, "total": 0.0, "burn": {}}
            m["good"] += d.get("good") or 0
            m["total"] += d.get("total") or 0
            for w, b in (d.get("burn") or {}).items():
                mw = m["burn"].setdefault(
                    w, {"good": 0.0, "total": 0.0, "span_s": 0.0})
                mw["good"] += b.get("good") or 0
                mw["total"] += b.get("total") or 0
                mw["span_s"] = max(mw["span_s"], b.get("span_s") or 0)
    out = []
    for m in merged.values():
        budget = 1.0 - float(m["target"])
        total = m["total"]
        m["attainment"] = (round(m["good"] / total, 6) if total
                           else None)
        m["budget_remaining"] = round(
            budget_remaining(m["good"], total, budget), 6)
        for w, b in m["burn"].items():
            b["rate"] = round(burn_rate(b["good"], b["total"], budget),
                              6)
        out.append(m)
    out.sort(key=lambda m: (m["objective"], m["tenant"] or ""))
    return out


# ---------------------------------------------------------------------------
# request lifecycle ledger: sampled JSONL + flight mirroring
# ---------------------------------------------------------------------------


class RequestLog:
    """Append-only JSONL stream of request lifecycle events.

    Enabled by `MXNET_REQUEST_LOG=<path>`; `MXNET_REQUEST_LOG_SAMPLE`
    (default 1.0) keeps that fraction of requests, decided
    DETERMINISTICALLY from the trace id (crc32), so a sampled request
    stays sampled across replicas and failover hops and an unsampled
    one never leaves half a lifecycle. Env is re-read per event, so the
    log can be pointed somewhere (or off) mid-process; the file handle
    is cached per path and writes are line-atomic under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._path = None
        self._fh = None

    @property
    def enabled(self):
        return bool(os.environ.get("MXNET_REQUEST_LOG"))

    def sample_rate(self):
        raw = os.environ.get("MXNET_REQUEST_LOG_SAMPLE")
        if not raw:
            return 1.0
        try:
            rate = float(raw)
        except ValueError:
            rate = -1.0
        if not 0.0 <= rate <= 1.0:
            # "50" meaning 50% must fail loudly, not silently clamp to
            # full-volume logging (same contract as the MXNET_SLO_*
            # percent-vs-fraction guard)
            raise ValueError("MXNET_REQUEST_LOG_SAMPLE must be a "
                             "fraction in [0, 1], got %r" % raw)
        return rate

    def sampled(self, trace):
        try:
            rate = self.sample_rate()
        except ValueError:
            # the knob is validated LOUDLY at ServingMetrics
            # construction; a malformed value flipped in mid-process is
            # downgraded here to full sampling + a one-time warning —
            # event() runs on the serving thread, where a config typo
            # must never read as a loop death
            if not getattr(self, "_warned_sample", False):
                self._warned_sample = True
                import warnings
                warnings.warn("malformed MXNET_REQUEST_LOG_SAMPLE %r "
                              "ignored (logging every request)"
                              % os.environ.get(
                                  "MXNET_REQUEST_LOG_SAMPLE"))
            rate = 1.0
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        h = zlib.crc32(str(trace).encode()) & 0xffffffff
        return h / 4294967296.0 < rate

    def event(self, event, req, replica=None, **fields):
        """Append one lifecycle event for `req` (needs .id/.trace/
        .tenant). Silently a no-op when the log is off, the request is
        unsampled, or telemetry is killed; a failing write disables
        nothing but never raises into the serving loop."""
        if not enabled():
            return None
        path = os.environ.get("MXNET_REQUEST_LOG")
        if not path:
            return None
        trace = getattr(req, "trace", None)
        if not self.sampled(trace):
            return None
        rec = {"ts": time.time(), "event": str(event),
               "request": getattr(req, "id", None), "trace": trace,
               "tenant": getattr(req, "tenant", None)}
        if replica is not None:
            rec["replica"] = replica
        for k, v in fields.items():
            if v is not None:
                rec[k] = v
        line = json.dumps(rec, default=str) + "\n"
        try:
            with self._lock:
                if self._fh is None or self._path != path:
                    if self._fh is not None:
                        self._fh.close()
                    self._fh = open(path, "a")
                    self._path = path
                self._fh.write(line)
                self._fh.flush()
        except OSError:
            return None
        return rec


_log = None
_log_lock = threading.Lock()


def request_log():
    """The process-wide request log (created on first use)."""
    global _log
    if _log is None:
        with _log_lock:
            if _log is None:
                _log = RequestLog()
    return _log


def request_event(event, req, replica=None, **fields):
    """One lifecycle transition: streamed to the sampled JSONL request
    log, and — for failover-implicated requests (the event is the hop
    itself, or the request already spent a hop) — mirrored as a coarse
    event into the crash flight recorder, so `tools/postmortem.py`
    timelines show the victims' lifecycles next to the faults that
    moved them."""
    if not enabled():
        return
    request_log().event(event, req, replica=replica, **fields)
    if event in _FLIGHT_EVENTS and (
            event == "failover" or getattr(req, "failovers", 0)):
        from .flight import flight
        flight().record("event", "request.%s" % event,
                        request=getattr(req, "id", None),
                        trace=getattr(req, "trace", None),
                        tenant=getattr(req, "tenant", None),
                        replica=replica, **fields)
