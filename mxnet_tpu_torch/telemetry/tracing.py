"""Span tracing: one request's (or train step's) life as a connected trace
(port of `mxnet_tpu/telemetry/tracing.py`).

`span(name, trace=..., **attrs)` is a context manager timing a region.
Every closed span is recorded three ways:

  * the legacy chrome-trace recorder (`profiler.record_event`, when the
    profiler is running) — so existing `profiler.dump()` traces gain the
    serving/training spans alongside the op-level events;
  * the in-process span ring (bounded; `export_perfetto()` turns it into
    a Perfetto-loadable JSON trace where every trace id is its own row);
  * the flight recorder ring (`telemetry.flight`) — the post-mortem
    record of "what was this process doing right before it died".

Trace ids connect spans: the serving stack uses the request id, so one
request's submit → queue → prefill chunks → decode steps all share an id
and render as a single row. Ids propagate implicitly to nested spans via
a thread-local (set once at the root span, inherited below), or
explicitly with `span(..., trace=id)` / `record_span(..., trace=id)` for
regions timed outside a `with` block (e.g. one decode step fanned out to
every sequence it advanced).
"""
from __future__ import annotations

import itertools
import json
import os
import re
import threading
import time
import uuid
from collections import deque

import zlib

from .. import profiler
from .metrics import enabled, default_registry, _host_label

_ids = itertools.count(1)
_tls = threading.local()

#: closed spans, newest last. Bounded: tracing must be always-on-able
#: without growing without bound; export before the ring wraps (or raise
#: MXNET_TELEMETRY_SPAN_RING).
_ring_size = int(os.environ.get("MXNET_TELEMETRY_SPAN_RING", "8192"))
_spans = deque(maxlen=_ring_size)
_lock = threading.Lock()
#: highest span id the last export_perfetto() saw: an overwrite of a
#: NEWER span is a drop the operator never got to see — it lands on
#: `spans_dropped_total`, and the ring fill rides the
#: `span_ring_occupancy` gauge
_exported_upto = 0


#: cached (counter, gauge) pair — record_span runs once per request per
#: decode step, so it must not pay a locked registry lookup per span.
#: Invalidated when the default registry is reset (a benchmark's
#: per-config isolation): the cached counter identity is checked
#: against the registry's current entry with one plain dict read.
_ring_cache = None
_occupancy_last = -1


def _ring_instruments():
    global _ring_cache
    reg = default_registry()
    cached = _ring_cache
    if cached is not None and cached[0] is reg and \
            reg._metrics.get("spans_dropped_total") is cached[1]:
        return cached[1], cached[2]
    ctr = reg.counter("spans_dropped_total",
                      help="spans evicted from the bounded span ring "
                           "before any export_perfetto() saw them "
                           "(raise MXNET_TELEMETRY_SPAN_RING or "
                           "export more often)")
    gauge = reg.gauge("span_ring_occupancy",
                      help="span-ring fill fraction (len / capacity)")
    _ring_cache = (reg, ctr, gauge)
    return ctr, gauge


# -- W3C trace context (traceparent) ----------------------------------------

#: traceparent: version "-" trace-id "-" parent-id "-" flags
#: (https://www.w3.org/TR/trace-context/); version ff is forbidden and
#: all-zero trace/parent ids are invalid
_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def new_trace_id():
    """A fresh 32-hex W3C-compatible trace id."""
    return uuid.uuid4().hex


def parse_traceparent(value):
    """The trace id out of a W3C `traceparent` header, or None for
    anything malformed (wrong field count, bad charset, all-zero ids,
    the forbidden ff version, bytes, whitespace garbage …). Callers
    MUST treat None as "start a fresh trace", never as an error — a
    client sending garbage must not be able to 500 the frontend."""
    try:
        m = _TRACEPARENT_RE.match(str(value).strip().lower())
    except Exception:
        return None
    if m is None:
        return None
    version, trace_id, parent_id, _flags = m.groups()
    if version == "ff":
        return None
    if trace_id == "0" * 32 or parent_id == "0" * 16:
        return None
    return trace_id


def format_traceparent(trace, parent_id=None, sampled=True):
    """Render a trace id back into a `traceparent` header value. A
    trace id that is not already 32-hex (an in-process id) is folded
    into one deterministically, so the emitted header is always
    well-formed."""
    t = str(trace).lower()
    if not re.match(r"^[0-9a-f]{32}$", t):
        t = uuid.uuid5(uuid.NAMESPACE_OID, str(trace)).hex
    if parent_id is None:
        parent_id = uuid.uuid4().hex[:16]
    return "00-%s-%s-%s" % (t, parent_id, "01" if sampled else "00")


def current_trace():
    """The thread's active trace id, or None."""
    return getattr(_tls, "trace", None)


def set_trace(trace):
    """Set the thread's trace id; returns the previous value (restore it
    when the propagation scope ends)."""
    prev = getattr(_tls, "trace", None)
    _tls.trace = trace
    return prev


def _now_us():
    return time.perf_counter_ns() // 1000


def record_span(name, start_us, dur_us, trace=None, category="trace",
                to_profiler=True, to_flight=True, **attrs):
    """Record one already-timed span. The seam for fan-out: a batched
    decode step is timed once but attributed to every request it
    advanced, so each request's row stays connected. The per-request
    copies only matter to the span ring (their Perfetto rows):
    `to_profiler=False` keeps them out of the chrome trace and
    `to_flight=False` out of the flight-recorder ring, where B duplicate
    copies per decode step would evict the history the black box exists
    to keep (the batch-level span covers the interval in both)."""
    if not enabled():
        return
    if trace is None:
        trace = current_trace()
    rec = {"id": next(_ids), "name": name, "cat": category,
           "trace": trace, "ts": start_us, "dur": dur_us,
           "pid": os.getpid(), "tid": threading.get_ident()}
    if attrs:
        rec["attrs"] = attrs
    global _occupancy_last
    dropped, occupancy = 0, 0.0
    with _lock:
        if len(_spans) == _spans.maxlen \
                and _spans[0]["id"] > _exported_upto:
            # the ring is about to overwrite a span no export has seen:
            # a gap in the next Perfetto row
            dropped = 1
        _spans.append(rec)
        occupancy = len(_spans) / float(_spans.maxlen or 1)
    # quantize the occupancy gauge so a full (or slowly-filling) ring
    # doesn't pay a locked gauge.set per span on the decode hot path;
    # a registry reset (per-config isolation) drops the cached
    # instruments, so the staleness check below re-creates AND re-sets
    # them even at a steady quantized fill
    cache = _ring_cache
    reg = default_registry()
    stale = (cache is None or cache[0] is not reg or
             reg._metrics.get("spans_dropped_total") is not cache[1])
    occ_q = int(occupancy * 128)
    if dropped or stale or occ_q != _occupancy_last:
        ctr, gauge = _ring_instruments()
        if dropped:
            ctr.inc()
        gauge.set(occupancy)
        _occupancy_last = occ_q
    if to_profiler:
        profiler.record_event(name, category, start_us, dur_us,
                              dict(attrs, trace=trace) if attrs
                              else {"trace": trace})
    if to_flight:
        from .flight import flight
        flight().record("span", name, trace=trace, dur_us=dur_us,
                        **attrs)
    return rec


class span:
    """Time a region and record it as a span. Usage:

        with telemetry.span("serving.prefill", trace=req.id, chunk=3):
            ...

    `trace=None` inherits the thread's current trace id; passing an
    explicit id also makes it the thread's current id for the duration
    (nested spans connect automatically)."""

    def __init__(self, name, trace=None, category="trace", **attrs):
        self.name = name
        self.category = category
        self.attrs = attrs
        self._trace = trace
        self._prev = None

    def __enter__(self):
        if self._trace is not None:
            self._prev = set_trace(self._trace)
        self._t0 = _now_us()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now_us()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        record_span(self.name, self._t0, t1 - self._t0,
                    trace=self._trace, category=self.category,
                    **self.attrs)
        if self._trace is not None:
            set_trace(self._prev)
        return False


def spans(trace=None):
    """Recorded spans, oldest first; `trace=` filters to one id."""
    with _lock:
        out = list(_spans)
    if trace is not None:
        out = [s for s in out if s["trace"] == trace]
    return out


def clear():
    """Drop the ring (tests)."""
    global _exported_upto, _occupancy_last
    with _lock:
        _spans.clear()
        _exported_upto = 0
    _occupancy_last = -1


def host_pid(host, pid):
    """Fold a host label into the numeric pid a Perfetto row keys on.
    Traces merged across a pod's hosts (tools/postmortem.py --perfetto)
    can carry the SAME OS pid on different hosts (containers all start
    at pid 1), which would silently merge their rows; folding the host
    into the high digits keeps every host's rows distinct while the low
    digits stay the recognizable OS pid."""
    try:
        h = int(host)
    except (TypeError, ValueError):
        h = zlib.crc32(str(host).encode())
    # 1e9 host slots: numeric pod indices never wrap, and crc32 string
    # labels collide only at ~1/1e9 per pair (the residual window is
    # disclosed here; pids stay well inside exact-int JSON range)
    return (h % 1_000_000_000) * 1_000_000 + int(pid) % 1_000_000


def export_perfetto(path=None):
    """Write the span ring as Perfetto-compatible chrome-trace JSON.

    Each distinct trace id becomes its own thread row (`tid` = trace id,
    named by a thread_name metadata event), so loading the file in
    Perfetto/chrome://tracing shows one request's whole life — queue,
    prefill chunks, decode steps — as a single connected row; untraced
    spans keep their real thread id. The process row folds
    MXNET_HOST_ID into the pid (`host_pid`) and is named
    `host <h> pid <p>`, so exports from different pod hosts can be
    merged without their rows colliding. Returns the trace dict (and
    writes it to `path` when given)."""
    global _exported_upto
    with _lock:
        recs = list(_spans)
        if recs:    # spans up to here have been exported: only younger
            # ones count as dropped if the ring overwrites them
            _exported_upto = max(_exported_upto, recs[-1]["id"])
    host = _host_label()
    events = []
    rows = {}
    pids = {}
    for r in recs:
        tid = r["tid"]
        if r["trace"] is not None:
            # stable small row ids: first-seen order per trace id
            tid = rows.setdefault(r["trace"], 1_000_000 + len(rows))
        pid = host_pid(host, r["pid"])
        pids[pid] = r["pid"]
        ev = {"name": r["name"], "cat": r["cat"], "ph": "X",
              "ts": r["ts"], "dur": r["dur"], "pid": pid,
              "tid": tid,
              "args": dict(r.get("attrs") or {}, trace=r["trace"],
                           span_id=r["id"], host=host)}
        events.append(ev)
    this_pid = host_pid(host, os.getpid())
    pids.setdefault(this_pid, os.getpid())
    for trace, tid in rows.items():
        events.append({"name": "thread_name", "ph": "M",
                       "pid": this_pid, "tid": tid,
                       "args": {"name": "trace %s" % (trace,)}})
    for pid, os_pid in pids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0,
                       "args": {"name": "host %s pid %s"
                                % (host, os_pid)}})
    events.sort(key=lambda e: e.get("ts", 0))
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc
