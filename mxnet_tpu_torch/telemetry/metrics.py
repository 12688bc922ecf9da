"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms
(port of `mxnet_tpu/telemetry/metrics.py`).

One `MetricsRegistry` holds named metrics labeled by `host`/`replica`,
readable two ways —

  * `snapshot()`  — a plain JSON-able dict (the test observable and the
    payload a benchmark attaches to each emitted line);
  * `prometheus_text()` — Prometheus text exposition (version 0.0.4),
    what the serving HTTP `/metrics` endpoint serves under
    `Accept: text/plain`.

Histograms are FIXED-BUCKET: `observe(v)` increments one bucket counter
plus a running sum/count, so p50/p95/p99 come from linear interpolation
inside the owning bucket — O(buckets) memory, no per-sample storage, and
the exposition is exactly Prometheus' cumulative `_bucket{le=...}` form.

There is one process-global default registry (`default_registry()`); the
serving stack builds a private registry per `ServingMetrics` so parallel
servers (and tests) never share counters. `MXNET_TELEMETRY=0` turns every
mutation into a no-op (reads still work: snapshots are just empty/zero).
"""
from __future__ import annotations

import bisect
import os
import re
import threading


def enabled():
    """Telemetry master switch: MXNET_TELEMETRY, default on (the
    instruments are a few ns each; production visibility should not be
    opt-in). `0` disables every metric mutation, span record, and flight
    event at the recording site."""
    return os.environ.get("MXNET_TELEMETRY", "1") != "0"


def _host_label():
    """This process's `host` label: MXNET_HOST_ID wins (an emulated
    multi-host run sets it), else the `torch.distributed` rank when a
    process group is already initialized (never initialize one just for
    a label), else 0."""
    env = os.environ.get("MXNET_HOST_ID")
    if env is not None:
        return env
    import sys
    torch = sys.modules.get("torch")
    dist = getattr(torch, "distributed", None) if torch is not None \
        else None
    if dist is not None:
        try:
            if dist.is_available() and dist.is_initialized():
                return str(dist.get_rank())
        except Exception:
            pass
    return "0"


def _replica_label():
    return os.environ.get("MXNET_REPLICA_ID", "0")


_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _sane(name):
    """Prometheus metric-name charset: [a-zA-Z_:][a-zA-Z0-9_:]*."""
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _fmt(v):
    """Prometheus sample-value formatting (no pythonic 'inf'/'nan')."""
    if v != v:
        return "NaN"
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


#: default histogram buckets: seconds-scale latencies from 100 µs to
#: ~2 min (exponential, factor ~2.5) — wide enough for decode steps,
#: train steps, and checkpoint publishes alike.
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0)


class _Metric:
    kind = None

    def __init__(self, registry, name, help=""):
        self.registry = registry
        self.name = name
        self.help = help


class Counter(_Metric):
    """Monotonic counter. `flight=True` mirrors every increment into the
    process flight recorder (the bad-step/retry/preemption events the
    post-mortem timeline is made of)."""

    kind = "counter"

    def __init__(self, registry, name, help="", flight=False):
        super().__init__(registry, name, help)
        self._value = 0.0
        self._flight = flight

    def inc(self, delta=1, **attrs):
        if not enabled():
            return
        with self.registry._lock:
            self._value += delta
        if self._flight:
            from .flight import flight
            flight().record("metric", self.name, delta=delta,
                            value=self._value, **attrs)

    @property
    def value(self):
        return self._value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, registry, name, help=""):
        super().__init__(registry, name, help)
        self._value = 0.0

    def set(self, value):
        if not enabled():
            return
        with self.registry._lock:
            self._value = float(value)

    def inc(self, delta=1):
        if not enabled():
            return
        with self.registry._lock:
            self._value += delta

    def dec(self, delta=1):
        self.inc(-delta)

    @property
    def value(self):
        return self._value


class Histogram(_Metric):
    """Fixed cumulative buckets + sum/count: quantiles without samples."""

    kind = "histogram"

    def __init__(self, registry, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram %r needs at least one bucket"
                             % name)
        self._counts = [0] * (len(self.buckets) + 1)   # +1 = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        if not enabled():
            return
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        with self.registry._lock:
            self._counts[i] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q):
        """Estimated q-quantile (0..1) by linear interpolation inside
        the owning bucket; None when empty. The +Inf bucket clamps to
        the largest finite bound (nothing better is known)."""
        if self.count == 0:
            return None
        rank = q * self.count
        cum = 0
        lo = 0.0
        for i, bound in enumerate(self.buckets):
            prev = cum
            cum += self._counts[i]
            if cum >= rank:
                frac = ((rank - prev) / self._counts[i]
                        if self._counts[i] else 0.0)
                # clamp: float interpolation must not overshoot the
                # bucket's own upper bound
                return min(bound,
                           lo + (bound - lo) * min(1.0, max(0.0, frac)))
            lo = bound
        return self.buckets[-1]

    def count_below(self, value):
        """Estimated number of observations <= `value`, interpolating
        linearly inside the owning bucket (the same convention as
        `quantile`, run in the other direction) — the SLO engine's
        good-event count for a latency threshold. Observations in the
        +Inf bucket are assumed to exceed any finite threshold."""
        value = float(value)
        cum = 0.0
        lo = 0.0
        for i, bound in enumerate(self.buckets):
            c = self._counts[i]
            if value >= bound:
                cum += c
                lo = bound
                continue
            if value > lo and c and bound > lo:
                cum += c * (value - lo) / (bound - lo)
            return cum
        return cum

    @property
    def mean(self):
        return self.sum / self.count if self.count else None


class MetricsRegistry:
    """Named metrics with common labels. Metric creation is idempotent:
    asking for an existing name returns the existing instance (so
    instrumentation sites never need creation-order coordination), but a
    kind mismatch raises."""

    def __init__(self, labels=None):
        self._lock = threading.RLock()
        self._metrics = {}
        self._labels = dict(labels or {})

    # -- creation ------------------------------------------------------------
    def _get(self, cls, name, **kwargs):
        name = _sane(name)
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        "metric %r already registered as %s, not %s"
                        % (name, m.kind, cls.kind))
                return m
            m = cls(self, name, **kwargs)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", flight=False):
        return self._get(Counter, name, help=help, flight=flight)

    def gauge(self, name, help=""):
        return self._get(Gauge, name, help=help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return self._get(Histogram, name, help=help, buckets=buckets)

    # -- reading -------------------------------------------------------------
    def labels(self):
        out = {"host": _host_label(), "replica": _replica_label()}
        out.update(self._labels)
        return out

    def _label_str(self):
        return ",".join('%s="%s"' % (k, str(v).replace('"', '\\"'))
                        for k, v in sorted(self.labels().items()))

    def snapshot(self):
        """JSON-able view: {name: {...}} plus the label set. Histograms
        carry count/sum/mean/p50/p95/p99 and the raw bucket counts (the
        BENCH_* artifact payload)."""
        out = {"labels": self.labels(), "metrics": {}}
        with self._lock:
            metrics = dict(self._metrics)
        for name, m in sorted(metrics.items()):
            if m.kind == "histogram":
                out["metrics"][name] = {
                    "kind": "histogram",
                    "count": m.count,
                    "sum": m.sum,
                    "mean": m.mean,
                    "p50": m.quantile(0.50),
                    "p95": m.quantile(0.95),
                    "p99": m.quantile(0.99),
                    "buckets": {_fmt(b): c for b, c in
                                zip(list(m.buckets) + [float("inf")],
                                    m._counts)},
                }
            else:
                out["metrics"][name] = {"kind": m.kind, "value": m.value}
        return out

    def prometheus_text(self):
        """Prometheus text exposition format 0.0.4. The format is pinned
        by tests: HELP/TYPE comment pairs, label set on every sample,
        cumulative `_bucket{le=...}` + `_sum`/`_count` for histograms,
        trailing newline."""
        return merged_prometheus_text([self])

    def _sample_lines(self, lines, name, m):
        """Append one metric's sample lines (no HELP/TYPE) under this
        registry's label set."""
        labels = self._label_str()
        if m.kind == "histogram":
            cum = 0
            for bound, c in zip(list(m.buckets) + [float("inf")],
                                m._counts):
                cum += c
                lab = '%s,le="%s"' % (labels, _fmt(bound)) if labels \
                    else 'le="%s"' % _fmt(bound)
                lines.append("%s_bucket{%s} %d" % (name, lab, cum))
            lines.append("%s_sum{%s} %s" % (name, labels, _fmt(m.sum)))
            lines.append("%s_count{%s} %d" % (name, labels, m.count))
        else:
            lines.append("%s{%s} %s" % (name, labels, _fmt(m.value)))

    def reset(self):
        """Drop every metric (tests and a benchmark's per-config isolation)."""
        with self._lock:
            self._metrics.clear()


def merged_prometheus_text(registries):
    """One Prometheus exposition over several registries — the
    multi-replica serving front door's `/metrics`: each engine replica
    records into a private registry labeled `replica="<i>"`, and the
    router merges them so every metric name appears ONCE with HELP/TYPE
    and one sample (or histogram series) per replica. Same-name metrics
    must agree on kind (first registry wins the HELP text)."""
    per = []
    for reg in registries:
        with reg._lock:
            per.append((reg, dict(reg._metrics)))
    names = sorted({n for _, ms in per for n in ms})
    lines = []
    for name in names:
        kinds = {ms[name].kind for _, ms in per if name in ms}
        if len(kinds) > 1:
            raise ValueError("metric %r registered with mixed kinds %r "
                             "across registries" % (name, sorted(kinds)))
        meta_done = False
        for reg, ms in per:
            m = ms.get(name)
            if m is None:
                continue
            if not meta_done:
                if m.help:
                    lines.append("# HELP %s %s" % (name, m.help))
                lines.append("# TYPE %s %s" % (name, m.kind))
                meta_done = True
            reg._sample_lines(lines, name, m)
    return "\n".join(lines) + "\n"


_default = MetricsRegistry()


def default_registry():
    """The process-global registry (training loop, checkpoint IO, bench
    instrumentation). Serving builds per-server registries instead."""
    return _default
