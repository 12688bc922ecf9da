"""Unified telemetry of the port: metrics registry, span tracing, crash
flight recorder, SLO engine, anomaly detector (port of
`mxnet_tpu/telemetry/`).

  * `metrics` — counters / gauges / fixed-bucket histograms labeled by
    host/replica, with Prometheus text exposition and a JSON snapshot
    (`default_registry()` is the process-wide instance; the serving
    stack builds one per server).
  * `tracing` — `span(name, trace=..., **attrs)` context manager; spans
    sharing a trace id (serving: the request's trace id) render as one
    connected row in the Perfetto JSON export and feed the chrome-trace
    recorder (`profiler.dump()`).
  * `flight` — a bounded ring of recent spans/flagged-metric/fault
    events that dumps to `MXNET_FLIGHT_RECORDER_DIR` on serving-loop
    death or /healthz wedge detection; rendered by `tools/postmortem.py`.
  * `introspect` — the compile watchdog over the port's compile sites
    (kernel builds, exports, AOTInductor, NVRTC, the first runs of the
    framework's steps), with the HBM and compile budgets and the comms
    ledger.
  * `slo` — objectives, burn rates and the request lifecycle log.
  * `anomaly` — EWMA z-score detectors over loss and grad-norm.

Master switch: `MXNET_TELEMETRY` (default on; `0` turns every recording
site into a no-op).
"""
from . import metrics
from . import tracing
from . import flight as _flight_mod
from . import introspect
from . import slo
from . import anomaly

from .metrics import (enabled, Counter, Gauge, Histogram, MetricsRegistry,
                      default_registry, DEFAULT_BUCKETS,
                      merged_prometheus_text)
from .tracing import (span, record_span, current_trace, set_trace,
                      spans, export_perfetto, new_trace_id,
                      parse_traceparent, format_traceparent)
from .flight import FlightRecorder, flight
from .introspect import (watchdog, instrument, compile_events,
                         compile_region, site_comms,
                         CompileBudgetExceeded, HbmBudgetExceeded)
from .slo import (Objective, SLOTracker, parse_slo_env, parse_windows,
                  merge_slo, request_log, request_event)
from .anomaly import EwmaDetector, AnomalyDetector


def counter(name, help="", flight=False):
    """Counter on the default registry."""
    return default_registry().counter(name, help=help, flight=flight)


def gauge(name, help=""):
    """Gauge on the default registry."""
    return default_registry().gauge(name, help=help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS):
    """Histogram on the default registry."""
    return default_registry().histogram(name, help=help, buckets=buckets)


def snapshot():
    """JSON snapshot of the default registry."""
    return default_registry().snapshot()


def prometheus_text():
    """Prometheus exposition of the default registry."""
    return default_registry().prometheus_text()
