"""Profiler (port of `mxnet_tpu/profiler.py`).

Parity: reference `src/profiler/` (chrome://tracing JSON events, aggregate
per-op summary table, modes, pause/resume) + `python/mxnet/profiler.py`
(set_config/set_state/dump/pause/resume, custom Domains/Tasks/Counters),
env autostart MXNET_PROFILER_AUTOSTART.

The device trace comes from `torch.profiler`: with
`set_config(xplane_dir=...)` (the reference's key; here it names a
directory of torch.profiler chrome traces) `set_state("run")` starts a
`torch.profiler.profile` over the CPU and, when the card is there, CUDA
activities, and `set_state("stop")` writes its chrome trace into that
directory. This module adds the
reference's UX on top: a Python-side event recorder that emits
chrome://tracing JSON, an aggregate summary table, and the scoped
Task/Frame/Counter API. Nothing here imports torch until a device trace
is asked for.
"""
from __future__ import annotations

import json
import os
import time
import threading
from collections import defaultdict

_state = {"running": False, "config": {"filename": "profile.json",
                                       "aggregate_stats": True},
          "events": [], "lock": threading.Lock(), "device_trace": None,
          # dump bookkeeping: events move to "flushed" once written (so a
          # re-dump never re-emits them into a fresh file) and files we
          # wrote this process are merged into, not clobbered
          "flushed": [], "dumped_to": set()}


def set_config(**kwargs):
    """Parity: profiler.py set_config (filename, profile_all, ...)."""
    _state["config"].update(kwargs)


def _start_device_trace(trace_dir):
    """A torch.profiler session over the CPU and (when present) CUDA
    activities; its chrome trace lands in `trace_dir` at stop."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof, trace_dir


def _stop_device_trace(handle):
    prof, trace_dir = handle
    prof.__exit__(None, None, None)
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, "device-trace-pid%d-%d.json"
                        % (os.getpid(), time.time_ns()))
    prof.export_chrome_trace(path)


def set_state(state="stop", profile_process="worker"):
    if state == "run":
        _state["running"] = True
        trace_dir = _state["config"].get("xplane_dir")
        if trace_dir and _state["device_trace"] is None:
            _state["device_trace"] = _start_device_trace(trace_dir)
    else:
        if _state["device_trace"] is not None:
            handle, _state["device_trace"] = _state["device_trace"], None
            _stop_device_trace(handle)
        _state["running"] = False


def pause(profile_process="worker"):
    _state["running"] = False


def resume(profile_process="worker"):
    _state["running"] = True


def is_running():
    return _state["running"]


def record_event(name, category, start_us, dur_us, args=None):
    if not _state["running"]:
        return
    with _state["lock"]:
        _state["events"].append({"name": name, "cat": category, "ph": "X",
                                 "ts": start_us, "dur": dur_us,
                                 "pid": os.getpid(),
                                 "tid": threading.get_ident(),
                                 "args": args or {}})


def dump(finished=True, profile_process="worker"):
    """Write chrome://tracing JSON (parity: MXDumpProfile).

    Append-safe across multiple dump calls in one process: each call
    DRAINS the pending events (they move to the aggregate-only
    `flushed` list, so `dumps()` keeps seeing them) and merges them
    into the target file's existing traceEvents when this process wrote
    that file before — a re-dump never re-emits already-flushed events
    into a fresh file, and repeated dumps to one filename accumulate
    instead of duplicating. Events are written sorted by `ts` (the
    recording order can interleave across threads)."""
    fname = _state["config"].get("filename", "profile.json")
    # the whole read-merge-write runs under the lock: concurrent dump()
    # calls serialize (neither can discard the other's pending batch),
    # and events are only marked flushed AFTER the write succeeded — a
    # failed write leaves them pending for the next dump
    with _state["lock"]:
        pending = _state["events"]
        existing = []
        if fname in _state["dumped_to"] and os.path.exists(fname):
            try:
                with open(fname) as f:
                    existing = json.load(f).get("traceEvents", [])
            except (OSError, ValueError):
                existing = []
        events = sorted(existing + pending, key=lambda e: e.get("ts", 0))
        with open(fname, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        _state["events"] = []
        _state["flushed"].extend(pending)
        _state["dumped_to"].add(fname)
    return fname


def dumps(reset=False):
    """Aggregate per-op summary table (parity: aggregate_stats.cc)."""
    agg = defaultdict(lambda: [0, 0.0, float("inf"), 0.0])
    with _state["lock"]:
        for e in _state["flushed"] + _state["events"]:
            s = agg[e["name"]]
            s[0] += 1
            s[1] += e["dur"] / 1000.0
            s[2] = min(s[2], e["dur"] / 1000.0)
            s[3] = max(s[3], e["dur"] / 1000.0)
        if reset:
            _state["events"] = []
            _state["flushed"] = []
    lines = ["%-40s %8s %12s %12s %12s %12s" % (
        "Name", "Calls", "Total(ms)", "Min(ms)", "Max(ms)", "Avg(ms)")]
    for name, (calls, total, mn, mx) in sorted(agg.items(),
                                               key=lambda kv: -kv[1][1]):
        lines.append("%-40s %8d %12.3f %12.3f %12.3f %12.3f" % (
            name, calls, total, mn if calls else 0.0, mx, total / max(1, calls)))
    return "\n".join(lines)


class scope:
    """Time a region (used by internal instrumentation and users)."""

    def __init__(self, name, category="user"):
        self._name = name
        self._cat = category

    def __enter__(self):
        self._t0 = time.perf_counter_ns() // 1000
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns() // 1000
        record_event(self._name, self._cat, self._t0, t1 - self._t0)


class Domain:
    """Parity: profiler.py Domain — grouping namespace for tasks/counters."""

    def __init__(self, name):
        self.name = name

    def new_task(self, name):
        return Task(self, name)

    def new_counter(self, name, value=None):
        return Counter(self, name, value)

    def new_frame(self, name):
        return Frame(self, name)


class Task:
    def __init__(self, domain, name):
        self.domain = domain
        self.name = name
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter_ns() // 1000

    def stop(self):
        if self._t0 is not None:
            t1 = time.perf_counter_ns() // 1000
            record_event(self.name, self.domain.name, self._t0, t1 - self._t0)
            self._t0 = None


Frame = Task


class Counter:
    def __init__(self, domain, name, value=None):
        self.domain = domain
        self.name = name
        self.value = value or 0

    def set_value(self, value):
        self.value = value
        record_event(self.name, self.domain.name,
                     time.perf_counter_ns() // 1000, 0,
                     {"value": value})

    def increment(self, delta=1):
        self.set_value(self.value + delta)

    def decrement(self, delta=1):
        self.set_value(self.value - delta)


# env autostart (parity: MXNET_PROFILER_AUTOSTART / MXNET_PROFILER_MODE,
# docs/faq/env_var.md:105-109)
if os.environ.get("MXNET_PROFILER_MODE"):
    _state["config"]["mode"] = os.environ["MXNET_PROFILER_MODE"]
if os.environ.get("MXNET_PROFILER_AUTOSTART", "0") == "1":
    set_state("run")


class Event(scope):
    """User-timed duration event (parity: profiler.py Event): start/stop
    pairs (or `with`) record one entry under the 'event' category. Rides
    the shared `scope` timing so the clock/format lives in one place."""

    def __init__(self, name):
        super().__init__(name, category="event")
        self.name = name
        self._started = False

    def start(self):
        self.__enter__()
        self._started = True

    def stop(self):
        if self._started:
            self.__exit__()
            self._started = False


class Marker:
    """Instant marker (parity: profiler.py Marker.mark): a zero-duration
    point in the trace, scoped 'process'/'thread'/'global'."""

    def __init__(self, domain, name):
        self.domain = domain
        self.name = name

    def mark(self, scope="process"):
        record_event(self.name, self.domain.name,
                     time.perf_counter_ns() // 1000, 0, {"scope": scope})


def dump_profile():
    """Deprecated alias (parity: profiler.py dump_profile -> dump)."""
    dump(True)


def profiler_set_config(**kwargs):
    """Deprecated alias (parity: profiler_set_config -> set_config)."""
    set_config(**kwargs)


def profiler_set_state(state="stop"):
    """Deprecated alias (parity: profiler_set_state -> set_state)."""
    set_state(state)
