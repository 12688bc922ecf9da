"""Crash flight recorder: a black box for training and serving processes
(port of `mxnet_tpu/telemetry/flight.py`; same dump names and layout, so
`tools/postmortem.py` renders the port's dumps unchanged).

A bounded ring buffer of recent happenings — closed spans, flagged metric
increments (bad steps, rollbacks, retries, engine failures), chaos fault
injections — that costs a deque append while the process is healthy and
dumps to disk the moment something goes wrong:

  * SIGTERM / preemption notice (`parallel.resilient.PreemptionWatcher`
    dumps before the drain starts);
  * an unhandled serving-loop fault (`LMServer._loop`);
  * `/healthz` wedge detection (first `health()` call that observes a
    dead-or-stalled loop);
  * explicitly, via `flight().dump(reason)`.

Dumps land in `MXNET_FLIGHT_RECORDER_DIR` as one JSON file per dump
(`flight-host<h>-pid<p>-<n>.<reason>.json`) carrying the ring, the
process labels, and a snapshot of the default metrics registry — enough
for `tools/postmortem.py` to render a human-readable timeline of a dead
pod's last seconds. With the env var unset, recording still happens (the
in-process ring is readable by tests/tools) but nothing is written to
disk unless a dump path is passed explicitly.

Ring size: `MXNET_FLIGHT_RECORDER_RING` (default 512 events).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from .metrics import enabled, _host_label, default_registry


class FlightRecorder:
    def __init__(self, capacity=None):
        if capacity is None:
            capacity = int(os.environ.get("MXNET_FLIGHT_RECORDER_RING",
                                          "512"))
        self.capacity = int(capacity)
        self._ring = deque(maxlen=self.capacity)
        # REENTRANT: dump() may run inside a signal handler (a SIGTERM
        # drain), which Python executes on the main thread — possibly
        # interrupting a record() that already holds this lock. A plain
        # Lock would deadlock the handler; with an RLock the re-entry is
        # safe (the guarded deque ops are single C calls a signal can't
        # split).
        self._lock = threading.RLock()
        self._dumps = 0
        self._wall0 = time.time()
        self._perf0 = time.perf_counter()

    # -- recording -----------------------------------------------------------
    def record(self, kind, name, **data):
        """Append one event. `kind` is 'span' | 'metric' | 'event' |
        'fault'; `data` must be JSON-able (the dump writes it as-is)."""
        if not enabled():
            return
        ev = {"t": time.time(), "kind": kind, "name": name}
        if data:
            ev.update(data)
        with self._lock:
            self._ring.append(ev)

    def events(self):
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()

    # -- dumping -------------------------------------------------------------
    def dump_dir(self):
        return os.environ.get("MXNET_FLIGHT_RECORDER_DIR")

    def dump(self, reason, path=None):
        """Write the black box to disk. Returns the path, or None when no
        directory is configured and no explicit path was given. Never
        raises: a failing dump must not mask the fault being dumped."""
        try:
            if path is None:
                d = self.dump_dir()
                if not d:
                    return None
                os.makedirs(d, exist_ok=True)
                with self._lock:
                    self._dumps += 1
                    n = self._dumps
                path = os.path.join(
                    d, "flight-host%s-pid%d-%d.%s.json"
                    % (_host_label(), os.getpid(), n,
                       "".join(c if c.isalnum() or c in "-_" else "_"
                               for c in str(reason))))
            doc = {
                "reason": str(reason),
                "host": _host_label(),
                "pid": os.getpid(),
                "dumped_at": time.time(),
                "ring_capacity": self.capacity,
                "events": self.events(),
                "metrics": default_registry().snapshot(),
            }
            tmp = path + ".tmp-%d" % os.getpid()
            with open(tmp, "w") as f:
                json.dump(doc, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            return path
        except Exception:
            return None


_flight = None
_flight_lock = threading.Lock()


def flight():
    """The process-wide flight recorder (created on first use)."""
    global _flight
    if _flight is None:
        with _flight_lock:
            if _flight is None:
                _flight = FlightRecorder()
    return _flight
