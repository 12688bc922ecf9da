"""Compile watchdog and device-memory accounting (port of
`mxnet_tpu/telemetry/introspect.py`).

The reference funnels every jit through one seam that owns the
executable cache. The port runs eagerly, so what it compiles is what its
entry points build or trace on the way, and each of those is a watchdog
site:

  * the kernel libraries (`ops/_cuda.py`: nvcc, site `kernels.<stem>`),
    the NVRTC compiles of `rtc.CudaModule` (`rtc.compile_cubin`) and the
    g++ tree of `cpp_package.build` — `compile_region`s;
  * `predict.export_model` / `export_train_step` (torch.export,
    `predict.export`) and the AOTInductor compiles (`predict.
    compile_for_cpp`) — `compile_region`s;
  * the eager steps the framework owns: `TrainStep` (`train.step`,
    `train.probe`), the serving engine's prefill / decode / spec-score
    steps, the draft and the full-forward adapters (`serving.*`). These
    go through `instrument(fn, site=...)`, the reference's `owned=False`
    path: a first-seen signature is timed WITH its first run (the event
    says so), and later calls at that signature dispatch straight to the
    callable.

What each compile records:

  * **Signature-diff attribution**: a new signature is diffed against the
    site's signatures — which argument's shape / dtype / device / static
    value changed ("tables: shape (1, 1) -> (1, 2) (axis 1)"). Sites are
    PROCESS-wide while the seen signatures belong to each instrumented
    callable, so a restarted engine's first steps read as `duplicate`.
  * **Recording**: a `compile` span, a flight-recorder event, the global
    `compile_total` and a per-site `compile_<site>_total` counter, the
    `compile_seconds` histogram; all no-ops under `MXNET_TELEMETRY=0`
    (signature tracking and the per-instance counters keep working: they
    are behaviour, not telemetry).
  * **Memory**: a first run on a CUDA device is measured through
    `torch.cuda.memory_stats` around it (one synchronisation for each new
    signature, none on a cached one) into the per-site gauges
    `exec_<site>_{argument,output,temp,code,hbm}_bytes`; `hbm_bytes` is
    the device allocation's peak during the run. A CPU run has no such
    reading: no memory, and no HBM gate.
  * **Collective-comms ledger**: a first run's collective traffic, read
    from `parallel/collectives.counters()` before and after it (the port
    has no HLO to walk), lands in `comms_<site>_<kind>_{bytes,ops}`;
    `site_comms("train.step")` reads it (ResilientLoop's `/statusz`).
  * **Budgets**: `MXNET_COMPILE_BUDGET=<n>[:warn|:raise]` turns the
    (n+1)-th compile at one site into a warning or a raise.
    `MXNET_HBM_BUDGET_GB=<gb>[:raise|:warn]` refuses a signature whose
    measured footprint exceeds the budget. An eager call has no footprint
    before it runs, so the gate acts after the first run's measurement
    (a `TrainStep` measures before its optimizer update, so a refused
    step changes nothing); a refused signature is re-checked at each
    later call without running, and is admitted once the budget is
    lifted.

The AOT cache (`mxnet_tpu_torch/aot`) reports its loads here:
`record_warm_load` counts a library or package loaded instead of
compiled, per site and per thread (`dispatch_warm_mark` /
`dispatch_warm_loads_since`), beside the compiles a thread paid
(`dispatch_mark` / `dispatch_compiles_since`): the serving engine and
`TrainStep` bracket their dispatches with these.
"""
from __future__ import annotations

import contextlib
import functools
import os
import re
import threading
import time
import warnings
from collections import deque

from ..base import MXNetError
from .metrics import enabled, default_registry, _sane


class CompileBudgetExceeded(MXNetError):
    """MXNET_COMPILE_BUDGET=<n>:raise tripped: one site compiled more
    than <n> distinct programs — a recompile storm (an unstable shape
    bucket) that would otherwise just eat throughput silently."""


class HbmBudgetExceeded(MXNetError):
    """MXNET_HBM_BUDGET_GB refusal: a signature's measured device
    footprint exceeds the declared budget."""


# -- metric-name templates (the reference's) --------------------------------
COMPILE_SECONDS = "compile_seconds"
COMPILE_TOTAL = "compile_total"
COMPILE_DUPLICATE_TOTAL = "compile_duplicate_total"
COMPILE_OVERRUNS_TOTAL = "compile_budget_overruns_total"
SITE_COMPILE_TOTAL = "compile_%s_total"
COMPILE_CACHE_HITS = "compile_cache_hits"
COMPILE_CACHE_MISSES = "compile_cache_misses"
COMPILE_CACHE_STORES = "compile_cache_stores"
COMPILE_CACHE_LOAD_SECONDS = "compile_cache_load_seconds"
COMPILE_CACHE_CORRUPT_TOTAL = "compile_cache_corrupt_total"
EXEC_ARG_BYTES = "exec_%s_argument_bytes"
EXEC_OUT_BYTES = "exec_%s_output_bytes"
EXEC_TEMP_BYTES = "exec_%s_temp_bytes"
EXEC_CODE_BYTES = "exec_%s_code_bytes"
EXEC_HBM_BYTES = "exec_%s_hbm_bytes"
EXEC_FLOPS = "exec_%s_flops"
COMMS_BYTES = "comms_%s_%s_bytes"
COMMS_OPS = "comms_%s_%s_ops"
COMMS_FRACTION = "comms_%s_fraction"

#: compile-seconds histogram buckets: a first eager step takes ms, an nvcc
#: build or an AOTInductor compile seconds to minutes
_COMPILE_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

#: warm-load buckets: reading a cached library or package is disk work
_CACHE_LOAD_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                       0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _parse_budget(env_var, default_policy, convert):
    """`<value>[:warn|:raise]` -> (converted value, policy) or
    (None, None). Any malformed part raises MXNetError NAMING the env
    var — this parse runs deep inside a compile, where a bare
    int()/float() ValueError would say nothing about its origin."""
    raw = os.environ.get(env_var)
    if not raw:
        return None, None
    value, _, policy = raw.partition(":")
    policy = policy or default_policy
    if policy not in ("warn", "raise"):
        raise MXNetError("%s policy must be warn or raise, got %r"
                         % (env_var, policy))
    try:
        value = convert(value)
    except ValueError:
        raise MXNetError("%s must be <number>[:warn|:raise], got %r"
                         % (env_var, raw))
    return value, policy


def compile_budget():
    """MXNET_COMPILE_BUDGET=<n>[:warn|:raise] — max distinct compilations
    per site; overruns warn by default. Returns (n, policy) or
    (None, None). Read at each compile, so it can be tightened live."""
    return _parse_budget("MXNET_COMPILE_BUDGET", "warn", int)


def hbm_budget_bytes():
    """MXNET_HBM_BUDGET_GB=<gb>[:raise|:warn] — device footprint ceiling;
    overruns refuse by default. Returns (bytes, policy) or
    (None, None)."""
    value, policy = _parse_budget("MXNET_HBM_BUDGET_GB", "raise", float)
    if value is None:
        return None, None
    return value * (1024.0 ** 3), policy


# ---------------------------------------------------------------------------
# signatures: what distinguishes one first run from another
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _dtype_str(dt):
    s = str(dt)
    return s[6:] if s.startswith("torch.") else s


@functools.lru_cache(maxsize=64)
def _device_str(dev):
    return str(dev)


def _leaf_sig(v):
    dev = getattr(v, "device", None)
    if dev is None and hasattr(v, "_data"):   # an NDArray: its tensor
        v = v._data
        dev = getattr(v, "device", None)
    shape = getattr(v, "shape", None)
    if shape is None:
        # a python static (bool flag, enum string): its VALUE is part of
        # the signature, unlike a tensor argument's
        return ("static", type(v).__name__, repr(v))
    return (tuple(shape), _dtype_str(getattr(v, "dtype", "?")),
            _device_str(dev) if dev is not None else "host")


def _leaves(a, out):
    if isinstance(a, (list, tuple)):
        for x in a:
            _leaves(x, out)
    elif isinstance(a, dict):
        for k in sorted(a):
            _leaves(a[k], out)
    elif a is not None:
        out.append(a)
    return out


def signature(args):
    """Per-top-level-argument signature tuple for a positional call: each
    argument's leaves (lists, tuples and dicts walked, dict keys sorted)
    as (shape, dtype, device) for a tensor or NDArray, ("static", type,
    repr) for a Python value."""
    return tuple(tuple(_leaf_sig(l) for l in _leaves(a, []))
                 if isinstance(a, (list, tuple, dict)) or a is None
                 else (_leaf_sig(a),) for a in args)


def _axes_changed(a, b):
    if len(a) != len(b):
        return "rank %d -> %d" % (len(a), len(b))
    axes = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    return "axis " + ",".join(str(i) for i in axes) if axes else ""


def _leaf_diff(old_leaf, new_leaf):
    """One leaf's human-readable change."""
    if old_leaf[0] == "static" or new_leaf[0] == "static":
        return "static %s -> %s" % (old_leaf[-1], new_leaf[-1])
    parts = []
    if old_leaf[0] != new_leaf[0]:
        extra = _axes_changed(old_leaf[0], new_leaf[0])
        parts.append("shape %s -> %s%s"
                     % (old_leaf[0], new_leaf[0],
                        " (%s)" % extra if extra else ""))
    if old_leaf[1] != new_leaf[1]:
        parts.append("dtype %s -> %s" % (old_leaf[1], new_leaf[1]))
    if old_leaf[2] != new_leaf[2]:
        parts.append("sharding %s -> %s" % (old_leaf[2], new_leaf[2]))
    return ", ".join(parts) or "changed"


def _arg_diff(old_arg, new_arg):
    if len(old_arg) != len(new_arg):
        return "structure %d -> %d leaves" % (len(old_arg), len(new_arg))
    diffs = [i for i, (o, n) in enumerate(zip(old_arg, new_arg)) if o != n]
    if not diffs:
        return "unchanged"
    text = _leaf_diff(old_arg[diffs[0]], new_arg[diffs[0]])
    if len(old_arg) > 1:
        text = "leaf %d: %s" % (diffs[0], text)
    if len(diffs) > 1:
        text += " (+%d more leaves)" % (len(diffs) - 1)
    return text


def diff_reason(argnames, cached_sigs, new_sig):
    """Attribute a new signature to the smallest diff against the site's
    cached signatures: which ARGUMENT changed, and how. Returns the
    human-readable reason string the compile event carries."""
    candidates = [s for s in cached_sigs if len(s) == len(new_sig)]
    if not candidates:
        if cached_sigs:
            return ("argument structure changed (%d args -> %d args)"
                    % (len(next(iter(cached_sigs))), len(new_sig)))
        return "first compilation at this site"
    # nearest neighbor: fewest differing arguments

    def ndiff(s):
        return sum(1 for o, n in zip(s, new_sig) if o != n)
    best = min(candidates, key=ndiff)
    parts = []
    for i, (o, n) in enumerate(zip(best, new_sig)):
        if o == n:
            continue
        name = (argnames[i] if argnames and i < len(argnames)
                else "arg%d" % i)
        parts.append("%s: %s" % (name, _arg_diff(o, n)))
    return "; ".join(parts) if parts else "identical signature"


# ---------------------------------------------------------------------------
# the collective-comms ledger, from the port's collective counters
# ---------------------------------------------------------------------------

#: the kinds the ledger attributes (the reference's gauge names); the
#: port's point-to-point sends (`ppermute`) are its collective_permute
COLLECTIVE_KINDS = ("all_reduce", "reduce_scatter", "all_gather",
                    "all_to_all", "collective_permute", "broadcast")
_KIND_OF = {"p2p": "collective_permute"}


_DTYPE_BYTES = {"pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
                "f8e4m3fn": 1, "f8e5m2": 1, "s16": 2, "u16": 2,
                "f16": 2, "bf16": 2, "s32": 4, "u32": 4, "f32": 4,
                "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16}

_SHAPE_RE = re.compile(r"\b([a-z][a-z0-9]*)\[([0-9,]*)\]")
_COLLECTIVE_RE = re.compile(
    r"=\s+(\([^)]*\)|\S+)\s+"
    r"(all-reduce|reduce-scatter|all-gather|all-to-all|"
    r"collective-permute)((?:-start)?)\(([^)]*)")


def _shape_bytes(text):
    """Summed byte size of every `dtype[dims]` shape token in `text`."""
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES.get(dtype, 4)
    return total


def comms_from_hlo(hlo_text):
    """{kind: {"bytes": b, "ops": n}} over the collective instructions of
    one HLO module's text, each at its logical payload max(operands,
    results) (an async `-start`'s aliased input taken out): the
    reference's reading of a compiled program, kept for programs that come
    as HLO text; the port's own steps fill the ledger from the collective
    counters (`comms_between`)."""
    kinds = {}
    for result, opcode, started, operands in \
            _COLLECTIVE_RE.findall(hlo_text):
        in_bytes = _shape_bytes(operands)
        out_bytes = _shape_bytes(result)
        if started:
            payload = max(in_bytes, out_bytes - in_bytes)
        else:
            payload = max(in_bytes, out_bytes)
        k = kinds.setdefault(opcode.replace("-", "_"),
                             {"bytes": 0, "ops": 0})
        k["bytes"] += payload
        k["ops"] += 1
    return kinds


def comms_ledger(compiled, bytes_accessed=None):
    """The ledger dict of a program given as HLO text (or an object with
    `as_text()`): {"kinds", "total_bytes", "bytes_accessed", "fraction"};
    None when there is no text."""
    try:
        txt = compiled if isinstance(compiled, str) else compiled.as_text()
    except Exception:
        return None
    if not txt:
        return None
    kinds = comms_from_hlo(txt)
    total = sum(k["bytes"] for k in kinds.values())
    return {"kinds": kinds, "total_bytes": total,
            "bytes_accessed": bytes_accessed,
            "fraction": (total / float(bytes_accessed)
                         if bytes_accessed else None)}


def _collective_counts():
    """(calls, bytes) of the port's collectives so far, or None when the
    collectives module was never imported (no collective can have run)."""
    import sys
    mod = sys.modules.get(__package__.rsplit(".", 1)[0]
                          + ".parallel.collectives")
    if mod is None:
        return None
    c = mod.counters()
    return c["calls"], c["payload"]


def comms_between(before, after):
    """The ledger dict the watchdog records for the collectives run
    between two `_collective_counts()` readings: {"kinds": {kind:
    {"bytes", "ops"}}, "total_bytes", "bytes_accessed": None, "fraction":
    None} (no traffic model, so no fraction), or None when no collective
    ran. Bytes are each call's logical payload, the larger of what the
    rank sent in and received (a reduce-scatter its full input, an
    all-gather its full output), as the reference's HLO reading counts
    them."""
    if after is None:
        return None
    calls0, bytes0 = before or ({}, {})
    calls1, bytes1 = after
    kinds = {}
    for op in set(calls1) | set(bytes1):
        n = calls1.get(op, 0) - calls0.get(op, 0)
        b = bytes1.get(op, 0) - bytes0.get(op, 0)
        if n or b:
            k = kinds.setdefault(_KIND_OF.get(op, op), {"bytes": 0, "ops": 0})
            k["bytes"] += int(b)
            k["ops"] += int(n)
    if not kinds:
        return None
    return {"kinds": kinds,
            "total_bytes": sum(k["bytes"] for k in kinds.values()),
            "bytes_accessed": None, "fraction": None}


# ---------------------------------------------------------------------------
# the watchdog
# ---------------------------------------------------------------------------


class CompileSite:
    """One named compile seam. Signature history is PROCESS-wide (so a
    restarted engine diffs against its predecessor's signatures); the
    seen sets live on the InstrumentedCall instances."""

    def __init__(self, name):
        self.name = name
        self.sane = _sane(name.replace(".", "_"))
        self.signatures = {}          # sig -> first-seen event seq
        self.compiles = 0             # process-wide compiles at this site
        self.duplicates = 0           # same-sig recompiles (cold instances)
        self.cache_hits = 0           # loads from the AOT cache
        self.seconds = 0.0            # their wall seconds, all told
        self.comms = None             # latest first run's comms ledger


class Watchdog:
    """Process-wide compile observatory: named sites, a bounded event
    ring, and the metric/span/flight recording every compile flows
    through."""

    def __init__(self, registry=None):
        self._lock = threading.RLock()
        self._sites = {}
        self._events = deque(maxlen=512)
        self._seq = 0
        self._registry = registry
        self.total_seconds = 0.0

    def registry(self):
        return self._registry or default_registry()

    def site(self, name):
        with self._lock:
            s = self._sites.get(name)
            if s is None:
                s = self._sites[name] = CompileSite(name)
            return s

    def sites(self):
        with self._lock:
            return dict(self._sites)

    # -- budget gate (checked BEFORE paying a compile) ----------------------
    def check_budget(self, site):
        budget, policy = compile_budget()
        if budget is None or site.compiles + site.duplicates < budget:
            return
        msg = ("compile budget overrun at site %r: %d compilations "
               "already recorded, MXNET_COMPILE_BUDGET=%d (%s) — a "
               "recompile storm; see watchdog().events() for the "
               "signature diffs" % (site.name,
                                    site.compiles + site.duplicates,
                                    budget, policy))
        if enabled():
            self.registry().counter(
                COMPILE_OVERRUNS_TOTAL, flight=True,
                help="compile-budget overruns (MXNET_COMPILE_BUDGET)"
            ).inc(site=site.name)
        if policy == "raise":
            raise CompileBudgetExceeded(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    # -- recording ----------------------------------------------------------
    def record(self, site, sig, reason, seconds, phase=None, memory=None,
               flops=None, duplicate=False, start_us=None, comms=None):
        """Record one compile event (the seam `InstrumentedCall` and
        `compile_region` report through). Returns the event dict."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            if duplicate:
                site.duplicates += 1
            else:
                site.compiles += 1
                if sig is not None:
                    site.signatures.setdefault(sig, seq)
            if comms is not None:
                site.comms = comms
            site.seconds += seconds
            self.total_seconds += seconds
            ev = {"seq": seq, "site": site.name, "reason": reason,
                  "seconds": seconds, "phase": phase,
                  "duplicate": bool(duplicate), "t": time.time()}
            if memory:
                ev["memory"] = dict(memory)
                ev["hbm_bytes"] = memory.get("hbm_bytes")
            if flops:
                ev["flops"] = flops
            if comms is not None:
                ev["comms"] = comms
            self._events.append(ev)
        if enabled():
            reg = self.registry()
            reg.histogram(
                COMPILE_SECONDS, buckets=_COMPILE_BUCKETS,
                help="wall time per watchdog-observed compilation "
                     "(a build, a trace, or a first eager run)"
            ).observe(seconds)
            reg.counter(COMPILE_TOTAL,
                        help="compilations across all watchdog sites"
                        ).inc()
            reg.counter(SITE_COMPILE_TOTAL % site.sane,
                        help="compilations at site %s" % site.name).inc()
            if duplicate:
                reg.counter(
                    COMPILE_DUPLICATE_TOTAL,
                    help="first runs of an already-seen signature (a new "
                         "instance, e.g. an engine restart)").inc()
            if memory:
                reg.gauge(EXEC_ARG_BYTES % site.sane,
                          help="argument bytes, latest first run"
                          ).set(memory["argument_bytes"])
                reg.gauge(EXEC_OUT_BYTES % site.sane,
                          help="output bytes, latest first run"
                          ).set(memory["output_bytes"])
                reg.gauge(EXEC_TEMP_BYTES % site.sane,
                          help="device bytes allocated beyond the entry's "
                               "at the peak, latest first run"
                          ).set(memory["temp_bytes"])
                reg.gauge(EXEC_CODE_BYTES % site.sane,
                          help="generated-code bytes (0: eager)"
                          ).set(memory["code_bytes"])
                reg.gauge(EXEC_HBM_BYTES % site.sane,
                          help="peak device allocation during the latest "
                               "first run").set(memory["hbm_bytes"])
            if flops:
                reg.gauge(EXEC_FLOPS % site.sane,
                          help="declared flops, latest first run"
                          ).set(flops)
            if comms is not None:
                for kind, k in comms["kinds"].items():
                    reg.gauge(COMMS_BYTES % (site.sane, kind),
                              help="%s payload bytes a step, latest first "
                                   "run" % kind.replace("_", "-")
                              ).set(k["bytes"])
                    reg.gauge(COMMS_OPS % (site.sane, kind),
                              help="%s calls a step, latest first run"
                              % kind.replace("_", "-")).set(k["ops"])
                # the gauges claim "latest first run": a kind that run
                # no longer made must read 0, not a stale value
                for kind in COLLECTIVE_KINDS:
                    if kind in comms["kinds"]:
                        continue
                    for tmpl in (COMMS_BYTES, COMMS_OPS):
                        name = tmpl % (site.sane, kind)
                        if name in reg._metrics:
                            reg.gauge(name).set(0)
                if comms["fraction"] is not None:
                    reg.gauge(COMMS_FRACTION % site.sane,
                              help="collective payload / total bytes "
                                   "accessed, latest first run"
                              ).set(comms["fraction"])
            if start_us is None:
                start_us = time.perf_counter_ns() // 1000 \
                    - int(seconds * 1e6)
            from .tracing import record_span
            record_span("compile", start_us, int(seconds * 1e6),
                        category="compile", to_flight=False,
                        site=site.name, reason=reason, phase=phase)
            from .flight import flight
            flight().record("event", "compile", site=site.name,
                            reason=reason, seconds=round(seconds, 4),
                            duplicate=bool(duplicate))
        return ev

    # -- AOT-cache recording -------------------------------------------------
    def record_cache_hit(self, site, sig, seconds, phase=None):
        """One library or package loaded from the AOT cache
        (mxnet_tpu_torch/aot): the signature registers at the site but
        neither `compiles` nor `duplicates` advances — a warm load is the
        ABSENCE of the compile."""
        with self._lock:
            self._seq += 1
            seq = self._seq
            site.cache_hits += 1
            if sig is not None:
                site.signatures.setdefault(sig, seq)
            site.seconds += seconds
            self.total_seconds += seconds
            ev = {"seq": seq, "site": site.name,
                  "reason": "warm-loaded from the AOT cache",
                  "seconds": seconds, "phase": phase, "duplicate": False,
                  "cache_hit": True, "t": time.time()}
            self._events.append(ev)
        if enabled():
            reg = self.registry()
            reg.counter(COMPILE_CACHE_HITS,
                        help="libraries and packages loaded from the AOT "
                             "cache (no compile)").inc()
            reg.histogram(COMPILE_CACHE_LOAD_SECONDS,
                          buckets=_CACHE_LOAD_BUCKETS,
                          help="wall time to load one cache entry"
                          ).observe(seconds)
            from .flight import flight
            flight().record("event", "compile_cache_hit", site=site.name,
                            seconds=round(seconds, 4))
        return ev

    def record_cache_miss(self, site):
        """A keyed lookup found no (valid) entry — the compile that
        follows will store one."""
        if enabled():
            self.registry().counter(
                COMPILE_CACHE_MISSES,
                help="AOT-cache lookups that fell through to a fresh "
                     "compile").inc()

    def record_cache_store(self, site):
        if enabled():
            self.registry().counter(
                COMPILE_CACHE_STORES,
                help="entries published to the AOT cache (atomic "
                     "first-wins rename)").inc()

    def record_cache_corrupt(self, site):
        """A truncated/bit-flipped/stale entry failed verification: the
        file was quarantined and the caller recompiles — corruption costs
        one compile, never an error."""
        if enabled():
            self.registry().counter(
                COMPILE_CACHE_CORRUPT_TOTAL, flight=True,
                help="AOT-cache entries that failed sha256/format/load "
                     "verification (quarantined, recompiled)").inc()
            from .flight import flight
            flight().record("event", "compile_cache_corrupt",
                            site=site.name)

    def check_hbm_budget(self, site, memory):
        """The footprint gate over a measured first run (no memory, as on
        the CPU: no gate)."""
        if not memory:
            return
        budget, policy = hbm_budget_bytes()
        if budget is None or memory["hbm_bytes"] <= budget:
            return
        msg = ("signature at site %r needs %.3f GB of device memory (the "
               "peak during its first run: %.3f resident at entry + %.3f "
               "allocated by the run) but MXNET_HBM_BUDGET_GB=%.3g (%s)"
               % (site.name, memory["hbm_bytes"] / 1024.0 ** 3,
                  (memory["hbm_bytes"] - memory["temp_bytes"])
                  / 1024.0 ** 3, memory["temp_bytes"] / 1024.0 ** 3,
                  budget / 1024.0 ** 3, policy))
        if enabled():
            from .flight import flight
            flight().record("event", "hbm_budget_overrun", site=site.name,
                            hbm_bytes=memory["hbm_bytes"])
        if policy == "raise":
            raise HbmBudgetExceeded(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)

    # -- reading ------------------------------------------------------------
    def events(self, site=None):
        with self._lock:
            out = list(self._events)
        if site is not None:
            out = [e for e in out if e["site"] == site]
        return out

    def mark(self):
        """Opaque marker for `since()`."""
        with self._lock:
            return self._seq

    def since(self, mark):
        """(compile seconds, peak hbm_bytes or None) over the events
        recorded after `mark`."""
        evs = [e for e in self.events() if e["seq"] > mark]
        seconds = sum(e["seconds"] for e in evs)
        peaks = [e["hbm_bytes"] for e in evs if e.get("hbm_bytes")]
        return seconds, (max(peaks) if peaks else None)


#: per-thread counts of the compiles and warm loads PAID by this thread's
#: dispatches — the attribution seam for callers (the serving engine,
#: TrainStep) that share instrumented callables across instances: bracket
#: a call with `dispatch_mark()` / `dispatch_compiles_since()` and count
#: exactly what that call paid, never a sibling's on another thread
_dispatch_tls = threading.local()


def dispatch_mark():
    """Opaque marker for `dispatch_compiles_since` (thread-local)."""
    return getattr(_dispatch_tls, "count", 0)


def dispatch_compiles_since(mark):
    """Compiles this thread paid since `mark` (survives
    MXNET_TELEMETRY=0: attribution is behavior, not telemetry)."""
    return getattr(_dispatch_tls, "count", 0) - mark


def dispatch_warm_mark():
    """Opaque marker for `dispatch_warm_loads_since` (thread-local):
    libraries and packages this thread loaded from the AOT cache instead
    of compiling."""
    return getattr(_dispatch_tls, "warm", 0)


def dispatch_warm_loads_since(mark):
    """Warm AOT-cache loads this thread performed since `mark`."""
    return getattr(_dispatch_tls, "warm", 0) - mark


def _note_compile():
    _dispatch_tls.count = getattr(_dispatch_tls, "count", 0) + 1


def _note_warm_load():
    _dispatch_tls.warm = getattr(_dispatch_tls, "warm", 0) + 1


_watchdog = None
_watchdog_lock = threading.Lock()


def watchdog():
    """The process-wide watchdog (created on first use)."""
    global _watchdog
    if _watchdog is None:
        with _watchdog_lock:
            if _watchdog is None:
                _watchdog = Watchdog()
    return _watchdog


def reset():
    """Drop all sites/events (tests). Instances created before the reset
    keep recording into the OLD watchdog's sites."""
    global _watchdog
    with _watchdog_lock:
        _watchdog = None


# ---------------------------------------------------------------------------
# first runs: timing, memory, comms
# ---------------------------------------------------------------------------


def _cuda_device(leaves):
    for v in leaves:
        t = getattr(v, "_data", v)
        dev = getattr(t, "device", None)
        if dev is not None and getattr(dev, "type", None) == "cuda":
            return dev
    return None


def _tensor_bytes(tree, dev):
    total = 0
    for v in _leaves(tree, []):
        t = getattr(v, "_data", v)
        if getattr(t, "device", None) == dev and hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def _allocated(dev):
    """(current, peak) allocated bytes of a CUDA device's caching
    allocator."""
    import torch
    s = torch.cuda.memory_stats(dev)
    return (int(s.get("allocated_bytes.all.current", 0)),
            int(s.get("allocated_bytes.all.peak", 0)))


class _Run:
    """One first run under observation: its start time, the device's
    allocation at entry and the collective counters at entry."""

    def __init__(self, dev, args):
        self.dev = dev
        self.args = args
        self.memory = None
        self.measured = False
        self.comms0 = _collective_counts() if enabled() else None
        if dev is not None:
            self.mem0 = _allocated(dev)
        self.t0_us = time.perf_counter_ns() // 1000
        self.t0 = time.perf_counter()

    def measure(self, out=None):
        """Synchronise the device once and take the run's seconds and
        memory so far (`out`: the outputs, for their bytes)."""
        if self.dev is not None:
            import torch
            torch.cuda.synchronize(self.dev)
            cur, peak = _allocated(self.dev)
            cur0, peak0 = self.mem0
            # the allocator's peak moved during the run: it IS the run's
            # peak; else the run stayed under an earlier peak, and the
            # larger of entry and exit is the reading that remains
            top = peak if peak > peak0 else max(cur0, cur)
            self.memory = {
                "argument_bytes": _tensor_bytes(self.args, self.dev),
                "output_bytes": _tensor_bytes(out, self.dev),
                "temp_bytes": max(0, top - cur0),
                "code_bytes": 0, "alias_bytes": 0, "hbm_bytes": top}
        self.seconds = time.perf_counter() - self.t0
        self.measured = True


class InstrumentedCall:
    """An eager callable registered at a watchdog site (the reference's
    `InstrumentedJit` with `owned=False`): a first-seen signature is
    timed WITH its first run (disclosed on the event), measured on a
    CUDA device, gated by the HBM budget after that run, and recorded;
    later calls at a seen signature go straight to the callable.

    `sig_argnums` picks the arguments the signature is computed over
    (default: all), and `argnames` names those: a serving step's
    signature is its own shape key (tokens, tables), never a walk over
    every parameter tensor. `device` is where memory is measured
    (default: the first CUDA tensor among the arguments).

    Per-instance `compiles` / `compiles_by_phase` and `warm_loads` are
    the FUNCTIONAL counters; they advance regardless of
    `MXNET_TELEMETRY` — only the recording is telemetry."""

    def __init__(self, fn, site, argnames=None, phase=None,
                 sig_argnums=None, device=None):
        self._fn = fn
        self._site = watchdog().site(site)
        self._argnames = tuple(argnames) if argnames else None
        self._phase = phase
        self._sig_argnums = (tuple(sig_argnums) if sig_argnums is not None
                             else None)
        self._device = device
        # sig -> None (admitted) or the measured memory of a signature
        # the HBM gate refused (re-checked at every later call)
        self._seen = {}
        # RLock: a first run stays under it, so two threads sharing one
        # callable pay one first run for a signature
        self._lock = threading.RLock()
        self.compiles = 0
        self.compiles_by_phase = {}
        self.warm_loads = 0
        self.warm_loads_by_phase = {}

    @property
    def site(self):
        return self._site.name

    @property
    def __wrapped__(self):
        return self._fn

    def _cache_size(self):
        """Distinct signatures this instance has run."""
        return len(self._seen)

    def signature_of(self, args):
        if self._sig_argnums is not None:
            args = tuple(args[i] for i in self._sig_argnums)
        return signature(args)

    def seen(self, sig):
        """Has this instance run `sig` (re-checking a refused one's
        footprint against the budget, which raises while it is over)?"""
        refused = self._seen.get(sig, False)
        if refused is False:
            return False
        if refused is not None:
            watchdog().check_hbm_budget(self._site, refused)
            self._seen[sig] = None            # the budget was lifted
        return True

    def _record_instance_compile(self, phase):
        _note_compile()
        with self._lock:
            self.compiles += 1
            if phase:
                self.compiles_by_phase[phase] = \
                    self.compiles_by_phase.get(phase, 0) + 1

    def __call__(self, *args, _phase=None):
        sig = self.signature_of(args)
        if self.seen(sig):
            return self._fn(*args)
        with self._lock:
            if self.seen(sig):                # a racing thread ran it
                return self._fn(*args)
            with self.first_run(sig, _phase or self._phase, args) as run:
                out = self._fn(*args)
                run.measure(out)
            return out

    @contextlib.contextmanager
    def first_run(self, sig, phase=None, args=(), device=None):
        """Observe the first run of `sig`, which the caller's block
        performs: the compile budget is checked before it, and after it
        the event is recorded (seconds, memory, comms) and the HBM gate
        applied. The block may call `run.measure()` and
        `gate(run)` itself, to refuse before it commits anything (a
        TrainStep before its optimizer update). A block that raises
        anything else records nothing. `device` is where memory is
        measured (default: the instance's, else the arguments')."""
        wd = watchdog()
        site = self._site
        with wd._lock:
            duplicate = sig in site.signatures
            cached = tuple(site.signatures)
        reason = ("signature already run in this process — a new "
                  "instance (engine restart / new step)" if duplicate
                  else diff_reason(self._argnames, cached, sig))
        wd.check_budget(site)
        dev = device if device is not None else self._device
        if dev is None:
            dev = _cuda_device(_leaves(args, []))
        if dev is not None and getattr(dev, "type", None) != "cuda":
            dev = None                # the CPU: no memory reading
        run = _Run(dev, args)
        run.gated = False
        try:
            yield run
        except HbmBudgetExceeded:
            if not run.gated:
                raise
            self._finish(wd, site, sig, reason, phase, duplicate, run)
            self._seen[sig] = run.memory
            raise
        if not run.measured:
            run.measure()
        self._finish(wd, site, sig, reason, phase, duplicate, run)
        self._seen[sig] = None
        if not run.gated:
            try:
                self.gate(run)
            except HbmBudgetExceeded:
                self._seen[sig] = run.memory
                raise

    def gate(self, run):
        """Apply the HBM budget to `run`'s measured footprint (measuring
        it first if the block has not)."""
        if not run.measured:
            run.measure()
        run.gated = True
        watchdog().check_hbm_budget(self._site, run.memory)

    def _finish(self, wd, site, sig, reason, phase, duplicate, run):
        comms = (comms_between(run.comms0, _collective_counts())
                 if enabled() else None)
        wd.record(site, sig, reason + " (timed with first execution)",
                  run.seconds, phase=phase, memory=run.memory,
                  duplicate=duplicate, start_us=run.t0_us, comms=comms)
        self._record_instance_compile(phase)


#: the reference's name for the instrumented callable
InstrumentedJit = InstrumentedCall


def instrument(fn, site, argnames=None, phase=None, sig_argnums=None,
               device=None):
    """Register an eager callable at a watchdog site (see
    `InstrumentedCall`)."""
    return InstrumentedCall(fn, site, argnames=argnames, phase=phase,
                            sig_argnums=sig_argnums, device=device)


@contextlib.contextmanager
def compile_region(site, phase=None, **attrs):
    """Time an explicit whole-compile region (torch.export in
    `predict.export_model` / `export_train_step`, an AOTInductor compile,
    an nvcc / NVRTC / g++ build) as one watchdog compile event, paid by
    this thread — no signature cache, every entry is a compile."""
    wd = watchdog()
    s = wd.site(site)
    wd.check_budget(s)
    t0_us = time.perf_counter_ns() // 1000
    t0 = time.perf_counter()
    # no try/finally: a region that RAISES produced nothing, so recording
    # it would disguise the failure as a normal compile
    yield
    wd.record(s, None,
              "explicit compile region%s"
              % (" (%s)" % ", ".join("%s=%s" % kv
                                     for kv in sorted(attrs.items()))
                 if attrs else ""),
              time.perf_counter() - t0, phase=phase, start_us=t0_us)
    _note_compile()


def record_warm_load(site, seconds, phase=None):
    """One library or package loaded from the AOT cache at `site` instead
    of compiled: a cache-hit event, paid (and counted) by this thread."""
    wd = watchdog()
    wd.record_cache_hit(wd.site(site), None, seconds, phase=phase)
    _note_warm_load()


def compile_events(site=None):
    """Recorded compile events, oldest first (`site=` filters)."""
    return watchdog().events(site)


def site_comms(site):
    """The latest first run's collective-comms ledger at a site —
    {"kinds": {kind: {"bytes", "ops"}}, "total_bytes", "bytes_accessed",
    "fraction"} — or None before one ran a collective there (or under
    MXNET_TELEMETRY=0, where the ledger is not read)."""
    s = watchdog().sites().get(site)
    return s.comms if s is not None else None
