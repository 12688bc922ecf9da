"""Port parity for the telemetry package (mxnet_tpu_torch/telemetry/ and
mxnet_tpu_torch/profiler.py) against the JAX reference's, on the CPU.

Mirrors tests/test_telemetry.py: the registry (counters, gauges,
histograms, the Prometheus exposition held byte for byte against the
reference for the same operations and labels), span tracing and its
Perfetto export, the flight recorder and its dump rendered by
tools/postmortem.py, the profiler's chrome-trace dumps, the serving
server's connected trace and content-negotiated /metrics, and the
recursive key tree of `ServingMetrics.snapshot()`. The anomaly
detectors flag the same steps as the reference's on one seeded series.
"""
import json
import os
import re
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import telemetry, profiler, serving
from mxnet_tpu_torch.telemetry import anomaly, metrics as tmetrics

from test_torch_serving import lm, PROMPTS  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_rings():
    for t in (telemetry, jtel):
        t.tracing.clear()
        t.flight().clear()
    yield
    for t in (telemetry, jtel):
        t.tracing.clear()
        t.flight().clear()


@pytest.fixture
def profiler_state():
    saved = {k: profiler._state[k] for k in ("events", "flushed",
                                             "dumped_to", "config")}
    profiler._state.update(events=[], flushed=[], dumped_to=set(),
                           config=dict(saved["config"]))
    yield profiler
    profiler.set_state("stop")
    profiler._state.update(saved)


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_roundtrip():
    reg = telemetry.MetricsRegistry()
    c = reg.counter("reqs_total")
    c.inc()
    c.inc(4)
    assert c.value == 5
    g = reg.gauge("depth")
    g.set(3)
    g.inc()
    g.dec(2)
    assert g.value == 2
    assert reg.counter("reqs_total") is c
    with pytest.raises(ValueError):
        reg.gauge("reqs_total")


def test_histogram_quantiles_and_count_below_match_reference():
    buckets = (0.001, 0.01, 0.1, 1.0)
    vals = [0.005] * 50 + [0.05] * 45 + [0.5] * 5 + [7.0]
    hs = []
    for pkg in (telemetry, jtel):
        h = pkg.MetricsRegistry().histogram("lat", buckets=buckets)
        assert h.quantile(0.5) is None and h.mean is None
        for v in vals:
            h.observe(v)
        hs.append(h)
    mine, ref = hs
    assert 0.01 < mine.quantile(0.50) <= 0.1
    for q in (0.0, 0.25, 0.5, 0.95, 0.99, 1.0):
        assert mine.quantile(q) == ref.quantile(q), q
    for v in (0.0, 0.001, 0.004, 0.01, 0.07, 0.3, 1.0, 99.0):
        assert mine.count_below(v) == ref.count_below(v), v
    assert (mine.count, mine.sum, mine.mean) == (ref.count, ref.sum,
                                                 ref.mean)


def _ops_basic(reg):
    reg.counter("reqs_total", help="requests").inc(3)
    reg.gauge("depth").set(7)
    h = reg.histogram("lat_seconds", buckets=(0.01, 0.1))
    h.observe(0.05)


def _ops_serving_like(reg):
    c = reg.counter("serving_tokens_generated_total",
                    help="decode tokens emitted")
    for n in (1, 8, 8, 3):
        c.inc(n)
    g = reg.gauge("serving_block_utilization", help="pool fill")
    g.set(0.25)
    g.inc(0.5)
    g.dec(0.125)
    h = reg.histogram("serving_decode_step_seconds",
                      help="one batched decode step")
    for v in (0.0001, 0.003, 0.0031, 0.02, 0.4, 150.0):
        h.observe(v)
    reg.gauge("1bad-name.here", help="sanitized").set(float("nan"))
    reg.gauge("neg_inf").set(float("-inf"))
    reg.gauge("big").set(1e17)
    reg.gauge("frac").set(1.0 / 3.0)


def _ops_mixed(reg):
    reg.histogram("empty_seconds", help="never observed")
    reg.counter("z_total").inc(0.5)
    reg.counter("a_total", help='quote " and \\ backslash').inc()
    h = reg.histogram("batch", buckets=(1, 2, 4, 8))
    for v in range(12):
        h.observe(v)


@pytest.mark.parametrize("ops", [_ops_basic, _ops_serving_like,
                                 _ops_mixed])
@pytest.mark.parametrize("labels", [None, {"replica": "3"}])
def test_prometheus_text_byte_equal_to_reference(ops, labels, monkeypatch):
    """One sequence of registry operations through both packages: the
    exposition and the snapshot are the reference's, byte for byte,
    with the host/replica labels set alike."""
    monkeypatch.setenv("MXNET_HOST_ID", "7")
    monkeypatch.setenv("MXNET_REPLICA_ID", "2")
    mine = telemetry.MetricsRegistry(labels=labels)
    ref = jtel.MetricsRegistry(labels=labels)
    ops(mine)
    ops(ref)
    text = mine.prometheus_text()
    assert text == ref.prometheus_text()
    assert text.endswith("\n")
    assert json.dumps(mine.snapshot(), sort_keys=True) == json.dumps(
        ref.snapshot(), sort_keys=True)


def test_merged_prometheus_text_matches_reference():
    regs = []
    for pkg in (telemetry, jtel):
        rs = [pkg.MetricsRegistry(labels={"replica": str(i)})
              for i in range(3)]
        for i, r in enumerate(rs):
            r.counter("serving_requests_completed_total",
                      help="done").inc(i)
            if i:
                r.histogram("lat", buckets=(0.1, 1.0)).observe(0.2 * i)
        regs.append(pkg.merged_prometheus_text(rs))
    assert regs[0] == regs[1]
    mixed = [telemetry.MetricsRegistry(), telemetry.MetricsRegistry()]
    mixed[0].counter("x")
    mixed[1].gauge("x")
    with pytest.raises(ValueError, match="mixed kinds"):
        telemetry.merged_prometheus_text(mixed)


def test_prometheus_exposition_format_pinned():
    """The text grammar of tests/test_telemetry.py:92-93 on every sample
    line; host/replica on every sample; cumulative buckets end at
    +Inf == _count."""
    reg = telemetry.MetricsRegistry()
    _ops_basic(reg)
    text = reg.prometheus_text()
    assert "# HELP reqs_total requests" in text
    assert "# TYPE lat_seconds histogram" in text
    sample = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*\{[^}]*\} "
                        r"(NaN|[+-]?(Inf|[0-9.e+-]+))$")
    lines = [ln for ln in text.splitlines() if not ln.startswith("#")]
    assert lines
    for ln in lines:
        assert sample.match(ln), ln
        assert 'host="' in ln and 'replica="' in ln, ln
    inf_val = [int(ln.rsplit(" ", 1)[1]) for ln in lines
               if 'le="+Inf"' in ln][0]
    count_val = [int(ln.rsplit(" ", 1)[1]) for ln in lines
                 if ln.startswith("lat_seconds_count")][0]
    assert inf_val == count_val == 1


def test_telemetry_kill_switch(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    reg = telemetry.MetricsRegistry()
    c = reg.counter("x_total")
    c.inc(10)
    assert c.value == 0
    h = reg.histogram("h")
    h.observe(1.0)
    assert h.count == 0
    reg.gauge("g").set(3)
    assert reg.gauge("g").value == 0
    with telemetry.span("dead"):
        pass
    assert telemetry.spans() == []
    telemetry.flight().record("event", "dead")
    assert telemetry.flight().events() == []


def test_host_label_env_and_process_group(monkeypatch):
    """MXNET_HOST_ID wins; else the rank of an initialized
    torch.distributed group; never a group made just for a label."""
    import socket
    import torch.distributed as dist
    monkeypatch.setenv("MXNET_HOST_ID", "3")
    reg = telemetry.MetricsRegistry()
    assert reg.labels()["host"] == "3"
    reg.counter("a_total").inc()
    assert 'host="3"' in reg.prometheus_text()
    monkeypatch.delenv("MXNET_HOST_ID")
    assert not dist.is_initialized()
    assert tmetrics._host_label() == "0"
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method="tcp://localhost:%d" % port,
                            rank=0, world_size=1)
    try:
        assert tmetrics._host_label() == str(dist.get_rank()) == "0"
    finally:
        dist.destroy_process_group()


def test_default_registry_and_module_helpers():
    reg = telemetry.default_registry()
    assert reg is telemetry.default_registry()
    telemetry.counter("port_helper_total").inc(2)
    assert telemetry.snapshot()["metrics"]["port_helper_total"][
        "value"] >= 2
    assert "port_helper_total" in telemetry.prometheus_text()
    assert tmetrics._sane("9a.b-c") == "_9a_b_c" == \
        jtel.metrics._sane("9a.b-c")


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------


def test_span_nesting_inherits_trace():
    with telemetry.span("outer", trace="t-1"):
        assert telemetry.current_trace() == "t-1"
        with telemetry.span("inner"):
            pass
    assert telemetry.current_trace() is None
    got = telemetry.spans(trace="t-1")
    assert [s["name"] for s in got] == ["inner", "outer"]
    assert all(s["trace"] == "t-1" for s in got)


def test_span_records_to_profiler_and_flight(profiler_state):
    profiler.set_state("run")
    try:
        with telemetry.span("traced.region", category="serving", k=1):
            pass
        telemetry.record_span("fanout", 0, 5, trace="t", to_profiler=False,
                              to_flight=False)
    finally:
        profiler.set_state("stop")
    names = [e["name"] for e in profiler._state["events"]]
    assert "traced.region" in names and "fanout" not in names
    fl = [e["name"] for e in telemetry.flight().events()
          if e["kind"] == "span"]
    assert "traced.region" in fl and "fanout" not in fl


def _strip_ids(doc):
    out = []
    for e in doc["traceEvents"]:
        e = dict(e)
        if "args" in e and "span_id" in e["args"]:
            e["args"] = {k: v for k, v in e["args"].items()
                         if k != "span_id"}
        if e.get("ph") == "X" and e["args"].get("trace") is None:
            e.pop("tid")         # a real thread id: differs by design
        out.append(e)
    return out


def test_perfetto_export_matches_reference(tmp_path):
    """The same spans, recorded through both packages at the same
    timestamps, export to the same Perfetto document: one row per trace
    id, named by thread_name metadata, ts sorted."""
    spans = [("a", 7, 100, 5), ("b", 7, 120, 3), ("c", 9, 110, 8),
             ("untraced", None, 90, 1), ("d", "req-x", 130, 0)]
    docs = []
    for pkg in (telemetry, jtel):
        for name, trace, ts, dur in spans:
            pkg.record_span(name, ts, dur, trace=trace, step=1)
        path = str(tmp_path / ("%s.json" % pkg.__name__))
        doc = pkg.export_perfetto(path)
        with open(path) as f:
            assert json.load(f) == doc
        docs.append(doc)
    assert _strip_ids(docs[0]) == _strip_ids(docs[1])
    evs = [e for e in docs[0]["traceEvents"] if e["ph"] == "X"]
    by7 = [e for e in evs if e["args"]["trace"] == 7]
    assert len(by7) == 2 and len({e["tid"] for e in by7}) == 1
    meta = {m["args"]["name"] for m in docs[0]["traceEvents"]
            if m["ph"] == "M"}
    assert {"trace 7", "trace 9", "trace req-x"} <= meta
    ts = [e["ts"] for e in docs[0]["traceEvents"] if "ts" in e]
    assert ts == sorted(ts)


def test_span_ring_drop_accounting(monkeypatch):
    from collections import deque
    from mxnet_tpu_torch.telemetry import tracing
    monkeypatch.setattr(tracing, "_spans", deque(maxlen=4))
    monkeypatch.setattr(tracing, "_exported_upto", 0)
    reg = telemetry.default_registry()
    ctr = reg.counter("spans_dropped_total")
    base = ctr.value
    for i in range(4):
        telemetry.record_span("fill%d" % i, 0, 1)
    assert ctr.value == base
    assert reg.gauge("span_ring_occupancy").value == 1.0
    telemetry.record_span("overflow", 0, 1)
    assert ctr.value == base + 1
    telemetry.export_perfetto()
    for i in range(4):
        telemetry.record_span("post%d" % i, 0, 1)
    assert ctr.value == base + 1
    telemetry.record_span("post-overflow", 0, 1)
    assert ctr.value == base + 2


def test_span_ring_size_env(monkeypatch):
    """MXNET_TELEMETRY_SPAN_RING sizes the ring at import, as in the
    reference."""
    code = ("from mxnet_tpu_torch.telemetry import tracing\n"
            "print(tracing._spans.maxlen)\n")
    env = dict(os.environ, MXNET_TELEMETRY_SPAN_RING="17")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "17"


# ---------------------------------------------------------------------------
# flight recorder + tools/postmortem.py
# ---------------------------------------------------------------------------


def test_flight_ring_bounded_and_dump(tmp_path, monkeypatch):
    fr = telemetry.FlightRecorder(capacity=8)
    for i in range(20):
        fr.record("event", "e%d" % i, i=i)
    evs = fr.events()
    assert len(evs) == 8
    assert evs[0]["name"] == "e12" and evs[-1]["name"] == "e19"
    monkeypatch.delenv("MXNET_FLIGHT_RECORDER_DIR", raising=False)
    assert fr.dump("test") is None
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR", str(tmp_path))
    monkeypatch.setenv("MXNET_HOST_ID", "5")
    path = fr.dump("unit test!")
    assert os.path.basename(path) == "flight-host5-pid%d-1.unit_test_.json" \
        % os.getpid()
    with open(path) as f:
        doc = json.load(f)
    # the reference's dump layout, key for key
    assert sorted(doc) == ["dumped_at", "events", "host", "metrics", "pid",
                           "reason", "ring_capacity"]
    assert doc["reason"] == "unit test!" and len(doc["events"]) == 8
    assert doc["ring_capacity"] == 8
    path2 = fr.dump("again")
    assert path2 != path and os.path.exists(path)
    # an explicit path works with no directory configured
    monkeypatch.delenv("MXNET_FLIGHT_RECORDER_DIR")
    assert fr.dump("x", path=str(tmp_path / "explicit.json")) == \
        str(tmp_path / "explicit.json")


def test_flight_ring_capacity_env(monkeypatch):
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER_RING", "3")
    fr = telemetry.FlightRecorder()
    for i in range(5):
        fr.record("event", "e%d" % i)
    assert fr.capacity == 3 and len(fr.events()) == 3


def test_flight_lock_is_reentrant():
    """dump() may run in a signal handler that interrupted a record()
    holding the lock (the reference's RLock): re-entry must not
    deadlock."""
    fr = telemetry.FlightRecorder(capacity=4)
    with fr._lock:
        fr.record("event", "inside")
        assert fr.events()[0]["name"] == "inside"


def test_flagged_counter_lands_in_flight_ring():
    reg = telemetry.MetricsRegistry()
    c = reg.counter("bad_steps_total", flight=True)
    c.inc(step=12)
    evs = [e for e in telemetry.flight().events()
           if e["kind"] == "metric" and e["name"] == "bad_steps_total"]
    assert evs and evs[0]["step"] == 12 and evs[0]["value"] == 1


def _postmortem(*args):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "postmortem.py")]
        + list(args), capture_output=True, text=True, timeout=120)


def test_postmortem_renders_port_dump(tmp_path, monkeypatch):
    """tools/postmortem.py (the reference's, unchanged) renders a dump
    the port wrote: timeline, FAULT callout, reason, final metrics, and
    its Perfetto merge."""
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR", str(tmp_path))
    telemetry.default_registry().counter("port_postmortem_total").inc()
    with telemetry.span("serving.decode", trace="abc", batch=2):
        pass
    telemetry.flight().record("fault", "chaos.serve_kill", replica=0,
                              step=3)
    path = telemetry.flight().dump("serving_loop_died")
    assert path is not None
    r = _postmortem(str(tmp_path), "--perfetto",
                    str(tmp_path / "pod.json"))
    assert r.returncode == 0, r.stderr
    for needle in ("serving.decode", "chaos.serve_kill", "FAULT",
                   "serving_loop_died", "port_postmortem_total"):
        assert needle in r.stdout, needle
    with open(tmp_path / "pod.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "serving.decode" in names


# ---------------------------------------------------------------------------
# profiler
# ---------------------------------------------------------------------------


def test_profiler_dump_append_safe(tmp_path, profiler_state):
    profiler.set_config(filename=str(tmp_path / "p.json"))
    profiler.set_state("run")
    with profiler.scope("relu"):
        pass
    profiler.set_state("stop")
    n1 = len(json.load(open(profiler.dump()))["traceEvents"])
    assert n1 > 0
    # a re-dump with no new events must not grow the file
    assert len(json.load(open(profiler.dump()))["traceEvents"]) == n1
    profiler.set_state("run")
    with profiler.scope("dot"):
        pass
    profiler.set_state("stop")
    assert len(json.load(open(profiler.dump()))["traceEvents"]) > n1
    profiler.set_config(filename=str(tmp_path / "p2.json"))
    assert json.load(open(profiler.dump()))["traceEvents"] == []
    table = profiler.dumps()
    assert "relu" in table and "dot" in table


def test_profiler_schema_and_user_api(tmp_path, profiler_state):
    profiler.set_config(filename=str(tmp_path / "s.json"))
    profiler.set_state("run")
    dom = profiler.Domain("d")
    task = dom.new_task("task")
    task.start()
    task.stop()
    ctr = dom.new_counter("ctr", 1)
    ctr.increment(2)
    ctr.decrement()
    ev = profiler.Event("event")
    ev.start()
    ev.stop()
    profiler.Marker(dom, "mark").mark()
    profiler.pause()
    assert not profiler.is_running()
    with profiler.scope("paused"):
        pass
    profiler.resume()
    with telemetry.span("schema.region"):
        pass
    profiler.set_state("stop")
    with open(profiler.dump()) as f:
        evs = json.load(f)["traceEvents"]
    names = [e["name"] for e in evs]
    assert {"task", "ctr", "event", "mark", "schema.region"} <= set(names)
    assert "paused" not in names
    assert [e["args"]["value"] for e in evs if e["name"] == "ctr"] == [3, 2]
    for e in evs:
        assert e["ph"] == "X" and isinstance(e["ts"], int) and \
            e["ts"] >= 0 and isinstance(e["dur"], int) and e["dur"] >= 0
        assert "pid" in e and "tid" in e
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts)
    # the legacy aliases
    profiler.profiler_set_config(filename=str(tmp_path / "alias.json"))
    profiler.profiler_set_state("stop")
    profiler.dump_profile()
    assert os.path.exists(tmp_path / "alias.json")


def test_profiler_device_trace_through_torch_profiler(tmp_path,
                                                      profiler_state):
    """The reference's `xplane_dir` starts a
    torch.profiler session with set_state("run"); stop writes its chrome
    trace there."""
    import torch
    profiler.set_config(xplane_dir=str(tmp_path / "trace"))
    profiler.set_state("run")
    torch.ones(64, 64) @ torch.ones(64, 64)
    profiler.set_state("stop")
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].startswith("device-trace-")
    with open(tmp_path / "trace" / files[0]) as f:
        assert json.load(f)["traceEvents"]
    assert profiler._state["device_trace"] is None


# ---------------------------------------------------------------------------
# serving: one request = one connected trace; Prometheus /metrics;
# the snapshot's key tree
# ---------------------------------------------------------------------------


def _tiny(lm, **kw):
    _, _, params, cfg = lm
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    return serving.serve((params, cfg), device="cpu", **kw)


def test_one_request_single_connected_trace(lm, tmp_path):
    srv = _tiny(lm, paged=True)
    try:
        req = srv.submit(PROMPTS[0], max_new_tokens=4)
        req.result(timeout=60)
    finally:
        srv.close()
    names = [s["name"] for s in telemetry.spans(trace=req.trace)]
    for want in ("serving.submit", "serving.queue", "serving.prefill"):
        assert want in names, names
    assert names.count("serving.decode") >= 2
    doc = telemetry.export_perfetto(str(tmp_path / "serving.json"))
    evs = [e for e in doc["traceEvents"]
           if e["ph"] == "X" and e["args"].get("trace") == req.trace]
    assert len({e["tid"] for e in evs}) == 1
    assert {"serving.submit", "serving.queue", "serving.prefill",
            "serving.decode"} <= {e["name"] for e in evs}


def test_http_metrics_content_negotiation(lm):
    srv = _tiny(lm, paged=True)
    try:
        host, port = srv.serve_http(port=0, block=False)
        srv.generate(PROMPTS[1], max_new_tokens=2, timeout=60)
        base = "http://%s:%d/metrics" % (host, port)
        with urllib.request.urlopen(base) as r:
            snap = json.loads(r.read())
        assert snap["requests"]["completed"] == 1
        rq = urllib.request.Request(base, headers={"Accept": "text/plain"})
        with urllib.request.urlopen(rq) as r:
            ctype = r.headers["Content-Type"]
            text = r.read().decode()
        assert ctype.startswith("text/plain")
        assert "# TYPE serving_requests_completed_total counter" in text
        assert re.search(r"serving_requests_completed_total\{[^}]*\} 1",
                         text)
        for gauge in ("serving_queue_depth", "serving_blocks_in_use",
                      "serving_blocks_high_water",
                      "serving_prefill_queue_depth"):
            assert "# TYPE %s gauge" % gauge in text, gauge
        assert "serving_decode_step_seconds_bucket" in text
    finally:
        srv.close()


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return None


@pytest.mark.parametrize("paged", [False, True])
def test_snapshot_key_tree_equals_reference(lm, paged):
    """The recursive key tree of `snapshot()` after one request through
    each package's server is the reference's (tests/test_telemetry.py::
    test_serving_metrics_snapshot_shape_unchanged pins the reference's)."""
    jparams, jcfg, params, cfg = lm
    trees = []
    for srv in (serving.serve((params, cfg), max_batch=2, block_size=8,
                              paged=paged, device="cpu"),
                jserving.serve((jparams, jcfg), max_batch=2, block_size=8,
                               paged=paged)):
        try:
            srv.generate(PROMPTS[1], max_new_tokens=3, timeout=300)
            snap = srv.snapshot()
        finally:
            srv.close()
        assert snap["requests"]["completed"] == 1
        assert snap["latency_ms"]["total_mean"] > 0
        assert snap["latency_ms"]["decode_step_p50"] is not None
        trees.append(_key_tree(snap))
    assert trees[0] == trees[1]


# ---------------------------------------------------------------------------
# anomaly detectors
# ---------------------------------------------------------------------------


def _series(seed, n=120):
    rng = np.random.RandomState(seed)
    x = 2.0 + 0.05 * rng.standard_normal(n)
    x[[40, 77, 101]] += [3.0, -1.5, 40.0]          # planted spikes
    x[90:] += 0.5                                  # a level shift
    return [float(v) for v in x]


@pytest.mark.parametrize("alpha,z,warmup", [(0.05, 6.0, 20),
                                            (0.2, 3.0, 5),
                                            (1.0, 2.0, 0)])
def test_ewma_detector_matches_reference(alpha, z, warmup):
    mine = telemetry.EwmaDetector(alpha, z, warmup)
    ref = jtel.EwmaDetector(alpha, z, warmup)
    flags = []
    for x in _series(0) + [float("nan"), float("inf"), 2.0]:
        a, b = mine.observe(x), ref.observe(x)
        assert a[1] == b[1]
        assert (a[0] is None) == (b[0] is None)
        if a[0] is not None:
            assert a[0] == pytest.approx(b[0], rel=1e-12, abs=1e-12)
        flags.append(a[1])
    assert (mine.mean, mine.var, mine.n) == (ref.mean, ref.var, ref.n)
    if warmup <= 20:
        assert flags[101]                        # the big spike flags


def test_anomaly_detector_flags_same_steps(monkeypatch):
    monkeypatch.setenv("MXNET_ANOMALY_WARMUP", "10")
    monkeypatch.setenv("MXNET_ANOMALY_ZSCORE", "4")
    reg_m, reg_r = telemetry.MetricsRegistry(), jtel.MetricsRegistry()
    mine = telemetry.AnomalyDetector(registry=reg_m)
    ref = jtel.AnomalyDetector(registry=reg_r)
    loss, gn = _series(1), _series(2)
    got, want = [], []
    for t, (lv, gv) in enumerate(zip(loss, gn)):
        got.append(mine.observe(t, loss=lv, grad_norm=gv))
        want.append(ref.observe(t, loss=lv, grad_norm=gv))
    assert got == want and any(got)
    assert mine.anomalies == ref.anomalies > 0
    assert reg_m.counter(anomaly.ANOMALIES_TOTAL).value == mine.anomalies
    assert reg_m.gauge(anomaly.SIGNAL_ZSCORE % "loss").value == \
        pytest.approx(reg_r.gauge("train_loss_zscore").value, rel=1e-12)
    flagged = [e for e in telemetry.flight().events()
               if e["name"] == "train.anomaly"]
    assert len(flagged) == mine.anomalies


@pytest.mark.parametrize("name,value", [
    ("MXNET_ANOMALY_ALPHA", "0"), ("MXNET_ANOMALY_ALPHA", "1.5"),
    ("MXNET_ANOMALY_ZSCORE", "-1"), ("MXNET_ANOMALY_WARMUP", "x")])
def test_anomaly_knobs_fail_naming_the_knob(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    for pkg in (anomaly, jtel.anomaly):
        with pytest.raises(ValueError, match=name):
            pkg.AnomalyDetector()
    monkeypatch.delenv(name)
    monkeypatch.setenv("MXNET_ANOMALY_DETECT", "1")
    assert anomaly.detect_enabled() and jtel.anomaly.detect_enabled()
