"""Port parity for request tracing and SLO/goodput accounting
(mxnet_tpu_torch/telemetry/slo.py, tracing's W3C traceparent, the
serving metrics' token ledger and /statusz) against the JAX reference,
on the CPU.

Mirrors tests/test_slo.py except its two router tests (the stitched
cross-replica failover trace and the fleet /statusz aggregate wait for
ROADMAP item 9): traceparent parsing held to the reference's over good
and malformed inputs, parse_slo_env / burn_rate / SLOTracker / merge_slo
results equal to the reference's within 1e-12, the request log's schema
and its sampling by the same trace ids, the /statusz token identity, and
tools/fleet_top.py rendering the live port server.
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
from mxnet_tpu.serving import metrics as jmetrics
from mxnet_tpu.serving import scheduler as jsched
from mxnet_tpu.telemetry import slo as jslo
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving.metrics import ServingMetrics
from mxnet_tpu_torch.serving.scheduler import (Request, make_resume,
                                               BrownoutShed,
                                               DeadlineExceeded)
from mxnet_tpu_torch.telemetry import slo as tslo

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


def _serve(lm, **kw):
    _, _, params, cfg = lm
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("paged", True)
    return serving.serve((params, cfg), device="cpu", **kw)


# ---------------------------------------------------------------------------
# W3C traceparent
# ---------------------------------------------------------------------------

_TID = "0af7651916cd43dd8448eb211c80319c"


@pytest.mark.parametrize("value", [
    "00-%s-b7ad6b7169203331-01" % _TID,
    "  00-%s-B7AD6B7169203331-01  " % _TID.upper(),
    "01-%s-b7ad6b7169203331-00" % _TID,
    None, "", "garbage", "00", "00-short-b7ad6b7169203331-01",
    "00-" + "0" * 32 + "-b7ad6b7169203331-01",
    "00-%s-" % _TID + "0" * 16 + "-01",
    "ff-%s-b7ad6b7169203331-01" % _TID,
    "00-0af7651916cd43dd8448eb211c80319X-b7ad6b7169203331-01",
    "zz-!!-##-@@", "00-0af7-01", 12345, b"\x00\xff",
    "00-%s-b7ad6b7169203331-01-extra" % _TID,
    "\x01\x02\x03", "a" * 4096, "-", "::", " ",
])
def test_parse_traceparent_matches_reference(value):
    got = telemetry.parse_traceparent(value)
    assert got == jtel.parse_traceparent(value)
    if got is not None:
        assert got == _TID


@pytest.mark.parametrize("trace", [_TID, "req-17", 42, _TID.upper()])
def test_format_traceparent_matches_reference(trace):
    mine, ref = (pkg.format_traceparent(trace, parent_id="b7ad6b7169203331")
                 for pkg in (telemetry, jtel))
    assert mine == ref
    t = telemetry.parse_traceparent(mine)
    assert re.match(r"^[0-9a-f]{32}$", t)
    assert telemetry.parse_traceparent(
        telemetry.format_traceparent(trace)) == t   # deterministic fold
    assert mine.endswith("-01")
    assert telemetry.format_traceparent(trace, sampled=False).endswith(
        "-00")


def test_http_fuzzed_traceparent_never_500(lm):
    """Garbage traceparent headers degrade to a fresh trace id — 200
    with a well-formed response traceparent; a well-formed one is
    honored verbatim and keys the request's spans."""
    srv = _serve(lm)
    try:
        host, port = srv.serve_http(port=0, block=False)
        url = "http://%s:%d/v1/generate" % (host, port)
        fuzz = ["garbage", "00", "ff-" + "a" * 32 + "-" + "b" * 16 + "-01",
                "00-" + "0" * 32 + "-" + "0" * 16 + "-01", "\x01\x02\x03",
                "a" * 4096, "00-zzzz-yyyy-01", "-"]
        seen = set()
        for i, tp in enumerate(fuzz):
            rq = urllib.request.Request(
                url, data=json.dumps({"tokens": [1 + i, 2, 3],
                                      "max_new_tokens": 2}).encode(),
                headers={"Content-Type": "application/json",
                         "traceparent": tp})
            with urllib.request.urlopen(rq, timeout=120) as r:
                assert r.status == 200
                out = json.loads(r.read())
                hdr = r.headers.get("traceparent")
            assert out["tokens"]
            assert telemetry.parse_traceparent(hdr) == out["trace"]
            seen.add(out["trace"])
        assert len(seen) == len(fuzz)
        rq = urllib.request.Request(
            url, data=json.dumps({"tokens": [5, 6],
                                  "max_new_tokens": 2}).encode(),
            headers={"traceparent": "00-%s-b7ad6b7169203331-01" % _TID})
        with urllib.request.urlopen(rq, timeout=120) as r:
            out = json.loads(r.read())
            assert telemetry.parse_traceparent(
                r.headers["traceparent"]) == _TID
        assert out["trace"] == _TID
        assert [s for s in telemetry.spans(trace=_TID)
                if s["name"] == "serving.decode"]
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# request lifecycle ledger: schema, ordering, deterministic sampling
# ---------------------------------------------------------------------------


def test_request_log_schema_is_the_reference_s():
    assert tslo.REQUEST_LOG_EVENTS == jslo.REQUEST_LOG_EVENTS
    assert tslo.REQUEST_LOG_REQUIRED == jslo.REQUEST_LOG_REQUIRED
    assert tslo.REQUEST_LOG_VERSION == jslo.REQUEST_LOG_VERSION
    assert tslo.DEFAULT_WINDOWS == jslo.DEFAULT_WINDOWS


def test_request_log_schema_and_ordering(lm, tmp_path, monkeypatch):
    path = str(tmp_path / "requests.jsonl")
    monkeypatch.setenv("MXNET_REQUEST_LOG", path)
    monkeypatch.delenv("MXNET_REQUEST_LOG_SAMPLE", raising=False)
    srv = _serve(lm)
    try:
        reqs = [srv.submit([1 + i, 2, 3], max_new_tokens=3,
                           tenant="acme" if i % 2 else None)
                for i in range(3)]
        for r in reqs:
            r.result(timeout=120)
    finally:
        srv.close()
    with open(path) as fh:
        recs = [json.loads(ln) for ln in fh if ln.strip()]
    assert recs
    for rec in recs:
        for key in tslo.REQUEST_LOG_REQUIRED:
            assert key in rec, (key, rec)
        assert rec["event"] in tslo.REQUEST_LOG_EVENTS, rec
    for req in reqs:
        mine = [r for r in recs if r["trace"] == req.trace]
        events = [r["event"] for r in mine]
        for needed in ("queued", "admitted", "prefill_chunk",
                       "first_token", "decode", "finish"):
            assert needed in events, (req.id, events)
        t_of = {r["event"]: r["ts"] for r in mine}
        assert t_of["queued"] <= t_of["first_token"] <= t_of["finish"]
        fin = [r for r in mine if r["event"] == "finish"][0]
        assert fin["outcome"] == "completed" and fin["generated"] == 3
        assert all(r["itl_ms"] >= 0 for r in mine if r["event"] == "decode")
    assert any(r["tenant"] == "acme" for r in recs)


@pytest.mark.parametrize("rate", ["0", "0.1", "0.5", "0.9", "1"])
def test_request_log_sampling_matches_reference(monkeypatch, tmp_path,
                                                rate):
    """crc32 sampling by trace id: the port keeps exactly the requests
    the reference keeps."""
    monkeypatch.setenv("MXNET_REQUEST_LOG", str(tmp_path / "s.jsonl"))
    monkeypatch.setenv("MXNET_REQUEST_LOG_SAMPLE", rate)
    traces = ["t-%d" % i for i in range(300)] + [
        telemetry.new_trace_id() for _ in range(50)]
    mine, ref = tslo.RequestLog(), jslo.RequestLog()
    got = [mine.sampled(t) for t in traces]
    assert got == [ref.sampled(t) for t in traces]
    assert got == [mine.sampled(t) for t in traces]
    if rate == "0.5":
        assert 120 <= sum(got) <= 230


def test_request_log_sample_knob_validated(lm, monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_REQUEST_LOG", str(tmp_path / "x.jsonl"))
    monkeypatch.setenv("MXNET_REQUEST_LOG_SAMPLE", "50")
    with pytest.raises(ValueError, match="MXNET_REQUEST_LOG_SAMPLE"):
        ServingMetrics()
    log = tslo.RequestLog()

    class R:
        id, trace, tenant = 1, "t-0", "default"

    with pytest.warns(UserWarning, match="MXNET_REQUEST_LOG_SAMPLE"):
        assert log.event("queued", R()) is not None   # logs everything
    monkeypatch.setenv("MXNET_REQUEST_LOG_SAMPLE", "0")
    assert log.event("queued", R()) is None


# ---------------------------------------------------------------------------
# SLO engine: env parsing, burn math, trackers, fleet merge
# ---------------------------------------------------------------------------


def _objs(pkg):
    return [(o.kind, o.tenant, o.threshold_s, o.target, o.key, o.budget,
             o.describe()) for o in pkg.parse_slo_env()]


@pytest.mark.parametrize("env", [
    {"MXNET_SLO_TTFT_MS": "250:0.99,acme=100", "MXNET_SLO_ITL_MS": "50",
     "MXNET_SLO_AVAILABILITY": "0.999,acme=0.9999"},
    {"MXNET_SLO_TTFT_MS": " 500 , a-b.c=12.5:0.5 ,"},
    {"MXNET_SLO_ITL_MS": "x=1:0.75,y=2"},
    {},
])
def test_parse_slo_env_matches_reference(monkeypatch, env):
    for k in ("MXNET_SLO_TTFT_MS", "MXNET_SLO_ITL_MS",
              "MXNET_SLO_AVAILABILITY"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = _objs(telemetry)
    assert got == _objs(jtel)
    assert len(got) == sum(len([e for e in v.split(",") if e.strip()])
                           for v in env.values())


@pytest.mark.parametrize("var,value", [
    ("MXNET_SLO_TTFT_MS", "not-a-number"), ("MXNET_SLO_TTFT_MS", "250:1.5"),
    ("MXNET_SLO_TTFT_MS", "1:0.5:3"), ("MXNET_SLO_AVAILABILITY", "99.9"),
    ("MXNET_SLO_ITL_MS", "50:0")])
def test_parse_slo_env_rejects_like_reference(monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    for pkg in (telemetry, jtel):
        with pytest.raises(ValueError, match=var):
            pkg.parse_slo_env()


def test_parse_windows_matches_reference(monkeypatch):
    monkeypatch.delenv("MXNET_SLO_WINDOWS", raising=False)
    assert telemetry.parse_windows() == tslo.DEFAULT_WINDOWS
    for raw in ("30,600", "600,30,30", " 5 ,"):
        monkeypatch.setenv("MXNET_SLO_WINDOWS", raw)
        assert telemetry.parse_windows() == jtel.parse_windows()
    monkeypatch.setenv("MXNET_SLO_WINDOWS", "0,-5")
    with pytest.raises(ValueError, match="MXNET_SLO_WINDOWS"):
        telemetry.parse_windows()


def test_burn_rate_and_budget_match_reference():
    rng = np.random.RandomState(0)
    for _ in range(200):
        total = float(rng.randint(0, 1000))
        good = float(rng.randint(0, total + 1)) if total else 0.0
        budget = float(rng.uniform(1e-4, 0.5))
        for fn in ("burn_rate", "budget_remaining"):
            a = getattr(tslo, fn)(good, total, budget)
            b = getattr(jslo, fn)(good, total, budget)
            assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), (fn, a, b)
    assert tslo.burn_rate(0, 0, 0.1) == 0.0
    assert tslo.budget_remaining(0, 0, 0.1) == 1.0


def test_burn_rate_multi_window():
    """Burn = windowed bad fraction / error budget from snapshot deltas,
    pinned against hand-computed numbers (the reference's own case)."""
    reg = telemetry.MetricsRegistry()
    counts = {"good": 0.0, "total": 0.0}
    obj = telemetry.Objective("ttft", threshold_s=0.25, target=0.9)
    tracker = telemetry.SLOTracker(
        reg, lambda o: (counts["good"], counts["total"]),
        objectives=[obj], windows=(60, 600))
    t0 = 1000.0
    tracker.update(now=t0)
    counts.update(good=90.0, total=100.0)
    tracker.update(now=t0 + 30)
    assert abs(reg.gauge(tslo._BURN % ("ttft", 60)).value - 1.0) < 1e-6
    counts.update(good=180.0, total=200.0)
    tracker.update(now=t0 + 60)
    assert abs(reg.gauge(tslo._BURN % ("ttft", 60)).value - 1.0) < 1e-6
    assert abs(reg.gauge(tslo._ATTAIN % "ttft").value - 0.9) < 1e-9
    assert abs(reg.gauge(tslo._BUDGET % "ttft").value - 0.0) < 1e-9
    counts.update(good=300.0, total=320.0)
    tracker.update(now=t0 + 90)
    counts.update(good=400.0, total=420.0)
    tracker.update(now=t0 + 120)
    w60 = tracker.payload(now=t0 + 121)[0]["burn"]["60s"]
    assert w60["rate"] == 0.0 and w60["total"] >= 100


def _close(a, b, path="$"):
    """Recursive equality with floats within 1e-12."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            _close(a[k], b[k], path + "." + str(k))
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, "%s[%d]" % (path, i))
    elif isinstance(a, float) and isinstance(b, (int, float)):
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_slo_tracker_payload_and_gauges_match_reference():
    """One seeded stream of lifetime counts through both trackers, at
    the same injected times, over three objectives and three windows."""
    rng = np.random.RandomState(3)
    objs = [("ttft", 0.25, 0.95, None), ("itl", 0.05, 0.99, "acme"),
            ("availability", None, 0.999, None)]
    trackers, regs, counts = [], [], {}
    for pkg in (telemetry, jtel):
        reg = pkg.MetricsRegistry()
        o = [pkg.Objective(k, threshold_s=t, target=g, tenant=n)
             for k, t, g, n in objs]
        trackers.append(pkg.SLOTracker(
            reg, lambda ob: counts.get(ob.key, (0.0, 0.0)),
            objectives=o, windows=(30, 120, 600)))
        regs.append(reg)
    now = 5000.0
    for _ in range(40):
        now += float(rng.uniform(1, 20))
        for key in ("ttft", "itl_tenant_acme", "availability"):
            g, t = counts.get(key, (0.0, 0.0))
            n = float(rng.randint(0, 50))
            counts[key] = (g + float(rng.binomial(int(n), 0.93)), t + n)
        for tr in trackers:
            tr.update(now=now)
    _close(trackers[0].payload(now=now + 1), trackers[1].payload(now=now + 1))
    assert regs[0].prometheus_text() == regs[1].prometheus_text()


def test_merge_slo_matches_reference():
    rng = np.random.RandomState(4)
    payloads = []
    for r in range(4):
        block = []
        for obj, tenant, thr in (("ttft", None, 250.0),
                                 ("ttft", "acme", 100.0),
                                 ("availability", None, None)):
            tot = float(rng.randint(0, 500))
            good = float(rng.randint(0, tot + 1)) if tot else 0.0
            burn = {}
            for w in ("60s", "300s"):
                wt = float(rng.randint(0, tot + 1)) if tot else 0.0
                burn[w] = {"good": float(rng.randint(0, wt + 1))
                           if wt else 0.0, "total": wt,
                           "span_s": float(rng.uniform(0, 300))}
            block.append({"objective": obj, "tenant": tenant,
                          "threshold_ms": thr, "target": 0.9,
                          "good": good, "total": tot, "burn": burn})
        payloads.append(block)
    _close(telemetry.merge_slo(payloads), jtel.merge_slo(payloads))
    # an idle replica does not dilute the burning one
    a = [{"objective": "ttft", "tenant": None, "threshold_ms": 250.0,
          "target": 0.9, "good": 90, "total": 100,
          "burn": {"60s": {"good": 90, "total": 100, "span_s": 60}}}]
    b = [{"objective": "ttft", "tenant": None, "threshold_ms": 250.0,
          "target": 0.9, "good": 0, "total": 0,
          "burn": {"60s": {"good": 0, "total": 0, "span_s": 0}}}]
    m = telemetry.merge_slo([a, b])[0]
    assert m["attainment"] == 0.9
    assert abs(m["burn"]["60s"]["rate"] - 1.0) < 1e-6


# ---------------------------------------------------------------------------
# the goodput token ledger + /statusz
# ---------------------------------------------------------------------------


def _token_identity(tok):
    assert tok["submitted"] == (tok["goodput"] + tok["slow"] + tok["shed"]
                                + tok["expired"] + tok["failed"]), tok


def test_statusz_identity_and_registry_consistency(lm, monkeypatch):
    monkeypatch.setenv("MXNET_SLO_TTFT_MS", "250:0.95")
    monkeypatch.setenv("MXNET_SLO_AVAILABILITY", "0.999")
    srv = _serve(lm)
    try:
        for i in range(4):
            srv.generate([1 + i, 2, 3], max_new_tokens=3, timeout=120)
        srv.submit([9, 8, 7], max_new_tokens=4,
                   tenant="acme").result(timeout=120)
        host, port = srv.serve_http(port=0, block=False)
        with urllib.request.urlopen(
                "http://%s:%d/statusz" % (host, port)) as r:
            stz = json.loads(r.read())
        _token_identity(stz["tokens"])
        assert stz["tokens"]["goodput"] + stz["tokens"]["slow"] == 4 * 3 + 4
        for t in stz["tenants"].values():
            _token_identity(t["tokens"])
        assert stz["tenants"]["acme"]["tokens"]["submitted"] == 4
        assert stz["tenants"]["acme"]["requests"]["completed"] == 1
        text = srv.prometheus_text()
        for kind, n in stz["tokens"].items():
            if kind in ("replayed", "generated"):
                continue
            m = re.search(r"serving_%s_tokens_total\{[^}]*\} (\d+)" % kind,
                          text)
            assert m and int(m.group(1)) == n, (kind, n)
        m = re.search(
            r"serving_tenant_acme_submitted_tokens_total\{[^}]*\} (\d+)",
            text)
        assert m and int(m.group(1)) == 4
        kinds = {(o["objective"], o["tenant"]) for o in stz["slo"]}
        assert ("ttft", None) in kinds and ("availability", None) in kinds
        assert "slo_ttft_attainment{" in text
        assert "slo_availability_burn_rate_300s{" in text
        assert "slo_ttft_budget_remaining{" in text
        assert set(stz) == {"replica", "uptime_s", "requests", "tokens",
                            "goodput_tok_per_sec", "tenants", "slo"}
    finally:
        srv.close()


def _ledger_run(metrics_cls, req_cls, resume_fn, errors):
    met = metrics_cls()

    def finish(err=None, tokens=None, max_new=5, tenant=None):
        req = req_cls([1, 2, 3], max_new_tokens=max_new, tenant=tenant)
        if err is not None:
            req._finish(error=err)
        else:
            req._finish(tokens=tokens or [1, 2, 3, 4, 5])
        met.request_finished(req)

    finish()
    finish(err=errors[0]("x"), tenant="acme")
    finish(err=errors[1]("x"))
    finish(err=errors[2]("engine died"), max_new=7, tenant="acme")
    orig = req_cls([1, 2], max_new_tokens=6)
    resume, carried = resume_fn(orig, [1, 2, 9, 9, 9], max_len=64)
    met.request_failover(orig, carried)
    resume._finish(tokens=[1, 2, 9, 9, 9, 8, 8, 8])
    met.request_finished(resume)
    return met


def test_ledger_classifies_like_reference():
    """Every error class lands on its own token bucket, failover salvage
    counts as replayed, and the ledger (fleet and per tenant) equals the
    reference's for the same finishes."""
    import mxnet_tpu as jmx
    mine = _ledger_run(ServingMetrics, Request, make_resume,
                       (BrownoutShed, DeadlineExceeded, MXNetError))
    ref = _ledger_run(jmetrics.ServingMetrics, jsched.Request,
                      jsched.make_resume,
                      (jsched.BrownoutShed, jsched.DeadlineExceeded,
                       jmx.MXNetError))
    tok = mine.tokens_ledger()
    assert tok == ref.tokens_ledger()
    assert tok["goodput"] == 2 + (3 + 3) and tok["shed"] == 5
    assert tok["expired"] == 5 and tok["failed"] == 7
    assert tok["replayed"] == 3
    _token_identity(tok)
    a, b = mine.statusz(), ref.statusz()
    for s in (a, b):
        s.pop("uptime_s")
        s.pop("goodput_tok_per_sec")
    assert a == b


def test_resume_goodput_judged_by_client_ttft(monkeypatch):
    monkeypatch.setenv("MXNET_SLO_TTFT_MS", "100")
    met = ServingMetrics()
    orig = Request([1, 2], max_new_tokens=6)
    orig.t_first_token = orig.t_submit + 0.4      # 400 ms > 100 ms
    orig.t_client_first_token = orig.t_first_token
    orig.t_last_token = orig.t_first_token
    resume, _ = make_resume(orig, [1, 2, 9], max_len=64)
    assert resume.t_client_submit == orig.t_client_submit
    assert resume.t_client_first_token == orig.t_client_first_token
    resume._finish(tokens=[1, 2, 9, 8, 8])
    met.request_finished(resume)
    tok = met.tokens_ledger()
    assert tok["slow"] == 3 and tok["goodput"] == 0, tok


def test_tenant_sanitize_collision_and_cap():
    met = ServingMetrics()
    assert met._tenant("a-b") is met._tenant("a.b")
    assert len(met._tenants_view()) == 1
    for i in range(2 * met._TENANT_CAP):
        met._tenant("t%d" % i)
    view = met._tenants_view()
    assert len(view) <= met._TENANT_CAP + 1
    assert "overflow" in view
    assert met._tenant("yet-another") is view["overflow"]


def test_slo_and_ledger_respect_kill_switch(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    monkeypatch.setenv("MXNET_REQUEST_LOG", str(tmp_path / "dead.jsonl"))
    req = Request([1, 2, 3], max_new_tokens=2)
    telemetry.request_event("queued", req)
    assert not (tmp_path / "dead.jsonl").exists()
    met = ServingMetrics()
    req._finish(tokens=[1, 2, 3, 4])
    met.request_finished(req)
    assert met.tokens_ledger()["submitted"] == 0


def test_request_event_mirrors_failover_victims_to_flight():
    req = Request([1, 2, 3], max_new_tokens=2, tenant="acme")
    telemetry.request_event("queued", req)
    assert telemetry.flight().events() == []         # not implicated
    req.failovers = 1
    telemetry.request_event("finish", req, outcome="completed")
    telemetry.request_event("decode", req, itl_ms=1.0)   # never mirrored
    evs = telemetry.flight().events()
    assert [e["name"] for e in evs] == ["request.finish"]
    assert evs[0]["tenant"] == "acme" and evs[0]["trace"] == req.trace


# ---------------------------------------------------------------------------
# tools/fleet_top.py against the live port server
# ---------------------------------------------------------------------------


def test_fleet_top_renders_live_server(lm, monkeypatch):
    monkeypatch.setenv("MXNET_SLO_TTFT_MS", "500")
    srv = _serve(lm)
    try:
        host, port = srv.serve_http(port=0, block=False)
        srv.submit([1, 2, 3], max_new_tokens=2,
                   tenant="acme").result(timeout=120)
        r = subprocess.run(
            [sys.executable, os.path.join(ROOT, "tools", "fleet_top.py"),
             "--url", "http://%s:%d" % (host, port), "--once", "--plain"],
            capture_output=True, text=True, timeout=120)
    finally:
        srv.close()
    assert r.returncode == 0, r.stderr
    frame = r.stdout
    assert "server: OK" in frame
    assert "tokens: submitted" in frame
    assert "goodput" in frame and "acme" in frame
    assert "burn" in frame
