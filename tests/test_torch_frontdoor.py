"""Port parity for the serving front door's contract: the scheduler's
multi-tenant admission, deadlines and brownout, `make_resume`, the
deadline gate, and the HTTP statuses (mxnet_tpu_torch/serving/
scheduler.py and server.py) against the JAX reference, on the CPU.

Mirrors tests/test_serving_failover.py's deadline and brownout tests
(:404-659) and `make_resume` (:137). Decisions are held to the
reference's with the same injected `now` and the same injected observed
rates, never on wall clocks: no test sleeps to make a deadline pass.
"""
import json
import math
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import scheduler as jsched
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import scheduler as tsched

from test_torch_serving import lm, PROMPTS  # noqa: F401 (fixture)

PKGS = {"port": (tsched, MXNetError), "reference": (jsched, jmx.MXNetError)}
T0 = 1000.0


# ---------------------------------------------------------------------------
# Scheduler.admit parity over parametrised scenarios
# ---------------------------------------------------------------------------


class _Engine:
    """The same admission oracle for both schedulers: a block pool of
    `cap` tokens, prompts over `max_len` unservable, a prefill chunk of
    `chunk` tokens and `dtps` scored tokens per decode step."""

    def __init__(self, err, cap=10 ** 6, max_len=64, chunk=8, dtps=1):
        self.err, self.cap, self.max_len = err, cap, max_len
        self.chunk, self.dtps = chunk, dtps

    def can_admit(self, prompt_len, max_new):
        if prompt_len > self.max_len:
            raise self.err("prompt of %d tokens exceeds max_len %d"
                           % (prompt_len, self.max_len))
        return prompt_len + max_new <= self.cap

    def prefill_tokens_per_step(self, prompt_len):
        return min(prompt_len, self.chunk)

    def decode_tokens_per_step(self):
        return self.dtps


def _seq(req_tenant, prompt_len=4):
    return types.SimpleNamespace(
        request=types.SimpleNamespace(tenant=req_tenant),
        prompt_len=prompt_len, done=False)


# each scenario: scheduler kwargs, engine kwargs, request specs
# (prompt_len, max_new, tenant, priority, deadline_ms, t_submit offset,
# failovers, migrated), and rounds (now offset, running tenants,
# prefilling tenants)
R = dict


def _r(plen=4, new=16, tenant=None, prio=None, dl=None, at=0.0, fo=0,
       mig=False):
    return (plen, new, tenant, prio, dl, at, fo, mig)


SCENARIOS = {
    "fifo": (R(max_batch=3), R(), [_r(at=0.01 * i) for i in range(5)],
             [(1.0, [], []), (1.1, ["default"] * 3, []),
              (1.2, ["default"], [])]),
    "priority_order": (
        R(max_batch=2), R(),
        [_r(prio=p, at=0.01 * i) for i, p in enumerate([0, 2, 1, 2, 0, 1])],
        [(1.0, [], []), (1.1, [], []), (1.2, ["default"], []),
         (1.3, [], [])]),
    "head_of_line_in_class": (
        R(max_batch=4), R(cap=40),
        [_r(prio=1, new=60, at=0.0), _r(prio=1, at=0.1), _r(prio=0, at=0.2),
         _r(prio=2, at=0.3)],
        [(1.0, [], []), (1.1, [], [])]),
    "token_budget": (
        R(max_batch=8, token_budget=12), R(),
        [_r(plen=8 - i, at=0.01 * i) for i in range(5)],
        [(1.0, ["default"] * 2, []), (1.1, [], ["default"]),
         (1.2, [], [])]),
    "tenant_budget": (
        R(max_batch=8, tenant_budget=8), R(),
        [_r(tenant="a", at=0.0), _r(tenant="a", at=0.1),
         _r(tenant="b", at=0.2), _r(tenant="a", at=0.3),
         _r(tenant="b", at=0.4)],
        [(1.0, ["a"] * 6, []), (1.1, [], []), (1.2, ["b"] * 8, [])]),
    "tenant_budgets_map": (
        R(max_batch=8, tenant_budgets={"a": 4, "b": 100},
          tenant_budget=6), R(),
        [_r(tenant=t, plen=4, at=0.1 * i)
         for i, t in enumerate("aabbcca")],
        [(1.0, ["a", "c"], ["c"]), (1.1, [], [])]),
    "deadline_drops_not_shadowed": (
        R(max_batch=1), R(),
        [_r(dl=50.0, at=0.0), _r(dl=2000.0, at=0.0), _r(at=0.1),
         _r(dl=10.0, at=0.5)],
        [(0.04, ["default"], []), (0.52, ["default"], []),
         (1.9, ["default"], []), (2.5, [], [])]),
    "queue_timeout": (
        R(max_batch=2, queue_timeout=0.5), R(),
        [_r(at=0.0), _r(at=0.4), _r(at=0.45), _r(at=0.9)],
        [(0.3, ["default"] * 2, []), (0.95, ["default"], []),
         (1.0, [], [])]),
    "unservable_prompt": (
        R(max_batch=4), R(max_len=16),
        [_r(plen=4), _r(plen=40, at=0.1), _r(plen=8, at=0.2)],
        [(1.0, [], [])]),
    "speculative_decode_cost": (
        R(max_batch=8, token_budget=20), R(dtps=4),
        [_r(plen=8, at=0.1 * i) for i in range(4)],
        [(1.0, ["default"] * 3, []), (1.1, ["default"], [])]),
    "brownout_sheds_then_clamps": (
        R(max_batch=2, max_queue=8, brownout=True, brownout_after_s=0.2,
          brownout_max_new=3), R(),
        [_r(prio=0 if i < 4 else 5, at=0.01 * i) for i in range(8)],
        [(1.0, ["default"] * 2, []), (1.1, ["default"] * 2, []),
         (1.25, ["default"] * 2, []), (1.3, [], []), (1.4, [], []),
         (1.5, [], [])]),
    "brownout_single_class_clamps_only": (
        R(max_batch=2, max_queue=8, brownout=True, brownout_after_s=0.0,
          brownout_max_new=3), R(),
        [_r(at=0.01 * i) for i in range(6)],
        [(1.0, ["default"] * 2, []), (1.01, ["default"] * 2, []),
         (1.02, [], []), (1.03, [], [])]),
    "brownout_spares_resumes_and_hops": (
        R(max_batch=4, max_queue=8, brownout=True, brownout_after_s=0.0,
          brownout_max_new=2), R(),
        [_r(prio=0, at=0.01 * i) for i in range(3)]
        + [_r(prio=5, at=0.1 + 0.01 * i) for i in range(3)]
        + [_r(prio=0, new=12, at=0.3, fo=1), _r(prio=0, new=9, at=0.31,
                                                mig=True)],
        [(1.0, ["default"] * 4, []), (1.01, ["default"] * 4, []),
         (1.02, [], []), (1.03, [], [])]),
}


def _run_scenario(pkg, name):
    sched_mod, err = PKGS[pkg]
    skw, ekw, specs, rounds = SCENARIOS[name]
    eng = _Engine(err, **ekw)
    sched = sched_mod.Scheduler(**skw)
    reqs = []
    for plen, new, tenant, prio, dl, at, fo, mig in specs:
        r = sched_mod.Request(list(range(1, plen + 1)), max_new_tokens=new,
                              tenant=tenant, priority=prio, deadline_ms=dl)
        r.t_submit = T0 + at
        r.t_deadline = None if dl is None else r.t_submit + dl / 1e3
        r.failovers, r.migrated = fo, mig
        reqs.append(r)
        sched.submit(r)
    index = {id(r): i for i, r in enumerate(reqs)}
    trace = []
    for at, running, prefilling in rounds:
        sched.running = [_seq(t) for t in running]
        sched.prefilling = [_seq(t) for t in prefilling]
        admitted, expired = sched.admit(eng, now=T0 + at)
        trace.append({
            "admitted": [(index[id(r)], r.max_new_tokens, r.t_admit - T0)
                         for r in admitted],
            "expired": [(index[id(r)], type(r.error).__name__)
                        for r in expired],
            "brownout_active": sched.brownout_active,
            "pending": sched.pending(),
            "counters": (sched.deadline_drops, sched.brownout_sheds)})
    for r in reqs:
        if r.error is not None:
            assert r.wait(0)
            with pytest.raises(type(r.error)):
                r.result(timeout=0)
    return trace


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_admit_matches_reference(name):
    """Both schedulers get the same queue, the same injected `now` and
    the same engine: the same request ids admit in the same order, with
    the same drops, sheds and clamps."""
    mine = _run_scenario("port", name)
    assert mine == _run_scenario("reference", name)
    assert any(r["admitted"] or r["expired"] for r in mine)


def test_scenarios_exercise_every_decision():
    """The scenario table covers each admission decision at least once."""
    seen = set()
    for name in SCENARIOS:
        for rnd in _run_scenario("port", name):
            seen.update(e for _, e in rnd["expired"])
            if rnd["brownout_active"]:
                seen.add("brownout")
            if any(new < SCENARIOS[name][2][i][1]
                   for i, new, _ in rnd["admitted"]):
                seen.add("clamp")
    assert {"DeadlineExceeded", "BrownoutShed", "RequestTimeout",
            "MXNetError", "brownout", "clamp"} <= seen, seen


def test_scheduler_env_knobs(monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_TENANT_BUDGET", "24")
    monkeypatch.setenv("MXNET_SERVING_TOKEN_BUDGET", "96")
    monkeypatch.setenv("MXNET_SERVING_BROWNOUT", "1")
    for mod in (tsched, jsched):
        s = mod.Scheduler(max_batch=2, tenant_budgets={"vip": 5})
        assert (s.tenant_budget, s.token_budget, s.brownout) == (24, 96,
                                                                 True)
        assert s.tenant_budget_for("vip") == 5
        assert s.tenant_budget_for("other") == 24
    monkeypatch.delenv("MXNET_SERVING_BROWNOUT")
    assert tsched.Scheduler(max_batch=2).brownout is False


def test_spent_by_tenant_matches_reference():
    outs = []
    for pkg in ("port", "reference"):
        mod, err = PKGS[pkg]
        s = mod.Scheduler(max_batch=8)
        s.running = [_seq("a"), _seq("b"), _seq("a")]
        s.prefilling = [_seq("a", 20), _seq(None, 3)]
        eng = _Engine(err, dtps=3)
        outs.append((s.spent_tokens(eng), s.spent_by_tenant(eng)))
    assert outs[0] == outs[1] == (9 + 8 + 3, {"a": 14, "b": 3,
                                              "default": 3})


# ---------------------------------------------------------------------------
# make_resume
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens,migrate", [
    ([1, 2, 3, 4, 5], False), ([1, 2, 3, 4, 5], True),
    ([1, 2, 3] + [9] * 8, False), ([1, 2, 3, 9, 7], False),
    ([1, 2, 3], False)])
def test_make_resume_matches_reference(tokens, migrate):
    got = []
    for mod in (tsched, jsched):
        orig = mod.Request([1, 2, 3], max_new_tokens=8, eos_id=7,
                           deadline_ms=5000.0, tenant="acme", priority=2)
        orig.failovers = 1
        orig.t_last_token = orig.t_submit + 0.5
        resume, carried = mod.make_resume(orig, list(tokens), max_len=64,
                                          migrate=migrate)
        if resume is None:
            got.append((None, carried))
            continue
        assert resume.trace == orig.trace
        assert resume.t_deadline == orig.t_deadline
        assert resume.t_client_submit == orig.t_client_submit
        assert resume.t_last_token == orig.t_last_token
        got.append((resume.prompt, resume.max_new_tokens, resume.eos_id,
                    resume.tenant, resume.priority, resume.deadline_ms,
                    resume.failovers, resume.migrated,
                    resume.resumed_tokens, carried))
    assert got[0] == got[1]


# ---------------------------------------------------------------------------
# both servers: the deadline gate, the HTTP contract, greedy tokens
# ---------------------------------------------------------------------------


def _servers(lm, **kw):
    jparams, jcfg, params, cfg = lm
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("paged", True)
    return {"port": serving.serve((params, cfg), device="cpu", **kw),
            "reference": jserving.serve((jparams, jcfg), **kw)}


def _close(srvs):
    for srv in srvs.values():
        srv.close()


def _stub_rates(srv, monkeypatch, decode, prefill):
    monkeypatch.setattr(srv.metrics, "observed_token_rate",
                        lambda min_steps=8: decode)
    monkeypatch.setattr(srv.metrics, "observed_prefill_rate",
                        lambda: prefill)


@pytest.mark.parametrize("decode,prefill,deadline_ms,max_new", [
    (None, None, 60_000.0, 8),       # cold server: never sheds
    (100.0, 1000.0, 0.001, 8),       # hopeless: shed
    (100.0, 1000.0, 500.0, 8),       # feasible: admit
    (10.0, None, 2000.0, 30),        # shed, Retry-After past 1 s
    (10.0, 50.0, 3000.0, 29)])       # admit (prefill priced separately)
def test_deadline_gate_matches_reference(lm, monkeypatch, decode, prefill,
                                         deadline_ms, max_new):
    srvs = _servers(lm)
    out = {}
    try:
        for name, srv in srvs.items():
            _stub_rates(srv, monkeypatch, decode, prefill)
            shed = {"UnmeetableErrors": (tsched.DeadlineUnmeetable,
                                         jsched.DeadlineUnmeetable)}
            try:
                req = srv.submit(PROMPTS[0], max_new_tokens=max_new,
                                 deadline_ms=deadline_ms)
                out[name] = ("admitted", len(req.result(timeout=120)))
            except shed["UnmeetableErrors"] as e:
                out[name] = ("shed", e.retry_after_s)
            snap = srv.snapshot()
            out[name] += (snap["requests"]["deadline_shed"],
                          snap["tokens"]["shed"])
    finally:
        _close(srvs)
    assert out["port"][0] == out["reference"][0]
    assert math.isclose(out["port"][1], out["reference"][1], rel_tol=1e-12)
    assert out["port"][2:] == out["reference"][2:]


def _post(url, payload, headers=None):
    rq = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(rq, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _http_contract(srv, monkeypatch):
    """200 with traceparent in and out, 503 + computed Retry-After, 504
    from a deadline that passed in queue (admission sees a clock an hour
    ahead instead of a sleep), 429 from a full queue under a parked
    loop, 400 and 404."""
    host, port = srv.serve_http(port=0, block=False)
    base = "http://%s:%d" % (host, port)
    url = base + "/v1/generate"
    tid = "4bf92f3577b34da6a3ce929d0e0e4736"
    out = {}
    code, body, hdr = _post(url, {"tokens": PROMPTS[1], "max_new_tokens": 3,
                                  "tenant": "acme", "priority": 1},
                            {"traceparent": "00-%s-00f067aa0ba902b7-01"
                             % tid})
    out["200"] = (code, body["trace"] == tid, len(body["tokens"]),
                  hdr["traceparent"].split("-")[1] == tid)
    _stub_rates(srv, monkeypatch, 50.0, 500.0)
    code, body, hdr = _post(url, {"tokens": PROMPTS[0], "max_new_tokens": 100,
                                  "deadline_ms": 20.0})
    out["503"] = (code, hdr.get("Retry-After"))
    monkeypatch.undo()
    real = srv.scheduler.admit
    srv.scheduler.admit = lambda eng, now=None: real(
        eng, time.perf_counter() + 3600.0)
    code, body, _ = _post(url, {"tokens": PROMPTS[0], "max_new_tokens": 3,
                                "deadline_ms": 5000.0})
    out["504"] = (code, "deadline" in body["error"])
    parked, release = threading.Event(), threading.Event()

    def park(eng, now=None):
        parked.set()
        release.wait(60)
        return [], []

    srv.scheduler.admit = park
    srv._work.set()
    assert parked.wait(30)
    srv.scheduler.max_queue = 1
    srv.submit_retries = 1
    held = srv.submit(PROMPTS[0], max_new_tokens=2)
    code, body, _ = _post(url, {"tokens": PROMPTS[1], "max_new_tokens": 2})
    out["429"] = (code, "full" in body["error"])
    srv.scheduler.admit = real
    release.set()
    out["held"] = len(held.result(timeout=120))
    out["400"] = _post(url, {"nope": 1})[0]
    out["404"] = _post(base + "/v1/rollout", {"cmd": "status"})[0]
    snap = srv.snapshot()
    out["requests"] = {k: snap["requests"][k] for k in (
        "submitted", "completed", "failed", "rejected", "expired",
        "deadline_shed", "brownout_shed")}
    out["tokens"] = snap["tokens"]
    return out


def test_http_contract_matches_reference(lm, monkeypatch):
    srvs = _servers(lm)
    try:
        outs = {name: _http_contract(srv, monkeypatch)
                for name, srv in srvs.items()}
    finally:
        _close(srvs)
    mine = outs["port"]
    assert mine == outs["reference"]
    assert mine["200"] == (200, True, 3, True)
    assert mine["503"][0] == 503 and int(mine["503"][1]) >= 1
    assert mine["504"] == (504, True)
    assert mine["429"] == (429, True)
    assert (mine["400"], mine["404"]) == (400, 404)


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_tokens_identical_through_both_servers(lm, paged):
    """Tenants, priorities and a generous deadline change which request
    admits when, never its tokens."""
    srvs = _servers(lm, paged=paged)
    got = {}
    try:
        for name, srv in srvs.items():
            reqs = [srv.submit(p, max_new_tokens=6, tenant="t%d" % (i % 2),
                               priority=i, deadline_ms=600_000.0)
                    for i, p in enumerate(PROMPTS)]
            got[name] = [r.result(timeout=300) for r in reqs]
    finally:
        _close(srvs)
    assert got["port"] == got["reference"]


def test_brownout_through_both_servers(lm):
    """A parked loop, a burst at two priorities, then admission: the
    lowest class is shed (BrownoutShed), requests admitted after
    brownout began are clamped, the one admitted before keeps its
    length — the same requests in both packages."""
    srvs = _servers(lm, max_batch=1, max_queue=8, brownout=True)
    got = {}
    try:
        for name, srv in srvs.items():
            srv.scheduler.brownout_after_s = 0.0
            srv.scheduler.brownout_max_new = 2
            real, parked, release = (srv.scheduler.admit, threading.Event(),
                                     threading.Event())

            def park(eng, now=None, _p=parked, _r=release):
                _p.set()
                _r.wait(60)
                return [], []

            srv.scheduler.admit = park
            srv._work.set()
            assert parked.wait(30)
            reqs = [srv.submit(PROMPTS[i % 3], max_new_tokens=5,
                               priority=int(i >= 4)) for i in range(8)]
            srv.scheduler.admit = real
            release.set()
            outs = []
            for r in reqs:
                try:
                    outs.append(len(r.result(timeout=120)))
                except (tsched.BrownoutShed, jsched.BrownoutShed):
                    outs.append("shed")
            got[name] = (outs, srv.metrics.brownout_shed,
                         srv.snapshot()["tokens"])
    finally:
        _close(srvs)
    assert got["port"] == got["reference"]
    # admitted before brownout began: full length; while it is on:
    # clamped; once the queue drains below max_queue // 4 it disengages
    assert got["port"][0] == ["shed"] * 4 + [5, 2, 5, 5]


def test_default_deadline_env_knob(lm, monkeypatch):
    monkeypatch.setenv("MXNET_SERVING_DEADLINE_MS", "45000")
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=1, block_size=8,
                        device="cpu")
    try:
        assert srv.default_deadline_ms == 45000.0
        req = srv.submit(PROMPTS[1], max_new_tokens=2)
        assert req.deadline_ms == 45000.0
        assert req.t_deadline == pytest.approx(req.t_submit + 45.0)
        req.result(timeout=120)
    finally:
        srv.close()


def test_deadline_expired_in_queue_dropped_before_prefill(lm):
    """The 504 path's accounting: no prefill chunk ran and no prefill span
    carries the dropped request's trace."""
    from mxnet_tpu_torch import telemetry
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=2, block_size=8,
                        paged=True, device="cpu")
    try:
        real = srv.scheduler.admit
        srv.scheduler.admit = lambda eng, now=None: real(
            eng, time.perf_counter() + 3600.0)
        req = srv.submit(PROMPTS[0], max_new_tokens=4, deadline_ms=30.0)
        with pytest.raises(serving.DeadlineExceeded, match="deadline"):
            req.result(timeout=60)
        srv.scheduler.admit = real
        assert srv.metrics.deadline_shed == 1
        assert srv.metrics.prefill_chunks == 0
        assert not [s for s in telemetry.spans(trace=req.trace)
                    if s["name"] == "serving.prefill"]
        tok = srv.snapshot()["tokens"]
        assert tok["expired"] == 4 and tok["submitted"] == 4
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# what is not ported raises, naming its ROADMAP item
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kwargs,item", [
    ({"tp": 2}, "item 9"), ({"devices": ["cuda:0"]}, "item 9"),
    ({"role": "prefill"}, "item 9"), ({"aot_cache": "/nonexistent"},
                                      "item 11"),
    ({"replicas": 2}, "item 9"), ({"autoscale": True}, "item 9"),
    ({"roles": "prefill:1,decode:1"}, "item 9"),
    ({"rollout": "/nonexistent"}, "item 9")])
def test_unported_arguments_raise_naming_their_item(lm, kwargs, item):
    _, _, params, cfg = lm
    with pytest.raises(MXNetError, match="ROADMAP %s" % item):
        serving.serve((params, cfg), device="cpu", **kwargs)


@pytest.mark.parametrize("var,value", [
    ("MXNET_SERVING_REPLICAS", "2"), ("MXNET_SERVING_AUTOSCALE", "1"),
    ("MXNET_SERVING_ROLES", "prefill:1,decode:1"),
    ("MXNET_SERVING_ROLLOUT_DIR", "/nonexistent")])
def test_unported_env_knobs_raise(lm, monkeypatch, var, value):
    _, _, params, cfg = lm
    monkeypatch.setenv(var, value)
    with pytest.raises(MXNetError, match="ROADMAP item 9"):
        serving.serve((params, cfg), device="cpu")
