"""Port parity for the multi-replica front door (mxnet_tpu_torch/serving/
router.py) against the JAX reference (mxnet_tpu/serving/router.py), on
the CPU's tiny LM.

Mirrors tests/test_serving_router.py's nine tests (:53-:337) and the
fleet `statusz` of tests/test_slo.py:529: the same scenario runs through
both packages' `ReplicatedLMServer`, and the port is held to the
reference's replica choices under the same scripted loads, its 503 and
Retry-After, drain and restore, greedy tokens (identical), counters and
the merged exposition's sample names and labels. Also the K1 launch
counter under concurrent replica threads. Every `result()` and `close()`
carries a timeout; no test waits on a wall clock to pass a window.
"""
import json
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import paged_attention as pa

from test_torch_serving import lm  # noqa: F401 (fixture)

PKGS = ("port", "reference")
TIMEOUT = 60


def _mod(pkg):
    return serving if pkg == "port" else jserving


def _err(pkg):
    return MXNetError if pkg == "port" else jmx.MXNetError


def fleet(pkg, lm, **kw):
    """serve() of both packages over the same weights; the port on the
    CPU."""
    jparams, jcfg, params, cfg = lm
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    if pkg == "port":
        return serving.serve((params, cfg), device="cpu", **kw)
    return jserving.serve((jparams, jcfg), **kw)


def arith_prompt(start, stride, n, vocab=48):
    return [(start + stride * t) % vocab for t in range(n)]


def wait(cond, timeout=TIMEOUT, poll=None):
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, "condition not met"
        if poll is not None:
            poll()
        time.sleep(0.01)


def both(fn):
    """Run `fn(pkg)` for the port and the reference; return both."""
    return {pkg: fn(pkg) for pkg in PKGS}


def park_admit(rep):
    """Park a replica's serving thread inside `admit` (its beat goes
    stale with the queue intact). Returns (release, restore)."""
    parked, hold = threading.Event(), threading.Event()
    orig = rep.scheduler.admit

    def stuck(engine, now=None):
        parked.set()
        hold.wait(TIMEOUT)
        return orig(engine, now)

    rep.scheduler.admit = stuck
    rep._work.set()
    assert parked.wait(TIMEOUT)
    rep._last_beat -= 999.0
    return hold, orig


# ---------------------------------------------------------------------------
# routing policy
# ---------------------------------------------------------------------------


def test_least_loaded_routing_pinned(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=3)
        try:
            loads = {0: 100, 1: 7, 2: 50}
            for i, rep in enumerate(srv.replicas):
                rep.load_tokens = (lambda v: (lambda: v))(loads[i])
            order = srv._pick_order()
            for rep in srv.replicas:
                rep.load_tokens = lambda: 5
            heads = [srv._pick_order()[0] for _ in range(6)]
            return order, heads
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][0] == [1, 2, 0]
    assert set(out["port"][1]) == {0, 1, 2}


def test_mixed_length_traffic_spreads_and_completes(lm):
    lens = (4, 11, 6, 17, 9, 5)

    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        try:
            assert isinstance(srv, _mod(pkg).ReplicatedLMServer)
            results = {}

            def client(i, plen):
                results[i] = srv.generate(arith_prompt(i, 1, plen),
                                          max_new_tokens=3 + i % 3,
                                          timeout=TIMEOUT)

            threads = [threading.Thread(target=client, args=(i, p))
                       for i, p in enumerate(lens)]
            for t in threads:
                t.start()
                time.sleep(0.02)
            for t in threads:
                t.join(TIMEOUT)
            snap = srv.snapshot()
            per = [s["requests"]["completed"] for s in snap["replicas"]]
            return results, snap["aggregate"]["requests"], per
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"][0] == out["reference"][0]     # greedy tokens
    for pkg in PKGS:
        results, agg, per = out[pkg]
        assert [len(results[i]) for i in range(len(lens))] == \
            [3 + i % 3 for i in range(len(lens))]
        assert agg["completed"] == len(lens) and agg["failed"] == 0
        assert sum(per) == len(lens) and all(c > 0 for c in per), per


# ---------------------------------------------------------------------------
# aggregate admission: a saturated FLEET bounces at the door
# ---------------------------------------------------------------------------


def _queue_full(pkg):
    full = _mod(pkg).QueueFull

    def raise_full(*a, **kw):
        raise full("replica queue is full")
    return raise_full


def test_all_replicas_saturated_raises_queue_full(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2, max_batch=1)
        try:
            for rep in srv.replicas:
                rep.submit = _queue_full(pkg)
            with pytest.raises(_mod(pkg).QueueFull) as ei:
                srv.submit([1, 2, 3], max_new_tokens=4)
            return str(ei.value), srv.snapshot()["router"]["metrics"][
                "serving_router_rejected_total"]["value"]
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert "all 2 replicas saturated" in out["port"][0]


def _post(url, payload, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_saturated_fleet_maps_to_503_retry_after(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2, max_batch=1)
        try:
            srv.submit_retries = 1
            for rep in srv.replicas:
                rep.submit = _queue_full(pkg)
            host, port = srv.serve_http(port=0, block=False)
            code, _, hdr = _post("http://%s:%d/v1/generate" % (host, port),
                                 {"tokens": [1, 2, 3], "max_new_tokens": 4})
            rejected = srv.snapshot()["router"]["metrics"][
                "serving_router_rejected_total"]["value"]
            return code, hdr.get("Retry-After"), rejected
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    code, retry_after, rejected = out["port"]
    assert code == 503 and int(retry_after) >= 1 and rejected >= 1


# ---------------------------------------------------------------------------
# wedge drain: degraded, not dead
# ---------------------------------------------------------------------------


def test_wedged_replica_drained_and_requests_rehomed(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2, max_queue=8)
        hold = None
        try:
            victim = srv.replicas[0]
            hold, _ = park_admit(victim)
            assert victim.health()["ok"] is False
            orphans = [victim.submit(arith_prompt(i, 1, 5),
                                     max_new_tokens=3) for i in range(3)]
            out = srv.generate(arith_prompt(9, 1, 6), max_new_tokens=4,
                               timeout=TIMEOUT)
            drained = srv._drained[0]
            rescued = [r.result(timeout=TIMEOUT) for r in orphans]
            h = srv.health()
            health = (h["ok"], h["degraded"], h["replicas_healthy"],
                      h["replicas"][0]["drained"])
            before = srv.replicas[1].metrics.completed
            more = srv.generate(arith_prompt(3, 2, 4), max_new_tokens=2,
                                timeout=TIMEOUT)
            after = srv.replicas[1].metrics.completed
            host, port = srv.serve_http(port=0, block=False)
            with urllib.request.urlopen("http://%s:%d/healthz"
                                        % (host, port), timeout=TIMEOUT) as r:
                code, payload = r.getcode(), json.loads(r.read())
            rerouted = srv.snapshot()["router"]["metrics"][
                "serving_router_rerouted_total"]["value"]
            return (out, drained, rescued, health, more, after - before,
                    code, payload["degraded"], payload["ok"], rerouted)
        finally:
            if hold is not None:
                hold.set()
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    got = out["port"]
    assert len(got[0]) == 4 and got[1] is True
    assert [len(r) for r in got[2]] == [3, 3, 3]
    assert got[3] == (True, True, 1, True)
    assert got[5] == 1 and got[6] == 200 and got[7] is True
    assert got[9] == 3


def test_transient_stall_drains_then_restores(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2, max_queue=8)
        hold = None
        try:
            victim = srv.replicas[0]
            hold, orig = park_admit(victim)
            first = srv._routable()
            drained = srv._drained[0]
            victim.scheduler.admit = orig
            hold.set()
            wait(lambda: srv._routable() == [0, 1])
            healthy = srv.health()["replicas_healthy"]
            m = srv.snapshot()["router"]["metrics"]
            counts = (m["serving_router_replicas_drained_total"]["value"],
                      m["serving_router_replicas_restored_total"]["value"])
            before = victim.metrics.completed
            outs = [srv.generate(arith_prompt(i, 1, 5), max_new_tokens=2,
                                 timeout=TIMEOUT) for i in range(4)]
            return (first, drained, srv._drained[0], healthy, counts,
                    outs, victim.metrics.completed > before)
        finally:
            if hold is not None:
                hold.set()
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][:5] == ([1], True, False, 2, (1, 1))
    assert out["port"][6] is True


def test_all_replicas_wedged_is_dead(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2, max_batch=1)
        try:
            for rep in srv.replicas:
                rep._closed = True
                rep._thread.join(timeout=TIMEOUT)
            h = srv.health()
            with pytest.raises(_mod(pkg).NoHealthyReplicas) as ei:
                srv.submit([1, 2, 3])
            host, port = srv.serve_http(port=0, block=False)
            code = _post("http://%s:%d/v1/generate" % (host, port),
                         {"tokens": [1, 2, 3]})[0]
            return h["ok"], h["replicas_healthy"], str(ei.value), code
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][0] is False and out["port"][1] == 0
    assert "no healthy replicas" in out["port"][2]
    assert out["port"][3] == 503


# ---------------------------------------------------------------------------
# merged observability
# ---------------------------------------------------------------------------

_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)\{([^}]*)\} ")


def _series(text):
    """{(sample name, label names, replica label)} of one exposition."""
    out = set()
    for ln in text.splitlines():
        m = _SAMPLE.match(ln)
        if m:
            labels = dict(kv.split("=", 1) for kv in m.group(2).split(","))
            out.add((m.group(1), tuple(sorted(labels)),
                     labels.get("replica")))
    return out


def test_router_prometheus_merges_replica_registries(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        try:
            outs = [srv.generate(arith_prompt(i, 1, 5), max_new_tokens=2,
                                 timeout=TIMEOUT) for i in range(2)]
            text = srv.prometheus_text()
            labels = [rep.metrics.registry.labels()["replica"]
                      for rep in srv.replicas]
            return outs, text, labels, len(srv.snapshot()["replicas"])
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"][0] == out["reference"][0]
    assert out["port"][2:] == out["reference"][2:] == (["0", "1"], 2)
    text = out["port"][1]
    assert 'replica="0"' in text and 'replica="1"' in text
    assert 'replica="router"' in text
    assert text.count(
        "# TYPE serving_requests_submitted_total counter") == 1
    assert "serving_router_requests_total" in text
    assert "serving_router_pick_seconds_bucket" in text
    # the same samples under the same label sets: every router series the
    # reference exposes, and every replica series of the serving ledger
    port, ref = _series(text), _series(out["reference"][1])
    router = {s for s in ref if s[2] == "router"}
    assert router <= port, sorted(router - port)
    ref_serving = {s for s in ref if s[0].startswith("serving_")}
    assert ref_serving <= port, sorted(ref_serving - port)


def test_replicas_env_var_and_kwarg(lm, monkeypatch):
    def run(pkg):
        monkeypatch.setenv("MXNET_SERVING_REPLICAS", "2")
        srv = fleet(pkg, lm, max_batch=1)
        try:
            kind = (type(srv).__name__, len(srv.replicas))
        finally:
            srv.close(timeout=TIMEOUT)
        srv = fleet(pkg, lm, replicas=1, max_batch=1)
        try:
            single = type(srv).__name__
        finally:
            srv.close(timeout=TIMEOUT)
        monkeypatch.delenv("MXNET_SERVING_REPLICAS")
        jparams, jcfg, params, cfg = lm
        with pytest.raises(_err(pkg)):
            if pkg == "port":
                serving.ReplicatedLMServer((params, cfg), replicas=0,
                                           device="cpu")
            else:
                jserving.ReplicatedLMServer((jparams, jcfg), replicas=0)
        return kind, single

    out = both(run)
    assert out["port"] == out["reference"] == \
        (("ReplicatedLMServer", 2), "LMServer")


def _token_identity(tok):
    assert tok["submitted"] == (tok["goodput"] + tok["slow"] + tok["shed"]
                                + tok["expired"] + tok["failed"]), tok


def test_router_statusz_aggregates_fleet(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        try:
            outs = [srv.generate([2 + i, 3, 4], max_new_tokens=2,
                                 timeout=TIMEOUT) for i in range(4)]
            stz = srv.statusz()
            fl = stz["fleet"]
            _token_identity(fl["tokens"])
            _token_identity(fl["tenants"]["default"]["tokens"])
            per = [b["tokens"]["submitted"] for b in stz["replicas"]]
            return (outs, len(stz["replicas"]), fl["tokens"]["submitted"],
                    sum(per), fl["replicas_total"], sorted(fl))
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][1:5] == (2, 8, 8, 2)


# ---------------------------------------------------------------------------
# placement and the K1 launch counter under concurrent replicas
# ---------------------------------------------------------------------------


def test_replica_device_placement(monkeypatch):
    assert serving.replica_device(5, "cpu") == "cpu"
    monkeypatch.setattr(serving.router.torch.cuda, "is_available",
                        lambda: True)
    monkeypatch.setattr(serving.router.torch.cuda, "device_count",
                        lambda: 1)
    assert [str(serving.replica_device(i)) for i in range(3)] == \
        ["cuda:0"] * 3
    monkeypatch.setattr(serving.router.torch.cuda, "device_count",
                        lambda: 2)
    assert [str(serving.replica_device(i)) for i in range(3)] == \
        ["cuda:0", "cuda:1", "cuda:0"]
    monkeypatch.setattr(serving.router.torch.cuda, "is_available",
                        lambda: False)
    assert serving.replica_device(0) is None


def test_fleet_without_cuda_raises_not_falls_back(lm):
    _, _, params, cfg = lm
    if serving.router.torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(MXNetError, match="torch.cuda.is_available"):
        serving.serve((params, cfg), replicas=2, max_batch=1)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_launch_counter_exact_under_threads(monkeypatch, quant):
    """Eight threads bump K1's counter at once, as a fleet's serving
    threads do: every launch is counted."""
    monkeypatch.setattr(pa.paged_attention, "launches", 0)
    monkeypatch.setattr(pa.paged_attention, "launches_int8", 0)
    n, per = 8, 20000
    go = threading.Barrier(n)

    def bump():
        go.wait(TIMEOUT)
        for _ in range(per):
            pa.count_launch(quant)

    threads = [threading.Thread(target=bump) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    want = (0, n * per) if quant else (n * per, 0)
    assert (pa.paged_attention.launches,
            pa.paged_attention.launches_int8) == want
