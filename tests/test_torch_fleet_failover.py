"""Port parity for the fleet's survival layer (mxnet_tpu_torch/serving/
router.py with server.py's death hook) against the JAX reference, on the
CPU's tiny LM.

Mirrors tests/test_serving_failover.py's router tests (:163 in-flight
failover, :203 the drain/restore race, :264 orphans, :302 death and
respawn, :352 the crash-loop circuit, :387 the respawn knob) and the
stitched failover trace of tests/test_slo.py:166. Each scenario runs
through both packages: greedy tokens through failover identical to the
undisturbed oracle (and to each other), each request finished exactly
once, and the same counters, circuit states and ledger identities. Every
`result()` and `close()` carries a timeout.
"""
import threading
import time

import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.utils import chaos as jchaos
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.utils import chaos

from test_torch_serving import lm  # noqa: F401 (fixture)
from test_torch_router import (TIMEOUT, arith_prompt, both, fleet, wait,
                               _token_identity)


def _chaos(pkg):
    return chaos if pkg == "port" else jchaos


def _tel(pkg):
    return telemetry if pkg == "port" else jtel


def _err_type(pkg):
    return (serving if pkg == "port" else jserving).QueueFull


@pytest.fixture(autouse=True)
def _clean():
    for c in (chaos, jchaos):
        c.reset()
    for t in (telemetry, jtel):
        t.tracing.clear()
        t.flight().clear()
    yield
    for c in (chaos, jchaos):
        c.reset()


@pytest.fixture(scope="module")
def oracle(lm):
    """Undisturbed greedy rollouts from each package's single server."""
    cases = {"a": (arith_prompt(3, 2, 6), 6), "b": (arith_prompt(5, 3, 7), 5),
             "c": (arith_prompt(4, 1, 6), 6),
             "t": ([3, 5, 7, 9, 11, 13], 6)}

    def run(pkg):
        srv = fleet(pkg, lm)
        try:
            return {k: srv.generate(list(p), max_new_tokens=n,
                                    timeout=TIMEOUT)
                    for k, (p, n) in cases.items()}
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    return cases, out["port"]


def count_finishes(req):
    """Wrap req._finish to count invocations (the exactly-once pin)."""
    calls = {"n": 0}
    real = req._finish

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    req._finish = counting
    return calls


def park_after_decodes(rep, n_calls):
    """Park a replica's serving thread INSIDE the decode seam after
    `n_calls` decode steps (tokens appended): wedged mid-generation."""
    real = rep.engine.decode_step
    parked, hold = threading.Event(), threading.Event()
    state = {"n": 0}

    def parking(seqs):
        out = real(seqs)
        state["n"] += 1
        if state["n"] == n_calls:
            parked.set()
            hold.wait(TIMEOUT)
        return out

    rep.engine.decode_step = parking
    return parked, hold


def test_inflight_failover_token_identical(lm, oracle):
    cases, want = oracle
    prompt, max_new = cases["a"]

    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        hold = None
        try:
            victim = srv.replicas[0]
            parked, hold = park_after_decodes(victim, 2)
            req = victim.submit(prompt, max_new_tokens=max_new)
            calls = count_finishes(req)
            assert parked.wait(TIMEOUT)
            victim._last_beat -= 999.0
            h = srv.health()                 # sweep: drain + failover
            drained = (srv._drained[0], h["ok"])
            got = req.result(timeout=TIMEOUT)
            tgt = srv.replicas[1].metrics
            counts = (calls["n"], tgt.failovers, tgt.failover_resumed_tokens,
                      srv.snapshot()["aggregate"]["failovers"])
            hold.set()
            wait(lambda: victim.engine.cache.pool.in_use == 0)
            return got, drained, counts, calls["n"]
        finally:
            if hold is not None:
                hold.set()
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    got, drained, counts, finishes = out["port"]
    assert got == want["a"], "failover diverged from the oracle rollout"
    assert drained == (True, True)
    assert counts == (1, 1, 3, 1) and finishes == 1


def test_drain_restore_race_exactly_once(lm, oracle):
    """A replica drained, re-homed and RESTORED while the failover replay
    is still gated before its prefill on the target must not serve the
    request a second time: its loop only releases the detached
    sequence."""
    cases, want = oracle
    prompt, max_new = cases["b"]

    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        hold = gate = None
        try:
            victim, target = srv.replicas
            parked, hold = park_after_decodes(victim, 2)
            real_start = target.engine.start
            gate, in_prefill = threading.Event(), threading.Event()

            def gated_start(*a, **kw):
                in_prefill.set()
                gate.wait(TIMEOUT)
                return real_start(*a, **kw)

            target.engine.start = gated_start
            req = victim.submit(prompt, max_new_tokens=max_new)
            calls = count_finishes(req)
            assert parked.wait(TIMEOUT)
            victim._last_beat -= 999.0
            srv.health()                      # drain + start the failover
            drained = srv._drained[0]
            assert in_prefill.wait(TIMEOUT), "replay never reached prefill"
            hold.set()                        # the victim recovers
            wait(lambda: not srv._drained[0], poll=srv.health)
            wait(lambda: victim.engine.cache.pool.in_use == 0)
            early = req._event.is_set()
            gate.set()                        # let the replay run
            got = req.result(timeout=TIMEOUT)
            orphaned = srv.snapshot()["router"]["metrics"][
                "serving_router_orphaned_total"]["value"]
            return got, drained, early, calls["n"], orphaned
        finally:
            for e in (hold, gate):
                if e is not None:
                    e.set()
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"] == (want["b"], True, False, 1, 0)


def test_orphaned_inflight_counted_and_failed_promptly(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        hold = None
        try:
            victim, other = srv.replicas
            full = _err_type(pkg)

            def full_adopt(req):
                raise full("saturated")

            other.adopt = full_adopt
            parked, hold = park_after_decodes(victim, 2)
            req = victim.submit(arith_prompt(2, 1, 5), max_new_tokens=6)
            assert parked.wait(TIMEOUT)
            victim._last_beat -= 999.0
            t0 = time.perf_counter()
            srv.health()
            with pytest.raises(Exception, match="orphaned") as ei:
                req.result(timeout=5)
            prompt_s = time.perf_counter() - t0
            orphaned = srv.snapshot()["router"]["metrics"][
                "serving_router_orphaned_total"]["value"]
            return type(ei.value).__name__, prompt_s < 5.0, orphaned
        finally:
            if hold is not None:
                hold.set()
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"] == ("MXNetError", True, 1)


def test_dead_replica_failover_then_respawn_serves_again(lm, oracle):
    cases, want = oracle
    prompt, max_new = cases["c"]

    def run(pkg):
        srv = fleet(pkg, lm, replicas=2, respawn_backoff=0.01)
        hold = None
        try:
            victim = srv.replicas[0]
            parked, hold = park_after_decodes(victim, 2)
            req = victim.submit(prompt, max_new_tokens=max_new)
            assert parked.wait(TIMEOUT)

            def bomb(engine):       # the loop dies OUTSIDE the engine
                raise RuntimeError("injected loop death")

            victim.scheduler.evict = bomb
            hold.set()
            victim._thread.join(timeout=TIMEOUT)
            died = victim._died
            # the death hook already failed the request over
            got = req.result(timeout=TIMEOUT)
            in_use = victim.engine.cache.pool.in_use
            wait(lambda: srv.replicas[0] is not victim, poll=srv.health)
            srv._retired_engines[0].audit_quiescent()
            corpse_kv = srv._retired_engines[0].cache.k
            snap = srv.snapshot()
            respawns = (snap["aggregate"]["respawns"], snap["router"][
                "metrics"]["serving_respawn_total"]["value"])
            srv.replicas[1].load_tokens = lambda: 10 ** 9
            out = srv.generate(arith_prompt(7, 1, 5), max_new_tokens=3,
                               timeout=TIMEOUT)
            served = srv.replicas[0].metrics.completed
            wait(lambda: srv.health()["replicas_healthy"] == 2)
            # the ledgers survive the swap: the rescued request's submit
            # lives on the corpse, its completion on the rescuer
            agg = srv.snapshot()["aggregate"]["requests"]
            _token_identity(srv.statusz()["fleet"]["tokens"])
            return (got, died, in_use, corpse_kv is None, respawns, out,
                    served, agg["submitted"],
                    agg["completed"] + agg["failed"])
        finally:
            if hold is not None:
                hold.set()
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    got, died, in_use, dropped, respawns, _, served, sub, fin = out["port"]
    assert got == want["c"] and died is True and in_use == 0
    assert dropped is True and respawns == (1, 1) and served >= 1
    assert sub == fin == 2


def test_crash_loop_opens_circuit_fleet_survives(lm):
    def run(pkg):
        _chaos(pkg).configure(serve_crash_loop=(0, 3))
        srv = fleet(pkg, lm, replicas=2, respawn_max=2,
                    respawn_backoff=0.01)
        try:
            wait(lambda: srv.health()["replicas_circuit_open"] == 1)
            h = srv.health()
            snap = srv.snapshot()["router"]["metrics"]
            outs = [srv.generate(arith_prompt(i, 1, 5), max_new_tokens=2,
                                 timeout=TIMEOUT) for i in range(3)]
            return (h["replicas"][0]["circuit_open"], h["ok"],
                    h["degraded"], snap["serving_respawn_total"]["value"],
                    snap["serving_crash_loop_open"]["value"],
                    "serving_crash_loop_open" in srv.prometheus_text(),
                    outs, srv._drained[0], srv._circuit_open[0])
        finally:
            _chaos(pkg).configure(serve_crash_loop=None)
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][:6] == (True, True, True, 2, 1, True)
    assert out["port"][7:] == (True, True)


def test_respawn_max_env_knob(lm, monkeypatch):
    monkeypatch.setenv("MXNET_REPLICA_RESPAWN_MAX", "5")

    def run(pkg):
        srv = fleet(pkg, lm, replicas=2, max_batch=1)
        try:
            mod = serving if pkg == "port" else jserving
            return mod.serving_respawn_max(), srv.respawn_max
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"] == (5, 5)


def test_failover_trace_stitched_single_row(lm, oracle, tmp_path):
    """Kill a replica's progress mid-decode: every span of the request —
    the victim's prefill and decodes AND the rescuer's replay — shares
    ONE trace id with one `serving.failover_hop`, and the Perfetto export
    renders it as one named row. The client's TTFT is observed once, on
    the victim."""
    cases, want = oracle
    prompt, max_new = cases["t"]

    def run(pkg):
        tel = _tel(pkg)
        srv = fleet(pkg, lm, replicas=2)
        hold = None
        try:
            victim = srv.replicas[0]
            parked, hold = park_after_decodes(victim, 2)
            req = victim.submit(list(prompt), max_new_tokens=max_new)
            tid = req.trace
            assert parked.wait(TIMEOUT)
            victim._last_beat -= 999.0
            srv.health()
            got = req.result(timeout=TIMEOUT)
            hold.set()
            spans = tel.spans(trace=tid)
            names = [s["name"] for s in spans]
            hops = [s["attrs"] for s in spans
                    if s["name"] == "serving.failover_hop"]
            doc = tel.export_perfetto(str(tmp_path / (pkg + ".json")))
            evs = [e for e in doc["traceEvents"]
                   if e["ph"] == "X" and e["args"].get("trace") == tid]
            rows = {e["tid"] for e in evs}
            meta = [e["args"]["name"] for e in doc["traceEvents"]
                    if e["ph"] == "M" and e["tid"] in rows]
            return (got, "serving.submit" in names,
                    names.count("serving.prefill") >= 2,
                    names.count("serving.decode") >= 3,
                    [(h["request"] == req.id, h["carried_tokens"], h["hop"],
                      h["target"]) for h in hops],
                    len(rows), meta == ["trace %s" % tid],
                    "serving.failover_hop" in {e["name"] for e in evs},
                    srv.replicas[1].metrics._h_ttft.count,
                    victim.metrics._h_ttft.count)
        finally:
            if hold is not None:
                hold.set()
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][0] == want["t"]
    assert out["port"][1:4] == (True, True, True)
    assert out["port"][4] == [(True, 3, 1, 1)]
    assert out["port"][5:] == (1, True, True, 0, 1)
