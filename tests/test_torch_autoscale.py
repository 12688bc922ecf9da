"""Port parity for SLO-driven elastic autoscaling (mxnet_tpu_torch/
serving/autoscale.py and the router's scale_up / scale_down) against the
JAX reference, on the CPU.

Mirrors tests/test_autoscale.py's seventeen tests (:118-:416). The policy
tests feed both packages' `Autoscaler` the same scripted burns, loads and
clocks and compare every decision; the real-router tests run the same
traffic through both fleets and compare tokens and counters. The
reference's AOT warm-gauge test (:416) becomes: the door accepts
`aot_cache=`, and the gauge follows the replicas' `engine.warm_loads`
(on the CPU no kernel library loads, so a replica's count is set by
hand).
Every clock is injected (`step(now=...)`); every `result()` and
`close()` carries a timeout.
"""
import threading
import time

import pytest

from mxnet_tpu.serving import autoscale as jauto
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import autoscale as tauto

from test_torch_serving import lm  # noqa: F401 (fixture)
from test_torch_router import TIMEOUT, arith_prompt, both, fleet


def _auto(pkg):
    return tauto if pkg == "port" else jauto


class FakeRouter:
    """Just enough router for the decision tests: a replica list and
    scale ops that honour nothing (bounds are the scaler's job)."""

    def __init__(self, n=1):
        self._closed = False
        self.replicas = ["rep%d" % i for i in range(n)]

    def scale_up(self):
        self.replicas.append("rep%d" % len(self.replicas))
        return self.replicas[-1]

    def scale_down(self):
        if len(self.replicas) <= 1:
            return None
        return self.replicas.pop()


def burns(rate, total=10, windows=(60, 300)):
    return {w: {"rate": rate, "good": max(0, total - 1),
                "total": total, "span_s": float(w)} for w in windows}


def scaler(pkg, router, **kw):
    base = dict(min_replicas=1, max_replicas=4, up_burn=1.0,
                down_burn=0.1, cooldown_s=30.0, idle_retire_s=60.0)
    base.update(kw)
    a = _auto(pkg)
    return a.Autoscaler(router, config=a.AutoscaleConfig(**base))


def drive(n, script, last_action=None, **cfg):
    """Run `script` — (now, burns, committed tokens) per tick — through
    both packages' Autoscaler over a FakeRouter of `n` replicas. Returns
    the decisions and fleet sizes after each tick, held equal."""
    def run(pkg):
        r = FakeRouter(n)
        sc = scaler(pkg, r, **cfg)
        if last_action is not None:
            sc._last_action_t = last_action
        out = []
        for now, b, load in script:
            sc.burn_rates = lambda b=b: b
            sc.fleet_load_tokens = lambda load=load: load
            out.append((sc.step(now=now), len(r.replicas)))
        return out, sc.scale_ups, sc.scale_downs, \
            sc.last_breach_to_action_s

    out = both(run)
    assert out["port"] == out["reference"]
    return out["port"]


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

_BAD = [dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
        dict(up_burn=1.0, down_burn=1.0), dict(up_burn=0.5, down_burn=0.6)]


def test_config_validation():
    def run(pkg):
        out = []
        for kw in _BAD:
            with pytest.raises(ValueError) as ei:
                _auto(pkg).AutoscaleConfig(**kw)
            out.append(str(ei.value))
        return out

    out = both(run)
    assert out["port"] == out["reference"]


def test_config_from_env(monkeypatch):
    for k, v in (("MIN_REPLICAS", "2"), ("MAX_REPLICAS", "6"),
                 ("SCALE_UP_BURN", "2.5"), ("SCALE_DOWN_BURN", "0.25"),
                 ("SCALE_COOLDOWN_S", "7"), ("SCALE_IDLE_S", "11"),
                 ("SCALE_INTERVAL_S", "0.5")):
        monkeypatch.setenv("MXNET_SERVING_" + k, v)

    def run(pkg):
        c = _auto(pkg).AutoscaleConfig.from_env()
        return (c.min_replicas, c.max_replicas, c.up_burn, c.down_burn,
                c.cooldown_s, c.idle_retire_s, c.interval_s)

    out = both(run)
    assert out["port"] == out["reference"] == (2, 6, 2.5, 0.25, 7.0, 11.0,
                                               0.5)


def test_autoscale_enabled_env(monkeypatch):
    def run(pkg):
        out = []
        for v in ("", "0", "false", "off", "1", "yes"):
            monkeypatch.setenv("MXNET_SERVING_AUTOSCALE", v)
            out.append(_auto(pkg).autoscale_enabled())
        return out

    out = both(run)
    assert out["port"] == out["reference"] == [False] * 4 + [True] * 2


# ---------------------------------------------------------------------------
# the decision, on an injected clock
# ---------------------------------------------------------------------------


def test_burn_breach_scales_up_and_cooldown_holds():
    steps, ups, _, breach = drive(
        1, [(t, burns(5.0), 100) for t in (0.0, 1.0, 29.9, 31.0)],
        cooldown_s=30.0)
    assert steps == [("up", 2), (None, 2), (None, 2), ("up", 3)]
    assert ups == 2 and breach is not None and breach >= 0.0


def test_max_replicas_is_a_hard_ceiling():
    steps, ups, _, _ = drive(
        4, [(float(t), burns(99.0), 1000) for t in range(10)],
        max_replicas=4, cooldown_s=0.0)
    assert steps == [(None, 4)] * 10 and ups == 0


def test_single_window_or_empty_breach_is_a_blip():
    steps, _, _, _ = drive(1, [
        (0.0, {60: {"rate": 5.0, "total": 8},
               300: {"rate": 0.2, "total": 8}}, 10),
        (1.0, burns(5.0, total=0), 10)], cooldown_s=0.0)
    assert steps == [(None, 1), (None, 1)]


def test_idle_fleet_retires_after_idle_window():
    times = [0.0, 59.0, 61.0, 62.0, 121.9, 122.0] + \
        [float(t) for t in range(300, 310)]
    steps, _, downs, _ = drive(3, [(t, {}, 0) for t in times],
                               idle_retire_s=60.0, cooldown_s=5.0)
    assert steps[:6] == [(None, 3), (None, 3), ("down", 2), (None, 2),
                         (None, 2), ("down", 1)]
    assert steps[6:] == [(None, 1)] * 10 and downs == 2


def test_warm_burn_blocks_idle_retire():
    steps, _, _, _ = drive(
        2, [(float(t), burns(0.5), 0) for t in range(0, 100, 5)],
        idle_retire_s=10.0, cooldown_s=0.0, down_burn=0.1)
    assert steps == [(None, 2)] * 20


def test_min_floor_restored_inside_cooldown():
    steps, _, _, _ = drive(1, [(1.0, {}, 0)], last_action=0.0,
                           min_replicas=2, max_replicas=4,
                           cooldown_s=1000.0)
    assert steps == [("up", 2)]


def test_oscillating_burn_never_flaps():
    script = [(float(t), burns(0.55 + 0.35 * (1 if t % 2 else -1)),
               10 if t % 7 else 0) for t in range(600)]
    steps, ups, downs, _ = drive(2, script, up_burn=1.0, down_burn=0.1,
                                 idle_retire_s=30.0, cooldown_s=5.0)
    assert all(s == (None, 2) for s in steps) and ups == downs == 0


def test_closed_router_never_scales():
    def run(pkg):
        r = FakeRouter(1)
        r._closed = True
        sc = scaler(pkg, r)
        sc.burn_rates = lambda: burns(9.0)
        sc.fleet_load_tokens = lambda: 50
        return sc.step(now=0.0), len(r.replicas)

    out = both(run)
    assert out["port"] == out["reference"] == (None, 1)


def test_daemon_thread_start_stop():
    def run(pkg):
        r = FakeRouter(1)
        sc = scaler(pkg, r, cooldown_s=0.0)
        sc.cfg.interval_s = 0.01
        ticked = threading.Event()
        sc.burn_rates = lambda: (ticked.set(), {})[1]
        sc.fleet_load_tokens = lambda: 1
        sc.start()
        sc.start()                           # idempotent
        ok = ticked.wait(TIMEOUT)
        sc.stop()
        return ok, sc._thread is None

    out = both(run)
    assert out["port"] == out["reference"] == (True, True)


# ---------------------------------------------------------------------------
# the real router: capacity in, drained capacity out
# ---------------------------------------------------------------------------


def test_router_scale_up_down_zero_lost_requests(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        try:
            n0 = srv.replica_count()
            added = srv.scale_up() is not None
            n1 = srv.replica_count()
            results = {}

            def client(i):
                results[i] = srv.generate(arith_prompt(i, 1, 5 + i % 3),
                                          max_new_tokens=4, timeout=TIMEOUT)

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(6)]
            for t in threads:
                t.start()
                time.sleep(0.01)
            # retire the tail while the burst is in flight
            retired = srv.scale_down() is not None
            for t in threads:
                t.join(TIMEOUT)
            agg = srv.snapshot()["aggregate"]["requests"]
            return (n0, added, n1, retired, srv.replica_count(),
                    srv._c_scale_up.value, srv._c_scale_down.value,
                    results, agg.get("failed", 0),
                    agg["submitted"] == agg["completed"])
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    got = out["port"]
    assert got[:7] == (2, True, 3, True, 2, 1, 1)
    assert [len(got[7][i]) for i in range(6)] == [4] * 6
    assert got[8:] == (0, True)


def test_scale_down_refuses_last_replica(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=2, max_batch=1)
        try:
            a = srv.scale_down() is not None
            n = srv.replica_count()
            b = srv.scale_down()
            return a, n, b, srv.replica_count()
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"] == (True, 1, None, 1)


def test_autoscaler_drill_on_real_router(lm):
    """Scripted burn breach -> a real replica spawned; scripted
    idle + cold after the cooldown -> it is drained and retired; the
    fleet serves before, between and after, token-identically."""
    def run(pkg):
        a = _auto(pkg)
        srv = fleet(pkg, lm, replicas=2)
        sc = a.Autoscaler(srv, a.AutoscaleConfig(
            min_replicas=1, max_replicas=3, cooldown_s=0.05,
            idle_retire_s=0.2))
        try:
            outs = [srv.generate(arith_prompt(1, 1, 6), max_new_tokens=3,
                                 timeout=TIMEOUT)]
            sc.burn_rates = lambda: burns(10.0, total=8)
            sc.fleet_load_tokens = lambda: 1
            steps = [sc.step(now=100.0)]
            n_up = srv.replica_count()
            outs.append(srv.generate(arith_prompt(2, 1, 7),
                                     max_new_tokens=3, timeout=TIMEOUT))
            sc.burn_rates = lambda: {}
            sc.fleet_load_tokens = lambda: 0
            steps += [sc.step(now=100.06), sc.step(now=100.36)]
            n_down = srv.replica_count()
            outs.append(srv.generate(arith_prompt(3, 1, 5),
                                     max_new_tokens=2, timeout=TIMEOUT))
            return (steps, n_up, n_down, outs,
                    sc.last_breach_to_action_s)
        finally:
            sc.stop()
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][:3] == (["up", None, "down"], 3, 2)
    assert out["port"][4] == 0.0


def test_serve_autoscale_builds_replicated_door(lm, monkeypatch):
    monkeypatch.delenv("MXNET_SERVING_AUTOSCALE", raising=False)

    def run(pkg):
        out = []
        srv = fleet(pkg, lm, replicas=1, autoscale=True, max_batch=1)
        try:
            out += [type(srv).__name__, srv.autoscaler is not None,
                    srv.autoscaler._thread is not None]
        finally:
            srv.close(timeout=TIMEOUT)
        out.append(srv.autoscaler._thread is None)    # close() stopped it
        srv = fleet(pkg, lm, max_batch=1)
        try:
            out.append(type(srv).__name__)
        finally:
            srv.close(timeout=TIMEOUT)
        monkeypatch.setenv("MXNET_SERVING_AUTOSCALE", "1")
        monkeypatch.setenv("MXNET_SERVING_MAX_REPLICAS", "2")
        srv = fleet(pkg, lm, max_batch=1)
        try:
            out += [type(srv).__name__, srv.autoscaler.cfg.max_replicas]
        finally:
            srv.close(timeout=TIMEOUT)
        monkeypatch.delenv("MXNET_SERVING_AUTOSCALE")
        monkeypatch.delenv("MXNET_SERVING_MAX_REPLICAS")
        return out

    out = both(run)
    assert out["port"] == out["reference"] == [
        "ReplicatedLMServer", True, True, True, "LMServer",
        "ReplicatedLMServer", 2]


def test_burn_rates_read_the_merged_fleet_slo(lm, monkeypatch):
    """`burn_rates()` over a real fleet: the default tenant's TTFT burn
    merged from the replicas' summed window deltas. A 1 us TTFT objective
    makes every request slow, so both packages see the same totals and
    the same (maximal) burn; a burn is a window delta, so the first read
    is the baseline."""
    monkeypatch.setenv("MXNET_SLO_TTFT_MS", "0.001")

    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        try:
            sc = _auto(pkg).Autoscaler(srv, _auto(pkg).AutoscaleConfig())
            before = sc.burn_rates()     # a burn is a delta: the baseline
            for i in range(4):
                srv.generate(arith_prompt(i, 1, 5), max_new_tokens=2,
                             timeout=TIMEOUT)
            b = sc.burn_rates()
            return ({w: (v["total"], v["good"], round(v["rate"], 9))
                     for w, v in b.items()}, sc._hot(before),
                    sc._hot(b), sc.fleet_load_tokens())
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    rates, cold, hot, load = out["port"]
    assert rates and all(t == 4 and g == 0 for t, g, _ in rates.values())
    assert cold is False and hot is True and load == 0


def test_warm_replica_gauge_reads_zero_and_aot_cache_raises(lm, tmp_path):
    """The door accepts `aot_cache=` (the process-wide cache, put back
    under env control after), and `serving_warm_replicas` follows the
    replicas' `engine.warm_loads` at each sweep: 0 while every replica
    built cold, then the replicas whose count is positive."""
    from mxnet_tpu_torch import aot
    cache = str(tmp_path / "aot")
    try:
        srv = fleet("port", lm, replicas=2, max_batch=1, aot_cache=cache)
        try:
            assert aot.cache_dir() == cache
            assert all(r.engine.aot_cache == cache for r in srv.replicas)
            assert len(srv.generate(arith_prompt(1, 1, 6), max_new_tokens=2,
                                    timeout=TIMEOUT)) == 2
            srv.health()
            assert srv._g_warm.value == 0
            srv.replicas[1].engine._warm_counts["prefill"] = 3
            srv.health()
            assert srv._g_warm.value == 1
            assert srv.scale_up() is not None
            srv.replicas[-1].engine._warm_counts["decode"] = 1
            srv.health()
            assert srv._g_warm.value == 2
        finally:
            srv.close(timeout=TIMEOUT)
    finally:
        aot.configure()