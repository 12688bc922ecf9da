"""Port parity for disaggregated prefill/decode serving (the router's roles
and migration, server.py's `_migrate_out` / `spawn_migrate`) against the
JAX reference, on the CPU's tiny LM.

Mirrors tests/test_serving_disagg.py's fourteen tests (:100-:494): the
role parser, the migrate-flavoured resume, a role-less fleet unchanged,
the hop's token identity and single trace row, exactly-once ledgers, the
bytes-saved ledger of the target's prefix hits, COW-divergent prefixes,
the tp!=tp hop onto a tensor-parallel decode role, a hop racing the
target's drain, role loss and a saturated target falling back to local
decode, the role surfaces, the per-role autoscale decision and a respawn
keeping its role. Greedy tokens identical; counters equal. Every
`result()` and `close()` carries a timeout.
"""
import re
import threading

import pytest

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.serving import autoscale as jautoscale
from mxnet_tpu.serving import router as jrouter
from mxnet_tpu.serving import scheduler as jsched
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import autoscale as tautoscale
from mxnet_tpu_torch.serving import router as trouter
from mxnet_tpu_torch.serving import scheduler as tsched

from test_torch_serving import lm  # noqa: F401 (fixture)
from test_torch_router import (TIMEOUT, arith_prompt, both, fleet, wait,
                               _token_identity)


def _pkg(pkg):
    if pkg == "port":
        return serving, trouter, tsched, tautoscale, MXNetError, telemetry
    return jserving, jrouter, jsched, jautoscale, jmx.MXNetError, jtel


@pytest.fixture(autouse=True)
def _clean():
    for t in (telemetry, jtel):
        t.tracing.clear()
    yield


def disagg(pkg, lm, roles="prefill:1,decode:1", **kw):
    kw.setdefault("max_batch", 4)
    return fleet(pkg, lm, roles=roles, **kw)


def oracle(lm, prompt, max_new, **kw):
    """The undisturbed single-server rollout of both packages (equal)."""
    def run(pkg):
        srv = fleet(pkg, lm, **kw)
        try:
            return srv.generate(list(prompt), max_new_tokens=max_new,
                                timeout=TIMEOUT)
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    return out["port"]


def count_finishes(req):
    calls = {"n": 0}
    real = req._finish

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    req._finish = counting
    return calls


# ---------------------------------------------------------------------------
# unit layer: role spec parsing + migrate-flavoured resume construction
# ---------------------------------------------------------------------------

_SPECS = ["prefill:1,decode:2", " decode:3 , prefill:1 ",
          "prefill:0,decode:2", {"prefill": 2}, "", None, "prefil:1",
          "prefill:two", "prefill:0,decode:0", "prefill", "decode:-1"]


def test_serving_roles_parser(monkeypatch):
    def run(pkg):
        _, router, *_ = _pkg(pkg)
        out = []
        monkeypatch.delenv("MXNET_SERVING_ROLES", raising=False)
        for spec in _SPECS:
            try:
                out.append(router.serving_roles(spec))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
        monkeypatch.setenv("MXNET_SERVING_ROLES", "prefill:1,decode:1")
        out.append(router.serving_roles())
        monkeypatch.delenv("MXNET_SERVING_ROLES")
        return out

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][0] == {"prefill": 1, "decode": 2}
    assert out["port"][2] == {"decode": 2}
    assert out["port"][4] is None and out["port"][5] is None
    assert "unknown serving role" in out["port"][6][1]


def test_make_resume_migrate_spends_no_failover_budget():
    def run(pkg):
        sched = _pkg(pkg)[2]
        orig = sched.Request([1, 2, 3], max_new_tokens=8, eos_id=7,
                             deadline_ms=5000.0, tenant="acme", priority=2)
        resume, carried = sched.make_resume(orig, [1, 2, 3, 4, 5],
                                            max_len=64, migrate=True)
        resume2, _ = sched.make_resume(resume, [1, 2, 3, 4, 5, 6],
                                       max_len=64)
        return (carried, resume.prompt, resume.max_new_tokens,
                resume.failovers, resume.migrated, orig.migrated,
                resume.tenant, resume.priority,
                resume.t_deadline == orig.t_deadline,
                resume.trace == orig.trace, resume2.failovers,
                resume2.migrated)

    out = both(run)
    assert out["port"] == out["reference"] == (
        2, [1, 2, 3, 4, 5], 6, 0, True, False, "acme", 2, True, True, 1,
        True)


# ---------------------------------------------------------------------------
# roles off: the role-less fleet is unchanged
# ---------------------------------------------------------------------------


def test_roles_off_fleet_unchanged(lm, monkeypatch):
    monkeypatch.delenv("MXNET_SERVING_ROLES", raising=False)

    def run(pkg):
        srv = fleet(pkg, lm, replicas=2)
        try:
            out = srv.generate(arith_prompt(3, 2, 6), max_new_tokens=4,
                               timeout=TIMEOUT)
            stz = srv.statusz()
            return (srv._roles, srv._role, out,
                    any("role" in h for h in srv.health()["replicas"]),
                    sorted(stz["fleet"]),
                    any("role" in b for b in stz["replicas"]),
                    "serving_role_" in srv.prometheus_text(),
                    [(r.role, r.on_prefill_done, r.metrics.migrations)
                     for r in srv.replicas])
        finally:
            srv.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    roles, role, toks, hrole, keys, brole, prom, reps = out["port"]
    assert roles is None and role == [None, None] and len(toks) == 4
    assert not hrole and not brole and not prom
    assert "roles" not in keys and "migrations" not in keys
    assert reps == [(None, None, 0)] * 2


# ---------------------------------------------------------------------------
# the migration hop: token identity, exactly-once, one trace row
# ---------------------------------------------------------------------------


def test_migration_token_identity_and_single_trace(lm, tmp_path):
    prompt, max_new = arith_prompt(3, 2, 12), 8
    want = oracle(lm, prompt, max_new)

    def run(pkg):
        tel = _pkg(pkg)[5]
        f = disagg(pkg, lm)
        try:
            req = f.submit(prompt, max_new_tokens=max_new)
            calls = count_finishes(req)
            got = req.result(timeout=TIMEOUT)
            pre, dec = f.replicas
            names = [s["name"] for s in tel.spans(trace=req.trace)]
            doc = tel.export_perfetto(str(tmp_path / (pkg + ".json")))
            evs = [e for e in doc["traceEvents"] if e["ph"] == "X"
                   and e["args"].get("trace") == req.trace]
            return (got, calls["n"], pre.role, dec.role,
                    pre.metrics.submitted, dec.metrics.submitted,
                    dec.metrics.completed, dec.metrics.migrations,
                    dec.metrics.migration_tokens, pre.metrics.failovers,
                    dec.metrics.failovers,
                    {"serving.migration_hop", "serving.prefill",
                     "serving.decode"} <= set(names),
                    len({e["tid"] for e in evs}))
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    got = out["port"]
    assert got[0] == want, "migrated rollout diverged from the oracle"
    assert got[1:8] == (1, "prefill", "decode", 1, 0, 1, 1)
    assert got[8] >= 1 and got[9:] == (0, 0, True, 1)


def test_migration_ledger_classified_exactly_once(lm):
    def run(pkg):
        f = disagg(pkg, lm)
        try:
            outs = [f.generate(arith_prompt(1 + i, 2, 8), max_new_tokens=4,
                               timeout=TIMEOUT) for i in range(3)]
            stz = f.statusz()
            _token_identity(stz["fleet"]["tokens"])
            agg = f.snapshot()["aggregate"]["requests"]
            return (outs, agg["submitted"], agg["completed"],
                    agg["migrations"], stz["fleet"]["migrations"],
                    stz["fleet"]["tokens"])
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][1:5] == (3, 3, 3, 3)


def test_migration_bytes_saved_by_target_cache_hits(lm):
    prompt = arith_prompt(5, 1, 24)

    def run(pkg):
        f = disagg(pkg, lm, paged=True, prefix_cache=True, prefill_chunk=8)
        try:
            a = f.generate(list(prompt), max_new_tokens=6, timeout=TIMEOUT)
            b = f.generate(list(prompt), max_new_tokens=6, timeout=TIMEOUT)
            stz = f.statusz()["fleet"]
            dec = f.replicas[1]
            per_tok = dec.engine.kv_bytes_per_token()
            return (a, b, stz["migrations"], stz["migration_bytes_saved"],
                    per_tok, dec.engine.cache.block_size,
                    dec.metrics.migration_bytes_saved)
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    a, b, migrations, saved, per_tok, bs, dec_saved = out["port"]
    assert a == b and migrations == 2 and per_tok > 0
    assert saved >= 2 * bs * per_tok and saved % per_tok == 0
    assert dec_saved == saved


def test_cow_divergent_prefix_migration(lm):
    base = arith_prompt(5, 1, 20)
    fork_a = base + [7, 9, 11, 13]
    fork_b = base + [8, 10, 12, 14]      # diverges mid-block
    want_a = oracle(lm, fork_a, 6, paged=True)
    want_b = oracle(lm, fork_b, 6, paged=True)

    def run(pkg):
        f = disagg(pkg, lm, paged=True, prefix_cache=True, prefill_chunk=8)
        try:
            return (f.generate(list(fork_a), max_new_tokens=6,
                               timeout=TIMEOUT),
                    f.generate(list(fork_b), max_new_tokens=6,
                               timeout=TIMEOUT),
                    f.statusz()["fleet"]["migrations"])
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"] == (want_a, want_b, 2)


def test_tp_decode_role_raises_naming_item_12(lm):
    """The reference's tp=1 -> tp=2 hop (:288): a tp=2 decode role (the
    port's window `["cpu"] * 2`, the reference's virtual devices) takes
    the migrated prompt and re-prefills it on its tp engine; tokens equal
    across the packages and to one server's. A fleet of tp=2 replicas
    serves the same tokens too."""
    prompt, max_new = arith_prompt(3, 2, 10), 6
    want = oracle(lm, prompt, max_new)

    def run(pkg):
        win = {"devices": ["cpu"] * 2} if pkg == "port" else {}
        f = disagg(pkg, lm, paged=True,
                   role_kwargs={"decode": dict(tp=2, **win)})
        try:
            tps = [r.engine.tp for r in f.replicas]
            got = f.generate(list(prompt), max_new_tokens=max_new,
                             timeout=TIMEOUT)
            hops = f.replicas[1].metrics.migrations
        finally:
            f.close(timeout=TIMEOUT)
        f = fleet(pkg, lm, replicas=2, tp=2, **win)
        try:
            tps += [r.engine.tp for r in f.replicas]
            return tps, got, hops, f.generate(
                list(prompt), max_new_tokens=max_new, timeout=TIMEOUT)
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"] == ([1, 2, 2, 2], want, 1, want)


def test_migration_racing_target_drain(lm):
    """The hop lands, then the decode replica wedges mid-decode: the
    request fails over BACK onto the prefill replica and still finishes
    token-identically, exactly once."""
    prompt, max_new = arith_prompt(3, 2, 6), 6
    want = oracle(lm, prompt, max_new)

    def run(pkg):
        f = disagg(pkg, lm, max_batch=2)
        hold = None
        try:
            dec = f.replicas[1]
            real = dec.engine.decode_step
            parked, hold = threading.Event(), threading.Event()
            state = {"n": 0}

            def parking(seqs):
                out = real(seqs)
                state["n"] += 1
                if state["n"] == 2:
                    parked.set()
                    hold.wait(TIMEOUT)
                return out

            dec.engine.decode_step = parking
            req = f.submit(prompt, max_new_tokens=max_new)
            calls = count_finishes(req)
            assert parked.wait(TIMEOUT)
            dec._last_beat -= 999.0
            h = f.health()
            drained = (f._drained[1], h["ok"])
            got = req.result(timeout=TIMEOUT)
            counts = (calls["n"], dec.metrics.migrations,
                      f.replicas[0].metrics.failovers)
            hold.set()
            wait(lambda: dec.engine.cache.pool.in_use == 0)
            return got, drained, counts, calls["n"]
        finally:
            if hold is not None:
                hold.set()
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"] == (want, (True, True), (1, 1, 1), 1)


# ---------------------------------------------------------------------------
# graceful degradation: role loss -> co-scheduled serving
# ---------------------------------------------------------------------------


def test_role_loss_falls_back_to_co_scheduled(lm):
    prompt, max_new = arith_prompt(3, 2, 8), 5
    want = oracle(lm, prompt, max_new)

    def run(pkg):
        f = disagg(pkg, lm)
        try:
            retired = f.scale_down() is not None
            roles = [r.role for r in f.replicas]
            got = f.generate(list(prompt), max_new_tokens=max_new,
                             timeout=TIMEOUT)
            stz = f.statusz()["fleet"]
            return (retired, roles, got, f.replicas[0].metrics.migrations,
                    stz["migrations"], "decode" in stz["roles"])
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"] == \
        (True, ["prefill"], want, 0, 0, False)


def test_saturated_decode_target_reattaches_locally(lm):
    prompt, max_new = arith_prompt(3, 2, 8), 5
    want = oracle(lm, prompt, max_new)

    def run(pkg):
        f = disagg(pkg, lm)
        try:
            dec = f.replicas[1]
            full = _pkg(pkg)[0].QueueFull

            def refuse(req):
                raise full("scripted saturation")

            dec.adopt = refuse
            req = f.submit(prompt, max_new_tokens=max_new)
            calls = count_finishes(req)
            got = req.result(timeout=TIMEOUT)
            _token_identity(f.statusz()["fleet"]["tokens"])
            return (got, calls["n"], dec.metrics.migrations,
                    f.replicas[0].metrics.completed)
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"] == (want, 1, 0, 1)


# ---------------------------------------------------------------------------
# observability + per-role autoscaling
# ---------------------------------------------------------------------------


def test_role_observability_surfaces(lm):
    from tools import fleet_top

    def run(pkg):
        f = disagg(pkg, lm, roles="prefill:1,decode:2")
        try:
            f.generate(arith_prompt(2, 3, 6), max_new_tokens=3,
                       timeout=TIMEOUT)
            stz = f.statusz()
            text = f.prometheus_text()
            gauges = []
            for rn in ("prefill", "decode"):
                m = re.search(r'serving_role_%s_replicas\{[^}]*'
                              r'replica="router"[^}]*\} (\d+)' % rn, text)
                gauges.append(int(m.group(1)) if m else None)
            frame = fleet_top.render(f.health(), stz, f.snapshot())
            return (stz["fleet"]["roles"],
                    [b.get("role") for b in stz["replicas"]],
                    [h["role"] for h in f.health()["replicas"]], gauges,
                    "serving_migration_total" in text,
                    "serving_migration_bytes_saved_total" in text,
                    "role" in frame and "prefill" in frame
                    and "migrations" in frame)
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"]
    assert out["port"][0] == {"prefill": {"replicas": 1, "healthy": 1},
                              "decode": {"replicas": 2, "healthy": 2}}
    assert out["port"][1] == out["port"][2] == \
        ["prefill", "decode", "decode"]
    assert out["port"][3:] == ([1, 2], True, True, True)


class _FakeRoleRouter:
    def __init__(self, roles=None):
        self._closed = False
        self._roles = roles
        self.replicas = ["p", "d"]
        self.up_roles = []

    def scale_up(self, role=None):
        self.up_roles.append(role)
        self.replicas.append(role or "x")
        return self.replicas[-1]

    def scale_down(self):
        return None


def _burns(rate, total=10, windows=(60, 300)):
    return {w: {"rate": rate, "good": max(0, total - 1),
                "total": total, "span_s": float(w)} for w in windows}


def test_autoscaler_scales_the_burning_role():
    def run(pkg):
        auto = _pkg(pkg)[3]
        r = _FakeRoleRouter(roles={"prefill": 1, "decode": 1})
        sc = auto.Autoscaler(r, config=auto.AutoscaleConfig(
            min_replicas=1, max_replicas=8, cooldown_s=0.0))
        sc.fleet_load_tokens = lambda: 100
        steps = []
        sc.burn_rates = lambda objective="ttft": (
            _burns(5.0) if objective == "ttft" else {})
        steps.append(sc.step(now=0.0))
        sc.burn_rates = lambda objective="ttft": _burns(5.0)
        steps.append(sc.step(now=1.0))
        sc.burn_rates = lambda: _burns(5.0)   # a scripted no-arg stub
        steps.append(sc.step(now=2.0))
        r2 = _FakeRoleRouter(roles=None)
        sc2 = auto.Autoscaler(r2, config=auto.AutoscaleConfig(
            min_replicas=1, max_replicas=8, cooldown_s=0.0))
        sc2.fleet_load_tokens = lambda: 100
        sc2.burn_rates = lambda: _burns(5.0)
        steps.append(sc2.step(now=0.0))
        return steps, r.up_roles, r2.up_roles

    out = both(run)
    assert out["port"] == out["reference"] == (
        ["up"] * 4, ["prefill", "decode", "prefill"], [None])


def test_respawned_replica_keeps_its_role(lm):
    def run(pkg):
        f = disagg(pkg, lm, respawn_backoff=0.02)
        try:
            dec = f.replicas[1]
            dec._died = True             # a crash, as the sweep sees it
            wait(lambda: f.replicas[1] is not dec, poll=f.health)
            fresh = f.replicas[1]
            out = f.generate(arith_prompt(4, 3, 8), max_new_tokens=4,
                             timeout=TIMEOUT)
            return (fresh.role, fresh.on_prefill_done is None, len(out),
                    fresh.metrics.migrations)
        finally:
            f.close(timeout=TIMEOUT)

    out = both(run)
    assert out["port"] == out["reference"] == ("decode", True, 4, 1)
