"""Port parity for the serving loop's chaos seams (mxnet_tpu_torch/
utils/chaos.py and the hooks in mxnet_tpu_torch/serving/server.py)
against the JAX reference, on the CPU's tiny LM.

A killed loop (/healthz 503, one flight dump that tools/postmortem.py
renders), a wedged loop (detected once, dumped once, then serving
again), decode poison against the failover budget, spec poison falling
back token-identically, and pool exhaustion queueing requests and
handing its held blocks back: each outcome held to the reference's.
"""
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest

from mxnet_tpu import serving as jserving
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.utils import chaos as jchaos
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.utils import chaos

from test_torch_serving import lm, PROMPTS  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("port", "reference")


@pytest.fixture(autouse=True)
def _chaos_reset(monkeypatch):
    for k in list(os.environ):
        if k.startswith("MXNET_CHAOS_"):
            monkeypatch.delenv(k)
    for c in (chaos, jchaos):
        c.reset()
    for t in (telemetry, jtel):
        t.flight().clear()
    yield
    for c in (chaos, jchaos):
        c.reset()


def _chaos(pkg):
    return chaos if pkg == "port" else jchaos


def _server(pkg, lm, **kw):
    jparams, jcfg, params, cfg = lm
    kw.setdefault("max_batch", 2)
    kw.setdefault("block_size", 8)
    kw.setdefault("paged", True)
    if pkg == "port":
        return serving.LMServer((params, cfg), device="cpu", **kw)
    return jserving.LMServer((jparams, jcfg), **kw)


def _wait(cond, timeout=30.0):
    t0 = time.perf_counter()
    while not cond():
        assert time.perf_counter() - t0 < timeout, "condition not met"
        time.sleep(0.01)


def _dumps(path):
    return sorted(n for n in os.listdir(path) if n.startswith("flight-"))


@pytest.fixture(scope="module")
def oracle(lm):
    """Undisturbed greedy tokens of every prompt, from the port's server."""
    srv = _server("port", lm)
    try:
        return [srv.generate(p, max_new_tokens=8, timeout=120)
                for p in PROMPTS]
    finally:
        srv.close()


def test_chaos_env_parsing_matches_reference(monkeypatch):
    monkeypatch.setenv("MXNET_CHAOS_SERVE_KILL", "1:5")
    monkeypatch.setenv("MXNET_CHAOS_SERVE_WEDGE", "0:2:0.5")
    monkeypatch.setenv("MXNET_CHAOS_SERVE_EXHAUST", "3:4:7")
    assert chaos.active() == {k: v for k, v in jchaos.active().items()
                              if k.startswith("serve_")}
    assert chaos.active()["serve_wedge"] == (0, 2, 0.5)
    chaos.reset()
    monkeypatch.setenv("MXNET_CHAOS_SERVE_POISON", "nope")
    with pytest.raises(ValueError, match="MXNET_CHAOS_SERVE_POISON"):
        chaos.active()
    chaos.reset()
    monkeypatch.delenv("MXNET_CHAOS_SERVE_POISON")
    with pytest.raises(ValueError, match="rollout"):
        chaos.configure(serve_rollout_corrupt=(3, 0))   # a rollout fault
    assert chaos.configure(serve_poison=(0, 1)) == {
        "serve_kill": (1, 5), "serve_wedge": (0, 2, 0.5),
        "serve_exhaust": (3, 4, 7.0), "serve_poison": (0, 1)}
    assert chaos.configure(serve_poison=None).get("serve_poison") is None


def _killed(pkg, lm, tmp_path, monkeypatch):
    d = tmp_path / pkg
    d.mkdir()
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR", str(d))
    _chaos(pkg).configure(serve_kill=(0, 2))
    srv = _server(pkg, lm)
    try:
        _wait(lambda: not srv._thread.is_alive())
        host, port = srv.serve_http(port=0, block=False)
        try:
            urllib.request.urlopen("http://%s:%d/healthz" % (host, port),
                                   timeout=30)
            code = 200
        except urllib.error.HTTPError as e:
            code, body = e.code, json.loads(e.read())
        with pytest.raises(Exception, match="closed"):
            srv.submit(PROMPTS[0], max_new_tokens=2)
        srv.health()                      # a second look dumps nothing
        files = _dumps(d)
    finally:
        srv.close()
    return {"healthz": code, "loop_alive": body["loop_alive"],
            "fired": sorted(_chaos(pkg).fired()),
            "dumps": [f.rsplit(".", 2)[-2] for f in files]}, d / files[0]


def test_killed_loop_matches_reference(lm, tmp_path, monkeypatch):
    got = {pkg: _killed(pkg, lm, tmp_path, monkeypatch) for pkg in PKGS}
    assert got["port"][0] == got["reference"][0]
    assert got["port"][0] == {"healthz": 503, "loop_alive": False,
                              "fired": ["serve_kill"],
                              "dumps": ["serving_loop_died"]}
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "tools", "postmortem.py"),
                        str(got["port"][1])],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    for needle in ("chaos.serve_kill", "serving.loop_died", "FAULT",
                   "serving_loop_died"):
        assert needle in r.stdout, needle


def _wedged(pkg, lm, tmp_path, monkeypatch):
    d = tmp_path / pkg
    d.mkdir()
    monkeypatch.setenv("MXNET_FLIGHT_RECORDER_DIR", str(d))
    _chaos(pkg).configure(serve_wedge=(0, 3, 0.6))
    srv = _server(pkg, lm)
    try:
        _wait(lambda: "serve_wedge" in _chaos(pkg).fired())
        _wait(lambda: not srv.health(max_beat_age=0.2)["ok"])
        h = srv.health(max_beat_age=0.2)     # still wedged: no new dump
        dumps_while = len(_dumps(d))
        _wait(lambda: srv.health(max_beat_age=0.2)["ok"], timeout=60)
        out = srv.generate(PROMPTS[1], max_new_tokens=8, timeout=120)
    finally:
        srv.close()
    return {"loop_alive": h["loop_alive"], "dumps_while": dumps_while,
            "dumps": [f.rsplit(".", 2)[-2] for f in _dumps(d)],
            "tokens": out}


def test_wedged_loop_detected_once(lm, tmp_path, monkeypatch, oracle):
    got = {pkg: _wedged(pkg, lm, tmp_path, monkeypatch) for pkg in PKGS}
    assert got["port"] == got["reference"]
    assert got["port"]["loop_alive"] and got["port"]["dumps_while"] == 1
    assert got["port"]["dumps"] == ["healthz_wedge"]
    assert got["port"]["tokens"] == oracle[1]


def _poisoned(pkg, lm, budget):
    _chaos(pkg).configure(serve_poison=(0, 1))
    srv = _server(pkg, lm)
    srv.max_failovers = budget
    try:
        try:
            out = srv.generate(PROMPTS[2], max_new_tokens=8, timeout=120)
        except Exception as e:
            out = type(e).__name__ + (": poisoned" if "poisoned" in str(e)
                                      else "")
        snap = srv.snapshot()
        in_use = srv.engine.cache.pool.in_use
    finally:
        srv.close()
    return {"out": out, "in_use": in_use,
            "requests": {k: snap["requests"][k] for k in (
                "completed", "failed", "engine_failures", "failovers")},
            "tokens": {k: v for k, v in snap["tokens"].items()
                       if k != "generated"}}


@pytest.mark.parametrize("budget", [2, 0])
def test_decode_poison_against_the_failover_budget(lm, oracle, budget):
    """A poisoned decode step re-queues the batch as a failover replay
    that finishes token-identically; with no budget left the error
    surfaces. Either way the loop lives on and no block leaks."""
    got = {pkg: _poisoned(pkg, lm, budget) for pkg in PKGS}
    assert got["port"] == got["reference"]
    if budget:
        assert got["port"]["out"] == oracle[2]
        assert got["port"]["requests"]["failovers"] == 1
        assert got["port"]["tokens"]["replayed"] >= 1
    else:
        assert got["port"]["out"] == "MXNetError: poisoned"
        assert got["port"]["requests"]["failed"] == 1
    assert got["port"]["requests"]["engine_failures"] == 1
    assert got["port"]["in_use"] == 0


def test_spec_poison_falls_back_token_identical(lm, oracle):
    jparams, jcfg, params, cfg = lm
    got = {}
    for pkg in PKGS:
        _chaos(pkg).configure(serve_spec_poison=(3, 1))
        draft = (serving.self_draft(params, cfg, 1) if pkg == "port"
                 else jserving.self_draft(jparams, jcfg, 1))
        srv = _server(pkg, lm, draft=draft, spec_k=3, replica_id=3)
        try:
            assert srv.engine.spec
            out = srv.generate(PROMPTS[0], max_new_tokens=8, timeout=120)
            snap = srv.snapshot()
        finally:
            srv.close()
        got[pkg] = (out, sorted(_chaos(pkg).fired()),
                    snap["spec"]["fallbacks"] >= 1,
                    snap["spec"]["passes"] >= 1,
                    snap["requests"]["failed"])
    assert got["port"] == got["reference"]
    assert got["port"] == (oracle[0], ["serve_spec_poison"], True, True, 0)


def test_pool_exhaustion_queues_then_releases(lm, oracle):
    got = {}
    for pkg in PKGS:
        _chaos(pkg).configure(serve_exhaust=(0, 1, 6))
        srv = _server(pkg, lm)
        try:
            _wait(lambda: srv._chaos_stolen is not None or
                  "serve_exhaust" in _chaos(pkg).fired())
            held = srv.engine.cache.pool.available
            out = srv.generate(PROMPTS[0], max_new_tokens=8, timeout=120)
            snap = srv.snapshot()
            stolen = srv._chaos_stolen
            in_use = srv.engine.cache.pool.in_use
        finally:
            srv.close()
        got[pkg] = (out, held, stolen, in_use, snap["requests"]["failed"])
    assert got["port"] == got["reference"]
    assert got["port"] == (oracle[0], 0, None, 0, 0)


def test_chaos_closing_server_returns_held_blocks(lm):
    """A server closed while its pool is held hostage hands the blocks
    back before the leak audit (close() would raise on a leak)."""
    chaos.configure(serve_exhaust=(0, 1, 10 ** 6))
    srv = _server("port", lm)
    _wait(lambda: srv._chaos_stolen is not None)
    assert srv.engine.cache.pool.available == 0
    srv.close()
    assert srv._chaos_stolen is None
    with pytest.raises(MXNetError, match="closed"):
        srv.submit(PROMPTS[0])
