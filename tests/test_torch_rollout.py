"""Port parity for the live weight rollout (mxnet_tpu_torch/serving/
rollout.py and the router's version machinery) against the JAX
reference, on the CPU's tiny LM.

Mirrors tests/test_rollout.py's nineteen tests: the same scenario runs
through both packages' fleets, each on checkpoints its own
CheckpointManager wrote, and the port is held to the reference's
transitions, versions, probe names, rosters, placement orders and greedy
tokens (identical). The reference's slow end-to-end drill becomes a light
one on fake clocks (`test_live_rollout_promotes_under_traffic_zero_loss`).
Across the packages: `params_digest` agrees on the same f32 and bf16
trees, a rejection either package writes is honoured by the other, and a
step the reference published is gated and promoted by the port. Every
`result()` and `close()` carries a timeout.
"""
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.serving import rollout as jrollout
from mxnet_tpu.utils import chaos as jchaos
from mxnet_tpu.utils.recovery import CheckpointManager as JManager
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import params_from_numpy
from mxnet_tpu_torch.serving import rollout as trollout
from mxnet_tpu_torch.utils import chaos
from mxnet_tpu_torch.utils.recovery import CheckpointManager

from test_torch_serving import lm  # noqa: F401 (fixture)
from test_torch_router import TIMEOUT, arith_prompt, both

PKGS = ("port", "reference")


@pytest.fixture(autouse=True)
def _chaos_reset():
    yield
    chaos.reset()
    jchaos.reset()


def api(pkg):
    """(serving, rollout module, CheckpointManager, chaos, MXNetError)."""
    if pkg == "port":
        return serving, trollout, CheckpointManager, chaos, MXNetError
    return jserving, jrollout, JManager, jchaos, jmx.MXNetError


def host(lm):
    """The tiny LM's weights as numpy (both packages' common source)."""
    return {k: np.asarray(v) for k, v in lm[0].items()}


def perturbed(lm, eps=0.05):
    return {k: v + eps for k, v in host(lm).items()}


def publish(pkg, directory, step, tree):
    """One verified single-file checkpoint publish by `pkg`'s manager."""
    api(pkg)[2](str(directory), async_save=False).save(step, dict(tree))


def model(pkg, lm, tree=None):
    """(params, cfg) of `pkg` over `tree` (default: the boot weights)."""
    jparams, jcfg, params, cfg = lm
    if pkg == "port":
        return (params if tree is None
                else params_from_numpy(tree, cfg, "cpu"), cfg)
    return (jparams if tree is None
            else {k: jnp.asarray(v) for k, v in tree.items()}, jcfg)


def fleet(pkg, lm, replicas=2, tree=None):
    kw = dict(device="cpu") if pkg == "port" else {}
    return api(pkg)[0].serve(model(pkg, lm, tree), replicas=replicas,
                             max_batch=2, block_size=8, **kw)


def attach(srv, directory, **kw):
    kw.setdefault("stages", (0.5,))
    kw.setdefault("window_s", 0.0)
    return srv.attach_rollout(str(directory), **kw)


def scenario(lm, tmp_path, body, replicas=2):
    """`body(pkg, srv, directory)` on a fleet of each package, each over
    its own checkpoint directory; returns {pkg: result}."""
    def run(pkg):
        srv = fleet(pkg, lm, replicas)
        try:
            return body(pkg, srv, tmp_path / pkg)
        finally:
            srv.close(timeout=TIMEOUT)
    return both(run)


def same(out):
    assert out["port"] == out["reference"], out
    return out["port"]


# ---------------------------------------------------------------------------
# pure pieces: pinned prompts, digests, knobs, roster
# ---------------------------------------------------------------------------


def test_pinned_prompts_pure_and_bounded():
    for args in ((48, 6, 64), (8, 4, 10), (8192, 4, 1024)):
        assert trollout.pinned_prompts(*args) == \
            jrollout.pinned_prompts(*args)
    a = trollout.pinned_prompts(48, 6, 64)
    assert a == trollout.pinned_prompts(48, 6, 64) and len(a) == 6
    for p in a:
        assert 2 <= len(p) <= 64 - 8 and all(1 <= t < 48 for t in p)
    for p in trollout.pinned_prompts(8, 4, 10):
        assert len(p) == 2 and all(1 <= t < 8 for t in p)


def test_params_digest_order_independent_and_sensitive(lm):
    tree = host(lm)
    names = sorted(tree)
    shuffled = {k: tree[k] for k in reversed(names)}
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    assert trollout.params_digest(tree) == trollout.params_digest(
        shuffled) == trollout.params_digest(port)
    bumped = dict(tree)
    bumped[names[0]] = tree[names[0]] + 1e-3
    assert trollout.params_digest(bumped) != trollout.params_digest(tree)


def test_params_digest_equals_the_reference_on_f32_and_bf16(lm):
    tree = host(lm)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ref = jrollout.params_digest(
            {k: jnp.asarray(v).astype(jdt) for k, v in tree.items()})
        port = trollout.params_digest(
            {k: torch.from_numpy(v).to(tdt) for k, v in tree.items()})
        assert port == ref, jdt
    assert trollout.params_digest(tree) == jrollout.params_digest(tree)


def test_rollout_knob_parsing_and_validation(monkeypatch):
    def run(pkg):
        ro = api(pkg)[1]
        out = []
        monkeypatch.delenv("MXNET_SERVING_ROLLOUT_DIR", raising=False)
        out.append(ro.rollout_dir())
        monkeypatch.setenv("MXNET_SERVING_ROLLOUT_DIR", "/ckpts")
        out.append(ro.rollout_dir())
        monkeypatch.delenv("MXNET_ROLLOUT_STAGES", raising=False)
        monkeypatch.delenv("MXNET_ROLLOUT_WINDOW_S", raising=False)
        out += [ro.rollout_stages(), ro.rollout_stages("1/8, 1/2, 1"),
                ro.rollout_stages((0.25, 0.75))]
        monkeypatch.setenv("MXNET_ROLLOUT_STAGES", "1/16,1/4")
        out.append(ro.rollout_stages())
        monkeypatch.delenv("MXNET_ROLLOUT_STAGES")
        out += [ro.rollout_window_s(), ro.rollout_window_s("2.5"),
                ro.rollout_window_s(0), ro.rollout_parity_prompts("7")]
        for fn, bad in ((ro.rollout_stages, "banana"),
                        (ro.rollout_stages, "0.5,0.25"),
                        (ro.rollout_stages, "0"), (ro.rollout_stages, "2"),
                        (ro.rollout_stages, "1/0"),
                        (ro.rollout_window_s, "-1"),
                        (ro.rollout_window_s, "soon"),
                        (ro.rollout_parity_prompts, "0"),
                        (ro.rollout_parity_prompts, "many")):
            with pytest.raises(api(pkg)[4]) as ei:
                fn(bad)
            out.append(str(ei.value))
        return out

    out = same(both(run))
    assert out[:8] == [None, "/ckpts", (1.0 / 16, 0.25, 0.5),
                       (0.125, 0.5, 1.0), (0.25, 0.75), (1.0 / 16, 0.25),
                       5.0, 2.5]
    assert all("MXNET_ROLLOUT" in m for m in out[11:])


def test_rejection_roster_first_writer_wins(tmp_path):
    a = trollout.RejectionRoster(str(tmp_path / "rejected"))
    b = trollout.RejectionRoster(str(tmp_path / "rejected"))
    assert a.reject(5, "sha mismatch", by="router-a") is True
    assert b.reject(5, "late verdict", by="router-b") is False
    assert a.steps() == b.steps() == {5}
    assert a.entry(5)["by"] == "router-a"
    assert b.entry(5)["reason"] == "sha mismatch"
    (tmp_path / "rejected" / "step-9.json").write_text("{tor")
    assert b.steps() == {5}
    wins = []

    def racer(r, tag):
        wins.append((tag, r.reject(12, tag, by=tag)))
    ts = [threading.Thread(target=racer, args=(r, t))
          for r, t in ((a, "a"), (b, "b"))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT)
    assert sum(1 for _, won in wins if won) == 1
    assert a.entry(12)["by"] in ("a", "b")


def test_rejection_roster_shared_with_the_reference(tmp_path):
    """A reference router and a port router watching one directory agree:
    the first writer's verdict stands whichever package wrote it."""
    d = str(tmp_path / "rejected")
    port, ref = trollout.RejectionRoster(d), jrollout.RejectionRoster(d)
    assert port.reject(5, "port verdict", by="port") is True
    assert ref.reject(5, "late", by="reference") is False
    assert ref.reject(7, "reference verdict", by="reference") is True
    assert port.reject(7, "late", by="port") is False
    assert port.steps() == ref.steps() == {5, 7}
    assert ref.entry(5) == port.entry(5) == {
        "step": 5, "reason": "port verdict", "by": "port"}
    assert port.entry(7)["by"] == "reference"


def test_rollout_requires_roleless_tuple_model():
    class Roled:
        _roles = {"prefill": 1, "decode": 1}

    class Opaque:
        _roles = None
        _model = object()

    for pkg in PKGS:
        ro, err = api(pkg)[1], api(pkg)[4]
        with pytest.raises(err, match="role-less"):
            ro.RolloutController(Roled(), "/nowhere")
        with pytest.raises(err, match="params, cfg"):
            ro.RolloutController(Opaque(), "/nowhere")


# ---------------------------------------------------------------------------
# the watcher and the gate
# ---------------------------------------------------------------------------


def test_watcher_skips_incomplete_and_rejected(lm, tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d)
        out = [ro.step(now=0.0)]
        (d / "ckpt-9.shard0of2.npz").write_bytes(b"partial")
        out += [ro.step(now=1.0), ro.state, sorted(ro.roster.steps()),
                9 in ro.mgr.all_steps()]
        publish(pkg, d, 12, perturbed(lm))
        ro.roster.reject(12, "operator fence", by="operator")
        out += [ro.step(now=2.0), ro.state, ro.candidate,
                list(srv._version)]
        return out

    assert same(scenario(lm, tmp_path, body)) == [
        None, None, "idle", [], True, None, "idle", None, [None, None]]


def test_corrupt_candidate_quarantined_before_traffic(lm, tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d)
        publish(pkg, d, 3, perturbed(lm))
        path = d / "ckpt-3.npz"
        blob = bytearray(path.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        path.write_bytes(bytes(blob))
        out = [ro.step(now=0.0), sorted(ro.roster.steps()),
               ro.last_rejection["step"], ro.last_rejection["probe"],
               os.path.exists(str(path) + ".corrupt"), path.exists(),
               len(srv.replicas), list(srv._version), ro.step(now=1.0)]
        block = srv.statusz()["fleet"]["rollout"]
        return out + [block["state"], block["rejected_steps"],
                      block["last_rejection"]["probe"]]

    assert same(scenario(lm, tmp_path, body)) == [
        "rejected", [3], 3, "digest", True, False, 2, [None, None], None,
        "idle", [3], "digest"]


def test_parity_gate_names_shape_and_divergence_probes(lm, tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d)
        tree = host(lm)
        short = {k: v for k, v in tree.items() if k != sorted(tree)[0]}
        publish(pkg, d, 2, short)
        out = [ro.step(now=0.0), ro.last_rejection["probe"]]
        publish(pkg, d, 4, perturbed(lm))
        fixed = [([1, 2, 3], np.zeros(lm[3].vocab, np.float32))]
        ro._probe_outputs = lambda p, c: list(fixed)
        return out + [ro.step(now=1.0), ro.last_rejection["probe"],
                      sorted(ro.roster.steps())]

    assert same(scenario(lm, tmp_path, body)) == [
        "rejected", "shape", "rejected", "divergence", [2, 4]]


def test_chaos_rollout_corrupt_fault_is_caught(lm, tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d)
        publish(pkg, d, 7, perturbed(lm))
        api(pkg)[3].configure(serve_rollout_corrupt=(7, 0))
        return [ro.step(now=0.0),
                "serve_rollout_corrupt" in api(pkg)[3].fired(),
                ro.last_rejection["probe"], sorted(ro.roster.steps())]

    assert same(scenario(lm, tmp_path, body)) == [
        "rejected", True, "digest", [7]]


# ---------------------------------------------------------------------------
# the ladder: canary -> stages -> promote, judged rollback
# ---------------------------------------------------------------------------


def test_canary_spawns_extra_replica_and_ladder_respects_window(lm,
                                                                tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d, stages=(0.25, 0.5), window_s=10.0)
        publish(pkg, d, 1, perturbed(lm))
        out = [ro.step(now=0.0), len(srv.replicas), list(srv._version),
               srv._rollout_weight, ro.stage, ro.step(now=3.0), ro.stage,
               ro.step(now=10.5), ro.stage, srv._rollout_weight,
               ro.step(now=11.0), ro.step(now=21.0), srv._rollout_weight]
        block = srv.statusz()["fleet"]["rollout"]
        return out + [block["state"], block["candidate"],
                      block["incumbent"]]

    assert same(scenario(lm, tmp_path, body)) == [
        "canary", 3, [None, None, 1], 0.25, 0, None, 0, "stage", 1, 0.5,
        None, "promoting", 1.0, "promoting", 1, None]


def test_weighted_pick_order_shifts_canary_share(lm, tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d, stages=(0.25,), window_s=30.0)
        publish(pkg, d, 1, perturbed(lm))
        assert ro.step(now=0.0) == "canary"
        canary = srv._version.index(1)
        heads = sum(srv._pick_order()[0] == canary for _ in range(16))
        tails = sum(srv._pick_order()[-1] == canary for _ in range(16))
        srv._rollout_weight = 0.0
        excluded = all(canary not in srv._pick_order() for _ in range(8))
        return heads, tails, excluded

    assert same(scenario(lm, tmp_path, body)) == (4, 12, True)


def test_promotion_rebuilds_fleet_and_restores_size(lm, tmp_path):
    prompt = arith_prompt(3, 5, 6)

    def body(pkg, srv, d):
        ro = attach(srv, d)
        publish(pkg, d, 1, perturbed(lm))
        out = [ro.step(now=t) for t in (0.0, 1.0, 2.0, 3.0, 4.0)]
        out += [srv.weights_version, list(srv._version), len(srv.replicas),
                ro.state, ro.stage, ro.last_promotion]
        got = srv.generate(list(prompt), max_new_tokens=4, timeout=TIMEOUT)
        ref = fleet(pkg, lm, replicas=1, tree=perturbed(lm))
        try:
            want = ref.generate(list(prompt), max_new_tokens=4,
                                timeout=TIMEOUT)
        finally:
            ref.close(timeout=TIMEOUT)
        return out + [got == want, got, ro.step(now=5.0)]

    out = same(scenario(lm, tmp_path, body))
    assert out[:11] == ["canary", "promoting", "promote_one", "promote_one",
                        "promoted", 1, [1, 1], 2, "idle", -1, {"step": 1}]
    assert out[11] is True and out[13] is None


def test_judged_breach_rolls_back_with_hysteresis(lm, tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d, stages=(0.25, 0.5), window_s=0.0)
        publish(pkg, d, 5, perturbed(lm))
        out = [ro.step(now=0.0)]
        req = srv.submit(arith_prompt(2, 3, 5), max_new_tokens=4)
        ro.judge = lambda: False
        out += [ro.step(now=1.0), ro.state, ro._bad, ro.step(now=2.0),
                ro.state, ro.candidate, len(srv.replicas),
                list(srv._version), srv._rollout_weight,
                sorted(ro.roster.steps()), ro.last_rejection["probe"],
                len(req.result(timeout=TIMEOUT))]
        tok = srv.statusz()["fleet"]["tokens"]
        out.append(tok["submitted"] == tok["goodput"] + tok["slow"]
                   + tok["shed"] + tok["expired"] + tok["failed"])
        del ro.judge
        publish(pkg, d, 6, perturbed(lm, eps=0.07))
        return out + [ro.step(now=3.0), ro.step(now=4.0)]

    assert same(scenario(lm, tmp_path, body)) == [
        "canary", None, "staging", 1, "rollback", "idle", None, 2,
        [None, None], None, [5], "judge", 4, True, "canary", "stage"]


def test_operator_overrides_and_http_surface(lm, tmp_path):
    def body(pkg, srv, d):
        err = api(pkg)[4]
        ro = attach(srv, d, stages=(0.0625, 0.25, 0.5), window_s=60.0)
        with pytest.raises(err):
            ro.promote()
        with pytest.raises(err):
            srv.rollout_command("sideways")
        publish(pkg, d, 2, perturbed(lm))
        out = [ro.step(now=0.0), srv.rollout_command("promote")["ok"],
               ro.step(now=0.1),
               srv.rollout_command("rollback", reason="oncall said no")["ok"],
               ro.step(now=0.2), ro.roster.entry(2)["reason"]]
        h, port = srv.serve_http(port=0, block=False)
        base = "http://%s:%d" % (h, port)

        def post(body):
            req = urllib.request.Request(
                base + "/v1/rollout", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
                return json.loads(r.read()), r.status
        st, code = post({"cmd": "status"})
        out += [code, st["state"]]
        rj, code = post({"cmd": "reject", "step": 99,
                         "reason": "known-bad eval"})
        out += [code, rj["first_writer"], 99 in ro.roster.steps()]
        with pytest.raises(urllib.error.HTTPError) as ei:
            post({"cmd": "sideways"})
        return out + [ei.value.code]

    assert same(scenario(lm, tmp_path, body)) == [
        "canary", True, "promoting", True, "rollback", "oncall said no",
        200, "idle", 200, True, True, 400]


def test_rollout_http_404_without_controller(lm):
    def run(pkg):
        srv = fleet(pkg, lm, replicas=1)
        try:
            h, port = srv.serve_http(port=0, block=False)
            req = urllib.request.Request(
                "http://%s:%d/v1/rollout" % (h, port),
                data=json.dumps({"cmd": "status"}).encode(),
                headers={"Content-Type": "application/json"},
                method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=TIMEOUT)
            return ei.value.code
        finally:
            srv.close(timeout=TIMEOUT)

    assert same(both(run)) == 404


def test_rollout_less_fleet_exposition_unchanged(lm, tmp_path):
    """No controller attached: /statusz carries no rollout block and the
    exposition no rollout metric; attaching one adds both."""
    srv = fleet("port", lm)
    try:
        body = json.dumps(srv.statusz()["fleet"], sort_keys=True)
        names = set(re.findall(r"^# TYPE (\S+)", srv.prometheus_text(),
                               re.M))
        assert "rollout" not in body
        assert not [n for n in names if "rollout" in n]
        attach(srv, tmp_path)
        assert "rollout" in srv.statusz()["fleet"]
        assert "serving_rollout_stage" in srv.prometheus_text()
    finally:
        srv.close(timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# autoscale and version pinning
# ---------------------------------------------------------------------------


def test_autoscale_during_rollout_stays_version_pinned(lm, tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d, stages=(0.25,), window_s=60.0)
        publish(pkg, d, 1, perturbed(lm))
        assert ro.step(now=0.0) == "canary"
        out = [srv.scale_up() is not None, list(srv._version),
               srv.scale_down() is not None, list(srv._version),
               srv.scale_down() is None, list(srv._version)]
        srv._rollout_retiring.add(1)
        out += [srv.scale_down() is not None, list(srv._version)]
        srv._rollout_retiring.discard(1)
        return out

    assert same(scenario(lm, tmp_path, body)) == [
        True, [None, None, 1, None], True, [None, None, 1], True,
        [None, None, 1], True, [None, None]]


def test_respawn_keeps_replica_version(lm, tmp_path):
    def body(pkg, srv, d):
        ro = attach(srv, d, stages=(0.25,), window_s=60.0)
        publish(pkg, d, 1, perturbed(lm))
        assert ro.step(now=0.0) == "canary"
        j = srv._version.index(1)
        old = srv.replicas[j]
        out = [srv.rollout_replace(j, 1), srv.replicas[j] is old,
               srv.rollout_replace(0, 1), srv._version[0],
               srv.rollout_replace(0, None), srv._version[0]]
        # a dead canary respawns on the candidate's weights
        srv._respawn_build(j, srv.replicas[j])
        return out + [srv._version[j], srv.replicas[j] is not old]

    assert same(scenario(lm, tmp_path, body)) == [
        True, True, True, 1, True, None, 1, True]


def test_chaos_slow_canary_standing_fault(lm):
    def run(pkg):
        api(pkg)[3].configure(serve_rollout_slow_canary=(0, 1, 0.01))
        srv = fleet(pkg, lm, replicas=1)
        try:
            got = srv.generate(arith_prompt(2, 3, 5), max_new_tokens=4,
                               timeout=TIMEOUT)
            return got, "serve_rollout_slow_canary" in api(pkg)[3].fired()
        finally:
            srv.close(timeout=TIMEOUT)

    out = same(both(run))
    assert len(out[0]) == 4 and out[1]


# ---------------------------------------------------------------------------
# end to end (port, fake clocks) and across the packages
# ---------------------------------------------------------------------------


def test_live_rollout_promotes_under_traffic_zero_loss(lm, tmp_path):
    """Clients stream through the door while step 1 canaries, stages and
    promotes on a fake clock: zero requests lost, and every response is
    greedy-token-identical to the oracle of the version that served it."""
    work = [(arith_prompt(2 + i, 3 + i % 4, 4 + i % 5), 3 + i % 3)
            for i in range(12)]
    oracles = []
    for tree in (None, perturbed(lm)):
        ref = fleet("port", lm, replicas=1, tree=tree)
        try:
            oracles.append([ref.generate(list(p), max_new_tokens=m,
                                         timeout=TIMEOUT) for p, m in work])
        finally:
            ref.close(timeout=TIMEOUT)
    srv = fleet("port", lm)
    try:
        ro = attach(srv, tmp_path, stages=(0.25, 0.5), window_s=1.0)
        results = {}

        def client(cid, nclients=3):
            for i in range(cid, len(work), nclients):
                prompt, max_new = work[i]
                try:
                    results[i] = srv.generate(list(prompt),
                                              max_new_tokens=max_new,
                                              timeout=TIMEOUT)
                except Exception as e:      # any loss fails below
                    results[i] = e

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        publish("port", tmp_path, 1, perturbed(lm))
        transitions, now = [], 0.0
        while "promoted" not in transitions and now < 100:
            v = ro.step(now=now)
            if v:
                transitions.append(v)
            now += 0.5
            time.sleep(0.01)
        for t in threads:
            t.join(TIMEOUT)
        assert transitions[0] == "canary" and transitions[-1] == \
            "promoted", transitions
        assert transitions.count("stage") == 1 and "promoting" in transitions
        assert srv.weights_version == 1 and len(srv.replicas) == 2
        assert all(v == 1 for v in srv._version)
        lost = [i for i, r in results.items() if not isinstance(r, list)]
        assert not lost and len(results) == len(work), results
        assert all(r in (oracles[0][i], oracles[1][i])
                   for i, r in results.items())
        tok = srv.statusz()["fleet"]["tokens"]
        assert tok["submitted"] == (tok["goodput"] + tok["slow"]
                                    + tok["shed"] + tok["expired"]
                                    + tok["failed"]), tok
    finally:
        srv.close(timeout=TIMEOUT)


def test_reference_written_step_promoted_by_the_port(lm, tmp_path):
    """A step the reference's CheckpointManager published passes the
    port's verification and gate and promotes; the fleet then serves the
    reference-trained weights, token for token."""
    publish("reference", tmp_path, 1, perturbed(lm))
    srv = fleet("port", lm)
    try:
        ro = attach(srv, tmp_path)
        steps = [ro.step(now=t) for t in (0.0, 1.0, 2.0, 3.0, 4.0)]
        assert steps == ["canary", "promoting", "promote_one",
                         "promote_one", "promoted"]
        prompt = arith_prompt(4, 3, 7)
        got = srv.generate(prompt, max_new_tokens=5, timeout=TIMEOUT)
    finally:
        srv.close(timeout=TIMEOUT)
    ref = fleet("reference", lm, replicas=1, tree=perturbed(lm))
    try:
        assert ref.generate(prompt, max_new_tokens=5, timeout=TIMEOUT) == got
    finally:
        ref.close(timeout=TIMEOUT)
