#!/usr/bin/env python
"""Serving chaos drill of the port (port of tools/chaos_serve.py): drive a
3-replica fleet through a fault storm and prove the survival layer holds.

One process runs a `ReplicatedLMServer` over a tiny transformer while
deterministic clients stream requests through the front door, and the
chaos seams (utils/chaos.py) inject, in sequence:

  1. **loop wedge** (replica 1): the serving thread stalls long enough to
     be judged wedged — drained, queued and in-flight work re-homed —
     then resumes and is RESTORED to rotation;
  2. **replica-thread kill** (replica 0): the loop dies mid-decode; the
     death hook fails over its in-flight sequences (prompt + generated
     tokens replay as prefills elsewhere) and the supervisor RESPAWNS a
     fresh replica that serves again within the drill;
  3. **decode-step poison** (replica 2): one decode step raises; the
     batch is locally resumed, the loop survives;
  4. **pool exhaustion** (replica 2): the free list vanishes for a few
     iterations; admission queues instead of failing;
  5. **crash loop** (replica 1): every (re)spawned instance dies; after
     its respawn budget the circuit OPENS and the fleet keeps serving on
     the survivors;
  6. **corrupted rollout candidate**: a published checkpoint has a byte
     flipped after its manifest landed; the rollout gate rejects it
     before any request reaches it;
  7. **draft poison** on a speculating replica: the pass degrades to
     plain decode, token-identical, and the fallback is counted.

Asserted at the end: availability >= 99 % of storm requests; every
completed request greedy-token-IDENTICAL to an undisturbed oracle
rollout; zero leaked blocks (`Engine.audit_quiescent()` on every
surviving replica and every retired engine); every injected fault and the
pinned failover victims' lifecycle events (request.failover /
request.finish, trace-linked) on the merged flight-recorder postmortem
timeline (tools/postmortem.py); the request-lifecycle JSONL ledger
(MXNET_REQUEST_LOG) carrying the victims' lifecycles under ONE trace id
across the hop; tools/fleet_top.py rendering a frame of the degraded
fleet.

    python -m mxnet_tpu_torch.tools.chaos_serve                # the card
    python -m mxnet_tpu_torch.tools.chaos_serve --device cpu
    python -m mxnet_tpu_torch.tools.chaos_serve --requests 96 --clients 6

The fault steps are functions of their own (`storm`, `crash_loop`,
`leak_audit`, `postmortem`, `check_timeline`, `console`), which
chip_smoke.py's phase 23b drives on its serving benchmark's fleet.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from mxnet_tpu_torch.tools import add_device_flag, require_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOOLS = os.path.join(REPO, "tools")

SERVE_FAULTS = ("chaos.serve_wedge", "chaos.serve_kill",
                "chaos.serve_poison", "chaos.serve_exhaust",
                "chaos.serve_crash_loop", "chaos.serve_rollout_corrupt",
                "chaos.serve_spec_poison")
#: the tiny transformer of the reference's drill
MODEL_CONFIG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                    max_len=64)
MODEL_SEED = 0


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def build_model(device):
    """(params, cfg): MODEL_CONFIG with weights from the port's initializer
    drawn by a torch.Generator seeded MODEL_SEED (the reference draws its
    weights with jax.random, which torch cannot reproduce)."""
    import torch
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_transformer_params)
    cfg = TransformerConfig(**MODEL_CONFIG)
    gen = torch.Generator().manual_seed(MODEL_SEED)
    return init_transformer_params(cfg, generator=gen, device=device), cfg


def workload(n, vocab=64):
    """Deterministic (prompt, max_new) pairs: the greedy rollouts are then
    pure functions of these, which is what makes token parity through a
    fault storm checkable at all."""
    out = []
    for i in range(n):
        plen = 4 + (i * 3) % 7
        prompt = [(2 + i + 5 * t) % vocab for t in range(plen)]
        out.append((prompt, 3 + i % 4))
    return out


def oracle_rollouts(model, work, device):
    """Undisturbed single-server rollouts: the parity reference."""
    from mxnet_tpu_torch import serving
    srv = serving.serve(model, max_batch=4, block_size=8, device=device)
    try:
        return [srv.generate(list(p), max_new_tokens=m, timeout=300)
                for p, m in work]
    finally:
        srv.close()


def wait_for(pred, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    raise AssertionError("timed out after %.0f s waiting for %s"
                         % (timeout, what))


def busy_with_tokens(rep, min_generated=1):
    """A racy-but-safe peek: does the replica hold a running sequence that
    has already generated tokens? (Arms the kill so the death is sure to
    strand in-flight work, the failover path's quarry.)"""
    for seq in list(rep.scheduler.running):
        if seq.request is not None and \
                len(seq.tokens) - seq.prompt_len >= min_generated:
            return True
    return False


def start_sweeper(srv):
    """A thread driving the fleet's drain / restore / respawn through its
    health sweep every 50 ms; returns the Event that stops it."""
    stop = threading.Event()

    def sweeper():
        while not stop.is_set():
            try:
                srv.health()
            except Exception:           # a sweep racing a close
                pass
            time.sleep(0.05)

    threading.Thread(target=sweeper, daemon=True).start()
    return stop


def storm(srv, pin_kill, pin_poison, wedge_s=6.0, timeout=60.0,
          dump_prefix="phase", log=print):
    """Faults 1-4 against a live fleet of 3 replicas (its sweeper and
    client stream already running). `pin_kill` / `pin_poison` are (prompt,
    max_new) pairs submitted straight to the victim replicas so each fault
    lands on in-flight work. The flight recorder is dumped as soon as each
    fault has happened (the ring keeps the last spans only). Returns
    {"victims": (kill request, poison request), "tokens": {"kill": the
    killed request's tokens, "kill_again": the pinned prompt served again
    by the respawned replica, "poison": the poisoned one's}, "faults",
    "seconds": per-fault times}."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.utils import chaos

    def dump(name):
        telemetry.flight().dump("%s_%s" % (dump_prefix, name))

    secs, t0 = {}, time.perf_counter()
    # 1. wedge replica 1: stale beat -> drain + failover -> restore
    wait_for(lambda: srv.replicas[1].scheduler.running, timeout,
             "replica 1 under load")
    chaos.configure(serve_wedge=(1, 1, wedge_s))
    wait_for(lambda: "serve_wedge" in chaos.fired(), timeout, "the wedge")
    dump("wedge")
    log("-- fault 1: replica 1 wedged (%gs stall)" % wedge_s)
    wait_for(lambda: srv._drained[1], timeout, "the wedged replica drained")
    dump("wedge_drained")
    wait_for(lambda: not srv._drained[1], timeout,
             "the wedged replica restored")
    secs["wedge_to_restore_s"] = time.perf_counter() - t0
    log("   drained, work re-homed, then RESTORED")
    # 2. kill replica 0 mid-decode: in-flight failover, respawn
    victim0 = srv.replicas[0]
    req_kill = victim0.submit(list(pin_kill[0]), max_new_tokens=pin_kill[1])
    wait_for(lambda: busy_with_tokens(victim0), timeout,
             "replica 0 decoding the pinned request")
    t1 = time.perf_counter()
    chaos.configure(serve_kill=(0, 1))
    # the dying thread re-homes its work before it exits
    wait_for(lambda: not victim0._thread.is_alive(), timeout, "the kill")
    dump("kill")
    log("-- fault 2: replica 0's serving thread killed mid-decode")
    got_kill = req_kill.result(timeout=timeout)
    dump("kill_finished")
    wait_for(lambda: srv.replicas[0] is not victim0, timeout,
             "replica 0 respawned")
    secs["kill_to_respawn_s"] = time.perf_counter() - t1
    again = srv.replicas[0].generate(list(pin_kill[0]),
                                     max_new_tokens=pin_kill[1],
                                     timeout=timeout)
    log("   in-flight work failed over; replica 0 RESPAWNED and serving")
    # 3. poison one decode step on replica 2 (local resume)
    req_poison = srv.replicas[2].submit(list(pin_poison[0]),
                                        max_new_tokens=pin_poison[1])
    wait_for(lambda: busy_with_tokens(srv.replicas[2]), timeout,
             "replica 2 decoding the pinned request")
    resumes = srv.replicas[2].metrics.failovers
    chaos.configure(serve_poison=(2, 1))
    wait_for(lambda: srv.replicas[2].metrics.failovers > resumes, timeout,
             "the poisoned batch resumed")
    dump("poison")
    log("-- fault 3: replica 2 decode step poisoned (batch resumed)")
    got_poison = req_poison.result(timeout=timeout)
    dump("poison_finished")
    # 4. transient pool exhaustion on replica 2
    chaos.configure(serve_exhaust=(2, 1, 10))
    wait_for(lambda: "serve_exhaust" in chaos.fired(), timeout,
             "the exhaustion")
    dump("exhaust")
    log("-- fault 4: replica 2 pool exhausted for 10 iterations")
    return {"victims": (req_kill, req_poison),
            "tokens": {"kill": got_kill, "kill_again": again,
                       "poison": got_poison},
            "faults": ["wedge", "kill", "poison", "exhaust"],
            "seconds": secs}


def crash_loop(srv, timeout=120.0, dump_prefix="phase"):
    """Fault 5: replica 1 crash-loops until its circuit opens; the fleet
    stays up, degraded. Returns the seconds to the open circuit."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.utils import chaos
    t0 = time.perf_counter()
    chaos.configure(serve_crash_loop=(1, 1))
    wait_for(lambda: srv.health()["replicas_circuit_open"] == 1, timeout,
             "the crash-loop circuit opening")
    telemetry.flight().dump("%s_crash_loop" % dump_prefix)
    chaos.configure(serve_crash_loop=None)
    secs = time.perf_counter() - t0
    h = srv.health()
    check(h["ok"] and h["degraded"] and h["replicas"][1]["circuit_open"],
          "after the crash loop /healthz says %r"
          % {k: h[k] for k in ("ok", "degraded", "replicas_circuit_open")})
    return secs


def leak_audit(srv, timeout=60.0, stop_sweep=None):
    """Every pool quiescent and audited: every replica's engine (the
    circuit-open one's too) and every retired (crashed) engine's. Returns
    the engines audited."""
    if stop_sweep is not None:
        stop_sweep.set()
    engines = ([rep.engine for rep in srv.replicas]
               + list(srv._retired_engines))
    wait_for(lambda: not any(e.cache.pool.in_use for e in engines),
             timeout, "every pool quiescent")
    for eng in engines:
        eng.audit_quiescent()
    return engines


def console(url, timeout=120.0):
    """tools/fleet_top.py's frame of the fleet at `url` (it must render
    the degraded fleet: the circuit and every replica)."""
    ft = subprocess.run([sys.executable, os.path.join(TOOLS, "fleet_top.py"),
                         "--url", url, "--once", "--plain"],
                        capture_output=True, text=True, timeout=timeout)
    frame = ft.stdout
    check(ft.returncode == 0 and "fleet:" in frame and "CIRCUIT" in frame,
          "fleet_top.py rc %d: %s" % (ft.returncode,
                                      (ft.stdout + ft.stderr)[-800:]))
    check("tokens: submitted" in frame, frame)
    for i in range(3):
        check(("\n  %d " % i) in frame or (" %d " % i) in frame,
              "replica %d missing from the console frame:\n%s" % (i, frame))
    return frame


def postmortem(flight_dir, timeout=120.0):
    """tools/postmortem.py's merged timeline of the flight dumps."""
    pm = subprocess.run([sys.executable, os.path.join(TOOLS,
                                                      "postmortem.py"),
                         flight_dir], capture_output=True, text=True,
                        timeout=timeout)
    check(pm.returncode == 0, "postmortem.py rc %d: %s"
          % (pm.returncode, pm.stderr[-800:]))
    return pm.stdout


def check_timeline(text, faults, victims):
    """Every fault of `faults` and each victim's failover, finish and
    trace id on the postmortem timeline."""
    missing = [f for f in faults if f not in text]
    check(not missing, "the postmortem timeline lacks %r" % missing)
    check("FAULT" in text, "no FAULT on the postmortem timeline")
    for ev in ("request.failover", "request.finish"):
        check(ev in text, "no %s on the postmortem timeline" % ev)
    for victim in victims:
        check(("request=%d" % victim.id) in text,
              "victim %d's failover event is not on the timeline"
              % victim.id)
        check(victim.trace in text,
              "victim %d's trace id is not on the timeline" % victim.id)


def check_request_log(path, victims):
    """The JSONL ledger carries each victim's queued, failover and finish
    under ONE trace id across the hop. Returns the records."""
    with open(path) as fh:
        recs = [json.loads(ln) for ln in fh if ln.strip()]
    for victim in victims:
        events = [r["event"] for r in recs if r.get("trace") == victim.trace]
        for needed in ("queued", "failover", "finish"):
            check(needed in events, "the request log lost victim %d's %r "
                  "event (has %r)" % (victim.id, needed, events))
    return recs


def rollout_leg(srv, model, extra, want, flight_dir):
    """Fault 6: a published checkpoint bit-flipped after its manifest
    landed must be rejected at the gate (probe "digest"), quarantined on
    the roster, with the fleet on the incumbent and the live requests
    `extra` served token-identically to `want`."""
    import numpy as np
    from mxnet_tpu_torch.utils import chaos
    from mxnet_tpu_torch.utils.recovery import CheckpointManager
    params, _cfg = model
    ckpt_dir = os.path.join(flight_dir, "rollout_ckpts")
    mgr = CheckpointManager(ckpt_dir, async_save=False)
    mgr.save(1, {k: v.detach().float().cpu().numpy() + np.float32(0.05)
                 for k, v in params.items()})
    chaos.configure(serve_rollout_corrupt=(1, 0))
    ro = srv.attach_rollout(ckpt_dir, stages=(0.5,), window_s=0.0)
    results = {}

    def client(j, p, m):
        try:
            results[j] = srv.generate(list(p), max_new_tokens=m,
                                      timeout=300)
        except Exception as e:
            results[j] = e

    threads = [threading.Thread(target=client, args=(j, p, m))
               for j, (p, m) in enumerate(extra)]
    for t in threads:
        t.start()
    verdict = ro.step()
    for t in threads:
        t.join(timeout=300)
    check(verdict == "rejected",
          "the corrupted candidate was not rejected: %r" % verdict)
    check("serve_rollout_corrupt" in chaos.fired(),
          "the rollout corruption never fired")
    check(ro.roster.steps() == {1}, ro.roster.steps())
    check(ro.state == "idle" and ro.candidate is None,
          "rollout state %r, candidate %r" % (ro.state, ro.candidate))
    check(all(v is None for v in srv._version),
          "a corrupted candidate reached a replica: %r" % srv._version)
    check(ro.last_rejection and ro.last_rejection["probe"] == "digest",
          "last rejection %r" % ro.last_rejection)
    lost = [j for j, r in results.items() if not isinstance(r, list)]
    check(not lost, "the rollout leg lost requests %r: %r"
          % (lost, [results[j] for j in lost]))
    mism = [j for j, r in results.items() if r != want[j]]
    check(not mism, "the rollout leg perturbed greedy tokens for %r" % mism)
    return len(results)


def spec_leg(model, pin_poison, want_poison, device):
    """Fault 7: a speculating replica (1-layer self-draft, k=3) whose draft
    logits turn NaN for one pass degrades that pass to plain decode:
    token-identical to the oracle, no request failed, the fallback
    counted. Returns (fallbacks, accepted draft tokens)."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.serving.spec import self_draft
    from mxnet_tpu_torch.utils import chaos
    params, cfg = model
    spec_srv = serving.LMServer(model, max_batch=4, block_size=8,
                                paged=True, draft=self_draft(params, cfg, 1),
                                spec_k=3, replica_id=7, device=device)
    check(spec_srv.engine.spec,
          "the spec replica fell back: %r" % spec_srv.engine.spec_fallback)
    chaos.configure(serve_spec_poison=(7, 1))
    try:
        got = spec_srv.generate(list(pin_poison[0]),
                                max_new_tokens=pin_poison[1], timeout=300)
        check(got == want_poison, "the spec poison degrade diverged: %r != "
              "%r" % (got, want_poison))
        check("serve_spec_poison" in chaos.fired(),
              "the spec poison never fired")
        check(spec_srv.engine.spec_fallbacks >= 1,
              "the poisoned pass was not counted as a spec fallback")
        check(spec_srv.engine.spec_accepted_tokens >= 1,
              "the spec replica never speculated after the degrade")
        wait_for(lambda: not spec_srv.engine.cache.pool.in_use, 30,
                 "the spec replica's pool quiescent")
        spec_srv.engine.audit_quiescent()
        return (spec_srv.engine.spec_fallbacks,
                spec_srv.engine.spec_accepted_tokens)
    finally:
        spec_srv.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--flight-dir", default="")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device)

    flight_dir = args.flight_dir or tempfile.mkdtemp(prefix="chaos_serve_")
    os.environ["MXNET_FLIGHT_RECORDER_DIR"] = flight_dir
    # the per-request lifecycle ledger rides the drill: every request's
    # queued -> ... -> finish streams as JSONL, and the pinned victims'
    # lifecycles must survive the failover hop under ONE trace id
    request_log = os.path.join(flight_dir, "requests.jsonl")
    os.environ["MXNET_REQUEST_LOG"] = request_log

    from mxnet_tpu_torch import serving, telemetry
    from mxnet_tpu_torch.utils import chaos

    model = build_model(device)
    work = workload(args.requests)
    # two pinned long-running requests, submitted straight to the fault
    # phases' victim replicas so the kill lands mid-decode (in-flight
    # failover) and the poison on a live batch, however fast the
    # background storm drains
    pin_kill = ([7, 11, 13, 17, 19], 32)
    pin_poison = ([23, 29, 31, 37], 32)
    print("== serving chaos drill on %s: %d requests / %d clients, 3 "
          "replicas" % (device, args.requests, args.clients), flush=True)
    t0 = time.time()
    want = oracle_rollouts(model, work + [pin_kill, pin_poison], device)
    want, want_kill, want_poison = want[:-2], want[-2], want[-1]
    print("-- oracle: %d undisturbed greedy rollouts (%.1fs)"
          % (len(want) + 2, time.time() - t0), flush=True)

    # a lenient beat threshold while every replica runs its first steps,
    # then a tight one so the storm's injected wedge is detected fast
    srv = serving.serve(model, replicas=3, max_batch=4, block_size=8,
                        max_queue=len(work) + 8, max_beat_age=5.0,
                        respawn_max=2, respawn_backoff=0.05, device=device)
    try:
        t0 = time.time()
        for rep in srv.replicas:
            warm = [rep.submit([3 + t for t in range(plen)],
                               max_new_tokens=4)
                    for plen in (5, 9, 17, 6)]
            for w in warm:
                w.result(timeout=300)
        srv.max_beat_age = 2.5
        print("-- fleet warmed: %d replicas (%.1fs)"
              % (len(srv.replicas), time.time() - t0), flush=True)
        http_host, http_port = srv.serve_http(port=0, block=False)
        console_url = "http://%s:%d" % (http_host, http_port)
        stop_sweep = start_sweeper(srv)

        results = {}

        def client(cid):
            for i in range(cid, len(work), args.clients):
                prompt, max_new = work[i]
                for attempt in range(8):   # absorb transient backpressure
                    try:
                        req = srv.submit(list(prompt),
                                         max_new_tokens=max_new)
                        results[i] = req.result(timeout=300)
                        break
                    except (serving.QueueFull, serving.NoHealthyReplicas):
                        time.sleep(0.1 * (attempt + 1))
                    except Exception as e:
                        results[i] = e
                        break
                time.sleep(0.01)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(args.clients)]
        t0 = time.time()
        for t in threads:
            t.start()
        out = storm(srv, pin_kill, pin_poison,
                    log=lambda m: print(m, flush=True))
        req_kill, req_poison = out["victims"]
        check(out["tokens"]["kill"] == want_kill,
              "in-flight failover diverged: %r != %r"
              % (out["tokens"]["kill"], want_kill))
        check(out["tokens"]["kill_again"] == want_kill,
              "the respawned replica diverged: %r != %r"
              % (out["tokens"]["kill_again"], want_kill))
        check(out["tokens"]["poison"] == want_poison,
              "local resume diverged: %r != %r"
              % (out["tokens"]["poison"], want_poison))
        for t in threads:
            t.join(timeout=600)
        storm_s = time.time() - t0

        # -- verdict: availability + token parity ---------------------------
        done = {i: r for i, r in results.items() if isinstance(r, list)}
        availability = len(done) / float(len(work))
        print("== storm done in %.1fs: %d/%d requests completed (%.1f%%)"
              % (storm_s, len(done), len(work), 100 * availability))
        for i, err in sorted(results.items()):
            if not isinstance(err, list):
                print("   FAILED request %d: %r" % (i, err))
        check(availability >= 0.99, "availability %.3f < 0.99"
              % availability)
        mismatched = [i for i, got in done.items() if got != want[i]]
        check(not mismatched, "failover perturbed greedy tokens for "
              "requests %r" % mismatched)
        print("== every completed request greedy-token-identical to the "
              "undisturbed oracle")
        snap = srv.snapshot()["aggregate"]
        print("== ledger: failovers=%d respawns=%d orphaned=%d"
              % (snap["failovers"], snap["respawns"], snap["orphaned"]))
        check(snap["failovers"] >= 1, "the kill stranded no in-flight work")
        check(snap["respawns"] >= 1, "no replica was respawned")
        # the respawned replica really serves again within the drill
        wait_for(lambda: srv.health()["replicas_healthy"] == 3, 60,
                 "the respawned replica back in rotation")

        # -- crash loop: the circuit opens, the fleet survives --------------
        crash_loop(srv)
        print("-- fault 5: replica 1 crash-looped; circuit OPEN after %d "
              "respawns; fleet degraded-not-dead" % srv.respawn_max)
        extra = workload(6, vocab=64)
        for j, (p, m) in enumerate(extra):
            got = srv.generate(list(p), max_new_tokens=m, timeout=300)
            check(got == want[j], "a survivor diverged after the circuit "
                  "opened")
        print("   survivors keep serving, token-identical")

        # -- live console: fleet_top renders the DEGRADED fleet -------------
        frame = console(console_url)
        print("-- fleet_top console frame (degraded fleet, circuit open):")
        for ln in frame.splitlines()[:8]:
            print("   | " + ln)

        # -- fault 6: a live rollout with a corrupted candidate -------------
        n = rollout_leg(srv, model, extra, want, flight_dir)
        print("-- fault 6: corrupted rollout candidate quarantined at the "
              "gate (probe=digest), %d live requests untouched, fleet "
              "stays on the incumbent" % n)
        telemetry.flight().dump("phase_rollout")

        # -- fault 7: speculative-decoding draft poison ---------------------
        fallbacks, accepted = spec_leg(model, pin_poison, want_poison,
                                       device)
        print("-- fault 7: spec replica's draft poisoned (NaN logits); pass "
              "degraded to non-spec, token-identical, fallback counted "
              "(fallbacks=%d, accepted=%d after recovery)"
              % (fallbacks, accepted))
        telemetry.flight().dump("phase_spec_poison")

        # -- leak audit: every pool quiescent, the crashed engines too ------
        engines = leak_audit(srv, stop_sweep=stop_sweep)
        print("== assert_quiescent clean on %d engines (%d retired corpses "
              "included): zero leaked blocks" % (len(engines),
                                                 len(srv._retired_engines)))
    finally:
        chaos.reset()
        srv.close()

    # -- postmortem: every injected fault on the merged timeline ------------
    telemetry.flight().dump("chaos_drill_end")
    check_timeline(postmortem(flight_dir), SERVE_FAULTS,
                   (req_kill, req_poison))
    print("== postmortem: all %d injected fault kinds + the pinned "
          "victims' request lifecycles on the merged timeline (%s)"
          % (len(SERVE_FAULTS), flight_dir))
    recs = check_request_log(request_log, (req_kill, req_poison))
    print("== request log: %d lifecycle events, victims' lifecycles "
          "trace-connected across the hop (%s)" % (len(recs), request_log))
    print("== OK: availability %.1f%%, failover token-identical, pools "
          "quiescent, faults accounted for" % (100 * availability))
    return 0


if __name__ == "__main__":
    sys.exit(main())
