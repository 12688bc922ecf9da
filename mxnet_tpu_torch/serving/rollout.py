"""Zero-downtime live weight rollout (port of
`mxnet_tpu/serving/rollout.py`).

The training side publishes sharded, manifest-verified checkpoints
(utils/recovery.py). This module composes them with the fleet's
primitives into one production loop: train → publish → canary → judge →
promote-or-rollback, with zero requests lost and a corrupted candidate
caught before it serves real traffic.

`RolloutController` attaches to a `ReplicatedLMServer`
(`serve(rollout=<ckpt dir>)` / MXNET_SERVING_ROLLOUT_DIR) and drives a small state machine, one
synchronous `step()` at a time (tests and drills use fake clocks; live
serving runs it on a daemon thread):

* **watch** — scan the checkpoint directory for a step newer than the
  fleet's serving version. An INCOMPLETE step (mid-save: shard files
  without a global manifest, or a manifest whose shard roster names a
  file that is not on disk yet) is SKIPPED, never judged — the writer
  may still be publishing. A step that fails its manifest/shard
  verification (`CheckpointManager._verify_step`) is corrupt:
  **quarantined**: demoted on disk (files renamed `.corrupt`), marked
  on the shared rejection roster so no watcher ever retries it,
  flight-recorded and counted.
* **parity gate** — before the candidate sees ANY user traffic, a
  pinned deterministic prompt set is decoded greedily on a throwaway
  candidate engine vs a throwaway incumbent engine (both
  `keep_logits=True`, on the fleet's device with its `paged` and
  `block_size`, so on the card the gate runs the paged kernel). Probes, each named in the failure:
  `digest` (the restored weights must re-verify against the step's
  manifests — a bit-flip after publish fails here), `shape` (logit
  rows must be vocab-wide), `finite` (no NaN/Inf logits), and
  `divergence` (if the candidate's weight digest differs from the
  incumbent's, the greedy tokens or logits must differ *somewhere* —
  bit-identical outputs from "changed" weights mean the weights never
  actually loaded). A failed gate quarantines the candidate exactly
  like a failed verification.
* **canary** — a gate-passed candidate gets ONE extra replica via the
  router's `_build_replica` path (`scale_up(version=step)`), and
  traffic shifts through the
  weighted placement ladder (`MXNET_ROLLOUT_STAGES`, default
  1/16 → 1/4 → 1/2): at stage weight f the router prefers the canary
  for ~f of placements and keeps it last in the order otherwise.
* **judge** — at each stage the canary must hold for a minimum
  observation window (`MXNET_ROLLOUT_WINDOW_S`) and is judged against
  the incumbent fleet on its own per-replica SLO burn
  (telemetry/slo.py, `replica=` label) and terminal-failure rate.
  Hysteresis: one bad window re-observes; `max_bad` consecutive bad
  windows roll back.
* **promote** — after the last stage, the remaining incumbents are
  rebuilt on the candidate version ONE AT A TIME (drain → re-home →
  swap), the same zero-loss machinery a respawn uses; the fleet's
  serving version advances and the watcher resumes.
* **rollback** — on a judged breach or operator override, promoted
  replicas are reverted in place, the extra canary replica is drained,
  re-homed and retired (the version-aware `scale_down` prefers
  rollback-pending canaries), and the candidate lands on the rejection
  roster: flight-recorded, alerted, never retried.

The rejection roster is the CordonRoster pattern of
parallel/supervisor.py: a directory of per-step atomic JSON files, first writer wins — two routers watching
one checkpoint directory (a reference router and a port router
included) agree on a rejection without a coordinator.

All rollout metrics/gauges and the /statusz block appear only when a
controller is attached — a rollout-less fleet's exposition stays
byte-for-byte unchanged. Rollouts require a role-less fleet and a
re-instantiable `(params, cfg)` model (each weight version builds its
own engines).
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
import time

import numpy as np
import torch

from ..base import MXNetError
from .. import telemetry
from ..utils import chaos


#: the traffic-shift ladder when MXNET_ROLLOUT_STAGES is unset: the
#: canary takes ~1/16 of placements, then 1/4, then 1/2, then promotes
DEFAULT_STAGES = (1.0 / 16, 1.0 / 4, 1.0 / 2)


def rollout_dir():
    """MXNET_SERVING_ROLLOUT_DIR — the checkpoint directory the serving
    fleet watches for live weight rollouts (docs/ENV_VARS.md);
    `serve(rollout=)` overrides. None/empty = rollouts off."""
    env = os.environ.get("MXNET_SERVING_ROLLOUT_DIR")
    return env if env else None


def rollout_stages(spec=None):
    """Parse the canary traffic ladder — `"1/16,1/4,1/2"` (fractions or
    floats, strictly increasing, each in (0, 1]) — from `spec`, or from
    MXNET_ROLLOUT_STAGES when `spec` is None (docs/ENV_VARS.md).
    Returns a tuple of floats. A list/tuple passes through validated.
    Malformed entries raise MXNetError naming MXNET_ROLLOUT_STAGES — a
    typo'd ladder must never silently become the default."""
    if spec is None:
        spec = os.environ.get("MXNET_ROLLOUT_STAGES")
    if spec is None or (isinstance(spec, str) and not spec.strip()):
        return tuple(DEFAULT_STAGES)
    if isinstance(spec, (tuple, list)):
        parts = [str(p) for p in spec]
    else:
        parts = [p for p in str(spec).split(",") if p.strip()]
    out = []
    for part in parts:
        part = part.strip()
        try:
            if "/" in part:
                num, den = part.split("/", 1)
                f = float(num) / float(den)
            else:
                f = float(part)
        except (TypeError, ValueError, ZeroDivisionError):
            raise MXNetError(
                "MXNET_ROLLOUT_STAGES entry %r is not a fraction or "
                "float (want e.g. '1/16,1/4,1/2')" % part)
        if not 0.0 < f <= 1.0:
            raise MXNetError(
                "MXNET_ROLLOUT_STAGES entry %r must be in (0, 1] — "
                "weight 0 never ships traffic, >1 is not a fraction"
                % part)
        out.append(f)
    if not out:
        raise MXNetError("MXNET_ROLLOUT_STAGES names zero stages")
    if any(b <= a for a, b in zip(out, out[1:])):
        raise MXNetError(
            "MXNET_ROLLOUT_STAGES %r must be strictly increasing — a "
            "rollout that shrinks its canary share mid-ladder is a "
            "typo, not a policy" % (spec,))
    return tuple(out)


def rollout_window_s(spec=None):
    """MXNET_ROLLOUT_WINDOW_S — the minimum observation window (seconds)
    the canary must hold at each stage before the judge advances it
    (docs/ENV_VARS.md). Default 5.0; 0 is legal (tests advance
    instantly); negatives and non-numbers raise MXNetError."""
    if spec is None:
        spec = os.environ.get("MXNET_ROLLOUT_WINDOW_S")
    if spec is None or (isinstance(spec, str) and not spec.strip()):
        return 5.0
    try:
        w = float(spec)
    except (TypeError, ValueError):
        raise MXNetError(
            "MXNET_ROLLOUT_WINDOW_S must be a number of seconds, got %r"
            % (spec,))
    if w < 0:
        raise MXNetError(
            "MXNET_ROLLOUT_WINDOW_S must be >= 0, got %r" % (spec,))
    return w


def rollout_parity_prompts(spec=None):
    """MXNET_ROLLOUT_PARITY_PROMPTS — how many pinned deterministic
    prompts the parity gate decodes on canary vs incumbent
    (docs/ENV_VARS.md). Default 4, minimum 1; malformed values raise
    MXNetError naming the knob."""
    if spec is None:
        spec = os.environ.get("MXNET_ROLLOUT_PARITY_PROMPTS")
    if spec is None or (isinstance(spec, str) and not spec.strip()):
        return 4
    try:
        n = int(spec)
    except (TypeError, ValueError):
        raise MXNetError(
            "MXNET_ROLLOUT_PARITY_PROMPTS must be an integer count, "
            "got %r" % (spec,))
    if n < 1:
        raise MXNetError(
            "MXNET_ROLLOUT_PARITY_PROMPTS must be >= 1, got %r"
            % (spec,))
    return n


def pinned_prompts(vocab, count, max_len):
    """The parity gate's pinned prompt set: a pure function of (vocab,
    count) — no RNG, no clock — so canary and incumbent decode the
    SAME prompts on every gate, in every process."""
    out = []
    for i in range(count):
        n = min(max(2, 4 + i), max(2, max_len - 8))
        out.append([1 + (i * 7 + j * 3) % max(1, vocab - 1)
                    for j in range(n)])
    return out


def _raw_bytes(v):
    """A leaf's raw bytes: a tensor's as stored (bfloat16 as its 2-byte
    words, which numpy cannot hold as floats), an array's as numpy."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(v)).tobytes()


def params_digest(tree):
    """One stable sha256 over a params tree (sorted names + raw bytes):
    the parity gate's weights-actually-changed witness. Tensors and
    arrays holding the same values in the same dtype digest alike, so it
    equals the reference's on the same f32 or bf16 tree."""
    h = hashlib.sha256()
    for name in sorted(tree):
        h.update(name.encode())
        h.update(_raw_bytes(tree[name]))
    return h.hexdigest()


class RejectionRoster:
    """Shared candidate-rejection roster: a directory of per-step
    atomic JSON files (`step-<n>.json`), the CordonRoster pattern from
    parallel/supervisor.py. `reject()` returns True only for the FIRST
    writer (os.replace is atomic; the existence check makes later
    writers report False), so two routers watching one checkpoint
    directory never fight over a verdict; readers skip torn entries."""

    def __init__(self, directory):
        self.directory = directory

    def _path(self, step):
        return os.path.join(self.directory, "step-%d.json" % int(step))

    def reject(self, step, reason="", by=None):
        os.makedirs(self.directory, exist_ok=True)
        path = self._path(step)
        if os.path.exists(path):
            return False
        tmp = path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump({"step": int(step), "reason": str(reason)[:500],
                       "by": by}, f)
            f.flush()
            os.fsync(f.fileno())
        try:
            if os.path.exists(path):        # lost the race
                os.unlink(tmp)
                return False
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        return True

    def steps(self):
        """Rejected step numbers (torn/foreign entries skipped)."""
        out = set()
        try:
            names = os.listdir(self.directory)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("step-")
                    and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.directory, name)) as f:
                    body = json.load(f)
                out.add(int(body["step"]))
            except (OSError, ValueError, KeyError, TypeError):
                continue
        return out

    def entry(self, step):
        try:
            with open(self._path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None


class RolloutController:
    """The detect → judge → act ladder over one `ReplicatedLMServer`.
    One synchronous `step(now)` per decision; `start()` runs it on a
    daemon thread every `interval_s` for live serving. Candidate weights
    come off disk as numpy and are made tensors of the config's dtype on
    the fleet's device."""

    #: consecutive bad observation windows before rollback (hysteresis:
    #: one bad window re-observes — a blip must not kill a rollout)
    max_bad = 2
    #: the judge's TTFT burn-rate breach threshold for the canary
    burn_breach = 1.0
    #: terminal-failure-rate slack the canary gets over the incumbents
    fail_slack = 0.05
    #: tokens decoded per pinned prompt by the parity gate
    parity_decode = 6

    def __init__(self, router, directory, stages=None, window_s=None,
                 parity_prompts=None, interval_s=1.0):
        from ..utils.recovery import CheckpointManager
        if getattr(router, "_roles", None) is not None:
            raise MXNetError(
                "live rollout needs a role-less fleet — disaggregated "
                "prefill/decode rollouts are not supported yet")
        if not (isinstance(router._model, tuple)
                and len(router._model) == 2):
            raise MXNetError(
                "live rollout needs a re-instantiable (params, cfg) "
                "model — each weight version builds its own engines")
        self.router = router
        self.directory = directory
        self.mgr = CheckpointManager(directory, async_save=False)
        self.roster = RejectionRoster(
            os.path.join(directory, "rejected"))
        self.stages = rollout_stages(stages)
        self.window_s = rollout_window_s(window_s)
        self.parity_prompts = rollout_parity_prompts(parity_prompts)
        self.interval_s = float(interval_s)
        self._lock = threading.Lock()
        self.state = "idle"
        self.candidate = None
        self.stage = -1
        self.canary_spawned = False
        self._stage_since = None
        self._bad = 0
        self.last_rejection = None
        self.last_promotion = None
        self._force_promote = False
        self._force_rollback = None
        self._thread = None
        self._stop = threading.Event()
        # rollout observability rides the router's registry — created
        # only here, so a rollout-less exposition stays byte-for-byte
        reg = router.registry
        self._c_candidates = reg.counter(
            "serving_rollout_candidates_total", flight=True,
            help="published checkpoint steps that passed verification "
                 "and entered the parity gate")
        self._c_rejected = reg.counter(
            "serving_rollout_rejected_total", flight=True,
            help="candidate steps quarantined (failed verification or "
                 "the parity gate) or rolled back — demoted on disk "
                 "and marked on the shared rejection roster")
        self._c_parity_fail = reg.counter(
            "serving_rollout_parity_failures_total", flight=True,
            help="parity-gate failures, by named probe (digest / shape "
                 "/ finite / divergence)")
        self._c_promotions = reg.counter(
            "serving_rollout_promotions_total",
            help="candidate versions promoted to the whole fleet "
                 "(every incumbent rebuilt, zero requests lost)")
        self._c_rollbacks = reg.counter(
            "serving_rollout_rollbacks_total", flight=True,
            help="rollouts rolled back (judged SLO/failure breach or "
                 "operator override): canary retired, candidate "
                 "rejected on the roster")
        self._g_stage = reg.gauge(
            "serving_rollout_stage",
            help="current traffic-shift stage index (-1 = no rollout "
                 "in flight)")
        self._g_active = reg.gauge(
            "serving_rollout_active",
            help="1 while a rollout (canary/staging/promoting) is in "
                 "flight")
        self._g_stage.set(-1)

    # -- watch ---------------------------------------------------------------

    def _span(self, phase, t0_us, dur_us=0, **attrs):
        telemetry.record_span(
            "serving.rollout", t0_us, dur_us, category="serving",
            to_profiler=False, phase=phase, **attrs)

    def _check_step(self, step):
        """'ok' | 'incomplete' | ('corrupt', why). Incomplete — shard
        files without a published global manifest, or a manifest whose
        roster names a file not on disk yet — is a writer mid-publish:
        skipped, NEVER quarantined (the next pass re-judges it)."""
        try:
            g = self.mgr.global_manifest(step)
        except (OSError, ValueError) as e:
            return ("corrupt", "global manifest unreadable: %s" % e)
        if g is not None and g.get("format") == "sharded":
            for fname in g.get("files", []):
                path = os.path.join(self.directory, fname)
                if not os.path.exists(path):
                    return "incomplete"
                try:
                    self.mgr._verify_shard(path)
                except (OSError, ValueError) as e:
                    return ("corrupt", str(e))
            return "ok"
        path = os.path.join(self.directory, "ckpt-%d.npz" % step)
        if not os.path.exists(path):
            return "incomplete"     # shards landing, manifest pending
        try:
            self.mgr._verify_manifest(step, path)
        except (OSError, ValueError) as e:
            return ("corrupt", str(e))
        return "ok"

    def _scan(self, now):
        """One watcher pass: newest verified, un-rejected step newer
        than the serving version becomes the candidate."""
        r = self.router
        rejected = self.roster.steps()
        current = r.weights_version
        for step in reversed(self.mgr.all_steps()):
            if step in rejected:
                continue
            if current is not None and step <= current:
                break               # all older: nothing new published
            # chaos seam (serve_rollout_corrupt): bit-flip one of the
            # candidate's published files — the verification below (or
            # the gate's digest probe) must catch it
            chaos.maybe_rollout_corrupt(
                step, [p for p in self.mgr.step_files(step)
                       if p.endswith(".npz")])
            verdict = self._check_step(step)
            if verdict == "incomplete":
                continue            # writer mid-publish: retry later
            if verdict != "ok":
                self._quarantine(step, "digest", verdict[1])
                return "rejected"
            return self._gate(step, now)
        return None

    def _quarantine(self, step, probe, detail):
        """Demote the step's files on disk, mark the shared roster (first
        writer wins), flight-record and alert."""
        t0 = time.perf_counter_ns() // 1000
        try:
            self.mgr.demote(step, reason="%s: %s" % (probe, detail))
        except Exception:
            pass
        self.roster.reject(step, "%s: %s" % (probe, detail),
                           by="rollout")
        self._c_rejected.inc(step=int(step))
        self._c_parity_fail.inc(step=int(step), probe=probe)
        self.last_rejection = {"step": int(step), "probe": probe,
                               "detail": str(detail)[:300]}
        telemetry.flight().record(
            "fault", "serving.rollout_quarantined", step=int(step),
            probe=probe, detail=str(detail)[:200])
        self._span("quarantine", t0, step=int(step), probe=probe)

    # -- the parity gate -----------------------------------------------------

    def _device(self):
        """The fleet's device (its first replica's engine's)."""
        return self.router.replicas[0].engine.device

    def _probe_outputs(self, params, cfg):
        """Greedy-decode the pinned prompt set on a throwaway engine
        (keep_logits=True) on the fleet's device, with the fleet's
        `paged` and `block_size`: [(tokens, last_logits)] per prompt. The
        engine never touches the serving fleet — single-writer stays
        intact and the candidate sees zero user traffic."""
        from .engine import Engine, TransformerLM
        kw = {k: self.router._kwargs[k] for k in ("paged", "block_size")
              if k in self.router._kwargs}
        eng = Engine(TransformerLM(params, cfg), max_batch=1,
                     keep_logits=True, device=self._device(), **kw)
        outs = []
        try:
            for prompt in pinned_prompts(cfg.vocab, self.parity_prompts,
                                         eng.max_len):
                seq = eng.start(prompt, self.parity_decode)
                if seq is None:
                    raise MXNetError("parity probe ran out of blocks")
                while not seq.done and \
                        len(seq.tokens) < seq.max_total:
                    eng.decode_step([seq])
                logits = (np.asarray(seq.last_logits)
                          if seq.last_logits is not None else None)
                outs.append((list(seq.tokens), logits))
                eng.release(seq, reusable=False)
        finally:
            try:
                eng.close(audit=False)
            except Exception:
                pass
        return outs

    def _gate(self, step, now):
        """Verify-restore the candidate and run the parity probes; a
        pass spawns the canary, a failure quarantines the step."""
        t0 = time.perf_counter_ns() // 1000
        self._c_candidates.inc(step=int(step))
        inc_params, cfg = self.router._model
        try:
            tree = self.mgr.restore(step)
        except Exception as e:      # sha/manifest mismatch on read
            self._quarantine(step, "digest", str(e))
            return "rejected"
        if not isinstance(tree, dict) or set(tree) != set(inc_params):
            self._quarantine(
                step, "shape",
                "restored tree keys do not match the serving params "
                "(%d vs %d names)"
                % (len(tree) if isinstance(tree, dict) else 0,
                   len(inc_params)))
            return "rejected"
        cand_digest = params_digest(tree)
        try:
            from ..models import params_from_numpy
            cand_params = params_from_numpy(tree, cfg, self._device())
            cand = self._probe_outputs(cand_params, cfg)
            inc = self._probe_outputs(inc_params, cfg)
        except Exception as e:
            self._quarantine(step, "shape",
                             "probe decode failed: %s: %s"
                             % (type(e).__name__, e))
            return "rejected"
        for toks, logits in cand:
            if logits is None or np.asarray(logits).ndim != 1 \
                    or len(logits) != cfg.vocab:
                self._quarantine(
                    step, "shape",
                    "candidate logits shape %r (want vocab %d)"
                    % (None if logits is None
                       else np.asarray(logits).shape, cfg.vocab))
                return "rejected"
            if not np.all(np.isfinite(logits)):
                self._quarantine(step, "finite",
                                 "candidate logits carry NaN/Inf")
                return "rejected"
        if cand_digest != params_digest(inc_params):
            same = all(
                ct == it and np.array_equal(cl, il)
                for (ct, cl), (it, il) in zip(cand, inc))
            if same:
                self._quarantine(
                    step, "divergence",
                    "weights digest changed but every pinned probe is "
                    "bit-identical to the incumbent — the candidate "
                    "weights never actually loaded")
                return "rejected"
        self._span("gate_pass", t0,
                   time.perf_counter_ns() // 1000 - t0, step=int(step))
        return self._spawn_canary(step, (cand_params, cfg), now)

    # -- canary & staging ----------------------------------------------------

    def _spawn_canary(self, step, model, now):
        r = self.router
        t0 = time.perf_counter_ns() // 1000
        r._models[step] = model
        rep = r.scale_up(version=step)
        if rep is None:
            r._models.pop(step, None)
            telemetry.flight().record(
                "fault", "serving.rollout_spawn_failed", step=int(step))
            return None             # retry on a later pass
        with self._lock:
            self.candidate = int(step)
            self.canary_spawned = True
            self.stage = 0
            self.state = "staging"
            self._stage_since = now
            self._bad = 0
            r._rollout_version = int(step)
            r._rollout_weight = self.stages[0]
        self._g_active.set(1)
        self._g_stage.set(0)
        telemetry.flight().record(
            "event", "serving.rollout_canary", step=int(step),
            warm=bool(getattr(rep.engine, "warm_loads", 0)))
        self._span("canary", t0, time.perf_counter_ns() // 1000 - t0,
                   step=int(step), stage_weight=self.stages[0])
        return "canary"

    def _canary_replicas(self):
        r = self.router
        return [i for i, v in enumerate(r._version)
                if v == self.candidate]

    def canary_burn(self):
        """Max TTFT burn rate (across windows with traffic) over the
        canary replicas' own SLO payloads — {} / 0.0 when no SLO is
        armed. Tests and drills monkeypatch this to script verdicts."""
        from ..telemetry import slo as _slo
        payloads = []
        for i in self._canary_replicas():
            try:
                payloads.append(
                    self.router.replicas[i].metrics.slo.payload())
            except Exception:
                continue
        worst = 0.0
        for m in _slo.merge_slo(payloads):
            if m.get("objective") != "ttft":
                continue
            for b in (m.get("burn") or {}).values():
                if b.get("total", 0) > 0:
                    worst = max(worst, b.get("rate", 0.0))
        return worst

    def failure_rates(self):
        """(canary, incumbent) terminal-failure fractions —
        failed / submitted over each group's request ledgers."""
        canary_ix = set(self._canary_replicas())
        c_fail = c_sub = i_fail = i_sub = 0
        for j, rep in enumerate(list(self.router.replicas)):
            try:
                reqs = rep.snapshot()["requests"]
            except Exception:
                continue
            if j in canary_ix:
                c_fail += reqs.get("failed", 0)
                c_sub += reqs.get("submitted", 0)
            else:
                i_fail += reqs.get("failed", 0)
                i_sub += reqs.get("submitted", 0)
        return (c_fail / c_sub if c_sub else 0.0,
                i_fail / i_sub if i_sub else 0.0)

    def judge(self):
        """One stage verdict: True = healthy. The canary breaches on
        its own TTFT burn (>= burn_breach) or a terminal-failure rate
        worse than the incumbents' plus `fail_slack`."""
        if self.canary_burn() >= self.burn_breach:
            return False
        c_rate, i_rate = self.failure_rates()
        return c_rate <= i_rate + self.fail_slack

    def _judge_stage(self, now):
        if self._force_rollback is not None:
            reason = self._force_rollback
            self._force_rollback = None
            return self._rollback(reason)
        if self._force_promote:
            self._force_promote = False
            return self._enter_promoting(now, forced=True)
        if self._stage_since is not None and \
                now - self._stage_since < self.window_s:
            return None             # observation window still open
        if not self.judge():
            self._bad += 1
            if self._bad >= self.max_bad:
                return self._rollback(
                    "judged breach at stage %d (weight %.4g): %d "
                    "consecutive bad windows"
                    % (self.stage, self.stages[self.stage], self._bad))
            self._stage_since = now     # hysteresis: re-observe
            return None
        self._bad = 0
        if self.stage + 1 < len(self.stages):
            with self._lock:
                self.stage += 1
                self._stage_since = now
                self.router._rollout_weight = self.stages[self.stage]
            self._g_stage.set(self.stage)
            self._span("stage", time.perf_counter_ns() // 1000,
                       step=self.candidate, stage=self.stage,
                       stage_weight=self.stages[self.stage])
            return "stage"
        return self._enter_promoting(now)

    def _enter_promoting(self, now, forced=False):
        with self._lock:
            self.state = "promoting"
            self._stage_since = now
            self.router._rollout_weight = 1.0
        self._g_stage.set(len(self.stages))
        self._span("promoting", time.perf_counter_ns() // 1000,
                   step=self.candidate, forced=bool(forced))
        return "promoting"

    # -- promote / rollback --------------------------------------------------

    def _promote_one(self, now):
        """Rebuild ONE remaining incumbent on the candidate version
        (drain → re-home → swap, zero requests lost); when none remain,
        the fleet's serving version advances and the watcher resumes."""
        if self._force_rollback is not None:
            reason = self._force_rollback
            self._force_rollback = None
            return self._rollback(reason)
        r = self.router
        target = None
        for j, v in enumerate(r._version):
            if v != self.candidate:
                target = j
                break
        if target is not None:
            if r.rollout_replace(target, self.candidate):
                return "promote_one"
            return None             # raced a respawn; retry next pass
        # every replica serves the candidate: finish
        step = self.candidate
        spawned_extra = self.canary_spawned
        with self._lock:
            r.weights_version = step
            r._model = r._models[step]
            r._models = {step: r._models[step]}
            r._rollout_weight = None
            r._rollout_version = None
            self.state = "idle"
            self.stage = -1
            self.candidate = None
            self.canary_spawned = False
            self._stage_since = None
            self._bad = 0
        if spawned_extra:
            # the canary was EXTRA capacity for the shift; retiring one
            # replica (drain + re-home, zero loss) returns the fleet to
            # its pre-rollout size — otherwise every rollout would grow
            # the fleet by one forever
            r.scale_down()
        self._c_promotions.inc(step=int(step))
        self._g_active.set(0)
        self._g_stage.set(-1)
        self.last_promotion = {"step": int(step)}
        telemetry.flight().record(
            "event", "serving.rollout_promoted", step=int(step),
            replicas=len(r.replicas))
        self._span("promoted", time.perf_counter_ns() // 1000,
                   step=int(step))
        return "promoted"

    def _rollback(self, reason):
        """Retire the candidate everywhere: promoted replicas revert in
        place, the extra canary replica drains, re-homes and retires
        (version-aware scale_down), and the step lands on the roster."""
        r = self.router
        step = self.candidate
        t0 = time.perf_counter_ns() // 1000
        with self._lock:
            r._rollout_weight = 0.0     # no new traffic to the canary
            r._rollout_retiring.add(step)
        incumbent = r.weights_version
        # the extra spawned canary replica retires outright — the
        # version-aware scale_down prefers rollback-pending versions
        # and swaps its victim to the tail; any replica promoted IN
        # PLACE before the breach then reverts through the same
        # drain-to-completion replace seam the promote used
        if self.canary_spawned:
            for _ in range(3):      # a respawn may briefly own a slot
                if not any(v == step for v in r._version):
                    break
                if r.scale_down() is not None:
                    break
                time.sleep(0.05)
        for j, v in enumerate(list(r._version)):
            if v == step:
                r.rollout_replace(j, incumbent)
        with self._lock:
            r._rollout_retiring.discard(step)
            r._rollout_weight = None
            r._rollout_version = None
            self.state = "idle"
            self.stage = -1
            self.candidate = None
            self.canary_spawned = False
            self._stage_since = None
            self._bad = 0
            r._models.pop(step, None)
        self.roster.reject(step, reason, by="rollout")
        self._c_rollbacks.inc(step=int(step))
        self._c_rejected.inc(step=int(step))
        self.last_rejection = {"step": int(step), "probe": "judge",
                               "detail": str(reason)[:300]}
        self._g_active.set(0)
        self._g_stage.set(-1)
        telemetry.flight().record(
            "fault", "serving.rollout_rollback", step=int(step),
            reason=str(reason)[:200])
        self._span("rollback", t0,
                   time.perf_counter_ns() // 1000 - t0,
                   step=int(step), reason=str(reason)[:120])
        return "rollback"

    # -- operator overrides (POST /v1/rollout) -------------------------------

    def promote(self):
        """Operator override: skip the remaining stages and promote the
        in-flight candidate on the next pass."""
        if self.state not in ("staging", "promoting"):
            raise MXNetError("no rollout in flight to promote")
        self._force_promote = True
        return {"ok": True, "candidate": self.candidate}

    def rollback(self, reason="operator override"):
        """Operator override: roll the in-flight candidate back on the
        next pass and reject it on the roster."""
        if self.state not in ("staging", "promoting"):
            raise MXNetError("no rollout in flight to roll back")
        self._force_rollback = str(reason)
        return {"ok": True, "candidate": self.candidate}

    def reject(self, step, reason="operator reject"):
        """Operator override: mark `step` rejected on the roster so the
        watcher never picks it up. First writer wins."""
        first = self.roster.reject(int(step), reason, by="operator")
        if first:
            self._c_rejected.inc(step=int(step))
        return {"ok": True, "step": int(step), "first_writer": first}

    # -- the decision --------------------------------------------------------

    def step(self, now=None):
        """One synchronous rollout decision: watch/gate when idle,
        judge when staging, replace-one when promoting. Returns the
        transition taken ('canary', 'stage', 'promoting',
        'promote_one', 'promoted', 'rollback', 'rejected') or None."""
        now = time.monotonic() if now is None else now
        r = self.router
        if r._closed:
            return None
        if self.state == "idle":
            return self._scan(now)
        if self.state == "staging":
            return self._judge_stage(now)
        if self.state == "promoting":
            return self._promote_one(now)
        return None                                  # pragma: no cover

    def status(self):
        """The /statusz `rollout` block (fleet_top renders it): state,
        versions, ladder position, and the canary verdict-so-far."""
        r = self.router
        with self._lock:
            weight = r._rollout_weight
            body = {
                "state": self.state,
                "incumbent": r.weights_version,
                "candidate": self.candidate,
                "stage": self.stage,
                "stages": [round(f, 6) for f in self.stages],
                "weight": weight,
                "versions": list(r._version),
                "bad_windows": self._bad,
                "window_s": self.window_s,
                "last_rejection": self.last_rejection,
                "last_promotion": self.last_promotion,
                "rejected_steps": sorted(self.roster.steps()),
            }
        return body

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """Run `step()` every `interval_s` on a daemon thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.step()
                except Exception:
                    # one bad pass must never kill the watcher; the
                    # flight recorder carries the evidence
                    continue

        self._thread = threading.Thread(target=loop,
                                        name="mxtt-rollout",
                                        daemon=True)
        self._thread.start()

    def stop(self, timeout=5.0):
        self._stop.set()
        t = self._thread
        self._thread = None
        if t is not None:
            t.join(timeout)
