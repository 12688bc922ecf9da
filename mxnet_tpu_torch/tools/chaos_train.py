#!/usr/bin/env python
"""Chaos drill of the port's training resilience: train through injected
faults and prove the final state equals an undisturbed run's.

    python -m mxnet_tpu_torch.tools.chaos_train                 # on the card
    python -m mxnet_tpu_torch.tools.chaos_train --device cpu --net mlp
    python -m mxnet_tpu_torch.tools.chaos_train --multihost
    python -m mxnet_tpu_torch.tools.chaos_train --multihost --supervised

Orchestrator mode (default) runs four worker processes: a CLEAN run, then
on a second checkpoint directory (a) SIGTERM mid-epoch
(MXNET_CHAOS_SIGTERM_AT): the watcher checkpoints at the boundary and
the worker exits 83; (b) a relaunch killed in the middle of a checkpoint
write (MXNET_CHAOS_KILL_SAVE, exit 43): the last published step stays
intact; (c) a relaunch with NaN gradients at one step
(MXNET_CHAOS_NAN_STEP) under the rollback policy. Every checkpoint holds
the generators, the LR schedule and the step count, and every batch is a
function of its step, so the faulted run's FINAL line (and the sha256 of
its parameters) must EQUAL the clean run's.

Worker mode (`--worker`) is the training loop: the net,
`ResilientLoop(TrainStep, CheckpointManager)`, `restore()`, train. All
fault behaviour comes from the environment.

Multi-host mode (`--multihost`) is the pod drill over a real
torch.distributed world: `--hosts` ranks (default 2, one process each,
gloo; on one card they share it) train `{'dp': hosts}` with the ZeRO
sharded update and per-rank SHARDED checkpoints. (a) The last rank is
SIGKILLed mid-run (MXNET_CHAOS_SIGKILL_AT); the survivors get the pod's
SIGTERM and must end within their grace window (MXNET_PREEMPT_GRACE_SECS):
83, or gloo's error about the dead peer at their next collective. Ranks
step in lockstep, so a kill between steps leaves every published step
complete; (b) a relaunch then loses
the last rank in the middle of a checkpoint write
(MXNET_CHAOS_KILL_SAVE), which leaves that step on disk but incomplete.
(c) A same-shape relaunch restores the newest step complete on every
rank (refusing the incomplete one) and finishes bit-identical to an
undisturbed world, step losses included. (d) An elastic relaunch onto a
world of one (the global batch held) finishes loss-curve-identical: each
step's loss, each parameter's sum of squares and the eval loss equal up
to the reduction order of the collectives, within ELASTIC_RTOL. (e) A
rank that hangs instead of dying (it stops itself with SIGSTOP,
`--stop-at`) in two worlds at once: in one, no notice comes, and the
survivor's collective must fail with gloo's timeout within
MXNET_WORLD_TIMEOUT; in the other, the world's timeout is far off and the
survivor gets SIGTERM while blocked, and its PreemptionWatcher's grace
timer must end it with 83 within HUNG_GRACE_S. The pod trains without
dropout: each rank draws the masks of its own slice, so masks depend on
the world's size (the reference draws one global mask).

Supervised mode (`--multihost --supervised`) is the remediation
campaign over an EMULATED pod, as the reference's: `--hosts` processes
(default 3), each a world of one training the whole batch (trajectory
replicas) and writing its part of per-host sharded checkpoints into one
directory, with the supervisor armed (MXNET_TRAIN_REMEDIATION=1). The
pod's relaunches go through `tools/train_supervise.py` (its restart
ladder: budget, backoff, circuit), each of its incarnations being one
pod incarnation here. Legs:

  A. a slow host (MXNET_CHAOS_SLOW_HOST) is flagged by the straggler
     detector, cordoned, the pod drains with 84 and is relaunched at N-1
     without it, finishing equal to the undisturbed run;
  B. a host whose newest checkpoint is then truncated
     (MXNET_CHAOS_CORRUPT_CKPT) is SIGKILLed and its peer preempted; the
     relaunch's checkpoint audit demotes the corrupt step before
     restore, and the pod finishes bit-identical;
  C. an SDC digest flip (MXNET_CHAOS_SDC_AT) makes the parity probes'
     quorum name exactly the armed host, which is cordoned; the pod
     finishes at N-1;
  D. a crash loop (kill-during-save kept armed) exhausts the restart
     budget and the circuit opens with a postmortem.

`--device` is cuda (the default: every worker runs on the card and fails
without one) or cpu. The last stdout line before the verdict is
`DRILL_STATS {json}`: each leg's wall time, the workers' checkpoint save
latency (the caller's host copy against the writer's write + fsync),
bytes a rank, restore ms, and the fused-RNN kernels' launches beside
the count the workers' steps and probes call for (`--net lm`: one K4a and
one K4b launch a layer for each step and each SDC probe).
"""
import argparse
import glob
import hashlib
import importlib.util
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TOOLS = os.path.join(REPO, "tools")

#: the exit codes the drill reads: parallel/resilient.py's preemption and
#: reconfigure drains, utils/chaos.py's kill during a save
EXIT_PREEMPTED, EXIT_RECONFIGURE, EXIT_KILL_SAVE = 83, 84, 43

#: the word LM of `--net lm`: vocab, embed, hidden, layers, bptt, batch
LM_DEFAULT = "10000,200,200,2,35,32"
#: adam's learning rate and the checkpoints kept, in every worker
LR, KEEP = 0.01, 3
#: the pod's MXNET_PREEMPT_GRACE_SECS and MXNET_WORLD_TIMEOUT: a rank
#: blocked on a dead peer errors out well inside its grace window
GRACE_S, WORLD_TIMEOUT_S = 20.0, 10.0
#: leg (e)'s grace window for a survivor blocked on a hung peer under a
#: world timeout far beyond it (WORKER_TIMEOUT_S): only the watcher's
#: grace timer can end that survivor in time
HUNG_GRACE_S = 5.0
#: seconds a survivor may take past its limit (process exit, polling)
EXIT_SLACK_S = 5.0
#: leg (e): seconds from the peer's hang to the survivor's SIGTERM, ample
#: for the survivor to be blocked in its collective by then (a step of
#: the word LM takes ~0.1 s), where Python runs no signal handler
NOTICE_DELAY_S = 2.0
#: the elastic relaunch (a world of one from the world of 2's checkpoint)
#: against the undisturbed world of 2: the largest relative error of a
#: step's loss, of a parameter's sum of squares and of the eval loss. The
#: same global batch, but the world of 2 sums two half batches' gradients
#: through the collective, so only the reduction order differs. On the
#: word LM at bench width (an H100 80GB HBM3 at 700 W,
#: chip_smoke_faults.py --phase 25; PERF.md) two sound runs read 0, 1.04e-7
#: and 9.04e-8 (eval loss, step loss, a parameter's sum of squares), one
#: that drops the world's gradient sum 7.6e-4, 6.73e-4 and 0.201
ELASTIC_RTOL = 1e-5
#: seconds any one worker may take
WORKER_TIMEOUT_S = 600.0


# ---------------------------------------------------------------------------
# worker
# ---------------------------------------------------------------------------


def lm_sizes(args):
    return [int(v) for v in args.lm.split(",")]


def build_net(mx, args):
    """The drill's net, initialized, with its deferred shapes made."""
    gluon = mx.gluon
    if args.net == "lenet":
        from mxnet_tpu_torch.models.lenet import LeNet
        net = LeNet(num_classes=10, dropout=args.dropout)
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((2, 1, 28, 28)))
        return net
    if args.net == "mlp":
        net = gluon.nn.HybridSequential()
        net.add(gluon.nn.Dense(32, in_units=64, activation="relu"))
        net.add(gluon.nn.Dropout(args.dropout))
        net.add(gluon.nn.Dense(10, in_units=32))
        net.initialize(mx.init.Xavier())
        return net
    vocab, embed, hidden, layers, bptt, batch = lm_sizes(args)
    dropout = args.dropout

    class BatchMajor(gluon.Block):
        """The word LM (RNNModel lstm) taking (N, T) tokens and giving
        (N*T, V) logits, so a mesh shards the batch along dim 0."""

        def __init__(self):
            super().__init__(prefix="bm_")
            with self.name_scope():
                self.lm = mx.models.RNNModel(
                    mode="lstm", vocab_size=vocab, num_embed=embed,
                    num_hidden=hidden, num_layers=layers, dropout=dropout)

        def forward(self, x):
            N, T = x.shape
            out = self.lm(x.T)
            return out.reshape((T, N, -1)).transpose((1, 0, 2)) \
                .reshape((N * T, -1))

    with mx.name.NameManager():
        net = BatchMajor()
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((batch, bptt)))
    return net


def batch_for(args, step):
    """The global batch of `step`: a pure function of the step index."""
    rng = np.random.RandomState(10_000 + step)
    if args.net == "lm":
        vocab, _, _, _, bptt, batch = lm_sizes(args)
        tok = rng.randint(0, vocab, (batch, bptt + 1))
        return (tok[:, :-1].astype(np.float32),
                tok[:, 1:].reshape(-1).astype(np.float32))
    if args.net == "lenet":
        x = rng.randn(8, 1, 28, 28).astype(np.float32)
    else:
        x = rng.randn(8, 64).astype(np.float32)
    return x, rng.randint(0, 10, (8,)).astype(np.float32)


def _start_barrier(args, timeout=300.0):
    """Emulated hosts start training together, as a real pod's world
    init lines its ranks up: each publishes a ready file of this
    incarnation and waits for the others'."""
    os.makedirs(args.barrier, exist_ok=True)
    with open(os.path.join(args.barrier, "ready-%d" % args.host_index),
              "w") as f:
        f.write(str(os.getpid()))
    deadline = time.time() + timeout
    while len(os.listdir(args.barrier)) < max(args.hosts, 1):
        _check(time.time() < deadline, "the pod's start barrier timed out")
        time.sleep(0.01)


def worker(args):
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn
    from mxnet_tpu_torch.parallel import ResilientLoop, TrainStep
    from mxnet_tpu_torch.utils.recovery import CheckpointManager
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("chaos_train worker: --device cuda, but "
                         "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.net == "lm":
        os.environ.setdefault("MXNET_FUSED_RNN", "1")
    mesh = None
    if args.world > 1:
        from mxnet_tpu_torch.parallel import build_mesh, init_world
        init_world(init_method="file://" + args.rendezvous, rank=args.rank,
                   world_size=args.world, device=args.device)
        mesh = build_mesh({"dp": args.world})
    ctx = mx.gpu(0) if args.device == "cuda" else mx.cpu()
    mx.random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)
    t_start = time.perf_counter()
    with ctx:
        net = build_net(mx, args)
        loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
        step_fn = TrainStep(net, loss_fn, "adam", {"learning_rate": LR},
                            guard=True, mesh=mesh,
                            sharded_update=mesh is not None)
        # a pod writes per-host sharded checkpoints into the SHARED
        # directory, and publishes them synchronously there so that the
        # step a host dies at decides which steps are complete
        pod = args.hosts > 0 or mesh is not None
        mgr = CheckpointManager(
            args.ckpt_dir, keep=KEEP, async_save=not pod,
            sharded=True if args.hosts else None,
            process_index=args.host_index if args.hosts else None,
            process_count=args.hosts or None)
        loop = ResilientLoop(step_fn, mgr, save_every=args.save_every,
                             policy=args.policy, rollback_after=1,
                             lr_shrink=1.0)
        sup = loop.supervisor
        if sup is not None and sup.auditor is not None:
            # an audit pass before the restore: a step whose published
            # files no longer verify is demoted before anything reads it
            demoted = sup.auditor.audit_once()
            if demoted:
                print("[audit] demoted steps %s before restore" % demoted,
                      flush=True)
        t0 = time.perf_counter()
        start = loop.restore()
        restore_ms = 1e3 * (time.perf_counter() - t0) if start else None
        if args.barrier:
            _start_barrier(args)
        fused_rnn.reset_launch_counts()
        losses, steps_run = {}, 0
        while loop.t < args.steps:
            if loop.t == args.stop_at:
                # a hung host: stopped, its sockets open, until killed
                print("[chaos] stopping at step %d" % loop.t, flush=True)
                os.kill(os.getpid(), signal.SIGSTOP)
            loss = loop.step(*batch_for(args, loop.t))
            losses[loop.t] = float(loss)
            steps_run += 1
        loop.finish()
        launches = fused_rnn.launch_counts()
        probes = sup.probe.probes if sup is not None and \
            sup.probe is not None else 0
        layers = lm_sizes(args)[3] if args.net == "lm" else 0
        xe, ye = batch_for(args, 999)
        out = net(mx.nd.array(xe))
        eval_loss = float(np.mean(loss_fn(out, mx.nd.array(ye)).asnumpy()))
        arrays = [p.data().asnumpy() for p in net.collect_params().values()]
        flat = np.concatenate([a.ravel() for a in arrays])
    print("FINAL step=%d loss=%.6f hash=%.8f"
          % (args.steps, eval_loss, float(np.sum(flat * flat))), flush=True)
    print("PARAMS sha256=%s" % hashlib.sha256(
        np.ascontiguousarray(flat).tobytes()).hexdigest(), flush=True)
    saves = list(mgr.save_log)
    print("WORKER_STATS " + json.dumps({
        "resumed_from": start, "restore_ms": restore_ms,
        "save_copy_ms": [1e3 * r["copy_s"] for r in saves],
        "save_write_ms": [1e3 * r["write_s"] for r in saves
                          if r["write_s"] is not None],
        "ckpt_bytes": mgr._metrics["bytes"].value,
        "k4_launches": list(launches),
        "k4_expected": layers * (steps_run + probes),
        "steps_run": steps_run, "probes": probes,
        "losses": {str(t): v for t, v in sorted(losses.items())},
        "param_sumsq": [float(np.sum(a.astype(np.float64) ** 2))
                        for a in arrays],
        "wall_s": time.perf_counter() - t_start}), flush=True)
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# orchestration helpers
# ---------------------------------------------------------------------------


def _worker_cmd(args, ckpt_dir, **kw):
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.chaos_train",
           "--worker", "--net", args.net, "--steps", str(args.steps),
           "--save-every", str(args.save_every), "--policy", args.policy,
           "--ckpt-dir", ckpt_dir, "--device", args.device,
           "--lm", args.lm, "--dropout", str(args.dropout)]
    for k, v in kw.items():
        cmd += ["--" + k.replace("_", "-"), str(v)]
    return cmd


def _worker_env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("MXNET_CHAOS_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    env.setdefault("OMP_NUM_THREADS", "1")
    env.update(extra or {})
    return env


class _Proc:
    """One worker process with its output in a file."""

    def __init__(self, args, ckpt_dir, tag, env=None, **kw):
        self.tag = tag
        self.log = tempfile.NamedTemporaryFile(
            mode="w+", prefix="chaos_%s_" % re.sub(r"\W", "_", tag),
            suffix=".log", delete=False, dir=args.work_dir)
        self.t0 = time.time()
        self.proc = subprocess.Popen(
            _worker_cmd(args, ckpt_dir, **kw), env=_worker_env(env),
            stdout=self.log, stderr=subprocess.STDOUT, text=True)
        self.stdout = ""
        self.rc = None

    def poll(self):
        return self.proc.poll()

    def wait(self, timeout):
        try:
            self.rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            self.rc = "timeout"
        self.elapsed = time.time() - self.t0
        self.log.flush()
        self.log.seek(0)
        self.stdout = self.log.read()
        self.log.close()
        try:
            os.unlink(self.log.name)
        except OSError:
            pass
        return self.rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()

    def report(self, what=None):
        print("-- %s: exit %s" % (what or self.tag, self.rc), flush=True)
        for line in self.stdout.splitlines():
            if line.startswith(("FINAL", "[resilient]", "[audit]")):
                print("   " + line, flush=True)
        if self.rc not in (0, EXIT_KILL_SAVE, EXIT_PREEMPTED,
                           EXIT_RECONFIGURE, -signal.SIGKILL):
            print(self.stdout[-3000:], flush=True)

    def final(self):
        lines = [l for l in self.stdout.splitlines()
                 if l.startswith(("FINAL", "PARAMS"))]
        return "\n".join(lines[-2:]) if lines else None

    def stats(self):
        for line in reversed(self.stdout.splitlines()):
            if line.startswith("WORKER_STATS "):
                return json.loads(line[len("WORKER_STATS "):])
        return None


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _parse_final(text):
    m = re.search(r"step=(\d+) loss=([-\d.eE]+) hash=([-\d.eE]+)",
                  text or "")
    _check(m, "no FINAL line: %r" % (text,))
    return int(m.group(1)), float(m.group(2)), float(m.group(3))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(TOOLS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stats:
    """What DRILL_STATS reports: leg wall times and the workers' own
    statistics."""

    def __init__(self):
        self.legs = {}
        self.workers = []

    def add(self, proc):
        s = proc.stats()
        if s is not None:
            s["tag"] = proc.tag
            self.workers.append(s)

    def emit(self):
        def summary(values):
            if not values:
                return None
            return {"n": len(values), "median": float(np.median(values)),
                    "max": max(values)}

        def flat(key):
            return summary([v for w in self.workers
                            for v in (w.get(key) or [])])
        restores = summary([w["restore_ms"] for w in self.workers
                            if w.get("restore_ms") is not None])
        launches = [sum(w["k4_launches"][i] for w in self.workers)
                    for i in (0, 1)] if self.workers else [0, 0]
        expected = sum(w["k4_expected"] for w in self.workers)
        print("DRILL_STATS " + json.dumps({
            "legs_s": self.legs, "workers": len(self.workers),
            "save_copy_ms": flat("save_copy_ms"),
            "save_write_ms": flat("save_write_ms"),
            "ckpt_bytes_per_rank": sorted({w["ckpt_bytes"]
                                           for w in self.workers
                                           if w.get("ckpt_bytes")}),
            "restore_ms": restores, "k4_launches": launches,
            "k4_expected": [expected, expected]}), flush=True)


# ---------------------------------------------------------------------------
# orchestrator: one process, three faults
# ---------------------------------------------------------------------------


def run_worker(args, ckpt_dir, tag, chaos=None, stats=None):
    p = _Proc(args, ckpt_dir, tag, env=chaos)
    p.wait(WORKER_TIMEOUT_S)
    p.report()
    if stats is not None:
        stats.add(p)
    return p


def orchestrate(args):
    from mxnet_tpu_torch.utils.recovery import CheckpointManager
    stats = _Stats()
    clean_dir = os.path.join(args.work_dir, "clean")
    fault_dir = os.path.join(args.work_dir, "faulted")
    k_sigterm = args.steps // 4            # mid-epoch
    k_killsave = (args.steps // 2 // args.save_every) * args.save_every
    k_nan = k_killsave + 2
    print("== chaos drill: %s on %s, %d steps, save every %d (faults: "
          "SIGTERM@%d, kill-during-save@%d, NaN@%d)"
          % (args.net, args.device, args.steps, args.save_every, k_sigterm,
             k_killsave, k_nan), flush=True)
    t0 = time.time()
    clean = run_worker(args, clean_dir, "clean reference", stats=stats)
    _check(clean.rc == 0, "clean run failed")
    stats.legs["clean"] = time.time() - t0
    t0 = time.time()
    p1 = run_worker(args, fault_dir, "fault 1: SIGTERM@%d" % k_sigterm,
                    {"MXNET_CHAOS_SIGTERM_AT": str(k_sigterm)}, stats)
    _check(p1.rc == EXIT_PREEMPTED, "expected preemption exit %d, got %r"
           % (EXIT_PREEMPTED, p1.rc))
    stats.legs["sigterm"] = time.time() - t0
    t0 = time.time()
    p2 = run_worker(args, fault_dir,
                    "fault 2: kill-during-save@%d" % k_killsave,
                    {"MXNET_CHAOS_KILL_SAVE": str(k_killsave)}, stats)
    _check(p2.rc == EXIT_KILL_SAVE, "expected chaos hard-kill exit 43, got "
           "%r" % (p2.rc,))
    # the torn temp file must not shadow the last published step
    mgr = CheckpointManager(fault_dir, async_save=False, process_index=0,
                            process_count=1)
    intact = mgr.intact_steps()
    _check(intact and max(intact) < k_killsave and
           k_killsave not in mgr.all_steps(),
           "after the kill during save of step %d the intact steps are %s"
           % (k_killsave, intact))
    print("   last published step %d survives the kill (torn temp files: "
          "%d)" % (max(intact), len(glob.glob(os.path.join(
              fault_dir, "*.tmp-*")))), flush=True)
    stats.legs["kill_save"] = time.time() - t0
    t0 = time.time()
    p3 = run_worker(args, fault_dir,
                    "fault 3: NaN grads@%d (rollback) + finish" % k_nan,
                    {"MXNET_CHAOS_NAN_STEP": str(k_nan)}, stats)
    _check(p3.rc == 0, "faulted run did not complete")
    _check("rolled back to step" in p3.stdout,
           "the NaN step did not trigger a rollback")
    stats.legs["nan_rollback"] = time.time() - t0
    want, got = clean.final(), p3.final()
    print("== clean:   %s" % want.replace("\n", "  "))
    print("== faulted: %s" % (got or "").replace("\n", "  "))
    _check(want is not None and want == got,
           "faulted trajectory diverged from the clean run")
    stats.emit()
    print("== OK: three faults survived, final state bit-identical",
          flush=True)
    return 0


# ---------------------------------------------------------------------------
# multi-host: a real world, one rank dies
# ---------------------------------------------------------------------------


def _world(args, ckpt_dir, n, tag, env_of=None, stop_at=None):
    """Start a world of n ranks (file rendezvous in the work dir); the
    last one stops itself before step `stop_at` when given."""
    rdv = tempfile.mktemp(prefix="rdv_", dir=args.work_dir)
    return [_Proc(args, ckpt_dir, "%s rank %d" % (tag, r),
                  env=dict(env_of(r) if env_of else {},
                           MXNET_HOST_ID=str(r)),
                  world=n, rank=r, rendezvous=rdv,
                  **({"stop_at": stop_at}
                     if stop_at is not None and r == n - 1 else {}))
            for r in range(n)]


def _wait_all(procs, timeout, stats=None):
    for p in procs:
        p.wait(timeout)
        p.report()
        if stats is not None:
            stats.add(p)
    return [p.rc for p in procs]


#: gloo's errors when a peer is gone (its sockets closed) or hangs (the
#: world's timeout expired)
PEER_GONE = re.compile(r"Connection closed by peer|Connection reset by "
                       r"peer|Broken pipe")
PEER_TIMEOUT = re.compile(r"Timed out waiting|timed out", re.I)


def _dead_rank(args, crew, victim_rc, what, stats):
    """Wait for the victim (the last rank) to die, then tear the pod down:
    the survivors get SIGTERM. Each survivor must end within its grace
    window, by the preemption drain or the grace timer (83) or by gloo's
    error about the dead peer at its next collective."""
    victim, survivors = crew[-1], crew[:-1]
    victim.wait(WORKER_TIMEOUT_S)
    victim.report(what)
    _check(victim.rc == victim_rc, "%s: expected the victim's exit %r, got "
           "%r" % (what, victim_rc, victim.rc))
    t_term = time.time()
    for p in survivors:
        if p.poll() is None:
            p.proc.send_signal(signal.SIGTERM)
    exits = {}
    for p in survivors:
        p.wait(GRACE_S + 30)
        took = time.time() - t_term
        p.report("survivor %s after its peer died" % p.tag)
        exits[p.tag] = {"rc": p.rc, "after_sigterm_s": took}
        # after gloo's error the process exits 1, or dies of the pod's
        # SIGTERM once shutdown has restored the default handler
        _check(p.rc == EXIT_PREEMPTED or (p.rc in (1, -signal.SIGTERM) and
                                          PEER_GONE.search(p.stdout)),
               "survivor %s exited %r: it must end by its grace window "
               "(%d) or by gloo's error about its dead peer"
               % (p.tag, p.rc, EXIT_PREEMPTED))
        _check(took <= GRACE_S + EXIT_SLACK_S,
               "survivor %s took %.1fs after SIGTERM, past its %gs grace"
               % (p.tag, took, GRACE_S))
    print("== survivors ended within their grace window: %s"
          % json.dumps(exits), flush=True)
    return exits


def _stopped(proc):
    """True once the process is stopped (SIGSTOP), from /proc."""
    try:
        with open("/proc/%d/stat" % proc.proc.pid) as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "T"
    except OSError:
        return False


def _hung_rank(args, hang_env):
    """Leg (e): the last rank of two worlds stops itself at a step. World
    "timeout": no notice; the survivor's next collective must fail with
    gloo's timeout within MXNET_WORLD_TIMEOUT of the hang. World "grace":
    the world's timeout is far off and the survivor, blocked in its
    collective, gets SIGTERM NOTICE_DELAY_S after its peer hangs; the
    watcher's grace timer must end it with 83 within HUNG_GRACE_S of the
    signal. Both worlds run at once."""
    k_stop = args.save_every + 1
    worlds = {
        "timeout": (hang_env, WORLD_TIMEOUT_S),
        "grace": (dict(hang_env, MXNET_WORLD_TIMEOUT=str(WORKER_TIMEOUT_S),
                       MXNET_PREEMPT_GRACE_SECS=str(HUNG_GRACE_S)),
                  HUNG_GRACE_S)}
    crews = {name: _world(args, os.path.join(args.work_dir, "hung_" + name),
                          2, "hung %s" % name, lambda r, env=env: env,
                          stop_at=k_stop)
             for name, (env, _) in worlds.items()}
    exits = {}
    try:
        # each limit runs from the hang ("timeout") or the notice ("grace")
        t_from = {}
        t_stop = None
        deadline = time.time() + WORKER_TIMEOUT_S
        while len(t_from) < len(crews):
            for name, crew in crews.items():
                victim, survivor = crew[1], crew[0]
                if name in t_from:
                    continue
                _check(victim.poll() is None and survivor.poll() is None,
                       "hung %s: a rank ended early (rcs %s, %s)"
                       % (name, survivor.poll(), victim.poll()))
                if name == "timeout" and _stopped(victim):
                    t_from[name] = time.time()
                elif name == "grace" and t_stop is None and \
                        _stopped(victim):
                    t_stop = time.time()
                elif name == "grace" and t_stop is not None and \
                        time.time() >= t_stop + NOTICE_DELAY_S:
                    survivor.proc.send_signal(signal.SIGTERM)
                    t_from[name] = time.time()
            _check(time.time() < deadline, "no rank stopped at step %d"
                   % k_stop)
            time.sleep(0.01)
        # each survivor's end, timed on its own
        t_end = {}
        deadline = time.time() + max(l for _, l in worlds.values()) + 30
        while len(t_end) < len(crews) and time.time() < deadline:
            for name, crew in crews.items():
                if name not in t_end and crew[0].poll() is not None:
                    t_end[name] = time.time()
            time.sleep(0.01)
        for name, crew in crews.items():
            survivor, limit = crew[0], worlds[name][1]
            survivor.wait(0 if name in t_end else 1)
            took = t_end.get(name, time.time()) - t_from[name]
            survivor.report("survivor of hung rank 1 (%s)" % name)
            exits[name] = {"rc": survivor.rc, "limit_s": limit,
                           ("after_hang_s" if name == "timeout" else
                            "after_sigterm_s"): took}
            if name == "timeout":
                _check(survivor.rc == 1 and
                       PEER_TIMEOUT.search(survivor.stdout),
                       "hung timeout: the survivor exited %r without "
                       "gloo's timeout error:\n%s"
                       % (survivor.rc, survivor.stdout[-2000:]))
            else:
                _check(survivor.rc == EXIT_PREEMPTED,
                       "hung grace: the survivor exited %r, not the grace "
                       "timer's %d" % (survivor.rc, EXIT_PREEMPTED))
            _check(took <= limit + EXIT_SLACK_S,
                   "hung %s: the survivor took %.1fs, past its %gs limit"
                   % (name, took, limit))
    finally:
        for crew in crews.values():
            for p in crew:
                p.kill()
            for p in crew:
                if p.rc is None:
                    p.wait(30)
    print("== survivors of a hung peer ended in time: %s"
          % json.dumps(exits), flush=True)
    return exits


def _restored_step(proc):
    m = re.search(r"resumed from step (\d+)", proc.stdout)
    return int(m.group(1)) if m else 0


def multihost(args):
    stats = _Stats()
    hosts = args.hosts or 2
    clean_dir = os.path.join(args.work_dir, "clean")
    fault_dir = os.path.join(args.work_dir, "faulted")
    elastic_dir = os.path.join(args.work_dir, "elastic")
    k_kill = args.steps // 2 + 1
    if k_kill % args.save_every == 0:
        k_kill += 1
    k_save = (k_kill // args.save_every + 1) * args.save_every
    k_done = (k_kill // args.save_every) * args.save_every
    # each rank draws the dropout masks of its own slice of the batch, so
    # the masks depend on the world's size: the pod trains without
    # dropout, or the elastic leg would compare different draws
    args.dropout = 0.0
    print("== multi-host chaos drill: %s on %s, %d steps, save every %d, a "
          "world of %d ranks (dp mesh, ZeRO sharded update, per-rank "
          "sharded checkpoints); SIGKILL rank %d at step %d, then a hard "
          "kill of it in the middle of step %d's save; world timeout %gs, "
          "grace %gs" % (args.net, args.device, args.steps,
                         args.save_every, hosts, hosts - 1, k_kill, k_save,
                         WORLD_TIMEOUT_S, GRACE_S), flush=True)
    pod_env = {"MXNET_WORLD_TIMEOUT": str(WORLD_TIMEOUT_S),
               "MXNET_PREEMPT_GRACE_SECS": str(GRACE_S)}
    t0 = time.time()
    clean = _world(args, clean_dir, hosts, "clean", lambda r: pod_env)
    rcs = _wait_all(clean, WORKER_TIMEOUT_S, stats)
    _check(rcs == [0] * hosts, "clean world failed: %s" % rcs)
    # the undisturbed world's finish: every rank holds the same weights
    ref, ref_stats = clean[0].final(), clean[0].stats()
    _check(all(p.final() == ref for p in clean),
           "the clean world's ranks disagree")
    stats.legs["clean_world"] = time.time() - t0

    # (a) SIGKILL between steps: every published step stays complete
    t0 = time.time()
    crew = _world(args, fault_dir, hosts, "faulted", lambda r: dict(
        pod_env, **({"MXNET_CHAOS_SIGKILL_AT": str(k_kill)}
                    if r == hosts - 1 else {})))
    exits = _dead_rank(args, crew, -signal.SIGKILL, "fault: SIGKILL rank "
                       "%d @%d" % (hosts - 1, k_kill), stats)
    stats.legs["sigkill_rank"] = time.time() - t0
    stats.legs["survivor_exit_sigkill"] = exits
    # (b) a hard kill in the middle of the victim's checkpoint write: the
    # other ranks publish their shards of k_save, so k_save is on disk
    # but INCOMPLETE, and every relaunch must refuse it
    t0 = time.time()
    crew = _world(args, fault_dir, hosts, "faulted again", lambda r: dict(
        pod_env, **({"MXNET_CHAOS_KILL_SAVE": str(k_save)}
                    if r == hosts - 1 else {})))
    exits = _dead_rank(args, crew, EXIT_KILL_SAVE, "fault: rank %d killed "
                       "mid-save @%d" % (hosts - 1, k_save), stats)
    stats.legs["kill_mid_save_rank"] = time.time() - t0
    stats.legs["survivor_exit_kill_save"] = exits
    _check(glob.glob(os.path.join(fault_dir, "ckpt-%d.shard0of%d.npz"
                                  % (k_save, hosts))),
           "rank 0 left no shard of step %d: no incomplete step to refuse"
           % k_save)
    print("   step %d is on disk but incomplete (rank %d never published "
          "its shard)" % (k_save, hosts - 1), flush=True)
    shutil.copytree(fault_dir, elastic_dir)

    # (c) same shape: the newest step complete on every rank, bit-exact
    t0 = time.time()
    relaunch = _world(args, fault_dir, hosts, "relaunch",
                      lambda r: pod_env)
    rcs = _wait_all(relaunch, WORKER_TIMEOUT_S, stats)
    _check(rcs == [0] * hosts, "same-shape relaunch failed: %s" % rcs)
    stats.legs["same_shape_relaunch"] = time.time() - t0
    for p in relaunch:
        _check(_restored_step(p) == k_done,
               "%s resumed from step %d, not the newest complete step %d"
               % (p.tag, _restored_step(p), k_done))
        print("== %s: %s" % (p.tag, p.final().replace("\n", "  ")))
        _check(p.final() == ref, "%s diverged from the undisturbed world"
               % p.tag)
        ran = p.stats()["losses"]
        _check(ran and ran == {t: ref_stats["losses"][t] for t in ran},
               "%s: step losses %s differ from the undisturbed world's"
               % (p.tag, ran))
    print("== clean:    %s" % ref.replace("\n", "  "))
    print("== same-shape relaunch: bit-identical on all %d hosts (resumed "
          "from step %d, incomplete step %d refused)"
          % (hosts, k_done, k_save), flush=True)

    # (d) elastic: a world of one from the same files
    t0 = time.time()
    el = _Proc(args, elastic_dir, "elastic relaunch (world of 1)",
               env=dict(pod_env, MXNET_HOST_ID="0"))
    el.wait(WORKER_TIMEOUT_S)
    el.report()
    stats.add(el)
    stats.legs["elastic_relaunch"] = time.time() - t0
    _check(el.rc == 0, "elastic relaunch failed")
    _check(_restored_step(el) == k_done,
           "elastic relaunch resumed from step %d, not %d"
           % (_restored_step(el), k_done))
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)
    s_w, l_w, _ = _parse_final(ref)
    s_e, l_e, _ = _parse_final(el.final())
    el_stats = el.stats()
    curve = el_stats["losses"]
    errs = {"eval_loss": rel(l_e, l_w),
            "step_loss": max(rel(v, ref_stats["losses"][t])
                             for t, v in curve.items()),
            "param_sumsq": max(rel(a, b) for a, b in zip(
                el_stats["param_sumsq"], ref_stats["param_sumsq"]))}
    print("== elastic:  %s" % el.final().replace("\n", "  "))
    print("== elastic against the undisturbed world: eval loss rel err "
          "%.3g, step loss max rel err %.3g over %d steps, parameter "
          "sum-of-squares max rel err %.3g over %d tensors (limit %g)"
          % (errs["eval_loss"], errs["step_loss"], len(curve),
             errs["param_sumsq"], len(el_stats["param_sumsq"]),
             ELASTIC_RTOL), flush=True)
    stats.legs["elastic_rel_err"] = errs
    _check(s_e == s_w, "elastic run ended at step %d, not %d" % (s_e, s_w))
    _check(sorted(curve, key=int) == [str(t) for t in
                                      range(k_done + 1, s_w + 1)],
           "elastic relaunch trained steps %s" % sorted(curve, key=int))
    _check(len(el_stats["param_sumsq"]) == len(ref_stats["param_sumsq"]),
           "the elastic net holds another set of parameters")
    _check(max(errs.values()) <= ELASTIC_RTOL,
           "elastic relaunch is not loss-curve-identical: rel errs %s > %g"
           % (errs, ELASTIC_RTOL))

    # (e) a hung rank: the world's timeout, and the grace timer
    t0 = time.time()
    stats.legs["survivor_exit_hung"] = _hung_rank(args, pod_env)
    stats.legs["hung_rank"] = time.time() - t0
    stats.emit()
    print("== OK: dead host survived; same-shape resume bit-identical; "
          "elastic resume (dp %d -> 1) loss-curve-identical; a hung peer "
          "ended by the world timeout and by the grace timer" % hosts,
          flush=True)
    return 0


# ---------------------------------------------------------------------------
# supervised: the remediation campaign over an emulated pod
# ---------------------------------------------------------------------------


class _Pod:
    """One pod incarnation a call: the hosts of the world the cordon
    roster leaves (and that have not finished yet), launched together and
    waited for; the incarnation's exit code is what
    `tools/train_supervise.py`'s ladder reads (0 all finished, 84 a
    reconfigure drain, 83 a preemption, else the first crash's code)."""

    def __init__(self, args, ckpt_dir, labels, env_for, stats):
        self.args = args
        self.ckpt_dir = ckpt_dir
        self.labels = [str(l) for l in labels]
        self.env_for = env_for
        self.stats = stats
        self.roster_dir = os.path.join(ckpt_dir, "cordon")
        self.finals = {}
        self.worlds = []
        self.outputs = []
        self._launched = {}

    def world(self):
        roster = _load_tool("train_supervise").read_roster(self.roster_dir)
        return [l for l in self.labels if l not in roster]

    def run_incarnation(self):
        world = self.world()
        self.worlds.append(list(world))
        todo = [l for l in world if l not in self.finals]
        print("[pod] incarnation %d: world %s, launching %s"
              % (len(self.worlds) - 1, world, todo), flush=True)
        procs = {}
        barrier = tempfile.mkdtemp(prefix="barrier_", dir=self.args.work_dir)
        for lab in todo:
            env = dict(self.env_for(lab) or {})
            if self._launched.get(lab) and not self.args.keep_chaos:
                # a relaunch scrubs the injected faults
                env = {k: v for k, v in env.items()
                       if not k.startswith("MXNET_CHAOS_")}
            env["MXNET_HOST_ID"] = lab
            self._launched[lab] = self._launched.get(lab, 0) + 1
            procs[lab] = _Proc(self.args, self.ckpt_dir, "host " + lab,
                               env=env, hosts=len(world),
                               host_index=world.index(lab),
                               **({"barrier": barrier}
                                  if len(todo) == len(world) else {}))
        rcs = {}
        for lab, p in procs.items():
            p.wait(WORKER_TIMEOUT_S)
            p.report()
            self.stats.add(p)
            self.outputs.append((lab, p.stdout))
            rcs[lab] = p.rc
            if p.rc == 0:
                self.finals[lab] = p.final()
        crashes = [rc for rc in rcs.values()
                   if rc not in (0, EXIT_PREEMPTED, EXIT_RECONFIGURE)]
        if crashes:
            return crashes[0] if isinstance(crashes[0], int) and \
                crashes[0] > 0 else 1
        if EXIT_RECONFIGURE in rcs.values():
            return EXIT_RECONFIGURE
        if EXIT_PREEMPTED in rcs.values():
            return EXIT_PREEMPTED
        return 0

    def supervise(self, restart_max=3, backoff=0.1):
        """Drive the pod through train_supervise's ladder; returns its
        exit code and its log lines."""
        ts = _load_tool("train_supervise")
        lines = []

        def log(msg):
            lines.append(str(msg))
            print(msg, flush=True)
        rc = ts.supervise(["<pod>"], restart_max=restart_max,
                          backoff=backoff, roster=self.roster_dir,
                          flight_dir=self.env_for("0").get(
                              "MXNET_FLIGHT_RECORDER_DIR"),
                          run=self.run_incarnation, log=log)
        return rc, lines


def _flight_events(flight_dir):
    """name -> [event, ...] across every dump in `flight_dir`."""
    out = {}
    for name in sorted(os.listdir(flight_dir)):
        if not (name.startswith("flight-") and name.endswith(".json")):
            continue
        with open(os.path.join(flight_dir, name)) as f:
            doc = json.load(f)
        for ev in doc.get("events", []):
            out.setdefault(ev.get("name"), []).append(ev)
    return out


def supervised(args):
    stats = _Stats()
    hosts = args.hosts or 3
    legs = set(args.legs.split(","))
    base = args.work_dir
    print("== supervised remediation campaign: %s on %s, %d steps, save "
          "every %d, an emulated pod of %d hosts, legs %s"
          % (args.net, args.device, args.steps, args.save_every, hosts,
             sorted(legs)), flush=True)
    t0 = time.time()
    ref = run_worker(args, os.path.join(base, "clean"), "clean reference",
                     stats=stats)
    _check(ref.rc == 0, "clean run failed")
    want = ref.final()
    stats.legs["clean"] = time.time() - t0
    pm = _load_tool("postmortem")
    labels = [str(i) for i in range(hosts)]
    sup_env = {"MXNET_TRAIN_REMEDIATION": "1"}

    if "A" in legs:
        t0 = time.time()
        dir_a, flight_a = os.path.join(base, "leg_a"), \
            os.path.join(base, "flight_a")
        env_a = dict(sup_env, MXNET_STRAGGLER_DIR=os.path.join(
            base, "straggler_a"), MXNET_STRAGGLER_WINDOW="2",
            MXNET_STRAGGLER_FACTOR="3.0", MXNET_STRAGGLER_PATIENCE="2",
            MXNET_FLIGHT_RECORDER_DIR=flight_a)
        print("== leg A: slow host 1 (%gs/step) must be cordoned and the "
              "pod finish at %d hosts" % (args.slow_s, hosts - 1),
              flush=True)
        pod = _Pod(args, dir_a, labels, lambda lab: dict(
            env_a, **({"MXNET_CHAOS_SLOW_HOST": "1:%g" % args.slow_s}
                      if lab == "1" else {})), stats)
        rc, _ = pod.supervise()
        _check(rc == 0, "leg A pod did not finish (rc %s)" % rc)
        roster = _load_tool("train_supervise").read_roster(pod.roster_dir)
        _check(sorted(roster) == ["1"], "expected exactly host 1 cordoned, "
               "roster: %s" % sorted(roster))
        _check(roster["1"]["reason"] == "straggler", roster["1"])
        _check(pod.worlds[-1] == [l for l in labels if l != "1"],
               "leg A's last world is %s" % pod.worlds)
        for lab in pod.worlds[-1]:
            _check(pod.finals.get(lab) == want,
                   "host %s diverged after the cordoned restart: %r != %r"
                   % (lab, pod.finals.get(lab), want))
        ev = _flight_events(flight_a)
        for name in ("chaos.slow_host", "train.straggler", "train.cordon",
                     "train.reconfigure", "train.reconfigure_exit"):
            _check(ev.get(name), "leg A flight timeline is missing %s"
                   % name)
        _check({str(e.get("host")) for e in ev["train.cordon"]} == {"1"},
               ev["train.cordon"])
        # the flags' readings: the slow host's mean step against the
        # pod's median (a healthy host's) and the margin over the factor
        stats.legs["A_straggler_flags"] = [
            {k: e.get(k) for k in ("host", "mean_s", "median_s", "ratio")}
            for e in ev["train.straggler"]]
        text = pm.render(pm.load_dumps([flight_a]))
        _check("train.cordon" in text and "ALERT" in text, text[:800])
        stats.legs["A_straggler_cordon"] = time.time() - t0
        print("== leg A OK: cordoned host 1, finished at %d hosts (%d "
              "incarnation(s), worlds %s)" % (hosts - 1, len(pod.worlds),
                                               pod.worlds), flush=True)

    if "B" in legs:
        t0 = time.time()
        dir_b = os.path.join(base, "leg_b")
        k_kill = (args.steps // 2 // args.save_every) * args.save_every
        env_b = dict(sup_env, MXNET_FLIGHT_RECORDER_DIR=os.path.join(
            base, "flight_b"))
        print("== leg B: host 1's step %d truncated after publishing, then "
              "SIGKILL (host 0 preempted at %d): the audit before restore "
              "must demote it, the relaunch finish bit-identical"
              % (k_kill, k_kill + 1), flush=True)
        pod = _Pod(args, dir_b, ["0", "1"], lambda lab: dict(
            env_b, **({"MXNET_CHAOS_SIGKILL_AT": str(k_kill),
                       "MXNET_CHAOS_CORRUPT_CKPT": str(k_kill)}
                      if lab == "1" else
                      {"MXNET_CHAOS_SIGTERM_AT": str(k_kill + 1)})), stats)
        rc, lines = pod.supervise(restart_max=3)
        _check(rc == 0, "leg B pod did not finish (rc %s)" % rc)
        crashes = [l for l in lines if "crash rc=" in l]
        _check(len(crashes) == 1, "expected one consumed life: %s" % lines)
        relaunched = "".join(out for _, out in pod.outputs[2:])
        _check("demoted steps [%d]" % k_kill in relaunched,
               "the relaunch's audit did not demote step %d:\n%s"
               % (k_kill, relaunched[-2000:]))
        _check(glob.glob(os.path.join(dir_b, "ckpt-%d.*.corrupt" % k_kill)),
               "no demoted files of step %d" % k_kill)
        for lab in ("0", "1"):
            _check(pod.finals.get(lab) == want,
                   "host %s diverged after the relaunch: %r != %r"
                   % (lab, pod.finals.get(lab), want))
        stats.legs["B_kill_corrupt_audit"] = time.time() - t0
        print("== leg B OK: dead host relaunched by train_supervise (1 of 3 "
              "lives), corrupt step %d demoted before restore, "
              "bit-identical finish" % k_kill, flush=True)

    if "C" in legs:
        t0 = time.time()
        dir_c, flight_c = os.path.join(base, "leg_c"), \
            os.path.join(base, "flight_c")
        k_probe = args.save_every
        k_sdc = 2 * k_probe
        env_c = dict(sup_env, MXNET_SDC_PROBE_EVERY=str(k_probe),
                     MXNET_SDC_PROBE_DIR=os.path.join(base, "sdc_c"),
                     MXNET_SDC_PROBE_TIMEOUT="180",
                     MXNET_FLIGHT_RECORDER_DIR=flight_c)
        print("== leg C: SDC digest flip on host 1 @ probe step %d must "
              "name and cordon exactly host 1" % k_sdc, flush=True)
        pod = _Pod(args, dir_c, labels, lambda lab: dict(
            env_c, **({"MXNET_CHAOS_SDC_AT": "1:%d" % k_sdc}
                      if lab == "1" else {})), stats)
        rc, _ = pod.supervise()
        _check(rc == 0, "leg C pod did not finish (rc %s)" % rc)
        roster = _load_tool("train_supervise").read_roster(pod.roster_dir)
        _check(sorted(roster) == ["1"], "SDC quorum named %s, expected "
               "exactly host 1" % sorted(roster))
        _check(roster["1"]["reason"] == "sdc", roster["1"])
        _check(pod.worlds[-1] == [l for l in labels if l != "1"],
               pod.worlds)
        for lab in pod.worlds[-1]:
            _check(pod.finals.get(lab) is not None,
                   "host %s left no FINAL line" % lab)
        ev = _flight_events(flight_c)
        _check(ev.get("chaos.sdc_at"), "injected SDC fault not on timeline")
        named = {str(e.get("host")) for e in ev.get("train.sdc", [])
                 if e.get("quorum")}
        _check(named == {"1"}, "train.sdc events named %s" % sorted(named))
        text = pm.render(pm.load_dumps([flight_c]))
        _check("train.sdc" in text and "ALERT" in text, text[:800])
        stats.legs["C_sdc_quorum"] = time.time() - t0
        print("== leg C OK: quorum named host 1, cordoned, finished at %d "
              "hosts" % (hosts - 1), flush=True)

    if "D" in legs:
        t0 = time.time()
        dir_d, flight_d = os.path.join(base, "leg_d"), \
            os.path.join(base, "flight_d")
        k_crash = 2 * args.save_every
        print("== leg D: kill-during-save @%d kept armed across relaunches "
              "must open the circuit (budget 2)" % k_crash, flush=True)
        args.keep_chaos = True
        pod = _Pod(args, dir_d, ["0"], lambda lab: dict(
            MXNET_CHAOS_KILL_SAVE=str(k_crash),
            MXNET_FLIGHT_RECORDER_DIR=flight_d), stats)
        rc, lines = pod.supervise(restart_max=2, backoff=0.05)
        args.keep_chaos = False
        _check(rc == EXIT_KILL_SAVE and any("CIRCUIT OPEN" in l
                                            for l in lines),
               "crash loop did not open the circuit (rc %r)" % rc)
        _check(sum(l.startswith("[supervise] crash rc=") for l in lines)
               == 3, lines)
        _check(any("chaos.kill_save" in l for l in lines),
               "the circuit-open postmortem did not render the fault")
        stats.legs["D_crash_loop_circuit"] = time.time() - t0
        print("== leg D OK: circuit opened after 3 crashes, postmortem "
              "rendered", flush=True)

    stats.emit()
    print("== OK: supervised remediation campaign (legs %s)"
          % ",".join(sorted(legs)), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--multihost", action="store_true",
                    help="the pod drill over a world of --hosts ranks")
    ap.add_argument("--supervised", action="store_true",
                    help="with --multihost: the remediation campaign over "
                         "an emulated pod")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--net", choices=("lenet", "mlp", "lm"), default="lm")
    ap.add_argument("--lm", default=LM_DEFAULT,
                    help="vocab,embed,hidden,layers,bptt,batch of --net lm")
    ap.add_argument("--dropout", type=float, default=0.5)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--save-every", type=int, default=4)
    ap.add_argument("--policy", default="rollback")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--work-dir", default="")
    ap.add_argument("--hosts", type=int, default=0,
                    help="pod size (worker: the emulated process count)")
    ap.add_argument("--host-index", type=int, default=0)
    ap.add_argument("--world", type=int, default=1,
                    help="worker: ranks of its torch.distributed world")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--rendezvous", default="")
    ap.add_argument("--barrier", default="",
                    help="worker: the emulated pod's start-barrier "
                         "directory")
    ap.add_argument("--stop-at", type=int, default=-1,
                    help="worker: stop this process (SIGSTOP) before this "
                         "step, a hung host")
    ap.add_argument("--legs", default="A,B,C,D",
                    help="the supervised campaign's legs")
    ap.add_argument("--slow-s", type=float, default=0.25)
    args = ap.parse_args(argv)
    args.keep_chaos = False
    if args.worker:
        _check(args.ckpt_dir, "--worker needs --ckpt-dir")
        return worker(args)
    own = not args.work_dir
    if own:
        args.work_dir = tempfile.mkdtemp(prefix="chaos_train_")
    os.makedirs(args.work_dir, exist_ok=True)
    try:
        if args.multihost and args.supervised:
            return supervised(args)
        if args.multihost:
            return multihost(args)
        return orchestrate(args)
    finally:
        if own:
            shutil.rmtree(args.work_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
