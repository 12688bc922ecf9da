"""The readings that phase 24's, 25's and 26's limits in chip_smoke.py sit
between.

chip_smoke.py's 24c holds one float32 step's change of the BatchNorm
running statistics to the single process's (DIST_BN_STATS_TOL), and its
24e holds the int8-collective run's parameter update to the float32
run's (DIST_INT8_UPDATE_TOL). A limit means something only if a sound run
reads below it and a broken one above. This script runs 24c's and 24e's
ranks as chip_smoke.py runs them (a world of 2 sharing cuda:0 over gloo),
sound and with one fault planted in every rank's process, and prints
what each run reads:

  24c  bn_running_stats_rel_err and grad_rel_err, for: sound (twice);
       bn_stats_local (K3a's statistics not reduced over dp: each rank
       normalizes by its own half of the batch); bn_sums_local (K3c's
       sums not reduced over dp).
  24e  int8_update_rel_err and int8_gap, for: sound (twice);
       int8_scale_x2 (the dequantized int8 sum doubled); int8_no_feedback
       (the error-feedback residuals dropped after every step).

  25a  tensors_differing between the resumed and the straight run, for:
       sound; resume_no_rng (load_state_dict drops the generators'
       states, so the masks after a restore repeat the first steps').
  25c  the pod drill's outcome and its elastic readings (the largest
       relative errors, against the world of 2, of the eval loss, of a
       step's loss and of a parameter's sum of squares),
       for: sound (twice); restore_incomplete (the manager accepts a
       sharded step whose files are missing, filling nothing in);
       elastic_no_reduce (the world's gradient sum dropped: each step's
       gradient is the first rank's half batch's, broadcast, so the
       ranks agree and the world of one differs); grace_after_collective
       (the watcher ignores the signal's wakeup byte, so its grace timer
       starts only when Python runs the handler, which a rank blocked in
       a collective never does until the collective returns).

  26a  the live rollout's verdicts (chip_smoke.phase_rollout), for:
       sound; no_divergence_probe (the gate's weights digest always
       equals the incumbent's, so the divergence probe never runs);
       slow_canary_promoted (the judge calls every window healthy).
  26b  the tp engines' readings (chip_smoke.phase_tp: the largest
       |logit - tp=1| at tp=2 and 4, the int8 tp=2 engine's against
       int8 tp=1, the checks that failed), for: sound;
       drop_shard1_partial (both reductions of a layer leave shard 1's
       partial out); whole_weight_row_scales (each row-parallel shard
       quantized with the whole weight's per-column scales instead of
       its own rows').

A fault replaces one function of the port in the rank's process (25c's
in every process of the drill, through a sitecustomize module on
PYTHONPATH that `MXTT_PLANT` arms); no file changes. In a run with a
fault, chip_smoke's checks record what fails instead of raising. Run
from the repository root on a machine with one card:

    python3 chip_smoke_faults.py [--phase 24|25|26]

It prints one line a run, the card's name and power limit, and as its
last line a JSON object of every reading. It exits 1 without a card.
"""
import json
import os
import re
import shutil
import sys
import tempfile
import time

import chip_smoke as cs

FAULTS_24C = ("sound", "sound", "bn_stats_local", "bn_sums_local")
FAULTS_24E = ("sound", "sound", "int8_scale_x2", "int8_no_feedback")
READ_24C = ("bn_running_stats_rel_err", "grad_rel_err", "grad_tol",
            "loss_rel_err")
READ_24E = ("int8_update_rel_err", "int8_gap")
FAULTS_25A = ("sound", "resume_no_rng")
FAULTS_25C = ("sound", "sound", "restore_incomplete", "elastic_no_reduce",
              "grace_after_collective")
FAULTS_26A = ("sound", "no_divergence_probe", "slow_canary_promoted")
FAULTS_26B = ("sound", "drop_shard1_partial", "whole_weight_row_scales")

_SITECUSTOMIZE = """\
import importlib.machinery, importlib.util, os, sys
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path
                      if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _mod = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_mod)
if os.environ.get("MXTT_PLANT"):
    import chip_smoke_faults
    chip_smoke_faults.plant_worker(os.environ["MXTT_PLANT"])
"""


def _plant(fault):
    """Break the port in this process as `fault` names."""
    from mxnet_tpu_torch.ops import fused_bn
    from mxnet_tpu_torch.parallel.trainer import TrainStep
    if fault == "bn_stats_local":
        fused_bn._global_stats = lambda mean, var, ax: (mean, var)
    elif fault == "bn_sums_local":
        fused_bn._sum_partials = lambda parts, ax: tuple(
            p.float() for p in parts)
    elif fault in ("int8_scale_x2", "int8_no_feedback"):
        sound = TrainStep._int8_allreduce

        def faulty(self, grads):
            out = sound(self, grads)
            if fault == "int8_scale_x2":
                return [2 * g for g in out]
            self._quant_residuals = None
            return out
        TrainStep._int8_allreduce = faulty
    elif fault != "sound":
        raise ValueError("unknown fault %r" % fault)


def plant_worker(fault):
    """Break the port in a drill process as `fault` names (25c)."""
    from mxnet_tpu_torch.parallel import trainer
    from mxnet_tpu_torch.utils import recovery
    if fault == "restore_incomplete":
        import numpy as np

        def lenient(self, step, g):
            """What the files on disk hold, zeros where none covers."""
            out = {k: np.zeros(a["shape"], np.dtype(a["dtype"]))
                   for k, a in g.get("arrays", {}).items()}
            for fname in g.get("files", []):
                path = os.path.join(self.directory, fname)
                if not os.path.exists(path):
                    continue
                m = self._verify_shard(path)
                archive = np.load(path, allow_pickle=False)
                for entry, info in m.get("entries", {}).items():
                    if info.get("index") is None:
                        out[info["key"]] = archive[entry]
                    else:
                        out[info["key"]][tuple(
                            slice(a, b) for a, b in info["index"])] = \
                            archive[entry]
            return recovery._unflatten(out)
        recovery.CheckpointManager._restore_sharded = lenient
        recovery.CheckpointManager._verify_step = lambda self, step: None
    elif fault == "elastic_no_reduce":
        import torch.distributed as dist

        def first(t, ax):
            t = t.clone()
            dist.broadcast(t, src=ax.ranks[0], group=ax.group)
            return t * ax.size
        trainer.all_reduce_flat = lambda ts, ax: [first(t, ax) for t in ts]
        trainer.reduce_scatter_raw = lambda t, ax, dim: first(t, ax).narrow(
            dim, ax.index * (t.shape[dim] // ax.size),
            t.shape[dim] // ax.size)
    elif fault == "grace_after_collective":
        from mxnet_tpu_torch.parallel import resilient

        def drain(self, r, prior):
            while os.read(r, 64):
                pass
            os.close(r)
        resilient.PreemptionWatcher._read_wakeups = drain
    elif fault != "sound":
        raise ValueError("unknown fault %r" % fault)


def _phase25(torch, np, dev, card):
    """25a sound and without the generators' states; 25c sound (twice)
    and with each worker fault."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.parallel.trainer import TrainStep
    failed = []

    def record(cond, msg):
        if not cond:
            failed.append(msg[-1500:])
    cs.check = record
    os.environ["MXNET_FUSED_RNN"] = "1"
    out = {"25a": [], "25c": []}
    sound_load = TrainStep.load_state_dict
    for fault in FAULTS_25A:
        del failed[:]
        if fault == "resume_no_rng":
            TrainStep.load_state_dict = lambda self, st: sound_load(
                self, {k: v for k, v in st.items() if k != "rng_key"})
        tmp = tempfile.mkdtemp(prefix="mxtt_faults25_")
        try:
            r = cs.res_inproc(torch, np, mx, fr, dev, tmp)
        finally:
            TrainStep.load_state_dict = sound_load
            shutil.rmtree(tmp, ignore_errors=True)
        reading = {"fault": fault,
                   "tensors_differing": r["tensors_differing"],
                   "max_abs_diff": r["max_abs_diff"],
                   "failed_checks": list(failed)}
        print("25a %s (%s): %s" % (fault, card, json.dumps(reading)))
        sys.stdout.flush()
        out["25a"].append(reading)
    site = tempfile.mkdtemp(prefix="mxtt_site_")
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(_SITECUSTOMIZE)
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.pathsep.join([site, here] + [p for p in [
        os.environ.get("PYTHONPATH")] if p])
    try:
        for fault in FAULTS_25C:
            del failed[:]
            t0 = time.perf_counter()
            stats, _, stdout = cs.res_pod_drill(
                dev, env={"MXTT_PLANT": fault, "PYTHONPATH": path})
            m = re.search(r"eval loss rel err ([-\d.e+]+), step loss max "
                          r"rel err ([-\d.e+]+) over \d+ steps, parameter "
                          r"sum-of-squares max rel err ([-\d.e+]+)", stdout)
            asserted = re.findall(r"AssertionError: (.*)", stdout +
                                  "".join(failed))
            reading = {"fault": fault, "passed": not failed,
                       "elastic_eval_loss_rel_err":
                           float(m.group(1)) if m else None,
                       "elastic_step_loss_rel_err":
                           float(m.group(2)) if m else None,
                       "elastic_param_sumsq_rel_err":
                           float(m.group(3)) if m else None,
                       "rejected_by": asserted[-1][:300] if asserted
                       else None,
                       "wall_s": time.perf_counter() - t0}
            print("25c %s (%s): %s" % (fault, card, json.dumps(reading)))
            sys.stdout.flush()
            out["25c"].append(reading)
    finally:
        shutil.rmtree(site, ignore_errors=True)
    return out


def _plant26(fault):
    """Break the rollout or the tp path in this process as `fault` names;
    returns the function that mends it."""
    import torch
    from mxnet_tpu_torch.ops.quantization import int8_scale
    from mxnet_tpu_torch.serving import rollout, tp
    saved = [(rollout, "params_digest", rollout.params_digest),
             (rollout.RolloutController, "judge",
              rollout.RolloutController.judge),
             (tp, "_reduce_add", tp._reduce_add),
             (tp, "quantize_tp_params", tp.quantize_tp_params)]

    def mend():
        for obj, name, value in saved:
            setattr(obj, name, value)
    if fault == "no_divergence_probe":
        rollout.params_digest = lambda tree: "one digest"
    elif fault == "slow_canary_promoted":
        rollout.RolloutController.judge = lambda self: True
    elif fault == "drop_shard1_partial":
        sound = tp._reduce_add
        tp._reduce_add = lambda x, parts, mesh: sound(
            x, parts[:1] + parts[2:], mesh)
    elif fault == "whole_weight_row_scales":
        sound = tp.quantize_tp_params

        def whole(shards, cfg):
            out = sound(shards, cfg)
            for i in range(cfg.n_layers):
                for name in ("wo", "w2"):
                    key = "layer%d_%s" % (i, name)
                    dev0 = shards[0][key].device
                    full = torch.cat([sh[key].to(dev0) for sh in shards])
                    s = int8_scale(full.float().abs().amax(0))
                    for j, sh in enumerate(shards):
                        w = sh[key].float()
                        sj = s.to(w.device)
                        q = torch.clamp(torch.round(w / sj), -127, 127)
                        out[j][key] = {"q": q.to(torch.int8), "s": sj}
            return out
        tp.quantize_tp_params = whole
    elif fault != "sound":
        raise ValueError("unknown fault %r" % fault)
    return mend


def _phase26(torch, np, dev, card):
    """26a's verdicts and 26b's readings, sound and with each fault."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    failed = []

    def record(cond, msg):
        if not cond:
            failed.append(msg[:400])
    cs.check = record
    cfg = TransformerConfig(dtype=torch.float32, **cs.BENCH_CFG)
    base = cs.bench_params(np, cfg, seed=cs.ROLL_SEED)
    out = {"26a": [], "26b": []}
    for fault in FAULTS_26A:
        del failed[:]
        mend = _plant26(fault)
        tmp = tempfile.mkdtemp(prefix="mxtt_faults26_")
        t0 = time.perf_counter()
        try:
            _, r = cs.phase_rollout(torch, np, serving, pa, cfg, base, dev,
                                    tmp, card)
            verdicts = {str(s): [e[1] for e in r["transitions"]
                                 if e[2] == s] for s in (1, 2, 3, 4, 5)}
            extra = {"canaries": r["canaries"], "rejections": {
                k: v.get("probe") for k, v in r["rejections"].items()}}
        except Exception as e:  # a faulted run may end early
            verdicts, extra = None, {"raised": "%s: %s" % (
                type(e).__name__, str(e)[:300])}
        finally:
            mend()
            shutil.rmtree(tmp, ignore_errors=True)
        reading = dict({"fault": fault, "passed": not failed and verdicts
                        is not None, "verdicts": verdicts,
                        "failed_checks": list(failed)[:6],
                        "wall_s": time.perf_counter() - t0}, **extra)
        print("26a %s (%s): %s" % (fault, card, json.dumps(reading)))
        sys.stdout.flush()
        out["26a"].append(reading)
    params = params_from_numpy(base, cfg, dev)
    for fault in FAULTS_26B:
        del failed[:]
        mend = _plant26(fault)
        t0 = time.perf_counter()
        try:
            _, _, r = cs.phase_tp(torch, np, serving, pa, cfg, params, dev,
                                  card)
        finally:
            mend()
        reading = {"fault": fault, "passed": not failed,
                   "tp2_max_abs_err": r["tp2"]["max_abs_err_vs_tp1"],
                   "tp4_max_abs_err": r["tp4"]["max_abs_err_vs_tp1"],
                   "int8_tp2_max_abs_err":
                       r["int8_tp2"]["max_abs_err_vs_int8_tp1"],
                   "int8_bound": r["int8_tp2"]["bound"],
                   "checks_failed": len(failed),
                   "failed_checks": list(failed)[:4],
                   "wall_s": time.perf_counter() - t0}
        print("26b %s (%s): %s" % (fault, card, json.dumps(reading)))
        sys.stdout.flush()
        out["26b"].append(reading)
    return out


def rank_fault(fault, target, args):
    """chip_smoke.<target>(*args) on this rank with `fault` planted:
    {"result": its result, "failed_checks": the checks that failed}."""
    failed = []

    def record(cond, msg):
        if not cond:
            failed.append(msg[:400])
    cs.check = record
    _plant(fault)
    return {"result": getattr(cs, target)(*args), "failed_checks": failed}


def _runs(target, faults, args, keys, card, device="cuda"):
    from mxnet_tpu_torch.parallel.launch import run_world
    out = []
    for fault in faults:
        t0 = time.perf_counter()
        ranks = run_world("chip_smoke_faults:rank_fault", cs.DIST_WORLD,
                          args=(fault, target, args), device=device,
                          timeout=600)
        reading = {k: max(r["result"][k] for r in ranks) for k in keys}
        reading.update({"fault": fault,
                        "failed_checks": ranks[0]["failed_checks"],
                        "wall_s": time.perf_counter() - t0})
        print("%s %s (%s): %s" % (target, fault, card, json.dumps(reading)))
        sys.stdout.flush()
        out.append(reading)
    return out


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this script needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", choices=("24", "25", "26"), default=None,
                    help="one phase's faults (default: all three)")
    phases = {"24", "25", "26"} if ap.parse_args().phase is None else \
        {ap.parse_args().phase}
    card = cs.nvidia_smi()
    cs.build_kernels(_cuda)
    readings = {"card": card}
    if "24" in phases:
        tmp = tempfile.mkdtemp(prefix="mxtt_faults_")
        try:
            r50_path, ulp_floor = cs.prep_24c(torch, np, mx, dev, tmp)
            torch.cuda.empty_cache()
            readings["24c"] = _runs("rank_24c", FAULTS_24C,
                                    (r50_path, ulp_floor), READ_24C, card)
            lm_path = cs.prep_24e(torch, mx, dev, tmp)
            torch.cuda.empty_cache()
            readings["24e"] = _runs("rank_24e", FAULTS_24E, (lm_path,),
                                    READ_24E, card)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    if "25" in phases:
        readings.update(_phase25(torch, np, dev, card))
    if "26" in phases:
        readings.update(_phase26(torch, np, dev, card))
    print(card)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
