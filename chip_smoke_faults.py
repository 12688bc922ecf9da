"""The readings that phase 24's, 25's, 26's, 29's and 30's limits in
chip_smoke.py sit between.

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

  29b  the exported word LM's largest logit error over the largest
       |logit| against the eager net with the flag off (the replay here,
       the fresh process's on the card and the CPU), for: sound (twice);
       wh_bf16 (K4a given wh rounded to bfloat16); reverse_flipped (K4a
       scanning each layer in the other direction); fresh_cpu_wh_bf16
       (the fresh process's plain scan on the CPU given wh rounded to
       bfloat16).

  30   the C++ half's checks (chip_smoke.phase_cpp_build, _predict and
       _train), for: sound; k4a_wrong_design (the C++ rnn_design takes
       the layout with the most rows a cluster where Python takes the
       fewest); wh_perturbed (the C++ op hands K4a wh scaled by
       1 + 1e-3); state_off_by_one (export_train_step's state/<i>.bin
       each written one slot late, the last first). The two C++ faults
       build a copy of cpp_package/'s sources, changed, in a temporary
       directory.

A fault replaces one function of the port in the rank's process (25c's
in every process of the drill, 29b's fresh_cpu_wh_bf16 in the fresh
process, through a sitecustomize module on PYTHONPATH that `MXTT_PLANT`
arms); no file changes. In a run with a
fault, chip_smoke's checks record what fails instead of raising. Run
from the repository root on a machine with one card:

    python3 chip_smoke_faults.py [--phase 24|25|26|29|30]

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
FAULTS_29B = ("sound", "sound", "wh_bf16", "reverse_flipped",
              "fresh_cpu_wh_bf16")
FAULTS_30 = ("sound", "k4a_wrong_design", "wh_perturbed", "state_off_by_one")
#: the C++ faults: (the source changed, the text replaced, its stand-in)
_CPP_FAULTS = {
    "k4a_wrong_design": (
        "src/rnn_op.cc",
        "std::make_tuple(ceil_div(clusters, n), R, -P)",
        "std::make_tuple(ceil_div(clusters, n), -R, -P)"),
    "wh_perturbed": (
        "src/rnn_op.cc",
        "const Design d = rnn_design(mc, N, static_cast<int>(H), dtype);",
        "const Design d = rnn_design(mc, N, static_cast<int>(H), dtype);\n"
        "  const at::Tensor whp = (wh * 1.001).contiguous();"),
}

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
    """Break the port in a drill process (25c) or 29b's fresh process as
    `fault` names."""
    if fault == "fresh_cpu_wh_bf16":
        import torch
        from mxnet_tpu_torch.ops import fused_rnn
        sound = fused_rnn.rnn_fwd_plain

        def rounded(mode, px, h0, c0, wh, *args, **kwargs):
            return sound(mode, px, h0, c0,
                         wh.to(torch.bfloat16).to(wh.dtype), *args,
                         **kwargs)
        fused_rnn.rnn_fwd_plain = rounded
        return
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


def _phase29(torch, np, dev, card):
    """29b's readings (the exported word LM's largest logit error over the
    largest |logit| against the eager net with the flag off: the replay in
    this process, the fresh process's on the card and on the CPU), sound
    and with each fault planted into K4a's wrapper in this process (the
    fresh process stays sound): wh_bf16 (the recurrent weight rounded to
    bf16 before the launch, a dtype slip), reverse_flipped (each layer
    scanned in the other direction); and fresh_cpu_wh_bf16, planted in
    the fresh process only (its plain scan on the CPU given wh rounded
    to bf16)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import fused_rnn
    failed = []

    def record(cond, msg):
        if not cond:
            failed.append(msg[:400])
    cs.check = record
    sound = fused_rnn.rnn_fwd

    def planted(transform):
        """K4a's wrapper with its arguments transformed; the wrapper counts
        through its global name, so the counts pass through to it."""
        def faulty(mode, px, h0, c0, wh, reverse=False):
            faulty.launches = sound.launches
            faulty.design_launches = sound.design_launches
            try:
                return sound(*transform(mode, px, h0, c0, wh, reverse))
            finally:
                sound.launches = faulty.launches
        return faulty
    site = tempfile.mkdtemp(prefix="mxtt_site_")
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(_SITECUSTOMIZE)
    here = os.path.dirname(os.path.abspath(__file__))
    planted_env = {"MXTT_PLANT": "fresh_cpu_wh_bf16",
                   "PYTHONPATH": os.pathsep.join([site, here] + [p for p in [
                       os.environ.get("PYTHONPATH")] if p])}
    prior_env = {k: os.environ.get(k) for k in planted_env}
    out = []
    for fault in FAULTS_29B:
        del failed[:]
        if fault == "fresh_cpu_wh_bf16":
            os.environ.update(planted_env)
        if fault == "wh_bf16":
            fused_rnn.rnn_fwd = planted(lambda m, px, h0, c0, wh, r: (
                m, px, h0, c0, wh.to(torch.bfloat16).to(wh.dtype), r))
        elif fault == "reverse_flipped":
            fused_rnn.rnn_fwd = planted(lambda m, px, h0, c0, wh, r: (
                m, px, h0, c0, wh, not r))
        tmp = tempfile.mkdtemp(prefix="mxtt_faults29_")
        try:
            with mx.gpu(dev.index or 0):
                _, main = cs.phase_deploy_word_lm(torch, np, mx, dev, card,
                                                  tmp)
        finally:
            fused_rnn.rnn_fwd = sound
            shutil.rmtree(tmp, ignore_errors=True)
            for k, v in prior_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        row = {"fault": fault, **main["logit_err_over_max"],
               "limit": cs.LM_EXPORT_RTOL,
               "cpu_limit": cs.LM_EXPORT_CPU_RTOL, "failed": list(failed)}
        print(json.dumps(row), flush=True)
        out.append(row)
    shutil.rmtree(site, ignore_errors=True)
    return {"29b": out}


def _cpp_variant(fault):
    """The C++ tree built from a copy of cpp_package/'s sources with
    `fault`'s change, in a temporary directory: its `Build`."""
    from mxnet_tpu_torch import cpp_package as cp
    rel, old, new = _CPP_FAULTS[fault]
    work = tempfile.mkdtemp(prefix="mxtt_cpp_%s_" % fault)
    src = os.path.join(work, "src_tree")
    shutil.copytree(cp.HERE, src,
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(src, rel)) as f:
        text = f.read()
    if fault == "wh_perturbed":
        text = text.replace("wh.data_ptr(), ys.data_ptr()",
                            "whp.data_ptr(), ys.data_ptr()")
    assert old in text, (fault, old)
    with open(os.path.join(src, rel), "w") as f:
        f.write(text.replace(old, new))
    includes, lib_dir, libs = cp._torch_paths(True)
    out = os.path.join(work, "build")
    os.makedirs(out)
    cp._compile_tree(out, True, cp._flags(True, includes), lib_dir, libs,
                     src_dir=src)
    return cp.Build(out, "cuda", *(os.path.join(out, p)
                                   for p in cp._PRODUCTS)), work


def _phase30(torch, np, dev, card):
    """Phase 30's readings (30a's designs that differ, 30b's logit error
    and K4a launches, 30c's largest relative loss error, the checks that
    failed), sound and with each fault planted: two into a copy of the
    C++ sources (k4a_wrong_design, wh_perturbed), one into
    export_train_step's artifact (state_off_by_one)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cpp_package, predict
    failed = []

    def record(cond, msg):
        if not cond:
            failed.append(msg[:400])
    cs.check = record
    sound_build, sound_publish = cpp_package.build, predict._publish_zip

    def off_by_one(path, entries):
        """state/<i>.bin written one slot late (the last first)."""
        names = sorted((n for n in entries if n.startswith("state/")),
                       key=lambda n: int(n[6:-4]))
        blobs = [entries[n] for n in names]
        entries.update(zip(names, blobs[-1:] + blobs[:-1]))
        return sound_publish(path, entries)
    out = []
    for fault in FAULTS_30:
        del failed[:]
        work = None
        if fault in _CPP_FAULTS:
            tree, work = _cpp_variant(fault)
            cpp_package.build = lambda device="cuda", _t=tree: _t
        elif fault == "state_off_by_one":
            predict._publish_zip = off_by_one
        tmp = tempfile.mkdtemp(prefix="mxtt_faults30_")
        row = {"fault": fault}
        try:
            with mx.gpu(dev.index or 0):
                tree, a = cs.phase_cpp_build(torch, np, dev, card)
                row["designs_differing"] = [
                    d for d in a["designs"] if d["python"] != d["cpp"]]
                try:
                    _, b = cs.phase_cpp_predict(torch, np, mx, tree, dev,
                                                card, tmp)
                    row["30b_logit_err"] = b["word_lm"]["logit_err_over_max"]
                    row["30b_k4a_launches"] = b["word_lm"]["k4a_launches"]
                except Exception as e:  # a planted fault's way to fail
                    failed.append(("30b raised: %r" % (e,))[:400])
                try:
                    c = cs.phase_cpp_train(torch, np, mx, tree, dev, card,
                                           tmp)
                    row["30c_max_rel_err"] = c["max_rel_err"]
                except Exception as e:  # a planted fault's way to fail
                    failed.append(("30c raised: %r" % (e,))[:400])
        finally:
            cpp_package.build, predict._publish_zip = sound_build, \
                sound_publish
            shutil.rmtree(tmp, ignore_errors=True)
            if work:
                shutil.rmtree(work, ignore_errors=True)
        row.update({"limits": {"30b": cs.LM_EXPORT_RTOL,
                               "30c": cs.CPP_TRAIN_RTOL},
                    "failed": list(failed)})
        print(json.dumps(row), flush=True)
        out.append(row)
    return {"30": out}


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
    ap.add_argument("--phase", choices=("24", "25", "26", "29", "30"),
                    default=None, help="one phase's faults (default: all)")
    phases = {"24", "25", "26", "29", "30"} if ap.parse_args().phase is None \
        else {ap.parse_args().phase}
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
    if "29" in phases:
        readings.update(_phase29(torch, np, dev, card))
    if "30" in phases:
        readings.update(_phase30(torch, np, dev, card))
    print(card)
    print(json.dumps(readings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
