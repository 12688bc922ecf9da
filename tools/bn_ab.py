#!/usr/bin/env python3
"""The fused BatchNorm's kernels (ops/csrc/fused_bn.cu) of two source
trees side by side on one card: each built from both trees and called
through its C entries at the 13 BatchNorm shapes of a batch-256 ResNet-50
step in bfloat16 (chip_smoke.R50_BNS), the stem's shape in float32 and
the 18 BatchNorm shapes of a batch-128 Inception-v3 step in float32
(chip_smoke.INC_BNS, relu and residual off):

- K3a (mxtt_bn_stats): mean and var, each tree's largest |kernel - plain|
  against this tree's plain version;
- K3b (mxtt_bn_apply): y, with bits_equal_to_base;
- K3c (mxtt_bn_bwd_reduce): dz and the channel sums, each tree's largest
  |kernel - plain|, bits_equal_to_base over all three and
  dz_bits_equal_to_base (dz must be bit equal; the sums need not be,
  where the two designs add in another order), and this tree's time at
  every cluster size P (`ms_by_P`);
- K3d (mxtt_bn_bwd_dx): dx, with bits_equal_to_base and max |this - base|.

Every call is timed by chip_smoke.time_ms in turns (base, this, this,
base) with the L2 flushed between calls, as chip_smoke.bn_time times it,
beside its bound (chip_smoke.bn_bound). Then the per-step sums of each
kernel over the ResNet-50 step's 53 calls and the Inception-v3 step's 94.
With --train, chip_smoke.py's phase 9 (ResNet-50 through TrainStep, batch
256) then runs from each tree in a process of its own, in turns (base,
this, this, base): each run's step times, launches and the profiled
step's device time (~1 min a run; the base tree builds its own kernels).
With --inception, phase 16b (Inception-v3 eager and hybridized, float32,
batch 128) runs the same way: each run's step times and each mode's
profiled device time.

    python tools/bn_ab.py BASE_DIR [--train] [--inception]
    # NVIDIA GPU, repo root

BASE_DIR is another checkout (e.g. `git archive <commit> | tar -x -C
<dir>` into a directory .gitignore lists) whose fused_bn.cu keeps the four
C entries with this tree's signatures. The P arguments of K3a and K3c
differ between designs: a tree whose ops/fused_bn.py has `_stats_cluster`
(K3a) or `_reduce_cluster` (K3c) takes a cluster size and no workspace;
an earlier one chunks a channel over a [2, C, P] workspace, sized by that
tree's rule (`base_parts`). Each row prints as a JSON line; the last
line holds them all. Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import attention_ab as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402

KINDS = ("stats", "apply", "bwd_reduce", "bwd_dx")


def base_parts(N, C, S):
    """Chunks per channel of K3a before its cluster design and of K3c
    before its own (ops/fused_bn.py `_parts`): 132 x 32 blocks, at least
    4 elements a thread."""
    return max(1, min(-(-132 * 32 // C), -(-(N * S) // (256 * 4))))


class Tree:
    """One tree's library, and how its K3a and K3c size their grids."""

    def __init__(self, lib, stats_cluster, reduce_cluster):
        self.lib = lib
        self.stats_cluster, self.reduce_cluster = stats_cluster, \
            reduce_cluster

    def stats(self, torch, fb, x):
        N, C, S = x.shape
        f32 = dict(dtype=torch.float32, device=x.device)
        mean, var = torch.empty(C, **f32), torch.empty(C, **f32)
        if self.stats_cluster:
            P, part = fb._stats_cluster(N, C, S, x.element_size()), None
        else:
            P = base_parts(N, C, S)
            part = torch.empty((2, C, P), **f32)
        err = self.lib.mxtt_bn_stats(
            fb._DTYPE_CODE[x.dtype], x.data_ptr(), N, C, S, P, 1.0 / (N * S),
            None if part is None else part.data_ptr(), mean.data_ptr(),
            var.data_ptr(), _stream(torch))
        assert err == 0, err
        return mean, var

    def apply(self, torch, fb, x, scale, offset, r, relu):
        N, C, S = x.shape
        y = torch.empty_like(x)
        err = self.lib.mxtt_bn_apply(
            fb._DTYPE_CODE[x.dtype], x.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), None if r is None else r.data_ptr(),
            y.data_ptr(), N, C, S, int(relu), _stream(torch))
        assert err == 0, err
        return y

    def bwd_reduce(self, torch, fb, dy, y, x, mean, inv, relu, P=None):
        N, C, S = x.shape
        f32 = dict(dtype=torch.float32, device=x.device)
        if self.reduce_cluster:
            P = P or fb._reduce_cluster(N, C, fb.reduce_clusters_at_once(
                x.device, x.dtype, relu))
            part = None
        else:
            P = base_parts(N, C, S)
            part = torch.empty((2, C, P), **f32)
        sdz, sdx = torch.empty(C, **f32), torch.empty(C, **f32)
        dz = torch.empty_like(dy) if relu else dy
        err = self.lib.mxtt_bn_bwd_reduce(
            fb._DTYPE_CODE[x.dtype], dy.data_ptr(),
            y.data_ptr() if relu else None, x.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), dz.data_ptr() if relu else None, N, C, S, P,
            None if part is None else part.data_ptr(), sdz.data_ptr(),
            sdx.data_ptr(), _stream(torch))
        assert err == 0, err
        return dz, sdz, sdx

    def bwd_dx(self, torch, fb, dz, x, c):
        N, C, S = x.shape
        dx = torch.empty_like(x)
        err = self.lib.mxtt_bn_bwd_dx(
            fb._DTYPE_CODE[x.dtype], dz.data_ptr(), x.data_ptr(),
            c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(), dx.data_ptr(),
            N, C, S, _stream(torch))
        assert err == 0, err
        return dx


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


def _max_err(got, want):
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _cases(torch):
    """(step, dtype name, dtype, itemsize, N, C, H, W, relu, residual,
    calls a step) of every timed shape."""
    for C, H, W, relu, res, count in cs.R50_BNS:
        yield ("resnet50", "bfloat16", torch.bfloat16, 2, cs.R50_BATCH, C, H,
               W, relu, res, count)
    C, H, W, relu, res, _ = cs.R50_BNS[0]
    yield ("resnet50_stem", "float32", torch.float32, 4, cs.R50_BATCH, C, H,
           W, relu, res, 1)
    for C, H, W, count in cs.INC_BNS:
        yield ("inception_v3", "float32", torch.float32, 4, cs.INC_BATCH, C,
               H, W, False, False, count)


def compare_kernels(torch, fb, trees, dev, card):
    """Every kernel of both trees at every case: rows and per-step sums.
    Raises if K3c's dz is not bit equal to the base tree's."""
    scratch = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows = []
    steps = {"resnet50": "bfloat16, one batch-256 ResNet-50 step's 53 "
                         "calls of each kernel",
             "inception_v3": "float32, one batch-128 Inception-v3 step's 94 "
                             "calls of each kernel"}
    total = {step: {kind: {"base_ms": 0.0, "ms": 0.0, "bound_ms": 0.0}
                    for kind in KINDS} for step in steps}
    for step, dname, dtype, itemsize, N, C, H, W, relu, res, count in \
            _cases(torch):
        S = H * W
        x, dy, r, gamma, beta = cs.bn_inputs(torch, dev, N, C, S, dtype,
                                             seed=C + S)
        r = r if res else None
        k = cs.bn_chain(torch, fb, x, dy, r, gamma, beta, relu)
        calls = {
            "stats": lambda t: t.stats(torch, fb, x),
            "apply": lambda t: (t.apply(torch, fb, x, k["scale"],
                                        k["offset"], r, relu),),
            "bwd_reduce": lambda t: t.bwd_reduce(
                torch, fb, dy, k["y"], x, k["mean"], k["inv"], relu),
            "bwd_dx": lambda t: (t.bwd_dx(torch, fb, k["dz"], x, k["c"]),)}
        plain = {
            "stats": fb.bn_stats_plain(x),
            "apply": (fb.bn_apply_plain(x, k["scale"], k["offset"], r,
                                        relu),),
            "bwd_reduce": fb.bn_bwd_reduce_plain(dy, k["y"], x, k["mean"],
                                                 k["inv"], relu),
            "bwd_dx": (fb.bn_bwd_dx_plain(k["dz"], x, *k["c"]),)}
        row = {"card": card, "step": step, "dtype": dname, "N": N, "C": C,
               "H": H, "W": W, "relu": relu, "residual": res,
               "per_step": count}
        for kind in KINDS:
            fn = calls[kind]
            got = [fn(t) for t in trees]
            t = {0: [], 1: []}
            for i in (0, 1, 1, 0):
                t[i].append(cs.time_ms(torch, lambda tr=trees[i]: fn(tr),
                                       n=10, flush=scratch.zero_))
            bound, _ = cs.bn_bound(fb, kind, N, C, S, itemsize, relu, res)
            one = {"base_ms": sum(t[0]) / 2, "ms": sum(t[1]) / 2,
                   "bound_ms": bound,
                   "base_max_abs_err": _max_err(got[0], plain[kind]),
                   "max_abs_err": _max_err(got[1], plain[kind]),
                   "max_abs_this_vs_base": _max_err(got[1], got[0]),
                   "bits_equal_to_base": all(
                       torch.equal(a, b) for a, b in zip(got[0], got[1]))}
            one["over_bound"] = one["ms"] / bound
            one["base_over_bound"] = one["base_ms"] / bound
            if kind == "bwd_reduce":
                one["dz_bits_equal_to_base"] = torch.equal(got[0][0],
                                                           got[1][0])
                if not one["dz_bits_equal_to_base"]:
                    raise SystemExit("K3c's dz differs from the base tree's "
                                     "at %s" % json.dumps(row))
                one["ms_by_P"] = {
                    P: cs.time_ms(torch, lambda P=P: trees[1].bwd_reduce(
                        torch, fb, dy, k["y"], x, k["mean"], k["inv"], relu,
                        P), n=10, flush=scratch.zero_)
                    for P in (1, 2, 4, 8) if P <= N}
            row[kind] = one
            if step in total:
                for key in total[step][kind]:
                    total[step][kind][key] += count * one[key]
            del got
        rows.append(row)
        print(json.dumps(row))
        del x, dy, r, k, calls, plain
    for step, what in steps.items():
        for kind in KINDS:
            tot = total[step][kind]
            tot["over_bound"] = tot["ms"] / tot["bound_ms"]
            tot["base_over_bound"] = tot["base_ms"] / tot["bound_ms"]
        summary = {"card": card, "what": what, **total[step]}
        print(json.dumps(summary))
        rows.append(summary)
    return rows


def main():
    import torch
    args = sys.argv[1:]
    if not args or not set(args[1:]) <= {"--train", "--inception"} \
            or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_bn as fb
    ops = os.path.join(args[0], "mxnet_tpu_torch", "ops")
    with open(os.path.join(ops, "fused_bn.py")) as f:
        src = f.read()
    trees = (Tree(ab.build(_cuda, os.path.join(ops, "csrc", "fused_bn.cu"),
                           "base-fused_bn"), "def _stats_cluster(" in src,
                  "def _reduce_cluster(" in src),
             Tree(_cuda.library("fused_bn.cu"), True, True))
    dev = torch.device("cuda", 0)
    rows = compare_kernels(torch, fb, trees, dev, cs.nvidia_smi())
    for flag, phase in (("--train", "resnet"), ("--inception", "inception")):
        if flag in args[1:]:
            turns = in_turns(args[0], phase)
            print(json.dumps(turns))
            rows.append(turns)
    print(json.dumps({"rows": rows}))
    return 0


#: one run of a chip_smoke.py phase from the tree it is started in
_RUN = """
import json, torch, numpy as np, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_, main = cs.phase_%s(torch, np, dev, cs.nvidia_smi())
print("AB_RUN " + json.dumps(main))
"""
#: the profile lines each phase prints, by name
_PROFILES = {"resnet": {"train": "resnet50 train profile: "},
             "inception": {m: "inception_v3 gluon %s train profile: " % m
                           for m in ("eager", "hybridized")}}


def _summary(phase, main, busy):
    """What a run of the phase reports: step times, launches, device
    time of each profiled step."""
    if phase == "resnet":
        return {"step_ms_mean": main["fused_bn_epilogue"]["step_ms_mean"],
                "step_ms_p50": main["fused_bn_epilogue"]["step_ms_p50"],
                "flag_off_step_ms_mean": main["flag_off"]["step_ms_mean"],
                "k3_launches": main["k3_launches"],
                "device_busy_ms": busy["train"].get("device_busy_ms"),
                "host_ms_profiled": busy["train"].get("host_ms_profiled")}
    return {m: {"step_ms_mean": main[m]["step_ms_mean"],
                "step_ms_p50": main[m]["step_ms_p50"],
                "device_busy_ms": busy[m].get("device_busy_ms"),
                "host_ms_profiled": busy[m].get("host_ms_profiled")}
            for m in ("eager", "hybridized")}


def in_turns(base_dir, phase):
    """Phase 9 (`resnet`) or 16b (`inception`) from the base tree and
    from this one, each in a process of its own, in turns (base, this,
    this, base)."""
    runs = {"base": [], "this": []}
    for name, root in (("base", base_dir), ("this", ROOT), ("this", ROOT),
                       ("base", base_dir)):
        r = subprocess.run([sys.executable, "-c", _RUN % phase], cwd=root,
                           capture_output=True, text=True)
        out = r.stdout.splitlines()
        line = [ln for ln in out if ln.startswith("AB_RUN ")]
        if r.returncode or not line:
            raise SystemExit("phase_%s from %s failed:\n%s%s"
                             % (phase, root, r.stdout[-4000:],
                                r.stderr[-4000:]))
        busy = {}
        for key, head in _PROFILES[phase].items():
            prof = [ln for ln in out if ln.startswith(head)]
            busy[key] = json.loads(prof[0][len(head):]) if prof else {}
        runs[name].append(_summary(phase, json.loads(line[0][7:]), busy))
    what = {"resnet": "phase 9 ResNet-50 bf16 step",
            "inception": "phase 16b Inception-v3 f32 step, eager and "
                         "hybridized"}[phase]
    return {"what": what + ", in turns base, this, this, base", **runs}


if __name__ == "__main__":
    sys.exit(main())
