#!/usr/bin/env python3
"""The fused-RNN scan kernels (ops/csrc/fused_rnn.cu, K4a and K4b) of two
source trees side by side on one card: each built from both trees and
called through its C entries (mxtt_rnn_fwd, mxtt_rnn_bwd) on the same
inputs (fused_rnn.check_inputs), lstm, at the word LM's shape (T 35, N 32,
H 200) in bfloat16 and float32, bench_lstm_sweep's H 256 and the ragged
shapes of chip_smoke.RNN_SHAPES (plus N 33) in bfloat16:

- each tree's K4a, then its K4b on its own K4a's outputs, held to this
  tree's plain versions fed with those outputs (fused_rnn.fed_plain):
  the largest |kernel - plain| of each tree;
- each call timed by chip_smoke.time_ms in turns (base, this, this,
  base), K4b on this tree's K4a outputs for both trees; this tree's
  design, and its serial floor (mxtt_rnn_floor) where it takes the
  cluster design.

With --train, chip_smoke.py's phase 11 (the word LM through TrainStep)
then runs from each tree in a process of its own, in turns (base, this,
this, base; --turns N repeats that block N times): each run's bf16 step
times, K4 launches and the profiled step's device time. --train-only
runs just that (for trees whose kernels are the same).
tools/rnn_design_sweep.py compares this tree's designs with each other.

    python tools/rnn_ab.py BASE_DIR [--train | --train-only] [--turns N]

BASE_DIR is another checkout (e.g. `git archive <commit> | tar -x -C
<dir>` into a directory .gitignore lists). A base tree whose
ops/fused_rnn.py has no `rnn_design` takes the streaming design's C
entries (batch rows a block, no cluster size, no dWh workspace); one
that has it is called with this tree's choice of design. Each row prints
as a JSON line; the last line holds them all. Imports nothing of JAX.
"""
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import attention_ab as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int

#: (label, T, N, H, dtype name): the path's shape in both dtypes, H 256,
#: the ragged shapes
SHAPES = ([("path", 35, 32, 200, "bfloat16"), ("path", 35, 32, 200, "float32"),
           ("H256", 35, 32, 256, "bfloat16")]
          + [("ragged", T, N, H, "bfloat16") for T, N, H in
             cs.RNN_SHAPES[2:] + [(35, 33, 200)]])


class Tree:
    """One tree's library and its C entries' signatures."""

    def __init__(self, lib, designs):
        self.lib, self.designs = lib, designs
        if not designs:  # the streaming design's signatures
            lib.mxtt_rnn_fwd.argtypes = [_I, _I] + [_P] * 8 + [_I] * 5 + [_P]
            lib.mxtt_rnn_bwd.argtypes = [_I, _I] + [_P] * 13 + [_I] * 5 + [_P]

    def _shape_args(self, fr, mode, N, H, dtype):
        if self.designs:
            d = fr.rnn_design(mode, N, H, dtype)
            return [d.rows, d.P], (d.blocks // d.P if d.P else 1)
        return [fr.batch_tile(N)], 1

    def fwd(self, torch, fr, a):
        T, N, H = a["dys"].shape
        dt = a["px"].dtype
        ys, cs_ = torch.empty_like(a["dys"]), torch.empty_like(a["dys"])
        hT, cT = torch.empty_like(a["h0"]), torch.empty_like(a["h0"])
        shape, _ = self._shape_args(fr, "lstm", N, H, dt)
        err = self.lib.mxtt_rnn_fwd(
            fr._DTYPE_CODE[dt], 0, a["px"].data_ptr(), a["h0"].data_ptr(),
            a["c0"].data_ptr(), a["wh"].data_ptr(), ys.data_ptr(),
            cs_.data_ptr(), hT.data_ptr(), cT.data_ptr(), T, N, H, *shape, 0,
            _stream(torch))
        assert err == 0, err
        return ys, cs_, hT, cT

    def bwd(self, torch, fr, a, ys, cs_):
        T, N, H = a["dys"].shape
        dt = a["px"].dtype
        hprev = fr._shift_prev(a["h0"], ys, False)
        cprev = fr._shift_prev(a["c0"], cs_, False)
        dpx = torch.empty_like(a["px"])
        dh0, dc0 = torch.empty_like(a["h0"]), torch.empty_like(a["h0"])
        f32 = dict(dtype=torch.float32, device=a["px"].device)
        dwh = torch.empty((4 * H, H), **f32)
        shape, clusters = self._shape_args(fr, "lstm", N, H, dt)
        ptrs = [a["px"].data_ptr(), None, hprev.data_ptr(), cprev.data_ptr(),
                cs_.data_ptr(), a["wh"].data_ptr(), a["dys"].data_ptr(),
                a["dhT"].data_ptr(), a["dcT"].data_ptr(), dpx.data_ptr(),
                dh0.data_ptr(), dc0.data_ptr(), dwh.data_ptr()]
        if self.designs:
            work = (torch.empty((clusters, 4 * H, H), **f32)
                    if clusters > 1 else None)
            ptrs.append(None if work is None else work.data_ptr())
        err = self.lib.mxtt_rnn_bwd(fr._DTYPE_CODE[dt], 0, *ptrs, T, N, H,
                                    *shape, 0, _stream(torch))
        assert err == 0, err
        return dpx, dh0, dc0, dwh


def _stream(torch):
    return torch.cuda.current_stream().cuda_stream


def _max_err(fr, a, outs):
    """Largest |kernel - plain| over K4a's and K4b's outputs, the plain
    versions fed with the kernel's own (fused_rnn.fed_plain)."""
    got = dict(zip(fr.OUTPUTS, outs))
    want = fr.fed_plain("lstm", a, got)
    return max(fr.plain_error(got[n], want[n])[2] for n in fr.OUTPUTS)


def compare(torch, fr, trees, dev, card):
    rows = []
    for label, T, N, H, dname in SHAPES:
        dtype = getattr(torch, dname)
        a = fr.check_inputs("lstm", T, N, H, dtype, seed=T + N + H,
                            device=dev)
        errs = []
        for tr in trees:
            f = tr.fwd(torch, fr, a)
            errs.append(_max_err(fr, a, f + tr.bwd(torch, fr, a, f[0], f[1])))
        ys, cs_ = trees[1].fwd(torch, fr, a)[:2]
        t = {"fwd": {0: [], 1: []}, "bwd": {0: [], 1: []}}
        for i in (0, 1, 1, 0):
            t["fwd"][i].append(cs.time_ms(
                torch, lambda tr=trees[i]: tr.fwd(torch, fr, a), 20))
            t["bwd"][i].append(cs.time_ms(
                torch, lambda tr=trees[i]: tr.bwd(torch, fr, a, ys, cs_), 20))
        d = fr.rnn_design("lstm", N, H, dtype)
        row = {"card": card, "shape": label, "T": T, "N": N, "H": H,
               "dtype": dname, "design": d.name, "P": d.P, "rows": d.rows,
               "base_max_abs_err": errs[0], "max_abs_err": errs[1]}
        for kind in ("fwd", "bwd"):
            b_ms, b_by = cs.rnn_bound(fr, kind, T, N, H, dname, dtype)
            row[kind] = {"base_ms": sum(t[kind][0]) / 2,
                         "ms": sum(t[kind][1]) / 2,
                         "base_ms_turns": t[kind][0],
                         "ms_turns": t[kind][1], "bound_ms": b_ms,
                         "bound_by": b_by}
        if d.name == "cluster":
            row["serial_floor_ms"] = cs.time_ms(
                torch, fr.serial_floor("lstm", T, N, H, dtype, dev), 20)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main():
    import torch
    args = sys.argv[1:]
    turns = 1
    if "--turns" in args:
        i = args.index("--turns")
        turns = int(args[i + 1])
        del args[i:i + 2]
    flags = set(args[1:])
    if not args or not flags <= {"--train", "--train-only"} \
            or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    if "--train-only" in flags:
        train = train_in_turns(args[0], turns)
        print(json.dumps({"rows": [train]}))
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_rnn as fr
    ops = os.path.join(args[0], "mxnet_tpu_torch", "ops")
    with open(os.path.join(ops, "fused_rnn.py")) as f:
        base_designs = "def rnn_design(" in f.read()
    lib = _cuda.library("fused_rnn.cu")
    trees = (Tree(ab.build(_cuda, os.path.join(ops, "csrc", "fused_rnn.cu"),
                           "base-fused_rnn"), base_designs),
             Tree(lib, True))
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    rows = compare(torch, fr, trees, dev, card)
    if "--train" in flags:
        train = train_in_turns(args[0], turns)
        print(json.dumps(train))
        rows.append(train)
    print(json.dumps({"rows": rows}))
    return 0


#: one run of chip_smoke.py's phase 11 from the tree it is started in
_TRAIN = """
import json, torch, numpy as np, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
_, main = cs.phase_word_lm(torch, np, dev, cs.nvidia_smi())
print("AB_TRAIN " + json.dumps(main))
"""
_PROFILE = "word_lm train profile: "


def train_in_turns(base_dir, turns=1):
    """Phase 11 from the base tree and from this one, each in a process of
    its own, in turns (base, this, this, base, `turns` times): each run's
    bf16 step times (flag on and off), K4 launches and the profiled
    step's device time."""
    runs = {"base": [], "this": []}
    for name, root in (("base", base_dir), ("this", ROOT), ("this", ROOT),
                       ("base", base_dir)) * turns:
        r = subprocess.run([sys.executable, "-c", _TRAIN], cwd=root,
                           capture_output=True, text=True)
        out = r.stdout.splitlines()
        line = [ln for ln in out if ln.startswith("AB_TRAIN ")]
        prof = [ln for ln in out if ln.startswith(_PROFILE)]
        if r.returncode or not line:
            raise SystemExit("phase 11 from %s failed:\n%s%s"
                             % (root, r.stdout[-4000:], r.stderr[-4000:]))
        main = json.loads(line[0][len("AB_TRAIN "):])
        busy = json.loads(prof[0][len(_PROFILE):]) if prof else {}
        runs[name].append({
            "step_ms_mean": main["fused_rnn"]["step_ms_mean"],
            "step_ms_p50": main["fused_rnn"]["step_ms_p50"],
            "flag_off_step_ms_mean": main["flag_off"]["step_ms_mean"],
            "k4_launches": main["k4_launches"],
            "device_busy_ms": busy.get("device_busy_ms"),
            "host_ms_profiled": busy.get("host_ms_profiled"),
            "kernels_us": busy.get("kernels_us")})
    return {"what": "phase 11 word-LM bf16 step, in turns base, this, "
            "this, base (%d times)" % turns, **runs}


if __name__ == "__main__":
    sys.exit(main())
