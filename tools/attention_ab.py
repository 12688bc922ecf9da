#!/usr/bin/env python3
"""The attention kernels of two source trees side by side on one card:
K1 (ops/csrc/paged_attention.cu) at chip_smoke.py's timed shapes over
float32, bfloat16 and int8 pools, and K2's forward and backward (ops/csrc/
flash_attention.cu) at the transformer training shape, each built from
both trees, held against this tree's plain versions and against each
other (max |this - base|), and timed by chip_smoke.time_ms in turns
(base, this, this, base), with and without the card's sleep before each
call. With --train, chip_smoke.py's phase 5 (the transformer training
step, flash on) then runs from each tree in a process of its own, in the
same turns, and its step times print beside each other.

    python tools/attention_ab.py BASE_DIR [--train]  # NVIDIA GPU, repo root

BASE_DIR is another checkout, e.g. a parent commit unpacked with
`git archive <commit> | tar -x -C <dir>` into a directory .gitignore
lists. Its sources must keep the C entries mxtt_paged_attention,
mxtt_flash_fwd and mxtt_flash_bwd with this tree's signatures. Each row
prints as a JSON line; the last line holds them all. Imports nothing of
JAX.
"""
import ctypes
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def build(_cuda, src, tag):
    """Load `src` built with the port's nvcc flags (cached by tag)."""
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    out = os.path.join(_cuda.BUILD_DIR, "ab-%s.so" % tag)
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", out, src],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit("build of %s failed:\n%s%s" % (src, r.stdout,
                                                        r.stderr))
    lib = ctypes.CDLL(out)
    _cuda._declare(lib)
    return lib


def paged(torch, pa, lib, q, k, v, tab, qs, bs, ks=None, vs=None):
    """One K1 launch through the C entry (the base tree's gate may
    differ, so the wrapper is bypassed)."""
    B, Tq, H, Dh = q.shape
    out = torch.empty_like(q)
    err = lib.mxtt_paged_attention(
        pa._DTYPE_CODE[q.dtype], pa._POOL_CODE[k.dtype], q.data_ptr(),
        k.data_ptr(), v.data_ptr(), None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(), tab.data_ptr(),
        qs.data_ptr(), out.data_ptr(), B, Tq, H, Dh, tab.shape[1], bs,
        1.0 / math.sqrt(Dh), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def flash_fwd(torch, fa, lib, q, k, v, scale):
    BH, T, D = q.shape
    out = torch.empty_like(q)
    m = torch.empty((BH, T, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    err = lib.mxtt_flash_fwd(
        fa._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), m.data_ptr(), l.data_ptr(), BH, T, k.shape[1], D,
        scale, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out, m, l


def max_diff(a, b):
    """The largest |a - b| over paired tensors."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def flash_bwd(torch, fa, lib, q, k, v, o, m, l, g, scale):
    BH, T, D = q.shape
    delta = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    err = lib.mxtt_flash_bwd(
        fa._DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), g.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH,
        T, k.shape[1], D, scale, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return dq, dk, dv


def in_turns(torch, fns, flush):
    """Mean ms of each of two calls, timed base, this, this, base: a dict
    with "base_ms" and "ms" (the card asleep while the host enqueues) and
    the same two without the sleep (the span of PRs 1-5)."""
    row = {}
    for sleep, suffix in ((True, ""), (False, "_no_sleep")):
        t = {0: [], 1: []}
        for i in (0, 1, 1, 0):
            t[i].append(cs.time_ms(torch, fns[i], n=20, flush=flush,
                                   sleep=sleep))
        row["base_ms" + suffix] = sum(t[0]) / 2
        row["ms" + suffix] = sum(t[1]) / 2
    return row


def main():
    import numpy as np
    import torch
    args = sys.argv[1:]
    if not args or args[1:] not in ([], ["--train"]) \
            or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import paged_attention as pa
    torch.backends.cuda.matmul.allow_tf32 = False
    base_csrc = os.path.join(sys.argv[1], "mxnet_tpu_torch", "ops", "csrc")
    libs = {}
    for src in ("paged_attention.cu", "flash_attention.cu"):
        libs[src] = (build(_cuda, os.path.join(base_csrc, src),
                           "base-" + src[:-3]),
                     _cuda.library(src))
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    rows = []

    def report(row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row))

    pl = libs["paged_attention.cu"]
    cases = [(label, B, Tq, w, qst, bs, dt, None)
             for label, B, Tq, w, qst, bs in cs.PAGED_TIMED
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(label, B, Tq, w, qst, cs.QUANT_BLOCK, dt, "int8")
              for label, B, Tq, w, qst in cs.INT8_CASES
              for dt in (torch.float32, torch.bfloat16)]
    for label, B, Tq, w, qst, bs, dt, pool in cases:
        q, k, v, tab, qs = cs.paged_case(
            torch, np, dev, B, Tq, w, qst,
            dt if pool is None else torch.float32, seed=99, bs=bs)
        sc = ()
        if pool == "int8":
            q = q.to(dt)
            (k, ks), (v, vs) = cs.quantize_pool(torch, k), \
                cs.quantize_pool(torch, v)
            sc = (ks, vs)
        args = (q, k, v, tab, qs, bs) + sc
        ref = pa.paged_attention_plain(
            q, k, v, tab, qs, bs, **(dict(k_scale=sc[0], v_scale=sc[1])
                                     if sc else {}))
        errs = [float((paged(torch, pa, lib, *args).float()
                       - ref.float()).abs().max()) for lib in pl]
        ms = in_turns(torch, [lambda lib=lib: paged(torch, pa, lib, *args)
                              for lib in pl], flush_buf.zero_)
        report({"kernel": "paged_attention", "shape": label,
                "q_dtype": str(dt)[6:], "pool": pool or str(dt)[6:],
                "B": B, "Tq": Tq, "w": w, "bs": bs, **ms,
                "base_max_abs_err": errs[0], "max_abs_err": errs[1]})

    fl = libs["flash_attention.cu"]
    _, BH, T, _, D, _ = cs.FLASH_CASES[0]
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, g = cs.flash_inputs(torch, np, dev, BH, T, T, D, dt, 99)
        scale = D ** -0.5
        want = fa.flash_fwd_plain(q, k, v, scale, True)
        got = [flash_fwd(torch, fa, lib, q, k, v, scale) for lib in fl]
        ms = in_turns(torch, [lambda lib=lib: flash_fwd(
            torch, fa, lib, q, k, v, scale) for lib in fl], None)
        report({"kernel": "flash_attention_fwd", "dtype": str(dt)[6:],
                "BH": BH, "T": T, "D": D, "causal": True, **ms,
                "base_max_abs_err": max_diff(got[0], want),
                "max_abs_err": max_diff(got[1], want),
                "max_abs_this_vs_base": max_diff(got[1], got[0])})
        o, m, l = fa.flash_attention_fwd(q, k, v, scale, True)
        want = fa.flash_bwd_plain(q, k, v, o, m, l, g, scale, True)
        got = [flash_bwd(torch, fa, lib, q, k, v, o, m, l, g, scale)
               for lib in fl]
        ms = in_turns(torch, [lambda lib=lib: flash_bwd(
            torch, fa, lib, q, k, v, o, m, l, g, scale) for lib in fl], None)
        report({"kernel": "flash_attention_bwd", "dtype": str(dt)[6:],
                "BH": BH, "T": T, "D": D, "causal": True, **ms,
                "base_max_abs_err": max_diff(got[0], want),
                "max_abs_err": max_diff(got[1], want),
                "max_abs_this_vs_base": max_diff(got[1], got[0])})
    del flush_buf
    if args[1:]:
        report(train_in_turns(args[0]))
    print(json.dumps({"rows": rows}))
    return 0


#: one run of chip_smoke.py's phase 5 from the tree it is started in
_TRAIN = """
import json, torch, numpy as np, chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
_, main = cs.phase_train(torch, np, dev, cs.nvidia_smi())
print("AB_TRAIN " + json.dumps(main))
"""


def train_in_turns(base_dir):
    """Phase 5 from the base tree and from this one, each in a process of
    its own, in turns (base, this, this, base): each run's step times."""
    runs = {"base": [], "this": []}
    for name, root in (("base", base_dir), ("this", ROOT), ("this", ROOT),
                       ("base", base_dir)):
        r = subprocess.run([sys.executable, "-c", _TRAIN], cwd=root,
                           capture_output=True, text=True)
        line = [ln for ln in r.stdout.splitlines()
                if ln.startswith("AB_TRAIN ")]
        if r.returncode or not line:
            raise SystemExit("phase 5 from %s failed:\n%s%s"
                             % (root, r.stdout[-4000:], r.stderr[-4000:]))
        main = json.loads(line[0][len("AB_TRAIN "):])
        runs[name].append({k: main[k] for k in (
            "step_ms_mean", "step_ms_p50", "flash_fwd_launches",
            "flash_bwd_launches", "grad_rel_err", "loss_last")})
    return {"what": "phase 5 training step, in turns base, this, this, "
            "base", **runs}


if __name__ == "__main__":
    sys.exit(main())
