#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases on the card, after building the
kernels, in the order given: each NAME is a `chip_smoke.phase_<NAME>`
that takes (torch, np, dev, card). `deploy` keeps phase 29a's ResNet-50
artifact for a later `cpp`, as main() does. `--consistency` first runs
the two check_consistency cases of phases 12b and 21a (bn_convnet and
sym.RNN lstm over [cpu, gpu(0)] at chip_smoke.CONSIST_SCALE), bn_convnet
with cuDNN off and on, printing each one's largest errors and launches,
a mismatch included. The AOT cache is configured to a temporary
directory before the build, as main() does; `cpp` keeps 30b's word-LM
artifact for a later `watchdog` (phase 31), and `watchdog` 31c's for a
later `cli` (phase 32, which exports its own when run without it).

    python3 tools/smoke_phases.py --consistency resilience deploy cpp
    python3 tools/smoke_phases.py cpp watchdog cli
    python3 tools/smoke_phases.py cli

Needs an NVIDIA GPU; run from the repository root. Imports nothing of
JAX. Prints the card's name and power limit first, and each phase's
`phase time:` line.
"""
import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def consistency(torch, cs, mx, dev):
    from mxnet_tpu_torch.ops import fused_bn as fb
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    try:
        for cudnn in (False, True):
            try:
                cs.consistency_check(
                    torch, mx, dev, "bn_convnet", cs.bn_convnet(mx.sym),
                    {"data": (cs.CONSIST_BN_BATCH, 1, 28, 28)},
                    fb.launch_counts, (2,) * 4, cudnn=cudnn)
            except (AssertionError, cs.SmokeFailure) as e:
                print("bn_convnet, cudnn %s: %s" % (cudnn, e))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    try:
        cs.consistency_rnn(torch, mx, dev)
    except (AssertionError, cs.SmokeFailure) as e:
        print("sym.RNN: %s" % e)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*")
    ap.add_argument("--consistency", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.nvidia_smi()
    print(card, flush=True)
    from mxnet_tpu_torch import aot
    aot_dir = tempfile.mkdtemp(prefix="mxtt_aot_")
    aot.configure(aot_dir)
    run = cs.PhaseClock()
    run(cs.build_kernels, _cuda)
    if args.consistency:
        run(consistency, torch, cs, mx, dev)
    keep = tempfile.mkdtemp(prefix="mxtt_r50_")
    carry = cpp = watch = None
    try:
        for name in args.phases:
            extra = ()
            if name == "deploy":
                extra = (keep,)
            elif name == "cpp":
                extra = (carry, keep)
            elif name == "watchdog":
                extra = (cpp, keep)
            elif name == "cli":
                extra = (watch,)
            out = run(getattr(cs, "phase_" + name), torch, np, dev, card,
                      *extra)
            if name == "deploy":
                carry = out[2]["29a"]["carry"]
            elif name == "cpp":
                cpp = out[1]["carry"]
            elif name == "watchdog":
                watch = out[1]["carry"]
    except cs.SmokeFailure as e:
        print("FAIL: %s" % e, file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(keep, ignore_errors=True)
        shutil.rmtree(aot_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
