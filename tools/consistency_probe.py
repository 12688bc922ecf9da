#!/usr/bin/env python3
"""How well conditioned chip_smoke.py's check_consistency cases are: each
case (phase 12b's bn_convnet at batch CONSIST_BN_BATCH, phase 21a's
sym.RNN lstm at the word LM's layer) bound twice on one device with
check_consistency's seeding at each scale, the second time with every
input and parameter moved by one float32 ulp (alternating signs). The
largest change of the outputs and of the gradients is printed as a
fraction of check_consistency's tol (1e-3, relative and absolute): a
case whose one-ulp change passes 1 cannot be held across devices, whose
float32 sums round in other orders.

    python3 tools/consistency_probe.py [--device cpu|cuda] [--scale 1 0.1]

Runs the kernels' plain versions on the CPU, the kernels on the card.
Imports nothing of JAX.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def run_case(np, sym, shapes, scale, ctx, nudge):
    """Outputs and gradients of check_consistency's run of `sym` on ctx at
    `scale`, every array moved by one ulp when `nudge`."""
    exe = sym.simple_bind(ctx, grad_req="write", **shapes)
    np.random.seed(0)
    values = {}
    for k in sorted(exe.arg_dict):
        if k not in shapes:
            values[k] = np.random.normal(
                0, scale, exe.arg_dict[k].shape).astype(np.float32)
    np.random.seed(1)
    for k in sorted(shapes):
        values[k] = np.random.normal(0, scale, shapes[k]).astype(np.float32)
    for k, v in values.items():
        if nudge:
            sign = np.where(np.arange(v.size).reshape(v.shape) % 2, 1, -1)
            v = np.nextafter(v, (sign * np.inf).astype(np.float32))
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    outs = [o.asnumpy() for o in exe.outputs]
    exe.backward()
    return outs, {k: g.asnumpy() for k, g in exe.grad_dict.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--scale", type=float, nargs="+", default=[1.0, 0.1])
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import test_utils as tu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.device == "cuda":
        print(cs.nvidia_smi(), flush=True)
    ctx = mx.cpu() if args.device == "cpu" else mx.gpu(0)
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    os.environ["MXNET_FUSED_RNN"] = "1"
    with mx.name.NameManager():
        cases = {
            "bn_convnet": (cs.bn_convnet(mx.sym),
                           {"data": (cs.CONSIST_BN_BATCH, 1, 28, 28)}),
            "sym.RNN lstm": (mx.sym.RNN(
                mx.sym.Variable("data"), mode="lstm",
                state_size=cs.LM_HIDDEN, num_layers=cs.LM_LAYERS,
                name="lstm"), {"data": (cs.LM_BPTT, cs.LM_BATCH,
                                        cs.LM_EMBED)})}
    tol = 1e-3
    with ctx:
        for name, (sym, shapes) in cases.items():
            for scale in args.scale:
                base = run_case(np, sym, shapes, scale, ctx, False)
                moved = run_case(np, sym, shapes, scale, ctx, True)
                err = {
                    "outputs": max(float(tu.find_max_violation(
                        a.astype(np.float64), b.astype(np.float64), tol,
                        tol)[1]) for a, b in zip(moved[0], base[0])),
                    "grads": max(float(tu.find_max_violation(
                        moved[1][k].astype(np.float64),
                        base[1][k].astype(np.float64), tol, tol)[1])
                        for k in base[1])}
                print(json.dumps({"case": name, "device": args.device,
                                  "scale": scale,
                                  "one_ulp_change_fraction_of_tol": err}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
