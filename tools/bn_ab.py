#!/usr/bin/env python3
"""K3d (the fused BatchNorm's dx kernel, ops/csrc/fused_bn.cu) of two
source trees side by side on one card: each built from both trees,
called through its C entry mxtt_bn_bwd_dx at the 13 BatchNorm shapes of
a batch-256 ResNet-50 step in bfloat16 (chip_smoke.R50_BNS) and the
stem's shape in float32, held against this tree's plain version and
against each other (max |this - base|), and timed by chip_smoke.time_ms
in turns (base, this, this, base) with the L2 flushed between calls, as
chip_smoke.bn_time times it. Then the per-step sums over the step's 53
calls.

    python tools/bn_ab.py BASE_DIR   # NVIDIA GPU, from the repo root

BASE_DIR is another checkout (e.g. `git archive <commit> | tar -x -C
<dir>` into a directory .gitignore lists) whose fused_bn.cu keeps the C
entry mxtt_bn_bwd_dx with this tree's signature. Each row prints as a
JSON line; the last line holds them all. Imports nothing of JAX.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import attention_ab as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402


def bn_dx(torch, fb, lib, dz, x, c):
    N, C, S = x.shape
    dx = torch.empty_like(x)
    err = lib.mxtt_bn_bwd_dx(
        fb._DTYPE_CODE[x.dtype], dz.data_ptr(), x.data_ptr(),
        c[0].data_ptr(), c[1].data_ptr(), c[2].data_ptr(), dx.data_ptr(), N,
        C, S, torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return dx


def main():
    import torch
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_bn as fb
    src = os.path.join(sys.argv[1], "mxnet_tpu_torch", "ops", "csrc",
                       "fused_bn.cu")
    libs = (ab.build(_cuda, src, "base-fused_bn"),
            _cuda.library("fused_bn.cu"))
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    scratch = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    rows, total = [], {"base_ms": 0.0, "ms": 0.0, "bound_ms": 0.0}
    cases = [("bfloat16", torch.bfloat16, 2, b) for b in cs.R50_BNS] + \
        [("float32", torch.float32, 4, cs.R50_BNS[0])]
    for dname, dtype, itemsize, (C, H, W, relu, res, count) in cases:
        N, S = cs.R50_BATCH, H * W
        x, dy, r, gamma, beta = cs.bn_inputs(torch, dev, N, C, S, dtype,
                                             seed=C + S)
        k = cs.bn_chain(torch, fb, x, dy, r if res else None, gamma, beta,
                        relu)
        dz, c = k["dz"], k["c"]
        want = fb.bn_bwd_dx_plain(dz, x, *c)
        got = [bn_dx(torch, fb, lib, dz, x, c) for lib in libs]
        t = {0: [], 1: []}
        for i in (0, 1, 1, 0):
            t[i].append(cs.time_ms(torch, lambda lib=libs[i]: bn_dx(
                torch, fb, lib, dz, x, c), n=10, flush=scratch.zero_))
        bound, _ = cs.bn_bound(fb, "bwd_dx", N, C, S, itemsize, relu, res)
        row = {"card": card, "kernel": "fused_bn_bwd_dx", "dtype": dname,
               "N": N, "C": C, "H": H, "W": W, "per_step": count,
               "base_ms": sum(t[0]) / 2, "ms": sum(t[1]) / 2,
               "bound_ms": bound,
               "base_max_abs_err": float((got[0].float() - want.float())
                                         .abs().max()),
               "max_abs_err": float((got[1].float() - want.float())
                                    .abs().max()),
               "max_abs_this_vs_base": float((got[1].float()
                                              - got[0].float()).abs().max()),
               "bits_equal_to_base": bool(torch.equal(got[0], got[1]))}
        if dname == "bfloat16":
            for key in total:
                total[key] += count * row[key]
        rows.append(row)
        print(json.dumps(row))
        del x, dy, r, k, dz, got, want
    summary = {"card": card, "kernel": "fused_bn_bwd_dx",
               "what": "bfloat16, one batch-256 ResNet-50 step's 53 calls",
               **total}
    print(json.dumps(summary))
    print(json.dumps({"rows": rows + [summary]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
