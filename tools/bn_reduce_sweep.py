#!/usr/bin/env python3
"""K3c (the fused BatchNorm's backward reduction, ops/csrc/fused_bn.cu
bn_bwd_reduce_kernel) over its launch choices, on one card: the vectors
in flight a thread (U = 2, 4, 8) and the blocks an SM its launch bounds
ask for (B = 2, 3, 4: the registers a thread may use), each a build of
this tree's source with those two lines edited, at the cluster size the
wrapper's rule picks from that build's own cluster occupancy
(fused_bn._reduce_cluster over mxtt_bn_reduce_max_clusters). The shipped
build (U4B2) is timed once more after a flush that leaves the L2 clean
(`U4B2_clean`): the usual flush writes 256 MB and leaves the 50 MB L2
full of dirty lines, so a call's first reads also write those back.
Every shape of a batch-256 ResNet-50 step in bfloat16 (chip_smoke.R50_BNS)
and its stem in float32, and of a batch-128 Inception-v3 step in float32
(chip_smoke.INC_BNS); each variant's dz held bit equal to the plain
version's and its sums' largest |kernel - plain| recorded, timed by
chip_smoke.time_ms. Then each variant's per-step sums.

    python tools/bn_reduce_sweep.py   # NVIDIA GPU, from the repo root

Each shape prints as a JSON line; the last two lines hold the per-step
sums. Imports nothing of JAX.
"""
import json
import os
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import attention_ab as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402

_U = "  constexpr int U = 4;  // units in flight a thread"
_B = "__launch_bounds__(kReduceThreads, 2)"
#: name -> (U, blocks an SM in the launch bounds)
BUILDS = {"U4B2": (4, 2), "U4B3": (4, 3), "U4B4": (4, 4), "U8B2": (8, 2),
          "U2B2": (2, 2), "U2B4": (2, 4)}


def build_all(_cuda):
    """{name: library} of every variant, built at once."""
    with open(os.path.join(_cuda._CSRC, "fused_bn.cu")) as f:
        src = f.read()
    assert src.count(_U) == 1 and src.count(_B) == 1, \
        "bn_bwd_reduce_kernel's U or launch bounds line not found"
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    libs, errs = {}, {}

    def one(name, U, B):
        path = os.path.join(_cuda.BUILD_DIR, "fused_bn_k3c_%s.cu" % name)
        with open(path, "w") as f:
            f.write(src.replace(_U, _U.replace("U = 4", "U = %d" % U))
                    .replace(_B, _B.replace(", 2)", ", %d)" % B)))
        try:
            libs[name] = ab.build(_cuda, path, "k3c-" + name)
        except SystemExit as e:
            errs[name] = e
    threads = [threading.Thread(target=one, args=(n,) + ub)
               for n, ub in BUILDS.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise SystemExit("builds failed: %s" % errs)
    return libs


def main():
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_bn as fb
    libs = build_all(_cuda)
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    clean = torch.ones(16 << 20, dtype=torch.float32, device=dev)

    def clean_flush():
        scratch.zero_()
        clean.sum()

    at_once = {}

    def cluster(name, dtype, relu, N, C):
        key = (name, dtype, relu)
        if key not in at_once:
            at_once[key] = {P: libs[name].mxtt_bn_reduce_max_clusters(
                fb._DTYPE_CODE[dtype], int(relu), P) for P in (1, 2, 4, 8)}
        return fb._reduce_cluster(N, C, at_once[key])

    def call(lib, dy, y, x, mean, inv, relu, P):
        N, C, S = x.shape
        sdz, sdx = (torch.empty(C, device=dev) for _ in range(2))
        dz = torch.empty_like(dy) if relu else dy
        err = lib.mxtt_bn_bwd_reduce(
            fb._DTYPE_CODE[x.dtype], dy.data_ptr(),
            y.data_ptr() if relu else None, x.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), dz.data_ptr() if relu else None, N, C, S, P,
            None, sdz.data_ptr(), sdx.data_ptr(), stream)
        assert err == 0, err
        return dz, sdz, sdx

    cases = [("resnet50", torch.bfloat16, cs.R50_BATCH, C, H * W, relu,
              count) for C, H, W, relu, _, count in cs.R50_BNS]
    cases.append(("resnet50_stem", torch.float32, cs.R50_BATCH,
                  cs.R50_BNS[0][0], cs.R50_BNS[0][1] * cs.R50_BNS[0][2],
                  False, 1))
    cases += [("inception_v3", torch.float32, cs.INC_BATCH, C, H * W, False,
               count) for C, H, W, count in cs.INC_BNS]
    total = {"resnet50": {}, "inception_v3": {}}
    for step, dtype, N, C, S, relu, count in cases:
        x, dy, y, _, _ = cs.bn_inputs(torch, dev, N, C, S, dtype, seed=C + S)
        mean, var = fb.bn_stats_plain(x)
        inv = torch.rsqrt(var + 1e-5)
        want = fb.bn_bwd_reduce_plain(dy, y, x, mean, inv, relu)
        bound, _ = cs.bn_bound(fb, "bwd_reduce", N, C, S,
                               x.element_size(), relu, False)
        row = {"card": card, "step": step, "dtype": str(dtype)[6:], "N": N,
               "C": C, "S": S, "relu": relu, "per_step": count,
               "bound_ms": bound}
        variants = [(b, b, scratch.zero_) for b in BUILDS] + \
            [("U4B2_clean", "U4B2", clean_flush)]
        for name, b, flush in variants:
            P = cluster(b, dtype, relu, N, C)
            got = call(libs[b], dy, y, x, mean, inv, relu, P)
            torch.cuda.synchronize()
            if not torch.equal(got[0], want[0]):
                raise SystemExit("%s: dz != plain at %s" % (b, row))
            row[name] = {"P": P, "max_abs_err": max(
                float((a - w).abs().max()) for a, w in zip(got[1:],
                                                           want[1:]))}
            row[name]["ms"] = cs.time_ms(torch, lambda: call(
                libs[b], dy, y, x, mean, inv, relu, P), n=20, flush=flush)
            if step in total:
                total[step][name] = total[step].get(name, 0.0) \
                    + count * row[name]["ms"]
        print(json.dumps(row), flush=True)
        del x, dy, y, want
    for step, what in (("resnet50", "bfloat16, one batch-256 ResNet-50 "
                        "step's 53 calls, ms"),
                       ("inception_v3", "float32, one batch-128 "
                        "Inception-v3 step's 94 calls, ms")):
        print(json.dumps({"card": card, "what": what, **total[step]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
