#!/usr/bin/env python3
"""K3a (the fused BatchNorm's statistics kernel, ops/csrc/fused_bn.cu
bn_stats_kernel) over its launch choices, on one card: the vectors in
flight a thread (U = 2, 4, 8) and the threads a block (256, 512), each
a build of this tree's source with that line edited, at the wrapper's
cluster size; and every cluster size P (blocks a channel group: 1, 2, 4,
8) through the C entry mxtt_bn_stats at 256 and 512 threads, at the 13
BatchNorm shapes of a batch-256 ResNet-50 step in bfloat16
(chip_smoke.R50_BNS) and the stem's in float32. Each variant is held
against the plain version (largest |kernel - plain| of mean and var) and
timed by chip_smoke.time_ms with the L2 flushed between calls. The
flush writes 256 MB, which leaves the 50 MB L2 full of dirty lines; the
`U4_clean` column times the wrapper's launch after a flush that then
reads 64 MB more, so that the L2 holds clean lines and the kernel's
reads evict nothing that must be written back. Then the per-step sums of
each variant over the step's 53 calls.

    python tools/bn_stats_sweep.py   # NVIDIA GPU, from the repo root

Each shape prints as a JSON line with the wrapper's P (`P0`); the last
line holds the per-step sums. Imports nothing of JAX.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import attention_ab as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402

CLUSTERS = (1, 2, 4, 8)
_U = "  constexpr int U = 4;\n  constexpr int V = Vec<T>::V;"
_THREADS = "constexpr int kStatsThreads = 256;"
#: name -> (U, threads a block)
BUILDS = {"U2": (2, 256), "U4": (4, 256), "U8": (8, 256), "T512": (4, 512)}


def main():
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_bn as fb
    with open(os.path.join(_cuda._CSRC, "fused_bn.cu")) as f:
        src = f.read()
    assert src.count(_U) == 1 and src.count(_THREADS) == 1, \
        "bn_stats_kernel's U or kStatsThreads line not found"
    libs = {}
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    for name, (U, threads) in BUILDS.items():
        path = os.path.join(_cuda.BUILD_DIR, "fused_bn_%s.cu" % name)
        with open(path, "w") as f:
            f.write(src.replace(_U, _U.replace("U = 4", "U = %d" % U))
                    .replace(_THREADS, _THREADS.replace("256", str(threads))))
        libs[name] = ab.build(_cuda, path, "k3a-" + name)
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    scratch = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    clean = torch.ones(16 << 20, dtype=torch.float32, device=dev)

    def clean_flush():
        scratch.zero_()
        clean.sum()

    def call(lib, x, P):
        N, C, S = x.shape
        mean, var = (torch.empty(C, device=dev) for _ in range(2))
        err = lib.mxtt_bn_stats(
            fb._DTYPE_CODE[x.dtype], x.data_ptr(), N, C, S, P,
            1.0 / (N * S), None, mean.data_ptr(), var.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return mean, var

    cases = [(torch.bfloat16, b) for b in cs.R50_BNS] + \
        [(torch.float32, cs.R50_BNS[0])]
    total = {}
    for dtype, (C, H, W, relu, res, count) in cases:
        N, S = cs.R50_BATCH, H * W
        x = cs.bn_inputs(torch, dev, N, C, S, dtype, seed=C + S)[0]
        P0 = fb._stats_cluster(N, C, S, x.element_size())
        pm, pv = fb.bn_stats_plain(x)
        row = {"card": card, "dtype": str(dtype).split(".")[-1], "C": C,
               "S": S, "per_step": count, "P0": P0}
        variants = [(b, b, P0, scratch.zero_) for b in BUILDS] + \
            [("%sP%d" % (b, P), b, P, scratch.zero_) for b in ("U4", "T512")
             for P in CLUSTERS] + [("U4_clean", "U4", P0, clean_flush)]
        for name, b, P, flush in variants:
            m, v = call(libs[b], x, P)
            row[name + "_max_abs_err"] = max(
                float((m - pm).abs().max()), float((v - pv).abs().max()))
            row[name + "_ms"] = cs.time_ms(
                torch, lambda: call(libs[b], x, P), n=20, flush=flush)
            if dtype == torch.bfloat16:
                total[name] = total.get(name, 0.0) + count * row[name + "_ms"]
        print(json.dumps(row), flush=True)
        del x
    print(json.dumps({"card": card, "what": "bfloat16, one batch-256 "
                      "ResNet-50 step's 53 calls, ms", **total}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
