#!/usr/bin/env python
"""Measure transfer and collective bandwidth (port of tools/bandwidth.py,
itself the reference MXNet's multi-device kvstore all-reduce benchmark):

  1. host -> device staging bandwidth: a pinned float64 buffer of
     --size-mb copied to the card --iters times, timed to the copies'
     completion;
  2. all-reduce bandwidth over a torch.distributed world of --world
     ranks, one process each (parallel/launch.run_world): NCCL over the
     card(s) with --device cuda (default: one rank a card), gloo over the
     CPU with --device cpu (default one rank). A world of one rank still
     runs the collective through the backend and reports the degenerate
     number plainly.

    python -m mxnet_tpu_torch.tools.bandwidth                     # the card
    python -m mxnet_tpu_torch.tools.bandwidth --device cpu --world 4

On the CPU the staging leg copies between host buffers: those numbers
are host-memory speeds, not the card's.
"""
import argparse
import sys
import time

from mxnet_tpu_torch.tools import add_device_flag, require_device


def human(bps):
    for unit in ("B/s", "KB/s", "MB/s", "GB/s"):
        if bps < 1024:
            return "%.2f %s" % (bps, unit)
        bps /= 1024.0
    return "%.2f TB/s" % bps


def bench_host_device(torch, device, size_mb, iters):
    """(bytes/s, checksum): --iters copies of a size_mb host buffer (pinned
    when the target is the card) to `device`, timed to their completion."""
    import numpy as np
    x = torch.from_numpy(np.random.RandomState(0).rand(size_mb * 1024 * 128))
    if device.type == "cuda":
        x = x.pin_memory()
    dst = torch.empty_like(x, device=device)
    dst.copy_(x, non_blocking=True)          # warm
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(iters):
        dst.copy_(x, non_blocking=True)
    _sync(torch, device)
    dt = time.perf_counter() - t0
    return x.numel() * x.element_size() * iters / dt, float(dst[0])


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def allreduce_rank(size_mb, iters):
    """One rank of the all-reduce leg (run by parallel/launch.run_world
    in a world already up): (per-replica payload bytes/s, world size,
    checksum, backend). Chained: each reduce feeds the next, scaled by
    1/n."""
    import torch
    import torch.distributed as dist
    from mxnet_tpu_torch.parallel.mesh import world_info
    info = world_info()
    n = info["world_size"]
    device = (torch.device("cuda", torch.cuda.current_device())
              if info["device_type"] == "cuda" else torch.device("cpu"))
    elems = size_mb * 1024 * 256                  # f32 elements a MB
    g = torch.Generator().manual_seed(1 + dist.get_rank())
    out = torch.rand(elems, generator=g).to(device)
    dist.all_reduce(out)                          # warm
    _sync(torch, device)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(iters):
        out.mul_(1.0 / n)
        dist.all_reduce(out)
    s = float(out[:1].sum())
    dt = time.perf_counter() - t0
    # algorithm bytes: each replica contributes size and receives size
    return elems * 4 * iters / dt, n, s, info["backend"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size-mb", type=int, default=16,
                    help="payload per transfer/reduce")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--world", type=int, default=None,
                    help="ranks of the all-reduce world (default: the "
                         "card count with --device cuda, 1 on the CPU)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    require_device(args.device)
    import torch
    from mxnet_tpu_torch.parallel.launch import run_world
    device = torch.device("cuda", 0) if args.device == "cuda" \
        else torch.device("cpu")
    if args.device == "cuda":
        print("devices: %d x %s" % (torch.cuda.device_count(),
                                     torch.cuda.get_device_name(0)))
    else:
        print("devices: cpu")
    world = args.world or (torch.cuda.device_count()
                           if args.device == "cuda" else 1)

    bw, _ = bench_host_device(torch, device, args.size_mb, args.iters)
    print("host->device staging : %s (%d MB x %d)"
          % (human(bw), args.size_mb, args.iters))

    results = run_world("mxnet_tpu_torch.tools.bandwidth:allreduce_rank",
                        world, (args.size_mb, args.iters),
                        device=args.device)
    bw = min(r[0] for r in results)
    n = results[0][1]
    print("allreduce over %d dev : %s per-replica payload bandwidth (%s)"
          % (n, human(bw), results[0][3]))
    if n == 1:
        print("(single rank: the reduce moves nothing between ranks; run "
              "a world of several for a meaningful number)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
