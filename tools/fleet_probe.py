#!/usr/bin/env python3
"""Where a fleet of serving replicas on one card loses its throughput.

    python3 tools/fleet_probe.py            # from the repository root, on a card

Runs chip_smoke.py phase 23a's traffic (24 requests of mixed length from
6 client threads, phase 4's config on K1) through one `LMServer` and
through `serve(replicas=N)` for N = 1, 2, 3, each at the interpreter's
default thread switch interval (5 ms) and at 0.5 ms
(`sys.setswitchinterval`), in two passes of turns (the order reversed in
the second). Every replica's loop shares one interpreter: a torch call
releases the interpreter lock around its dispatch, and a thread that
wants it back can wait up to a switch interval while another thread
runs Python. Per run it prints tokens/s, TTFT p50, the replicas' decode
step p50 and the number of steps; each run's greedy tokens are checked
against the gather oracle as in phase 23a.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def run(serving, params, cfg, work, kw, replicas, switch):
    """One pass of the traffic; returns (numbers, results)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(switch)
    try:
        srv = serving.serve((params, cfg), replicas=replicas, **kw) \
            if replicas else serving.LMServer((params, cfg), **kw)
        try:
            results, reqs, errors, wall = cs.fleet_clients(
                srv, work, cs.FLEET_CLIENTS)
            reps = getattr(srv, "replicas", [srv])
            snaps = [r.snapshot() for r in reps]
        finally:
            srv.close(timeout=cs.FLEET_WAIT_S)
    finally:
        sys.setswitchinterval(old)
    cs.check(not errors, "requests failed: %r" % errors[:4])
    tokens = sum(len(o[0]) for o in results.values())
    ttfts = sorted(r.t_first_token - r.t_submit for r in reqs)
    return {"server": "LMServer" if not replicas else
            "serve(replicas=%d)" % replicas, "switch_ms": 1e3 * switch,
            "tokens_per_s": tokens / wall, "wall_s": wall,
            "ttft_p50_ms": 1e3 * ttfts[len(ttfts) // 2],
            "decode_step_p50_ms": [s["latency_ms"]["decode_step_p50"]
                                   for s in snaps],
            "decode_steps": [s["throughput"]["decode_steps"]
                             for s in snaps]}, results


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: this probe needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import _cuda
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.nvidia_smi()
    print("device: %s" % card)
    _cuda.library("paged_attention.cu")
    cfg = TransformerConfig(dtype=torch.float32, **cs.BENCH_CFG)
    params = params_from_numpy(cs.bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(23)
    work = cs.fleet_work(np, rng, cs.FLEET_REQUESTS, cs.FLEET_PROMPT,
                         cs.FLEET_GEN, cfg.vocab)
    ref, margins = cs.gather_oracle(torch, np, serving, params, cfg,
                                    [p for p, _ in work],
                                    max(g for _, g in work), dev)
    kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256)
    configs = [(n, sw) for sw in (0.005, 0.0005) for n in (0, 1, 2, 3)]
    run(serving, params, cfg, work, kw, 0, 0.005)          # warm-up
    rows = []
    for order in (configs, configs[::-1]):
        for n, sw in order:
            t0 = time.perf_counter()
            nums, results = run(serving, params, cfg, work, kw, n, sw)
            cs.check_fleet_tokens("probe", results, list(range(len(work))),
                                  ref, margins)
            nums["card"] = card
            rows.append(nums)
            print("fleet probe: " + json.dumps(nums), flush=True)
            if time.perf_counter() - t0 > 120:
                print("fleet probe: stopping, a run took over 120 s")
                return 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
