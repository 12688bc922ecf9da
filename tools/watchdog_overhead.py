#!/usr/bin/env python3
"""The compile watchdog's cost on one serving decode step, measured in
one process on the card: phase 4's model (chip_smoke.BENCH_CFG, float32,
paged, block 16) bound by an Engine, a batch of 8 sequences decoded to
their full width, then the paged decode step called through its
instrumented form (`model.decode_paged`: the signature of tokens,
positions and tables, the seen-check) and through the bare step
(`model._decode_paged`) in ABBA blocks of N calls each, every block
ended by a synchronise. Also times the engine's `_count` bracket alone.
Prints one JSON line: microseconds a call of each, and the difference.
With `--front-door B`, then chip_smoke.py's 22e run (phase 4's traffic on
a fresh server, MXNET_TELEMETRY=1) in ABBA blocks: as built, and with the
engine's steps bypassing the watchdog (the bare step callables, `_count`
a plain bracket), printing each run's step period and engine-call p50.

    python tools/watchdog_overhead.py [--calls N] [--blocks B]
                                      [--front-door B]

Needs an NVIDIA GPU; run from the repository root. Imports nothing of
JAX.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--front-door", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = TransformerConfig(dtype=torch.float32, **cs.BENCH_CFG)
    params = params_from_numpy(cs.bench_params(np, cfg), cfg, dev)
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=8,
                         paged=True, block_size=16)
    rng = np.random.RandomState(4)
    seqs = [eng.start([int(t) for t in rng.randint(1, cfg.vocab, 64)], 64)
            for _ in range(8)]
    eng.decode_step(seqs)
    w = 8
    toks = torch.as_tensor([s.tokens[-1] for s in seqs], device=dev)
    pos = torch.as_tensor([len(s.tokens) - 1 for s in seqs],
                          dtype=torch.int32, device=dev)
    tabs = torch.as_tensor(np.stack([s.table_row[:w] for s in seqs]),
                           dtype=torch.int32, device=dev)
    model = eng.model
    call = (eng.cache.k, eng.cache.v, toks, pos, tabs)

    def timed(fn):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn(*call)
        torch.cuda.synchronize(dev)
        return (time.perf_counter() - t0) / args.calls * 1e6

    model.decode_paged(*call)
    runs = {"instrumented": [], "bare": []}
    for _ in range(args.blocks):
        for name in ("instrumented", "bare", "bare", "instrumented"):
            fn = model.decode_paged if name == "instrumented" \
                else model._decode_paged
            runs[name].append(timed(fn))
    t0 = time.perf_counter()
    for _ in range(args.calls * 10):
        with eng._count("decode", (8, w)):
            pass
    count_us = (time.perf_counter() - t0) / (args.calls * 10) * 1e6
    med = {k: sorted(v)[len(v) // 2] for k, v in runs.items()}
    print(json.dumps({"card": cs.nvidia_smi(), "calls": args.calls,
                      "blocks": args.blocks, "us_per_call": runs,
                      "median_us": med,
                      "instrumented_minus_bare_us":
                          med["instrumented"] - med["bare"],
                      "count_bracket_us": count_us}))
    for s in seqs:
        eng.release(s)
    if args.front_door:
        front_door(cs, serving, params, cfg, args.front_door)
    return 0


def front_door(cs, serving, params, cfg, blocks):
    """22e's run under MXNET_TELEMETRY=1, as built and with the watchdog
    bypassed in the engine, in ABBA blocks."""
    import contextlib
    import numpy as np
    from mxnet_tpu_torch.serving import engine as engine_mod
    rng = np.random.RandomState(22)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, cs.PROMPT_LEN)]
               for _ in range(cs.FD_PROMPTS)]
    kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256)
    real_serve, real_count = serving.serve, engine_mod.Engine._count

    @contextlib.contextmanager
    def bare_count(self, kind, sig):
        yield

    def bare_serve(*a, **k):
        srv = real_serve(*a, **k)
        m = srv.engine.model
        for name in ("decode_paged", "prefill_chunk", "decode", "prefill"):
            setattr(m, name, getattr(m, "_" + name))
        return srv

    runs = []
    for _ in range(blocks):
        for mode in ("built", "bypassed", "bypassed", "built"):
            serving.serve = real_serve if mode == "built" else bare_serve
            engine_mod.Engine._count = real_count if mode == "built" \
                else bare_count
            try:
                r = cs.front_door_cost_run(serving, params, cfg, prompts,
                                           kw, "1")
            finally:
                serving.serve = real_serve
                engine_mod.Engine._count = real_count
            runs.append({"mode": mode,
                         "step_period_p50_ms": r["step_period_p50_ms"],
                         "decode_call_p50_ms": r["decode_call_p50_ms"]})
            print("front_door " + json.dumps(runs[-1]), flush=True)
    med = {m: sorted(r["step_period_p50_ms"] for r in runs
                     if r["mode"] == m)[blocks - 1]
           for m in ("built", "bypassed")}
    print(json.dumps({"front_door_median_period_ms": med}))


if __name__ == "__main__":
    sys.exit(main())
