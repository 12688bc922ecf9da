#!/usr/bin/env python3
"""Telemetry's cost on the serving front door (chip_smoke.py's phase 22e)
from two source trees in turns on one card: phase 4's traffic (8
in-process requests and one HTTP POST at the bench width, paged, K1) on
fresh servers with MXNET_TELEMETRY=0 and =1 in ABBA blocks, each tree in
a process of its own, in the order given by --order (default base, this,
this, base). Per run it prints the decode-step period p50 with telemetry
on and off, their median difference, the engine call's p50 and tokens/s.

    python tools/frontdoor_ab.py BASE_DIR [--this DIR] [--blocks N]
                                 [--order ORDER]

BASE_DIR is another checkout (e.g. a parent commit unpacked with
`git archive <commit> | tar -x -C <dir>` into a directory .gitignore
lists) with chip_smoke.front_door_cost. Needs an NVIDIA GPU; run from the
repository root. `--this` names the tree to compare in place of this
one (a copy of it placed beside BASE_DIR, so that neither tree is the
repository root). Each run prints as a JSON line; the last line holds
them all. Imports nothing of JAX.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ONE = r"""
import json, os, sys
import numpy as np, torch
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
from mxnet_tpu_torch.ops import _cuda
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_cuda.library("paged_attention.cu")
cs.FD_COST_BLOCKS = int(sys.argv[1])
dev = torch.device("cuda", 0)
cfg = TransformerConfig(dtype=torch.float32, **cs.BENCH_CFG)
params = params_from_numpy(cs.bench_params(np, cfg), cfg, dev)
rng = np.random.RandomState(22)
prompts = [[int(t) for t in rng.randint(1, cfg.vocab, cs.PROMPT_LEN)]
           for _ in range(cs.FD_PROMPTS)]
kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256)
r = cs.front_door_cost(serving, params, cfg, prompts, kw)
print(json.dumps({"median": r["median"]}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base")
    ap.add_argument("--this", default=ROOT)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--order", default="base,this,this,base")
    args = ap.parse_args()
    trees = {"base": os.path.abspath(args.base),
             "this": os.path.abspath(args.this)}
    out = []
    for name in args.order.split(","):
        tree = trees[name]
        p = subprocess.run([sys.executable, "-c", ONE, str(args.blocks)],
                           cwd=tree, capture_output=True, text=True,
                           timeout=900, env=dict(os.environ, PYTHONPATH=tree))
        if p.returncode:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        med = json.loads(p.stdout.strip().splitlines()[-1])["median"]
        line = {"tree": name,
                "period_on_p50_ms": med["step_period_p50_ms"]["on"],
                "period_off_p50_ms": med["step_period_p50_ms"]["off"],
                "on_minus_off_ms": med["step_period_p50_ms"]["on_minus_off"],
                "decode_call_on_ms": med["decode_call_p50_ms"]["on"],
                "tokens_per_s_on": med["tokens_per_s"]["on"]}
        print("frontdoor_ab " + json.dumps(line), flush=True)
        out.append(line)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
