#!/usr/bin/env python3
"""What sets the CPU replay's error in chip_smoke.py 29b: the exported
word LM replayed on the CPU, read at each torch thread count and in fresh
processes.

29b exports the word LM at phase 11's width (chip_smoke.lm_export:
Xavier weights from DEPLOY_SEED, MXNET_FUSED_RNN=1) and replays the
artifact in a fresh process (chip_smoke.LM_REPLAY) on the card and on the
CPU, each held to the eager net's logits with the flag off on the card.
This exports the same net, takes the same reference, and reads the CPU
replay's largest |error| over the largest |logit| (chip_smoke.lm_err):

- in this process at each thread count of THREADS, REPEATS times each;
- in --fresh fresh processes of LM_REPLAY at torch's default thread
  count, then as many at one thread, in turns.

Each reading prints as a JSON line with the bits of its logits (a hash),
so equal results show as equal hashes; then the host's CPU model and
torch's parallel settings, the card's name and power limit, and a last
line of everything.

    python tools/lm_replay_probe.py [--fresh N]   # NVIDIA GPU, repo root

Imports nothing of JAX.
"""
import argparse
import hashlib
import io
import json
import os
import sys
import tempfile
import zipfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

#: the in-process thread counts (capped at the host's cores) and the
#: replays at each
THREADS = (1, 2, 3, 4, 6, 8)
REPEATS = 2


def _digest(a):
    return hashlib.sha1(a.tobytes()).hexdigest()[:12]


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


def main():
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fresh", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import torch.export.passes
    import mxnet_tpu_torch as mx
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.nvidia_smi()
    from mxnet_tpu_torch.ops import _cuda
    cs.build_kernels(_cuda)
    rows = []
    prior = os.environ.get("MXNET_FUSED_RNN")
    with tempfile.TemporaryDirectory(prefix="mxtt_lmprobe_") as tmp, \
            mx.gpu(0):
        try:
            os.environ["MXNET_FUSED_RNN"] = "1"
            net, x_np, art, _ = cs.lm_export(torch, np, mx, dev, tmp)
            os.environ["MXNET_FUSED_RNN"] = "0"
            want = net(mx.nd.array(x_np))._data.float().cpu().numpy()
        finally:
            if prior is None:
                os.environ.pop("MXNET_FUSED_RNN", None)
            else:
                os.environ["MXNET_FUSED_RNN"] = prior
        default_threads = torch.get_num_threads()
        with zipfile.ZipFile(art) as z:
            blob = z.read("model.pt2")
        prog = torch.export.passes.move_to_device_pass(
            torch.export.load(io.BytesIO(blob)), "cpu")
        x = torch.from_numpy(x_np)
        for n in THREADS:
            if n > (os.cpu_count() or 1):
                continue
            torch.set_num_threads(n)
            for r in range(REPEATS):
                with torch.no_grad():
                    y = prog.module()(x)[0].float().numpy()
                rows.append({"where": "this process", "threads": n,
                             "repeat": r, "err": cs.lm_err(np, y, want),
                             "bits": _digest(y)})
                print(json.dumps(rows[-1]), flush=True)
        torch.set_num_threads(default_threads)
        for i in range(args.fresh):
            for threads in (0, 1):
                _, ys = cs.lm_fresh_replay(np, art, x_np, tmp, dev, threads)
                rows.append({"where": "fresh process", "turn": i,
                             "threads": threads or "default",
                             "err": cs.lm_err(np, ys["cpu"], want),
                             "bits": _digest(ys["cpu"]),
                             "card_err": cs.lm_err(np, ys["card"], want)})
                print(json.dumps(rows[-1]), flush=True)
    host = {"cpu": _cpu_model(), "cores": os.cpu_count(),
            "torch_default_threads": default_threads,
            "torch": torch.__version__,
            "parallel_info": torch.__config__.parallel_info(),
            "mkldnn": torch.backends.mkldnn.is_available(),
            "env": {k: os.environ.get(k) for k in (
                "OMP_NUM_THREADS", "MKL_NUM_THREADS", "MKL_DYNAMIC",
                "OMP_DYNAMIC")}}
    print(json.dumps(host))
    print(card)
    print(json.dumps({"card": card, "host": host, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
