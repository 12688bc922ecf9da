#!/usr/bin/env python3
"""How long the C++ route takes ResNet-50: phase 29a's net (resnet50_v1,
1000 classes, Xavier weights from seed 29, float32, batch 32 of 224 x 224)
exported by predict.export_model on the card, compiled for the card by
predict.compile_for_cpp (AOTInductor), and run by the C++ tree's
mxtpu_predict; its logits against the Python replay of the artifact.

    python tools/aoti_resnet_probe.py   # NVIDIA GPU, repo root

Prints the export, compile and C++ seconds, the C++ and replay ms a
forward and the logit error as one JSON line, after the card's name and
power limit. Imports nothing of JAX.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import numpy as np
    import torch
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import cpp_package, predict
    from mxnet_tpu_torch.gluon.model_zoo import vision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    tree = cpp_package.build("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp, mx.gpu(0):
        mx.random.seed(cs.DEPLOY_SEED)
        torch.manual_seed(cs.DEPLOY_SEED)
        with mx.name.NameManager():
            net = vision.resnet50_v1(classes=1000)
        net.initialize(mx.init.Xavier())
        shape = (cs.DEPLOY_BATCH, 3, cs.R50_IMAGE, cs.R50_IMAGE)
        x = np.random.RandomState(cs.DEPLOY_SEED).standard_normal(
            shape).astype(np.float32)
        net(mx.nd.array(x))
        art = os.path.join(tmp, "r50.mxtpu")
        t0 = time.perf_counter()
        predict.export_model(net, [("data", shape)], art)
        out["export_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        predict.compile_for_cpp(art, ctx=mx.gpu(0))
        out["compile_for_cpp_s"] = time.perf_counter() - t0
        served = predict.load_exported(art, ctx=mx.gpu(0))
        xd = mx.nd.array(x)
        want = served.forward(data=xd)[0]._data.cpu().numpy()
        out["replay_ms"] = cs.deploy_forward_ms(
            torch, lambda: served.forward(data=xd))
        x.tofile(os.path.join(tmp, "x.bin"))
        t0 = time.perf_counter()
        p = subprocess.run(
            [tree.mxtpu_predict, art, "--device", str(dev), "--input",
             "0=" + os.path.join(tmp, "x.bin"), "--output-dir", tmp,
             "--repeat", "10"], capture_output=True, text=True)
        out["cpp_process_s"] = time.perf_counter() - t0
        if p.returncode != 0:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        out["cpp_forward_ms"] = cs.cpp_line(p.stdout, "forward ms:")
        got = np.fromfile(os.path.join(tmp, "out0.bin"),
                          np.float32).reshape(want.shape)
        out["logit_err_over_max"] = cs.lm_err(np, got, want)
        out["artifact_bytes"] = os.path.getsize(art)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
