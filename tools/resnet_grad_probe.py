#!/usr/bin/env python3
"""How exact a ResNet's first-step loss and gradients are, and against
what: the oracle choices behind tests/test_torch_resnet.py and the card
checks of the fused BatchNorm kernels (K3a-d).

    python tools/resnet_grad_probe.py --impl port          # NVIDIA GPU
    JAX_PLATFORMS=cpu python tools/resnet_grad_probe.py --impl reference

`--impl port` (imports nothing of JAX): the port's resnet18_v1(classes=10)
with Xavier weights (seed 0), batch 16 of 64x64 inputs from
RandomState(0), float32 with TF32 off. It takes the first SGD step's
gradients (`TrainStep.loss_and_grads`) on the card with
MXNET_FUSED_BN_EPILOGUE=1 (the CUDA kernels), with it off (the
composite, cuDNN on), with it off and cuDNN disabled, and with the flag
on on the CPU (the kernels' plain versions), and holds each against the
same step in float64 on the card. It prints, for each, the worst relative
Frobenius error over the gradients (conv biases that feed a BatchNorm
left out: their gradient is exactly zero), and the card's fused step
against the CPU's.

`--impl reference` (imports nothing of the port): the JAX package's
resnet18_v1(classes=10), batch 2, Xavier weights (numpy seed 0); the
first-step loss through `functionalize(net, train_mode=True)` with an
explicit PRNG key, flag on (Pallas in interpret mode) and off, at 32x32
and at 64x64 inputs. At 32x32 the last stage's BatchNorms see 2 values
a channel.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _set_flag(on):
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1" if on else "0"


def probe_port():
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.models import gluon_params_from_numpy
    from mxnet_tpu_torch.parallel import TrainStep
    if not torch.cuda.is_available():
        raise SystemExit("--impl port needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (16, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 10, (16,))
    nets = {}
    for ctx in (mx.cpu(), mx.gpu(0)):
        with ctx, mx.name.NameManager():
            net = vision.resnet18_v1(classes=10)
            net.initialize(mx.init.Xavier(seed=0))
            net(mx.nd.zeros((1, 3, 64, 64)))
        nets[ctx.device_type] = net
    gluon_params_from_numpy(nets["gpu"], {
        n: p.data().asnumpy()
        for n, p in nets["cpu"].collect_params().items()})

    def grads(where, flag, dtype=torch.float32):
        _set_flag(flag)
        net = nets[where]
        dev = mx.Context(where, 0).torch_device()
        step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), "sgd",
                         {"learning_rate": 0.01})
        loss, g = step.loss_and_grads(
            torch.from_numpy(x).to(dev, dtype), torch.from_numpy(y).to(dev))
        return float(loss), {n: v.double().cpu() for n, v in g.items()}

    runs = {"card_fused": grads("gpu", True),
            "card_composite": grads("gpu", False)}
    torch.backends.cudnn.enabled = False
    runs["card_composite_cudnn_off"] = grads("gpu", False)
    torch.backends.cudnn.enabled = True
    runs["cpu_fused"] = grads("cpu", True)
    for p in nets["gpu"].collect_params().values():
        p.cast("float64")
    ref_loss, ref = grads("gpu", False, torch.float64)

    def worst(g, against):
        return max(float((g[n] - r).norm() / r.norm())
                   for n, r in against.items()
                   if not ("conv2d" in n and n.endswith("_bias")))

    out = {"device": torch.cuda.get_device_name(0),
           "float64_loss": ref_loss}
    for name, (loss, g) in runs.items():
        out[name] = {"loss": loss, "grad_rel_err_vs_float64": worst(g, ref)}
    out["card_fused_vs_cpu_fused"] = worst(runs["card_fused"][1],
                                           runs["cpu_fused"][1])
    print(json.dumps(out))


def probe_reference():
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_default_matmul_precision", "highest")
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo import vision
    from mxnet_tpu.parallel.functional import functionalize
    np.random.seed(0)
    net = vision.resnet18_v1(classes=10)
    net.initialize(mx.init.Xavier())
    net(mx.nd.zeros((1, 3, 32, 32)))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = {}
    for hw in (32, 64):
        rng = np.random.RandomState(0)
        x = jnp.asarray(rng.uniform(-1, 1, (2, 3, hw, hw)).astype(np.float32))
        y = jnp.asarray(rng.randint(0, 10, (2,)).astype(np.int32))
        losses = {}
        for flag in (True, False):
            _set_flag(flag)     # read while the forward is traced
            apply_fn, _, values = functionalize(net, train_mode=True)
            logits = apply_fn(values, x, key=jax.random.PRNGKey(0))
            losses[flag] = float(jnp.mean(loss_fn(
                mx.nd.NDArray(logits), mx.nd.NDArray(y))._data))
        out["%dx%d" % (hw, hw)] = {
            "loss_flag_on": losses[True], "loss_flag_off": losses[False],
            "rel_diff": abs(losses[True] - losses[False])
            / abs(losses[False])}
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("port", "reference"), required=True)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.impl == "port":
        probe_port()
    else:
        probe_reference()


if __name__ == "__main__":
    main()
