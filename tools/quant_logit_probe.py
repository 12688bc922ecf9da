#!/usr/bin/env python3
"""Teacher-forced logit error of quantized serving (int8 KV + int8
weights) against the float engine, at chip_smoke.py phase 6's config,
on the CPU; with `--tp K`, of the quantized engine sharded over K devices
against the quantized engine on one (chip_smoke.py phase 26b's bound).

    JAX_PLATFORMS=cpu python tools/quant_logit_probe.py --impl reference
    python tools/quant_logit_probe.py --impl port
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \
        python tools/quant_logit_probe.py --impl reference --tp 2

Both modes serve the same random weights (numpy seed 0, N(0, 0.02)
matrices, unit/zero layer norms, the full-width serving config of
chip_smoke.py) and the same 64-token prompt (numpy seed 1). The float
paged engine (block 32) generates 128 tokens; a quantized engine then
runs the same request with each decode step's input token set to the
float engine's, so every logit row is compared at the same context. The
script prints the largest |logit - float| and how many rows' argmax
agree. With `--tp K` the baseline is the quantized engine on one device
and the engine under test the same one at tp=K (the reference over K
virtual CPU devices, the port over the window `["cpu"] * K`).

`--impl reference` runs the JAX package's engine (its Pallas kernel in
interpreter mode) and imports nothing of the port; `--impl port` runs
the port's engine (the paged kernel's plain PyTorch version, since the
tensors are on the CPU) through chip_smoke.py's own probe and imports
nothing of JAX. chip_smoke.py holds the card to twice the reference's
number.
"""
import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: chip_smoke.py's BENCH_CFG, QUANT_BLOCK, PROMPT_LEN and GEN
CFG = dict(vocab=8192, d_model=512, n_heads=4, n_layers=4, d_ff=2048,
           max_len=1024)
BLOCK, PROMPT_LEN, GEN = 32, 64, 128


def weights():
    """chip_smoke.bench_params's draws, in its name order."""
    D, V, F = CFG["d_model"], CFG["vocab"], CFG["d_ff"]
    shapes = [("embed", (V, D)), ("pos_embed", (CFG["max_len"], D))]
    for i in range(CFG["n_layers"]):
        pre = "layer%d_" % i
        shapes += [(pre + "ln1_g", (D,)), (pre + "ln1_b", (D,)),
                   (pre + "wqkv", (D, 3 * D)), (pre + "wo", (D, D)),
                   (pre + "ln2_g", (D,)), (pre + "ln2_b", (D,)),
                   (pre + "w1", (D, F)), (pre + "w2", (F, D))]
    shapes += [("lnf_g", (D,)), ("lnf_b", (D,)), ("head", (D, V))]
    rng = np.random.RandomState(0)
    out = {}
    for name, shape in shapes:
        if name.endswith("_g"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("_b"):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (0.02 * rng.standard_normal(shape)).astype(
                np.float32)
    return out


def prompt():
    rng = np.random.RandomState(1)
    return [int(t) for t in rng.randint(1, CFG["vocab"], PROMPT_LEN)]


def run_reference(tp=1):
    import jax
    from mxnet_tpu import serving
    from mxnet_tpu.models.transformer import TransformerConfig
    jax.config.update("jax_default_matmul_precision", "highest")
    cfg = TransformerConfig(**CFG)
    params = {k: jax.numpy.asarray(v) for k, v in weights().items()}

    def run(forced=None, **kw):
        eng = serving.Engine(serving.TransformerLM(dict(params), cfg),
                             max_batch=8, block_size=BLOCK, paged=True,
                             keep_logits=True, **kw)
        seq = eng.start(prompt(), GEN)
        i = 0
        while not seq.done:
            if forced is not None:
                seq.tokens[-1] = int(forced[i])
            i += 1
            eng.decode_step([seq])
        out = (list(seq.generated),
               np.stack([np.asarray(r, np.float32)
                         for r in seq.token_logits]))
        eng.release(seq)
        eng.close()
        return out

    quant = dict(kv_quant=True, weight_quant="int8")
    if tp > 1:
        ref_tokens, ref_logits = run(**quant)
        _, rows = run(forced=ref_tokens, tp=tp, **quant)
    else:
        ref_tokens, ref_logits = run()
        _, rows = run(forced=ref_tokens, **quant)
    return (float(np.abs(rows - ref_logits).max()), len(rows),
            int((rows.argmax(1) == ref_logits.argmax(1)).sum()))


def run_port(tp=1):
    import torch
    import chip_smoke as cs
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    torch.backends.cuda.matmul.allow_tf32 = False
    assert (cs.BENCH_CFG, cs.QUANT_BLOCK, cs.PROMPT_LEN, cs.GEN) == \
        (CFG, BLOCK, PROMPT_LEN, GEN)
    cfg = TransformerConfig(dtype=torch.float32, **CFG)
    w = weights()
    same = cs.bench_params(np, cfg)
    assert all(np.array_equal(w[k], same[k]) for k in same)
    params = params_from_numpy(w, cfg, "cpu")
    if tp > 1:
        ref, rows = cs.quant_logit_rows(np, serving, params, cfg, prompt(),
                                        GEN, "cpu")
        return cs.quant_logit_probe(np, serving, params, cfg, prompt(), GEN,
                                    "cpu", ref, rows, tp=tp)
    logits = []
    ref, _ = cs.gather_oracle(torch, np, serving, params, cfg, [prompt()],
                              GEN, "cpu", paged=True, block_size=BLOCK,
                              logits=logits)
    return cs.quant_logit_probe(np, serving, params, cfg, prompt(), GEN,
                                "cpu", ref[0], logits[0])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", choices=("reference", "port"), required=True)
    ap.add_argument("--tp", type=int, default=1,
                    help="compare the quantized engine at this tp degree "
                         "with the quantized engine at tp=1")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    err, rows, agree = (run_reference if args.impl == "reference"
                        else run_port)(args.tp)
    base = "float" if args.tp == 1 else "int8 tp=1"
    print("%s: int8 KV + int8 weights%s, teacher-forced, %d rows: max "
          "|logit - %s| %.5f; argmax equal on %d of %d rows"
          % (args.impl, "" if args.tp == 1 else " at tp=%d" % args.tp,
             rows, base, err, agree, rows))


if __name__ == "__main__":
    main()
