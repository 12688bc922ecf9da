#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root

Phases (any failure exits non-zero before the last line):
  1. device   — a CUDA device must be present; prints nvidia-smi's name
                and power limit.
  2. build    — compiles every kernel source (mxnet_tpu_torch/ops/csrc/)
                at once, one nvcc per source, and prints each build's
                seconds and ptxas register and spill counts.
  3. kernels  — holds each kernel against its plain PyTorch version on the
                card at the main paths' shapes (and, for flash attention,
                ragged, head_dim 128 and non-causal cases; for the paged
                kernel's int8 variant, q float32 and bfloat16 over an int8
                pool at the decode, prefill-chunk and spec-score shapes),
                and times the kernel, the plain version, one library call
                as a yardstick, and the least time the card could take
                (bound).
  4. serving main path — serves the transformer LM at the full width of
                the repo's serving benchmark config (vocab 8192, d_model
                512, 4 heads x 128, 4 layers, d_ff 2048, max_len 1024;
                random weights from a numpy seed) through `serving.serve(
                ..., paged=True)`: 8 concurrent in-process requests plus
                one HTTP POST /v1/generate, 64-token prompts, 128 new
                tokens each. Checks every result, the engine-failure
                count, the kernel's launch count, and the greedy tokens
                against the port's own gather path on the card. Then
                profiles 16 steady paged decode steps on a fresh engine
                and checks its tokens against the same gather path.
  5. training main path — trains the transformer LM at the full width of
                the repo's flash-attention training benchmark
                (bench.py's non-smoke `bench_transformer_flash`: vocab
                8192, d_model 512, 8 heads x 64, 6 layers, d_ff 2048,
                max_len 1024; batch 8 x 1024 tokens from numpy seed 0, SGD
                at lr 0.1) with MXNET_FLASH_ATTENTION=1 through
                `make_transformer_train_step`: first the first step's loss
                and every gradient against the same step with the flag
                off, then one warm-up and 10 timed steps (finite, falling
                loss; both flash kernels launched n_layers times a step),
                then a profiled step.
  6. quantized serving path — `serving.serve(..., kv_quant=True,
                weight_quant="int8", paged=True, block_size=32)` at phase
                4's config and traffic (8 in-process requests + 1 HTTP,
                64-token prompts, 128 new tokens): the int8 KV pool read
                by the paged kernel's int8 variant, int8 weights. Checks
                results, failures, int8 launches = n_layers x (decode
                steps + prefill chunks) and no float launch, greedy
                tokens against the float paged engine up to each
                request's first near-tie (top-2 margin under 0.1), and a
                teacher-forced logit probe of one request against the
                float engine; then profiles 16 quantized decode steps.
  7. spec + prefix path — a server with a 2-layer self-draft
                (`spec_k=3`) and the prefix cache: 8 sequential requests
                sharing a 272-token prefix (off the 32-token block
                boundary, so every later request copies-on-write the
                part-shared block), each with its own 32-token suffix, 64
                new tokens. Run over the float pool first, its tokens
                held to the float paged engine's at phase 4's margin,
                then over the int8 pool with int8 weights, held as in
                phase 6. Each run checks spec passes, prefix hits, COW
                copies >= 7, and its kernel variant's launches = n_layers
                x (plain decode steps + prefill chunks + spec passes).
                Then profiles 8 speculative steps over the int8 pool.
  8. the kernels line, nvidia-smi's line, and the last line
     {"ok": true, "device": {...}}.

Parity settings: TF32 is off for matmuls and cuDNN, so float32 products
run in full float32 (the reference suite forces highest matmul
precision). Imports nothing of JAX or of the JAX package.
"""
import json
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request

#: H100 SXM data-sheet peaks (dense): device-memory bytes/s, and
#: float32 (CUDA cores) / bf16 (tensor cores) operations/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12}
#: kernel-vs-plain tolerances (atol = rtol). float32: the two sum the
#: scores and the PV product in different orders (online softmax over
#: blocks vs one softmax over the gathered row), a few ulps of a sum of
#: up to ~200 terms. bfloat16: the output is rounded to bf16 (8 bits of
#: mantissa, ~4e-3 relative) after float32 accumulation in both.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: greedy-token comparison stops at a step whose top-2 logit margin is
#: under this (10x the float32 tolerance): batch composition changes the
#: matmul shapes, so such near-ties may legitimately flip
MARGIN = 10 * TOL["float32"]
#: the serving benchmark's full-width config (bench.py's non-smoke
#: serving config) and its traffic: 64-token prompts, 128 new tokens,
#: 8 in-process requests plus one over HTTP
BENCH_CFG = dict(vocab=8192, d_model=512, n_heads=4, n_layers=4,
                 d_ff=2048, max_len=1024)
PROMPT_LEN, GEN, N_REQ = 64, 128, 9
#: the training benchmark's full-width config (bench.py's non-smoke
#: bench_transformer_flash) and its batch, steps and learning rate
TRAIN_CFG = dict(vocab=8192, d_model=512, n_heads=8, n_layers=6,
                 d_ff=2048, max_len=1024)
TRAIN_BATCH, TRAIN_STEPS, TRAIN_LR = 8, 10, 0.1
#: flash kernel vs plain tolerances (atol = rtol), (forward, backward).
#: float32: the forward sums by 64-key tiles with an online softmax, the
#: plain version in one dense softmax; the backward sums products over
#: up to T = 1024 rows in another order. bfloat16: outputs rounded to 8
#: mantissa bits after float32 arithmetic in both. m and l are float32
#: in both dtypes and take the float32 forward tolerance.
FLASH_TOL = {"float32": (2e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
#: flag-on vs flag-off training step (float32, TF32 off): the loss to
#: this relative error, each gradient to this relative Frobenius error
#: ||g_flash - g_ref|| / ||g_ref||. The flash kernels and dense attention
#: sum in other orders (~1e-6 relative). Where that flips the sign of a
#: ReLU pre-activation within ~1e-6 of zero (some 15 of a layer's 16.7 M
#: at this width), one token's term moves a whole gradient column: a
#: relative Frobenius error near sqrt(15 / 16.7e6) ~ 1e-3, and larger
#: elementwise. The bound leaves a tenfold margin; a kernel fault moves
#: it to O(0.1). The reference against itself in another summation order
#: (two half batches) is printed beside it, as the noise floor.
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-2
SOURCES = ("paged_attention.cu", "flash_attention.cu")
#: quantized serving (phases 6 and 7): bench.py's bench_serving_quant
#: block size (int8 blocks of 32 tokens, bench.py:2563), the greedy-token
#: near-tie margin (twice the reference's 0.05 logit budget for int8 KV +
#: int8 weights, tests/test_serving_quant.py:218), and the logit probe's
#: bound. At this config's full width the JAX reference's own quantized
#: engine, teacher-forced on its float engine's tokens, is off by up to
#: 0.0511 (tools/quant_logit_probe.py --impl reference, CPU), above the
#: tiny config's 0.05 budget; the probe is held to twice that.
QUANT_BLOCK = 32
QUANT_MARGIN = 0.1
REF_QUANT_LOGIT_ERR = 0.0511
PROBE_BOUND = 2 * REF_QUANT_LOGIT_ERR
#: phase 7's traffic (bench.py:1439-1442's shared-prompt shape, with the
#: shared length moved off the block boundary: 272 = 8.5 x 32)
SHARED_LEN, SUFFIX_LEN, SPEC_GEN, N_SPEC_REQ = 272, 32, 64, 8
SPEC_K, DRAFT_LAYERS = 3, 2


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, "nvidia-smi failed: %s" % out.stderr)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n=50, flush=None):
    """Mean device time of one call in ms: CUDA events around each call,
    with `flush` (an L2 eviction) run between calls outside the timed
    span, as the real caller finds the pool cold."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(n):
        if flush is not None:
            flush()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / n


def paged_case(torch, np, dev, B, Tq, w, q_starts, dtype, seed, H=4,
               Dh=128, bs=16):
    """Random pool, distinct non-null table ids and queries for one
    paged_attention call."""
    rng = np.random.RandomState(seed)
    nb = B * w + 8
    k = torch.from_numpy(rng.standard_normal((nb, bs, H, Dh))
                         .astype(np.float32)).to(dev, dtype)
    v = torch.from_numpy(rng.standard_normal((nb, bs, H, Dh))
                         .astype(np.float32)).to(dev, dtype)
    q = torch.from_numpy(rng.standard_normal((B, Tq, H, Dh))
                         .astype(np.float32)).to(dev, dtype)
    tab = rng.permutation(np.arange(1, nb))[:B * w].reshape(B, w)
    tables = torch.from_numpy(tab.astype(np.int32)).to(dev)
    q_start = torch.tensor(q_starts, dtype=torch.int32, device=dev)
    return q, k, v, tables, q_start


def bound(pa, B, Tq, H, Dh, bs, w, q_starts, dtype_name, itemsize,
          kv_itemsize=None, scale_blocks=0):
    """Least time (ms) of one call on these inputs: each live block read
    once, q read and out written once, over the memory rate, against the
    flops over the peak rate for the input type. Only live blocks count:
    the kernel never reads a dead one. An int8 pool passes
    kv_itemsize=1 and its scales' num_blocks, counted whole as the
    reference's paged_call_cost counts them (the kernel reads only the
    live blocks' scales)."""
    flops = nbytes = 0
    for qs in q_starts:
        live = min(w, (qs + Tq - 1) // bs + 1)
        f, b = pa.paged_call_cost(1, Tq, H, Dh, live, bs,
                                  kv_itemsize=kv_itemsize or itemsize,
                                  q_itemsize=itemsize)
        flops += f
        nbytes += b
    nbytes += 2 * scale_blocks * H * 4
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_OPS_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def phase_kernels(torch, np, dev, card):
    """Hold the CUDA kernel against the plain version; time both at the
    main path's shapes."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    H, Dh, bs = 4, 128, 16
    errs = {"float32": 0.0, "bfloat16": 0.0}
    ncases = 0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        for w in (4, 16):
            top = w * bs
            cases = [  # decode B=8: ragged, incl. 0, mid-block, last slot
                (8, 1, [0, 5, bs + 5, 2 * bs, top // 2 + 3, top - bs - 1,
                        top - 2, top - 1]),
                # prefill chunk B=1, Tq=32: from 0 and from mid-block
                (1, 32, [0]), (1, 32, [top - 32 - 11]),
                # spec score B=8, Tq=k+1=4: ragged, incl. the last rows
                (8, 4, [0, 3, bs - 2, bs + 7, top // 2, top - bs - 3,
                        top - 5, top - 4])]
            for B, Tq, qst in cases:
                q, k, v, tab, qs = paged_case(torch, np, dev, B, Tq, w, qst,
                                              dtype, seed=ncases)
                out = pa.paged_attention(q, k, v, tab, qs, bs)
                ref = pa.paged_attention_plain(q, k, v, tab, qs, bs)
                torch.cuda.synchronize()
                check(bool(torch.isfinite(out).all()),
                      "kernel output not finite (%s B=%d Tq=%d w=%d)"
                      % (dname, B, Tq, w))
                err = float((out.float() - ref.float()).abs().max())
                errs[dname] = max(errs[dname], err)
                try:
                    torch.testing.assert_close(out.float(), ref.float(),
                                               atol=TOL[dname],
                                               rtol=TOL[dname])
                except AssertionError as e:
                    raise SmokeFailure(
                        "kernel != plain (%s B=%d Tq=%d w=%d q_start=%s): "
                        "%s" % (dname, B, Tq, w, qst, e))
                ncases += 1
    print("kernel check: %d cases, max |kernel - plain| float32 %.3g "
          "(tol %g), bfloat16 %.3g (tol %g)"
          % (ncases, errs["float32"], TOL["float32"], errs["bfloat16"],
             TOL["bfloat16"]))

    # timing at the shapes the main path gives the kernel
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    rows = []
    for label, B, Tq, w, qst, tbs in (
            ("decode", 8, 1, 16, [190] * 8, bs),       # last decode step
            ("decode_mid", 8, 1, 8, [127] * 8, bs),    # mid-generation
            ("prefill_chunk", 1, 32, 4, [32], bs),     # 2nd chunk of 64
            # a k+1 = 4 scoring pass at phase 7's lengths and block
            ("spec_score", 8, 4, 16, [300, 310, 320, 330, 340, 350, 355,
                                      360], QUANT_BLOCK)):
        for dname, dtype, itemsize in (("float32", torch.float32, 4),
                                       ("bfloat16", torch.bfloat16, 2)):
            q, k, v, tab, qs = paged_case(torch, np, dev, B, Tq, w, qst,
                                          dtype, seed=99, bs=tbs)
            t_k = time_ms(torch, lambda: pa.paged_attention(
                q, k, v, tab, qs, tbs), flush=flush)
            t_p = time_ms(torch, lambda: pa.paged_attention_plain(
                q, k, v, tab, qs, tbs), flush=flush)
            # yardstick only: SDPA over the already-gathered dense K/V
            # with the ragged mask (the port never calls it)
            idx = tab.long()
            kd = k[idx].reshape(B, w * tbs, H, Dh).transpose(1, 2)
            vd = v[idx].reshape(B, w * tbs, H, Dh).transpose(1, 2)
            qd = q.transpose(1, 2)
            kp = torch.arange(w * tbs, device=dev)
            qp = qs.long()[:, None] + torch.arange(Tq, device=dev)
            mask = (kp[None, None, :] <= qp[:, :, None])[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            t_l = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask),
                          flush=flush)
            b_ms, b_by, nbytes, flops = bound(pa, B, Tq, H, Dh, tbs, w, qst,
                                              dname, itemsize)
            rows.append({"card": card, "shape": label, "dtype": dname,
                         "B": B, "Tq": Tq,
                         "w": w, "bs": tbs, "q_start": qst[0], "ms": t_k,
                         "plain_ms": t_p, "library_ms": t_l,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bound_bytes": nbytes, "bound_flops": flops})
    for r in rows:
        print("kernel timing: " + json.dumps(r))
    del flush_buf
    return errs, rows


def quantize_pool(torch, pool):
    """Per-(block, head) symmetric int8 of an (NB, bs, H, Dh) float pool
    (the reference's tests/test_serving_quant.py:87)."""
    s = pool.abs().amax(dim=(1, 3)).clamp(min=1e-12) / 127.0
    q = torch.clamp(torch.round(pool / s[:, None, :, None]), -127, 127)
    return q.to(torch.int8).contiguous(), s.contiguous()


#: int8 cases: (label, B, Tq, w, q_starts) at H=4, Dh=128, bs=32 — the
#: quantized decode step, the second 64-token prefill chunk, and a
#: speculative scoring pass (k+1 = 4 rows) of phase 7's lengths
INT8_CASES = [("decode", 8, 1, 8, [0, 5, 37, 64, 131, 200, 254, 255]),
              ("prefill_chunk", 1, 64, 4, [64]),
              ("spec_score", 8, 4, 8, [0, 33, 64, 100, 160, 200, 250, 252])]


def phase_kernels_int8(torch, np, dev, card):
    """The paged kernel's int8 variant against its plain version, q
    float32 and bfloat16 over int8 pools quantized from seeded float
    data; then the same shapes timed four ways."""
    from mxnet_tpu_torch.ops import paged_attention as pa
    H, Dh, bs = 4, 128, QUANT_BLOCK
    errs = {"float32": 0.0, "bfloat16": 0.0}
    flush_buf = torch.empty(96 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    rows = []
    for n, (label, B, Tq, w, qst) in enumerate(INT8_CASES):
        for dname, dtype, itemsize in (("float32", torch.float32, 4),
                                       ("bfloat16", torch.bfloat16, 2)):
            q, k, v, tab, qs = paged_case(torch, np, dev, B, Tq, w, qst,
                                          torch.float32, seed=100 + n,
                                          H=H, Dh=Dh, bs=bs)
            q = q.to(dtype)
            kq, ks = quantize_pool(torch, k)
            vq, vs = quantize_pool(torch, v)
            del k, v
            sc = dict(k_scale=ks, v_scale=vs)
            out = pa.paged_attention(q, kq, vq, tab, qs, bs, **sc)
            ref = pa.paged_attention_plain(q, kq, vq, tab, qs, bs, **sc)
            torch.cuda.synchronize()
            check(out.dtype == dtype and bool(torch.isfinite(out).all()),
                  "int8 kernel output not finite (%s %s)" % (label, dname))
            errs[dname] = max(errs[dname],
                              float((out.float() - ref.float()).abs().max()))
            try:
                torch.testing.assert_close(out.float(), ref.float(),
                                           atol=TOL[dname], rtol=TOL[dname])
            except AssertionError as e:
                raise SmokeFailure("int8 kernel != plain (%s, q %s, B=%d "
                                   "Tq=%d w=%d): %s"
                                   % (label, dname, B, Tq, w, e))
            t_k = time_ms(torch, lambda: pa.paged_attention(
                q, kq, vq, tab, qs, bs, **sc), flush=flush)
            t_p = time_ms(torch, lambda: pa.paged_attention_plain(
                q, kq, vq, tab, qs, bs, **sc), flush=flush)
            # yardstick only: SDPA over K/V gathered and dequantized
            # beforehand, with the ragged mask (the port never calls it)
            idx = tab.long()
            kd = (kq[idx].float() * ks[idx][:, :, None, :, None]).to(dtype)
            vd = (vq[idx].float() * vs[idx][:, :, None, :, None]).to(dtype)
            kd = kd.reshape(B, w * bs, H, Dh).transpose(1, 2)
            vd = vd.reshape(B, w * bs, H, Dh).transpose(1, 2)
            kp = torch.arange(w * bs, device=dev)
            qp = qs.long()[:, None] + torch.arange(Tq, device=dev)
            mask = (kp[None, None, :] <= qp[:, :, None])[:, None]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qd = q.transpose(1, 2)
            t_l = time_ms(torch, lambda: sdpa(qd, kd, vd, attn_mask=mask),
                          flush=flush)
            b_ms, b_by, nbytes, flops = bound(
                pa, B, Tq, H, Dh, bs, w, qst, dname, itemsize,
                kv_itemsize=1, scale_blocks=kq.shape[0])
            rows.append({"card": card, "shape": label, "q_dtype": dname,
                         "pool": "int8", "B": B, "Tq": Tq, "w": w,
                         "bs": bs, "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_l, "bound_ms": b_ms,
                         "bound_by": b_by, "bound_bytes": nbytes,
                         "bound_flops": flops})
    print("kernel check int8: %d cases (decode, prefill chunk, spec "
          "score), max |kernel - plain| q float32 %.3g (tol %g), q "
          "bfloat16 %.3g (tol %g)"
          % (2 * len(INT8_CASES), errs["float32"], TOL["float32"],
             errs["bfloat16"], TOL["bfloat16"]))
    for r in rows:
        print("kernel timing int8: " + json.dumps(r))
    del flush_buf
    return errs, rows


def bench_params(np, cfg, seed=0):
    """Random weights of the full-width config from a numpy seed, in the
    reference's initialization (N(0, 0.02), unit/zero layer norms)."""
    from mxnet_tpu_torch.models.transformer import param_shapes
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("_g"):
            out[name] = np.ones(shape, np.float32)
        elif name.endswith("_b"):
            out[name] = np.zeros(shape, np.float32)
        else:
            out[name] = (0.02 * rng.standard_normal(shape)).astype(
                np.float32)
    return out


def gather_oracle(torch, np, serving, params, cfg, prompts, gen, dev,
                  paged=False, block_size=16, logits=None):
    """Greedy tokens and per-token top-2 logit margins from the port's
    float engine on the card: the gather path (Engine(paged=False)), or
    the float paged engine. With `logits` (a list) each request's logit
    rows are appended to it."""
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=8,
                         block_size=block_size, paged=paged,
                         keep_logits=True, device=dev)
    toks, margins = [], []
    for lo in range(0, len(prompts), 8):
        seqs = [eng.start(list(p), max_new=gen) for p in prompts[lo:lo + 8]]
        while any(not s.done for s in seqs):
            eng.decode_step(seqs)
        for s in seqs:
            toks.append(s.generated)
            if logits is not None:
                logits.append(np.stack(s.token_logits))
            m = []
            for row in s.token_logits:
                top2 = np.partition(row, -2)[-2:]
                m.append(float(top2[1] - top2[0]))
            margins.append(m)
            eng.release(s)
    eng.close()
    return toks, margins


def compare_tokens(what, got, ref, margins, margin=MARGIN, quiet=False):
    """Greedy tokens `got` (one list per request) against the oracle's
    `ref`, stopping a request at its first near-tie (top-2 margin under
    `margin`). Returns how many tokens were compared."""
    compared = 0
    for i, toks in enumerate(got):
        for t, tok in enumerate(toks):
            if margins[i][t] < margin:
                if not quiet:
                    print("token check (%s): request %d stops at token %d "
                          "(top-2 margin %.3g < %.3g)"
                          % (what, i, t, margins[i][t], margin))
                break
            check(tok == ref[i][t],
                  "%s: request %d token %d: %d != oracle %d (margin %.3g)"
                  % (what, i, t, tok, ref[i][t], margins[i][t]))
            compared += 1
    return compared


def profile_decode(torch, serving, params, cfg, prompts, dev, steps=16,
                   label="profile", max_new=None, **engine_kw):
    """Where a steady paged decode step's time goes: device time by
    kernel from torch.profiler over `steps` steps of a batch of 8, beside
    the host wall time of the same (profiled) steps, on a paged engine
    (block 16 unless `engine_kw` says otherwise; its options too).
    Returns the greedy tokens the engine generated, for the caller to
    check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine_kw.setdefault("block_size", 16)
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=8,
                         paged=True, device=dev, **engine_kw)
    seqs = [eng.start(list(p), max_new=max_new or steps + 8)
            for p in prompts]
    for _ in range(4):
        eng.decode_step(seqs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.decode_step(seqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    toks = [list(s.generated) for s in seqs]
    for s in seqs:
        eng.release(s)
    eng.close()
    dev_us = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev_us[e.key] = e.self_device_time_total
    total = sum(dev_us.values())
    if total <= 0:
        print("%s: not measured (no device time recorded)" % label)
        return toks
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    print(label + ": " + json.dumps({
        "decode_steps": steps, "batch": len(seqs),
        "host_ms_per_step_profiled": 1e3 * wall / steps,
        "device_busy_ms_per_step": total / 1e3 / steps,
        "device_busy_share": total / 1e6 / wall,
        "kernels_us_per_step": {k: v / steps for k, v in top}}))
    return toks


def serve_traffic(serving, pa, params, cfg, prompts, gen, kw):
    """Phases 4 and 6's traffic through `serving.serve((params, cfg),
    **kw)`: a warm-up server (CUDA context, cuBLAS handles) closed first,
    then 8 in-process requests plus one HTTP POST /v1/generate at once.
    The kernel counters are set to 0 just before the requests and read
    just after. Checks every result and the request counters; returns
    (outs, wall_s, (float launches, int8 launches), snapshot, requests,
    engine)."""
    warm = serving.serve((params, cfg), **kw)
    try:
        warm.generate(prompts[0], max_new_tokens=4, timeout=300)
    finally:
        warm.close()

    srv = serving.serve((params, cfg), **kw)
    try:
        host, port = srv.serve_http(port=0, block=False)
        http_out = {}

        def post():
            body = json.dumps({"tokens": prompts[8],
                               "max_new_tokens": gen}).encode()
            req = urllib.request.Request(
                "http://%s:%d/v1/generate" % (host, port), data=body,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=600) as resp:
                    http_out["status"] = resp.status
                    http_out["body"] = json.loads(resp.read())
            except Exception as e:  # reported by the check below
                http_out["error"] = "%s: %s" % (type(e).__name__, e)

        pa.paged_attention.launches = 0
        pa.paged_attention.launches_int8 = 0
        t0 = time.perf_counter()
        client = threading.Thread(target=post, daemon=True)
        client.start()
        reqs = [srv.submit(p, max_new_tokens=gen) for p in prompts[:8]]
        outs = [r.result(timeout=600) for r in reqs]
        client.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = (pa.paged_attention.launches,
                    pa.paged_attention.launches_int8)
        check(not client.is_alive(), "HTTP request did not finish")
        snap = srv.snapshot()
    finally:
        srv.close()

    check("error" not in http_out, "HTTP request failed: %s"
          % http_out.get("error"))
    check(http_out.get("status") == 200, "HTTP status %r"
          % http_out.get("status"))
    outs.append(http_out["body"]["tokens"])
    for i, o in enumerate(outs):
        check(len(o) == gen, "request %d returned %d tokens, wanted %d"
              % (i, len(o), gen))
    req_snap = snap["requests"]
    check(req_snap["engine_failures"] == 0, "engine failures: %d"
          % req_snap["engine_failures"])
    check(req_snap["completed"] == len(prompts) and req_snap["failed"] == 0,
          "requests: %r" % req_snap)
    return outs, wall, launches, snap, reqs, srv.engine


def phase_main_path(torch, np, dev, card):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    prompt_len, gen, n_req = PROMPT_LEN, GEN, N_REQ
    params = params_from_numpy(bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, prompt_len)]
               for _ in range(n_req)]
    kw = dict(max_batch=8, paged=True, block_size=16, token_budget=256)
    outs, wall, (launches, _), snap, reqs, _ = serve_traffic(
        serving, pa, params, cfg, prompts, gen, kw)
    paths = snap["paths"]
    want = cfg.n_layers * (paths["paged_decode_steps"]
                           + paths["prefill_chunks"])
    check(launches == want and launches > 0,
          "paged kernel launched %d times, expected n_layers x (decode "
          "steps + prefill chunks) = %d x (%d + %d) = %d"
          % (launches, cfg.n_layers, paths["paged_decode_steps"],
             paths["prefill_chunks"], want))
    check(paths["gather_decode_steps"] == 0, "gather path ran on a paged "
          "server")

    # greedy tokens against the gather path on the card
    ref, margins = gather_oracle(torch, np, serving, params, cfg, prompts,
                                 gen, dev)
    compared = compare_tokens("served", outs, ref, margins)
    print("token check: %d of %d greedy tokens compared, all equal to the "
          "gather path" % (compared, n_req * gen))
    # a failure of this second paged engine fails the smoke like any other
    try:
        prof_toks = profile_decode(torch, serving, params, cfg, prompts[:8],
                                   dev)
    except SmokeFailure:
        raise
    except Exception as e:
        raise SmokeFailure("profiled paged decode failed: %s: %s"
                           % (type(e).__name__, e))
    compared = compare_tokens("profiled", prof_toks, ref, margins)
    check(compared > 0, "profiled decode: no token compared")
    print("token check (profiled): %d greedy tokens compared, all equal to "
          "the gather path" % compared)

    ttfts = sorted(r.t_first_token - r.t_submit for r in reqs)
    lat = snap["latency_ms"]
    main = {"card": card, "requests": n_req, "tokens": n_req * gen,
            "wall_s": wall, "tokens_per_s": n_req * gen / wall,
            "ttft_p50_ms_inproc": 1e3 * float(np.median(ttfts)),
            "ttft_p50_ms_hist": lat["time_to_first_token_p50"],
            "decode_step_mean_ms": lat["decode_step_mean"],
            "decode_step_p50_ms": lat["decode_step_p50"],
            "decode_steps": paths["paged_decode_steps"],
            "prefill_chunks": paths["prefill_chunks"],
            "kernel_launches": launches}
    print("main path: " + json.dumps(main))
    return launches, main


def quant_logit_probe(np, serving, params, cfg, prompt, gen, dev,
                      ref_tokens, ref_logits):
    """Max |logit - float| of one request on a fresh quantized engine
    (int8 KV + int8 weights), TEACHER-FORCED on the float engine's
    tokens `ref_tokens`: before each decode step the input token is set
    to the float engine's, so every logit row is compared at the same
    context. Returns (max error, rows compared, argmax agreements)."""
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=8,
                         block_size=QUANT_BLOCK, paged=True,
                         keep_logits=True, kv_quant=True,
                         weight_quant="int8", device=dev)
    seq = eng.start(list(prompt), gen)
    i = 0
    while not seq.done:
        seq.tokens[-1] = int(ref_tokens[i])
        i += 1
        eng.decode_step([seq])
    rows = np.stack(seq.token_logits)
    eng.release(seq)
    eng.close()
    err = float(np.abs(rows - ref_logits).max())
    agree = int((rows.argmax(1) == ref_logits.argmax(1)).sum())
    return err, len(rows), agree


def phase_quant(torch, np, dev, card):
    """Phase 6: the quantized serving path at phase 4's config and
    traffic; int8 launches counted, tokens and logits against the float
    paged engine."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    gen, n_req = GEN, N_REQ
    params = params_from_numpy(bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(1)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab, PROMPT_LEN)]
               for _ in range(n_req)]
    kw = dict(max_batch=8, paged=True, block_size=QUANT_BLOCK,
              token_budget=256, kv_quant=True, weight_quant="int8")
    outs, wall, (f32_launches, launches), snap, reqs, eng = serve_traffic(
        serving, pa, params, cfg, prompts, gen, kw)
    check(eng.kv_quant and eng.weight_quant == "int8",
          "quantized server: kv_quant %r, weight_quant %r"
          % (eng.kv_quant, eng.weight_quant))
    paths = snap["paths"]
    want = cfg.n_layers * (paths["paged_decode_steps"]
                           + paths["prefill_chunks"])
    check(launches == want and launches > 0,
          "int8 kernel launched %d times, expected n_layers x (decode "
          "steps + prefill chunks) = %d x (%d + %d) = %d"
          % (launches, cfg.n_layers, paths["paged_decode_steps"],
             paths["prefill_chunks"], want))
    check(f32_launches == 0 and paths["gather_decode_steps"] == 0,
          "the quantized server ran %d float paged launches and %d gather "
          "steps" % (f32_launches, paths["gather_decode_steps"]))

    ref_logits = []
    ref, margins = gather_oracle(torch, np, serving, params, cfg, prompts,
                                 gen, dev, paged=True,
                                 block_size=QUANT_BLOCK, logits=ref_logits)
    compared = compare_tokens("quantized", outs, ref, margins,
                              margin=QUANT_MARGIN, quiet=True)
    print("token check (quantized): %d of %d greedy tokens compared, each "
          "request up to its first top-2 margin under %g, all equal to the "
          "float paged engine" % (compared, n_req * gen, QUANT_MARGIN))
    err, nrows, agree = quant_logit_probe(np, serving, params, cfg,
                                          prompts[0], gen, dev, ref[0],
                                          ref_logits[0])
    print("logit probe (quantized, teacher-forced, %d rows): max |logit - "
          "float| %.5f (reference budget 0.05; bound %.4f = twice the JAX "
          "reference's own %.4f at this config); argmax equal on %d of %d "
          "rows" % (nrows, err, PROBE_BOUND, REF_QUANT_LOGIT_ERR, agree,
                    nrows))
    check(err <= PROBE_BOUND, "quantized logit error %.5f > %.4f"
          % (err, PROBE_BOUND))
    prof_toks = profile_decode(torch, serving, params, cfg, prompts[:8],
                               dev, label="profile (quantized)",
                               block_size=QUANT_BLOCK, kv_quant=True,
                               weight_quant="int8")
    n = compare_tokens("quantized, profiled", prof_toks, ref, margins,
                       margin=QUANT_MARGIN, quiet=True)
    print("token check (quantized, profiled): %d greedy tokens compared, "
          "all equal to the float paged engine" % n)
    ttfts = sorted(r.t_first_token - r.t_submit for r in reqs)
    lat = snap["latency_ms"]
    main = {"card": card, "requests": n_req, "tokens": n_req * gen,
            "wall_s": wall, "tokens_per_s": n_req * gen / wall,
            "ttft_p50_ms_inproc": 1e3 * float(np.median(ttfts)),
            "decode_step_mean_ms": lat["decode_step_mean"],
            "decode_step_p50_ms": lat["decode_step_p50"],
            "decode_steps": paths["paged_decode_steps"],
            "prefill_chunks": paths["prefill_chunks"],
            "int8_kernel_launches": launches,
            "kv_bytes_per_token": snap["quant"][
                "serving_kv_quant_bytes_per_token"],
            "max_logit_err": err, "tokens_compared": compared}
    print("quant path: " + json.dumps(main))
    return launches, main


def serve_spec_prefix(serving, pa, params, cfg, prompts, quant):
    """Phase 7's traffic, requests one after another, through a server
    with a 2-layer self-draft (spec_k=3) and the prefix cache, over the
    int8 pool with int8 weights (`quant`) or the float pool. The kernel
    counters are set to 0 just before the requests and read just after.
    Checks every result, spec passes, prefix hits, COW copies, and that
    the pool's kernel variant ran n_layers x (plain decode steps +
    prefill chunks + spec passes) times and the other variant never.
    Returns (outs, wall_s, launches, snapshot)."""
    what = "int8" if quant else "float"
    kw = dict(kv_quant=True, weight_quant="int8") if quant else {}
    srv = serving.serve(
        (params, cfg), max_batch=8, paged=True, block_size=QUANT_BLOCK,
        token_budget=256, draft=serving.self_draft(params, cfg, DRAFT_LAYERS),
        spec_k=SPEC_K, prefix_cache=True, **kw)
    try:
        eng = srv.engine
        check(eng.spec and eng.prefix_cache is not None
              and eng.kv_quant == quant,
              "%s pool: spec %r (fallback %r), prefix cache %r, kv_quant %r"
              % (what, eng.spec, eng.spec_fallback, eng.prefix_cache,
                 eng.kv_quant))
        pa.paged_attention.launches = 0
        pa.paged_attention.launches_int8 = 0
        t0 = time.perf_counter()
        outs = [srv.generate(p, max_new_tokens=SPEC_GEN, timeout=600)
                for p in prompts]
        wall = time.perf_counter() - t0
        launches = (pa.paged_attention.launches_int8,
                    pa.paged_attention.launches)
        if not quant:
            launches = launches[::-1]
        snap = srv.snapshot()
    finally:
        srv.close()
    for i, o in enumerate(outs):
        check(len(o) == SPEC_GEN, "%s pool: request %d returned %d tokens, "
              "wanted %d" % (what, i, len(o), SPEC_GEN))
    paths, sp, pre = snap["paths"], snap["spec"], snap["cache"]["prefix"]
    check(snap["requests"]["engine_failures"] == 0, "%s pool: engine "
          "failures: %d" % (what, snap["requests"]["engine_failures"]))
    check(sp["passes"] > 0 and pre["hit_tokens"] > 0
          and pre["cow_copies"] >= N_SPEC_REQ - 1,
          "%s pool: spec passes %d, prefix hit tokens %d, COW copies %d "
          "(want > 0, > 0, >= %d)" % (what, sp["passes"], pre["hit_tokens"],
                                      pre["cow_copies"], N_SPEC_REQ - 1))
    plain = paths["paged_decode_steps"] - sp["passes"]
    want = cfg.n_layers * (plain + paths["prefill_chunks"] + sp["passes"])
    check(launches[0] == want and launches[1] == 0,
          "%s kernel launched %d times (the other variant %d), expected "
          "n_layers x (plain decode steps + prefill chunks + spec passes) "
          "= %d x (%d + %d + %d) = %d"
          % (what, launches[0], launches[1], cfg.n_layers, plain,
             paths["prefill_chunks"], sp["passes"], want))
    return outs, wall, launches[0], snap


def phase_spec_prefix(torch, np, dev, card):
    """Phase 7: speculative decoding and the prefix cache, 8 sequential
    requests sharing a 272-token prefix: first over the float pool, whose
    greedy tokens must equal the float paged engine's at phase 4's
    margin (the scoring pass, verification and COW copies switch speed,
    never tokens), then over the int8 pool with int8 weights, held to
    the quantized margin."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
    from mxnet_tpu_torch.ops import paged_attention as pa
    cfg = TransformerConfig(dtype=torch.float32, **BENCH_CFG)
    params = params_from_numpy(bench_params(np, cfg), cfg, dev)
    rng = np.random.RandomState(2)
    shared = [int(t) for t in rng.randint(1, cfg.vocab, SHARED_LEN)]
    prompts = [shared + [int(t) for t in rng.randint(1, cfg.vocab,
                                                     SUFFIX_LEN)]
               for _ in range(N_SPEC_REQ)]
    ref, margins = gather_oracle(torch, np, serving, params, cfg, prompts,
                                 SPEC_GEN, dev, paged=True,
                                 block_size=QUANT_BLOCK)
    f_outs, f_wall, f_launches, f_snap = serve_spec_prefix(
        serving, pa, params, cfg, prompts, quant=False)
    f_compared = compare_tokens("spec+prefix, float pool", f_outs, ref,
                                margins)
    check(f_compared > 0, "spec+prefix, float pool: no token compared")
    print("token check (spec+prefix, float pool): %d of %d greedy tokens "
          "compared, all equal to the float paged engine"
          % (f_compared, N_SPEC_REQ * SPEC_GEN))

    outs, wall, launches, snap = serve_spec_prefix(
        serving, pa, params, cfg, prompts, quant=True)
    compared = compare_tokens("spec+prefix", outs, ref, margins,
                              margin=QUANT_MARGIN, quiet=True)
    print("token check (spec+prefix): %d of %d greedy tokens compared, each "
          "request up to its first top-2 margin under %g, all equal to the "
          "float paged engine" % (compared, N_SPEC_REQ * SPEC_GEN,
                                  QUANT_MARGIN))
    prof_toks = profile_decode(
        torch, serving, params, cfg, prompts, dev, steps=8,
        label="profile (spec+prefix)", max_new=SPEC_GEN,
        block_size=QUANT_BLOCK, kv_quant=True, weight_quant="int8",
        draft=serving.self_draft(params, cfg, DRAFT_LAYERS), spec_k=SPEC_K,
        prefix_cache=True)
    n = compare_tokens("spec+prefix, profiled", prof_toks, ref, margins,
                       margin=QUANT_MARGIN, quiet=True)
    print("token check (spec+prefix, profiled): %d greedy tokens compared, "
          "all equal to the float paged engine" % n)
    paths, sp, pre = snap["paths"], snap["spec"], snap["cache"]["prefix"]
    main = {"card": card, "requests": N_SPEC_REQ,
            "tokens": N_SPEC_REQ * SPEC_GEN, "wall_s": wall,
            "tokens_per_s": N_SPEC_REQ * SPEC_GEN / wall,
            "spec_k": sp["k"], "spec_passes": sp["passes"],
            "acceptance_rate": sp["acceptance_rate"],
            "accepted_per_pass": sp["accepted_per_pass"],
            "spec_fallbacks": sp["fallbacks"],
            "prefix_hit_tokens": pre["hit_tokens"],
            "prefix_hits": pre["hits"], "cow_copies": pre["cow_copies"],
            "plain_decode_steps": paths["paged_decode_steps"] - sp["passes"],
            "prefill_chunks": paths["prefill_chunks"],
            "int8_kernel_launches": launches,
            "decode_step_mean_ms": snap["latency_ms"]["decode_step_mean"],
            "tokens_compared": compared,
            "float_pool": {
                "tokens_per_s": N_SPEC_REQ * SPEC_GEN / f_wall,
                "spec_passes": f_snap["spec"]["passes"],
                "acceptance_rate": f_snap["spec"]["acceptance_rate"],
                "kernel_launches": f_launches,
                "decode_step_mean_ms":
                    f_snap["latency_ms"]["decode_step_mean"],
                "tokens_compared": f_compared}}
    print("spec+prefix path: " + json.dumps(main))
    return launches, main


def ptxas_summary(log_path):
    """One entry per kernel of a build log: 'name<type,D,...>: N regs,
    S bytes spilled' from nvcc's -Xptxas -v lines."""
    out, name, spill = [], None, "0"
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                raw = m.group(1)
                k = re.search(r"\d+([a-z_]+_kernel)I(.*?)EEv", raw)
                name = raw if k is None else "%s<%s>" % (
                    k.group(1), k.group(2).replace("13__nv_bfloat16", "bf16")
                    .replace("E", "").replace("Li", ","))
                continue
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m:
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", ln)
            if m and name is not None:
                out.append("%s: %s regs, %s B spill stores"
                           % (name, m.group(1), spill))
                name, spill = None, "0"
    return out


def build_kernels(_cuda):
    """Build every kernel source at once, one nvcc per source, each in a
    thread of its own; print each build's seconds and ptxas lines."""
    done = {}

    def one(src):
        t0 = time.perf_counter()
        try:
            _cuda.library(src)
            done[src] = (time.perf_counter() - t0, None)
        except Exception as e:  # reported below, per source
            done[src] = (time.perf_counter() - t0, e)

    threads = [threading.Thread(target=one, args=(src,)) for src in SOURCES]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for src in SOURCES:
        secs, err = done[src]
        check(err is None, "build of %s failed: %s" % (src, err))
        info = ptxas_summary(_cuda.target(src)[1])
        print("build %s: %.1f s; %d kernels" % (src, secs, len(info)))
        for line in info:
            print("  ptxas %s" % line)
    print("build: all sources in %.1f s" % (time.perf_counter() - t0))


def flash_bound(fa, BH, T, D, dtype_name, itemsize, backward):
    """Least time (ms) of one causal call at [BH, T, D]: each input read
    once and each output written once over the memory rate, against the
    flops of the live (query, key) pairs, T (T + 1) / 2 a row, over the
    peak rate for the input type."""
    flops, nbytes, _ = fa.flash_call_cost(BH, T, T, D, itemsize, nq=1,
                                          pairs=T * (T + 1) // 2,
                                          backward=backward)
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_OPS_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_inputs(torch, np, dev, BH, T, Tk, D, dtype, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev, dtype) for s in ((BH, T, D), (BH, Tk, D), (BH, Tk, D),
                                      (BH, T, D))]


#: flash kernel checks: (label, BH, T, Tk, D, causal); "main" is the
#: training path's shape (batch 8 x 8 heads, 1024 tokens, head_dim 64)
FLASH_CASES = [("main", 64, 1024, 1024, 64, True),
               ("ragged_1000", 8, 1000, 1000, 64, True),
               ("ragged_37", 8, 37, 37, 64, True),
               ("head_dim_128", 8, 512, 512, 128, True),
               ("non_causal_tk", 8, 300, 517, 64, False)]


def phase_flash(torch, np, dev, card):
    """Hold the flash forward (out, m, l) and backward (dq, dk, dv)
    kernels against their plain versions, in float32 and bfloat16; time
    both directions at the training path's shape."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    outputs = ("out", "m", "l", "dq", "dk", "dv")
    errs = {(d, w): 0.0 for d in FLASH_TOL for w in outputs}
    ncases = 0
    for dname, dtype in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
        tol_f, tol_b = FLASH_TOL[dname]
        f32_tol = FLASH_TOL["float32"][0]
        for label, BH, T, Tk, D, causal in FLASH_CASES:
            q, k, v, g = flash_inputs(torch, np, dev, BH, T, Tk, D, dtype,
                                      seed=ncases)
            scale = D ** -0.5
            got = fa.flash_attention_fwd(q, k, v, scale, causal)
            want = fa.flash_fwd_plain(q, k, v, scale, causal)
            gotb = fa.flash_attention_bwd(q, k, v, got[0], got[1], got[2], g,
                                          scale, causal)
            wantb = fa.flash_bwd_plain(q, k, v, got[0], got[1], got[2], g,
                                       scale, causal)
            torch.cuda.synchronize()
            for what, a, b, tol in (
                    ("out", got[0], want[0], tol_f),
                    ("m", got[1], want[1], f32_tol),
                    ("l", got[2], want[2], f32_tol),
                    ("dq", gotb[0], wantb[0], tol_b),
                    ("dk", gotb[1], wantb[1], tol_b),
                    ("dv", gotb[2], wantb[2], tol_b)):
                check(bool(torch.isfinite(a).all()),
                      "flash %s not finite (%s %s)" % (what, dname, label))
                err = float((a.float() - b.float()).abs().max())
                errs[dname, what] = max(errs[dname, what], err)
                try:
                    torch.testing.assert_close(a.float(), b.float(),
                                               atol=tol, rtol=tol)
                except AssertionError as e:
                    raise SmokeFailure("flash %s kernel != plain (%s %s "
                                       "BH=%d T=%d Tk=%d D=%d causal=%s): %s"
                                       % (what, dname, label, BH, T, Tk, D,
                                          causal, e))
            ncases += 1
    for dname in FLASH_TOL:
        print("flash kernel check %s: %d cases, max |kernel - plain| %s; "
              "tol (atol = rtol) out %g, m and l %g, grads %g"
              % (dname, ncases // 2, ", ".join(
                  "%s %.3g" % (w, errs[dname, w]) for w in outputs),
                 FLASH_TOL[dname][0], FLASH_TOL["float32"][0],
                 FLASH_TOL[dname][1]))

    # timing at the training path's shape; no L2 flush: the kernels are
    # bound by operations, and the step hands them fresh q/k/v
    _, BH, T, _, D, _ = FLASH_CASES[0]
    B, H = TRAIN_BATCH, BH // TRAIN_BATCH
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for dname, dtype, itemsize in (("float32", torch.float32, 4),
                                   ("bfloat16", torch.bfloat16, 2)):
        q, k, v, g = flash_inputs(torch, np, dev, BH, T, T, D, dtype,
                                  seed=99)
        scale = D ** -0.5
        out, m, l = fa.flash_attention_fwd(q, k, v, scale, True)
        t_f = time_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, scale, True), n=20)
        t_fp = time_ms(torch, lambda: fa.flash_fwd_plain(
            q, k, v, scale, True), n=20)
        t_b = time_ms(torch, lambda: fa.flash_attention_bwd(
            q, k, v, out, m, l, g, scale, True), n=20)
        t_bp = time_ms(torch, lambda: fa.flash_bwd_plain(
            q, k, v, out, m, l, g, scale, True), n=20)
        # yardsticks only (the port never calls them): SDPA's causal
        # forward, and its autograd backward
        q4, k4, v4 = (t.view(B, H, T, D).detach().clone()
                      .requires_grad_(True) for t in (q, k, v))
        g4 = g.view(B, H, T, D)
        t_fl = time_ms(torch, lambda: sdpa(q4, k4, v4, is_causal=True),
                       n=20)
        o4 = sdpa(q4, k4, v4, is_causal=True)
        t_bl = time_ms(torch, lambda: torch.autograd.grad(
            o4, (q4, k4, v4), g4, retain_graph=True), n=20)
        del o4
        for kind, t_k, t_p, t_l in (("fwd", t_f, t_fp, t_fl),
                                    ("bwd", t_b, t_bp, t_bl)):
            b_ms, b_by = flash_bound(fa, BH, T, D, dname, itemsize,
                                     kind == "bwd")
            rows.append({"card": card, "kernel": "flash_attention_" + kind,
                         "dtype": dname, "BH": BH, "T": T, "D": D,
                         "causal": True, "ms": t_k, "plain_ms": t_p,
                         "library_ms": t_l, "bound_ms": b_ms,
                         "bound_by": b_by})
    # the layout copy the training path pays before the forward: the
    # (B, S, 3D) projection split into contiguous [B*H, S, Dh] q, k, v
    qkv = torch.randn(B, T, 3 * H * D, device=dev)

    def layout():
        for t in torch.split(qkv, H * D, dim=-1):
            t.reshape(B, T, H, D).transpose(1, 2).reshape(B * H, T, D)

    copy_ms = time_ms(torch, layout, n=20)
    for r in rows:
        print("flash timing: " + json.dumps(r))
    print("flash layout copy: %s" % json.dumps({
        "card": card, "what": "q, k, v views -> contiguous [BH, T, D], "
        "float32", "ms": copy_ms}))
    return errs, rows


def profile_train_step(torch, run, params, toks):
    """Where one training step's time goes: device time by kernel from
    torch.profiler over one step, beside its host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, loss = run(params, toks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(bool(torch.isfinite(loss)), "profiled step: loss not finite")
    dev_us = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            dev_us[e.key] = e.self_device_time_total
    total = sum(dev_us.values())
    if total <= 0:
        print("train profile: not measured (no device time recorded)")
        return
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]
    print("train profile: " + json.dumps({
        "steps": 1, "host_ms_profiled": 1e3 * wall,
        "device_busy_ms": total / 1e3,
        "device_busy_share": total / 1e6 / wall,
        "kernels_us": dict(top)}))


def phase_train(torch, np, dev, card):
    """The training main path: make_transformer_train_step at the full
    width, flash on; oracle against the flag-off step, then the timed
    steps with the flash kernels' launches counted, then a profile."""
    from mxnet_tpu_torch.models import (TransformerConfig,
                                        make_transformer_train_step)
    from mxnet_tpu_torch.models.transformer import lm_loss_and_grads
    from mxnet_tpu_torch.ops import flash_attention as fa
    cfg = TransformerConfig(dtype=torch.float32, **TRAIN_CFG)
    toks = np.random.RandomState(0).randint(
        0, cfg.vocab, (TRAIN_BATCH, cfg.max_len))
    run, params = make_transformer_train_step(cfg, lr=TRAIN_LR, seed=0,
                                              device=dev)
    tokens = torch.as_tensor(toks, dtype=torch.long, device=dev)
    prior = os.environ.get("MXNET_FLASH_ATTENTION")
    try:
        # oracle: the first step's loss and gradients, flag off vs on
        os.environ["MXNET_FLASH_ATTENTION"] = "0"
        ref_loss, ref_grads = lm_loss_and_grads(params, tokens, cfg)
        # noise floor: the same reference step as the mean of two half
        # batches (each half has the same number of targets)
        half = TRAIN_BATCH // 2
        _, ga = lm_loss_and_grads(params, tokens[:half], cfg)
        _, gb = lm_loss_and_grads(params, tokens[half:], cfg)
        floor = max(float(((ga[n] + gb[n]) / 2 - gr).norm())
                    / max(float(gr.norm()), 1e-30)
                    for n, gr in ref_grads.items())
        del ga, gb
        os.environ["MXNET_FLASH_ATTENTION"] = "1"
        n_f = fa.flash_attention_fwd.launches
        loss1, grads1 = lm_loss_and_grads(params, tokens, cfg)
        check(fa.flash_attention_fwd.launches > n_f,
              "flag on: the flash forward kernel did not launch")
        loss_err = abs(float(loss1) - float(ref_loss)) / abs(float(ref_loss))
        check(loss_err <= TRAIN_LOSS_RTOL,
              "first-step loss flash %r != reference %r (rel err %.3g > %g)"
              % (float(loss1), float(ref_loss), loss_err, TRAIN_LOSS_RTOL))
        worst, worst_name, worst_el, worst_el_name = 0.0, None, 0.0, None
        for name, gr in ref_grads.items():
            gf = grads1[name]
            check(bool(torch.isfinite(gf).all()), "grad %s not finite" % name)
            diff = gf - gr
            rel = float(diff.norm()) / max(float(gr.norm()), 1e-30)
            rel_el = float(diff.abs().max()) / max(
                float(gr.abs().max()), 1e-30)
            if rel >= worst:
                worst, worst_name = rel, name
            if rel_el >= worst_el:
                worst_el, worst_el_name = rel_el, name
        check(worst <= TRAIN_GRAD_TOL,
              "first-step grad %s: flash vs reference relative Frobenius "
              "error %.3g > %g" % (worst_name, worst, TRAIN_GRAD_TOL))
        print("train oracle: loss flash %.7f reference %.7f (rel err %.3g, "
              "tol %g); %d gradients, worst relative Frobenius error %.3g "
              "(%s, tol %g); largest element error %.3g of the tensor's "
              "largest element (%s); noise floor, the reference against "
              "itself over two half batches: worst relative Frobenius "
              "error %.3g"
              % (float(loss1), float(ref_loss), loss_err, TRAIN_LOSS_RTOL,
                 len(ref_grads), worst, worst_name, TRAIN_GRAD_TOL, worst_el,
                 worst_el_name, floor))
        del ref_grads, grads1

        # the main path: one warm-up step, then the timed steps
        fa.flash_attention_fwd.launches = 0
        fa.flash_attention_bwd.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        params, loss = run(params, toks)
        losses, times = [float(loss)], []
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, loss = run(params, toks)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = (fa.flash_attention_fwd.launches,
                    fa.flash_attention_bwd.launches)
        peak = torch.cuda.max_memory_allocated(dev)
        want = cfg.n_layers * (TRAIN_STEPS + 1)
        check(launches == (want, want),
              "flash kernels launched %d (forward) and %d (backward) times, "
              "expected n_layers x steps = %d x %d = %d each"
              % (launches[0], launches[1], cfg.n_layers, TRAIN_STEPS + 1,
                 want))
        check(all(np.isfinite(losses)), "losses not finite: %r" % losses)
        check(losses[-1] < losses[0], "loss did not fall: %r" % losses)
        print("train repeat: the warm-up step's loss %.7f, the oracle's "
              "flag-on loss %.7f" % (losses[0], float(loss1)))
        try:
            profile_train_step(torch, run, params, toks)
        except SmokeFailure:
            raise
        except Exception as e:
            raise SmokeFailure("profiled training step failed: %s: %s"
                               % (type(e).__name__, e))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FLASH_ATTENTION", None)
        else:
            os.environ["MXNET_FLASH_ATTENTION"] = prior
    ms = sorted(1e3 * t for t in times)
    mean_ms = sum(ms) / len(ms)
    main = {"card": card, "steps_timed": TRAIN_STEPS,
            "grad_rel_err": worst, "grad_rel_err_noise_floor": floor,
            "batch": TRAIN_BATCH, "seq": cfg.max_len,
            "step_ms_mean": mean_ms, "step_ms_p50": float(np.median(ms)),
            "tokens_per_s": TRAIN_BATCH * cfg.max_len / (mean_ms / 1e3),
            "loss_first": losses[0], "loss_last": losses[-1],
            "max_memory_allocated": peak,
            "flash_fwd_launches": launches[0],
            "flash_bwd_launches": launches[1]}
    print("train path: " + json.dumps(main))
    return launches, main


def main():
    import torch
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    import numpy as np
    try:
        from mxnet_tpu_torch.ops import _cuda
    except ImportError as e:
        print("FAIL: cannot import the port (run from the repository "
              "root): %s" % e, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        smi = nvidia_smi()
        print("device: %s (%s), torch %s, CUDA %s"
              % (torch.cuda.get_device_name(0), smi, torch.__version__,
                 torch.version.cuda))
        build_kernels(_cuda)
        errs, rows = phase_kernels(torch, np, dev, smi)
        int8_errs, int8_rows = phase_kernels_int8(torch, np, dev, smi)
        flash_errs, flash_rows = phase_flash(torch, np, dev, smi)
        launches, main_path = phase_main_path(torch, np, dev, smi)
        train_launches, train_path = phase_train(torch, np, dev, smi)
        int8_launches, quant_path = phase_quant(torch, np, dev, smi)
        spec_launches, spec_path = phase_spec_prefix(torch, np, dev, smi)
    except SmokeFailure as e:
        print("FAIL: %s" % e, file=sys.stderr)
        return 1
    top = next(r for r in rows if r["shape"] == "decode"
               and r["dtype"] == "float32")
    kernels = [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_paged.py:108",
        "launches": launches,
        "max_abs_err": errs["float32"],
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
    }]
    top8 = next(r for r in int8_rows if r["shape"] == "decode"
                and r["q_dtype"] == "float32")
    kernels.append({
        "name": "paged_attention_int8",
        "route": "cuda",
        "source": "mxnet_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": "mxnet_tpu/ops/pallas_paged.py:119",
        # the quantized path's decode steps and chunks (phase 6) plus
        # the spec+prefix path's scoring passes and chunks (phase 7)
        "launches": int8_launches + spec_launches,
        "max_abs_err": int8_errs["float32"],
        "ms": top8["ms"],
        "plain_ms": top8["plain_ms"],
        "bound_ms": top8["bound_ms"],
        "bound_by": top8["bound_by"],
        "library_ms": top8["library_ms"],
    })
    for i, (kind, line) in enumerate((("fwd", 32), ("bwd", 138))):
        r = next(r for r in flash_rows if r["dtype"] == "float32"
                 and r["kernel"] == "flash_attention_" + kind)
        kernels.append({
            "name": r["kernel"],
            "route": "cuda",
            "source": "mxnet_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": "mxnet_tpu/ops/pallas_attention.py:%d" % line,
            "launches": train_launches[i],
            # out for the forward (m and l are printed above; l grows
            # with T), the largest of dq, dk, dv for the backward
            "max_abs_err": (flash_errs["float32", "out"] if kind == "fwd"
                            else max(flash_errs["float32", w]
                                     for w in ("dq", "dk", "dv"))),
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
