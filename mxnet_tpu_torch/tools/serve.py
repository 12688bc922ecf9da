#!/usr/bin/env python
"""Serve a language model over HTTP with continuous batching (port of
tools/serve.py).

The stdlib-HTTP front door over mxnet_tpu_torch.serving: load a `.mxtpu`
artifact exported by `mxnet_tpu_torch.predict.export_model` (one int
token input (batch, seq) -> logits, served by `ExportedLM`) and serve it,
or run `--demo` to serve a randomly initialized tiny transformer for
smoke-testing the stack.

    python -m mxnet_tpu_torch.tools.serve --model lm.mxtpu --port 8080
    python -m mxnet_tpu_torch.tools.serve --demo --paged --device cpu
    curl -X POST localhost:8080/v1/generate \\
         -d '{"tokens": [3, 1, 4, 1, 5], "max_new_tokens": 16}'
    curl localhost:8080/v1/metrics                      # JSON snapshot
    curl -H 'Accept: text/plain' localhost:8080/metrics # Prometheus
    curl localhost:8080/statusz    # SLO/goodput view (per-tenant
                                   # ledger, burn rates)

POST /v1/generate accepts a W3C `traceparent` header (malformed values
degrade to a fresh trace id) and returns one, so a request is one
connected trace across replicas and failover hops; watch the fleet live
with `python tools/fleet_top.py --url http://host:port`.

`--demo` serves the reference demo's config (vocab 256, d_model 64, 4
heads, 2 layers, d_ff 128, max_len 128) with weights from the port's
initializer drawn by a torch.Generator seeded DEMO_SEED: the reference
draws them with jax.random, whose numbers torch cannot reproduce, so the
two demos serve different weights (`demo_model` takes weights carried
across instead). `--device` is the card by default; a machine without
one exits naming it. SIGTERM or SIGINT stops the server; it then prints
one `stopped: {json}` line: requests served, the kernels' launches in
this process and the AOT cache's warm loads and nvcc builds.
"""
import argparse
import json
import os
import signal
import sys
import threading

from mxnet_tpu_torch.tools import add_device_flag, require_device

#: the reference demo's transformer (tools/serve.py --demo)
DEMO_CONFIG = dict(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                   max_len=128)
DEMO_SEED = 0


def demo_model(device):
    """(params, cfg) of the --demo transformer on `device`: DEMO_CONFIG,
    weights from `init_transformer_params` drawn by a torch.Generator
    seeded DEMO_SEED. The one place the CLI builds its demo weights, so a
    caller can hand it others (the reference demo's, carried across with
    `models.convert.params_from_numpy`)."""
    import torch
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_transformer_params)
    cfg = TransformerConfig(**DEMO_CONFIG)
    gen = torch.Generator().manual_seed(DEMO_SEED)
    return init_transformer_params(cfg, generator=gen, device=device), cfg


def stop_summary(srv):
    """What the stopped server did in this process: requests, kernel
    launches, the exported program's replays (an artifact's engines;
    0 for a Block or the demo), the AOT cache's warm loads and nvcc
    builds."""
    from mxnet_tpu_torch.ops import fused_rnn
    from mxnet_tpu_torch.ops import paged_attention as pa
    from mxnet_tpu_torch.telemetry import introspect
    from mxnet_tpu_torch import serving
    snap = srv.snapshot()
    if isinstance(srv, serving.ReplicatedLMServer):
        requests = snap["aggregate"]["requests"]
        engines = [r.engine for r in srv.replicas]
    else:
        requests = snap["requests"]
        engines = [srv.engine]
    sites = introspect.watchdog().sites()
    k4 = fused_rnn.launch_counts()
    return {
        "requests": requests,
        "kernel_launches": {
            "paged_attention": pa.paged_attention.launches,
            "paged_attention_int8": pa.paged_attention.launches_int8,
            "rnn_fwd": k4[0], "rnn_bwd": k4[1]},
        "replays": sum(getattr(e.model, "replays", 0) for e in engines),
        "warm_loads": sum(e.warm_loads for e in engines),
        "nvcc_builds": sum(s.compiles for n, s in sites.items()
                           if n.startswith("kernels."))}


def _raise_interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv=None, on_serving=None):
    """The CLI. `on_serving(srv)` is called with the built server just
    before it serves (a caller on another thread stops it with
    `srv.stop_http()`)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default=None,
                    help=".mxtpu artifact from predict.export_model")
    ap.add_argument("--demo", action="store_true",
                    help="serve a random tiny transformer (no artifact)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--queue-timeout", type=float, default=None,
                    help="fail requests queued longer than this (s)")
    ap.add_argument("--paged", action="store_true", default=None,
                    help="decode via the hand-written paged-attention "
                         "kernel + chunked prefill (default: the "
                         "MXNET_PAGED_ATTENTION env var)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="prefill chunk length in tokens (paged path; "
                         "default 2 * block-size)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-iteration token budget: decode tokens + "
                         "prefill chunks (default: "
                         "MXNET_SERVING_TOKEN_BUDGET or unbounded)")
    ap.add_argument("--tp", type=int, default=None,
                    help="tensor-parallel degree per replica: shard the "
                         "transformer weights and the KV block pool "
                         "head-wise over a window of k devices (default: "
                         "MXNET_SERVING_TP or 1; implies --paged; "
                         "unshardable configs fall back to 1 — "
                         "placement changes, logits never do)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="engine replicas behind one front door with "
                         "least-loaded routing (default: "
                         "MXNET_SERVING_REPLICAS or 1); with --tp k, "
                         "replica i runs on devices [i*k, (i+1)*k)")
    ap.add_argument("--prefix-cache", action="store_true", default=None,
                    help="content-addressed KV prefix reuse: shared "
                         "prompt prefixes hit resident pool blocks "
                         "instead of re-prefilling, copy-on-write on "
                         "divergence, LRU eviction under pool pressure "
                         "(default: the MXNET_PREFIX_CACHE env var; "
                         "needs the paged path)")
    ap.add_argument("--tenant-budget", type=int, default=None,
                    help="per-iteration token budget PER TENANT: one "
                         "tenant's burst spreads across iterations "
                         "while other tenants keep admitting (default: "
                         "MXNET_SERVING_TENANT_BUDGET or unbounded; "
                         "requests carry a 'tenant' field, default "
                         "'default')")
    ap.add_argument("--priority", type=int, default=0,
                    help="default priority for requests that don't "
                         "carry a 'priority' field (higher admits "
                         "first; default 0)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default per-request deadline: shed at "
                         "admission when the observed service rate "
                         "can't meet it (503 + computed Retry-After), "
                         "drop unstarted work past it (504) (default: "
                         "MXNET_SERVING_DEADLINE_MS or none; requests "
                         "may override via a 'deadline_ms' field)")
    ap.add_argument("--brownout", action="store_true", default=None,
                    help="graceful degradation under sustained "
                         "saturation: shed the lowest priority class "
                         "first, then clamp max_new_tokens of newly "
                         "admitted work (default: the "
                         "MXNET_SERVING_BROWNOUT env var)")
    ap.add_argument("--respawn-max", type=int, default=None,
                    help="with --replicas: how many times a dead "
                         "replica is rebuilt before its crash-loop "
                         "circuit opens (default: "
                         "MXNET_REPLICA_RESPAWN_MAX or 3)")
    ap.add_argument("--aot-cache", default=None, metavar="DIR",
                    help="persistent AOT cache directory: the kernel "
                         "libraries (and AOTInductor packages) are "
                         "published here and warm-loaded on restart — "
                         "zero nvcc builds, bit-identical logits "
                         "(default: MXNET_AOT_CACHE_DIR or off; "
                         "pre-populate with "
                         "python -m mxnet_tpu_torch.tools.aot_warm)")
    ap.add_argument("--autoscale", action="store_true", default=None,
                    help="SLO-driven elastic autoscaling: grow the "
                         "fleet on TTFT burn breach, drain + retire on "
                         "sustained idle (default: the "
                         "MXNET_SERVING_AUTOSCALE env var; bounds from "
                         "--min/--max-replicas)")
    ap.add_argument("--min-replicas", type=int, default=None,
                    help="autoscale floor (default: "
                         "MXNET_SERVING_MIN_REPLICAS or 1)")
    ap.add_argument("--max-replicas", type=int, default=None,
                    help="autoscale ceiling (default: "
                         "MXNET_SERVING_MAX_REPLICAS or 4)")
    ap.add_argument("--rollout-dir", default=None, metavar="DIR",
                    help="live weight rollout: watch this checkpoint "
                         "directory for newly published steps — verify,"
                         " parity-gate a canary replica, shift traffic "
                         "through weighted stages, then promote or "
                         "roll back with zero requests lost (default: "
                         "MXNET_SERVING_ROLLOUT_DIR or off; drive "
                         "overrides with tools/rollout.py)")
    ap.add_argument("--draft", type=int, default=None, metavar="N",
                    help="speculative decoding with a truncated SELF-"
                         "draft: the first N layers of the served model "
                         "propose --spec-k tokens per iteration and the "
                         "full model scores k+1 positions in one paged "
                         "pass — greedy verification keeps output "
                         "token-identical to plain decode (default: "
                         "MXNET_SPEC_DECODE/MXNET_SPEC_DRAFT_LAYERS; "
                         "needs the paged path; ineligible configs "
                         "fall back with the reason printed)")
    ap.add_argument("--spec-k", type=int, default=None,
                    help="draft tokens proposed per decode iteration "
                         "(default: MXNET_SPEC_K or 4; admission prices "
                         "a speculating sequence at k+1 tokens)")
    ap.add_argument("--kv-quant", action="store_true", default=None,
                    help="store the paged KV pool as int8 with per-"
                         "block-per-head f32 scales, dequantized inside "
                         "the paged kernel (~2x less device memory read "
                         "per decode step, ~4x more resident sequences; "
                         "precision pinned against the f32 oracle — "
                         "default: MXNET_QUANTIZED_KV; needs the paged "
                         "path, ineligible configs fall back with the "
                         "reason printed)")
    ap.add_argument("--weight-quant", default=None, metavar="MODE",
                    help="quantize the matmul weights at load: 'int8' "
                         "= per-output-channel symmetric int8 with "
                         "dynamic per-row activation quant "
                         "(embeds/norms/head stay f32; default: "
                         "MXNET_QUANTIZED_WEIGHTS or off)")
    ap.add_argument("--roles", default=None, metavar="SPEC",
                    help="disaggregated fleet layout 'prefill:N,"
                         "decode:M': prefill replicas absorb prompt "
                         "processing and migrate finished prompts to "
                         "decode replicas over the replay transport "
                         "(KV blocks the target already caches are "
                         "skipped); replica count = N+M and --replicas "
                         "is ignored (default: MXNET_SERVING_ROLES or "
                         "off)")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = require_device(args.device)
    if args.draft is not None:
        # route through the env knobs so every construction path (single
        # server, router respawn, autoscale grow, rollout canary) builds
        # the same self-draft from its own copy of the weights
        os.environ["MXNET_SPEC_DECODE"] = "1"
        os.environ["MXNET_SPEC_DRAFT_LAYERS"] = str(args.draft)
    if args.min_replicas is not None:
        os.environ["MXNET_SERVING_MIN_REPLICAS"] = str(args.min_replicas)
    if args.max_replicas is not None:
        os.environ["MXNET_SERVING_MAX_REPLICAS"] = str(args.max_replicas)

    from mxnet_tpu_torch import serving

    if args.demo:
        model = demo_model(device)
        print("serving DEMO transformer (random weights, vocab %d)"
              % model[1].vocab)
    elif args.model:
        model = args.model
        print("serving artifact %s" % args.model)
    else:
        ap.error("pass --model artifact.mxtpu or --demo")

    # placement flags (--paged/--tp/--replicas) are read HERE, at
    # construction, and frozen: the Engine raises on post-start
    # mutation, so a replica can never straddle two configs — restart
    # the process to change placement
    kwargs = dict(max_batch=args.max_batch,
                  max_queue=args.max_queue,
                  block_size=args.block_size,
                  queue_timeout=args.queue_timeout,
                  paged=args.paged,
                  prefill_chunk=args.prefill_chunk,
                  token_budget=args.token_budget,
                  tp=args.tp,
                  replicas=args.replicas,
                  prefix_cache=args.prefix_cache,
                  tenant_budget=args.tenant_budget,
                  default_priority=args.priority,
                  default_deadline_ms=args.deadline_ms,
                  brownout=args.brownout,
                  aot_cache=args.aot_cache,
                  autoscale=args.autoscale,
                  roles=args.roles,
                  rollout=args.rollout_dir,
                  spec_k=args.spec_k,
                  kv_quant=args.kv_quant,
                  weight_quant=args.weight_quant,
                  device=device)
    if args.respawn_max is not None:
        n = (args.replicas if args.replicas is not None
             else serving.serving_replicas())
        if n <= 1:
            ap.error("--respawn-max needs a multi-replica front door "
                     "(--replicas > 1 or MXNET_SERVING_REPLICAS > 1)")
        kwargs["respawn_max"] = args.respawn_max
    srv = serving.serve(model, **kwargs)
    _describe(srv, args)
    if threading.current_thread() is threading.main_thread():
        # SIGTERM (and SIGINT, also where the launcher ignored it) end
        # the loop through serve_http's KeyboardInterrupt path
        signal.signal(signal.SIGTERM, _raise_interrupt)
        signal.signal(signal.SIGINT, _raise_interrupt)
    if on_serving is not None:
        on_serving(srv)
    print("listening on http://%s:%d  (POST /v1/generate, "
          "GET /v1/metrics, GET /statusz)" % (args.host, args.port),
          flush=True)
    srv.serve_http(host=args.host, port=args.port, block=True)
    print("stopped: %s" % json.dumps(stop_summary(srv)), flush=True)
    return 0


def _describe(srv, args):
    """Print the server's configuration as the reference CLI does."""
    from mxnet_tpu_torch import aot, serving, telemetry
    if isinstance(srv, serving.ReplicatedLMServer):
        eng = srv.replicas[0].engine
        print("front door: %d replicas, tp=%d per replica%s"
              % (len(srv.replicas), eng.tp,
                 " (tp fallback: %s)" % eng.tp_fallback
                 if eng.tp_fallback else ""))
        if srv._roles is not None:
            print("roles: %s — prompts prefill on the prefill "
                  "replicas, then migrate to a decode replica "
                  "(replay transport, prefix-cached KV blocks "
                  "skipped; co-scheduled fallback on role loss)"
                  % ", ".join("%s:%d" % (k, v)
                              for k, v in srv._roles.items()))
        first = srv.replicas[0]
    else:
        first = srv
        if srv.engine.tp_fallback:
            print("tp fallback: %s" % srv.engine.tp_fallback)
    eng = first.engine
    print("config: device=%s paged=%s prefill_chunk=%s block_size=%d "
          "max_batch=%d max_queue=%d"
          % (args.device, "on" if eng.paged else "off",
             eng.prefill_chunk or "-", args.block_size, args.max_batch,
             args.max_queue))
    if eng.prefix_cache is not None:
        print("prefix cache: on (content-addressed KV block reuse, "
              "copy-on-write, LRU eviction)")
    elif eng.prefix_cache_fallback:
        print("prefix cache: OFF — %s" % eng.prefix_cache_fallback)
    else:
        print("prefix cache: off")
    if eng.spec:
        print("speculative decoding: on — k=%d, %d-layer draft "
              "(greedy verification: flag switches speed, never "
              "logits; admission prices each sequence at k+1)"
              % (eng.spec_k, eng.draft.cfg.n_layers))
    elif eng.spec_fallback:
        print("speculative decoding: OFF — %s" % eng.spec_fallback)
    else:
        print("speculative decoding: off (--draft N --spec-k K, or "
              "MXNET_SPEC_DECODE=1 + MXNET_SPEC_DRAFT_LAYERS=N)")
    if eng.kv_quant or eng.weight_quant:
        print("quantized serving: kv=%s weights=%s — %d KV bytes/token "
              "(precision pinned vs the f32 oracle; flags frozen at "
              "construction)"
              % ("int8" if eng.kv_quant else "f32",
                 eng.weight_quant or "f32", eng.kv_bytes_per_token()))
    elif eng.kv_quant_fallback or eng.weight_quant_fallback:
        if eng.kv_quant_fallback:
            print("kv quant: OFF — %s" % eng.kv_quant_fallback)
        if eng.weight_quant_fallback:
            print("weight quant: OFF — %s" % eng.weight_quant_fallback)
    else:
        print("quantized serving: off (--kv-quant / --weight-quant "
              "int8, or MXNET_QUANTIZED_KV=1 / "
              "MXNET_QUANTIZED_WEIGHTS=int8)")
    print("tenants: budget=%s tokens/iteration, default priority=%d "
          "(per-request 'tenant'/'priority' JSON fields accepted)"
          % (first.scheduler.tenant_budget or "unbounded",
             args.priority))
    print("survival: deadline=%s brownout=%s%s"
          % ("%.0fms" % first.default_deadline_ms
             if first.default_deadline_ms else "none",
             "on" if first.scheduler.brownout else "off",
             (" respawn_max=%d" % srv.respawn_max)
             if isinstance(srv, serving.ReplicatedLMServer) else ""))
    cdir = aot.cache_dir()
    if cdir:
        print("aot cache: %s (%d warm load(s) so far; restarts load the "
              "kernel libraries instead of building them — pre-populate "
              "with python -m mxnet_tpu_torch.tools.aot_warm)"
              % (cdir, eng.warm_loads))
    else:
        print("aot cache: off (set MXNET_AOT_CACHE_DIR or --aot-cache "
              "to make restarts build-free)")
    if getattr(srv, "autoscaler", None) is not None:
        c = srv.autoscaler.cfg
        print("autoscale: on — replicas %d..%d, scale up at burn>=%g "
              "(two shortest windows), retire after %gs idle at "
              "burn<=%g, cooldown %gs"
              % (c.min_replicas, c.max_replicas, c.up_burn,
                 c.idle_retire_s, c.down_burn, c.cooldown_s))
    else:
        print("autoscale: off")
    ro = getattr(srv, "rollout", None)
    if ro is not None:
        print("rollout: watching %s — canary ladder %s, %gs windows, "
              "%d parity prompts (overrides: tools/rollout.py "
              "--promote/--rollback/--reject)"
              % (ro.directory,
                 "/".join("%g" % f for f in ro.stages),
                 ro.window_s, ro.parity_prompts))
    else:
        print("rollout: off (set MXNET_SERVING_ROLLOUT_DIR or "
              "--rollout-dir to roll new checkpoints out live)")
    slo_objs = [o.describe() for o in telemetry.parse_slo_env()]
    if slo_objs:
        print("slo: %d objective(s) armed — %s (burn on /statusz and "
              "/metrics)"
              % (len(slo_objs),
                 ", ".join("%s%s" % (o["objective"],
                                     "@" + o["tenant"] if o["tenant"]
                                     else "") for o in slo_objs)))


if __name__ == "__main__":
    sys.exit(main())
