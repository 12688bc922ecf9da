"""mxnet_tpu_torch.serving — continuous-batching LM inference on the card.

A paged KV-cache (fixed-shape block pools on the device, float or int8
with per-block scales, a host free-list), a prefill/decode engine whose
paged path runs the hand-written paged-attention kernel once per layer
(decode steps, chunked prefill and speculative scoring), int8 weights,
draft-model speculative decoding (spec.py), a content-addressed prefix
cache (prefix_cache.py), a continuous-batching scheduler with
backpressure, a per-iteration token budget, priority classes, per-tenant
token budgets, deadlines and brownout, serving metrics with the goodput
ledger and SLO burn (`statusz()`, Prometheus text), and an in-process
`serve()` API with a stdlib HTTP frontend (W3C `traceparent` in and out,
`/statusz`, `/metrics`, `/healthz`).

Quickstart::

    from mxnet_tpu_torch import serving
    srv = serving.serve((params, cfg), max_batch=8, paged=True,
                        kv_quant=True, weight_quant="int8",
                        draft=serving.self_draft(params, cfg, 2),
                        spec_k=3, prefix_cache=True)
    out = srv.generate([1, 2, 3], max_new_tokens=16)
    print(out, srv.snapshot()["throughput"])
    srv.close()
"""
from .kv_cache import BlockPool, PagedKVCache, CacheOverflow
from .prefix_cache import PrefixCache, prefix_cache_enabled
from .engine import Engine, Sequence, TransformerLM, pow2_bucket
from .scheduler import (Scheduler, Request, QueueFull, RequestTimeout,
                        DeadlineExceeded, DeadlineUnmeetable,
                        BrownoutShed, make_resume)
from .metrics import ServingMetrics
from .server import LMServer, serve, spawn_resume
from .spec import (DraftLM, self_draft, spec_decode_enabled, spec_k,
                   spec_draft_layers)

__all__ = [
    "BlockPool", "PagedKVCache", "CacheOverflow",
    "PrefixCache", "prefix_cache_enabled",
    "DraftLM", "self_draft", "spec_decode_enabled", "spec_k",
    "spec_draft_layers",
    "Engine", "Sequence", "TransformerLM", "pow2_bucket",
    "Scheduler", "Request", "QueueFull", "RequestTimeout",
    "DeadlineExceeded", "DeadlineUnmeetable", "BrownoutShed",
    "make_resume", "spawn_resume",
    "ServingMetrics", "LMServer", "serve",
]
