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
`/statusz`, `/metrics`, `/healthz`). `serve(replicas=N)`,
`serve(roles="prefill:1,decode:2")` and `serve(autoscale=True)` put a
fleet of servers behind one door (router.py: least-loaded routing,
failover and respawn, prefill/decode migration; autoscale.py), and
`serve(rollout=<checkpoint dir>)` rolls newly published weights out
through a gated canary (rollout.py). `tp=k` shards one engine over a
window of devices (tp.py). Besides the transformer, `serve()` takes a
Gluon Block (`BlockLM`) or a `.mxtpu` artifact (`ExportedLM`), served by
full forwards; `aot_cache=` loads the kernel libraries from the AOT
cache.

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
from .engine import (BlockLM, Engine, ExportedLM, Sequence, TransformerLM,
                     pow2_bucket)
from .scheduler import (Scheduler, Request, QueueFull, RequestTimeout,
                        DeadlineExceeded, DeadlineUnmeetable,
                        BrownoutShed, make_resume)
from .metrics import ServingMetrics
from .server import LMServer, serve, spawn_resume, spawn_migrate
from .router import (ReplicatedLMServer, serving_replicas,
                     serving_respawn_max, serving_roles, replica_device,
                     NoHealthyReplicas)
from .autoscale import Autoscaler, AutoscaleConfig, autoscale_enabled
from .rollout import (RolloutController, RejectionRoster, rollout_dir,
                      rollout_stages, rollout_window_s,
                      rollout_parity_prompts)
from .tp import serving_tp, tp_cache_variant
from .spec import (DraftLM, self_draft, spec_decode_enabled, spec_k,
                   spec_draft_layers)

__all__ = [
    "BlockPool", "PagedKVCache", "CacheOverflow",
    "PrefixCache", "prefix_cache_enabled",
    "DraftLM", "self_draft", "spec_decode_enabled", "spec_k",
    "spec_draft_layers",
    "BlockLM", "Engine", "ExportedLM", "Sequence", "TransformerLM",
    "pow2_bucket",
    "Scheduler", "Request", "QueueFull", "RequestTimeout",
    "DeadlineExceeded", "DeadlineUnmeetable", "BrownoutShed",
    "make_resume", "spawn_resume", "spawn_migrate",
    "ServingMetrics", "LMServer", "serve",
    "ReplicatedLMServer", "serving_replicas", "serving_respawn_max",
    "serving_roles", "replica_device", "NoHealthyReplicas",
    "Autoscaler", "AutoscaleConfig", "autoscale_enabled",
    "RolloutController", "RejectionRoster", "rollout_dir",
    "rollout_stages", "rollout_window_s", "rollout_parity_prompts",
    "serving_tp", "tp_cache_variant",
]
