"""Serving metrics (port of `mxnet_tpu/serving/metrics.py`, reduced to
what `LMServer.snapshot()` reports): request outcomes, time to first
token, decode-step time, tokens per second and engine failures, the
path counters (paged/gather decode steps, prefill chunks) that show which
implementation served the traffic, and the options' counters under the
reference's names: speculative passes, proposed and accepted tokens and
fallbacks (`snapshot()["spec"]`), the prefix cache's lookups, hits, hit
tokens, COW copies, evictions and residents (`["cache"]["prefix"]`), and
the quantization gauges (`["quant"]`).

The counters live on a private `telemetry.MetricsRegistry` per server;
latencies are fixed-bucket histograms, so p50/p95/p99 need no per-sample
storage. All times are host wall-clock seconds (`time.perf_counter`),
taken after the step's device work has been read back.
"""
from __future__ import annotations

import time

from .. import telemetry


def _ms(v):
    return None if v is None else 1e3 * v


#: tokens emitted per sequence per speculative pass: 1 (only the
#: target's own token) up to k+1
_SPEC_BUCKETS = (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 5.0, 6.0, 8.0, 12.0, 16.0)


class ServingMetrics:
    def __init__(self):
        self._t0 = time.perf_counter()
        self.registry = reg = telemetry.MetricsRegistry()
        c, h = reg.counter, reg.histogram
        self._submitted = c("serving_requests_submitted_total",
                            help="requests accepted by submit()")
        self._rejected = c("serving_requests_rejected_total",
                           help="requests bounced by queue backpressure")
        self._expired = c("serving_requests_expired_total",
                          help="requests failed at admission (timeout "
                               "or unservable)")
        self._completed = c("serving_requests_completed_total",
                            help="requests finished successfully")
        self._failed = c("serving_requests_failed_total",
                         help="requests finished with an error")
        self._engine_failures = c(
            "serving_engine_failures_total",
            help="engine exceptions absorbed by the serving loop "
                 "(requests failed, loop kept alive)")
        self._tokens = c("serving_tokens_generated_total",
                         help="tokens emitted by decode steps")
        self._steps_paged = c("serving_decode_steps_paged_total",
                              help="decode steps on the paged kernel path")
        self._steps_gather = c("serving_decode_steps_gather_total",
                               help="decode steps on the gather path")
        self._chunks = c("serving_prefill_chunks_total",
                         help="chunked-prefill steps run (paged path)")
        self._h_ttft = h("serving_ttft_seconds",
                         help="time from submit to the first token")
        self._h_step = h("serving_decode_step_seconds",
                         help="wall time of one batched decode step")
        self._spec_passes = c("serving_spec_passes_total",
                              help="speculative scoring passes (one "
                                   "draft+score+verify round per decode "
                                   "iteration)")
        self._spec_proposed = c("serving_spec_proposed_tokens_total",
                                help="draft tokens proposed to the target")
        self._spec_accepted = c("serving_spec_accepted_tokens_total",
                                help="draft tokens the target accepted "
                                     "(excludes the per-pass bonus or "
                                     "correction token)")
        self._spec_fallbacks = c("serving_spec_fallback_total",
                                 help="speculative passes degraded to the "
                                      "plain decode step (draft fault)")
        self._h_spec_accepted = h("serving_spec_accepted_per_pass",
                                  buckets=_SPEC_BUCKETS,
                                  help="tokens emitted per sequence per "
                                       "speculative pass (accepted + 1)")

    @property
    def engine_failures(self):
        return int(self._engine_failures.value)

    @property
    def decode_steps(self):
        return int(self._steps_paged.value + self._steps_gather.value)

    @property
    def prefill_chunks(self):
        return int(self._chunks.value)

    # -- recording -----------------------------------------------------------

    def request_submitted(self):
        self._submitted.inc()

    def request_rejected(self):
        self._rejected.inc()

    def engine_failure(self):
        self._engine_failures.inc()

    def request_expired(self):
        """Counts the expiry only; request_finished() (always called
        after) does the outcome accounting exactly once."""
        self._expired.inc()

    def prefill_chunk(self):
        self._chunks.inc()

    def request_prefilled(self, req):
        """The request's first token was just sampled."""
        req.t_first_token = time.perf_counter()
        self._h_ttft.observe(req.t_first_token - req.t_submit)

    def decode_step(self, active, step_s, paged, tokens=None):
        """One decode iteration advanced `active` sequences in `step_s`
        seconds and emitted `tokens` (default: one per sequence; a
        speculative step emits a burst)."""
        (self._steps_paged if paged else self._steps_gather).inc()
        self._h_step.observe(step_s)
        self._tokens.inc(active if tokens is None else tokens)

    def spec_pass(self, batch=0, proposed=0, accepted=0, emitted=0,
                  fallback=False):
        """One speculative round (the engine's `last_spec`): a completed
        draft+score+verify pass over `batch` sequences, or a degraded one
        (`fallback=True`: the batch ran the plain step)."""
        if fallback:
            self._spec_fallbacks.inc()
            return
        self._spec_passes.inc()
        self._spec_proposed.inc(proposed)
        self._spec_accepted.inc(accepted)
        if batch:
            self._h_spec_accepted.observe(emitted / float(batch))

    def request_finished(self, req):
        (self._completed if req.error is None else self._failed).inc()

    # -- reading -------------------------------------------------------------

    def snapshot(self, engine=None, scheduler=None):
        """One dict: the HTTP /metrics body and the test observable.
        tokens_per_sec is the lifetime average since the server started;
        latencies are in milliseconds."""
        elapsed = time.perf_counter() - self._t0
        tokens = int(self._tokens.value)
        t, s = self._h_ttft, self._h_step
        snap = {
            "requests": {
                "submitted": int(self._submitted.value),
                "completed": int(self._completed.value),
                "failed": int(self._failed.value),
                "rejected": int(self._rejected.value),
                "expired": int(self._expired.value),
                "engine_failures": self.engine_failures,
            },
            "latency_ms": {
                "time_to_first_token_mean": _ms(t.mean),
                "time_to_first_token_p50": _ms(t.quantile(0.5)),
                "time_to_first_token_p95": _ms(t.quantile(0.95)),
                "time_to_first_token_p99": _ms(t.quantile(0.99)),
                "decode_step_mean": _ms(s.mean),
                "decode_step_p50": _ms(s.quantile(0.5)),
                "decode_step_p95": _ms(s.quantile(0.95)),
                "decode_step_p99": _ms(s.quantile(0.99)),
            },
            "throughput": {
                "tokens_generated": tokens,
                "tokens_per_sec": tokens / elapsed if elapsed > 0 else None,
                "decode_steps": self.decode_steps,
            },
            "paths": {
                "paged_decode_steps": int(self._steps_paged.value),
                "gather_decode_steps": int(self._steps_gather.value),
                "prefill_chunks": self.prefill_chunks,
            },
        }
        if engine is not None:
            pool = engine.cache.pool
            snap["engine"] = {
                "device": str(engine.device),
                "max_batch": engine.max_batch,
                "max_len": engine.max_len,
                "paged_attention": bool(engine.paged),
                "prefill_chunk": engine.prefill_chunk,
                "prefix_cache": engine.prefix_cache is not None,
                "spec_decode": bool(engine.spec),
            }
            for name in ("kv_quant_fallback", "spec_fallback",
                         "prefix_cache_fallback"):
                if getattr(engine, name):
                    snap["engine"][name] = getattr(engine, name)
            snap["cache"] = {
                "block_utilization": engine.cache_utilization(),
                "blocks_in_use": pool.in_use,
                "blocks_available": pool.available,
                "blocks_high_water": pool.high_water,
                "blocks_total": engine.cache.num_blocks - 1,
            }
            if engine.spec or engine.spec_passes:
                h = self._h_spec_accepted
                snap["spec"] = {
                    "k": engine.spec_k,
                    "passes": engine.spec_passes,
                    "proposed_tokens": engine.spec_proposed_tokens,
                    "accepted_tokens": engine.spec_accepted_tokens,
                    "fallbacks": engine.spec_fallbacks,
                    "acceptance_rate": (
                        engine.spec_accepted_tokens
                        / engine.spec_proposed_tokens
                        if engine.spec_proposed_tokens else None),
                    "accepted_per_pass": h.sum / h.count if h.count
                    else None,
                }
            pc = engine.prefix_cache
            if pc is not None:
                snap["cache"]["prefix"] = {
                    "lookups": pc.lookups,
                    "hits": pc.hits,
                    "misses": pc.misses,
                    "hit_rate": pc.hit_rate,
                    "hit_tokens": pc.hit_tokens_total,
                    "evictions": pc.evictions,
                    "cow_copies": pc.cow_copies,
                    "inserts": pc.inserts,
                    "resident_tokens": pc.resident_tokens,
                    "resident_blocks": len(pc),
                }
            if engine.kv_quant or engine.weight_quant:
                # the reference's quantization gauges, named as there
                snap["quant"] = {
                    "serving_kv_quant_enabled": int(engine.kv_quant),
                    "serving_weight_quant_enabled":
                        int(bool(engine.weight_quant)),
                    "serving_kv_quant_bytes_per_token":
                        engine.kv_bytes_per_token(),
                }
        if scheduler is not None:
            snap["scheduler"] = {
                "token_budget": scheduler.token_budget,
                "queued": scheduler.pending(),
                "prefilling": len(scheduler.prefilling),
            }
        return snap
