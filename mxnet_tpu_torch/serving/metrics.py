"""Serving metrics: request latency, throughput, occupancy, cache use,
the goodput token ledger and the SLO views (port of
`mxnet_tpu/serving/metrics.py`).

The counters live on a `telemetry.MetricsRegistry` (one PRIVATE registry
per ServingMetrics, so parallel servers and tests never share state):
every request/token/step counter is a registry Counter, the latency sums
are fixed-bucket Histograms (p50/p95/p99 without per-sample storage),
and the scheduler/block-pool observables are Gauges refreshed on read.
Three read paths share that one source of truth:

  * `snapshot()` — the HTTP JSON `/metrics` body and the test
    observable, in the reference's key tree (means derived from
    histogram sum/count); a quantized engine adds `["quant"]`, the
    reference's quantization gauges by name;
  * `prometheus_text()` — Prometheus text exposition, what the HTTP
    endpoint serves under `Accept: text/plain`;
  * `statusz()` — the /statusz JSON body: token ledgers, per-tenant
    breakdown and the SLO block.

Phase timings also land in the profiler through the telemetry span
layer (engine spans carry the request's trace id), so a chrome trace or
Perfetto export of a serving run shows one request's queue → prefill →
decode life as a single connected row. All times are host wall-clock
seconds (`time.perf_counter`), taken after the step's device work has
been read back.
"""
from __future__ import annotations

import threading
import time

from .. import profiler
from .. import telemetry
from ..telemetry import slo as _slo

_DOMAIN = profiler.Domain("serving")

#: decode/prefill batch-size buckets (powers of two up to a big pod batch)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
_OCCUPANCY_BUCKETS = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)
#: accepted-tokens-per-pass buckets: 1.0 is the floor (every
#: speculative pass emits at least the target's own token), spec_k+1 the
#: ceiling; fractional edges resolve the sub-token differences that
#: decide whether speculation pays for the draft
_SPEC_BUCKETS = (1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0)

#: per-tenant instrument-name templates (the reference's
#: docs/OBSERVABILITY.md names these with a `<tenant>` placeholder).
#: Token counters share the terminal-classification ledger documented
#: in telemetry/slo.py:
#: submitted == goodput + slow + shed + expired + failed, always.
_TENANT_TOKEN_KINDS = ("submitted", "goodput", "slow", "shed",
                       "expired", "failed", "replayed")
_T_TOKENS = "serving_tenant_%s_%s_tokens_total"
_T_TTFT = "serving_tenant_%s_ttft_seconds"
_T_ITL = "serving_tenant_%s_itl_seconds"
_T_REQ_DONE = "serving_tenant_%s_requests_completed_total"
_T_REQ_FAIL = "serving_tenant_%s_requests_failed_total"


class ServingMetrics:
    def __init__(self, registry=None, replica=None):
        """`replica=` stamps every sample of this server's registry with
        a `replica` label — the multi-replica front door gives each
        engine replica its own ServingMetrics and aggregates the
        registries into one exposition (docs/OBSERVABILITY.md)."""
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        if registry is None:
            labels = {"replica": str(replica)} if replica is not None \
                else None
            registry = telemetry.MetricsRegistry(labels=labels)
        self.registry = registry
        self.replica = replica
        reg = self.registry
        c, g, h = reg.counter, reg.gauge, reg.histogram
        # the fleet-wide goodput token ledger. Every request
        # is classified EXACTLY ONCE at its terminal state (see
        # telemetry/slo.py): submitted == goodput + slow + shed +
        # expired + failed at every instant; replayed counts failover
        # salvage separately (extra work, not a terminal class).
        self._tok = {}
        for kind, help_ in (
                ("submitted", "tokens classified at terminal "
                              "accounting (the sum of goodput + slow + "
                              "shed + expired + failed)"),
                ("goodput", "delivered tokens whose request met its "
                            "SLO (TTFT objective + deadline)"),
                ("slow", "delivered tokens whose request violated its "
                         "SLO — served, but late"),
                ("shed", "tokens of requests shed at admission "
                         "(unmeetable deadline, brownout)"),
                ("expired", "tokens of requests that expired in queue "
                            "(deadline/timeout passed before prefill)"),
                ("failed", "tokens of requests that failed (engine "
                           "fault, orphaned by a dead replica)")):
            self._tok[kind] = c("serving_%s_tokens_total" % kind,
                                help=help_)
        self._h_itl = h("serving_itl_seconds",
                        help="per-request inter-token latency (gap "
                             "between consecutive emitted tokens, "
                             "failover stalls included)")
        # per-tenant ledgers + latency histograms, created lazily on a
        # tenant's first traffic (name templates above)
        self._tenants = {}
        # SLO objectives (MXNET_SLO_*; read at construction) + burn
        # tracking over this registry's own histograms
        self.slo = _slo.SLOTracker(reg, self._slo_counts)
        # fail LOUDLY at construction on a malformed sample knob — the
        # per-event path downgrades to a warning instead of letting a
        # config typo kill the serving thread
        if _slo.request_log().enabled:
            _slo.request_log().sample_rate()
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
            "serving_engine_failures_total", flight=True,
            help="engine exceptions absorbed by the serving loop "
                 "(requests failed, loop kept alive)")
        # survival-layer observables (deadlines, brownout, failover)
        self._deadline_shed = c(
            "serving_deadline_shed_total",
            help="requests shed on deadline: admission-time unmeetable "
                 "sheds plus queue expiries dropped before prefill")
        self._brownout_shed = c(
            "serving_brownout_shed_total",
            help="requests shed by brownout mode (lowest priority "
                 "class under sustained saturation)")
        self._failovers = c(
            "serving_failover_total", flight=True,
            help="in-flight requests re-homed as a prefill replay "
                 "(cross-replica on drain/death, or a local resume "
                 "after a decode fault)")
        self._failover_tokens = c(
            "serving_failover_resumed_tokens_total",
            help="already-generated tokens salvaged by failover "
                 "replays (not re-decoded, only re-prefilled)")
        # disaggregated-serving observables: the planned,
        # every-request version of the failover hop — prefill replicas
        # hand finished prompts to decode replicas over the same replay
        # transport, no failover budget spent
        self._migrations = c(
            "serving_migration_total", flight=True,
            help="planned prefill->decode migration hops placed "
                 "(disaggregated serving; replay transport)")
        self._migration_tokens = c(
            "serving_migration_tokens_total",
            help="tokens carried across migration hops (prompt + "
                 "generated-so-far, re-prefilled on the decode "
                 "replica rather than re-decoded)")
        self._migration_bytes = c(
            "serving_migration_bytes_saved_total",
            help="KV-cache bytes migration hops did NOT rebuild "
                 "because the target's prefix cache already held "
                 "the blocks (priced at the target engine's KV "
                 "layout, accounted per hop at target admission)")
        self._g_brownout = g(
            "serving_brownout_active",
            help="1 while brownout shedding/clamping is engaged")
        self._tokens = c("serving_tokens_generated_total",
                         help="decode tokens emitted")
        self._steps = c("serving_decode_steps_total",
                        help="decode engine steps")
        self._steps_paged = c("serving_decode_steps_paged_total",
                              help="decode steps served by the paged "
                                   "attention kernel")
        self._steps_gather = c("serving_decode_steps_gather_total",
                               help="decode steps served by the dense "
                                    "gather path")
        self._chunks = c("serving_prefill_chunks_total",
                         help="chunked-prefill kernel calls")
        # prefix-cache observables: counters synced from the
        # engine's PrefixCache monotonic stats on every read path
        self._prefix_lookups = c("serving_prefix_lookups_total",
                                 help="prefix-cache lookups at admission")
        self._prefix_hits = c("serving_prefix_hits_total",
                              help="admissions served >=1 shared block")
        self._prefix_misses = c("serving_prefix_misses_total",
                                help="admissions with no reusable prefix")
        self._prefix_hit_tokens = c(
            "serving_prefix_hit_tokens_total",
            help="prompt tokens whose prefill was skipped via shared "
                 "blocks")
        self._prefix_evictions = c(
            "serving_prefix_evictions_total",
            help="cached blocks evicted LRU under pool pressure")
        self._prefix_cow = c(
            "serving_prefix_cow_total",
            help="copy-on-write block copies (divergence mid-block / "
                 "write into a shared tail)")
        self._prefix_inserts = c("serving_prefix_inserts_total",
                                 help="blocks registered as reusable "
                                      "content")
        self._g_prefix_resident = g(
            "serving_prefix_resident_tokens",
            help="tokens of KV currently resident in the prefix cache")
        self._g_prefix_blocks = g(
            "serving_prefix_resident_blocks",
            help="pool blocks the prefix cache currently holds")
        self._g_prefix_hit_rate = g(
            "serving_prefix_hit_rate",
            help="lifetime prefix-cache hit rate (hits / lookups)")
        # paged-serving observables as gauges, so they appear in
        # the Prometheus exposition, not just the JSON snapshot
        self._g_queue = g("serving_queue_depth",
                          help="requests waiting for admission")
        self._g_prefill_backlog = g("serving_prefill_queue_depth",
                                    help="sequences mid-chunked-prefill")
        self._g_token_budget = g("serving_token_budget",
                                 help="scheduler per-iteration token "
                                      "budget (0 = unbounded)")
        self._g_in_use = g("serving_blocks_in_use",
                           help="KV-cache pool blocks allocated")
        self._g_available = g("serving_blocks_available",
                              help="KV-cache pool blocks free")
        self._g_high_water = g("serving_blocks_high_water",
                               help="max pool blocks ever in use")
        self._g_util = g("serving_block_utilization",
                         help="pool blocks in use / total")
        self._h_queue = h("serving_queue_seconds",
                          help="submit -> admission wait")
        self._h_prefill = h("serving_prefill_seconds",
                            help="per-request prefill compute (all "
                                 "chunks)")
        self._h_ttft = h("serving_ttft_seconds",
                         help="submit -> first token")
        self._h_total = h("serving_request_seconds",
                          help="submit -> completion")
        self._h_step = h("serving_decode_step_seconds",
                         help="one batched decode step")
        self._h_batch = h("serving_decode_batch",
                          buckets=_BATCH_BUCKETS,
                          help="live sequences per decode step")
        self._h_occupancy = h("serving_decode_occupancy",
                              buckets=_OCCUPANCY_BUCKETS,
                              help="decode batch fill fraction "
                                   "(active/max_batch)")
        # speculative decoding
        self._spec_passes = c("serving_spec_passes_total",
                              help="speculative scoring passes (one "
                                   "draft+score+verify round per "
                                   "decode iteration)")
        self._spec_proposed = c("serving_spec_proposed_tokens_total",
                                help="draft tokens proposed to the "
                                     "target for verification")
        self._spec_accepted = c("serving_spec_accepted_tokens_total",
                                help="draft tokens the target accepted "
                                     "(excludes the per-pass bonus/"
                                     "correction token)")
        self._spec_fallbacks = c("serving_spec_fallback_total",
                                 help="speculative passes degraded to "
                                      "the non-speculative path (draft "
                                      "fault / poisoned logits)")
        self._h_spec_accepted = h("serving_spec_accepted_per_pass",
                                  buckets=_SPEC_BUCKETS,
                                  help="tokens emitted per sequence per "
                                       "speculative pass (accepted + "
                                       "1; floor 1.0, ceiling k+1)")
        self._g_spec_rate = g("serving_spec_acceptance_rate",
                              help="lifetime accepted/proposed draft-"
                                   "token ratio")
        self._cache_util_last = None
        self._prefill_depth_last = 0
        # quantized-serving gauges, created lazily on the
        # first quant-enabled engine observed — plain attr here so a
        # quant-less exposition stays byte-for-byte unchanged (same
        # idiom as the router's per-role fleet gauges)
        self._quant_gauges = None
        # prompt tokens whose prefill compute has been observed — the
        # denominator feed for observed_prefill_rate() (plain attr, not
        # an exposition metric: it exists only to rate the h_prefill sum)
        self._prefill_tokens_obs = 0
        # decode tokens whose step time has been observed — numerator
        # feed for observed_token_rate(): under speculation one step
        # emits a BURST, so the rate must count tokens, not iterations
        # (same plain-attr pattern as _prefill_tokens_obs)
        self._step_tokens_obs = 0
        self._counter = _DOMAIN.new_counter("tokens_generated")

    # -- legacy attribute surface (health(), tests) --------------------------

    @property
    def submitted(self):
        return int(self._submitted.value)

    @property
    def rejected(self):
        return int(self._rejected.value)

    @property
    def expired(self):
        return int(self._expired.value)

    @property
    def completed(self):
        return int(self._completed.value)

    @property
    def failed(self):
        return int(self._failed.value)

    @property
    def engine_failures(self):
        return int(self._engine_failures.value)

    @property
    def deadline_shed(self):
        return int(self._deadline_shed.value)

    @property
    def brownout_shed(self):
        return int(self._brownout_shed.value)

    @property
    def failovers(self):
        return int(self._failovers.value)

    @property
    def failover_resumed_tokens(self):
        return int(self._failover_tokens.value)

    @property
    def migrations(self):
        return int(self._migrations.value)

    @property
    def migration_tokens(self):
        return int(self._migration_tokens.value)

    @property
    def migration_bytes_saved(self):
        return int(self._migration_bytes.value)

    @property
    def tokens_generated(self):
        return int(self._tokens.value)

    @property
    def decode_steps(self):
        return int(self._steps.value)

    @property
    def decode_steps_paged(self):
        return int(self._steps_paged.value)

    @property
    def decode_steps_gather(self):
        return int(self._steps_gather.value)

    @property
    def prefill_chunks(self):
        return int(self._chunks.value)

    # -- per-tenant ledger + SLO sources --------------------------------------

    #: distinct per-tenant instrument sets one server will create —
    #: tenant names arrive from CLIENT JSON, and ~11 instruments per
    #: name must not let a misbehaving client grow the registry (and
    #: every scrape) without bound; traffic beyond the cap folds into
    #: one "overflow" ledger, loudly named
    _TENANT_CAP = 64

    def _tenant(self, name):
        """This tenant's instrument set, created lazily on first
        traffic (token counters, TTFT/ITL histograms, request
        outcomes). All registry-backed, so the Prometheus exposition
        and /statusz read the same numbers. Keyed by the SANITIZED
        name — the same identity the metric names carry — so two raw
        names that sanitize identically share ONE ledger instead of
        aliasing the same counters under two entries (which the fleet
        aggregate would then double-count)."""
        from ..telemetry.metrics import _sane
        key = _sane(str(name) if name is not None else "default")
        t = self._tenants.get(key)
        if t is None:
            if len(self._tenants) >= self._TENANT_CAP \
                    and key != "overflow":
                return self._tenant("overflow")
            reg = self.registry
            name = key
            created = {
                "tokens": {k: reg.counter(
                    _T_TOKENS % (key, k),
                    help="tenant %r %s tokens (see the fleet "
                         "serving_%s_tokens_total ledger)"
                    % (name, k, k)) for k in _TENANT_TOKEN_KINDS},
                "ttft": reg.histogram(
                    _T_TTFT % key,
                    help="tenant %r submit -> first token" % name),
                "itl": reg.histogram(
                    _T_ITL % key,
                    help="tenant %r inter-token latency" % name),
                "completed": reg.counter(
                    _T_REQ_DONE % key,
                    help="tenant %r requests finished cleanly" % name),
                "failed": reg.counter(
                    _T_REQ_FAIL % key,
                    help="tenant %r requests finished with an error "
                         "(sheds and expiries included)" % name),
            }
            # insert under the lock: statusz()/_slo_counts iterate a
            # locked copy of this dict from HTTP threads while request
            # threads grow it (registry creation above is idempotent,
            # so a racing double-build resolves to the same metrics)
            with self._lock:
                t = self._tenants.setdefault(key, created)
        return t

    def _tenants_view(self):
        """A point-in-time copy safe to iterate while request threads
        add tenants."""
        with self._lock:
            return dict(self._tenants)

    def _account_tokens(self, req, kind, n):
        """Terminal classification: `n` tokens land on `kind` AND on
        `submitted`, fleet-wide and on the request's tenant — the
        ledger identity holds by construction."""
        n = int(n)
        if n < 0:
            n = 0
        t = self._tenant(req.tenant)["tokens"]
        self._tok[kind].inc(n)
        self._tok["submitted"].inc(n)
        t[kind].inc(n)
        t["submitted"].inc(n)

    def _slo_counts(self, obj):
        """Lifetime (good, total) for one objective, from this
        registry's own instruments (the SLOTracker's source)."""
        t = None
        if obj.tenant is not None:
            from ..telemetry.metrics import _sane
            t = self._tenants_view().get(_sane(obj.tenant))
        if obj.kind == "availability":
            if obj.tenant is None:
                good, bad = self.completed, self.failed
            else:
                good = int(t["completed"].value) if t else 0
                bad = int(t["failed"].value) if t else 0
            return float(good), float(good + bad)
        if obj.kind == "ttft":
            hist = self._h_ttft if obj.tenant is None else \
                (t["ttft"] if t else None)
        else:
            hist = self._h_itl if obj.tenant is None else \
                (t["itl"] if t else None)
        if hist is None:
            return 0.0, 0.0
        return (float(hist.count_below(obj.threshold_s)),
                float(hist.count))

    def _met_slo(self, req):
        """Did this (terminal, clean) request meet its SLO? The goodput
        classifier: the governing TTFT objective (tenant-scoped wins)
        plus the request's own absolute deadline. ITL objectives burn
        budget at the fleet level but don't reclassify single requests
        (one slow gap in a 500-token stream is not a failed delivery)."""
        thr = self.slo.ttft_threshold(req.tenant)
        if thr is not None and req.t_client_first_token is not None \
                and (req.t_client_first_token
                     - req.t_client_submit) > thr:
            return False
        if req.t_deadline is not None and req.t_done is not None and \
                req.t_done > req.t_deadline:
            return False
        return True

    def log_event(self, event, req, **fields):
        """Route one lifecycle event to the request log / flight mirror
        with this server's replica label attached."""
        _slo.request_event(event, req, replica=self.replica, **fields)

    # -- recording -----------------------------------------------------------

    def request_submitted(self, req=None):
        self._submitted.inc()
        if req is not None:
            self.log_event("queued", req, prompt_len=len(req.prompt),
                           max_new_tokens=req.max_new_tokens,
                           priority=req.priority,
                           deadline_ms=req.deadline_ms,
                           failovers=req.failovers or None)

    def request_rejected(self):
        self._rejected.inc()

    def engine_failure(self):
        self._engine_failures.inc()

    def request_deadline_shed(self, req=None):
        """Deadline shed. With `req` (the admission-time unmeetable
        path — the request is refused BEFORE it is ever submitted, so
        no request_finished() will run for it) this is also its
        terminal accounting: shed tokens + the lifecycle event. The
        queue-expiry path passes nothing — its terminal accounting
        happens in request_finished()."""
        self._deadline_shed.inc()
        if req is not None:
            # tokens land on `shed`; the request OUTCOME counters stay
            # untouched (fleet and tenant alike) — an admission refusal
            # is backpressure, not an availability failure, and the two
            # availability views must agree on what counts
            self._account_tokens(req, "shed", req.max_new_tokens)
            self.log_event("shed", req, reason="deadline_unmeetable",
                           max_new_tokens=req.max_new_tokens)

    def request_brownout_shed(self):
        self._brownout_shed.inc()

    def request_failover(self, req, resumed_tokens):
        """One failover replay placed for `req`'s trace: count it, and
        credit the salvaged tokens as `replayed` on the tenant ledger
        (extra work performed — NOT a terminal class; the replay's own
        finish classifies the delivery)."""
        self._failovers.inc()
        if resumed_tokens:
            self._failover_tokens.inc(resumed_tokens)
            self._tenant(req.tenant)["tokens"]["replayed"].inc(
                resumed_tokens)
        self.log_event("failover", req, resumed_tokens=resumed_tokens,
                       hop=req.failovers + 1)

    def request_migration(self, req, carried):
        """One planned prefill->decode migration hop placed for `req`'s
        trace (disaggregated serving). Counts the hop and the carried
        tokens; does NOT credit the tenant `replayed` ledger — replayed
        is failover salvage (unplanned extra work), and keeping the two
        apart preserves fleet-replayed == sum(tenant-replayed). The hop's
        own finish classifies the delivery exactly once."""
        self._migrations.inc()
        if carried:
            self._migration_tokens.inc(carried)
        self.log_event("migrate", req, carried_tokens=carried)

    def request_migration_savings(self, req, hit_tokens, nbytes):
        """Bytes of KV a migration hop skipped rebuilding because this
        (target) engine's prefix cache already held `hit_tokens` of the
        replayed prompt — accounted per hop, on the target, priced at the
        target's KV layout."""
        if nbytes:
            self._migration_bytes.inc(int(nbytes))
        self.log_event("migrate_savings", req, hit_tokens=hit_tokens,
                       bytes_saved=int(nbytes))

    def request_expired(self, req):
        """Counts the expiry only; request_finished() (always called
        after) does the failed/total accounting exactly once."""
        self._expired.inc()
        from .scheduler import BrownoutShed, DeadlineUnmeetable
        shedlike = isinstance(req.error, (BrownoutShed,
                                          DeadlineUnmeetable))
        self.log_event("shed" if shedlike else "expired", req,
                       reason=type(req.error).__name__
                       if req.error is not None else "timeout")

    def request_prefilled(self, req, prefill_s):
        self._h_queue.observe(req.t_admit - req.t_submit)
        self._h_prefill.observe(prefill_s)
        with self._lock:
            self._prefill_tokens_obs += len(req.prompt)
        req.t_first_token = time.perf_counter()
        if req.t_last_token is not None:
            # a failover resume carried the victim's last emit time:
            # the replay's first fresh token closes the client's real
            # cross-hop gap — exactly the stall an ITL SLO must see
            itl = req.t_first_token - req.t_last_token
            self._h_itl.observe(itl)
            self._tenant(req.tenant)["itl"].observe(itl)
        req.t_last_token = req.t_first_token
        if req.t_client_first_token is None:
            # the CLIENT's first token, measured from the CLIENT's
            # submit — for a resume whose victim died mid-prefill this
            # includes the whole failed first life; a resume whose
            # client already HAS a first token observes nothing (a
            # fresh-clock replay TTFT would make the histogram — and
            # the goodput classifier — optimistic under failover)
            req.t_client_first_token = req.t_first_token
            ttft = req.t_client_first_token - req.t_client_submit
            self._h_ttft.observe(ttft)
            self._tenant(req.tenant)["ttft"].observe(ttft)
            self.log_event("first_token", req,
                           ttft_ms=round(1e3 * ttft, 3),
                           prefill_ms=round(1e3 * prefill_s, 3))

    def request_admitted(self, req):
        """Lifecycle only (the counters move at prefill/finish)."""
        self.log_event("admitted", req,
                       queue_ms=round(1e3 * (req.t_admit - req.t_submit),
                                      3) if req.t_admit else None)

    def request_chunk(self, req, prefilled):
        """One prefill chunk ran for `req` (lifecycle ledger only)."""
        self.log_event("prefill_chunk", req, prefilled=prefilled)

    def token_generated(self, req, now=None, position=None):
        """One decode token emitted for `req`: observe the per-request
        inter-token latency (fleet + tenant) — failover stalls land
        here too, which is exactly what an ITL SLO must see."""
        now = time.perf_counter() if now is None else now
        prev = req.t_last_token
        req.t_last_token = now
        if prev is None:
            return
        itl = now - prev
        self._h_itl.observe(itl)
        self._tenant(req.tenant)["itl"].observe(itl)
        if _slo.request_log().enabled:
            self.log_event("decode", req,
                           itl_ms=round(1e3 * itl, 3),
                           position=position)

    def prefill_chunk(self, queue_depth):
        """One chunked-prefill kernel call ran; `queue_depth` is the
        number of sequences still mid-prefill after it."""
        self._chunks.inc()
        with self._lock:
            self._prefill_depth_last = queue_depth
        self._g_prefill_backlog.set(queue_depth)

    def decode_step(self, active, max_batch, step_s, cache_util=None,
                    paged=False, tokens=None):
        """One decode iteration advanced `active` sequences. `tokens` is
        the number it actually EMITTED — equal to `active` on the plain
        path (the default keeps old callers exact), a burst of up to
        active*(k+1) under speculation."""
        tokens = active if tokens is None else tokens
        self._steps.inc()
        (self._steps_paged if paged else self._steps_gather).inc()
        self._h_batch.observe(active)
        self._h_occupancy.observe(active / float(max_batch))
        self._h_step.observe(step_s)
        self._tokens.inc(tokens)
        self._step_tokens_obs += tokens
        if cache_util is not None:
            with self._lock:
                self._cache_util_last = cache_util
            self._g_util.set(cache_util)
        self._counter.increment(tokens)

    def spec_pass(self, batch=0, proposed=0, accepted=0, emitted=0,
                  fallback=False):
        """One speculative decode round (engine.last_spec feed): either
        a completed draft+score+verify pass over `batch` sequences, or
        a degraded one (`fallback=True` — the batch re-ran on the
        non-speculative path, token-identical)."""
        if fallback:
            self._spec_fallbacks.inc()
            return
        self._spec_passes.inc()
        self._spec_proposed.inc(proposed)
        self._spec_accepted.inc(accepted)
        if batch:
            self._h_spec_accepted.observe(emitted / float(batch))
        if self._spec_proposed.value > 0:
            self._g_spec_rate.set(self._spec_accepted.value
                                  / self._spec_proposed.value)

    def request_finished(self, req):
        from .scheduler import (BrownoutShed, DeadlineExceeded,
                                DeadlineUnmeetable, RequestTimeout)
        tenant = self._tenant(req.tenant)
        if req.error is None:
            self._completed.inc()
            tenant["completed"].inc()
            # delivered tokens: this request's own generation plus
            # whatever a failover replay carried in its prompt (the
            # client received both as one stream)
            gen = (len(req.tokens) - len(req.prompt)) if req.tokens \
                else 0
            gen += req.resumed_tokens
            self._account_tokens(
                req, "goodput" if self._met_slo(req) else "slow", gen)
        else:
            self._failed.inc()
            tenant["failed"].inc()
            if isinstance(req.error, (BrownoutShed, DeadlineUnmeetable)):
                kind = "shed"
            elif isinstance(req.error, (DeadlineExceeded,
                                        RequestTimeout)):
                kind = "expired"
            else:
                kind = "failed"
            # the work the client asked for and never got (a failover
            # resume's prompt already carries its salvage — count its
            # remaining ask plus the carried tokens it now can't
            # deliver either)
            self._account_tokens(req, kind,
                                 req.max_new_tokens + req.resumed_tokens)
        if req.t_done is not None:
            self._h_total.observe(req.t_done - req.t_submit)
        self.log_event(
            "finish", req,
            outcome="completed" if req.error is None
            else type(req.error).__name__,
            generated=(len(req.tokens) - len(req.prompt))
            if req.tokens else 0,
            latency_ms=round(1e3 * (req.t_done - req.t_submit), 3)
            if req.t_done is not None else None,
            failovers=req.failovers or None)

    def observed_token_rate(self, min_steps=8):
        """Decode tokens per COMPUTE second: tokens actually emitted
        (accepted tokens under speculation — a speculative step delivers
        a burst, so counting iterations would understate the service
        rate and falsely shed deadline requests) over summed step wall
        time — the rate the deadline admission check divides the
        committed-token backlog by. None until `min_steps` decode steps
        have been observed: a cold server never sheds on a rate it
        hasn't measured."""
        if self.decode_steps < min_steps or self._h_step.sum <= 0:
            return None
        return self._step_tokens_obs / self._h_step.sum

    def observed_prefill_rate(self):
        """Prompt tokens per prefill-compute second — prefill drains far
        faster than decode, so the deadline gate must not price prompt
        backlog at the decode rate (that would falsely shed servable
        long-prompt requests). None until a prefill has been observed."""
        if self._prefill_tokens_obs <= 0 or self._h_prefill.sum <= 0:
            return None
        return self._prefill_tokens_obs / self._h_prefill.sum

    # -- reading -------------------------------------------------------------

    def _refresh_gauges(self, engine=None, scheduler=None):
        """Pull the point-in-time observables (queue depth, pool state)
        onto their gauges so BOTH read paths see current values."""
        if scheduler is not None:
            self._g_queue.set(scheduler.pending())
            self._g_prefill_backlog.set(len(scheduler.prefilling))
            self._g_token_budget.set(scheduler.token_budget or 0)
            self._g_brownout.set(
                1 if getattr(scheduler, "brownout_active", False) else 0)
        if engine is not None and engine.cache is not None:
            pool = engine.cache.pool
            self._g_in_use.set(pool.in_use)
            self._g_available.set(pool.available)
            self._g_high_water.set(pool.high_water)
            util = engine.cache_utilization()
            if util is not None:
                self._g_util.set(util)
        pc = getattr(engine, "prefix_cache", None)
        if pc is not None:
            # counters stay monotonic: sync the delta since last read
            # from the cache's own lifetime totals
            for ctr, total in ((self._prefix_lookups, pc.lookups),
                               (self._prefix_hits, pc.hits),
                               (self._prefix_misses, pc.misses),
                               (self._prefix_hit_tokens,
                                pc.hit_tokens_total),
                               (self._prefix_evictions, pc.evictions),
                               (self._prefix_cow, pc.cow_copies),
                               (self._prefix_inserts, pc.inserts)):
                delta = total - ctr.value
                if delta > 0:
                    ctr.inc(delta)
            self._g_prefix_resident.set(pc.resident_tokens)
            self._g_prefix_blocks.set(len(pc))
            self._g_prefix_hit_rate.set(pc.hit_rate)
        # quantized-serving observables: declared only when a
        # quant-enabled engine is observed, so the flags-off exposition
        # stays byte-for-byte identical to the unquantized stack
        if engine is not None and (getattr(engine, "kv_quant", False)
                                   or getattr(engine, "weight_quant",
                                              None)):
            if self._quant_gauges is None:
                g = self.registry.gauge
                self._quant_gauges = {
                    "kv": g("serving_kv_quant_enabled",
                            help="1 while the paged pool stores int8 "
                                 "KV blocks (dequantized by the paged "
                                 "kernel as it stages each block)"),
                    "w": g("serving_weight_quant_enabled",
                           help="1 while the matmul weights serve "
                                "int8 per-channel (embeds/norms/head "
                                "stay f32)"),
                    "bpt": g("serving_kv_quant_bytes_per_token",
                             help="KV bytes one token occupies under "
                                  "the engine's layout (int8 payload "
                                  "+ amortized f32 scale sidecars "
                                  "when quantized)"),
                    "err": g("serving_quant_max_logit_error",
                             help="max |quant - f32 oracle| logit "
                                  "error last measured against this "
                                  "engine (parity seam fed by the "
                                  "bench/tests; 0 until measured)"),
                }
            q = self._quant_gauges
            q["kv"].set(1 if engine.kv_quant else 0)
            q["w"].set(1 if engine.weight_quant else 0)
            q["bpt"].set(engine.kv_bytes_per_token())
            err = getattr(engine, "quant_logit_error", None)
            if err is not None:
                q["err"].set(float(err))

    def prometheus_text(self, engine=None, scheduler=None):
        """Prometheus text exposition (format 0.0.4) of the server's
        registry — the `/metrics` body under `Accept: text/plain`."""
        self._refresh_gauges(engine, scheduler)
        self.slo.update()
        return self.registry.prometheus_text()

    def tokens_ledger(self):
        """The fleet goodput/shed/expired/failed token ledger as plain
        ints (reads the registry counters — /statusz can never disagree
        with /metrics)."""
        out = {k: int(c.value) for k, c in self._tok.items()}
        out["replayed"] = self.failover_resumed_tokens
        out["generated"] = self.tokens_generated
        return out

    def statusz(self, engine=None, scheduler=None):
        """The /statusz JSON body: request/token ledgers,
        per-tenant breakdown, and the SLO block (attainment, error
        budget remaining, multi-window burn). Everything is read from
        the same registry the Prometheus exposition serves."""
        self._refresh_gauges(engine, scheduler)
        elapsed = max(1e-9, time.perf_counter() - self._t0)
        tenants = {}
        for name, t in sorted(self._tenants_view().items()):
            tenants[name] = {
                "tokens": {k: int(c.value)
                           for k, c in t["tokens"].items()},
                "requests": {"completed": int(t["completed"].value),
                             "failed": int(t["failed"].value)},
                "ttft_ms_p95": (round(1e3 * t["ttft"].quantile(0.95), 3)
                                if t["ttft"].count else None),
                "itl_ms_p99": (round(1e3 * t["itl"].quantile(0.99), 3)
                               if t["itl"].count else None),
            }
        return {
            "replica": self.replica,
            "uptime_s": round(elapsed, 3),
            "requests": {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "expired": self.expired,
                "deadline_shed": self.deadline_shed,
                "brownout_shed": self.brownout_shed,
                "failovers": self.failovers,
                "migrations": self.migrations,
            },
            "tokens": self.tokens_ledger(),
            "goodput_tok_per_sec": round(
                self._tok["goodput"].value / elapsed, 3),
            "tenants": tenants,
            "slo": self.slo.payload(),
        }

    def snapshot(self, engine=None, scheduler=None):
        """One dict with everything: the HTTP /metrics body and the test
        observable. Rates are lifetime averages; latencies are means in
        milliseconds over finished/started requests. Shape unchanged by
        the registry migration (tests pin it); histogram-backed fields
        now also expose p50/p95/p99."""
        self._refresh_gauges(engine, scheduler)
        elapsed = time.perf_counter() - self._t0
        completed, failed = self.completed, self.failed
        expired, tokens = self.expired, self.tokens_generated
        steps = self.decode_steps
        fin = max(1, completed + failed)
        started = max(1, completed + failed - expired)
        snap = {
            "requests": {
                "submitted": self.submitted,
                "completed": completed,
                "failed": failed,
                "rejected": self.rejected,
                "expired": expired,
                "engine_failures": self.engine_failures,
                "deadline_shed": self.deadline_shed,
                "brownout_shed": self.brownout_shed,
                "failovers": self.failovers,
                "migrations": self.migrations,
            },
            "latency_ms": {
                "queue_mean": 1e3 * self._h_queue.sum / started,
                "prefill_mean": 1e3 * self._h_prefill.sum / started,
                "time_to_first_token_mean":
                    1e3 * self._h_ttft.sum / started,
                "time_to_first_token_p95":
                    (1e3 * self._h_ttft.quantile(0.95)
                     if self._h_ttft.count else None),
                "total_mean": 1e3 * self._h_total.sum / fin,
                "decode_per_token_mean": (
                    1e3 * self._h_step.sum / tokens if tokens else None),
                "decode_step_p50": (1e3 * self._h_step.quantile(0.5)
                                    if self._h_step.count else None),
                "decode_step_p99": (1e3 * self._h_step.quantile(0.99)
                                    if self._h_step.count else None),
            },
            "throughput": {
                "tokens_generated": tokens,
                "tokens_per_sec": (tokens / elapsed
                                   if elapsed > 0 else None),
                "decode_steps": steps,
            },
            "batch": {
                "mean_active": (self._h_batch.sum / steps
                                if steps else None),
                "mean_occupancy": (self._h_occupancy.sum / steps
                                   if steps else None),
            },
            "paths": {
                "paged_decode_steps": self.decode_steps_paged,
                "gather_decode_steps": self.decode_steps_gather,
                "prefill_chunks": self.prefill_chunks,
                "prefill_queue_depth": self._prefill_depth_last,
            },
            "cache": {"block_utilization": self._cache_util_last},
            # the goodput token ledger rides the snapshot too
            # (tools/fleet_top.py reads it from here)
            "tokens": self.tokens_ledger(),
        }
        if engine is not None:
            snap["engine"] = {
                "prefill_compilations": engine.prefill_compilations,
                "decode_compilations": engine.decode_compilations,
                "max_batch": engine.max_batch,
                "max_len": engine.max_len,
                "paged_attention": bool(engine.paged),
                "prefill_chunk": engine.prefill_chunk,
                "prefix_cache": getattr(engine, "prefix_cache",
                                        None) is not None,
            }
            for name in ("prefix_cache_fallback", "kv_quant_fallback"):
                if getattr(engine, name, None):
                    snap["engine"][name] = getattr(engine, name)
            snap["engine"]["spec_decode"] = bool(
                getattr(engine, "spec", False))
            if getattr(engine, "spec_fallback", None):
                snap["engine"]["spec_fallback"] = engine.spec_fallback
            if getattr(engine, "spec", False) or \
                    getattr(engine, "spec_passes", 0):
                passes = engine.spec_passes
                snap["spec"] = {
                    "k": engine.spec_k,
                    "passes": passes,
                    "proposed_tokens": engine.spec_proposed_tokens,
                    "accepted_tokens": engine.spec_accepted_tokens,
                    "fallbacks": engine.spec_fallbacks,
                    "acceptance_rate": (
                        engine.spec_accepted_tokens
                        / engine.spec_proposed_tokens
                        if engine.spec_proposed_tokens else None),
                    "accepted_per_pass": (
                        (self._h_spec_accepted.sum
                         / self._h_spec_accepted.count)
                        if self._h_spec_accepted.count else None),
                }
            pc = getattr(engine, "prefix_cache", None)
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
                # the port's one addition to the reference's tree: a
                # quantized engine's quantization gauges, by the
                # reference's names (phase 6 of chip_smoke.py reads them)
                snap["quant"] = {
                    "serving_kv_quant_enabled": int(engine.kv_quant),
                    "serving_weight_quant_enabled":
                        int(bool(engine.weight_quant)),
                    "serving_kv_quant_bytes_per_token":
                        engine.kv_bytes_per_token(),
                }
            util = engine.cache_utilization()
            if util is not None:
                pool = engine.cache.pool
                snap["cache"]["block_utilization"] = util
                snap["cache"]["blocks_in_use"] = pool.in_use
                snap["cache"]["blocks_available"] = pool.available
                snap["cache"]["blocks_high_water"] = pool.high_water
                snap["cache"]["blocks_total"] = engine.cache.num_blocks - 1
        if scheduler is not None:
            snap["scheduler"] = {
                "token_budget": scheduler.token_budget,
                "tenant_budget": getattr(scheduler, "tenant_budget",
                                         None),
                "queued": scheduler.pending(),
                "prefilling": len(scheduler.prefilling),
            }
        return snap
