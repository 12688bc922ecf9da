"""Continuous-batching scheduler: admit, run, evict, recycle (port of
`mxnet_tpu/serving/scheduler.py`).

The unit of scheduling is one engine *step*. Before every decode step the
scheduler admits queued requests into free batch slots (FIFO — a late
request is guaranteed the next slot that frees up, the fairness property
tests pin), the engine advances the whole active batch one token, and
finished sequences are evicted with their cache blocks recycled.

Backpressure is two-level: `submit` rejects immediately once the queue
holds `max_queue` requests (callers see the failure instead of unbounded
buffering), and a queued request older than `queue_timeout` seconds is
failed at admission time rather than served stale. Admission itself is
head-of-line: if the oldest request's block reservation doesn't fit the
pool, nothing behind it jumps ahead (no starvation of big requests).

Token budget: with chunked prefill (engine.paged) one loop iteration
processes `len(running)` decode tokens plus one fixed-shape prefill
chunk per sequence still prefilling. `token_budget`
(MXNET_SERVING_TOKEN_BUDGET) caps that sum at admission time: a new
request is only admitted while the decode batch plus every pending
chunk fits the budget, bounding per-iteration latency — the knob that
trades time-to-first-token for decode tail latency. Admission always
makes progress (the budget never blocks the only candidate when nothing
is running or prefilling).

Multi-tenant admission: every request carries a `tenant`
(isolation domain, default "default") and an integer `priority`
(higher admits first). Admission considers candidates in (priority
desc, arrival) order — head-of-line blocking still applies within that
order (a big request is never starved by later small ones), but a
tenant over its per-iteration `tenant_budget`
(MXNET_SERVING_TENANT_BUDGET, or the per-tenant `tenant_budgets` map)
is SKIPPED rather than blocking the queue: one tenant's burst spreads
itself across iterations while other tenants keep admitting — it
cannot starve their working set or monopolize the block pool. A tenant
with nothing in flight always makes progress (its head request admits
even when the request alone exceeds the budget), mirroring the global
budget's progress rule.

Deadlines & brownout: a request may carry `deadline_ms` —
its total latency budget from submit. Admission drops a request whose
deadline already passed BEFORE spending prefill tokens on it
(`DeadlineExceeded` → HTTP 504); the server-side admission gate sheds
requests the observed service rate can't meet at all
(`DeadlineUnmeetable` → 503 + computed Retry-After). Under sustained
saturation, brownout mode (`MXNET_SERVING_BROWNOUT`) sheds the lowest
priority class first and clamps `max_new_tokens` of newly admitted
work — admitted work's length and logits are never touched.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque

from ..base import MXNetError


def _decode_cost(engine):
    """Scored tokens one decode iteration costs per running sequence:
    `engine.decode_tokens_per_step()` (k+1 on a speculating engine, 1
    otherwise). getattr-defensive — scheduler tests drive minimal
    engine stubs that predate the speculative path."""
    fn = getattr(engine, "decode_tokens_per_step", None)
    return fn() if fn is not None else 1


class QueueFull(MXNetError):
    """submit() backpressure: the request queue is at max_queue."""


class RequestTimeout(MXNetError):
    """The request waited in the queue longer than queue_timeout."""


class DeadlineExceeded(MXNetError):
    """The request's deadline passed while it waited for admission — it
    is dropped BEFORE any prefill tokens are spent on it (serving a
    response the client already gave up on is pure waste). The HTTP
    frontend maps this to 504."""


class DeadlineUnmeetable(MXNetError):
    """Admission-time shed: at the observed service rate the queue ahead
    of this request already exceeds its deadline, so accepting it would
    only burn tokens on a guaranteed 504. The HTTP frontend maps this to
    503 with the COMPUTED Retry-After carried on `retry_after_s`."""

    def __init__(self, msg, retry_after_s=1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class BrownoutShed(MXNetError):
    """The request was shed by brownout mode (sustained saturation —
    MXNET_SERVING_BROWNOUT): lowest priority class first, so paying
    tenants degrade last. Maps to 503 + Retry-After."""


_ids = itertools.count(1)

QUEUED, RUNNING, DONE, FAILED = "queued", "running", "done", "failed"


class Request:
    """One generation request plus its completion handle. `wait`/`result`
    make it a minimal future the in-process API and HTTP frontend share."""

    def __init__(self, prompt, max_new_tokens=32, eos_id=None,
                 tenant=None, priority=None, deadline_ms=None,
                 trace=None):
        if not len(prompt):
            raise MXNetError("empty prompt")
        self.id = next(_ids)
        # the request's TRACE id: a W3C-compatible 32-hex id
        # accepted from the client's `traceparent` header or minted
        # fresh. Every span of this request's life — submit, queue,
        # prefill chunks, decode steps — is keyed by it, and
        # `make_resume` carries it across failover hops, so one request
        # is ONE connected trace no matter how many replicas served it.
        from ..telemetry import new_trace_id
        self.trace = str(trace) if trace else new_trace_id()
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.tenant = str(tenant) if tenant is not None else "default"
        self.priority = int(priority) if priority is not None else 0
        self.deadline_ms = (float(deadline_ms)
                            if deadline_ms is not None else None)
        self.state = QUEUED
        self.error = None
        self.tokens = None            # prompt + generated, set on DONE
        self.t_submit = time.perf_counter()
        # absolute deadline on the same clock the scheduler reads
        self.t_deadline = (self.t_submit + self.deadline_ms / 1e3
                           if self.deadline_ms is not None else None)
        self.t_enqueue = None         # stamped under the queue's lock
        self.t_admit = None
        self.t_first_token = None
        self.t_done = None
        # CLIENT-truth latency anchors: a failover resume is
        # a fresh Request with a fresh t_submit, but the client has
        # been waiting since the ORIGINAL submit and may already have
        # its first token — the SLO classifier and the TTFT histogram
        # must judge by these, or failover makes the numbers optimistic
        # exactly when they matter (make_resume carries them forward)
        self.t_client_submit = self.t_submit
        self.t_client_first_token = None
        self.failovers = 0            # resume hops already spent on it
        self.migrated = False         # this Request is a PLANNED
                                      # prefill->decode migration hop
                                      # (disaggregated serving), not a
                                      # fault recovery: it is admitted
                                      # work mid-generation (brownout-
                                      # exempt) but spends no failover
                                      # budget
        self.resumed_tokens = 0       # generated tokens a failover
                                      # replay carried in its prompt
                                      # (the goodput ledger credits the
                                      # CLIENT-visible delivery)
        self.t_last_token = None      # previous token's emit time (ITL)
        self._on_finish = None        # failover stitch callback
        self._event = threading.Event()
        self._finish_lock = threading.Lock()

    def wait(self, timeout=None):
        return self._event.wait(timeout)

    def result(self, timeout=None):
        """Block until finished; returns the generated tokens (prompt
        excluded). Raises the request's error on failure."""
        if not self._event.wait(timeout):
            raise RequestTimeout("request %d still pending after %ss"
                                 % (self.id, timeout))
        if self.error is not None:
            raise self.error
        return self.tokens[len(self.prompt):]

    def _finish(self, tokens=None, error=None):
        # first finish wins, ATOMICALLY: a request that was failed over
        # must never be completed a second time by its original replica
        # resuming (the exactly-once contract the drain/restore race
        # test pins), and two racing finishers must not interleave
        # state/tokens/error writes
        with self._finish_lock:
            if self._event.is_set():
                return
            self.t_done = time.perf_counter()
            if error is not None:
                self.state = FAILED
                self.error = error
            else:
                self.state = DONE
                self.tokens = tokens
            cb, self._on_finish = self._on_finish, None
            self._event.set()
        if cb is not None:           # outside the lock: the stitch
            cb(self)                 # finishes ANOTHER request


def make_resume(orig, tokens, max_len, migrate=False):
    """Build the failover replay for `orig`: a fresh Request whose
    prompt is the original prompt PLUS every token already generated —
    replayed as a prefill on the target replica (hitting the prefix
    cache when the prefix is resident), after which decode continues.
    Greedy decoding is a pure function of the token history, so the
    continuation is token-identical to an undisturbed run (the
    parity-oracle discipline). Returns (resume, carried) where
    `carried` counts the generated-so-far tokens the replay salvages,
    or (None, carried) when nothing remains to generate (the caller
    finishes `orig` directly with `tokens`).

    `migrate=True` builds the PLANNED hop of disaggregated serving
    (prefill replica -> decode replica) instead of a fault recovery:
    identical replay transport and carried anchors, but the resume
    spends no failover budget (`failovers` stays at the original's —
    every-request migration must not eat the bounded fault-hop
    allowance) and is marked `migrated` so admission treats it as what
    it is: already-admitted work mid-generation (brownout-exempt,
    never shed or clamped).

    The caller owns the stitch: set ``resume._on_finish`` to complete
    `orig` from the resume's result — `orig.result()` slices by the
    ORIGINAL prompt length, so handing it the resume's full token list
    yields pre-fault and post-fault generation as one seamless
    response."""
    carried = max(0, len(tokens) - len(orig.prompt))
    total = min(max_len, len(orig.prompt) + orig.max_new_tokens)
    remaining = total - len(tokens)
    hit_eos = (orig.eos_id is not None and carried
               and tokens[-1] == orig.eos_id)
    if remaining <= 0 or hit_eos:
        return None, carried
    resume = Request(tokens, max_new_tokens=remaining,
                     eos_id=orig.eos_id, tenant=orig.tenant,
                     priority=orig.priority,
                     deadline_ms=orig.deadline_ms,
                     trace=orig.trace)
    resume.failovers = orig.failovers if migrate \
        else orig.failovers + 1
    resume.migrated = bool(migrate or orig.migrated)
    resume.resumed_tokens = carried
    # the victim's last token-emit time rides along so the client's
    # real inter-token gap across the hop lands in the ITL histogram
    # (the replay's first fresh token closes that gap); the client
    # anchors ride too so TTFT is judged from the ORIGINAL submit and
    # never re-observed for a client that already has its first token
    resume.t_last_token = orig.t_last_token
    resume.t_client_submit = orig.t_client_submit
    resume.t_client_first_token = orig.t_client_first_token \
        if orig.t_client_first_token is not None else orig.t_first_token
    # the deadline is ABSOLUTE from the client's submit — a failover hop
    # must not extend it (t_submit stays fresh: queue_timeout measures
    # queue wait, and the resume really does enter a queue anew)
    resume.t_deadline = orig.t_deadline
    return resume, carried


class Scheduler:
    """Owns the waiting queue and the running set. Thread-safe for
    `submit` vs. the single serving thread driving `admit`/`evict`."""

    def __init__(self, max_batch=8, max_queue=64, queue_timeout=None,
                 token_budget=None, tenant_budget=None,
                 tenant_budgets=None, brownout=None,
                 brownout_after_s=1.0, brownout_max_new=16):
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.queue_timeout = queue_timeout
        if token_budget is None:
            env = os.environ.get("MXNET_SERVING_TOKEN_BUDGET")
            token_budget = int(env) if env else None
        self.token_budget = token_budget
        if tenant_budget is None:
            env = os.environ.get("MXNET_SERVING_TENANT_BUDGET")
            tenant_budget = int(env) if env else None
        self.tenant_budget = tenant_budget        # default per-tenant cap
        self.tenant_budgets = dict(tenant_budgets or {})  # per-name override
        # brownout: graceful degradation under SUSTAINED saturation
        # (MXNET_SERVING_BROWNOUT / Scheduler(brownout=True)). While
        # active, admission sheds the lowest priority class first and
        # clamps max_new_tokens of NEWLY admitted work — it never
        # touches the logits (or length) of work already admitted.
        if brownout is None:
            brownout = os.environ.get("MXNET_SERVING_BROWNOUT", "0") == "1"
        self.brownout = bool(brownout)
        self.brownout_after_s = float(brownout_after_s)
        self.brownout_max_new = int(brownout_max_new)
        self._sat_since = None        # when the queue first ran hot
        self.brownout_active = False
        self.brownout_sheds = 0       # monotonic (metrics sync)
        self.deadline_drops = 0       # admission-time deadline expiries
        self._queue = deque()
        self._lock = threading.Lock()
        self.running = []             # serving-thread-only
        self.prefilling = []          # serving-thread-only: chunked
                                      # prefill in flight (paged path)

    def submit(self, req):
        with self._lock:
            if len(self._queue) >= self.max_queue:
                raise QueueFull(
                    "serving queue is full (%d requests); retry later"
                    % self.max_queue)
            req.t_enqueue = time.perf_counter()
            self._queue.append(req)
        return req

    def pending(self):
        with self._lock:
            return len(self._queue)

    def has_work(self):
        return bool(self.running) or bool(self.prefilling) or \
            self.pending()

    def spent_tokens(self, engine):
        """Tokens the NEXT loop iteration is already committed to:
        `decode_tokens_per_step` per running sequence (1 plain, k+1 for
        a speculating engine — the target SCORES k+1 positions per
        sequence per iteration, so that is the honest price next to a
        prefill chunk) plus one prefill chunk per sequence still
        prefilling."""
        return _decode_cost(engine) * len(self.running) + sum(
            engine.prefill_tokens_per_step(s.prompt_len)
            for s in self.prefilling)

    def tenant_budget_for(self, tenant):
        """Per-iteration token cap for one tenant: the per-name override
        wins, else the shared default, else unbounded."""
        return self.tenant_budgets.get(tenant, self.tenant_budget)

    @staticmethod
    def _tenant_of(seq):
        req = getattr(seq, "request", None)
        return getattr(req, "tenant", None) or "default"

    def spent_by_tenant(self, engine):
        """Per-tenant committed tokens of the NEXT loop iteration (the
        tenant-budget analogue of `spent_tokens`, with the same
        speculative k+1 decode price)."""
        dc = _decode_cost(engine)
        spent = {}
        for s in self.running:
            t = self._tenant_of(s)
            spent[t] = spent.get(t, 0) + dc
        for s in self.prefilling:
            t = self._tenant_of(s)
            spent[t] = spent.get(t, 0) \
                + engine.prefill_tokens_per_step(s.prompt_len)
        return spent

    def _update_brownout(self, now):
        """Saturation hysteresis (caller holds the lock): the queue
        running at >= 3/4 of max_queue for `brownout_after_s` turns
        brownout ON; draining back below 1/4 turns it OFF. The two
        thresholds keep one oscillating burst from toggling the mode
        every iteration."""
        if not self.brownout:
            return
        qlen = len(self._queue)
        hi = max(1, (3 * self.max_queue) // 4)
        lo = max(0, self.max_queue // 4)
        if qlen >= hi:
            if self._sat_since is None:
                self._sat_since = now
            elif now - self._sat_since >= self.brownout_after_s:
                self.brownout_active = True
        elif qlen <= lo:
            self._sat_since = None
            self.brownout_active = False

    def admit(self, engine, now=None):
        """Move queued requests into the running set while batch slots,
        cache blocks, and the token budgets allow; expire the ones that
        waited too long. Candidates are considered in (priority desc,
        arrival) order — FIFO when nobody sets priorities, so the FIFO
        fairness property is unchanged for single-tenant traffic. A
        candidate that doesn't fit the block pool stops admission
        (head-of-line: nothing lower-ranked jumps a big request); a
        candidate whose TENANT is over its per-iteration token budget is
        skipped instead — other tenants keep admitting, so one tenant's
        burst can't starve the rest. Returns (admitted, expired) — the
        caller prefills the admitted ones."""
        admitted, expired = [], []
        spent = self.spent_tokens(engine)
        by_tenant = self.spent_by_tenant(engine)
        with self._lock:
            # read under the lock, like `t_enqueue`: a request stamped
            # before `now` is in the queue this round sees
            now = time.perf_counter() if now is None else now
            self._update_brownout(now)
            order = sorted(self._queue,
                           key=lambda r: (-r.priority, r.t_submit, r.id))
            drop = set()
            if self.brownout_active:
                # shed the lowest priority class first (and only when
                # classes are distinguishable — with one class the
                # max_new clamp below is the degradation lever; shedding
                # everyone would be an outage, not a brownout)
                # failover resumes (failovers > 0) and migration hops
                # (migrated) are exempt: they ARE admitted work
                # mid-generation, re-queued only because their replica
                # died or handed them to a decode replica — shedding or
                # clamping one would fail/truncate a response the
                # client was already receiving and break replay token
                # parity
                prios = {r.priority for r in order
                         if r.failovers == 0 and not r.migrated}
                if len(prios) > 1:
                    floor = min(prios)
                    for req in order:
                        if req.priority == floor and req.failovers == 0 \
                                and not req.migrated:
                            drop.add(req.id)
                            expired.append(req)
                            req.error = BrownoutShed(
                                "request %d shed by brownout (sustained "
                                "saturation, priority %d is the lowest "
                                "queued class); retry later"
                                % (req.id, req.priority))
                            self.brownout_sheds += 1
                    order = [r for r in order if r.id not in drop]
            # expired deadlines drop over the WHOLE queue, before the
            # batch-capacity break below can shadow them: a corpse must
            # not hold a queue slot (inflating backpressure and the
            # brownout hysteresis) for as long as the batch stays full,
            # and its 504 must reach the client promptly
            for req in order:
                if req.t_deadline is not None and now > req.t_deadline:
                    drop.add(req.id)
                    expired.append(req)
                    req.error = DeadlineExceeded(
                        "request %d missed its %.0f ms deadline after "
                        "%.1f ms in queue"
                        % (req.id, req.deadline_ms or 0.0,
                           1e3 * (now - req.t_submit)))
                    self.deadline_drops += 1
            if drop:
                order = [r for r in order if r.id not in drop]
            for req in order:
                if len(self.running) + len(self.prefilling) \
                        + len(admitted) >= self.max_batch:
                    break
                if self.queue_timeout is not None and \
                        now - req.t_submit > self.queue_timeout:
                    drop.add(req.id)
                    expired.append(req)
                    continue
                try:
                    fits = engine.can_admit(len(req.prompt),
                                            req.max_new_tokens)
                except MXNetError as e:
                    # can NEVER be served (e.g. prompt > max_len): fail
                    # this request, don't let it wedge the whole queue
                    drop.add(req.id)
                    expired.append(req)
                    req.error = e
                    continue
                if not fits:
                    break     # head-of-line within the priority order
                cost = engine.prefill_tokens_per_step(len(req.prompt))
                if self.token_budget is not None \
                        and spent + cost > self.token_budget \
                        and (spent > 0 or admitted):
                    break             # budget full this iteration; the
                                      # head keeps its place
                t_spent = by_tenant.get(req.tenant, 0)
                budget = self.tenant_budget_for(req.tenant)
                if budget is not None and t_spent + cost > budget \
                        and t_spent > 0:
                    continue  # THIS tenant over budget: skip, don't
                              # block other tenants behind it (progress:
                              # an idle tenant's head always admits)
                spent += cost
                by_tenant[req.tenant] = t_spent + cost
                drop.add(req.id)
                if self.brownout_active and req.failovers == 0 \
                        and not req.migrated:
                    # degrade, don't deny: newly admitted work generates
                    # fewer tokens under brownout. Admitted work is
                    # never re-clamped and logits are never touched —
                    # which is exactly why failover resumes and
                    # migration hops are exempt (they are admitted work
                    # continuing elsewhere).
                    req.max_new_tokens = min(req.max_new_tokens,
                                             self.brownout_max_new)
                req.t_admit = now
                admitted.append(req)
            if drop:
                self._queue = deque(r for r in self._queue
                                    if r.id not in drop)
        for req in expired:
            req._finish(error=req.error or RequestTimeout(
                "request %d expired after %.1fs in queue"
                % (req.id, now - req.t_submit)))
        return admitted, expired

    def evict(self, engine):
        """Remove finished sequences from the running set, recycle their
        blocks, and complete their requests. Returns the finished list."""
        finished = [s for s in self.running if s.done]
        if finished:
            self.running = [s for s in self.running if not s.done]
            for seq in finished:
                engine.release(seq)
                if seq.request is not None:
                    seq.request._finish(tokens=list(seq.tokens))
        return finished
