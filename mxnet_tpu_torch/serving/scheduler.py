"""Continuous-batching scheduler: admit, run, evict, recycle (port of
`mxnet_tpu/serving/scheduler.py`, single tenant).

Before every decode step the scheduler admits queued requests into free
batch slots in FIFO order (a late request gets the next slot that frees
up), the engine advances the whole active batch one token, and finished
sequences are evicted with their cache blocks recycled.

Backpressure is two-level: `submit` rejects immediately once the queue
holds `max_queue` requests, and a queued request older than
`queue_timeout` seconds is failed at admission time rather than served
stale. Admission is head-of-line: if the oldest request's block
reservation doesn't fit the pool, nothing behind it jumps ahead.

Token budget: on the paged path one loop iteration scores
`engine.decode_tokens_per_step()` tokens per running sequence (1, or k+1
on a speculating engine) plus one fixed-shape prefill chunk per sequence
still prefilling. `token_budget` caps that sum at admission time,
bounding per-iteration latency.
Admission always makes progress: the budget never blocks the only
candidate when nothing is running or prefilling.

Tenants, priorities, deadlines and brownout are not ported yet.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from ..base import MXNetError
from ..telemetry import new_trace_id


class QueueFull(MXNetError):
    """submit() backpressure: the request queue is at max_queue."""


class RequestTimeout(MXNetError):
    """The request waited in the queue longer than queue_timeout."""


_ids = itertools.count(1)

QUEUED, RUNNING, DONE, FAILED = "queued", "running", "done", "failed"


class Request:
    """One generation request plus its completion handle. `wait`/`result`
    make it a minimal future the in-process API and HTTP frontend share."""

    def __init__(self, prompt, max_new_tokens=32, eos_id=None, trace=None):
        if not len(prompt):
            raise MXNetError("empty prompt")
        self.id = next(_ids)
        self.trace = str(trace) if trace else new_trace_id()
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        self.state = QUEUED
        self.error = None
        self.tokens = None            # prompt + generated, set on DONE
        self.t_submit = time.perf_counter()
        self.t_admit = None
        self.t_first_token = None
        self.t_done = None
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
        # first finish wins, atomically
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
            self._event.set()


class Scheduler:
    """Owns the waiting queue and the running set. Thread-safe for
    `submit` vs. the single serving thread driving `admit`/`evict`."""

    def __init__(self, max_batch=8, max_queue=64, queue_timeout=None,
                 token_budget=None):
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.queue_timeout = queue_timeout
        self.token_budget = token_budget
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
            self._queue.append(req)
        return req

    def pending(self):
        with self._lock:
            return len(self._queue)

    def has_work(self):
        return bool(self.running) or bool(self.prefilling) or \
            bool(self.pending())

    def spent_tokens(self, engine):
        """Tokens the NEXT loop iteration is already committed to: the
        scored decode tokens of every running sequence (k+1 each when
        speculating) plus one prefill chunk per sequence still
        prefilling."""
        return engine.decode_tokens_per_step() * len(self.running) + sum(
            engine.prefill_tokens_per_step(s.prompt_len)
            for s in self.prefilling)

    def admit(self, engine, now=None):
        """Move queued requests into the running set, FIFO, while batch
        slots, cache blocks and the token budget allow; expire the ones
        that waited too long. A request that doesn't fit the block pool
        stops admission (head-of-line). Returns (admitted, expired) — the
        caller prefills the admitted ones."""
        admitted, expired = [], []
        now = time.perf_counter() if now is None else now
        spent = self.spent_tokens(engine)
        with self._lock:
            drop = set()
            for req in self._queue:
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
                    break     # head-of-line
                cost = engine.prefill_tokens_per_step(len(req.prompt))
                if self.token_budget is not None \
                        and spent + cost > self.token_budget \
                        and (spent > 0 or admitted):
                    break     # budget full this iteration; the head
                              # keeps its place
                spent += cost
                drop.add(req.id)
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
