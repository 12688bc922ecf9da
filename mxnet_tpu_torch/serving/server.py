"""The serving front doors: in-process `serve()` and a stdlib HTTP shim
(port of `mxnet_tpu/serving/server.py`, one replica).

`serve(model, ...)` accepts a `(params, TransformerConfig)` pair or a
`TransformerLM` and returns a started `LMServer`: a background thread
runs the continuous-batching loop (admit → prefill → decode step →
evict), callers submit token prompts and block on per-request futures.
The HTTP frontend (`LMServer.serve_http`) is a ThreadingHTTPServer over
the same object — one handler thread per connection, all funneling into
the single serving thread, which alone touches the engine.

Replicas, routing, failover, migration, rollout and chaos seams are not
ported yet: an engine fault fails the requests it hit and the loop keeps
serving.
"""
from __future__ import annotations

import json
import threading
import time

import torch

from ..base import MXNetError
from .. import telemetry
from .engine import Engine, TransformerLM
from .metrics import ServingMetrics
from .scheduler import Request, Scheduler, QueueFull, RUNNING


def _resolve_model(model):
    if isinstance(model, TransformerLM):
        return model
    if isinstance(model, tuple) and len(model) == 2:
        params, cfg = model
        return TransformerLM(params, cfg)
    raise MXNetError("don't know how to serve %r — pass (params, cfg) or "
                     "a TransformerLM" % type(model))


class _HTTPFrontend:
    """The stdlib HTTP front door. A front provides submit / snapshot /
    health / close; a full queue maps to 429 after `submit_retries`
    attempts with exponential backoff from `submit_backoff` seconds."""

    saturated_status = 429
    submit_retries = 3
    submit_backoff = 0.05
    _httpd = None

    def serve_http(self, host="127.0.0.1", port=8080, block=True):
        """Start the HTTP frontend. Endpoints:
        POST /v1/generate  {"tokens": [...], "max_new_tokens": N,
                            "eos_id": id?}  -> {"tokens": [...], ...}
        GET  /metrics      -> the metrics snapshot (JSON)
        GET  /healthz      -> loop liveness
        Returns the bound (host, port); with block=False the HTTP server
        runs on a daemon thread (tests bind port 0)."""
        from http.server import ThreadingHTTPServer
        self._httpd = ThreadingHTTPServer((host, port),
                                          _make_handler(self))
        addr = self._httpd.server_address
        if block:
            try:
                self._httpd.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                self.close()
        else:
            threading.Thread(target=self._httpd.serve_forever,
                             daemon=True).start()
        return addr

    def _submit_with_retry(self, body):
        """Submit with bounded backoff on QueueFull: a briefly full queue
        drains in a few decode steps. Only the final failure counts as a
        rejection."""
        for attempt in range(self.submit_retries):
            try:
                return self.submit(
                    body["tokens"],
                    max_new_tokens=int(body.get("max_new_tokens", 32)),
                    eos_id=body.get("eos_id"), count_reject=False)
            except QueueFull:
                if attempt == self.submit_retries - 1:
                    raise
                time.sleep(self.submit_backoff * 2 ** attempt)


def _make_handler(outer):
    """BaseHTTPRequestHandler class bound to one `_HTTPFrontend`."""
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # keep stdout clean
            pass

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                h = outer.health()
                self._reply(200 if h["ok"] else 503, h)
            elif self.path in ("/v1/metrics", "/metrics"):
                self._reply(200, outer.snapshot())
            else:
                self._reply(404, {"error": "unknown path %s" % self.path})

        def do_POST(self):
            if self.path not in ("/v1/generate", "/generate"):
                self._reply(404, {"error": "unknown path %s" % self.path})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                req = outer._submit_with_retry(body)
            except QueueFull as e:
                outer.metrics.request_rejected()
                self._reply(outer.saturated_status, {"error": str(e)})
                return
            except (KeyError, ValueError, TypeError, MXNetError) as e:
                # submit-side failures are the client's fault (malformed
                # body, empty or oversized prompt)
                self._reply(400, {"error": "bad request: %s" % e})
                return
            try:
                generated = req.result(
                    timeout=float(body.get("timeout", 300)))
            except MXNetError as e:
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {
                "tokens": generated,
                "prompt_len": len(req.prompt),
                "latency_ms": 1e3 * (req.t_done - req.t_submit),
                "trace": req.trace,
            })

    return Handler


class LMServer(_HTTPFrontend):
    """Continuous-batching server over one Engine. Start with
    `serve(...)`; stop with `close()` (or use as a context manager).
    `device=None` serves on the card; `device="cpu"` is the only way onto
    the CPU."""

    def __init__(self, model, max_batch=8, max_len=None, block_size=16,
                 num_blocks=None, max_queue=64, queue_timeout=None,
                 keep_logits=False, idle_wait=0.005, paged=None,
                 prefill_chunk=None, token_budget=None, device=None,
                 prefix_cache=None, draft=None, spec=None, spec_k=None,
                 kv_quant=None, weight_quant=None):
        self.engine = Engine(_resolve_model(model), max_batch=max_batch,
                             max_len=max_len, block_size=block_size,
                             num_blocks=num_blocks, keep_logits=keep_logits,
                             paged=paged, prefill_chunk=prefill_chunk,
                             device=device, prefix_cache=prefix_cache,
                             draft=draft, spec=spec, spec_k=spec_k,
                             kv_quant=kv_quant, weight_quant=weight_quant)
        self.scheduler = Scheduler(max_batch=max_batch, max_queue=max_queue,
                                   queue_timeout=queue_timeout,
                                   token_budget=token_budget)
        self.metrics = ServingMetrics()
        self._idle_wait = idle_wait
        self._work = threading.Event()
        self._closed = False
        self._died = False
        # liveness for /healthz: the loop beats every iteration
        self._last_beat = time.perf_counter()
        self._thread = threading.Thread(target=self._loop,
                                        name="mxtt-serving", daemon=True)
        self._thread.start()

    # -- client API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, eos_id=None,
               count_reject=True):
        """Enqueue one request; returns it (a future: .result(timeout)).
        Raises QueueFull immediately when backpressure kicks in;
        `count_reject=False` leaves the rejection uncounted, for retry
        wrappers that count only the final failure."""
        if self._closed:
            raise MXNetError("server is closed")
        if len(prompt) > self.engine.max_len:
            raise MXNetError(
                "prompt length %d exceeds the server's max_len %d"
                % (len(prompt), self.engine.max_len))
        req = Request(prompt, max_new_tokens=max_new_tokens, eos_id=eos_id)
        try:
            self.scheduler.submit(req)
        except QueueFull:
            if count_reject:
                self.metrics.request_rejected()
            raise
        self.metrics.request_submitted()
        telemetry.record_span("serving.submit", int(req.t_submit * 1e6),
                              0, trace=req.trace, category="serving",
                              request=req.id, prompt_len=len(req.prompt),
                              max_new_tokens=req.max_new_tokens)
        self._work.set()
        return req

    def generate(self, prompt, max_new_tokens=32, eos_id=None,
                 timeout=None):
        """Synchronous helper: submit and wait; returns generated tokens
        (prompt excluded)."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id).result(timeout)

    def snapshot(self):
        return self.metrics.snapshot(self.engine, self.scheduler)

    def health(self, max_beat_age=5.0):
        """Loop liveness for /healthz: `ok` needs the serving thread
        alive and beating recently."""
        beat_age = time.perf_counter() - self._last_beat
        alive = self._thread.is_alive() and not self._closed
        return {"ok": bool(alive and beat_age < max_beat_age),
                "loop_alive": bool(alive),
                "last_beat_age_s": round(beat_age, 3),
                "engine_failures": self.metrics.engine_failures}

    def close(self, drain=True, timeout=30.0):
        """Stop the loop; with drain=True finish in-flight work first. A
        clean close runs the engine's block-pool leak audit; anything
        still queued or in flight afterwards fails promptly."""
        if drain:
            deadline = time.perf_counter() + timeout
            while self.scheduler.has_work() and \
                    time.perf_counter() < deadline:
                time.sleep(0.01)
        clean = drain and not self._died and not self.scheduler.has_work()
        self._closed = True
        self._work.set()
        self._thread.join(timeout=timeout)
        self._fail_all(MXNetError("server closed with the request still "
                                  "in flight"))
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.engine.close(audit=clean and not self._thread.is_alive())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- the serving loop ----------------------------------------------------

    def _loop(self):
        if self.engine.device.type == "cuda":
            # this thread's current device is not inherited from the
            # thread that built the engine
            torch.cuda.set_device(self.engine.device)
        try:
            self._loop_inner()
        except BaseException as e:
            # a dead loop must not strand clients in result()
            self._died = True
            self._closed = True
            self._fail_all(MXNetError("serving loop died: %s: %s"
                                      % (type(e).__name__, e)))
            raise

    def _fail_all(self, err):
        """Release every in-flight sequence's blocks and fail every
        request still queued or in flight with `err`."""
        sched = self.scheduler
        with sched._lock:
            reqs = list(sched._queue)
            sched._queue.clear()
        for seq in sched.running + sched.prefilling:
            try:
                self.engine.release(seq)
            except MXNetError:
                pass      # a broken pool must not strand the clients
            if seq.request is not None:
                reqs.append(seq.request)
        sched.running = []
        sched.prefilling = []
        for req in reqs:
            if not req.wait(0):
                req._finish(error=err)
                self.metrics.request_finished(req)

    def _loop_inner(self):
        eng, sched, met = self.engine, self.scheduler, self.metrics
        while not self._closed:
            self._last_beat = time.perf_counter()
            admitted, expired = sched.admit(eng)
            for req in expired:
                met.request_expired()
                met.request_finished(req)
            if eng.paged:
                # chunked prefill: allocate now, stream the prompt
                # through fixed-shape chunks co-scheduled with decode
                self._admit_paged(admitted)
                self._prefill_chunks()
            else:
                self._admit_dense(admitted)
            if sched.running:
                t0 = time.perf_counter()
                # a speculative step emits a burst per sequence: count
                # the tokens as post-length minus pre-length
                pre = {id(s): len(s.tokens) for s in sched.running}
                try:
                    advanced = eng.decode_step(sched.running)
                except Exception as e:  # engine fault: fail the batch,
                    met.engine_failure()  # keep the loop serving
                    self._fail(sched.running, "engine decode failed", e)
                    sched.running = []
                    continue
                if advanced:
                    met.decode_step(len(advanced), time.perf_counter() - t0,
                                    paged=eng.paged,
                                    tokens=sum(len(s.tokens) - pre[id(s)]
                                               for s in advanced))
                    if eng.last_spec is not None:
                        met.spec_pass(**eng.last_spec)
                        eng.last_spec = None
                for seq in sched.evict(eng):
                    if seq.request is not None:
                        met.request_finished(seq.request)
            elif sched.prefilling:
                pass      # chunk work ran this iteration; loop straight
                          # into the next chunk round
            elif not sched.pending():
                self._work.clear()
                self._work.wait(self._idle_wait * 20)
            else:
                time.sleep(self._idle_wait)

    def _fail(self, seqs, what, exc):
        """Release `seqs`' blocks and fail their requests with `exc`."""
        err = MXNetError("%s: %s: %s" % (what, type(exc).__name__, exc))
        for seq in seqs:
            self.engine.release(seq)
            if seq.request is not None:
                seq.request._finish(error=err)
                self.metrics.request_finished(seq.request)

    def _requeue(self, reqs):
        """Transient block shortage: put `reqs` back at the queue head,
        in order."""
        with self.scheduler._lock:
            for r in reversed(reqs):
                self.scheduler._queue.appendleft(r)

    def _admit_dense(self, admitted):
        """Gather path: each admitted request runs its WHOLE prefill
        before the decode step."""
        eng, sched, met = self.engine, self.scheduler, self.metrics
        for i, req in enumerate(admitted):
            prev = telemetry.set_trace(req.trace)
            try:
                seq = eng.start(req.prompt, req.max_new_tokens,
                                eos_id=req.eos_id)
            except Exception as e:  # engine fault: fail THIS request
                met.engine_failure()
                req._finish(error=MXNetError(
                    "engine prefill failed: %s: %s"
                    % (type(e).__name__, e)))
                met.request_finished(req)
                continue
            finally:
                telemetry.set_trace(prev)
            if seq is None:
                self._requeue(admitted[i:])
                break
            seq.request = req
            req.state = RUNNING
            met.request_prefilled(req)
            sched.running.append(seq)

    def _admit_paged(self, admitted):
        """Paged admission: allocate cache blocks only; the prompt
        streams through `_prefill_chunks` across loop iterations."""
        eng, sched, met = self.engine, self.scheduler, self.metrics
        for i, req in enumerate(admitted):
            try:
                seq = eng.begin(req.prompt, req.max_new_tokens,
                                eos_id=req.eos_id)
            except Exception as e:
                met.engine_failure()
                req._finish(error=MXNetError(
                    "engine prefill failed: %s: %s"
                    % (type(e).__name__, e)))
                met.request_finished(req)
                continue
            if seq is None:
                self._requeue(admitted[i:])
                break
            seq.request = req
            req.state = RUNNING
            sched.prefilling.append(seq)

    def _prefill_chunks(self):
        """Advance every mid-prefill sequence by ONE chunk (FIFO), bounded
        by the scheduler's token budget net of the decode batch. At least
        one chunk always runs when nothing is decoding."""
        eng, sched, met = self.engine, self.scheduler, self.metrics
        budget = sched.token_budget
        spent = eng.decode_tokens_per_step() * len(sched.running)
        for seq in list(sched.prefilling):
            cost = eng.prefill_tokens_per_step(seq.prompt_len)
            if budget is not None and spent + cost > budget and spent > 0:
                break             # the rest keep their place
            t0 = time.perf_counter()
            try:
                done = eng.prefill_step(seq)
            except Exception as e:  # chunk fault: fail THIS request
                met.engine_failure()
                sched.prefilling.remove(seq)
                self._fail([seq], "engine prefill failed", e)
                continue
            met.prefill_chunk()
            seq.prefill_s += time.perf_counter() - t0
            spent += cost
            if done:
                sched.prefilling.remove(seq)
                if seq.request is not None:
                    met.request_prefilled(seq.request)
                sched.running.append(seq)


def serve(model, **kwargs):
    """Build and start an `LMServer` over `model` (a (params, cfg) pair or
    a TransformerLM). Keyword args pass through to LMServer and its
    Engine (paged, kv_quant, weight_quant, draft, spec, spec_k,
    prefix_cache, ...); `device` defaults to the card."""
    return LMServer(model, **kwargs)
