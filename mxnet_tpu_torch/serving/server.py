"""The serving front door: in-process `serve()` and a stdlib HTTP shim
(port of `mxnet_tpu/serving/server.py`, one replica).

`serve(model, ...)` accepts a `(params, TransformerConfig)` pair, a
`TransformerLM`, an initialized Gluon Block (with `vocab=`, `max_len=`
and, for a time-major net, `time_major=True`; served by `BlockLM`), the
path of a `.mxtpu` artifact (`ExportedLM`) or either adapter, and returns
a started `LMServer`: a background thread
runs the continuous-batching loop (admit → prefill → decode step →
evict), callers submit token prompts and block on per-request futures.
The HTTP frontend (`LMServer.serve_http`) is a ThreadingHTTPServer over
the same object — one handler thread per connection, all funneling into
the single serving thread, which alone touches the engine.

The front door's contract is the reference's: tenants, priorities and
per-tenant token budgets at admission; deadlines (shed at submit when
the observed service rate cannot meet them — 503 with a computed
Retry-After — and dropped before prefill when they pass in queue — 504);
brownout under sustained saturation; a decode fault re-queues the batch
as failover replays on this server's own queue, up to `max_failovers`
hops a request; W3C `traceparent` in and out; `/statusz` and the
Prometheus text `/metrics`; the flight recorder dumped on a dead or
wedged loop; and the serving chaos seams (utils/chaos.py).

The server also carries the multi-replica door's hooks (router.py):
`role` (an advisory prefill/decode label), `on_prefill_done` (the
migration hand-off of a disaggregated fleet), `on_death` (the rescue of a
dying loop's queued and in-flight work) and `drain_queue`. `serve()`
builds a `ReplicatedLMServer` for `replicas > 1`, `autoscale`, `roles` or
`rollout` (a live weight rollout watching a checkpoint directory,
rollout.py). `tp=`/`devices=` pass through to the Engine's
tensor-parallel placement (tp.py), and `aot_cache=` to the Engine's AOT
cache (the kernel libraries its steps load, mxnet_tpu_torch/aot).
"""
from __future__ import annotations

import json
import os
import threading
import time
from http.server import ThreadingHTTPServer

import torch

from ..base import MXNetError
from .. import telemetry
from ..utils import chaos
from .engine import BlockLM, Engine, ExportedLM, TransformerLM
from .metrics import ServingMetrics
from .scheduler import (Scheduler, Request, QueueFull, BrownoutShed,
                        DeadlineExceeded, DeadlineUnmeetable, make_resume,
                        RUNNING)


def _queue_span(req):
    """Record the request's submit -> admission wait as a span on its
    trace row (req.t_submit/t_admit are perf_counter seconds; span
    timestamps are the same clock in microseconds)."""
    telemetry.record_span("serving.queue", int(req.t_submit * 1e6),
                          int((req.t_admit - req.t_submit) * 1e6),
                          trace=req.trace, category="serving",
                          to_profiler=False, request=req.id)


def _resolve_model(model, vocab=None, max_len=None, time_major=False,
                   device=None):
    if isinstance(model, (TransformerLM, BlockLM, ExportedLM)):
        return model
    if isinstance(model, str):
        return ExportedLM(model, device=device)
    if isinstance(model, tuple) and len(model) == 2:
        params, cfg = model
        return TransformerLM(params, cfg)
    if hasattr(model, "collect_params"):          # Gluon Block
        if vocab is None or max_len is None:
            raise MXNetError("serving a Gluon Block needs vocab= and "
                             "max_len=")
        return BlockLM(model, vocab, max_len, time_major=time_major)
    raise MXNetError("don't know how to serve %r — pass (params, cfg), an "
                     "adapter, a Gluon Block, or a .mxtpu path"
                     % type(model))


class _HTTPFrontend:
    """The stdlib HTTP front door. A front provides submit / snapshot /
    prometheus_text / statusz / health / close plus two backpressure
    knobs: `saturated_status` (the HTTP code a full queue maps to) and
    `retry_after_s` (emitted as a Retry-After header when set)."""

    saturated_status = 429
    retry_after_s = None
    submit_retries = 3
    submit_backoff = 0.05
    _httpd = None

    def _final_reject(self):
        """Count one request bounced by backpressure after retries."""

    def serve_http(self, host="127.0.0.1", port=8080, block=True):
        """Start the HTTP frontend. Endpoints:
        POST /v1/generate  {"tokens": [...], "max_new_tokens": N,
                            "eos_id": id?, "tenant": name?,
                            "priority": int?, "deadline_ms": ms?}
                           -> {"tokens": [...], ...}
        GET  /v1/metrics, /metrics -> the JSON snapshot, or Prometheus
                            text under `Accept: text/plain`
        GET  /statusz      -> token ledgers, tenants, SLO burn
        GET  /healthz      -> loop liveness (503 when dead or wedged)
        POST /v1/rollout   -> the front's `rollout_command` (404 on a
                              single server)
        Returns the bound (host, port); with block=False the HTTP server
        runs on a daemon thread (tests bind port 0)."""
        self._httpd = _Server((host, port), _make_handler(self))
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

    def stop_http(self):
        """End a blocking `serve_http` from another thread: its loop
        returns, and it closes the server on its own thread."""
        httpd = self._httpd
        if httpd is not None:
            httpd.shutdown()


class _Server(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog sized for a
    burst of clients (the stdlib's 5 resets connections that arrive
    while the accept loop waits for the interpreter)."""

    request_queue_size = 128
    daemon_threads = True


def _make_handler(outer):
    """BaseHTTPRequestHandler class bound to one `_HTTPFrontend`. All
    handler threads funnel into the front's submit path; the serving
    thread stays the single writer of its engine."""
    from http.server import BaseHTTPRequestHandler
    from .router import NoHealthyReplicas

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):   # keep stdout clean
            pass

        def _reply(self, code, payload, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                h = outer.health()
                self._reply(200 if h["ok"] else 503, h)
            elif self.path == "/statusz":
                self._reply(200, outer.statusz())
            elif self.path in ("/v1/metrics", "/metrics"):
                if "text/plain" in self.headers.get("Accept", ""):
                    # Prometheus scrape: text exposition 0.0.4
                    body = outer.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._reply(200, outer.snapshot())
            else:
                self._reply(404, {"error": "unknown path %s" % self.path})

        def do_POST(self):
            if self.path in ("/v1/rollout", "/rollout"):
                # live-rollout operator overrides: 404 on a door with no
                # rollout support (a single LMServer); the fleet's
                # dispatch raises MXNetError (400) until rollout exists
                dispatch = getattr(outer, "rollout_command", None)
                if dispatch is None:
                    self._reply(404, {"error": "no rollout support on "
                                               "this server"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    out = dispatch(body.get("cmd"), step=body.get("step"),
                                   reason=body.get("reason"))
                    self._reply(200, out)
                except (KeyError, ValueError, TypeError,
                        MXNetError) as e:
                    self._reply(400, {"error": "bad request: %s" % e})
                return
            if self.path not in ("/v1/generate", "/generate"):
                self._reply(404, {"error": "unknown path %s" % self.path})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                from ..utils import retry
                # a well-formed inbound W3C `traceparent` joins the
                # caller's trace; anything malformed degrades to a fresh
                # trace id — a client's garbage header never 500s the door
                trace = telemetry.parse_traceparent(
                    self.headers.get("traceparent"))
                priority = body.get("priority")
                deadline_ms = body.get("deadline_ms")
                # a briefly-full queue drains in a few decode steps:
                # absorb the burst with bounded backoff; only the FINAL
                # failure below counts as a rejection
                req = retry(
                    lambda: outer.submit(
                        body["tokens"],
                        max_new_tokens=int(
                            body.get("max_new_tokens", 32)),
                        eos_id=body.get("eos_id"),
                        count_reject=False,
                        tenant=body.get("tenant"),
                        priority=(int(priority) if priority is not None
                                  else None),
                        deadline_ms=(float(deadline_ms)
                                     if deadline_ms is not None
                                     else None),
                        trace=trace),
                    attempts=outer.submit_retries,
                    backoff=outer.submit_backoff,
                    retry_on=QueueFull)
            except DeadlineUnmeetable as e:
                # admission-time shed: 503 with the COMPUTED Retry-After
                self._reply(503, {"error": str(e)},
                            headers={"Retry-After":
                                     "%d" % max(1, int(e.retry_after_s))})
                return
            except QueueFull as e:
                outer._final_reject()
                headers = None
                if outer.retry_after_s is not None:
                    headers = {"Retry-After":
                               "%d" % max(1, int(outer.retry_after_s))}
                self._reply(outer.saturated_status, {"error": str(e)},
                            headers=headers)
                return
            except NoHealthyReplicas as e:
                # a fleet outage, NOT a client error: 503, so load
                # balancers fail over and clients retry
                self._reply(503, {"error": str(e)})
                return
            except (KeyError, ValueError, TypeError, MXNetError) as e:
                # submit-side failures are the client's fault (malformed
                # body, empty or oversized prompt)
                self._reply(400, {"error": "bad request: %s" % e})
                return
            try:
                generated = req.result(
                    timeout=float(body.get("timeout", 300)))
            except DeadlineExceeded as e:
                # the deadline passed in queue: dropped before prefill
                self._reply(504, {"error": str(e)})
                return
            except BrownoutShed as e:
                self._reply(503, {"error": str(e)},
                            headers={"Retry-After": "1"})
                return
            except MXNetError as e:
                self._reply(500, {"error": str(e)})
                return
            self._reply(200, {
                "tokens": generated,
                "prompt_len": len(req.prompt),
                "latency_ms": 1e3 * (req.t_done - req.t_submit),
                "trace": req.trace,
            }, headers={"traceparent":
                        telemetry.format_traceparent(req.trace)})

    return Handler


class LMServer(_HTTPFrontend):
    """Continuous-batching server over one Engine. Start with
    `serve(...)`; stop with `close()` (or use as a context manager).
    `device=None` serves on the card; `device="cpu"` is the only way onto
    the CPU. `tp=`/`devices=` shard the engine over a window of devices
    (tp.py). `replica_id=` labels this server's metrics registry and
    keys its chaos seams."""

    #: resume hops one request may spend before its fault is surfaced
    max_failovers = 2

    def __init__(self, model, max_batch=8, max_len=None, block_size=16,
                 num_blocks=None, max_queue=64, queue_timeout=None,
                 keep_logits=False, vocab=None, time_major=False,
                 idle_wait=0.005, paged=None,
                 prefill_chunk=None, token_budget=None, tp=None,
                 devices=None, replica_id=None, prefix_cache=None,
                 tenant_budget=None, tenant_budgets=None,
                 default_priority=0, default_deadline_ms=None,
                 brownout=None, aot_cache=None, role=None, draft=None,
                 spec=None, spec_k=None, kv_quant=None, weight_quant=None,
                 device=None):
        adapter = _resolve_model(model, vocab=vocab, max_len=max_len,
                                 time_major=time_major, device=device)
        self.engine = Engine(adapter, max_batch=max_batch,
                             max_len=max_len, block_size=block_size,
                             num_blocks=num_blocks, keep_logits=keep_logits,
                             paged=paged, prefill_chunk=prefill_chunk,
                             tp=tp, devices=devices, device=device,
                             prefix_cache=prefix_cache, aot_cache=aot_cache,
                             draft=draft, spec=spec, spec_k=spec_k,
                             kv_quant=kv_quant, weight_quant=weight_quant)
        self.scheduler = Scheduler(max_batch=max_batch, max_queue=max_queue,
                                   queue_timeout=queue_timeout,
                                   token_budget=token_budget,
                                   tenant_budget=tenant_budget,
                                   tenant_budgets=tenant_budgets,
                                   brownout=brownout)
        self.default_priority = int(default_priority)
        if default_deadline_ms is None:
            env = os.environ.get("MXNET_SERVING_DEADLINE_MS")
            default_deadline_ms = float(env) if env else None
        self.default_deadline_ms = default_deadline_ms
        self.metrics = ServingMetrics(replica=replica_id)
        self.replica_id = replica_id
        # disaggregated serving: `role` is an advisory label
        # ("prefill"/"decode"/None) the router stamps for placement and
        # observability — it never changes this server's compute.
        # `on_prefill_done` is the router's migration hook on prefill
        # replicas, called on the serving thread when a prompt finishes
        # prefilling.
        self.role = str(role) if role is not None else None
        self.on_prefill_done = None
        self._idle_wait = idle_wait
        self._work = threading.Event()
        self._closed = False
        # `on_death` is the router's rescue hook — called with the queued
        # requests and the in-flight (request, tokens, prompt_len) states
        # of a dying or closing loop so they can be re-homed instead of
        # failed; `_died` tells a crashed loop (respawnable) from an
        # administrative close
        self.on_death = None
        self._died = False
        self._chaos_stolen = None     # (block ids, release-at iteration)
        # serializes in-flight capture between the death path, the
        # migration hand-off (serving thread) and the router's wedge
        # rescue (sweep thread): whoever detaches a sequence first owns
        # it — the other side sees request=None and captures nothing
        self._failover_lock = threading.Lock()
        # liveness observables for /healthz: the loop thread beats every
        # iteration; decode progress stamps separately
        self._last_beat = time.perf_counter()
        self._last_step_t = None
        self._wedge_dumped = False
        self._thread = threading.Thread(target=self._loop,
                                        name="mxtt-serving", daemon=True)
        self._thread.start()

    # -- client API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens=32, eos_id=None,
               count_reject=True, tenant=None, priority=None,
               deadline_ms=None, trace=None):
        """Enqueue one request; returns it (a future: .result(timeout)).
        Raises QueueFull immediately when backpressure kicks in;
        `count_reject=False` leaves the rejection uncounted, for retry
        wrappers that count only the final failure. `tenant`/`priority`
        feed the scheduler's multi-tenant admission (default tenant,
        server default priority when omitted). `deadline_ms` (default
        `default_deadline_ms` / MXNET_SERVING_DEADLINE_MS) is the
        client's total latency budget: a request the OBSERVED service
        rate already can't meet is shed here (DeadlineUnmeetable, with
        the computed Retry-After). `trace` is the caller's trace id (the
        HTTP frontend passes a parsed W3C `traceparent`); unset mints a
        fresh one. Every span of the request's life keys on it."""
        if self._closed:
            # a replica behind the router reports closure as
            # backpressure, so the door tries the next replica; a
            # standalone server keeps the hard contract
            if self.replica_id is not None:
                raise QueueFull("replica %s is closed" % self.replica_id)
            raise MXNetError("server is closed")
        if len(prompt) > self.engine.max_len:
            raise MXNetError(
                "prompt length %d exceeds the server's max_len %d"
                % (len(prompt), self.engine.max_len))
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        req = Request(prompt, max_new_tokens=max_new_tokens, eos_id=eos_id,
                      tenant=tenant,
                      priority=(priority if priority is not None
                                else self.default_priority),
                      deadline_ms=deadline_ms, trace=trace)
        if deadline_ms is not None:
            # after the Request exists, so a shed has an id/trace/tenant
            # to account and log against (it was never submitted: its
            # terminal accounting happens in the gate)
            self._check_deadline_meetable(req)
        try:
            self.scheduler.submit(req)
        except QueueFull:
            if count_reject:
                self.metrics.request_rejected()
            raise
        if self._closed:
            # the loop died between the check above and the enqueue:
            # pull the request back if it is still queued
            with self.scheduler._lock:
                try:
                    self.scheduler._queue.remove(req)
                    pulled = True
                except ValueError:
                    pulled = False
            if pulled:
                if self.replica_id is not None:
                    raise QueueFull("replica %s closed mid-submit"
                                    % self.replica_id)
                raise MXNetError("server is closed")
        self.metrics.request_submitted(req)
        # the trace row's start marker: every later span (queue, prefill
        # chunks, decode steps) shares this request's trace id
        telemetry.record_span("serving.submit", int(req.t_submit * 1e6),
                              0, trace=req.trace, category="serving",
                              to_profiler=False, request=req.id,
                              prompt_len=len(req.prompt),
                              max_new_tokens=req.max_new_tokens)
        self._work.set()
        return req

    def adopt(self, req):
        """Enqueue a Request object created elsewhere (a drained
        replica's orphan, or a replay of `spawn_resume` /
        `spawn_migrate`). Raises QueueFull under backpressure."""
        if self._closed:
            raise QueueFull("replica is closed")
        self.scheduler.submit(req)
        self._work.set()
        return req

    def drain_queue(self):
        """Pull every queued (not yet admitted) request off this
        server's scheduler — the router calls this when the replica
        wedges, then re-routes the orphans to healthy replicas."""
        with self.scheduler._lock:
            orphans = list(self.scheduler._queue)
            self.scheduler._queue.clear()
        return orphans

    def _load_split(self):
        """Committed backlog split into (prefill tokens, decode tokens)
        — the two drain at very different rates, and the deadline gate
        prices each at its own observed rate. Advisory reads."""
        sched = self.scheduler
        with sched._lock:
            queued = list(sched._queue)
        pre = sum(len(r.prompt) for r in queued)
        dec = sum(r.max_new_tokens for r in queued)
        for s in list(sched.running):
            dec += max(1, s.max_total - len(s.tokens))
        for s in list(sched.prefilling):
            pre += max(0, s.prompt_len - s.prefilled)
            dec += max(1, s.max_total - s.prompt_len)
        return pre, dec

    def load_tokens(self):
        """Tokens this server is still committed to: queued requests'
        prompt + generation budgets plus every in-flight sequence's
        remaining tokens (the same backlog walk the deadline gate
        reads)."""
        pre, dec = self._load_split()
        return pre + dec

    def _check_deadline_meetable(self, req):
        """Admission-time deadline gate: the estimated completion time is
        the committed DECODE backlog over the observed decode token rate
        PLUS the prefill backlog over the observed prefill rate. When it
        already exceeds the deadline, shed NOW with a Retry-After of how
        long the backlog needs to drain below feasibility. No measured
        rate yet: admit."""
        deadline_ms = req.deadline_ms
        rate = self.metrics.observed_token_rate()
        if rate is None or rate <= 0:
            return
        pre_b, dec_b = self._load_split()
        pre_b += len(req.prompt)
        dec_b += req.max_new_tokens
        prate = self.metrics.observed_prefill_rate()
        est_s = dec_b / rate + (pre_b / prate if prate else 0.0)
        if est_s <= deadline_ms / 1e3:
            return
        self.metrics.request_deadline_shed(req)
        retry_after = max(1.0, est_s - deadline_ms / 1e3)
        raise DeadlineUnmeetable(
            "deadline %.0f ms unmeetable: %d decode + %d prefill "
            "backlog tokens at the observed %.0f tok/s decode rate "
            "need ~%.0f ms; retry in %.0fs"
            % (deadline_ms, dec_b, pre_b, rate, est_s * 1e3,
               retry_after),
            retry_after_s=retry_after)

    def generate(self, prompt, max_new_tokens=32, eos_id=None,
                 timeout=None):
        """Synchronous helper: submit and wait; returns generated tokens
        (prompt excluded)."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           eos_id=eos_id).result(timeout)

    def snapshot(self):
        return self.metrics.snapshot(self.engine, self.scheduler)

    def prometheus_text(self):
        """Prometheus exposition of the server's metrics registry (the
        `/metrics` body under `Accept: text/plain`)."""
        return self.metrics.prometheus_text(self.engine, self.scheduler)

    def statusz(self):
        """The /statusz JSON body: the goodput token ledger, per-tenant
        breakdown, and SLO attainment/burn for this server."""
        body = self.metrics.statusz(self.engine, self.scheduler)
        if self.role is not None:
            # stamped only on disaggregated fleets: role-less bodies
            # keep the single server's key set
            body["role"] = self.role
        return body

    def health(self, max_beat_age=5.0):
        """Loop liveness for /healthz: `ok` requires the serving thread
        alive AND beating recently (a wedged loop is as dead as a crashed
        one). `last_step_age_s` is decode-progress age — None until the
        first decode step. The FIRST health check that observes a wedged
        loop dumps the flight recorder (a dead loop dumped it as it
        died)."""
        now = time.perf_counter()
        alive = self._thread.is_alive() and not self._closed
        beat_age = now - self._last_beat
        ok = bool(alive and beat_age < max_beat_age)
        if not ok and not self._closed and not self._wedge_dumped:
            self._wedge_dumped = True
            telemetry.flight().record(
                "fault", "serving.healthz_wedge",
                loop_alive=bool(alive), beat_age_s=round(beat_age, 3))
            telemetry.flight().dump("healthz_wedge")
        return {
            "ok": ok,
            "loop_alive": bool(alive),
            "last_beat_age_s": round(beat_age, 3),
            "last_step_age_s": (round(now - self._last_step_t, 3)
                                if self._last_step_t is not None else None),
            "engine_failures": self.metrics.engine_failures,
        }

    def close(self, drain=True, timeout=30.0):
        """Stop the loop; with drain=True finish in-flight work first. A
        clean close (drained, loop exited on its own terms) runs the
        engine's block-pool leak audit. Anything still queued or in
        flight afterwards (a submit that slipped past the closed check,
        a request mid-admission) is rescued through `on_death` when a
        router installed one, and failed promptly otherwise."""
        if drain:
            deadline = time.perf_counter() + timeout
            while self.scheduler.has_work() and \
                    time.perf_counter() < deadline:
                time.sleep(0.01)
        clean = drain and not self._died and not self.scheduler.has_work()
        self._closed = True
        self._work.set()
        self._thread.join(timeout=timeout)
        self._strand(MXNetError("server closed with the request still "
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
        except BaseException as e:  # noqa: BLE001 — a dead loop must not
            # strand clients in result(): dump the black box, then rescue
            # (through the router's on_death hook) or fail everything
            # queued or in flight
            telemetry.flight().record("fault", "serving.loop_died",
                                      error="%s: %s"
                                      % (type(e).__name__, e))
            telemetry.flight().dump("serving_loop_died")
            self._died = True
            self._closed = True
            self._strand(MXNetError("serving loop died: %s: %s"
                                    % (type(e).__name__, e)))
            raise

    def _strand(self, err):
        """Capture AND DETACH every in-flight request (under the failover
        lock, so a concurrent wedge rescue cannot capture one twice) with
        the tokens it has so far, release every sequence's blocks (not
        reusable: an exited loop cannot certify their KV) and the
        chaos-held blocks, and pull the queue. Then hand queued and
        in-flight work to `on_death`, or fail it with `err`."""
        sched = self.scheduler
        states = []
        with self._failover_lock:
            for seq in sched.running + sched.prefilling:
                req = seq.request
                if req is None or req._event.is_set():
                    continue
                states.append((req, list(seq.tokens), seq.prompt_len))
                seq.request = None
                seq.done = True
        for seq in sched.running + sched.prefilling:
            try:
                self.engine.release(seq, reusable=False)
            except Exception:
                pass      # a broken pool must not strand the clients
        sched.running = []
        sched.prefilling = []
        self._release_chaos_blocks()
        queued = self.drain_queue()
        if not (queued or states):
            return
        if self.on_death is not None:
            try:
                self.on_death(self, queued, states)
                return
            except Exception:
                pass      # rescue failed: fall back to failing
        for req in [st[0] for st in states] + queued:
            if not req.wait(0):
                req._finish(error=err)
                self.metrics.request_finished(req)

    def _loop_inner(self):
        eng, sched, met = self.engine, self.scheduler, self.metrics
        rid = self.replica_id if self.replica_id is not None else 0
        it = 0
        while not self._closed:
            it += 1
            self._last_beat = time.perf_counter()
            # chaos seams (no-ops unless armed): a kill raises HERE —
            # outside the engine-fault isolation — so the loop dies like
            # a real bug; a wedge sleeps so the beat goes stale;
            # exhaustion steals the free list for a few rounds
            chaos.maybe_kill_serving_loop(rid, it)
            chaos.maybe_wedge_serving_loop(rid, it)
            # a standing per-iteration sleep on ONE replica: the
            # healthy-but-slow canary the rollout judge must roll back
            chaos.rollout_slow_canary(rid, it)
            self._chaos_pool_pressure(rid, it)
            admitted, expired = sched.admit(eng)
            for req in expired:
                if isinstance(req.error, DeadlineExceeded):
                    met.request_deadline_shed()
                elif isinstance(req.error, BrownoutShed):
                    met.request_brownout_shed()
                met.request_expired(req)
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
                try:
                    if chaos.decode_poison(rid, it):
                        raise MXNetError("chaos: decode step poisoned")
                    if eng.spec:
                        # NaN-fill THIS iteration's draft logits when
                        # armed: the engine degrades the batch to the
                        # plain step, token-identical
                        eng.chaos_spec_poison = chaos.spec_poison(rid, it)
                    # a speculative step emits a burst per sequence:
                    # count tokens as post-length minus pre-length
                    pre_lens = [len(s.tokens) for s in sched.running
                                if not s.done]
                    advanced = eng.decode_step(sched.running)
                except Exception as e:
                    # a decode fault poisons the STEP, not the history:
                    # re-queue the batch on this server as failover
                    # replays (prompt + generated so far re-prefills,
                    # decode continues token-identically); a request that
                    # keeps hitting faults exhausts max_failovers and
                    # surfaces the error
                    met.engine_failure()
                    err = MXNetError("engine decode failed: %s: %s"
                                     % (type(e).__name__, e))
                    self._resume_locally(sched.running, err)
                    sched.running = []
                    continue
                self._last_step_t = time.perf_counter()
                if advanced:
                    emitted = sum(len(s.tokens) - n
                                  for s, n in zip(advanced, pre_lens))
                    met.decode_step(len(advanced), eng.max_batch,
                                    self._last_step_t - t0,
                                    cache_util=eng.cache_utilization(),
                                    paged=eng.paged, tokens=emitted)
                    if eng.last_spec is not None:
                        met.spec_pass(**eng.last_spec)
                        eng.last_spec = None
                    # per-request inter-token latency: one observation
                    # per EMITTED token (a speculative burst's interior
                    # gaps are ~0: the client receives them together)
                    for s, n in zip(advanced, pre_lens):
                        if s.request is not None:
                            for posn in range(n, len(s.tokens)):
                                met.token_generated(
                                    s.request, now=self._last_step_t,
                                    position=posn)
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
            t0 = time.perf_counter()
            # the engine's prefill span inherits the request's trace id
            # through the thread-local (the Sequence only learns its
            # request after start() returns)
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
            _queue_span(req)
            met.request_admitted(req)
            met.request_prefilled(req, time.perf_counter() - t0)
            # disaggregated serving: the chunked path's hand-off seam —
            # the one-shot prefill completed, its first token appended
            if not seq.done and self.on_prefill_done is not None \
                    and not req._event.is_set() \
                    and self._migrate_out(seq, req):
                continue
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
            _queue_span(req)
            met.request_admitted(req)
            if req.migrated and seq.cache_hit_tokens:
                # the migration hop's savings, priced at THIS engine's KV
                # layout: every prompt token the prefix cache already
                # held is KV the hop did not rebuild
                met.request_migration_savings(
                    req, seq.cache_hit_tokens,
                    seq.cache_hit_tokens * eng.kv_bytes_per_token())
            sched.prefilling.append(seq)

    def _prefill_chunks(self):
        """Advance every mid-prefill sequence by ONE chunk (FIFO), bounded
        by the scheduler's token budget net of the decode batch (priced
        as admission prices it: k+1 scored tokens per speculating
        sequence). At least one chunk always runs when nothing is
        decoding."""
        eng, sched, met = self.engine, self.scheduler, self.metrics
        budget = sched.token_budget
        spent = eng.decode_tokens_per_step() * len(sched.running)
        for seq in list(sched.prefilling):
            if seq.done:
                # detached by a router failover while this loop was
                # wedged: the request lives elsewhere now — release the
                # blocks (mid-prefill KV may be partial) and move on
                sched.prefilling.remove(seq)
                try:
                    eng.release(seq, reusable=False)
                except Exception:
                    pass
                continue
            cost = eng.prefill_tokens_per_step(seq.prompt_len)
            if budget is not None and spent + cost > budget and spent > 0:
                break             # the rest keep their place
            t0 = time.perf_counter()
            try:
                done = eng.prefill_step(seq)
            except Exception as e:  # chunk fault: fail THIS request,
                met.engine_failure()  # free its blocks, keep serving
                sched.prefilling.remove(seq)
                try:
                    eng.release(seq, reusable=False)
                except Exception:
                    pass
                if seq.request is not None:
                    seq.request._finish(error=MXNetError(
                        "engine prefill failed: %s: %s"
                        % (type(e).__name__, e)))
                    met.request_finished(seq.request)
                continue
            seq.prefill_s += time.perf_counter() - t0
            spent += cost
            if seq.request is not None:
                met.request_chunk(seq.request, seq.prefilled)
            if done:
                sched.prefilling.remove(seq)
                req = seq.request
                if req is not None:
                    met.request_prefilled(req, seq.prefill_s)
                # disaggregated serving: a prefill replica hands the
                # finished prompt to a decode replica here — after the
                # first token (TTFT observed on THIS replica, which
                # produced it), before any steady-state decode. A
                # sequence already complete finishes locally; a failed
                # placement decodes locally (co-scheduled fallback)
                if req is not None and not seq.done \
                        and self.on_prefill_done is not None \
                        and not req._event.is_set() \
                        and self._migrate_out(seq, req):
                    met.prefill_chunk(len(sched.prefilling))
                    continue
                sched.running.append(seq)
            met.prefill_chunk(len(sched.prefilling))

    # -- migration (disaggregated serving) -----------------------------------

    def _migrate_out(self, seq, req):
        """Hand one just-prefilled sequence to the router's migration
        hook (`on_prefill_done`). Returns True when the request now lives
        elsewhere (a migration resume was placed on a decode replica, or
        nothing remained and the hook finished it): the local sequence is
        released, its prefilled KV registered in THIS replica's prefix
        cache. Returns False when the source should keep decoding it
        (no healthy decode replica, or every one saturated).

        Exactly-once: the sequence is DETACHED under the failover lock
        before the hook can place a replay anywhere — once a resume
        exists, this loop can only release, never finish. A failed
        placement re-attaches; the sequence was in neither scheduler
        list meanwhile (the caller popped it from `prefilling` and has
        not appended it to `running`), so no rescue sweep can have
        captured it."""
        hook = self.on_prefill_done
        with self._failover_lock:
            if seq.request is None or req._event.is_set():
                return False
            seq.request = None
            seq.done = True
        tokens = list(seq.tokens)
        try:
            placed = bool(hook(self, req, tokens))
        except Exception:
            placed = False
        if not placed:
            with self._failover_lock:
                seq.request = req
                seq.done = False
            return False
        # the prompt is fully prefilled and its first token appended:
        # the KV is certified, so the prompt stays resident in the
        # source's prefix cache while the blocks go back to the pool
        try:
            self.engine.release(seq, reusable=True)
        except Exception:
            pass
        return True

    # -- decode-fault recovery -----------------------------------------------

    def _resume_locally(self, seqs, err):
        """Release every poisoned sequence's blocks and re-queue each
        request on THIS server as a failover replay (prompt + tokens
        generated so far; that history predates the faulted step, so the
        greedy continuation is token-identical). A request that has
        exhausted its failover budget surfaces the engine error."""
        for seq in list(seqs):
            req = seq.request
            tokens = list(seq.tokens)
            try:
                self.engine.release(seq, reusable=False)
            except Exception:
                pass
            if req is None or req._event.is_set():
                continue
            if req.failovers >= self.max_failovers:
                req._finish(error=err)
                self.metrics.request_finished(req)
                continue
            try:
                resume, carried = spawn_resume(req, tokens, self)
            except QueueFull:
                req._finish(error=err)
                self.metrics.request_finished(req)
                continue
            if resume is None:      # generation was already complete
                self.metrics.request_finished(req)
            else:
                self.metrics.request_failover(req, carried)

    # -- chaos seams ---------------------------------------------------------

    def _chaos_pool_pressure(self, rid, it):
        """Armed serve_exhaust: steal the whole free list for a few loop
        iterations (admission sees transient exhaustion and queues), then
        hand the blocks back."""
        if self._chaos_stolen is not None:
            ids, release_at = self._chaos_stolen
            if it >= release_at:
                if ids:
                    self.engine.cache.pool.free(ids)
                self._chaos_stolen = None
            return
        hold = chaos.pool_exhaustion(rid, it)
        if hold and self.engine.cache is not None:
            pool = self.engine.cache.pool
            ids = pool.try_alloc(pool.available) or []
            self._chaos_stolen = (ids, it + hold)

    def _release_chaos_blocks(self):
        if self._chaos_stolen is None:
            return
        ids, _ = self._chaos_stolen
        self._chaos_stolen = None
        try:
            if ids:
                self.engine.cache.pool.free(ids)
        except Exception:
            pass

    def _final_reject(self):
        self.metrics.request_rejected()


def spawn_resume(orig, tokens, target):
    """Place one failover replay for `orig` onto `target` (an LMServer):
    the resume's prompt is `tokens` — the original prompt plus everything
    generated before the fault — replayed as a prefill, after which
    decode continues. The stitch callback completes `orig` from the
    resume's result, so the client's future resolves with ONE token
    stream, greedy-token-identical to an undisturbed run.

    Returns `(resume, carried)`; `resume` is None when the generation was
    already complete (orig finished directly). Raises QueueFull when the
    target can't absorb it. Metric accounting stays with the caller."""
    resume, carried = make_resume(orig, tokens, target.engine.max_len)
    if resume is None:
        orig._finish(tokens=list(tokens))
        return None, carried

    def stitch(r):
        if r.error is None:
            orig._finish(tokens=list(r.tokens))
        else:
            orig._finish(error=r.error)

    resume._on_finish = stitch
    target.adopt(resume)
    # the hop annotation on the request's (single, stitched) trace row
    now_us = time.perf_counter_ns() // 1000
    telemetry.record_span("serving.failover_hop", now_us, 0,
                          trace=orig.trace, category="serving",
                          to_profiler=False, request=orig.id,
                          resume=resume.id, carried_tokens=carried,
                          hop=resume.failovers,
                          target=target.replica_id)
    return resume, carried


def spawn_migrate(orig, tokens, target):
    """Place one PLANNED prefill->decode migration hop for `orig` onto
    `target` (a decode-role LMServer): the replay transport of
    `spawn_resume` — the target re-prefills prompt + generated-so-far,
    skipping every KV block its prefix cache already holds, and decode
    continues greedy-token-identically — but the hop spends no failover
    budget and admission treats it as already-admitted work (never
    brownout-shed or clamped). Deadline, tenant, priority, the client's
    latency anchors and the trace ride along, so the request stays ONE
    trace row and is SLO-classified once, at its terminal state on the
    target.

    Returns `(resume, carried)`; `resume` is None when the generation was
    already complete (orig finished directly). Raises QueueFull when the
    target can't absorb it. Metric accounting stays with the caller."""
    resume, carried = make_resume(orig, tokens, target.engine.max_len,
                                  migrate=True)
    if resume is None:
        orig._finish(tokens=list(tokens))
        return None, carried

    def stitch(r):
        if r.error is None:
            orig._finish(tokens=list(r.tokens))
        else:
            orig._finish(error=r.error)

    resume._on_finish = stitch
    target.adopt(resume)
    now_us = time.perf_counter_ns() // 1000
    telemetry.record_span("serving.migration_hop", now_us, 0,
                          trace=orig.trace, category="serving",
                          to_profiler=False, request=orig.id,
                          resume=resume.id, carried_tokens=carried,
                          target=target.replica_id)
    return resume, carried


def serve(model, replicas=None, autoscale=None, roles=None, rollout=None,
          **kwargs):
    """Build and start a serving front door over `model` (a (params, cfg)
    pair, a TransformerLM, a Gluon Block with `vocab=` / `max_len=` /
    `time_major=`, a `.mxtpu` path, or a BlockLM / ExportedLM). Keyword
    args pass through to each LMServer and its Engine (paged, kv_quant,
    weight_quant, draft, spec, spec_k, prefix_cache, aot_cache, tenant
    budgets, deadlines, brownout, ...); `device` defaults to the card (a
    Block's own device for a Block). With `replicas=N > 1` (or
    MXNET_SERVING_REPLICAS) this is a `ReplicatedLMServer`: N replicas,
    each with its own scheduler, block pool, serving thread and metrics
    registry, behind one least-loaded front (router.py). `autoscale=True`
    (or MXNET_SERVING_AUTOSCALE=1) arms SLO-driven elastic scaling
    (autoscale.py) and always builds the replicated door, even at one
    replica, so the fleet can grow. `roles="prefill:N,decode:M"` (or
    MXNET_SERVING_ROLES) builds a disaggregated fleet of N + M replicas
    (`replicas` is then ignored). `rollout=<checkpoint dir>` (or
    MXNET_SERVING_ROLLOUT_DIR) attaches a live-rollout watcher
    (rollout.py) on a daemon thread: newly published checkpoint steps are
    gated, canaried, judged and promoted or rolled back with zero
    downtime; it too always builds the replicated door, so a canary has
    somewhere to stand. Otherwise a single `LMServer`."""
    from .autoscale import autoscale_enabled
    from .router import (ReplicatedLMServer, serving_replicas,
                         serving_roles)
    from .rollout import rollout_dir
    role_map = serving_roles(roles)
    scale = autoscale_enabled() if autoscale is None else autoscale
    rdir = rollout_dir() if rollout is None else (rollout or None)
    if role_map:
        srv = ReplicatedLMServer(model, roles=role_map, autoscale=scale,
                                 **kwargs)
    else:
        n = serving_replicas() if replicas is None else int(replicas)
        if not (n > 1 or scale or rdir):
            return LMServer(model, **kwargs)
        srv = ReplicatedLMServer(model, replicas=n, autoscale=scale,
                                 **kwargs)
    if rdir:
        try:
            srv.attach_rollout(rdir, start=True)
        except BaseException:
            srv.close(drain=False, timeout=5.0)
            raise
    return srv
