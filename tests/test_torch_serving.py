"""Port parity for the serving stack (mxnet_tpu_torch/serving/) against
the JAX reference (mxnet_tpu/serving/), on the CPU.

The reference's weights cross over as numpy arrays; the same prompts go
through both engines, on the gather path and on the paged path (the
reference's Pallas kernel in interpreter mode, the port's plain version
of its CUDA kernel), and through both servers in-process and over HTTP.
Tolerances are the reference's own engine-parity ones
(tests/test_pallas_paged.py): logits at rtol 1e-4 / atol 1e-5, greedy
tokens identical.
"""
import json
import os
import re
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from mxnet_tpu import serving as jserving
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TINY = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64)
# the reference's engine-parity prompts: lengths 9, 4 and 19 at block
# size 8 span several table widths, and 19 tokens take 3 prefill chunks
PROMPTS = [[(1 + t) % 48 for t in range(9)],
           [(5 + 2 * t) % 48 for t in range(4)],
           [(7 + 3 * t) % 48 for t in range(19)]]
_ENGINE = dict(max_batch=4, block_size=8, keep_logits=True,
               prefill_chunk=8)


@pytest.fixture(scope="module")
def lm():
    jcfg = jtf.TransformerConfig(**_TINY)
    jparams = jtf.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    cfg = TransformerConfig(**_TINY)
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jparams.items()}, cfg, "cpu")
    return jparams, jcfg, params, cfg


def _drive(eng, steps=5):
    """Prefill every prompt, then `steps` batched decode steps; returns
    per-step logits, final tokens."""
    seqs = [eng.start(list(p), max_new=steps + 1) for p in PROMPTS]
    logits = [[np.asarray(s.last_logits) for s in seqs]]
    for _ in range(steps):
        eng.decode_step(seqs)
        logits.append([np.asarray(s.last_logits) for s in seqs])
    tokens = [list(s.tokens) for s in seqs]
    for s in seqs:
        eng.release(s)
    return logits, tokens


@pytest.fixture(scope="module")
def jax_engine_runs(lm):
    jparams, jcfg, _, _ = lm
    return {paged: _drive(jserving.Engine(
        jserving.TransformerLM(jparams, jcfg), paged=paged, **_ENGINE))
        for paged in (False, True)}


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_jax(lm, jax_engine_runs, paged):
    _, _, params, cfg = lm
    eng = serving.Engine(serving.TransformerLM(params, cfg), paged=paged,
                         device="cpu", **_ENGINE)
    assert eng.paged is paged
    logits, tokens = _drive(eng)
    want_logits, want_tokens = jax_engine_runs[paged]
    for step in range(len(want_logits)):
        for i in range(len(PROMPTS)):
            np.testing.assert_allclose(
                logits[step][i], want_logits[step][i], rtol=1e-4,
                atol=1e-5, err_msg="step %d seq %d" % (step, i))
    assert tokens == want_tokens
    if paged:
        chunks = [sig for kind, sig in eng._sigs if kind == "prefill"]
        assert len({w for _, w in chunks}) >= 2, eng._sigs  # table widths
        assert all(c == 8 for c, _ in chunks)
    eng.close()


@pytest.mark.parametrize("paged", [False, True])
def test_engine_matches_jax_bf16(lm, paged):
    """bf16 weights and pools, both paths, against the reference engine
    in bf16. A step is compared while both engines have been fed the same
    tokens: a bf16 near-tie may flip a greedy token in one framework, and
    the sequences then legitimately diverge. Tolerance: bf16 keeps 8
    mantissa bits (~4e-3 relative), compounded over the layers; the two
    frameworks round products at different places."""
    import jax.numpy as jnp
    jparams, jcfg, _, _ = lm
    cfg = TransformerConfig(dtype=torch.bfloat16, **_TINY)
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jparams.items()}, cfg, "cpu")
    jb = {k: v.astype(jnp.bfloat16) for k, v in jparams.items()}
    want, want_tokens = _drive(jserving.Engine(
        jserving.TransformerLM(jb, jcfg), paged=paged, **_ENGINE), steps=3)
    eng = serving.Engine(serving.TransformerLM(params, cfg), paged=paged,
                         device="cpu", **_ENGINE)
    assert eng.cache.k.dtype == torch.bfloat16
    got, tokens = _drive(eng, steps=3)
    compared = 0
    for i, p in enumerate(PROMPTS):
        n = len(p)
        for step in range(len(want)):
            if tokens[i][:n + step] != want_tokens[i][:n + step]:
                break
            np.testing.assert_allclose(got[step][i], want[step][i],
                                       rtol=5e-2, atol=1e-2,
                                       err_msg="step %d seq %d"
                                       % (step, i))
            compared += 1
    assert compared >= 2 * len(PROMPTS)
    eng.close()


def test_chunked_prefill_matches_dense_prefill(lm):
    """The 19-token prompt prefilled in 3 chunks gives the same first
    logits and greedy continuation as the one-shot dense prefill."""
    _, _, params, cfg = lm
    out = {}
    for paged in (False, True):
        eng = serving.Engine(serving.TransformerLM(params, cfg),
                             paged=paged, device="cpu", **_ENGINE)
        seq = eng.begin(list(PROMPTS[2]), max_new=8)
        n = 1
        while not eng.prefill_step(seq):
            n += 1
        first = seq.last_logits
        while not seq.done:
            eng.decode_step([seq])
        out[paged] = (n, first, list(seq.tokens))
        eng.release(seq)
        eng.close()
    assert out[True][0] == 3 and out[False][0] == 1
    np.testing.assert_allclose(out[True][1], out[False][1], rtol=1e-4,
                               atol=1e-5)
    assert out[True][2] == out[False][2]


@pytest.fixture(scope="module")
def jax_server_tokens(lm):
    jparams, jcfg, _, _ = lm
    srv = jserving.serve((jparams, jcfg), max_batch=2, block_size=8,
                         paged=True, prefill_chunk=8)
    try:
        return [srv.generate(p, max_new_tokens=6, timeout=300)
                for p in PROMPTS[:2]]
    finally:
        srv.close()


def _http(host, port, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request("http://%s:%d%s" % (host, port, path),
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_and_http_match_jax(lm, jax_server_tokens):
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=2, block_size=8,
                        paged=True, prefill_chunk=8, device="cpu")
    try:
        assert srv.generate(PROMPTS[0], max_new_tokens=6, timeout=120) \
            == jax_server_tokens[0]
        host, port = srv.serve_http(port=0, block=False)
        code, body = _http(host, port, "/v1/generate",
                           {"tokens": PROMPTS[1], "max_new_tokens": 6})
        assert code == 200 and body["tokens"] == jax_server_tokens[1]
        assert body["prompt_len"] == len(PROMPTS[1])
        code, met = _http(host, port, "/metrics")
        assert code == 200 and met["requests"]["completed"] == 2
        assert met["paths"]["paged_decode_steps"] > 0
        assert met["paths"]["gather_decode_steps"] == 0
        assert met["paths"]["prefill_chunks"] == 3    # 9 -> 2, 4 -> 1
        assert met["requests"]["engine_failures"] == 0
        assert met["latency_ms"]["time_to_first_token_mean"] > 0
        assert _http(host, port, "/healthz")[1]["ok"]
        assert _http(host, port, "/v1/generate", {"nope": 1})[0] == 400
        assert _http(host, port, "/nowhere")[0] == 404
    finally:
        srv.close()
    assert srv.engine.cache.pool.in_use == 0


def test_queue_backpressure(lm):
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=1, max_queue=2,
                        block_size=8, device="cpu")
    try:
        reqs = []
        with pytest.raises(serving.QueueFull):
            for _ in range(16):             # 1 running + 2 queued max
                reqs.append(srv.submit([1, 2, 3], max_new_tokens=32))
        assert len(reqs) >= 2
        assert srv.snapshot()["requests"]["rejected"] >= 1
        for r in reqs:
            assert len(r.result(timeout=120)) == 32
    finally:
        srv.close()


def test_token_budget_and_fifo_admission(lm):
    """A budget of one chunk: the paged loop still drains every request,
    FIFO, with chunks interleaved with decode."""
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=2, block_size=8,
                        paged=True, prefill_chunk=8, token_budget=8,
                        device="cpu")
    try:
        reqs = [srv.submit(p, max_new_tokens=5) for p in PROMPTS]
        outs = [r.result(timeout=120) for r in reqs]
        assert all(len(o) == 5 for o in outs)
        assert reqs[0].t_admit <= reqs[1].t_admit <= reqs[2].t_admit
        snap = srv.snapshot()
        assert snap["paths"]["prefill_chunks"] == 2 + 1 + 3
        assert snap["scheduler"]["token_budget"] == 8
    finally:
        srv.close()


def test_queue_timeout_and_oversized_prompt(lm):
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=1, block_size=8,
                        queue_timeout=0.02, device="cpu")
    try:
        with pytest.raises(MXNetError, match="max_len"):
            srv.submit(list(range(cfg.max_len + 1)), max_new_tokens=4)
        blocker = srv.submit(PROMPTS[2], max_new_tokens=40)
        victim = srv.submit(PROMPTS[1], max_new_tokens=4)
        with pytest.raises(serving.RequestTimeout):
            victim.result(timeout=120)
        assert len(blocker.result(timeout=120)) == 40
        snap = srv.snapshot()["requests"]
        assert (snap["expired"], snap["failed"], snap["completed"]) == \
            (1, 1, 1)
    finally:
        srv.close()


def test_entry_points_default_to_the_card(lm, monkeypatch):
    """No device given and no CUDA: Engine(), serve(), the KV pool, the
    initializer, the weight loader and the train step raise instead of
    running on the CPU."""
    from mxnet_tpu_torch.models import (init_transformer_params,
                                        make_transformer_train_step)
    jparams, _, params, cfg = lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="cuda"):
        serving.PagedKVCache(cfg.n_layers, cfg.n_heads,
                             cfg.d_model // cfg.n_heads)
    with pytest.raises(MXNetError, match="cuda"):
        init_transformer_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(MXNetError, match="cuda"):
        params_from_numpy(jparams, cfg, None)
    with pytest.raises(MXNetError, match="cuda"):
        serving.Engine(serving.TransformerLM(params, cfg))
    with pytest.raises(MXNetError, match="cuda"):
        serving.serve((params, cfg))
    with pytest.raises(MXNetError, match="cuda"):
        serving.Engine(serving.TransformerLM(params, cfg), device="cuda:0")
    with pytest.raises(MXNetError, match="cuda"):
        make_transformer_train_step(cfg)


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|mxnet_tpu)(\.|\s|$)",
                        re.M)


def test_port_sources_import_no_jax_and_no_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, dirs, names in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        dirs[:] = [x for x in dirs if x != "_build"]   # build outputs
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            assert not _FORBIDDEN.search(f.read()), path


def test_port_import_leaves_jax_out_of_sys_modules():
    """In a fresh interpreter (tests/conftest.py imports mxnet_tpu into
    this one): importing the port pulls in neither jax nor mxnet_tpu."""
    code = ("import sys, mxnet_tpu_torch.serving, mxnet_tpu_torch.models, "
            "mxnet_tpu_torch.ops._cuda, mxnet_tpu_torch.ops.flash_attention, "
            "chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'mxnet_tpu'))\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_engine_fault_fails_the_batch_not_the_loop(lm, monkeypatch):
    """A decode exception re-queues the batch as failover replays (the
    reference's decode-fault recovery); a fault that outlasts the
    request's `max_failovers` hops fails it, one engine failure counted
    per faulted step, and the loop keeps serving the next request."""
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=2, block_size=8,
                        paged=True, prefill_chunk=8, device="cpu")
    try:
        real = srv.engine.decode_step
        calls = []

        def flaky(seqs):
            calls.append(len(seqs))
            if len(calls) <= srv.max_failovers + 1:
                raise RuntimeError("injected decode fault")
            return real(seqs)

        monkeypatch.setattr(srv.engine, "decode_step", flaky)
        victim = srv.submit(PROMPTS[0], max_new_tokens=4)
        with pytest.raises(MXNetError, match="injected decode fault"):
            victim.result(timeout=120)
        assert len(srv.generate(PROMPTS[1], max_new_tokens=4,
                                timeout=120)) == 4
        snap = srv.snapshot()["requests"]
        assert snap["engine_failures"] == srv.max_failovers + 1
        assert snap["failovers"] == srv.max_failovers
        assert (snap["failed"], snap["completed"]) == (1, 1)
        assert srv.engine.cache.pool.in_use == 0
    finally:
        srv.close()


def test_request_spans_share_its_trace(lm):
    """submit, prefill chunks and decode steps of one request land in the
    span ring under the request's trace id."""
    from mxnet_tpu_torch import telemetry
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=1, block_size=8,
                        paged=True, prefill_chunk=8, device="cpu")
    try:
        req = srv.submit(PROMPTS[0], max_new_tokens=3)
        req.result(timeout=120)
    finally:
        srv.close()
    names = [s["name"] for s in telemetry.spans(trace=req.trace)]
    assert names[0] == "serving.submit"
    assert names.count("serving.prefill") == 2      # 9 tokens, chunk 8
    assert names.count("serving.decode") == 2       # tokens 2 and 3


def test_scheduler_token_budget_bounds_admission():
    """The reference's scheduler unit test, on the port's Scheduler:
    admission stops once the decode batch plus pending prefill chunks
    would exceed the budget, FIFO order kept; an idle scheduler always
    admits its head (progress)."""

    class FakeEngine:
        def can_admit(self, plen, max_new):
            return True

        def prefill_tokens_per_step(self, plen):
            return 8

        def decode_tokens_per_step(self):
            return 1

    sched = serving.Scheduler(max_batch=8, token_budget=16)
    reqs = [serving.Request([1, 2, 3]) for _ in range(4)]
    for r in reqs:
        sched.submit(r)
    sched.running = [object(), object()]     # 2 decode tokens committed
    admitted, expired = sched.admit(FakeEngine())
    assert not expired
    assert [r.id for r in admitted] == [reqs[0].id]  # 2+8=10; +8 > 16
    assert sched.pending() == 3
    sched2 = serving.Scheduler(max_batch=8, token_budget=4)
    r = serving.Request([1, 2, 3])
    sched2.submit(r)
    admitted, _ = sched2.admit(FakeEngine())
    assert [a.id for a in admitted] == [r.id]
