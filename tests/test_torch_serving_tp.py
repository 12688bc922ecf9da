"""Port parity for tensor-parallel serving (mxnet_tpu_torch/serving/tp.py,
the engine's tp construction) against the JAX reference, on the CPU.

Mirrors tests/test_serving_tp.py's eight tests: the port's window is
`devices=["cpu"] * k` (one process drives every shard), the reference's
its 8 virtual CPU devices. The tp engines' logits are held to the
reference's tp engine AND to the port's own tp=1 paged and gather
engines at every prefill and decode step, f32 rtol 1e-4 / atol 1e-5 with
identical greedy tokens, bf16 at 2e-2 (the reference's tolerances). The
int8 engine (int8 weights over an int8 pool) is held to the reference's
int8 tp engine at the same f32 tolerance, which pins the per-shard
scales: a row-parallel shard quantizes its own rows. Also the fallback
reasons (equal strings), the head-sharded pools (k contiguous tensors),
frozen flags, a served tp engine and the tp=1 -> tp=2 migration hop.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import serving as jserving
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import TransformerConfig
from mxnet_tpu_torch.serving import tp as ttp

from test_torch_serving import lm, _TINY  # noqa: F401 (fixture)
from test_torch_router import TIMEOUT, arith_prompt
from test_torch_disagg import disagg, oracle

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
QUANT = dict(kv_quant=True, weight_quant="int8", block_size=32)


def cpus(k):
    return ["cpu"] * k


def port_engine(params, cfg, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("keep_logits", True)
    kw.setdefault("device", "cpu")
    return serving.Engine(serving.TransformerLM(dict(params), cfg), **kw)


def ref_engine(jparams, jcfg, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("keep_logits", True)
    return jserving.Engine(jserving.TransformerLM(dict(jparams), jcfg), **kw)


def rollout_logits(eng, steps=5):
    """Two mixed-length sequences, per-step logits (the reference test's
    `rollout_logits`)."""
    s1 = eng.start(arith_prompt(1, 1, 9), max_new=steps + 1)
    s2 = eng.start(arith_prompt(5, 2, 4), max_new=steps + 1)
    logs = [[np.asarray(s1.last_logits, np.float32),
             np.asarray(s2.last_logits, np.float32)]]
    for _ in range(steps):
        eng.decode_step([s1, s2])
        logs.append([np.asarray(s1.last_logits, np.float32),
                     np.asarray(s2.last_logits, np.float32)])
    toks = (list(s1.tokens), list(s2.tokens))
    for s in (s1, s2):
        eng.release(s)
    return logs, toks


def assert_logits(got, want, tol):
    for step, (a, b) in enumerate(zip(got, want)):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x, y, err_msg="step %d" % step, **tol)


@pytest.fixture(scope="module")
def ref_runs(lm):
    """The reference's tp engines (f32 tp=2 and tp=4, bf16 tp=2, int8
    tp=2) over its virtual devices, once per module."""
    jparams, jcfg, _, _ = lm
    bf16 = {k: v.astype(jnp.bfloat16) for k, v in jparams.items()}
    out = {}
    for key, params, kw, steps in (
            ("f32-2", jparams, dict(tp=2), 5),
            ("f32-4", jparams, dict(tp=4), 5),
            ("bf16-2", bf16, dict(tp=2), 3),
            ("int8-2", jparams, dict(tp=2, **QUANT), 5)):
        eng = ref_engine(params, jcfg, paged=True, **kw)
        assert eng.tp == kw["tp"], eng.tp_fallback
        out[key] = rollout_logits(eng, steps)
    return out


# ---------------------------------------------------------------------------
# parity: tp == the reference's tp == tp=1 paged == gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_decode_parity_three_way(lm, ref_runs, tp):
    _, _, params, cfg = lm
    e_tp = port_engine(params, cfg, paged=True, tp=tp, devices=cpus(tp))
    assert e_tp.tp == tp and e_tp.paged, e_tp.tp_fallback
    log_t, tok_t = rollout_logits(e_tp)
    log_p, tok_p = rollout_logits(port_engine(params, cfg, paged=True))
    log_g, tok_g = rollout_logits(port_engine(params, cfg, paged=False))
    log_r, tok_r = ref_runs["f32-%d" % tp]
    for ref in (log_r, log_p, log_g):
        assert_logits(log_t, ref, F32)
    assert tok_t == tok_p == tok_g == tok_r


def test_tp_decode_parity_bf16(lm, ref_runs):
    _, _, params, cfg = lm
    bf16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
    e_tp = port_engine(bf16, cfg, paged=True, tp=2, devices=cpus(2))
    assert e_tp.tp == 2, e_tp.tp_fallback
    assert e_tp.cache.k[0].dtype == torch.bfloat16
    log_t, _ = rollout_logits(e_tp, steps=3)
    log_p, _ = rollout_logits(port_engine(bf16, cfg, paged=True), steps=3)
    assert_logits(log_t, log_p, BF16)
    # the reference's bf16 rounds elsewhere, and at this tiny width its
    # first decode step meets a near-tie whose greedy pick differs from
    # the port's single-device engine's as well; the prefill logits
    # precede any pick
    assert_logits(log_t[:1], ref_runs["bf16-2"][0][:1], BF16)


def test_tp_int8_matches_reference_tp_engine(lm, ref_runs):
    """int8 weights quantized AFTER sharding (each shard its own scales)
    over an int8 pool whose (L, NB, H/k) scales shard with the heads."""
    _, _, params, cfg = lm
    eng = port_engine(params, cfg, paged=True, tp=2, devices=cpus(2),
                      **QUANT)
    assert eng.tp == 2 and eng.kv_quant and eng.weight_quant == "int8"
    for ks in eng.cache.k_scale:
        assert tuple(ks.shape) == (cfg.n_layers, eng.cache.num_blocks,
                                   cfg.n_heads // 2)
    # a row-parallel shard's scales are its own rows', not the whole
    # weight's: whole-weight scales would be the elementwise max of them
    w = eng.model.params_f32["layer0_wo"]
    whole = torch.maximum(w.abs().amax(0), torch.tensor(1e-12)) / 127.0
    shard_s = [sh["layer0_wo"]["s"] for sh in eng.model.tp_params]
    assert not all(torch.equal(s, whole) for s in shard_s)
    torch.testing.assert_close(torch.maximum(*shard_s), whole)
    log_t, tok_t = rollout_logits(eng)
    log_r, tok_r = ref_runs["int8-2"]
    assert_logits(log_t, log_r, F32)
    assert tok_t == tok_r


def test_tp_spec_prefix_and_int8_pool_match_tp1(lm):
    """Speculative scoring, the prefix cache's copy-on-write and the int8
    pool's scale resets each run per shard: a tp=2 engine with all three
    gives the tp=1 engine's greedy tokens on prompts that share a
    prefix diverging mid-block."""
    _, _, params, cfg = lm
    base = arith_prompt(5, 1, 20)
    prompts = [base + [7, 9, 11], base + [8, 10, 12], base[:13]]
    kw = dict(paged=True, kv_quant=True, prefix_cache=True, spec_k=2,
              draft=serving.self_draft(params, cfg, 1), block_size=8)

    def run(eng):
        out = []
        for p in prompts:
            seq = eng.start(list(p), max_new=6)
            while not seq.done:
                eng.decode_step([seq])
            out.append(list(seq.generated))
            eng.release(seq)
        return out, eng.prefix_cache.cow_copies, eng.spec_passes

    one = run(port_engine(params, cfg, **kw))
    two = run(port_engine(params, cfg, tp=2, devices=cpus(2), **kw))
    assert two == one and one[1] > 0 and one[2] > 0


def test_tp_pool_sharded_over_heads(lm):
    """The pool is k separate contiguous (L, NB, bs, H/k, Dh) tensors, one
    per window device; block tables stay host-side ints."""
    _, _, params, cfg = lm
    eng = port_engine(params, cfg, paged=True, tp=2, devices=cpus(2))
    assert eng.tp == 2, eng.tp_fallback
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    for plane in (eng.cache.k, eng.cache.v):
        assert len(plane) == 2
        for t in plane:
            assert tuple(t.shape) == (cfg.n_layers, eng.cache.num_blocks, 8,
                                      H // 2, Dh)
            assert t.is_contiguous() and t.device.type == "cpu"
    assert eng.cache.k[0].data_ptr() != eng.cache.k[1].data_ptr()
    total = cfg.n_layers * eng.cache.num_blocks * 8 * H * Dh
    assert sum(t.numel() for t in eng.cache.k) == total
    assert ttp.tp_cache_variant(eng.mesh) == "tp2@cpu,cpu"
    assert ttp.tp_cache_variant([torch.device("cuda", 0)] * 2) == "tp2@0,0"


# ---------------------------------------------------------------------------
# the signature lattice: tp does not widen it
# ---------------------------------------------------------------------------


def test_tp_recompile_bound_mixed_lengths(lm):
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=4, block_size=8,
                        paged=True, tp=2, devices=cpus(2), device="cpu")
    try:
        assert srv.engine.tp == 2, srv.engine.tp_fallback
        results = {}

        def client(i, delay, plen):
            time.sleep(delay)
            results[i] = srv.generate(arith_prompt(i, 1, plen),
                                      max_new_tokens=10, timeout=TIMEOUT)

        threads = [threading.Thread(target=client, args=(i, 0.05 * i, p))
                   for i, p in enumerate((5, 9, 17))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert all(len(results[i]) == 10 for i in range(3))
        eng = srv.engine
        assert eng.prefill_compilations <= 2, sorted(eng._sigs)
        assert eng.decode_compilations <= 6, sorted(eng._sigs)
    finally:
        srv.close(timeout=TIMEOUT)


# ---------------------------------------------------------------------------
# fallback: placement changes, logits never do
# ---------------------------------------------------------------------------


def test_tp_fallback_reasons(lm):
    jparams, jcfg, params, cfg = lm
    wide = dict(_TINY, n_heads=16, d_model=64)
    moe = dict(_TINY, n_experts=2, d_ff=32)
    cases = [(None, dict(paged=True, tp=3)),
             (wide, dict(paged=True, tp=16)),
             (None, dict(paged=False, tp=2)),
             (moe, dict(paged=True, tp=2))]
    for shape, kw in cases:
        if shape is None:
            jp, jc, tp_, tc = jparams, jcfg, params, cfg
        else:
            jc = jtf.TransformerConfig(**shape)
            jp = jtf.init_transformer_params(jax.random.PRNGKey(0), jc)
            tc = TransformerConfig(**shape)
            tp_ = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
        e_ref = ref_engine(jp, jc, **kw)
        e = port_engine(tp_, tc, devices=cpus(8), **kw)
        assert e.tp == e_ref.tp == 1
        assert e.tp_fallback == e_ref.tp_fallback, (kw, e.tp_fallback)
        assert e.paged == e_ref.paged
    # without a window the default is every CUDA device: none here
    e = port_engine(params, cfg, tp=2)
    assert e.tp == 1 and e.tp_fallback == "tp=2 needs 2 devices, have 0"
    with pytest.raises(MXNetError):
        port_engine(params, cfg, tp=0)
    # the fallback engine still serves the same tokens
    e = port_engine(params, cfg, paged=True, tp=3, devices=cpus(3))
    seq = e.start(arith_prompt(2, 1, 6), max_new=3)
    while not seq.done:
        e.decode_step([seq])
    e.release(seq)
    assert len(seq.generated) == 3


def test_tp_env_var_read_at_construction(lm, monkeypatch):
    _, _, params, cfg = lm
    monkeypatch.setenv("MXNET_SERVING_TP", "2")
    e = port_engine(params, cfg, devices=cpus(2))
    assert e.tp_requested == 2 and e.tp == 2 and e.paged
    e = port_engine(params, cfg, tp=1, devices=cpus(2))
    assert e.tp == 1 and e.tp_fallback is None
    monkeypatch.delenv("MXNET_SERVING_TP")
    e = port_engine(params, cfg, devices=cpus(2))
    assert e.tp == 1
    # the window's first device is the engine's; another one raises
    with pytest.raises(MXNetError, match="first device"):
        port_engine(params, cfg, tp=2, devices=["meta", "meta"])


def test_engine_flags_frozen_after_construction(lm):
    _, _, params, cfg = lm
    eng = port_engine(params, cfg, paged=True, tp=2, devices=cpus(2))
    for flag, val in (("paged", False), ("paged_requested", False),
                      ("tp", 1), ("tp_requested", 4),
                      ("prefill_chunk", 32), ("mesh", None)):
        with pytest.raises(MXNetError, match="fixed at construction"):
            setattr(eng, flag, val)
    eng.keep_logits = False
    assert eng.tp == 2 and eng.paged


# ---------------------------------------------------------------------------
# end to end: the serving loop over a tp engine, and the tp != tp hop
# ---------------------------------------------------------------------------


def test_tp_serve_end_to_end(lm):
    jparams, jcfg, params, cfg = lm
    prompt = arith_prompt(3, 1, 7)
    srv = serving.serve((params, cfg), max_batch=2, block_size=8, tp=2,
                        devices=cpus(2), device="cpu")
    try:
        assert srv.engine.tp == 2, srv.engine.tp_fallback
        out = srv.generate(prompt, max_new_tokens=4, timeout=TIMEOUT)
        snap = srv.snapshot()
        assert snap["paths"]["paged_decode_steps"] >= 3
        assert snap["requests"]["completed"] == 1
    finally:
        srv.close(timeout=TIMEOUT)
    ref = jserving.serve((jparams, jcfg), max_batch=2, block_size=8, tp=2)
    try:
        assert ref.engine.tp == 2
        assert ref.generate(prompt, max_new_tokens=4, timeout=TIMEOUT) == out
    finally:
        ref.close()


def test_tp_mismatched_migration_hop(lm):
    """A tp=1 prefill replica hands the prompt to a tp=2 decode replica;
    the hop re-prefills on the tp engine and the tokens equal one
    server's."""
    prompt, max_new = arith_prompt(3, 2, 10), 6
    want = oracle(lm, prompt, max_new)
    fleet = disagg("port", lm, paged=True,
                   role_kwargs={"decode": {"tp": 2, "devices": cpus(2)}})
    try:
        pre, dec = fleet.replicas
        assert pre.engine.tp == 1
        assert dec.engine.tp == 2, dec.engine.tp_fallback
        got = fleet.generate(list(prompt), max_new_tokens=max_new,
                             timeout=TIMEOUT)
        assert got == want
        assert dec.metrics.migrations == 1
    finally:
        fleet.close(timeout=TIMEOUT)
