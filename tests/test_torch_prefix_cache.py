"""Port parity for the prefix cache (mxnet_tpu_torch/serving/
prefix_cache.py and the Engine's cached admission) against the JAX
reference, on the CPU.

Tolerances:
- the host logic (chain hashes, lookup, insert, reclaim, evict): the same
  script on the port's and the reference's cache gives identical ids,
  hashes and counters;
- prefix-on against prefix-off over the float32 pool: identical tokens
  and logits at rtol 1e-4 / atol 1e-5 (a hit reuses the very K/V a fresh
  prefill would write);
- over the int8 pool (the reference's test_prefix_cache_cow_keeps_shared_
  scales): identical tokens, logits within the reference's int8-KV
  budget of 0.01 of the float engine, shared blocks' scales bit-for-bit
  unchanged by the COW writer.
"""
import numpy as np
import pytest
import torch

import jax

from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.serving import kv_cache as jkv
from mxnet_tpu.serving import prefix_cache as jpc
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
from mxnet_tpu_torch.serving import kv_cache
from mxnet_tpu_torch.serving.prefix_cache import PrefixCache

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TINY = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64)
KV_LOGIT_BUDGET = 0.01


@pytest.fixture(scope="module")
def lm():
    jcfg = jtf.TransformerConfig(**_TINY)
    jparams = jtf.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    cfg = TransformerConfig(**_TINY)
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jparams.items()}, cfg, "cpu")
    return params, cfg


def arith_prompt(start, stride, n, vocab=48):
    return [(start + stride * t) % vocab for t in range(n)]


def make_engine(params, cfg, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("keep_logits", True)
    kw.setdefault("paged", True)
    return serving.Engine(serving.TransformerLM(dict(params), cfg),
                          device="cpu", **kw)


def rollout(eng, prompt, max_new=6):
    seq = eng.start(list(prompt), max_new)
    while not seq.done:
        eng.decode_step([seq])
    out = list(seq.tokens), [np.asarray(r) for r in seq.token_logits]
    eng.release(seq)
    return out


def assert_rollouts_equal(got, want):
    assert got[0] == want[0]
    for a, b in zip(got[1], want[1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# host logic against the reference, script for script
# ---------------------------------------------------------------------------


def test_chain_hashes_match_jax():
    toks = arith_prompt(3, 5, 37)
    for bs in (4, 8):
        mine = PrefixCache(kv_cache.BlockPool(4), bs)
        theirs = jpc.PrefixCache(jkv.BlockPool(4), bs)
        assert mine.chain_hashes(toks) == theirs.chain_hashes(toks)
        assert len(mine.chain_hashes(toks)) == 37 // bs
    a = PrefixCache(kv_cache.BlockPool(4), 8)
    b = PrefixCache(kv_cache.BlockPool(4), 4)
    assert not set(a.chain_hashes(toks)) & set(b.chain_hashes(toks))
    other = toks[:8] + [0] + toks[9:]
    assert a.chain_hashes(other)[0] == a.chain_hashes(toks)[0]
    assert a.chain_hashes(other)[1:] != a.chain_hashes(toks)[1:]


def _script(pool_cls, cache_cls):
    """Insert, look up (full and partial-tail hits, misses), release and
    evict under pressure; returns everything observable."""
    pool = pool_cls(12)
    cache = cache_cls(pool, 4)
    log = []
    p1 = arith_prompt(1, 1, 10)
    p2 = arith_prompt(9, 2, 9)
    ids1 = pool.try_alloc(3)
    cache.insert(p1, ids1, 10, partial_ok=True)
    pool.free(ids1)
    ids2 = pool.try_alloc(3)
    cache.insert(p2, ids2, 8)
    log.append(("after inserts", len(cache), pool.in_use,
                cache.resident_tokens))
    for probe in (p1 + [0], p1[:6] + [47, 46], p2[:9], [5, 5, 5, 5, 5],
                  p1[:9] + [3]):
        full, tail = cache.lookup(probe)
        log.append(("lookup", full, tail))
        pool.free(full + ([tail[0]] if tail else []))
    pool.free(ids2)
    log.append(("reclaimable", cache.reclaimable_blocks()))
    got = pool.try_alloc(pool.available + 2)          # evicts 2, LRU
    log.append(("pressure", got, cache.evictions, len(cache)))
    pool.free(got)
    log.append(("flush", cache.flush(), len(cache), pool.in_use))
    log.append(("stats", cache.lookups, cache.hits, cache.misses,
                cache.hit_tokens_total, cache.inserts, cache.hit_rate))
    return log


def test_lookup_insert_reclaim_evict_match_jax():
    assert _script(kv_cache.BlockPool, PrefixCache) == \
        _script(jkv.BlockPool, jpc.PrefixCache)


def test_lru_eviction_keeps_the_recently_used_chain():
    pool = kv_cache.BlockPool(10)
    cache = PrefixCache(pool, 4)
    p1, p2 = arith_prompt(1, 1, 8), arith_prompt(9, 2, 8)
    for p in (p1, p2):
        ids = pool.try_alloc(2)
        cache.insert(p, ids, 8)
        pool.free(ids)
    full, _ = cache.lookup(p1 + [0])                  # touch P1
    pool.free(full)
    got = pool.try_alloc(7)
    assert got is not None and cache.evictions == 2
    resident = {h.hex() for h in cache._by_hash}
    assert cache.chain_hashes(p1)[-1] in resident
    assert not set(cache.chain_hashes(p2)) & resident
    pinned, _ = cache.lookup(p1 + [0])
    rest = pool.try_alloc(pool.available)
    assert pool.try_alloc(1) is None          # P1 pinned: nothing to evict
    pool.free(pinned + rest + got)


# ---------------------------------------------------------------------------
# the engine: hits, COW, parity, admission, audit
# ---------------------------------------------------------------------------


def test_prefix_hit_skips_prefill_and_pins_shared_blocks(lm):
    params, cfg = lm
    eng = make_engine(params, cfg, prefix_cache=True, prefill_chunk=8)
    pc = eng.prefix_cache
    prompt = arith_prompt(3, 1, 24)
    rollout(eng, prompt)
    assert pc.lookups == 1 and pc.misses == 1 and pc.inserts >= 3
    seq = eng.begin(list(prompt), max_new=4)
    assert seq.cache_hit_tokens > 0 and seq.prefilled == seq.cache_hit_tokens
    assert seq.shared_blocks >= 2
    shared = seq.block_ids[:seq.shared_blocks]
    assert all(eng.cache.pool.refcount(b) == 2 for b in shared)
    chunks = 0
    while not eng.prefill_step(seq):
        chunks += 1
    assert chunks == 0                        # one chunk finished it
    eng.release(seq)
    assert all(eng.cache.pool.refcount(b) == 1 for b in shared)
    eng.audit_quiescent()
    eng.prefix_cache.flush()
    assert eng.cache.pool.in_use == 0


def test_prefix_on_equals_prefix_off_with_cow(lm):
    """A request that diverges inside a cached block COW-copies it; the
    donor blocks' bytes are untouched and every request's tokens and
    logits equal a cache-off engine's."""
    params, cfg = lm
    eng = make_engine(params, cfg, prefix_cache=True)
    pc = eng.prefix_cache
    base = arith_prompt(3, 1, 20)
    rollout(eng, base + [7, 9])
    donors = sorted(e.block_id for e in pc._by_hash.values())
    before = eng.cache.k[:, donors].clone()
    got = [rollout(eng, base + [7, 11]), rollout(eng, base[:19])]
    assert pc.cow_copies == 2 and pc.hits == 2
    assert torch.equal(eng.cache.k[:, donors], before)
    off = make_engine(params, cfg)
    for prompt, g in zip((base + [7, 11], base[:19]), got):
        assert_rollouts_equal(g, rollout(off, prompt))
    eng.audit_quiescent()


def test_int8_cow_keeps_shared_scales(lm):
    """The reference's test_prefix_cache_cow_keeps_shared_scales."""
    params, cfg = lm
    prompt = [int(t) for t in np.random.RandomState(0).randint(1, 48, 20)]
    eng = make_engine(params, cfg, block_size=16, max_batch=2,
                      prefix_cache=True, kv_quant=True)
    rollout(eng, prompt, max_new=8)
    shared_scale = eng.cache.k_scale.clone()
    p2 = prompt[:18] + [7, 9]
    s2 = eng.start(p2, 8)
    assert s2.cache_hit_tokens > 0 and eng.prefix_cache.cow_copies >= 1
    while not s2.done:
        eng.decode_step([s2])
    t2 = list(s2.tokens)
    l2 = [np.asarray(x) for x in s2.token_logits]
    resident = sorted(e.block_id
                      for e in eng.prefix_cache._by_hash.values())
    assert resident
    assert torch.equal(eng.cache.k_scale[:, resident],
                       shared_scale[:, resident])
    eng.release(s2)
    eng.audit_quiescent()
    t0, l0 = rollout(make_engine(params, cfg, block_size=16, max_batch=2),
                     p2, max_new=8)
    assert t2 == t0
    assert max(float(np.abs(a - b).max()) for a, b in zip(l0, l2)) \
        < KV_LOGIT_BUDGET


def test_admission_reclaims_cache_held_blocks(lm):
    """A cache that has absorbed the free list is capacity: can_admit
    counts reclaimable blocks and begin() evicts LRU to make room."""
    params, cfg = lm
    eng = make_engine(params, cfg, prefix_cache=True, num_blocks=9,
                      max_batch=1)
    for i in range(3):
        rollout(eng, arith_prompt(1 + 7 * i, 1, 17), max_new=4)
    pool = eng.cache.pool
    assert pool.available < 3
    assert eng.can_admit(17, 4)
    seq = eng.begin(arith_prompt(40, 3, 17), 4)
    assert seq is not None and eng.prefix_cache.evictions > 0
    eng.release(seq, reusable=False)
    eng.audit_quiescent()


def test_audit_names_a_leaked_block(lm):
    params, cfg = lm
    eng = make_engine(params, cfg, prefix_cache=True)
    rollout(eng, arith_prompt(5, 1, 12))
    eng.audit_quiescent()
    stray = eng.cache.pool.try_alloc(1)
    with pytest.raises(MXNetError, match="leaked"):
        eng.audit_quiescent()
    eng.cache.pool.free(stray)


def test_prefix_cache_env_gating_and_fallback(lm, monkeypatch):
    params, cfg = lm
    monkeypatch.setenv("MXNET_PREFIX_CACHE", "1")
    assert make_engine(params, cfg).prefix_cache is not None
    eng = make_engine(params, cfg, paged=False)
    assert eng.prefix_cache is None and "paged" in eng.prefix_cache_fallback
    monkeypatch.setenv("MXNET_PREFIX_CACHE", "0")
    assert make_engine(params, cfg).prefix_cache is None
    assert make_engine(params, cfg, prefix_cache=True).prefix_cache \
        is not None


def test_server_prefix_metrics(lm):
    params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=2, block_size=8,
                        paged=True, prefix_cache=True, device="cpu")
    base = arith_prompt(3, 1, 20)
    try:
        outs = [srv.generate(base + [i], max_new_tokens=4, timeout=120)
                for i in range(3)]
        snap = srv.snapshot()
    finally:
        srv.close()
    assert all(len(o) == 4 for o in outs)
    pre = snap["cache"]["prefix"]
    assert pre["lookups"] == 3 and pre["hits"] == 2 and pre["misses"] == 1
    assert pre["hit_tokens"] >= 2 * 16 and pre["cow_copies"] == 2
    assert pre["resident_blocks"] > 0 and pre["hit_rate"] == \
        pytest.approx(2 / 3)
    assert snap["engine"]["prefix_cache"] is True
    # 21 tokens at chunk 16: two chunks cold, one after a 20-token hit
    assert snap["paths"]["prefill_chunks"] == 2 + 1 + 1
