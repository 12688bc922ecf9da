"""Port parity for the paged KV-cache (mxnet_tpu_torch/serving/
kv_cache.py) against the JAX reference (mxnet_tpu/serving/kv_cache.py):
the host free-list's invariants, and the slot / write / gather ops on the
same numpy inputs through both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.serving import kv_cache as ref
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.serving import kv_cache


def test_block_pool_alloc_free_reuse():
    pool = kv_cache.BlockPool(8)            # ids 1..7 allocatable
    assert pool.available == 7 and pool.in_use == 0
    a = pool.try_alloc(3)
    b = pool.try_alloc(2)
    assert len(set(a) | set(b)) == 5        # all distinct
    assert 0 not in a + b                   # null block never handed out
    assert pool.in_use == 5 and pool.available == 2
    assert pool.high_water == 5
    # transient exhaustion -> None (backpressure), not an exception
    assert pool.try_alloc(3) is None
    pool.free(a)
    assert pool.available == 5
    c = pool.try_alloc(3)
    assert set(c) <= set(a)                 # freed blocks are reused
    pool.free(b)
    with pytest.raises(MXNetError):         # double free
        pool.free(b)
    with pytest.raises(MXNetError):         # the null block is foreign
        pool.free([0])
    with pytest.raises(kv_cache.CacheOverflow):
        pool.try_alloc(8)                   # more than the pool ever has
    with pytest.raises(MXNetError):
        kv_cache.BlockPool(1)               # only the null block
    pool.free(c)
    pool.assert_quiescent()


def test_block_pool_free_is_atomic_and_refcounted():
    pool = kv_cache.BlockPool(6)
    ids = pool.try_alloc(3)
    with pytest.raises(MXNetError, match="duplicate"):
        pool.free([ids[0], ids[0]])
    with pytest.raises(MXNetError, match="double-free"):
        pool.free([ids[1], 5])              # 5 is not live
    assert pool.in_use == 3                 # nothing was freed
    pool.add_ref([ids[0]])
    assert pool.refcount(ids[0]) == 2
    pool.free(ids)
    assert pool.in_use == 1 and pool.refcount(ids[0]) == 1
    with pytest.raises(MXNetError, match="leaked"):
        pool.assert_quiescent()
    pool.free([ids[0]])
    pool.assert_quiescent()
    with pytest.raises(MXNetError, match="not live"):
        pool.add_ref([ids[0]])


def test_block_pool_matches_reference_sequence():
    """Same alloc/free script, same ids handed out (LIFO reuse)."""
    mine, theirs = kv_cache.BlockPool(10), ref.BlockPool(10)
    script = [("a", 3), ("a", 2), ("f", 0), ("a", 4), ("f", 1), ("a", 1)]
    held_m, held_t = [], []
    for op, arg in script:
        if op == "a":
            held_m.append(mine.try_alloc(arg))
            held_t.append(theirs.try_alloc(arg))
        else:
            mine.free(held_m.pop(arg))
            theirs.free(held_t.pop(arg))
        assert held_m == held_t
        assert (mine.available, mine.in_use, mine.high_water) == \
            (theirs.available, theirs.in_use, theirs.high_water)


def test_paged_kv_cache_layout():
    c = kv_cache.PagedKVCache(3, 2, 8, block_size=4, num_blocks=9,
                              dtype=torch.bfloat16, device="cpu")
    assert c.k.shape == (3, 9, 4, 2, 8) and c.v.dtype == torch.bfloat16
    assert c.k.device.type == "cpu" and not c.k.any()
    r = ref.PagedKVCache(3, 2, 8, block_size=4, num_blocks=9)
    for n in range(1, 14):
        assert c.blocks_for(n) == r.blocks_for(n)
    np.testing.assert_array_equal(c.table_row([3, 5], 4),
                                  r.table_row([3, 5], 4))
    assert c.utilization() == 0.0


def _pools(rng, L=2, nb=7, bs=4, H=2, Dh=3):
    k = rng.randn(L, nb, bs, H, Dh).astype(np.float32)
    v = rng.randn(L, nb, bs, H, Dh).astype(np.float32)
    return k, v


def test_flat_and_prompt_slots_match_jax():
    tables = np.array([[3, 5, 0], [1, 2, 6]], np.int32)
    positions = np.array([9, 4], np.int32)
    want = np.asarray(ref.flat_slots(jnp.asarray(tables),
                                     jnp.asarray(positions), 4))
    got = kv_cache.flat_slots(torch.from_numpy(tables),
                              torch.from_numpy(positions), 4)
    np.testing.assert_array_equal(got.numpy(), want)
    row = np.array([3, 5, 0, 0], np.int32)
    want = np.asarray(ref.prompt_slots(jnp.asarray(row), 13, 4))
    got = kv_cache.prompt_slots(torch.from_numpy(row), 13, 4)
    np.testing.assert_array_equal(got.numpy(), want)


def test_write_kv_matches_jax_in_place():
    rng = np.random.RandomState(0)
    k, v = _pools(rng)
    slots = np.array([13, 2, 21, 27], np.int32)       # distinct slots
    kn = rng.randn(4, 2, 3).astype(np.float32)
    vn = rng.randn(4, 2, 3).astype(np.float32)
    wk, wv = ref.write_kv(jnp.asarray(k), jnp.asarray(v), 1,
                          jnp.asarray(slots), jnp.asarray(kn),
                          jnp.asarray(vn))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    ptr = tk.data_ptr()
    assert kv_cache.write_kv(tk, tv, 1, torch.from_numpy(slots),
                             torch.from_numpy(kn),
                             torch.from_numpy(vn)) is None
    assert tk.data_ptr() == ptr                       # written in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))


def test_gather_kv_matches_jax():
    rng = np.random.RandomState(1)
    k, v = _pools(rng)
    tables = np.array([[3, 5, 0], [1, 2, 6]], np.int32)
    wk, wv = ref.gather_kv(jnp.asarray(k), jnp.asarray(v), 1,
                           jnp.asarray(tables), 4)
    gk, gv = kv_cache.gather_kv(torch.from_numpy(k), torch.from_numpy(v),
                                1, torch.from_numpy(tables), 4)
    assert gk.shape == (2, 12, 2, 3)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


# ---------------------------------------------------------------------------
# the int8 pool: layout, the quantizing writer, COW and scale hygiene.
# Exact against the reference: both requantize in float32 with the same
# operations in the same order and round half to even. Block 0 (the null
# block) is excluded from pool comparisons: the reference may also
# rewrite it as a padding candidate, and nothing ever reads it.
# ---------------------------------------------------------------------------


def test_int8_pool_layout_matches_jax():
    c = kv_cache.PagedKVCache(2, 2, 8, block_size=4, num_blocks=6,
                              device="cpu", kv_dtype="int8")
    r = ref.PagedKVCache(2, 2, 8, block_size=4, num_blocks=6,
                         kv_dtype="int8")
    assert c.quantized and c.k.dtype == torch.int8
    assert tuple(c.k.shape) == r.k.shape
    assert tuple(c.k_scale.shape) == r.k_scale.shape == (2, 6, 2)
    assert c.k_scale.dtype == torch.float32 and not c.k_scale.any()
    with pytest.raises(MXNetError, match="int4"):
        kv_cache.PagedKVCache(1, 1, 8, device="cpu", kv_dtype="int4")


def _quant_state(rng, L=2, nb=6, bs=4, H=2, Dh=8):
    """A pool with some history: random int8 contents and scales."""
    k = rng.randint(-127, 128, (L, nb, bs, H, Dh)).astype(np.int8)
    v = rng.randint(-127, 128, (L, nb, bs, H, Dh)).astype(np.int8)
    ks = rng.uniform(0.0, 0.02, (L, nb, H)).astype(np.float32)
    vs = rng.uniform(0.0, 0.02, (L, nb, H)).astype(np.float32)
    ks[:, 3] = 0.0                     # a freshly zeroed block
    return k, v, ks, vs


def _assert_quant_equal(tk, tv, tks, tvs, want):
    wk, wv, wks, wvs = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(tk.numpy()[:, 1:], wk[:, 1:])
    np.testing.assert_array_equal(tv.numpy()[:, 1:], wv[:, 1:])
    np.testing.assert_array_equal(tks.numpy(), wks)
    np.testing.assert_array_equal(tvs.numpy(), wvs)


@pytest.mark.parametrize("slots,scale_up", [
    ([4, 5, 6, 7], 1.0),               # one whole block
    ([9, 14, 15, 16, 17], 0.3),        # straddles blocks 2, 3 and 4
    ([13, 12, 2, 1], 4.0),             # decode-like scatter + null block
    ([21, 22, 23], 0.001),             # small rows: scale stays put
])
def test_write_kv_quant_matches_jax(slots, scale_up):
    rng = np.random.RandomState(len(slots))
    k, v, ks, vs = _quant_state(rng)
    n = len(slots)
    kn = (scale_up * rng.randn(n, 2, 8)).astype(np.float32)
    vn = (scale_up * rng.randn(n, 2, 8)).astype(np.float32)
    want = ref.write_kv_quant(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(ks), jnp.asarray(vs), 1,
                              jnp.asarray(np.asarray(slots, np.int32)),
                              jnp.asarray(kn), jnp.asarray(vn))
    tk, tv, tks, tvs = (torch.from_numpy(a.copy()) for a in (k, v, ks, vs))
    ptr = tk.data_ptr()
    assert kv_cache.write_kv_quant(tk, tv, tks, tvs, 1,
                                   torch.tensor(slots),
                                   torch.from_numpy(kn),
                                   torch.from_numpy(vn)) is None
    assert tk.data_ptr() == ptr                       # written in place
    _assert_quant_equal(tk, tv, tks, tvs, want)
    np.testing.assert_array_equal(tk.numpy()[0], k[0])   # other layer


def test_write_kv_quant_scale_is_monotonic_and_rescales():
    """A larger row raises the block's scale and requantizes the rows
    already there; a smaller later row leaves the scale alone."""
    rng = np.random.RandomState(7)
    c = kv_cache.PagedKVCache(1, 2, 8, block_size=4, num_blocks=5,
                              device="cpu", kv_dtype="int8")
    small = torch.from_numpy(rng.randn(2, 2, 8).astype(np.float32))
    kv_cache.write_kv_quant(c.k, c.v, c.k_scale, c.v_scale, 0,
                            torch.tensor([4, 5]), small, small)
    s0 = c.k_scale[0, 1].clone()
    torch.testing.assert_close(s0, small.abs().amax(dim=(0, 2)) / 127.0)
    deq = c.k[0, 1, :2].float() * s0[None, :, None]
    assert float((deq - small).abs().max()) <= 0.51 * float(s0.max())
    big = 10.0 * small[:1]
    kv_cache.write_kv_quant(c.k, c.v, c.k_scale, c.v_scale, 0,
                            torch.tensor([6]), big, big)
    s1 = c.k_scale[0, 1].clone()
    assert bool((s1 >= s0).all()) and bool((s1 > s0).any())
    deq = c.k[0, 1, :2].float() * s1[None, :, None]   # requantized rows
    assert float((deq - small).abs().max()) <= 0.51 * float(s1.max()) \
        + 0.51 * float(s0.max())
    kv_cache.write_kv_quant(c.k, c.v, c.k_scale, c.v_scale, 0,
                            torch.tensor([7]), 0.01 * small[:1],
                            0.01 * small[:1])
    assert torch.equal(c.k_scale[0, 1], s1)


def test_copy_block_and_copy_block_quant_match_jax():
    rng = np.random.RandomState(3)
    k, v = _pools(rng)
    wk, wv = ref.copy_block(jnp.asarray(k), jnp.asarray(v), 2, 5)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    kv_cache.copy_block(tk, tv, 2, 5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
    qk, qv, ks, vs = _quant_state(rng)
    want = ref.copy_block_quant(jnp.asarray(qk), jnp.asarray(qv),
                                jnp.asarray(ks), jnp.asarray(vs), 1, 4)
    t = [torch.from_numpy(a.copy()) for a in (qk, qv, ks, vs)]
    kv_cache.copy_block_quant(*t, 1, 4)
    _assert_quant_equal(*t, want)


def test_zero_block_scales_on_a_reused_block():
    """The reference's scale-hygiene case: COW moves scales with the
    data; a reclaimed block is zeroed and requantizes at the new, small
    scale instead of inheriting the old occupant's; the source block is
    untouched; a null-block write leaves real blocks alone."""
    c = kv_cache.PagedKVCache(1, 2, 8, block_size=4, num_blocks=5,
                              device="cpu", kv_dtype="int8")
    big = torch.full((4, 2, 8), 100.0)
    kv_cache.write_kv_quant(c.k, c.v, c.k_scale, c.v_scale, 0,
                            torch.tensor([4, 5, 6, 7]), big, big)
    kv_cache.copy_block_quant(c.k, c.v, c.k_scale, c.v_scale, 1, 2)
    assert torch.equal(c.k[0, 2], c.k[0, 1])
    assert torch.equal(c.k_scale[0, 2], c.k_scale[0, 1])
    src_scale = c.k_scale[0, 1].clone()
    kv_cache.zero_block_scales(c.k_scale, c.v_scale, torch.tensor([2]))
    assert not c.k_scale[0, 2].any() and not c.v_scale[0, 2].any()
    small = torch.full((1, 2, 8), 0.01)
    kv_cache.write_kv_quant(c.k, c.v, c.k_scale, c.v_scale, 0,
                            torch.tensor([8]), small, small)
    assert torch.equal(c.k_scale[0, 1], src_scale)
    assert float(c.k_scale[0, 2, 0]) == pytest.approx(0.01 / 127.0)
    before = c.k[0, 1:].clone()
    kv_cache.write_kv_quant(c.k, c.v, c.k_scale, c.v_scale, 0,
                            torch.tensor([0]), big[:1], big[:1])
    assert torch.equal(c.k[0, 1:], before)
    js = ref.zero_block_scales(jnp.ones((1, 5, 2)), jnp.ones((1, 5, 2)),
                               jnp.asarray([2, 4], jnp.int32))
    ts = (torch.ones(1, 5, 2), torch.ones(1, 5, 2))
    kv_cache.zero_block_scales(*ts, torch.tensor([2, 4]))
    np.testing.assert_array_equal(ts[0].numpy(), np.asarray(js[0]))


def test_block_pool_reclaimer_and_resident_audit_match_jax():
    """The reclaimer runs on a shortfall before try_alloc gives up; the
    audit accepts cache residents held by one ref and names the rest."""
    got = {}
    for name, pool in (("port", kv_cache.BlockPool(5)),
                       ("jax", ref.BlockPool(5))):
        held = pool.try_alloc(4)              # the pool is now empty
        calls = []

        def reclaim(n, pool=pool, held=held, calls=calls):
            calls.append(n)
            pool.free(held[:n])
            return n

        pool.reclaimer = reclaim
        got[name] = (pool.try_alloc(2), calls, pool.available)
    assert got["port"] == got["jax"]
    assert got["port"][1] == [2] and got["port"][0] is not None
    a, b = kv_cache.BlockPool(6), ref.BlockPool(6)
    for pool in (a, b):
        ids = pool.try_alloc(3)
        pool.assert_quiescent(cache_resident=ids)
        pool.add_ref([ids[0]])
        with pytest.raises(Exception, match="leaked"):
            pool.assert_quiescent(cache_resident=ids)
        pool.free([ids[0]])
        with pytest.raises(Exception, match="dead blocks"):
            pool.assert_quiescent(cache_resident=ids + [5])
