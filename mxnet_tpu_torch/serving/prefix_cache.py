"""Prefix cache: content-addressed reuse of KV blocks (port of
`mxnet_tpu/serving/prefix_cache.py`, copied: the reference module is
host-only, but importing it would import jax through its package).

A map from token content to resident pool blocks. Identity is a CHAINED
content hash at block granularity: block i's key is
``H(key_{i-1} || tokens_i)``, so two prompts share block i's entry iff
they agree on every token up to and including block i. The chain seed
folds in the block size, so caches at different block sizes never alias.

Reuse semantics:

* **Full-block hits** are shared in place: the new request's block
  table points at the resident block and the pool refcount pins it. At
  most ``len(prompt) - 1`` tokens ever hit, so at least one prompt token
  runs through prefill (the request needs its last-token logits).
* **Partial-tail hits** (the request diverges mid-block, or its prompt
  ends inside a cached block) are served COPY-ON-WRITE: the engine copies
  the cached block into a fresh private one at admission
  (`kv_cache.copy_block`, or `copy_block_quant` with its scales on an
  int8 pool), since this request will write into it.
* **Insertion** happens when KV becomes immutable: full prompt blocks as
  soon as prefill completes, generated-token blocks and the final
  partial tail at release. Duplicate content dedupes onto the first
  resident copy.
* **Eviction** is LRU over entries no reader holds, leaves first. It
  runs from the block pool's allocation path: when ``try_alloc`` comes up
  short it asks this cache to reclaim the shortfall first, so cached
  prefixes are free capacity, never a leak.

Entries hold host-side block ids and token content only; all mutation
happens on the one serving thread that drives the engine.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np

from ..base import MXNetError


def prefix_cache_enabled():
    """MXNET_PREFIX_CACHE=1, read when an Engine is constructed;
    `Engine(prefix_cache=...)` overrides."""
    return os.environ.get("MXNET_PREFIX_CACHE", "0") == "1"


def _lcp(a, b):
    """Longest common prefix length of two token sequences."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class _Entry:
    """One resident cached block: its chain hash, parent hash, pool
    block id, and the exact tokens whose KV it holds (== block_size for
    full blocks, fewer for a partial tail)."""

    __slots__ = ("h", "prev", "block_id", "tokens", "last_use")

    def __init__(self, h, prev, block_id, tokens, last_use):
        self.h = h
        self.prev = prev
        self.block_id = block_id
        self.tokens = tokens
        self.last_use = last_use


class PrefixCache:
    """Content hash -> resident pool block, with refcounts and LRU
    eviction. Owns no device memory: blocks live in the `BlockPool` /
    `PagedKVCache` it is built over; the cache holds one pool ref per
    entry and the pool's `reclaimer` hook points back here."""

    def __init__(self, pool, block_size):
        if block_size < 1:
            raise MXNetError("prefix cache needs block_size >= 1")
        self.pool = pool
        self.block_size = block_size
        self._root = hashlib.sha256(
            b"mxtpu-prefix-cache/v1/bs=%d" % block_size).digest()
        self._by_hash = {}            # hash -> _Entry
        self._by_prev = {}            # parent hash -> set of child hashes
        self._clock = 0               # monotonic LRU tick (no wall clock)
        # monotonic stats (ServingMetrics syncs counters from these)
        self.lookups = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens_total = 0
        self.inserts = 0
        self.evictions = 0
        self.cow_copies = 0
        self.resident_tokens = 0
        pool.reclaimer = self.reclaim

    def __len__(self):
        return len(self._by_hash)

    @property
    def hit_rate(self):
        return self.hits / self.lookups if self.lookups else 0.0

    # -- hashing -------------------------------------------------------------

    def _hash(self, prev, tokens):
        m = hashlib.sha256(prev)
        m.update(np.asarray(tokens, np.int64).tobytes())
        return m.digest()

    def chain_hashes(self, tokens):
        """Hex chain keys of `tokens`' full blocks — the content
        identity tests pin (stable across instances, prefix-consistent,
        block-size-disjoint)."""
        out, prev = [], self._root
        bs = self.block_size
        for i in range(len(tokens) // bs):
            prev = self._hash(prev, tuple(tokens[i * bs:(i + 1) * bs]))
            out.append(prev.hex())
        return out

    # -- lookup --------------------------------------------------------------

    def _touch(self, entry):
        self._clock += 1
        entry.last_use = self._clock

    def lookup(self, prompt):
        """Longest reusable prefix of `prompt`: a run of full-block hits
        plus at most one partially-matched tail block, capped at
        ``len(prompt) - 1`` tokens. Returns ``(full_ids, tail)`` where
        `full_ids` are shared block ids in table order and `tail` is
        ``(block_id, n_tokens)`` or None; a pool ref is ALREADY taken on
        every returned id (drop with ``pool.free`` on abort)."""
        bs = self.block_size
        self.lookups += 1
        max_use = len(prompt) - 1
        prev, full, used = self._root, [], 0
        while used + bs <= max_use:
            h = self._hash(prev, tuple(prompt[used:used + bs]))
            e = self._by_hash.get(h)
            if e is None:
                break
            self._touch(e)
            full.append(e.block_id)
            prev = h
            used += bs
        tail = None
        rem = list(prompt[used:max_use])
        if rem:
            best, best_m = None, 0
            for h in self._by_prev.get(prev, ()):
                e = self._by_hash[h]
                m = _lcp(e.tokens, rem)
                if m > best_m:
                    best, best_m = e, m
            if best is not None:
                self._touch(best)
                tail = (best.block_id, best_m)
        if full or tail:
            self.hits += 1
            self.hit_tokens_total += used + (tail[1] if tail else 0)
            self.pool.add_ref(full + ([tail[0]] if tail else []))
        else:
            self.misses += 1
        return full, tail

    # -- insertion -----------------------------------------------------------

    def _add(self, h, prev, tokens, block_id):
        self.pool.add_ref([block_id])
        self._clock += 1
        e = _Entry(h, prev, block_id, tuple(tokens), self._clock)
        self._by_hash[h] = e
        self._by_prev.setdefault(prev, set()).add(h)
        self.inserts += 1
        self.resident_tokens += len(e.tokens)
        return e

    def insert(self, tokens, block_ids, n_valid, partial_ok=False):
        """Register ``tokens[:n_valid]`` — whose KV lives in
        `block_ids` (table order) — as reusable content. Full blocks
        always; the trailing partial block only with `partial_ok=True`
        (the caller guarantees its owner will never write it again).
        Content already resident dedupes onto the first copy (no extra
        ref is taken on the caller's duplicate block)."""
        bs = self.block_size
        prev, j = self._root, 0
        while (j + 1) * bs <= n_valid and j < len(block_ids):
            blk = tuple(tokens[j * bs:(j + 1) * bs])
            h = self._hash(prev, blk)
            e = self._by_hash.get(h)
            if e is None:
                self._add(h, prev, blk, block_ids[j])
            else:
                self._touch(e)
            prev = h
            j += 1
        if not partial_ok:
            return
        rem = tuple(tokens[j * bs:n_valid])
        if not rem or j >= len(block_ids):
            return
        for h in self._by_prev.get(prev, ()):
            if self._by_hash[h].tokens == rem:
                self._touch(self._by_hash[h])
                return
        self._add(self._hash(prev, rem), prev, rem, block_ids[j])

    # -- eviction ------------------------------------------------------------

    def _evictable(self, entry):
        """No live sequence reads it (only the cache's own ref remains)
        and no resident child chains through it."""
        return not self._by_prev.get(entry.h) \
            and self.pool.refcount(entry.block_id) == 1

    def _drop(self, entry):
        del self._by_hash[entry.h]
        kids = self._by_prev.get(entry.prev)
        if kids is not None:
            kids.discard(entry.h)
            if not kids:
                del self._by_prev[entry.prev]
        self.resident_tokens -= len(entry.tokens)
        self.evictions += 1
        self.pool.free([entry.block_id])

    def reclaim(self, shortfall):
        """Pool allocation hook: evict up to `shortfall` blocks, LRU
        among refcount-zero LEAF entries (evicting a leaf may expose its
        parent for the next round). Returns how many were freed."""
        freed = 0
        while freed < int(shortfall):
            victim = None
            for e in self._by_hash.values():
                if not self._evictable(e):
                    continue
                if victim is None or e.last_use < victim.last_use:
                    victim = e
            if victim is None:
                break
            self._drop(victim)
            freed += 1
        return freed

    def reclaimable_blocks(self):
        """How many resident blocks eviction could hand back: entries
        only the cache pins (pool refcount 1). An upper bound — an
        interior entry whose child a live sequence pins evicts only
        after that child — used by `Engine.can_admit` so cached content
        reads as capacity, not exhaustion."""
        return sum(1 for e in self._by_hash.values()
                   if self.pool.refcount(e.block_id) == 1)

    def flush(self):
        """Evict everything no live sequence pins (tests, shutdown)."""
        return self.reclaim(len(self._by_hash))
