"""Paged KV-cache: fixed-shape block pools on the device plus a host
free-list (port of `mxnet_tpu/serving/kv_cache.py`).

The pools are CONTIGUOUS PER LAYER with an explicit block axis —
(n_layers, num_blocks, block_size, n_heads, head_dim) — so a block-table
entry indexes a whole (block_size, n_heads, head_dim) block directly: the
unit the paged-attention kernel (ops/paged_attention.py) stages per table
slot.

Block 0 is the *null block*: never allocated, it absorbs every write from
padded batch rows and padded table entries, so the step functions need no
branches for inactive slots. Reads from it are masked by sequence length.

Unlike the reference, whose pools are immutable jax arrays threaded
through each step, the port writes the pools IN PLACE (`write_kv`,
`write_kv_quant`, `copy_block`): one preallocated tensor per plane lives
for the engine's life.

With `kv_dtype="int8"` the pools hold int8 and grow float32 scale
sidecars `k_scale`/`v_scale` of shape (n_layers, num_blocks, n_heads):
one symmetric scale per (layer, block, head), which the paged kernel
reads beside each block it stages.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError, resolve_device
from ..ops.quantization import div_int8_range


class CacheOverflow(MXNetError):
    """Raised when a reservation asks for more blocks than exist at all;
    transient exhaustion (blocks held by running sequences) is reported by
    ``try_alloc`` returning None so the scheduler can queue instead."""


class BlockPool:
    """Free-list over block ids 1..num_blocks-1 (0 is the null block).

    Invariants: a block is never handed out twice while live, freeing a
    block not currently live raises, and freed blocks are reused (LIFO).
    `high_water` tracks the peak in-use count.

    Blocks are REFCOUNTED: `try_alloc` hands a block out at refcount 1,
    `add_ref` pins it for an additional reader, and `free` drops one ref
    per id — a block only returns to the free list at refcount zero. A
    `free` call is validated ATOMICALLY before any mutation: duplicate
    ids within one call and ids that are not live both raise with the
    pool untouched. When the free list runs short, `try_alloc` first asks
    the `reclaimer` hook (the prefix cache) to evict cached blocks no
    reader holds."""

    def __init__(self, num_blocks):
        if num_blocks < 2:
            raise MXNetError("BlockPool needs >= 2 blocks (block 0 is the "
                             "reserved null block)")
        self.num_blocks = num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))  # pop() -> 1 first
        self._live = set()
        self._refs = {}               # live block id -> refcount >= 1
        self.high_water = 0
        self.reclaimer = None         # callable(shortfall) -> blocks freed

    @property
    def available(self):
        return len(self._free)

    @property
    def in_use(self):
        return len(self._live)

    def refcount(self, b):
        """Current refcount of a block (0 when not live)."""
        return self._refs.get(b, 0)

    def try_alloc(self, n):
        """Reserve n blocks (each at refcount 1); None when the pool
        can't satisfy it right now (backpressure), CacheOverflow when it
        never could. A shortfall first asks the reclaimer to release
        cached blocks no reader holds."""
        if n > self.num_blocks - 1:
            raise CacheOverflow(
                "requested %d blocks but the pool only has %d total"
                % (n, self.num_blocks - 1))
        if n > len(self._free) and self.reclaimer is not None:
            self.reclaimer(n - len(self._free))
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        self._live.update(ids)
        for b in ids:
            self._refs[b] = 1
        self.high_water = max(self.high_water, len(self._live))
        return ids

    def assert_quiescent(self, cache_resident=()):
        """Leak audit: with no sequence in flight every live block must be
        a prefix-cache resident (`cache_resident`) pinned by exactly the
        cache's own ref. Raises MXNetError listing the leaked block ids,
        and any resident id that is not live."""
        resident = set(cache_resident)
        leaked = sorted(b for b in self._live
                        if b not in resident or self._refs[b] != 1)
        phantom = sorted(b for b in resident if b not in self._live)
        if leaked or phantom:
            raise MXNetError(
                "BlockPool not quiescent: %d leaked block id(s) %r "
                "(in_use=%d, cache-resident=%d%s) — a sequence was "
                "released without freeing them, or a shared block holds a "
                "ref no reader owns"
                % (len(leaked), leaked[:32], len(self._live), len(resident),
                   (", cache entries pointing at dead blocks %r"
                    % phantom[:8]) if phantom else ""))

    def add_ref(self, ids):
        """Pin each live block for one more reader; raises on a block
        that is not currently live (nothing to pin)."""
        for b in ids:
            if b not in self._live:
                raise MXNetError(
                    "add_ref on block %r which is not live" % b)
        for b in ids:
            self._refs[b] += 1

    def free(self, ids):
        """Drop one ref per id; blocks reaching refcount zero return to
        the free list. Validated atomically BEFORE any mutation: a
        duplicate id in one call or a non-live id raises MXNetError and
        leaves the pool unchanged."""
        ids = list(ids)
        seen = set()
        for b in ids:
            if b in seen:
                raise MXNetError(
                    "duplicate block id %r in one free() call (would "
                    "drop two refs for one reader); pool left unchanged"
                    % b)
            seen.add(b)
            if b not in self._live:
                raise MXNetError("double-free or foreign block id %r; "
                                 "pool left unchanged" % b)
        for b in ids:
            self._refs[b] -= 1
            if self._refs[b] == 0:
                del self._refs[b]
                self._live.remove(b)
                self._free.append(b)


class PagedKVCache:
    """Device-side K/V pools plus the host free-list.

    ``k``/``v`` are (n_layers, num_blocks, block_size, n_heads, head_dim)
    tensors of `dtype` (float32 or bfloat16) on `device`, zero-filled at
    construction and updated in place by `write_kv`. With
    ``kv_dtype="int8"`` they are int8, updated by `write_kv_quant`, and
    ``k_scale``/``v_scale`` (n_layers, num_blocks, n_heads) float32 hold
    the per-(block, head) scales; otherwise the scales are None.
    `device=None` puts them on the card (raising without one); the CPU is
    asked for by `device="cpu"`.

    With `devices` (a tensor-parallel window of k devices, serving/tp.py)
    the pools shard over the HEAD axis: ``k``/``v`` (and the scales) are
    tuples of k separate contiguous tensors, shard j holding heads
    [j H/k, (j+1) H/k) of every block on devices[j]. One host free-list
    serves them all: a block id names the same block in every shard."""

    def __init__(self, n_layers, n_heads, head_dim, block_size=16,
                 num_blocks=64, dtype=torch.float32, device=None,
                 kv_dtype=None, devices=None):
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.head_dim = head_dim
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.pool = BlockPool(num_blocks)
        if kv_dtype is not None and str(kv_dtype) != "int8":
            raise MXNetError("kv_dtype %r is not supported (int8 or None)"
                             % (kv_dtype,))
        self.kv_dtype = "int8" if kv_dtype is not None else None
        pool_dtype = torch.int8 if self.kv_dtype else dtype
        if devices is None:
            self.k, self.v, self.k_scale, self.v_scale = self._planes(
                resolve_device(device), n_heads, pool_dtype)
            return
        if n_heads % len(devices):
            raise MXNetError("%d heads do not shard over %d devices"
                             % (n_heads, len(devices)))
        planes = [self._planes(d, n_heads // len(devices), pool_dtype)
                  for d in devices]
        self.k, self.v, self.k_scale, self.v_scale = (
            tuple(p[i] for p in planes) if planes[0][i] is not None
            else None for i in range(4))

    def _planes(self, device, n_heads, pool_dtype):
        """(k, v, k_scale, v_scale) of n_heads heads on one device."""
        shape = (self.n_layers, self.num_blocks, self.block_size, n_heads,
                 self.head_dim)
        k = torch.zeros(shape, dtype=pool_dtype, device=device)
        v = torch.zeros(shape, dtype=pool_dtype, device=device)
        if not self.kv_dtype:
            return k, v, None, None
        sshape = (self.n_layers, self.num_blocks, n_heads)
        return (k, v,
                torch.zeros(sshape, dtype=torch.float32, device=device),
                torch.zeros(sshape, dtype=torch.float32, device=device))

    @property
    def quantized(self):
        return self.kv_dtype is not None

    def shards(self):
        """(k, v, k_scale, v_scale) of every head shard: one tuple on a
        single-device pool, one per window device on a sharded one."""
        if not isinstance(self.k, tuple):
            return [(self.k, self.v, self.k_scale, self.v_scale)]
        none = (None,) * len(self.k)
        return list(zip(self.k, self.v, self.k_scale or none,
                        self.v_scale or none))

    def blocks_for(self, n_tokens):
        """Blocks needed to hold n_tokens KV entries — by construction
        the kernel-side table width for a sequence of that length."""
        return max(1, math.ceil(n_tokens / self.block_size))

    def table_row(self, block_ids, n_entries):
        """Fixed-width int32 table row: allocated ids, null-padded."""
        row = np.zeros((n_entries,), np.int32)
        row[:len(block_ids)] = block_ids
        return row

    def utilization(self):
        return self.pool.in_use / float(self.num_blocks - 1)


# ---------------------------------------------------------------------------
# tensor ops used by the engine's step functions
# ---------------------------------------------------------------------------


def flat_slots(block_table, positions, block_size):
    """Flat pool slot for each (row, position): the position'th token of a
    sequence lives in its table's position//bs block at offset
    position%bs. block_table (B, nblk), positions (B,) -> (B,) int64.
    Every position must lie inside its row's table."""
    positions = positions.long()
    blk = torch.gather(block_table.long(), 1,
                       (positions // block_size)[:, None])[:, 0]
    return blk * block_size + positions % block_size


def prompt_slots(table_row, length_cap, block_size):
    """Flat slots for prompt positions 0..length_cap-1 of ONE sequence.
    table_row (nblk,) -> (length_cap,) int64. Positions past the
    allocated blocks hit null-padded table entries -> the null block."""
    pos = torch.arange(length_cap, device=table_row.device)
    return table_row.long()[pos // block_size] * block_size \
        + pos % block_size


def write_kv(k_pool, v_pool, layer, slots, k_new, v_new):
    """Scatter new K/V entries into one layer's flat slots (block id *
    block_size + offset), IN PLACE. slots (...,) integer; k_new/v_new
    (..., n_heads, head_dim). Padded rows may write the same null-block
    slot more than once; which write lands there is unspecified and
    harmless, since no real row ever reads block 0."""
    bs = k_pool.shape[2]
    slots = slots.long()
    blk, off = slots // bs, slots % bs
    k_pool[layer, blk, off] = k_new.to(k_pool.dtype)
    v_pool[layer, blk, off] = v_new.to(v_pool.dtype)


def copy_block(k_pool, v_pool, src, dst):
    """Copy one block's K/V across every layer, IN PLACE — the prefix
    cache's copy-on-write: a request about to write into a shared block
    gets a private copy first, so a shared block is never mutated by a
    reader."""
    k_pool[:, dst] = k_pool[:, src]
    v_pool[:, dst] = v_pool[:, src]


def write_kv_quant(k_pool, v_pool, k_scale, v_scale, layer, slots, k_new,
                   v_new):
    """Quantizing scatter into an int8 pool, IN PLACE: write N new K/V rows
    into one layer's flat slots and requantize each touched block,
    symmetric per (block, head). slots (N,) integer; k_new/v_new
    (N, n_heads, head_dim) float; scales (n_layers, num_blocks, n_heads)
    float32.

    Per touched block the scale is MONOTONIC — s_new = max(s_old,
    amax(new rows) / 127) — so rows written earlier under a smaller scale
    are dequantized with s_old and requantized with s_new (an unchanged
    scale requantizes exactly to the same bytes). The whole block is
    rewritten. Writes aimed at the null block land there, as in the float
    path; nothing reads it.

    The reference gathers the distinct touched blocks with
    `jnp.unique(size=...)`. `torch.unique` on a CUDA tensor waits for the
    device (its output size depends on the data), so here each of the N
    rows stages its own block and maps to the FIRST row that touches the
    same block (`ci`): the new rows are written into that row's copy, and
    every row writes back the requantized copy of its first row, so rows
    that share a block write identical bytes. Same arithmetic, fixed
    shapes, no host round trip."""
    bs = k_pool.shape[2]
    slots = slots.long()
    tb, off = slots // bs, slots % bs                         # (N,)
    ci = (tb[:, None] == tb[None, :]).int().argmax(dim=1)     # first match

    def upd(pool, scale, new):
        new = new.float()
        a = new.abs().amax(dim=-1)                            # (N, H)
        plane = scale[layer]                                  # (NB, H) view
        s_old = plane[tb]                                     # (N, H)
        plane.scatter_reduce_(0, tb[:, None].expand_as(a),
                              div_int8_range(a), reduce="amax")
        s_new = plane[tb]
        s_safe = torch.where(s_new > 0, s_new, torch.ones_like(s_new))
        blk = pool[layer][tb].float() * s_old[:, None, :, None]
        blk[ci, off] = new                                    # (N,bs,H,Dh)
        q = torch.clamp(torch.round(blk[ci] / s_safe[:, None, :, None]),
                        -127, 127)
        pool[layer, tb] = q.to(torch.int8)

    upd(k_pool, k_scale, k_new)
    upd(v_pool, v_scale, v_new)


def copy_block_quant(k_pool, v_pool, k_scale, v_scale, src, dst):
    """`copy_block` for an int8 pool: the scales move with the data, so a
    private copy is bit-identical to the shared original."""
    copy_block(k_pool, v_pool, src, dst)
    k_scale[:, dst] = k_scale[:, src]
    v_scale[:, dst] = v_scale[:, src]


def zero_block_scales(k_scale, v_scale, ids):
    """Reset the scales of freshly ALLOCATED blocks, IN PLACE (ids: a
    list or integer tensor). A reused block otherwise inherits its
    previous occupant's scale, and the monotonic max of `write_kv_quant`
    would quantize the new tokens at that stale, possibly much larger,
    scale. Shared prefix-cache blocks keep their scales: their data is
    reused."""
    k_scale[:, ids] = 0.0
    v_scale[:, ids] = 0.0


def gather_kv(k_pool, v_pool, layer, block_table, block_size):
    """Read one layer's K/V for a batch of sequences by block table.
    block_table (B, nblk) -> k/v (B, nblk*block_size, n_heads, head_dim),
    position-ordered; entries past each sequence's length are garbage and
    must be masked by the caller (mask = arange(T) <= position)."""
    B, nblk = block_table.shape
    idx = block_table.long()
    ks = k_pool[layer][idx]               # (B, nblk, bs, H, Dh)
    vs = v_pool[layer][idx]
    return (ks.reshape(B, nblk * block_size, *ks.shape[3:]),
            vs.reshape(B, nblk * block_size, *vs.shape[3:]))
