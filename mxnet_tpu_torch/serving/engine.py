"""Prefill + decode engine over the paged KV-cache (port of
`mxnet_tpu/serving/engine.py`, transformer family, single device).

`TransformerLM` serves the functional transformer (models/transformer.py)
through two implementations of the cache read:

- the GATHER path (`paged=False`), the port's parity oracle: decode
  gathers each sequence's K/V blocks into a dense (B, T, H, Dh) tensor
  per layer and masked-softmaxes over the full padded width; prefill runs
  the dense causal forward once per request over a power-of-two length
  bucket.
- the PAGED path (`paged=True`, or MXNET_PAGED_ATTENTION=1): decode
  attention is ONE paged-attention kernel launch per layer that walks the
  block table in place (ops/paged_attention.py), with the table WIDTH
  bucketed to the longest live sequence; prefill is CHUNKED, a fixed
  chunk of prompt tokens per call, appended to the pool and attended by
  the same kernel.

PyTorch runs eagerly, so the engine has no compiled-step lattice to bound;
it keeps the reference's power-of-two batch and width buckets all the
same, so the kernel sees the shapes the reference's kernel saw, and
records each (kind, shape) signature it ran in `_sigs`.

The engine owns the device: the pools live on it, the params are moved to
it at construction, and every index tensor is built on it. `device=None`
means the card; a CPU run is asked for by `device="cpu"`.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..base import MXNetError, resolve_device
from .. import telemetry
from ..models.transformer import _layer_norm, _moe_ffn
from ..ops.paged_attention import (paged_attention, paged_enabled,
                                   paged_limit)
from ..parallel.ring_attention import attention_reference
from .kv_cache import (PagedKVCache, flat_slots, prompt_slots, write_kv,
                       gather_kv)


def pow2_bucket(n, lo=1, hi=None):
    """Smallest power of two >= n (clamped to [lo, hi])."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi) if hi is not None else b


class Sequence:
    """One in-flight generation: prompt + generated tokens, cache blocks,
    bookkeeping the engine and scheduler share. `prefilled` counts prompt
    tokens already written to the cache (chunked prefill advances it one
    chunk per `prefill_step`); `prefill_s` accumulates prefill wall time
    across chunks for the metrics roll-up."""

    __slots__ = ("tokens", "prompt_len", "block_ids", "table_row",
                 "max_total", "eos_id", "done", "last_logits", "request",
                 "prefilled", "prefill_s", "token_logits")

    def __init__(self, prompt, max_total, eos_id=None):
        self.tokens = list(prompt)
        self.prompt_len = len(prompt)
        self.block_ids = []
        self.table_row = None
        self.max_total = max_total
        self.eos_id = eos_id
        self.done = False
        self.last_logits = None
        self.request = None
        self.prefilled = 0
        self.prefill_s = 0.0
        self.token_logits = None      # keep_logits engines: one f32 (V,)
                                      # row per emitted token

    @property
    def generated(self):
        return self.tokens[self.prompt_len:]


# ---------------------------------------------------------------------------
# transformer step functions (all write the pools in place)
# ---------------------------------------------------------------------------


def _ffn(params, pre, x, cfg):
    """Position-wise FFN on (N, D), dense or dense-dispatch MoE: both are
    per-token maps, so padded positions cannot perturb real ones."""
    if cfg.n_experts:
        return _moe_ffn(x[None], params[pre + "wg"], params[pre + "w1"],
                        params[pre + "w2"])[0]
    return torch.relu(x @ params[pre + "w1"]) @ params[pre + "w2"]


def _qkv(params, pre, x, H, Dh):
    """LayerNorm + fused QKV projection of (N, D) -> three contiguous
    (N, H, Dh) tensors."""
    h = _layer_norm(x, params[pre + "ln1_g"], params[pre + "ln1_b"])
    q, k, v = torch.split(h @ params[pre + "wqkv"], H * Dh, dim=-1)
    N = x.shape[0]
    return (q.reshape(N, H, Dh).contiguous(),
            k.reshape(N, H, Dh).contiguous(),
            v.reshape(N, H, Dh).contiguous())


def _block_out(params, pre, x, att, cfg):
    """Attention output projection + residual, then the FFN sublayer."""
    N, D = x.shape
    x = x + att.reshape(N, D) @ params[pre + "wo"]
    h = _layer_norm(x, params[pre + "ln2_g"], params[pre + "ln2_b"])
    return x + _ffn(params, pre, h, cfg)


def _head(params, x):
    h = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return (h @ params["head"]).float()


def _tf_prefill(params, k_pool, v_pool, tokens, length, table_row, cfg,
                block_size):
    """Dense causal forward over one padded prompt (S,), writing every
    layer's K/V into the pool and returning the logits (V,) at position
    length-1. Padded positions (>= length) sit AFTER the real tokens, so
    under the causal mask no real position ever attends to them; their
    K/V writes land in not-yet-used or null-block slots and are
    overwritten by decode before they can be read."""
    S = tokens.shape[0]
    H = cfg.n_heads
    Dh = cfg.d_model // H
    x = params["embed"][tokens] + params["pos_embed"][:S]          # (S, D)
    slots = prompt_slots(table_row, S, block_size)                 # (S,)
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        q, kh, vh = _qkv(params, pre, x, H, Dh)
        write_kv(k_pool, v_pool, i, slots, kh, vh)
        att = attention_reference(q.transpose(0, 1)[None],
                                  kh.transpose(0, 1)[None],
                                  vh.transpose(0, 1)[None], causal=True)
        x = _block_out(params, pre, x, att[0].transpose(0, 1), cfg)
    return _head(params, x[length - 1])


def _tf_decode(params, k_pool, v_pool, tokens, positions, tables, cfg,
               block_size):
    """One gather-path decode step for a (padded) batch: tokens (B,) at
    positions (B,), block tables (B, nblk). Writes the new K/V, gathers
    each sequence's cache by table, masked-softmax attention; returns
    logits (B, V) float32. Padded rows carry the all-null table — their
    writes hit the null block and their logits are discarded."""
    B = tokens.shape[0]
    H = cfg.n_heads
    Dh = cfg.d_model // H
    scale = 1.0 / math.sqrt(Dh)
    x = params["embed"][tokens] + params["pos_embed"][positions]   # (B, D)
    slots = flat_slots(tables, positions, block_size)              # (B,)
    T = tables.shape[1] * block_size
    live = torch.arange(T, device=tokens.device)[None, :] \
        <= positions.long()[:, None]                               # (B, T)
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        q, kh, vh = _qkv(params, pre, x, H, Dh)
        write_kv(k_pool, v_pool, i, slots, kh, vh)
        ks, vs = gather_kv(k_pool, v_pool, i, tables, block_size)  # (B,T,H,Dh)
        # the length mask stands in for the causal mask (the query IS the
        # newest position)
        s = torch.einsum("bhd,bthd->bht", q, ks).float() * scale
        s = s.masked_fill(~live[:, None, :], float("-inf"))
        p = torch.softmax(s, dim=-1)
        att = torch.einsum("bht,bthd->bhd", p, vs.to(p.dtype))
        x = _block_out(params, pre, x, att.to(x.dtype), cfg)
    return _head(params, x)


def _tf_decode_paged(params, k_pool, v_pool, tokens, positions, tables,
                     cfg, block_size):
    """One decode step through the paged-attention kernel: same contract
    as `_tf_decode`, but each layer's cache read is one kernel launch
    walking the block table in place — no dense (B, T, H, Dh) gather is
    materialized. `tables` (B, w) int32 is width-bucketed by the caller to
    the longest live sequence; `positions` (B,) int32."""
    B = tokens.shape[0]
    H = cfg.n_heads
    Dh = cfg.d_model // H
    x = params["embed"][tokens] + params["pos_embed"][positions]   # (B, D)
    slots = flat_slots(tables, positions, block_size)              # (B,)
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        q, kh, vh = _qkv(params, pre, x, H, Dh)
        write_kv(k_pool, v_pool, i, slots, kh, vh)
        att = paged_attention(q[:, None], k_pool[i], v_pool[i], tables,
                              positions, block_size)[:, 0]         # (B,H,Dh)
        x = _block_out(params, pre, x, att, cfg)
    return _head(params, x)


def _tf_prefill_chunk(params, k_pool, v_pool, toks, qs, length, last_idx,
                      table_row, cfg, block_size):
    """One fixed-shape prefill chunk for ONE sequence: toks (C,) are the
    prompt tokens at positions qs..qs+C-1 (zero-padded past the true
    prompt `length`), table_row (w,) int32 is the sequence's
    width-bucketed block table. Writes the chunk's K/V into the pool and
    attends via the paged kernel — the mask `key_pos <= qs+i` is the
    causal mask within the chunk and the full-history mask across earlier
    chunks. Returns logits (V,) at chunk index `last_idx`.

    Padded positions (>= length) write their K/V into the null block, not
    into their table slot, which belongs to a future decode position.
    Their table index and positional row are clamped BEFORE indexing:
    a padded position may lie past the table's width or past max_len,
    where the reference's gathers clamp and a CUDA index would fault."""
    C = toks.shape[0]
    H = cfg.n_heads
    Dh = cfg.d_model // H
    w = table_row.shape[0]
    dev = toks.device
    pos = qs + torch.arange(C, device=dev)                         # (C,)
    x = params["embed"][toks] \
        + params["pos_embed"][pos.clamp(max=cfg.max_len - 1)]      # (C, D)
    blk = table_row.long()[(pos // block_size).clamp(max=w - 1)]
    slots = torch.where(pos < length, blk * block_size + pos % block_size,
                        pos % block_size)                          # null blk
    tables = table_row[None]                                       # (1, w)
    qs_row = torch.full((1,), qs, dtype=torch.int32, device=dev)
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        q, kh, vh = _qkv(params, pre, x, H, Dh)
        write_kv(k_pool, v_pool, i, slots, kh, vh)
        att = paged_attention(q[None], k_pool[i], v_pool[i], tables,
                              qs_row, block_size)[0]               # (C,H,Dh)
        x = _block_out(params, pre, x, att, cfg)
    return _head(params, x[last_idx])


class TransformerLM:
    """Paged-cache adapter for the functional transformer
    (models/transformer.py): a params dict of tensors + TransformerConfig."""

    uses_cache = True

    def __init__(self, params, cfg):
        if cfg.n_experts and cfg.moe_top_k:
            raise MXNetError(
                "serving: top-k MoE routing is capacity-dependent across "
                "the token group, so padded decode batches would change "
                "real tokens' routing; serve dense-FFN or dense-dispatch "
                "MoE configs (moe_top_k=0)")
        self.params = params
        self.cfg = cfg
        self.vocab = cfg.vocab
        self.max_len = cfg.max_len
        self.block_size = None

    def cache_spec(self):
        """(n_layers, n_heads, head_dim, dtype) of the KV pool."""
        return (self.cfg.n_layers, self.cfg.n_heads,
                self.cfg.d_model // self.cfg.n_heads,
                self.params["embed"].dtype)

    def bind(self, block_size, device):
        """Fix the block size and move the params to `device` (no copy
        when they are already there)."""
        self.block_size = block_size
        self.params = {k: v.to(device) for k, v in self.params.items()}

    def prefill(self, k, v, tokens, length, table_row):
        return _tf_prefill(self.params, k, v, tokens, length, table_row,
                           self.cfg, self.block_size)

    def decode(self, k, v, tokens, positions, tables):
        return _tf_decode(self.params, k, v, tokens, positions, tables,
                          self.cfg, self.block_size)

    def decode_paged(self, k, v, tokens, positions, tables):
        return _tf_decode_paged(self.params, k, v, tokens, positions,
                                tables, self.cfg, self.block_size)

    def prefill_chunk(self, k, v, tokens, q_start, length, last_idx,
                      table_row):
        return _tf_prefill_chunk(self.params, k, v, tokens, q_start,
                                 length, last_idx, table_row, self.cfg,
                                 self.block_size)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class Engine:
    """Owns the cache pool, the device and the shape buckets.
    Thread-compatible, not thread-safe: all compute entry points (`start`,
    `prefill_step`, `decode_step`) must be called from one serving thread.

    `paged` (None: MXNET_PAGED_ATTENTION) picks the kernel path. On CUDA
    a paged engine whose shapes the kernel does not take raises here, at
    construction, naming the limit; it never switches to the gather path
    behind the caller's back."""

    def __init__(self, model, max_batch=8, max_len=None, block_size=16,
                 num_blocks=None, keep_logits=False, paged=None,
                 prefill_chunk=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.max_batch = max_batch
        self.max_len = int(max_len or model.max_len)
        self.keep_logits = keep_logits
        self._sigs = set()
        self.paged = paged_enabled() if paged is None else bool(paged)
        self.prefill_chunk = 0
        nl, nh, dh, dt = model.cache_spec()
        self._nblk = max(1, math.ceil(self.max_len / block_size))
        if num_blocks is None:
            num_blocks = max_batch * self._nblk + 1
        if self.paged:
            self.prefill_chunk = min(self.max_len,
                                     int(prefill_chunk or 2 * block_size))
            if self.device.type == "cuda":
                for tq in (1, self.prefill_chunk):
                    limit = paged_limit(dh, block_size, tq, dt)
                    if limit is not None:
                        raise MXNetError(
                            "paged=True on %s: the paged-attention kernel "
                            "does not take this config: %s"
                            % (self.device, limit))
        model.bind(block_size, self.device)
        self.cache = PagedKVCache(nl, nh, dh, block_size=block_size,
                                  num_blocks=num_blocks, dtype=dt,
                                  device=self.device)

    def _tensor(self, arr):
        return torch.as_tensor(arr, device=self.device)

    # -- admission accounting ------------------------------------------------

    def blocks_needed(self, prompt_len, max_new):
        total = min(self.max_len, prompt_len + max_new)
        return self.cache.blocks_for(total)

    def can_admit(self, prompt_len, max_new):
        """Would this request's block reservation fit right now? Raises
        MXNetError for a prompt that can never be served."""
        if prompt_len > self.max_len:
            raise MXNetError("prompt length %d exceeds max_len %d"
                             % (prompt_len, self.max_len))
        return self.blocks_needed(prompt_len, max_new) \
            <= self.cache.pool.available

    def cache_utilization(self):
        return self.cache.utilization()

    # -- prefill -------------------------------------------------------------

    def begin(self, prompt, max_new, eos_id=None):
        """Admit one request: allocate its cache blocks, no compute.
        Prefill is advanced by `prefill_step`. Returns the Sequence, or
        None if blocks ran out (transient)."""
        L = len(prompt)
        if L < 1:
            raise MXNetError("empty prompt")
        seq = Sequence(prompt, min(self.max_len, L + max_new), eos_id)
        if self.keep_logits:
            seq.token_logits = []
        ids = self.cache.pool.try_alloc(self.blocks_needed(L, max_new))
        if ids is None:
            return None
        seq.block_ids = ids
        seq.table_row = self.cache.table_row(ids, self._nblk)
        return seq

    def prefill_tokens_per_step(self, prompt_len):
        """Tokens one `prefill_step` call will process — the scheduler's
        token-budget admission cost. Fixed chunk on the paged path; the
        whole (bucketed) prompt in one shot on the gather path."""
        if self.paged:
            return self.prefill_chunk
        return pow2_bucket(prompt_len, lo=1, hi=self.max_len)

    def prefill_step(self, seq):
        """Advance one sequence's prefill. Paged path: run ONE
        fixed-shape chunk; gather path: run the whole prompt. Returns True
        when the prompt is fully prefilled and the first token has been
        sampled."""
        L = seq.prompt_len
        prompt = seq.tokens[:L]
        rid = seq.request.trace if seq.request is not None else None
        with telemetry.span("serving.prefill", trace=rid,
                            category="serving", prompt_len=L,
                            chunk_start=seq.prefilled):
            if self.paged:
                C = self.prefill_chunk
                qs = seq.prefilled
                toks = np.zeros((C,), np.int64)
                toks[:min(C, L - qs)] = prompt[qs:qs + C]
                w = pow2_bucket(self.cache.blocks_for(qs + C),
                                lo=1, hi=self._nblk)
                self._sigs.add(("prefill", (C, w)))
                logits = self.model.prefill_chunk(
                    self.cache.k, self.cache.v, self._tensor(toks), qs, L,
                    min(L - 1 - qs, C - 1),
                    self._tensor(seq.table_row[:w]))
                seq.prefilled = min(L, qs + C)
                if seq.prefilled < L:
                    return False
            else:
                s_pad = pow2_bucket(L, lo=min(8, self.max_len),
                                    hi=self.max_len)
                toks = np.zeros((s_pad,), np.int64)
                toks[:L] = prompt
                self._sigs.add(("prefill", s_pad))
                logits = self.model.prefill(
                    self.cache.k, self.cache.v, self._tensor(toks), L,
                    self._tensor(seq.table_row))
                seq.prefilled = L
            logits = logits.cpu().numpy()
        if self.keep_logits:
            seq.last_logits = logits
            seq.token_logits.append(logits)
        self._append(seq, int(np.argmax(logits)))
        return True

    def start(self, prompt, max_new, eos_id=None):
        """Admit one request and run its whole prefill. Returns the live
        Sequence, or None if blocks ran out (transient). The serving loop
        uses begin/prefill_step instead so chunks interleave with decode
        steps."""
        seq = self.begin(prompt, max_new, eos_id=eos_id)
        if seq is None:
            return None
        while not self.prefill_step(seq):
            pass
        return seq

    # -- decode --------------------------------------------------------------

    def decode_tokens_per_step(self):
        """Tokens one decode iteration scores per running sequence."""
        return 1

    def decode_step(self, seqs):
        """Advance every sequence in `seqs` by one token (one batched
        step over the power-of-two padded batch). Returns the sequences
        it advanced."""
        seqs = [s for s in seqs if not s.done]
        if not seqs:
            return []
        if len(seqs) > self.max_batch:
            raise MXNetError("decode batch %d exceeds max_batch %d"
                             % (len(seqs), self.max_batch))
        bb = pow2_bucket(len(seqs), lo=1, hi=self.max_batch)
        t0_us = time.perf_counter_ns() // 1000
        with telemetry.span("serving.decode", category="serving",
                            batch=len(seqs)):
            # paged path: the kernel's table width is bucketed to the
            # longest LIVE sequence, so a step's bytes track true
            # lengths; the gather path always sees the full table
            w = self._nblk
            if self.paged:
                w = pow2_bucket(max(self.cache.blocks_for(len(s.tokens))
                                    for s in seqs), lo=1, hi=self._nblk)
            toks = np.zeros((bb,), np.int64)
            pos = np.zeros((bb,), np.int32)
            tabs = np.zeros((bb, w), np.int32)
            for i, s in enumerate(seqs):
                toks[i] = s.tokens[-1]
                pos[i] = len(s.tokens) - 1
                tabs[i] = s.table_row[:w]
            step = self.model.decode_paged if self.paged \
                else self.model.decode
            self._sigs.add(("decode", (bb, w) if self.paged else bb))
            logits = step(self.cache.k, self.cache.v, self._tensor(toks),
                          self._tensor(pos), self._tensor(tabs))
            nxt = logits.argmax(-1).cpu().numpy()
            logits = logits.cpu().numpy() if self.keep_logits else None
        dur_us = time.perf_counter_ns() // 1000 - t0_us
        for i, s in enumerate(seqs):
            if logits is not None:
                s.last_logits = logits[i]
                s.token_logits.append(logits[i])
            self._append(s, int(nxt[i]))
            if s.request is not None:
                # the batch step, fanned out to each request's trace row
                telemetry.record_span("serving.decode", t0_us, dur_us,
                                      trace=s.request.trace,
                                      category="serving",
                                      position=len(s.tokens) - 1)
        return seqs

    def _append(self, seq, token):
        seq.tokens.append(token)
        if (seq.eos_id is not None and token == seq.eos_id) \
                or len(seq.tokens) >= seq.max_total:
            seq.done = True

    # -- end of life ---------------------------------------------------------

    def release(self, seq):
        """Recycle a finished sequence's cache blocks."""
        if seq.block_ids:
            self.cache.pool.free(seq.block_ids)
            seq.block_ids = []

    def audit_quiescent(self):
        """Leak audit: with no sequence in flight no pool block may be
        allocated. Raises MXNetError listing the leaked ids."""
        self.cache.pool.assert_quiescent()

    def close(self, audit=True):
        """End-of-life seam: with `audit=True` run the leak audit."""
        if audit:
            self.audit_quiescent()
