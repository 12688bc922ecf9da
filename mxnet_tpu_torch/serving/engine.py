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

Options of the paged path, each read when the Engine is constructed:

- `kv_quant` (MXNET_QUANTIZED_KV=1): an int8 pool with per-(block, head)
  float32 scales, written by `write_kv_quant` and read by the kernel's
  int8 variant, which dequantizes as it stages each block.
- `weight_quant="int8"` (MXNET_QUANTIZED_WEIGHTS=int8): per-channel int8
  matmul weights (ops/quantization.py); embeddings, norms and the LM head
  stay float.
- `draft`/`spec`/`spec_k` (MXNET_SPEC_DECODE, MXNET_SPEC_K,
  MXNET_SPEC_DRAFT_LAYERS): speculative decoding (spec.py). The target
  scores k+1 positions per sequence in one pass (`_tf_spec_score`, the
  kernel at Tq = k+1); greedy verification keeps the tokens identical to
  the per-token path.
- `prefix_cache` (MXNET_PREFIX_CACHE=1): shared prompt prefixes hit
  resident refcounted blocks (prefix_cache.py), copy-on-write on
  divergence.
- `tp`/`devices` (MXNET_SERVING_TP): tensor parallelism over a window of
  devices driven by this one engine (tp.py): the weights and the pool
  shard over heads, each shard runs the paged kernel over its own pool,
  and the two reductions a layer are peer copies summed in a fixed
  order. tp > 1 implies the paged path.

A quantized engine switches PRECISION against the float oracle, within
the reference's logit budgets; spec and the prefix cache switch speed
only, never tokens, and tp placement only, never logits. An option the
configuration cannot take (kv_quant or spec without the paged path, spec
without a draft, a draft with another vocabulary, a tp degree the heads,
the FFN or the window cannot hold) records its reason on
`kv_quant_fallback`, `spec_fallback`, `prefix_cache_fallback` or
`tp_fallback` and serves without it; on CUDA an option whose shapes the
kernel does not take raises at construction.

PyTorch runs eagerly, so nothing is compiled per shape; the engine keeps
the reference's power-of-two batch and width buckets all the same, so the
kernel sees the shapes the reference's kernel saw. Each step goes through
the compile watchdog (telemetry/introspect.py) at the reference's sites —
`serving.prefill`, `serving.decode`, `serving.spec_score`,
`serving.draft`, and for the full-forward adapters
`serving.step_full` / `serving.exported_call` — whose signature is the
step's own shape key (its token and table tensors), never a walk over the
parameters: a new bucket is a first run there, with its diff reason.
`prefill_compilations` / `decode_compilations` count the first runs (and
kernel builds) this engine's calls paid, `warm_loads` the kernel
libraries they loaded from the AOT cache (`Engine(aot_cache=)`), through
the watchdog's per-thread seam; each (kind, shape) signature it ran is
also kept in `_sigs`.

Besides `TransformerLM` on the paged pool, the engine serves two
full-forward adapters with no cache hooks (`uses_cache = False`), as the
reference does: `BlockLM` (an initialized Gluon causal LM, e.g. the word
LM, whose fused LSTM runs K4a) and `ExportedLM` (a `.mxtpu` artifact from
`predict.export_model`, replayed through torch.export, K4a as the op
`mxnet_tpu_torch::rnn_fwd`). Every step re-runs the whole bucketed
history; the pool, the paged kernel, the int8 pool, the prefix cache,
speculation and tp do not apply and record their fallback reasons.

The engine owns the device: the pools live on it, the params are moved to
it at construction, and every index tensor is built on it. `device=None`
means the card (a tp window's first device); a CPU run is asked for by
`device="cpu"` (and a CPU window by `devices=["cpu"] * k`).
"""
from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch

from ..base import MXNetError, resolve_device, torch_dtype
from .. import telemetry
from ..telemetry import introspect as _introspect
from ..models.transformer import _layer_norm, _moe_ffn
from ..ops.paged_attention import (paged_attention, paged_enabled,
                                   paged_limit)
from ..ops.quantization import maybe_quant_matmul as _mm
from ..parallel.ring_attention import attention_reference
from . import spec as _spec
from .kv_cache import (PagedKVCache, flat_slots, prompt_slots, write_kv,
                       gather_kv, copy_block, write_kv_quant,
                       copy_block_quant, zero_block_scales)
from .prefix_cache import PrefixCache, prefix_cache_enabled


def quantized_kv_enabled():
    """MXNET_QUANTIZED_KV=1 requests the int8 KV pool, read when an
    Engine is constructed."""
    return os.environ.get("MXNET_QUANTIZED_KV", "") == "1"


def quantized_weights_env():
    """MXNET_QUANTIZED_WEIGHTS=int8 requests int8 weights, read when an
    Engine is constructed; unset or empty means float weights."""
    v = os.environ.get("MXNET_QUANTIZED_WEIGHTS", "").strip()
    return v or None


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
    chunk per `prefill_step`; a prefix-cache hit starts it past zero);
    `prefill_s` accumulates prefill wall time across chunks for the
    metrics roll-up."""

    __slots__ = ("tokens", "prompt_len", "block_ids", "table_row",
                 "max_total", "eos_id", "done", "last_logits", "request",
                 "prefilled", "prefill_s", "cache_hit_tokens",
                 "shared_blocks", "token_logits")

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
        self.cache_hit_tokens = 0     # prompt tokens served by prefix hits
        self.shared_blocks = 0        # table entries pointing at shared
                                      # (refcounted) cache blocks
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
    per-token maps, so padded positions cannot perturb real ones. Dense
    weights may be int8 (`_mm`); MoE expert stacks stay float."""
    if cfg.n_experts:
        return _moe_ffn(x[None], params[pre + "wg"], params[pre + "w1"],
                        params[pre + "w2"])[0]
    return _mm(torch.relu(_mm(x, params[pre + "w1"])), params[pre + "w2"])


def _qkv(params, pre, x, H, Dh):
    """LayerNorm + fused QKV projection of (N, D) -> three contiguous
    (N, H, Dh) tensors."""
    h = _layer_norm(x, params[pre + "ln1_g"], params[pre + "ln1_b"])
    q, k, v = torch.split(_mm(h, params[pre + "wqkv"]), H * Dh, dim=-1)
    N = x.shape[0]
    return (q.reshape(N, H, Dh).contiguous(),
            k.reshape(N, H, Dh).contiguous(),
            v.reshape(N, H, Dh).contiguous())


def _block_out(params, pre, x, att, cfg):
    """Attention output projection + residual, then the FFN sublayer."""
    N, D = x.shape
    x = x + _mm(att.reshape(N, D), params[pre + "wo"])
    h = _layer_norm(x, params[pre + "ln2_g"], params[pre + "ln2_b"])
    return x + _ffn(params, pre, h, cfg)


def _head(params, x):
    h = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    return (h @ params["head"]).float()


def _write_attend(k_pool, v_pool, k_scale, v_scale, layer, slots, kh, vh,
                  q, tables, q_start, block_size):
    """Write one layer's new K/V rows into the pool (quantizing when the
    pool is int8, `k_scale` given) and attend q (B, Tq, H, Dh) through
    the paged kernel against it."""
    if k_scale is None:
        write_kv(k_pool, v_pool, layer, slots, kh, vh)
        return paged_attention(q, k_pool[layer], v_pool[layer], tables,
                               q_start, block_size)
    write_kv_quant(k_pool, v_pool, k_scale, v_scale, layer, slots, kh, vh)
    return paged_attention(q, k_pool[layer], v_pool[layer], tables,
                           q_start, block_size, k_scale=k_scale[layer],
                           v_scale=v_scale[layer])


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
                     cfg, block_size, k_scale=None, v_scale=None):
    """One decode step through the paged-attention kernel: same contract
    as `_tf_decode`, but each layer's cache read is one kernel launch
    walking the block table in place — no dense (B, T, H, Dh) gather is
    materialized. `tables` (B, w) int32 is width-bucketed by the caller to
    the longest live sequence; `positions` (B,) int32. With
    `k_scale`/`v_scale` the pool is int8: appends quantize and the kernel
    dequantizes."""
    B = tokens.shape[0]
    H = cfg.n_heads
    Dh = cfg.d_model // H
    x = params["embed"][tokens] + params["pos_embed"][positions]   # (B, D)
    slots = flat_slots(tables, positions, block_size)              # (B,)
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        q, kh, vh = _qkv(params, pre, x, H, Dh)
        att = _write_attend(k_pool, v_pool, k_scale, v_scale, i, slots, kh,
                            vh, q[:, None], tables, positions,
                            block_size)[:, 0]                      # (B,H,Dh)
        x = _block_out(params, pre, x, att, cfg)
    return _head(params, x)


def _tf_prefill_chunk(params, k_pool, v_pool, toks, qs, length, last_idx,
                      table_row, cfg, block_size, k_scale=None,
                      v_scale=None):
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
        att = _write_attend(k_pool, v_pool, k_scale, v_scale, i, slots, kh,
                            vh, q[None], tables, qs_row,
                            block_size)[0]                         # (C,H,Dh)
        x = _block_out(params, pre, x, att, cfg)
    return _head(params, x[last_idx])


def _tf_spec_score(params, k_pool, v_pool, toks, q_starts, counts, tables,
                   cfg, block_size, k_scale=None, v_scale=None):
    """Speculative scoring pass, the batched generalization of
    `_tf_prefill_chunk`: toks (B, C) holds each row's [last history
    token, draft_1..draft_k] (zero-padded past the row's true `counts`)
    at positions q_starts[b]..q_starts[b]+C-1; tables (B, w) are the live
    width-bucketed block tables. ONE paged pass per layer (the kernel at
    Tq = C) writes the C positions' K/V and returns logits (B, C, V)
    float32: row j of a sequence is the target's next-token distribution
    given its history plus the first j draft tokens.

    Positions past `counts` (short proposals, padded batch rows) write to
    the null block; positions past an eventual rejection land in real
    table slots and are rewritten by the next pass over the sequence
    before any mask lets a query read them."""
    B, C = toks.shape
    H = cfg.n_heads
    D = cfg.d_model
    Dh = D // H
    w = tables.shape[1]
    dev = toks.device
    ar = torch.arange(C, device=dev)
    pos = q_starts.long()[:, None] + ar[None, :]                   # (B, C)
    valid = ar[None, :] < counts.long()[:, None]                   # (B, C)
    x = params["embed"][toks] \
        + params["pos_embed"][pos.clamp(max=cfg.max_len - 1)]      # (B,C,D)
    blk = torch.gather(tables.long(), 1,
                       (pos // block_size).clamp(max=w - 1))
    slots = torch.where(valid, blk * block_size + pos % block_size,
                        pos % block_size).reshape(B * C)           # null blk
    x = x.reshape(B * C, D)
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        q, kh, vh = _qkv(params, pre, x, H, Dh)
        att = _write_attend(k_pool, v_pool, k_scale, v_scale, i, slots, kh,
                            vh, q.reshape(B, C, H, Dh), tables, q_starts,
                            block_size)                            # (B,C,H,Dh)
        x = _block_out(params, pre, x, att.reshape(B * C, H, Dh), cfg)
    return _head(params, x).reshape(B, C, -1)


def _to_device(value, device):
    """A param or a quantized `{"q", "s"}` weight moved to `device` (no
    copy when already there)."""
    if isinstance(value, dict):
        return {k: v.to(device) for k, v in value.items()}
    return value.to(device)


class TransformerLM:
    """Paged-cache adapter for the functional transformer
    (models/transformer.py): a params dict of tensors + TransformerConfig.
    `bind` (and `bind_tp`) register each step at its watchdog site as the
    adapter's `prefill`, `decode`, `decode_paged`, `prefill_chunk` and
    `spec_score` (and their `_tp` forms), afresh for each engine, so a
    restarted engine's first steps read as duplicates."""

    uses_cache = True

    #: step -> (watchdog site, phase, signature argument names, their
    #: positions): the signature is the step's shape key, never the params;
    #: a tp step registers as its single-device form does
    _STEPS = {
        "prefill": ("serving.prefill", "prefill", ("tokens", "table_row"),
                    (2, 4)),
        "decode": ("serving.decode", "decode",
                   ("tokens", "positions", "tables"), (2, 3, 4)),
        "decode_paged": ("serving.decode", "decode",
                         ("tokens", "positions", "tables"), (2, 3, 4)),
        "prefill_chunk": ("serving.prefill", "prefill",
                          ("tokens", "table_row"), (2, 6)),
        "spec_score": ("serving.spec_score", "decode",
                       ("tokens", "q_starts", "tables"), (2, 3, 5)),
    }
    _TP_STEPS = {"decode_tp": "decode_paged",
                 "prefill_chunk_tp": "prefill_chunk",
                 "spec_score_tp": "spec_score"}

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
        self.weight_quant = None
        self.params_f32 = None    # the float weights once quantized: the
                                  # self-draft's and tp placement's source
        self.tp_params = None     # per-shard dicts once bound to a window
        self.tp_mesh = None

    def cache_spec(self):
        """(n_layers, n_heads, head_dim, dtype) of the KV pool."""
        return (self.cfg.n_layers, self.cfg.n_heads,
                self.cfg.d_model // self.cfg.n_heads,
                self.params["embed"].dtype)

    def quantize_weights(self, mode="int8"):
        """Quantize the matmul weights once at load: per-channel
        symmetric int8 for wqkv/wo/w1/w2 (each a `{"q", "s"}` dict the
        step functions' `_mm` consumes); embeddings, positional table,
        layer norms and the LM head stay float, as do MoE expert stacks.
        Idempotent; the float weights stay on `params_f32`."""
        if str(mode) != "int8":
            raise MXNetError("weight_quant %r is not supported (int8 "
                             "or None)" % (mode,))
        if self.weight_quant:
            return
        from ..predict import quantize_lm_params
        self.params_f32 = self.params
        self.params = quantize_lm_params(self.params, self.cfg.n_layers,
                                         mode=mode)
        self.weight_quant = "int8"

    def bind(self, block_size, device):
        """Fix the block size and move the params to `device` (no copy
        when they are already there). The float originals of quantized
        weights stay where they are: only a self-draft reads them, and
        it moves what it keeps."""
        self.block_size = block_size
        self.params = {k: _to_device(v, device)
                       for k, v in self.params.items()}
        self._instrument(self._STEPS, device)

    def _instrument(self, names, device):
        for name in names:
            site, phase, argnames, sig = self._STEPS[
                self._TP_STEPS.get(name, name)]
            setattr(self, name, _introspect.instrument(
                getattr(self, "_" + name), site=site, phase=phase,
                argnames=argnames, sig_argnums=sig, device=device))

    def bind_tp(self, mesh):
        """Lay the weights out over the tp window `mesh` (tp.py): k
        per-shard dicts, head-major. With int8 weights the float
        originals are placed and each shard quantizes its own block, so
        a row-parallel shard's scales are its own rows'. `self.params`
        stays the replicated single-device copy."""
        from .tp import place_tp_params, quantize_tp_params
        src = self.params_f32 if self.weight_quant else self.params
        shards = place_tp_params(src, self.cfg, mesh)
        if self.weight_quant:
            shards = quantize_tp_params(shards, self.cfg)
        self.tp_params = shards
        self.tp_mesh = mesh
        self._instrument(self._TP_STEPS, mesh[0])

    def _prefill(self, k, v, tokens, length, table_row):
        return _tf_prefill(self.params, k, v, tokens, length, table_row,
                           self.cfg, self.block_size)

    def _decode(self, k, v, tokens, positions, tables):
        return _tf_decode(self.params, k, v, tokens, positions, tables,
                          self.cfg, self.block_size)

    def _decode_paged(self, k, v, tokens, positions, tables, k_scale=None,
                      v_scale=None):
        return _tf_decode_paged(self.params, k, v, tokens, positions,
                                tables, self.cfg, self.block_size,
                                k_scale, v_scale)

    def _prefill_chunk(self, k, v, tokens, q_start, length, last_idx,
                       table_row, k_scale=None, v_scale=None):
        return _tf_prefill_chunk(self.params, k, v, tokens, q_start,
                                 length, last_idx, table_row, self.cfg,
                                 self.block_size, k_scale, v_scale)

    def _spec_score(self, k, v, tokens, q_starts, counts, tables,
                    k_scale=None, v_scale=None):
        return _tf_spec_score(self.params, k, v, tokens, q_starts, counts,
                              tables, self.cfg, self.block_size, k_scale,
                              v_scale)

    # the tp steps: the same signatures over the window's per-shard pools
    # (tuples of tensors, one per window device)

    def _decode_tp(self, k, v, tokens, positions, tables, k_scale=None,
                   v_scale=None):
        from .tp import _decode_body
        return _decode_body(self.tp_params, self.tp_mesh, k, v, tokens,
                            positions, tables, self.cfg, self.block_size,
                            k_scale, v_scale)

    def _prefill_chunk_tp(self, k, v, tokens, q_start, length, last_idx,
                          table_row, k_scale=None, v_scale=None):
        from .tp import _prefill_chunk_body
        return _prefill_chunk_body(self.tp_params, self.tp_mesh, k, v,
                                   tokens, q_start, length, last_idx,
                                   table_row, self.cfg, self.block_size,
                                   k_scale, v_scale)

    def _spec_score_tp(self, k, v, tokens, q_starts, counts, tables,
                       k_scale=None, v_scale=None):
        from .tp import _spec_score_body
        return _spec_score_body(self.tp_params, self.tp_mesh, k, v, tokens,
                                q_starts, counts, tables, self.cfg,
                                self.block_size, k_scale, v_scale)


# ---------------------------------------------------------------------------
# full-forward adapters (no cache hooks): Gluon Blocks and .mxtpu artifacts
# ---------------------------------------------------------------------------


def _rows_at(out, lengths):
    """Each row's logits at its lengths-1 position of (B, S, V), as
    float32 (B, V)."""
    rows = torch.arange(out.shape[0], device=out.device)
    return out[rows, lengths.to(out.device).long() - 1].float()


class BlockLM:
    """Serve an initialized Gluon causal LM Block: tokens (B, S) ->
    logits (B, S, V), or time-major (S, B) -> (S*B, V) like
    `models.word_lm.RNNModel` with `time_major=True`. Each step is one
    eager inference forward of the block over the bucketed history
    (MXNET_FUSED_RNN=1 runs a fused LSTM's layers on K4a), registered at
    the watchdog's site "serving.step_full" with the (tokens, lengths)
    signature; the adapter's seen signatures persist across the engines
    that share it."""

    uses_cache = False

    def __init__(self, block, vocab, max_len, time_major=False):
        self.vocab = vocab
        self.max_len = max_len
        self.time_major = bool(time_major)
        self._block = block
        params = [p for p in block.collect_params().values()
                  if p._data is not None]
        self.device = params[0]._data._data.device if params else None
        self._step = _introspect.instrument(
            self._logits, site="serving.step_full",
            argnames=("tokens", "lengths"))

    def _logits(self, toks, lengths):
        from .. import autograd
        from ..ndarray import NDArray
        B, S = toks.shape
        with autograd.pause(train_mode=False), torch.no_grad():
            if self.time_major:
                out = self._block(NDArray(toks.t().float()))._data
                out = out.reshape(S, B, -1).transpose(0, 1)
            else:
                out = self._block(NDArray(toks))._data
        return _rows_at(out, lengths)

    def step_full(self, tokens, lengths, phase=None):
        """tokens (B, S) int -> float32 logits (B, V) at lengths-1 (one
        step serves prefill and decode; `phase` attributes a first run to
        the side that paid it)."""
        toks = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                               device=self.device)
        lens = torch.as_tensor(np.asarray(lengths), dtype=torch.int64,
                               device=self.device)
        return self._step(toks, lens, _phase=phase)


class ExportedLM:
    """Serve a `.mxtpu` artifact (`predict.export_model`) whose one input
    is int token ids (B_sig, S_sig) and whose first output is logits
    (B_sig, S_sig, V). The program's shape is fixed at export, so serving
    pads and chunks each batch to the exported signature. `device` is
    where the program replays (the card by default). Each replay is
    registered at the watchdog's site "serving.exported_call", and
    `replays` counts them."""

    uses_cache = False

    def __init__(self, artifact, device=None):
        from ..predict import ExportedPredictor, load_exported
        if isinstance(artifact, ExportedPredictor):
            pred = artifact
        else:
            ctx = None
            if device is not None:
                from ..context import Context
                dev = resolve_device(device)
                ctx = Context("gpu" if dev.type == "cuda" else "cpu",
                              dev.index or 0)
            pred = load_exported(artifact, ctx=ctx)
        desc = pred.input_descs
        if len(desc) != 1 or len(desc[0]["shape"]) != 2:
            raise MXNetError(
                "ExportedLM needs an artifact with ONE (batch, seq) token "
                "input; got %r" % (desc,))
        self._pred = pred
        self.device = pred.device
        self.sig_batch, self.sig_len = desc[0]["shape"]
        self.max_len = self.sig_len
        self._dtype = desc[0]["dtype"]
        self.vocab = None  # unknown until the first forward
        self.replays = 0
        self._call = _introspect.instrument(
            lambda buf: pred._call([buf])[0],
            site="serving.exported_call", argnames=("tokens",))

    def step_full(self, tokens, lengths, phase=None):
        """tokens (B, S <= sig_len) int -> float32 logits (B, V) at
        lengths-1, chunked over the exported batch size."""
        tokens = np.asarray(tokens)
        lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int64)
        B, S = tokens.shape
        if S > self.sig_len:
            raise MXNetError("sequence length %d exceeds the exported "
                             "signature %d" % (S, self.sig_len))
        rows = []
        for lo in range(0, B, self.sig_batch):
            chunk = tokens[lo:lo + self.sig_batch]
            buf = np.zeros((self.sig_batch, self.sig_len), np.int64)
            buf[:len(chunk), :S] = chunk
            t = torch.as_tensor(buf, device=self.device).to(
                torch_dtype(self._dtype))
            logits = self._call(t, _phase=phase)         # (Bs, Ss, V)
            self.replays += 1
            self.vocab = logits.shape[-1]
            rows.append(_rows_at(logits[:len(chunk)],
                                 lengths[lo:lo + self.sig_batch]))
        return torch.cat(rows, 0)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class Engine:
    """Owns the cache pool, the device and the shape buckets.
    Thread-compatible, not thread-safe: all compute entry points (`start`,
    `prefill_step`, `decode_step`) must be called from one serving thread.

    `paged` (None: MXNET_PAGED_ATTENTION) picks the kernel path;
    `kv_quant`, `weight_quant`, `draft`/`spec`/`spec_k` and
    `prefix_cache` are the options of the module docstring, each None
    for its environment default. On CUDA a paged engine whose shapes the
    kernel does not take (decode, the prefill chunk, the k+1 scoring
    width, over the float or int8 pool, per tp shard) raises here, at
    construction, naming the limit; it never switches to another path
    behind the caller's back.

    `tp` (None: MXNET_SERVING_TP) shards the engine over the window
    `devices` (default: every CUDA device; a device may repeat), and the
    engine's device is the window's first. Placement flags are read at
    construction only and frozen afterwards: assigning one of
    `_FROZEN_FLAGS` on a live engine raises.

    `aot_cache=` names a directory for the process-wide AOT cache
    (mxnet_tpu_torch/aot; None defers to MXNET_AOT_CACHE_DIR), configured
    before this engine's first step so the kernel libraries its steps
    load come from it. A full-forward model (`BlockLM`, `ExportedLM`)
    runs on its own device unless `device=` names one."""

    #: flags the pools, the weights' placement and the step bodies derive
    #: from, fixed at construction
    _FROZEN_FLAGS = frozenset(
        ("paged", "paged_requested", "prefill_chunk", "tp",
         "tp_requested", "mesh", "prefix_cache", "aot_cache", "spec",
         "spec_requested", "spec_k", "draft", "kv_quant",
         "kv_quant_requested", "weight_quant"))

    def __init__(self, model, max_batch=8, max_len=None, block_size=16,
                 num_blocks=None, keep_logits=False, paged=None,
                 prefill_chunk=None, tp=None, devices=None, device=None,
                 prefix_cache=None, aot_cache=None, draft=None, spec=None,
                 spec_k=None, kv_quant=None, weight_quant=None):
        from .tp import (serving_tp, tp_fallback_reason, build_tp_mesh,
                         tp_cache_variant)
        from .. import aot
        # the process-wide AOT cache (the watchdog's seam is process-wide
        # too), resolved before any step of this engine runs
        if aot_cache is not None:
            aot.configure(str(aot_cache))
        self.aot_cache = aot.cache_dir()
        uses_cache = model.uses_cache
        # tensor parallel: tp > 1 implies the paged path (the gather
        # oracle is single-device); a config the window cannot shard
        # serves at tp=1 with its reason on `tp_fallback`
        tp_req = serving_tp() if tp is None else int(tp)
        if tp_req < 1:
            raise MXNetError("tp must be >= 1, got %d" % tp_req)
        self.tp_requested = tp_req
        self.tp_fallback = None
        self.tp = 1
        self.mesh = None
        if tp_req > 1 and paged is False:
            self.tp_fallback = ("paged=False pins the single-device "
                                "gather oracle")
            tp_req = 1
        if tp_req > 1 and not uses_cache:
            self.tp_fallback = ("model family has no cache hooks "
                                "(BlockLM/ExportedLM run single-device)")
            tp_req = 1
        if not uses_cache and device is None and not devices:
            device = model.device
        if devices:
            # the window's first device is the engine's
            first = resolve_device(devices[0])
            if device is not None and resolve_device(device) != first:
                raise MXNetError(
                    "device %s is not the window's first device %s"
                    % (device, first))
            device = first
        self.device = resolve_device(device)
        self.model = model
        self.max_batch = max_batch
        self.max_len = int(max_len or model.max_len)
        self.keep_logits = keep_logits
        self._sigs = set()
        # the compiles and AOT-cache loads this engine's calls paid, by
        # side, through the watchdog's per-thread seam (`_count`): engines
        # sharing one adapter never absorb each other's
        self._compile_counts = {"prefill": 0, "decode": 0}
        self._warm_counts = {"prefill": 0, "decode": 0}
        self.paged_requested = tp_req > 1 or (
            paged_enabled() if paged is None else bool(paged))
        self.paged = self.paged_requested and uses_cache
        if tp_req > 1:
            reason = tp_fallback_reason(model.cfg, self.paged, tp_req,
                                        devices)
            if reason is not None:
                self.tp_fallback = reason
            else:
                self.mesh = build_tp_mesh(tp_req, devices)
                self.tp = tp_req
        if self.tp_fallback is not None:
            telemetry.flight().record(
                "event", "serving.tp_fallback",
                requested=self.tp_requested, reason=self.tp_fallback)
        self.prefill_chunk = 0
        if uses_cache:
            nl, nh, dh, dt = model.cache_spec()
        self._nblk = max(1, math.ceil(self.max_len / block_size))
        if num_blocks is None:
            num_blocks = max_batch * self._nblk + 1
        if self.paged:
            self.prefill_chunk = min(self.max_len,
                                     int(prefill_chunk or 2 * block_size))

        # quantized serving: precision against the float oracle
        kvq_req = (quantized_kv_enabled() if kv_quant is None
                   else bool(kv_quant))
        wq_req = (quantized_weights_env() if weight_quant is None
                  else (weight_quant or None))
        self.kv_quant_requested = kvq_req
        self.kv_quant = False
        self.kv_quant_fallback = None
        self.weight_quant = None
        self.weight_quant_fallback = None
        if wq_req is not None:
            if not hasattr(model, "quantize_weights"):
                self.weight_quant_fallback = (
                    "model family has no weight hooks (BlockLM/ExportedLM "
                    "serve their own parameters in float)")
            else:
                model.quantize_weights(str(wq_req))
                self.weight_quant = str(wq_req)
        if kvq_req:
            if not uses_cache:
                self.kv_quant_fallback = ("model family has no cache hooks "
                                          "(int8 KV needs the paged pool)")
            elif self.paged:
                self.kv_quant = True
            else:
                self.kv_quant_fallback = (
                    "int8 KV needs the paged path (MXNET_PAGED_ATTENTION=1 "
                    "/ Engine(paged=True)); the gather oracle reads the "
                    "float pool")

        # speculative decoding: speed, never tokens
        self.spec_requested = (bool(spec) if spec is not None
                               else (_spec.spec_decode_enabled()
                                     or draft is not None))
        self.spec_k = int(spec_k) if spec_k is not None else _spec.spec_k()
        if self.spec_k < 1:
            raise MXNetError("spec_k must be >= 1, got %d" % self.spec_k)
        self.spec = False
        self.spec_fallback = None
        self.draft = None
        self.chaos_spec_poison = False   # armed per-iteration by the
                                         # serving loop's chaos seam
        self.last_spec = None            # the latest pass's accounting
        self.spec_passes = 0
        self.spec_proposed_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_fallbacks = 0
        d = None
        if self.spec_requested:
            d = _spec.build_draft(draft, model)
            self.spec_fallback = _spec.spec_fallback_reason(model, d,
                                                            self.paged)
            self.spec = self.spec_fallback is None
        self.cache = None
        self.prefix_cache = None
        self.prefix_cache_fallback = None
        want_prefix = (prefix_cache_enabled() if prefix_cache is None
                       else bool(prefix_cache))
        if not uses_cache:
            if want_prefix:
                self.prefix_cache_fallback = (
                    "model family has no cache hooks (prefix reuse needs "
                    "the paged KV pool)")
            self._constructed = True
            return

        if self.paged and self.device.type == "cuda":
            # the Hopper gate; a tp shard's kernel sees the same
            # head_dim, block and query rows over H/k heads
            pool_dt = torch.int8 if self.kv_quant else dt
            widths = [("paged=True", 1), ("paged=True", self.prefill_chunk)]
            if self.spec:
                widths.append(("spec_k=%d" % self.spec_k, self.spec_k + 1))
            where = (str(self.device) if self.mesh is None
                     else tp_cache_variant(self.mesh))
            for what, tq in widths:
                limit = paged_limit(dh, block_size, tq, dt, pool_dt)
                if limit is not None:
                    raise MXNetError(
                        "%s%s on %s: the paged-attention kernel does not "
                        "take this config: %s"
                        % (what, " kv_quant=True" if self.kv_quant else "",
                           where, limit))
        model.bind(block_size, self.device)
        if self.mesh is not None:
            model.bind_tp(self.mesh)
        if self.spec:
            self.draft = d.to(self.device)
        self.cache = PagedKVCache(nl, nh, dh, block_size=block_size,
                                  num_blocks=num_blocks, dtype=dt,
                                  device=self.device,
                                  kv_dtype="int8" if self.kv_quant else None,
                                  devices=self.mesh)

        # prefix cache: which blocks a table points at, never logits
        if want_prefix:
            if self.paged:
                self.prefix_cache = PrefixCache(self.cache.pool, block_size)
            else:
                self.prefix_cache_fallback = (
                    "prefix reuse needs the chunked-prefill paged path "
                    "(MXNET_PAGED_ATTENTION=1 / Engine(paged=True)); the "
                    "gather oracle prefills whole prompts")
        self._constructed = True

    def __setattr__(self, name, value):
        if name in self._FROZEN_FLAGS and \
                getattr(self, "_constructed", False):
            raise MXNetError(
                "Engine.%s is fixed at construction (the pools, the "
                "weights' placement and the step bodies derive from it); "
                "build a new Engine instead of mutating a live one" % name)
        object.__setattr__(self, name, value)

    def _tensor(self, arr):
        return torch.as_tensor(arr, device=self.device)

    def _scales(self):
        """(k_scale, v_scale) of an int8 pool, (None, None) otherwise (per
        shard tuples on a tp engine)."""
        return self.cache.k_scale, self.cache.v_scale

    # -- admission accounting ------------------------------------------------

    def blocks_needed(self, prompt_len, max_new):
        if self.cache is None:
            return 0
        total = min(self.max_len, prompt_len + max_new)
        return self.cache.blocks_for(total)

    def can_admit(self, prompt_len, max_new):
        """Would this request's block reservation fit right now? Cached
        blocks no reader holds count as available: `try_alloc` reclaims
        them on demand. Raises MXNetError for a prompt that can never be
        served."""
        if prompt_len > self.max_len:
            raise MXNetError("prompt length %d exceeds max_len %d"
                             % (prompt_len, self.max_len))
        if self.cache is None:
            return True
        avail = self.cache.pool.available
        if self.prefix_cache is not None:
            avail += self.prefix_cache.reclaimable_blocks()
        return self.blocks_needed(prompt_len, max_new) <= avail

    def cache_utilization(self):
        return self.cache.utilization() if self.cache is not None else None

    @property
    def prefill_compilations(self):
        """Prefill-path compiles THIS engine's calls paid, counted by the
        compile watchdog at the step sites: each first run of a (chunk,
        width) or length bucket, and any kernel library built inside
        one."""
        return self._compile_counts["prefill"]

    @property
    def decode_compilations(self):
        """Decode-side compiles (decode, draft, spec scoring); see
        `prefill_compilations`."""
        return self._compile_counts["decode"]

    @property
    def prefill_warm_loads(self):
        """Kernel libraries this engine's prefill calls loaded from the
        AOT cache (mxnet_tpu_torch/aot) instead of building."""
        return self._warm_counts["prefill"]

    @property
    def decode_warm_loads(self):
        """Decode-side warm loads (see `prefill_warm_loads`)."""
        return self._warm_counts["decode"]

    @property
    def warm_loads(self):
        """Everything this engine loaded from the AOT cache: the router's
        warm-replica gauge counts replicas where it is positive."""
        return sum(self._warm_counts.values())

    @contextlib.contextmanager
    def _count(self, kind, sig):
        """Bracket one model step call: record its (kind, shape)
        signature in `_sigs` and add the compiles and warm loads the call
        paid — per-thread attribution, so a sibling engine sharing the
        adapter never inflates these counters — to this engine's tally
        ("prefill", else the decode side)."""
        self._sigs.add((kind, sig))
        side = "prefill" if kind == "prefill" else "decode"
        mark = _introspect.dispatch_mark()
        wmark = _introspect.dispatch_warm_mark()
        try:
            yield
        finally:
            # a call that compiled and then FAILED still paid the compile
            self._compile_counts[side] += \
                _introspect.dispatch_compiles_since(mark)
            self._warm_counts[side] += \
                _introspect.dispatch_warm_loads_since(wmark)

    def kv_bytes_per_token(self):
        """Bytes of KV-cache one token occupies (K and V, every layer):
        the int8 payload plus the float32 scales amortized over a block's
        tokens on a quantized pool; 0 for a model without a cache."""
        if self.cache is None:
            return 0
        nl, nh, dh, dt = self.model.cache_spec()
        if self.cache.quantized:
            scale_bytes = math.ceil(2 * nl * nh * 4
                                    / float(self.cache.block_size))
            return 2 * nl * nh * dh + scale_bytes
        return 2 * nl * nh * dh * torch.empty((), dtype=dt).element_size()

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
        if self.cache is None:
            return seq
        n = self.blocks_needed(L, max_new)
        if self.prefix_cache is None:
            ids = self.cache.pool.try_alloc(n)
            if ids is not None and self.kv_quant:
                self._zero_scales(ids)
        else:
            ids = self._begin_cached(seq, prompt, n)
        if ids is None:
            return None
        seq.block_ids = ids
        seq.table_row = self.cache.table_row(ids, self._nblk)
        return seq

    def _zero_scales(self, ids):
        """Reset the int8 pool's scales of freshly allocated (possibly
        reclaimed) blocks: the per-block scale is a monotonic max, so a
        previous occupant's scale would make the new tokens' step too
        coarse."""
        if ids:
            idx = self._tensor(np.asarray(ids, np.int64))
            for _, _, ks, vs in self.cache.shards():
                zero_block_scales(ks, vs, idx.to(ks.device))

    def _begin_cached(self, seq, prompt, n):
        """Prefix-cache admission: point the leading table entries at
        resident shared blocks (refs taken by the lookup), allocate the
        rest fresh, and COW-copy a partially matched tail block — this
        request WILL write into it, and a reader must never mutate a
        shared block. Skipped prefix tokens start `seq.prefilled` past
        zero, so whole prefill chunks never run. Returns the table's id
        list, or None on transient exhaustion (all refs dropped)."""
        pool = self.cache.pool
        with telemetry.span("prefix.lookup", category="serving",
                            prompt_len=len(prompt)):
            full, tail = self.prefix_cache.lookup(prompt)
        fresh = pool.try_alloc(n - len(full))
        if fresh is None:
            held = full + ([tail[0]] if tail else [])
            if held:
                pool.free(held)
            return None
        if self.kv_quant:
            # fresh blocks first: a COW copy below then installs the
            # shared block's scales over fresh[0]
            self._zero_scales(fresh)
        hit = len(full) * self.cache.block_size
        if tail is not None:
            src, m = tail
            for k, v, ks, vs in self.cache.shards():
                if self.kv_quant:
                    copy_block_quant(k, v, ks, vs, src, fresh[0])
                else:
                    copy_block(k, v, src, fresh[0])
            pool.free([src])          # the private copy replaces the
                                      # shared block in the table
            self.prefix_cache.cow_copies += 1
            hit += m
        seq.prefilled = hit
        seq.cache_hit_tokens = hit
        seq.shared_blocks = len(full)
        return full + fresh

    def prefill_tokens_per_step(self, prompt_len):
        """Tokens one `prefill_step` call will process — the scheduler's
        token-budget admission cost. Fixed chunk on the paged path; the
        whole (bucketed) prompt in one shot on the gather path."""
        if self.paged:
            return self.prefill_chunk
        return pow2_bucket(prompt_len, lo=1, hi=self.max_len)

    def _full_step(self, kind, toks, lens):
        """One full-forward step of a cache-free model over a (B, S)
        token batch: float32 logits (B, V) at each row's lengths-1, as a
        torch tensor."""
        with self._count(kind, toks.shape):
            return self.model.step_full(toks, lens, phase=kind)

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
            if self.cache is None:
                s_pad = pow2_bucket(L, lo=1, hi=self.max_len)
                toks = np.zeros((1, s_pad), np.int64)
                toks[0, :L] = prompt
                logits = self._full_step("prefill", toks,
                                         np.asarray([L], np.int64))[0]
                seq.prefilled = L
            elif self.paged:
                C = self.prefill_chunk
                qs = seq.prefilled
                toks = np.zeros((C,), np.int64)
                toks[:min(C, L - qs)] = prompt[qs:qs + C]
                w = pow2_bucket(self.cache.blocks_for(qs + C),
                                lo=1, hi=self._nblk)
                chunk_fn = self.model.prefill_chunk_tp if self.tp > 1 \
                    else self.model.prefill_chunk
                with self._count("prefill", (C, w)):
                    logits = chunk_fn(
                        self.cache.k, self.cache.v, self._tensor(toks), qs,
                        L, min(L - 1 - qs, C - 1),
                        self._tensor(seq.table_row[:w]), *self._scales())
                seq.prefilled = min(L, qs + C)
                if seq.prefilled < L:
                    return False
                if self.prefix_cache is not None:
                    # the full prompt blocks are immutable from here on:
                    # register them now so a same-prefix burst hits while
                    # this request still decodes; the partial tail stays
                    # private until release
                    self.prefix_cache.insert(prompt, seq.block_ids, L)
            else:
                s_pad = pow2_bucket(L, lo=min(8, self.max_len),
                                    hi=self.max_len)
                toks = np.zeros((s_pad,), np.int64)
                toks[:L] = prompt
                with self._count("prefill", s_pad):
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
        steps. A prefill that raises releases the sequence's blocks (not
        for reuse) before the error propagates, so the pool stays whole."""
        seq = self.begin(prompt, max_new, eos_id=eos_id)
        if seq is None:
            return None
        try:
            while not self.prefill_step(seq):
                pass
        except BaseException:
            self.release(seq, reusable=False)
            raise
        return seq

    # -- decode --------------------------------------------------------------

    def decode_tokens_per_step(self):
        """Tokens one decode iteration SCORES per running sequence — the
        scheduler's budget cost: k+1 for a speculating engine, else 1."""
        return self.spec_k + 1 if self.spec else 1

    def decode_step(self, seqs):
        """Advance every sequence in `seqs` (one batched step over the
        power-of-two padded batch). A plain engine emits one token per
        sequence; a speculating one 1..k+1, token-identical to the plain
        path. A draft fault (non-finite draft logits) degrades THIS batch
        to the plain step. Returns the sequences it advanced."""
        seqs = [s for s in seqs if not s.done]
        if not seqs:
            return []
        if len(seqs) > self.max_batch:
            raise MXNetError("decode batch %d exceeds max_batch %d"
                             % (len(seqs), self.max_batch))
        bb = pow2_bucket(len(seqs), lo=1, hi=self.max_batch)
        if self.spec:
            out = self._spec_decode_step(seqs, bb)
            if out is not None:
                return out
        t0_us = time.perf_counter_ns() // 1000
        with telemetry.span("serving.decode", category="serving",
                            batch=len(seqs)):
            if self.cache is None:
                logits, nxt = self._full_decode(seqs, bb)
            else:
                logits, nxt = self._cached_decode(seqs, bb)
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
                                      to_profiler=False, to_flight=False,
                                      position=len(s.tokens) - 1)
        return seqs

    def _full_decode(self, seqs, bb):
        """A cache-free model's decode step: the whole history of each
        sequence, padded to a (bb, pow2 length) batch, in one full
        forward. Returns (logits or None, next tokens) on the host."""
        s_pad = pow2_bucket(max(len(s.tokens) for s in seqs), lo=1,
                            hi=self.max_len)
        toks = np.zeros((bb, s_pad), np.int64)
        lens = np.ones((bb,), np.int64)
        for i, s in enumerate(seqs):
            toks[i, :len(s.tokens)] = s.tokens
            lens[i] = len(s.tokens)
        logits = self._full_step("decode", toks, lens)
        nxt = logits.argmax(-1).cpu().numpy()
        return (logits.cpu().numpy() if self.keep_logits else None), nxt

    def _cached_decode(self, seqs, bb):
        """The pool's decode step (paged or gather). Returns (logits or
        None, next tokens) on the host."""
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
        args = (self.cache.k, self.cache.v, self._tensor(toks),
                self._tensor(pos), self._tensor(tabs))
        with self._count("decode", (bb, w) if self.paged else bb):
            if self.paged:
                # one device, or sharded over the tp window
                step_fn = self.model.decode_tp if self.tp > 1 \
                    else self.model.decode_paged
                logits = step_fn(*args, *self._scales())
            else:
                logits = self.model.decode(*args)
        nxt = logits.argmax(-1).cpu().numpy()
        return (logits.cpu().numpy() if self.keep_logits else None), nxt

    def _draft_propose(self, seqs, bb, k, poison=False):
        """k greedy steps of the cache-free draft over the (bucketed)
        batch of token histories. Returns (draft (B, k) int64, per-sequence
        proposal counts), or None when the draft emitted non-finite
        logits (`poison` NaN-fills them: the serving loop's chaos seam).
        Sequences within one token of max_total get a shorter (possibly
        empty) proposal: the bonus token takes the last slot."""
        d = self.draft
        B = len(seqs)
        hist = [list(s.tokens) for s in seqs]
        nbs = [max(0, min(k, s.max_total - len(s.tokens) - 1))
               for s in seqs]
        out = np.zeros((B, k), np.int64)
        for j in range(max(nbs)):
            s_pad = pow2_bucket(max(len(h) for h in hist),
                                lo=min(8, d.max_len), hi=d.max_len)
            toks = np.zeros((bb, s_pad), np.int64)
            lens = np.ones((bb,), np.int64)
            for i, h in enumerate(hist):
                toks[i, :len(h)] = h
                lens[i] = len(h)
            with self._count("draft", (bb, s_pad)):
                logits = d.logits_at(self._tensor(toks),
                                     self._tensor(lens))[:B]
            if poison:
                logits = torch.full_like(logits, float("nan"))
            if not bool(torch.isfinite(logits).all()):
                return None
            nxt = logits.argmax(-1).cpu().numpy()
            for i in range(B):
                if j < nbs[i]:
                    out[i, j] = nxt[i]
                    hist[i].append(int(nxt[i]))
        return out, nbs

    def _spec_decode_step(self, seqs, bb):
        """One speculative iteration: the draft proposes, the target
        scores all k+1 positions in ONE paged pass against the live block
        tables, greedy verification accepts a prefix (plus the target's
        own token at the first disagreement, plus a bonus on a full
        sweep). Emitted tokens are exactly the plain greedy path's.
        Returns the advanced seqs, or None to degrade this batch to the
        plain step (draft fault)."""
        k = self.spec_k
        C = k + 1
        poison, self.chaos_spec_poison = self.chaos_spec_poison, False
        t0_us = time.perf_counter_ns() // 1000
        with telemetry.span("serving.spec", category="serving",
                            batch=len(seqs), k=k):
            drafted = self._draft_propose(seqs, bb, k, poison)
            if drafted is None:
                self.spec_fallbacks += 1
                self.last_spec = {"fallback": True, "batch": len(seqs)}
                return None
            draft, nbs = drafted
            B = len(seqs)
            w = pow2_bucket(
                max(self.cache.blocks_for(len(s.tokens) + k)
                    for s in seqs), lo=1, hi=self._nblk)
            toks = np.zeros((bb, C), np.int64)
            qs = np.zeros((bb,), np.int32)
            counts = np.zeros((bb,), np.int32)
            tabs = np.zeros((bb, w), np.int32)
            for i, s in enumerate(seqs):
                toks[i, 0] = s.tokens[-1]
                toks[i, 1:1 + nbs[i]] = draft[i, :nbs[i]]
                qs[i] = len(s.tokens) - 1
                counts[i] = 1 + nbs[i]
                tabs[i] = s.table_row[:w]
            score_fn = self.model.spec_score_tp if self.tp > 1 \
                else self.model.spec_score
            with self._count("spec", (bb, w)):
                logits = score_fn(
                    self.cache.k, self.cache.v, self._tensor(toks),
                    self._tensor(qs), self._tensor(counts),
                    self._tensor(tabs), *self._scales())         # (bb,C,V)
            am = logits.argmax(-1).cpu().numpy()
            logits = logits.cpu().numpy() if self.keep_logits else None
            accepted = proposed = emitted_n = 0
            dur_us = time.perf_counter_ns() // 1000 - t0_us
            for i, s in enumerate(seqs):
                emitted, acc = _spec.greedy_verify(am[i], draft[i], nbs[i])
                accepted += acc
                proposed += nbs[i]
                for j, tok in enumerate(emitted):
                    if s.done:
                        break
                    if logits is not None:
                        s.last_logits = logits[i, j]
                        s.token_logits.append(logits[i, j])
                    self._append(s, int(tok))
                    emitted_n += 1
                    if s.request is not None:
                        telemetry.record_span(
                            "serving.decode", t0_us, dur_us,
                            trace=s.request.trace, category="serving",
                            to_profiler=False, to_flight=False,
                            position=len(s.tokens) - 1)
        self.spec_passes += 1
        self.spec_proposed_tokens += proposed
        self.spec_accepted_tokens += accepted
        self.last_spec = {"fallback": False, "batch": B,
                          "proposed": proposed, "accepted": accepted,
                          "emitted": emitted_n}
        return seqs

    def _append(self, seq, token):
        seq.tokens.append(token)
        if (seq.eos_id is not None and token == seq.eos_id) \
                or len(seq.tokens) >= seq.max_total:
            seq.done = True

    # -- end of life ---------------------------------------------------------

    def release(self, seq, reusable=True):
        """Recycle a finished sequence's cache blocks. With the prefix
        cache on, everything whose KV is now immutable (full blocks over
        prompt and generated tokens, plus the final partial tail) is
        registered for reuse first; `reusable=False` skips that, and so
        does a release in mid-prefill."""
        if seq.block_ids and self.cache is not None:
            if reusable and self.prefix_cache is not None and \
                    seq.prefilled >= seq.prompt_len:
                # the final token was appended but its KV never written:
                # only tokens[:-1] are content-addressable
                self.prefix_cache.insert(seq.tokens, seq.block_ids,
                                         len(seq.tokens) - 1,
                                         partial_ok=True)
            self.cache.pool.free(seq.block_ids)
            seq.block_ids = []

    def audit_quiescent(self):
        """Leak audit: with no sequence in flight every allocated block
        must be a prefix-cache resident pinned by the cache's own ref
        only. Raises MXNetError listing the leaked ids."""
        if self.cache is None:
            return
        resident = []
        if self.prefix_cache is not None:
            resident = [e.block_id
                        for e in self.prefix_cache._by_hash.values()]
        self.cache.pool.assert_quiescent(resident)

    def close(self, audit=True):
        """End-of-life seam: with `audit=True` run the leak audit."""
        if audit:
            self.audit_quiescent()
