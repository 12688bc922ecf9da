"""Tensor-parallel serving: one engine's transformer sharded over a window
of devices driven by ONE process (port of `mxnet_tpu/serving/tp.py`).

`MXNET_SERVING_TP=k` (or `Engine(tp=k, devices=[...])`) shards one engine
replica's weights and KV block pool over a window of k devices:

* Weights shard Megatron-style (`place_tp_params`): wqkv column-parallel
  over heads (head-major, `reorder_qkv_heads`), wo row-parallel, FFN w1
  column / w2 row. Embeddings, layer norms and the LM head are
  replicated, one copy per shard.
* The KV block pool shards over the HEAD axis: k separate contiguous
  (L, num_blocks, block_size, H/k, Dh) tensors, one per window device
  (and, on an int8 pool, (L, num_blocks, H/k) scales beside each). Block
  tables stay host-side integers, uploaded once per device per step, so
  the free list, the prefix cache and the scheduler are untouched.
* The step bodies run once per shard, under `torch.cuda.device(dev_j)`:
  each shard writes its own heads' K/V, runs the paged-attention kernel
  (ops/paged_attention.py) over its own pool, and computes its partial
  output and FFN projections. The two reductions a layer copy every
  shard's partial to every window device (`.to(dev, non_blocking=True)`,
  a no-op where the devices coincide) and sum them there in the fixed
  order 0..k-1, so the residual stream is bit-identical on every shard
  and the logits (and the argmax) come from shard 0.

The reference runs the same engine under `shard_map` over a `{'tp': k}`
mesh with `psum`; here one Python thread issues every shard's launches
and the reductions are peer copies, so the scheduler, the block pool and
speculative decoding stay as they are and a tp replica is still one
`LMServer`. A window may repeat a device (`devices=["cuda:0"] * 2`): the
shards then share one card, as the reference's tests share 8 virtual CPU
devices, and every shard's kernel and both reductions still run.

Fallback semantics: the flag switches PLACEMENT, never logits. A config
the tp path cannot shard (heads or d_ff not divisible by k, MoE FFN,
fewer than k devices in the window, the gather path) serves at tp=1 with
the reason on `Engine.tp_fallback`. Read at Engine construction only.
"""
from __future__ import annotations

import contextlib
import os

import torch

from ..base import MXNetError, resolve_device
from ..models.transformer import _layer_norm
from ..ops.quantization import maybe_quant_matmul as _mm, \
    quantize_channelwise
from .engine import _head, _write_attend

#: the serving mesh axis name, the training mesh's tensor axis too
TP_AXIS = "tp"

#: the four matmul weights of a layer, by how they shard: column-parallel
#: weights split their output columns, row-parallel ones their input rows
_COL = ("wqkv", "w1")
_ROW = ("wo", "w2")


def serving_tp():
    """MXNET_SERVING_TP, read when an Engine is constructed. 1/unset =
    one device."""
    env = os.environ.get("MXNET_SERVING_TP")
    return int(env) if env else 1


def serving_devices():
    """The serving default window: every CUDA device of this process
    (empty without CUDA: nothing falls back to the CPU unasked)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def tp_fallback_reason(cfg, paged, tp, devices=None):
    """Why a tp>1 request must fall back to tp=1 (None = shardable). The
    window's ENTRIES are counted, so a repeated device counts as the
    reference's virtual devices do. Placement-only fallback: the served
    logits are the same either way."""
    if not paged:
        return ("paged path off/ineligible; the gather oracle is "
                "single-device")
    if cfg.n_experts:
        return "MoE FFN is not tp-sharded; serve dense-FFN configs"
    if cfg.n_heads % tp:
        return "n_heads %d not divisible by tp=%d" % (cfg.n_heads, tp)
    if cfg.d_ff % tp:
        return "d_ff %d not divisible by tp=%d" % (cfg.d_ff, tp)
    n = len(devices if devices is not None else serving_devices())
    if n < tp:
        return "tp=%d needs %d devices, have %d" % (tp, tp, n)
    return None


def build_tp_mesh(tp, devices=None):
    """The window: the first `tp` entries of `devices` (default: every
    CUDA device) as torch.devices, all of one device type."""
    devs = [resolve_device(d) for d in
            (serving_devices() if devices is None else devices)][:tp]
    if len(devs) < tp:
        raise MXNetError("tp=%d needs %d devices, have %d"
                         % (tp, tp, len(devs)))
    if len({d.type for d in devs}) != 1:
        raise MXNetError("a tp window must hold one device type, got %s"
                         % [str(d) for d in devs])
    return devs


def tp_cache_variant(mesh):
    """Variant tag of one window: the tp degree and the device indices
    ("tp2@0,1"; "tp2@0,0" on a window that repeats cuda:0), the key that
    keeps two replicas' cached steps apart."""
    ids = ",".join(str(d.index) if d.index is not None else d.type
                   for d in mesh)
    return "tp%d@%s" % (len(mesh), ids)


def reorder_qkv_heads(wqkv, n_heads):
    """Rewrite a fused (D, 3D) QKV projection from qkv-major columns
    ([q all heads | k all heads | v all heads]) to HEAD-major ([head0:
    q,k,v | head1: q,k,v | ...]) so a contiguous column shard is exactly
    the q/k/v projections of H/k whole heads."""
    D = wqkv.shape[0]
    Dh = D // n_heads
    return wqkv.reshape(D, 3, n_heads, Dh).permute(0, 2, 1, 3) \
        .reshape(D, 3 * D)


def place_tp_params(params, cfg, mesh):
    """k per-shard param dicts, dict j on window device j: wqkv head-major
    with the columns of heads [j H/k, (j+1) H/k), wo the matching rows,
    w1 a column block and w2 the matching rows; everything else (the
    embeddings, norms and LM head) replicated. The caller's params stay
    untouched."""
    k = len(mesh)
    out = [{} for _ in range(k)]
    split = {}
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        split[pre + "wqkv"] = (reorder_qkv_heads(params[pre + "wqkv"],
                                                 cfg.n_heads), 1)
        split[pre + "w1"] = (params[pre + "w1"], 1)
        split[pre + "wo"] = (params[pre + "wo"], 0)
        split[pre + "w2"] = (params[pre + "w2"], 0)
    for name, value in params.items():
        if isinstance(value, dict):
            raise MXNetError("tp serving: %r is quantized; place the float "
                             "weights and quantize the shards "
                             "(quantize_tp_params)" % name)
        if name in split:
            w, dim = split[name]
            parts = torch.chunk(w, k, dim=dim)
        else:
            parts = [value] * k
        for j, dev in enumerate(mesh):
            out[j][name] = parts[j].to(dev).contiguous()
    return out


def _quant_shard(w):
    """Per-output-channel symmetric int8 of ONE local weight shard: the
    amax never looks past the shard's own rows."""
    return quantize_channelwise(w, axis=1)


def quantize_tp_params(shards, cfg):
    """Quantize the four matmul weights AFTER placement: each shard
    quantizes its own block. A column-parallel shard gets the scales of
    its own output columns (equal to a whole-weight quantization's); a
    row-parallel shard's per-output-channel scales come from its OWN rows
    only, so they differ shard by shard and each shard dequantizes its
    partial before the reduction. Returns new dicts; norms, embeddings
    and the head pass through."""
    out = []
    for sh in shards:
        q = dict(sh)
        for i in range(cfg.n_layers):
            pre = "layer%d_" % i
            for name in _COL + _ROW:
                qw, s = _quant_shard(sh[pre + name])
                q[pre + name] = {"q": qw, "s": s}
        out.append(q)
    return out


# ---------------------------------------------------------------------------
# the sharded step bodies: every shard runs on its own device; the
# residual stream is kept once per distinct window device
# ---------------------------------------------------------------------------


def _on(dev):
    """The launch context of one shard's device."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _distinct(mesh):
    return list(dict.fromkeys(mesh))


def _per_device(t, mesh):
    """One copy of a host-built index tensor on every distinct window
    device (the first is the tensor itself when it lies there)."""
    return {d: t.to(d, non_blocking=True) for d in _distinct(mesh)}


def _reduce_add(x, parts, mesh):
    """The tp all-reduce: x[d] + sum_j parts[j] on every distinct window
    device d, the partials copied over and summed in the fixed order
    0..k-1, so every device's residual stream carries the same bits."""
    out = {}
    for d in x:
        with _on(d):
            acc = parts[0].to(d, non_blocking=True)
            for p in parts[1:]:
                acc = acc + p.to(d, non_blocking=True)
            out[d] = x[d] + acc
    return out


def _local_qkv(h, wqkv_local, Dh):
    """h (N, D) @ a head-major wqkv shard -> q, k, v (N, H/k, Dh) each,
    contiguous (the kernel checks its operands)."""
    N = h.shape[0]
    qkv = _mm(h, wqkv_local).reshape(N, -1, 3, Dh)
    return (qkv[:, :, 0].contiguous(), qkv[:, :, 1].contiguous(),
            qkv[:, :, 2].contiguous())


def _tp_layers(shards, mesh, k_pools, v_pools, k_scales, v_scales, x,
               slots, tables, q_start, q_rows, cfg, block_size):
    """Every layer over the window: x {device: (N, D)} the replicated
    residual stream; slots/tables/q_start {device: tensor}; the kernel
    sees each shard's q as (*q_rows, H/k, Dh). Returns x."""
    Dh = cfg.d_model // cfg.n_heads
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        parts = []
        for j, (p, d) in enumerate(zip(shards, mesh)):
            with _on(d):
                xd = x[d]
                h = _layer_norm(xd, p[pre + "ln1_g"], p[pre + "ln1_b"])
                q, kh, vh = _local_qkv(h, p[pre + "wqkv"], Dh)
                att = _write_attend(
                    k_pools[j], v_pools[j],
                    None if k_scales is None else k_scales[j],
                    None if v_scales is None else v_scales[j], i, slots[d],
                    kh, vh, q.reshape(*q_rows, -1, Dh), tables[d],
                    q_start[d], block_size)
                parts.append(_mm(att.reshape(xd.shape[0], -1),
                                 p[pre + "wo"]))
        x = _reduce_add(x, parts, mesh)
        parts = []
        for p, d in zip(shards, mesh):
            with _on(d):
                h = _layer_norm(x[d], p[pre + "ln2_g"], p[pre + "ln2_b"])
                parts.append(_mm(torch.relu(_mm(h, p[pre + "w1"])),
                                 p[pre + "w2"]))
        x = _reduce_add(x, parts, mesh)
    return x


def _embed(shards, mesh, toks, pos):
    """The replicated embedding, once per distinct window device, from
    the first shard that lives there."""
    x = {}
    for p, d in zip(shards, mesh):
        if d not in x:
            with _on(d):
                x[d] = p["embed"][toks[d]] + p["pos_embed"][pos[d]]
    return x


def _decode_body(shards, mesh, k_pools, v_pools, tokens, positions, tables,
                 cfg, block_size, k_scales=None, v_scales=None):
    """The window's half of `engine._tf_decode_paged`: same contract
    (tokens (B,), positions (B,) int32, tables (B, w) int32 on window
    device 0; logits (B, V) float32 back), each shard over its own heads
    and pool."""
    from .kv_cache import flat_slots
    toks = _per_device(tokens, mesh)
    pos = _per_device(positions, mesh)
    tabs = _per_device(tables, mesh)
    x = _embed(shards, mesh, toks, pos)
    slots = {d: flat_slots(tabs[d], pos[d], block_size) for d in tabs}
    B = tokens.shape[0]
    x = _tp_layers(shards, mesh, k_pools, v_pools, k_scales, v_scales, x,
                   slots, tabs, pos, (B, 1), cfg, block_size)
    with _on(mesh[0]):
        return _head(shards[0], x[mesh[0]])


def _prefill_chunk_body(shards, mesh, k_pools, v_pools, toks, qs, length,
                        last_idx, table_row, cfg, block_size, k_scales=None,
                        v_scales=None):
    """The window's half of `engine._tf_prefill_chunk` (one fixed-shape
    chunk of ONE sequence): the same null-block padding, each shard over
    its own heads. Returns logits (V,) at chunk index `last_idx`."""
    C = toks.shape[0]
    w = table_row.shape[0]
    dev0 = toks.device
    pos = qs + torch.arange(C, device=dev0)
    blk = table_row.long()[(pos // block_size).clamp(max=w - 1)]
    slots = torch.where(pos < length, blk * block_size + pos % block_size,
                        pos % block_size)
    qs_row = torch.full((1,), qs, dtype=torch.int32, device=dev0)
    x = _embed(shards, mesh, _per_device(toks, mesh),
               _per_device(pos.clamp(max=cfg.max_len - 1), mesh))
    x = _tp_layers(shards, mesh, k_pools, v_pools, k_scales, v_scales, x,
                   _per_device(slots, mesh),
                   _per_device(table_row[None], mesh),
                   _per_device(qs_row, mesh), (1, C), cfg, block_size)
    with _on(mesh[0]):
        return _head(shards[0], x[mesh[0]][last_idx])


def _spec_score_body(shards, mesh, k_pools, v_pools, toks, q_starts, counts,
                     tables, cfg, block_size, k_scales=None, v_scales=None):
    """The window's half of `engine._tf_spec_score` (the k+1 scoring
    pass): the same position and null-block rules, each shard over its
    own heads. Returns logits (B, C, V) float32."""
    B, C = toks.shape
    w = tables.shape[1]
    dev0 = toks.device
    ar = torch.arange(C, device=dev0)
    pos = q_starts.long()[:, None] + ar[None, :]
    valid = ar[None, :] < counts.long()[:, None]
    blk = torch.gather(tables.long(), 1,
                       (pos // block_size).clamp(max=w - 1))
    slots = torch.where(valid, blk * block_size + pos % block_size,
                        pos % block_size).reshape(B * C)
    x = _embed(shards, mesh, _per_device(toks.reshape(B * C), mesh),
               _per_device(pos.clamp(max=cfg.max_len - 1).reshape(B * C),
                           mesh))
    x = _tp_layers(shards, mesh, k_pools, v_pools, k_scales, v_scales, x,
                   _per_device(slots, mesh), _per_device(tables, mesh),
                   _per_device(q_starts, mesh), (B, C), cfg, block_size)
    with _on(mesh[0]):
        return _head(shards[0], x[mesh[0]]).reshape(B, C, -1)
