"""Transformer language model, functional form (port of
`mxnet_tpu/models/transformer.py`, single-device paths).

The model is a flat dict of tensors plus pure functions, the same names
and layouts as the reference, so weights carry across unchanged
(`models/convert.py`) and parity reduces to comparing logits, losses and
gradients. The FFN is dense, dense-dispatch MoE or top-k MoE, as in the
reference. Training is `lm_loss` and a single-device SGD step
(`train_step`, `make_train_step`); the mesh variants (dp/tp/sp/ep, ring
attention) come with the distributed slice.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..base import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import attention_reference


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 128
    n_experts: int = 0          # 0 => dense FFN; >0 => MoE
    moe_top_k: int = 0          # 0 => dense dispatch; >0 => top-k routing
    capacity_factor: float = 1.25  # per-expert buffer over the even share
    moe_group_size: int = 4096  # GShard token grouping; <=0 => one group
    max_len: int = 128
    dtype: torch.dtype = torch.float32


def param_shapes(cfg):
    """name -> shape of every parameter of a config, in the reference's
    flat naming (MoE layers carry `wg` and an expert dimension on `w1`,
    `w2`)."""
    D, E = cfg.d_model, cfg.n_experts
    shapes = {"embed": (cfg.vocab, D), "pos_embed": (cfg.max_len, D)}
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        shapes[pre + "ln1_g"] = (D,)
        shapes[pre + "ln1_b"] = (D,)
        shapes[pre + "wqkv"] = (D, 3 * D)
        shapes[pre + "wo"] = (D, D)
        shapes[pre + "ln2_g"] = (D,)
        shapes[pre + "ln2_b"] = (D,)
        if E:
            shapes[pre + "wg"] = (D, E)
            shapes[pre + "w1"] = (E, D, cfg.d_ff)
            shapes[pre + "w2"] = (E, cfg.d_ff, D)
        else:
            shapes[pre + "w1"] = (D, cfg.d_ff)
            shapes[pre + "w2"] = (cfg.d_ff, D)
    shapes["lnf_g"] = (D,)
    shapes["lnf_b"] = (D,)
    shapes["head"] = (D, cfg.vocab)
    return shapes


def init_transformer_params(cfg, generator=None, device=None):
    """Flat dict name -> tensor: N(0, 0.02) weights, unit/zero layer
    norms, as the reference initializes. Draws come from `generator`
    (a torch.Generator on the CPU), so they differ from jax.random's;
    tests that compare the two packages carry the reference's weights
    across with `params_from_numpy` instead. `device=None` puts the
    weights on the card (raising without one); the CPU is asked for by
    `device="cpu"`."""
    device = resolve_device(device)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("_g"):
            t = torch.ones(shape)
        elif name.endswith("_b"):
            t = torch.zeros(shape)
        else:
            t = 0.02 * torch.randn(shape, generator=generator)
        out[name] = t.to(device=device, dtype=cfg.dtype)
    return out


def _layer_norm(x, g, b, eps=1e-5):
    # population variance, as jnp.var computes it (torch.var would
    # default to the unbiased estimate)
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * g + b


def flash_enabled():
    """MXNET_FLASH_ATTENTION=1, the reference's own switch, read at each
    call (the reference reads it when it traces)."""
    return os.environ.get("MXNET_FLASH_ATTENTION", "0") == "1"


def _attention(x, wqkv, wo, cfg, causal=True):
    B, S, D = x.shape
    H = cfg.n_heads
    q, k, v = torch.split(x @ wqkv, D, dim=-1)

    def heads(t):  # (B, S, D) -> (B, H, S, Dh), a transposed view
        return t.reshape(B, S, H, D // H).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    if flash_enabled():
        # the flash kernels (forward and backward); flash_attention's
        # reshape to [B*H, S, Dh] copies each view into the contiguous
        # layout the kernels read
        out = flash_attention(q, k, v, causal=causal)
    else:
        out = attention_reference(q, k, v, causal=causal)
    return out.transpose(1, 2).reshape(B, S, D) @ wo


def _moe_ffn(x, wg, w1, w2):
    """Gate-weighted dense-dispatch MoE over (B, S, D): every expert sees
    every token, outputs weighted by the full softmax gate."""
    gates = torch.softmax(x @ wg, dim=-1)                   # (B, S, E)
    h = torch.relu(torch.einsum("bsd,edf->besf", x, w1))
    y = torch.einsum("besf,efd->besd", h, w2)
    return torch.einsum("bse,besd->bsd", gates, y)


def _route_group_topk(xg, wg, w1, w2, k, capacity):
    """Route token groups xg (G, Tg, D) through top-k capacity-bounded
    experts: the reference's per-group function with its `vmap` over
    groups written as the leading batch dimension. Returns (out
    (G, Tg, D), aux (G,)). Routing bookkeeping is int32; only the masks
    cast to xg's dtype, at the einsum boundary."""
    G, Tg, D = xg.shape
    E = w1.shape[0]
    gates = torch.softmax(xg @ wg, dim=-1)                  # (G, Tg, E)
    topv, topi = torch.topk(gates, k, dim=-1)               # (G, Tg, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    sel_i = torch.nn.functional.one_hot(topi, E).to(torch.int32)
    # position of each (token, choice) in its expert's buffer: prior
    # selections of that expert, choice slots in priority order (k=0
    # first, as GShard)
    flat = sel_i.transpose(1, 2).reshape(G, k * Tg, E)      # (G, k*Tg, E)
    pos_flat = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = pos_flat.reshape(G, k, Tg, E).transpose(1, 2)     # (G, Tg, k, E)
    in_cap = ((pos < capacity) & (sel_i > 0)).to(xg.dtype)
    pos_idx = (pos * sel_i).sum(-1, dtype=torch.int32)      # (G, Tg, k)

    # one-hot over capacity slots; an overflow index (>= capacity) gives
    # a zero row, as jax.nn.one_hot does
    cap_hot = (pos_idx[..., None] == torch.arange(
        capacity, device=xg.device, dtype=torch.int32)).to(xg.dtype)
    dispatch = torch.einsum("gtke,gtkc->gtec", in_cap, cap_hot)
    expert_in = torch.einsum("gtec,gtd->gecd", dispatch, xg)
    h = torch.relu(torch.einsum("gecd,edf->gecf", expert_in, w1))
    expert_out = torch.einsum("gecf,efd->gecd", h, w2)
    combine = torch.einsum("gtke,gtk,gtkc->gtec", in_cap, topv, cap_hot)
    out = torch.einsum("gtec,gecd->gtd", combine, expert_out)

    # Switch/GShard load-balancing auxiliary, E * sum_e f_e * P_e
    f = sel_i[:, :, 0, :].float().mean(1)                   # (G, E)
    p = gates.float().mean(1)                               # (G, E)
    return out, E * (f * p).sum(-1)


def _moe_groups(tokens, group_size):
    """Number of routing groups: smallest G dividing `tokens` with
    tokens/G <= group_size (G=1 when tokens already fit), searched up to
    twice the ideal count; past that, one group."""
    if group_size <= 0 or tokens <= group_size:
        return 1
    ideal = (tokens + group_size - 1) // group_size
    for g in range(ideal, min(2 * ideal, tokens) + 1):
        if tokens % g == 0:
            return g
    return 1


def _moe_ffn_topk(x, wg, w1, w2, k, capacity_factor=1.25, group_size=4096):
    """Top-k sparse-dispatch MoE (Switch/GShard) over (B, S, D): the
    B*S tokens split into G routing groups of Tg tokens, each with
    capacity C = ceil(capacity_factor * Tg * k / E); tokens past an
    expert's capacity drop to the residual path. Returns (out, mean of
    the groups' auxiliaries)."""
    B, S, D = x.shape
    E = w1.shape[0]
    tokens = B * S
    G = _moe_groups(tokens, group_size)
    tg = tokens // G
    capacity = max(int(np.ceil(capacity_factor * tg * k / E)), k)
    out, aux = _route_group_topk(x.reshape(G, tg, D), wg, w1, w2, k,
                                 capacity)
    return out.reshape(B, S, D), aux.mean()


def transformer_apply(params, tokens, cfg, causal=True, return_aux=False):
    """tokens: (B, S) integer tensor -> logits (B, S, vocab). With
    return_aux=True also returns the summed MoE load-balancing auxiliary
    (a float32 0-d tensor, 0.0 for dense and dense-dispatch configs)."""
    B, S = tokens.shape
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x = params["embed"][tokens] + params["pos_embed"][:S][None]
    for i in range(cfg.n_layers):
        pre = "layer%d_" % i
        h = _layer_norm(x, params[pre + "ln1_g"], params[pre + "ln1_b"])
        x = x + _attention(h, params[pre + "wqkv"], params[pre + "wo"],
                           cfg, causal=causal)
        h = _layer_norm(x, params[pre + "ln2_g"], params[pre + "ln2_b"])
        if cfg.n_experts and cfg.moe_top_k:
            moe_out, aux = _moe_ffn_topk(h, params[pre + "wg"],
                                         params[pre + "w1"],
                                         params[pre + "w2"], cfg.moe_top_k,
                                         cfg.capacity_factor,
                                         cfg.moe_group_size)
            x = x + moe_out
            aux_total = aux_total + aux
        elif cfg.n_experts:
            x = x + _moe_ffn(h, params[pre + "wg"], params[pre + "w1"],
                             params[pre + "w2"])
        else:
            x = x + torch.relu(h @ params[pre + "w1"]) @ params[pre + "w2"]
    x = _layer_norm(x, params["lnf_g"], params["lnf_b"])
    logits = x @ params["head"]
    if return_aux:
        return logits, aux_total
    return logits


def lm_loss(params, tokens, cfg, aux_coef=0.01):
    """Next-token cross entropy: a float32 log_softmax over the logits of
    the full sequence, shifted in loss space, mean over the B*(S-1)
    targets, plus `aux_coef` times the top-k MoE auxiliary."""
    logits, aux = transformer_apply(params, tokens, cfg, return_aux=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]
    return -ll.mean() + aux_coef * aux


def lm_loss_and_grads(params, tokens, cfg):
    """(loss, {name: gradient}) of `lm_loss` at `params`, through
    torch.autograd: the port's `jax.value_and_grad(lm_loss)`. The
    parameter tensors are marked as requiring grad."""
    names = list(params)
    for name in names:
        params[name].requires_grad_(True)
    loss = lm_loss(params, tokens, cfg)
    grads = torch.autograd.grad(loss, [params[n] for n in names])
    return loss.detach(), dict(zip(names, grads))


def train_step(params, tokens, cfg, lr):
    """One SGD step, p <- p - lr * g, on `lm_loss`. The update is made IN
    PLACE, under no_grad, on the caller's tensors (the reference donates
    its params to the jitted step instead), so no second copy of the
    weights is held. Returns (params, loss)."""
    loss, grads = lm_loss_and_grads(params, tokens, cfg)
    with torch.no_grad():
        for name, g in grads.items():
            params[name].sub_(lr * g)
    return params, loss


def make_train_step(cfg, lr=0.1, seed=0, device=None):
    """(run, params): params from `init_transformer_params` with a
    torch.Generator seeded by `seed`, on `device` (default the card), and
    `run(params, tokens_np) -> (params, loss)`, one `train_step` on a
    (B, S) integer batch. Single device: it takes no mesh; the dp, tp,
    sp and ep variants of the reference come with the distributed
    slice."""
    device = resolve_device(device)
    params = init_transformer_params(
        cfg, torch.Generator().manual_seed(seed), device=device)

    def run(params, tokens_np):
        tokens = torch.as_tensor(np.asarray(tokens_np), dtype=torch.long,
                                 device=device)
        return train_step(params, tokens, cfg, lr)

    return run, params
