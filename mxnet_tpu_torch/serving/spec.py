"""Draft-model speculative decoding for the paged serving engine (port of
`mxnet_tpu/serving/spec.py`).

A small DRAFT model proposes k tokens autoregressively, then the TARGET
scores all k+1 positions in ONE ragged paged pass against the live block
tables (`engine._tf_spec_score`, the paged-attention kernel at Tq = k+1).
A verification rule accepts a prefix of the draft so the emitted
distribution is exactly the target's:

* greedy (`greedy_verify`, the serving path): emit target argmaxes while
  they agree with the draft, the target's own token at the first
  disagreement, and a bonus token when every draft token survives —
  token for token what the target alone would emit;
* sampled (`rejection_sample`): accept draft token d with probability
  min(1, p(d)/q(d)), else sample from norm(max(p - q, 0)) (Leviathan et
  al., arXiv:2211.17192); pinned by unit tests.

KV safety is positional: the scoring pass writes k+1 rows at positions
n-1..n-1+k, and rows past an accepted prefix are rewritten by the next
pass before any mask lets a query read them. The prefix cache indexes
only `tokens[:-1]`, accepted history.

The draft is CACHE-FREE: one dense causal forward
(`models.transformer.transformer_apply`) over the pow2-bucketed token
history per proposal step, so it holds no state of its own.
`MXNET_SPEC_DRAFT_LAYERS=n` builds it from the target's own first n
layers, so speculation is reachable from environment variables alone.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..base import MXNetError


def spec_decode_enabled():
    """MXNET_SPEC_DECODE=1 requests speculative decoding."""
    return os.environ.get("MXNET_SPEC_DECODE", "") == "1"


def spec_k(default=4):
    """MXNET_SPEC_K: draft tokens proposed per decode iteration (the
    target scores k+1 positions per pass)."""
    v = os.environ.get("MXNET_SPEC_K", "")
    return int(v) if v else default


def spec_draft_layers():
    """MXNET_SPEC_DRAFT_LAYERS=n: draft with the target's own first n
    transformer layers (0 or unset: no self-draft)."""
    v = os.environ.get("MXNET_SPEC_DRAFT_LAYERS", "")
    return int(v) if v else 0


def self_draft(params, cfg, n_layers):
    """Truncated self-draft: the first `n_layers` of the target's own
    stack, sharing its embeddings, final norm and head. Returns a
    `(params, cfg)` pair for `DraftLM`."""
    if not 1 <= n_layers <= cfg.n_layers:
        raise MXNetError(
            "self_draft: n_layers must be in [1, %d], got %d"
            % (cfg.n_layers, n_layers))
    keep = ("embed", "pos_embed", "lnf_g", "lnf_b", "head")
    prefixes = tuple("layer%d_" % i for i in range(n_layers))
    dparams = {k: v for k, v in params.items()
               if k in keep or k.startswith(prefixes)}
    return dparams, dataclasses.replace(cfg, n_layers=n_layers)


class DraftLM:
    """Cache-free draft model: params + TransformerConfig. `logits_at`
    runs the full causal forward over a right-padded (B, S) batch and
    returns the float32 logits at each row's true last position, through
    the watchdog's site "serving.draft" (a new (batch, length) bucket is a
    first run there)."""

    def __init__(self, params, cfg):
        if cfg.n_experts and cfg.moe_top_k:
            raise MXNetError(
                "spec: top-k MoE routing is capacity-dependent across the "
                "token group — padded draft batches would change real "
                "tokens' routing; draft with dense-FFN or dense-dispatch "
                "configs (moe_top_k=0)")
        from ..telemetry import introspect
        self.params = params
        self.cfg = cfg
        self.vocab = cfg.vocab
        self.max_len = cfg.max_len
        self._logits = introspect.instrument(
            self._last_logits, site="serving.draft", phase="decode",
            argnames=("tokens", "lengths"))

    def to(self, device):
        """Move the params to `device` (no copy when already there)."""
        self.params = {k: v.to(device) for k, v in self.params.items()}
        return self

    def logits_at(self, tokens, lengths):
        """Next-token float32 logits (B, V) at each row's `lengths`-1;
        `tokens` is a right-padded (B, S) integer tensor."""
        return self._logits(tokens, lengths)

    def _last_logits(self, tokens, lengths):
        from ..models.transformer import transformer_apply
        out = transformer_apply(self.params, tokens, self.cfg)    # (B,S,V)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        return out[rows, lengths.long() - 1].float()


def build_draft(draft, model):
    """Normalize the `Engine(draft=...)` argument into a DraftLM (or
    None): a DraftLM, a `(params, cfg)` tuple, or anything with
    `.params`/`.cfg`. With draft=None, `MXNET_SPEC_DRAFT_LAYERS` builds a
    truncated self-draft from the target's float weights (`params_f32`
    when its weights are quantized: draft precision moves only the
    acceptance rate, never the emitted tokens)."""
    if draft is None:
        n = spec_draft_layers()
        src = getattr(model, "params_f32", None)
        if src is None:
            src = getattr(model, "params", None)
        if n and src is not None \
                and getattr(model, "cfg", None) is not None:
            return DraftLM(*self_draft(src, model.cfg, n))
        return None
    if isinstance(draft, DraftLM):
        return draft
    if isinstance(draft, tuple) and len(draft) == 2:
        return DraftLM(draft[0], draft[1])
    if getattr(draft, "params", None) is not None \
            and getattr(draft, "cfg", None) is not None:
        return DraftLM(draft.params, draft.cfg)
    raise MXNetError(
        "Engine(draft=...): expected a DraftLM, a (params, cfg) tuple, "
        "or a model with .params/.cfg, got %r" % (type(draft).__name__,))


def spec_fallback_reason(model, draft, paged):
    """Why speculation falls back to the per-token decode (None: it can
    run). Configuration reasons only; on CUDA a scoring width the kernel
    does not take raises at Engine construction instead."""
    if draft is None:
        return ("no draft model: pass Engine(draft=(params, cfg)) or set "
                "MXNET_SPEC_DRAFT_LAYERS=n for a truncated self-draft")
    if not paged:
        return ("paged attention off; the k+1 scoring pass runs the paged "
                "kernel against the live block tables "
                "(MXNET_PAGED_ATTENTION=1)")
    if draft.vocab != model.vocab:
        return ("draft vocab %d != target vocab %d — acceptance compares "
                "token ids, so the vocabularies must be identical"
                % (draft.vocab, model.vocab))
    if draft.max_len < model.max_len:
        return ("draft max_len %d < target max_len %d — the draft must "
                "reach every position the target can decode"
                % (draft.max_len, model.max_len))
    return None


def greedy_verify(target_argmax, draft_tokens, n_draft):
    """Greedy acceptance for ONE sequence. `target_argmax[j]` is the
    target's argmax given the history plus the first j draft tokens,
    `draft_tokens[:n_draft]` the proposals. Returns (emitted_tokens,
    n_accepted) with 1 <= len(emitted) == n_accepted + 1 <= n_draft + 1,
    token-identical to running the target greedily one token at a
    time."""
    emitted = []
    for j in range(int(n_draft)):
        a = int(target_argmax[j])
        emitted.append(a)
        if a != int(draft_tokens[j]):
            return emitted, j
    emitted.append(int(target_argmax[int(n_draft)]))
    return emitted, int(n_draft)


def rejection_sample(target_probs, draft_probs, draft_tokens, uniforms,
                     resample_u):
    """Exact-distribution speculative sampling for ONE sequence,
    deterministic given the random draws. `target_probs` (k+1, V) rows
    p_j, `draft_probs` (k, V) rows q_j, `draft_tokens` (k,), `uniforms`
    (k,) accept draws, `resample_u` the one draw spent by the terminal
    sample (residual on rejection, p_k on a full sweep). Accept d_j when
    uniforms[j] < min(1, p_j(d)/q_j(d)); on rejection sample
    norm(max(p_j - q_j, 0)) by inverse CDF. Returns (emitted_tokens,
    n_accepted)."""
    tp = np.asarray(target_probs, dtype=np.float64)
    qp = np.asarray(draft_probs, dtype=np.float64)
    k = len(draft_tokens)
    emitted = []
    for j in range(k):
        d = int(draft_tokens[j])
        p_d, q_d = tp[j, d], qp[j, d]
        if q_d <= 0.0 or uniforms[j] < min(1.0, p_d / q_d):
            emitted.append(d)
            continue
        resid = np.maximum(tp[j] - qp[j], 0.0)
        tot = resid.sum()
        if tot <= 0.0:
            # p_j == q_j exactly: acceptance probability was 1, so a
            # rejection means uniforms[j] >= 1 — emit d regardless
            emitted.append(d)
            return emitted, j + 1
        cdf = np.cumsum(resid / tot)
        emitted.append(int(np.searchsorted(cdf, resample_u)))
        return emitted, j
    cdf = np.cumsum(tp[k] / tp[k].sum())
    emitted.append(int(np.searchsorted(cdf, resample_u)))
    return emitted, k
