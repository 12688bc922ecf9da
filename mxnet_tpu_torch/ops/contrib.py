"""Contrib ops (port of `mxnet_tpu/ops/contrib.py`): the SSD multibox
family (`MultiBoxPrior`, `MultiBoxTarget`, `MultiBoxDetection`),
`box_iou`, `box_nms`, the CTC loss, `count_sketch`, `fft` / `ifft`, the
RPN `Proposal` / `MultiProposal`, `DeformableConvolution`, the
position-sensitive ROI poolings, `bipartite_matching`, `khatri_rao`,
`_contrib_div_sqrt_dim` and `_contrib_PagedAttention`.

None of the reference's functions here reaches a Pallas kernel, so each
is plain PyTorch on its inputs' device: nothing is copied to the host to
compute. The reference's sequential sweeps (greedy NMS, greedy bipartite
matching, the CTC recursion) are Python loops of tensor ops vectorised
over the batch, with no host synchronisation inside. Sorts are stable
(`torch.sort(stable=True)`), as `jnp.argsort` and `lax.top_k` are, and
`argmax` takes the first maximum in both packages, so ties resolve
alike. Where the reference scatters with repeated indices (`.at[].set`),
the last write in index order wins, as in XLA; the port computes that
writer explicitly with `scatter_reduce("amax")` over the write order, so
the result does not depend on a device's scatter order.

`_contrib_PagedAttention` is the serving engine's paged read as a public
op, and keeps the reference's switch: with MXNET_PAGED_ATTENTION=1 it
calls `ops.paged_attention.paged_attention`, which launches the paged
kernel (K1, csrc/paged_attention.cu) on CUDA tensors or raises, and runs
its plain version on CPU tensors; with the flag off it runs that plain
version on any device: the reference's gather by table and masked
float32 softmax, the same function.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError
from . import paged_attention as _pa
from .registry import register


@register("khatri_rao")
def khatri_rao(*args):
    """Column-wise Khatri-Rao product of 2-D matrices A_i [M_i, N]:
    [prod(M_i), N], whose k-th column is the Kronecker product of the k-th
    columns (earlier matrices vary slowest)."""
    out = args[0]
    for m in args[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("_contrib_div_sqrt_dim")
def div_sqrt_dim(data):
    """data / sqrt(size of the last axis), the attention scaler (the
    root taken in data's dtype, as the reference takes it)."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype))


@register("_contrib_PagedAttention", aliases=("PagedAttention",),
          differentiable=False)
def PagedAttention(query, k_pool, v_pool, block_table, q_start,
                   block_size=16, scale=None):
    """Ragged paged attention over one layer's block pool (inference
    only). query [B, Tq, H, Dh]; k_pool / v_pool [num_blocks, block_size,
    H, Dh]; block_table [B, w] and q_start [B] (any integer or float
    dtype: they reach the kernel as contiguous int32 on query's device).
    Keys past position q_start + i are masked for query row i."""
    Dh = query.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(Dh)
    if _pa.paged_enabled() and query.device.type != "meta":
        tables = block_table.to(device=query.device,
                                dtype=torch.int32).contiguous()
        starts = q_start.to(device=query.device,
                            dtype=torch.int32).contiguous()
        return _pa.paged_attention(query.contiguous(), k_pool.contiguous(),
                                   v_pool.contiguous(), tables, starts,
                                   int(block_size), scale=scale)
    return _pa.paged_attention_plain(query, k_pool, v_pool, block_table,
                                     q_start, int(block_size), scale)


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def _iou_corner(a, b):
    """IoU of corner boxes a [..., M, 4] and b [..., N, 4] (leading dims
    broadcast): [..., M, N], 0 where the union is empty."""
    iw = (torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
          - torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
          ).clamp(min=0.0)
    ih = (torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
          - torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
          ).clamp(min=0.0)
    inter = iw * ih
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])).clamp(
        min=0.0)
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])).clamp(
        min=0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _greedy_nms(sup, valid):
    """The reference's greedy scan over score-sorted rows, batched:
    sup [B, n, n] (row i suppresses column j), valid [B, n] -> kept
    [B, n]. Row i is kept when it is valid and no kept row before it
    suppresses it. Only suppressions of later rows matter, so the scan
    keeps the upper triangle and a row's `alive` bit is final once the
    scan reaches it: one masked update a row, no host sync."""
    n = sup.shape[-1]
    sup = sup & torch.ones(n, n, dtype=torch.bool,
                           device=sup.device).triu(1)
    alive = valid.clone()
    for i in range(n):
        alive.masked_fill_(sup[:, i] & alive[:, i, None], False)
    return alive


def _last_write(target, n_rows):
    """For writes i = 0.. into rows target[..., i] (< n_rows), made in
    index order as XLA's scatter makes them: the 1-based index of each
    row's last writer, 0 where no write lands."""
    order = torch.arange(1, target.shape[-1] + 1, device=target.device)
    last = torch.zeros(target.shape[:-1] + (n_rows,), dtype=order.dtype,
                       device=target.device)
    return last.scatter_reduce(-1, target, order.expand(target.shape),
                               "amax")


def _sorted_gather(x, order):
    """x [B, n, ...] reordered along axis 1 by order [B, n]."""
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
        order.shape + x.shape[2:])
    return x.gather(1, idx)


# ---------------------------------------------------------------------------
# SSD: MultiBoxPrior / MultiBoxTarget / MultiBoxDetection
# ---------------------------------------------------------------------------


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
          differentiable=False)
def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes per cell of data's [H, W] map: (sizes[0], ratios[0]),
    (sizes[1:], ratios[0]), (sizes[0], ratios[1:]); [1, H*W*anchors, 4]
    corner boxes in normalized coordinates, in data's dtype. Built from
    the static shape on data's device."""
    H, W = data.shape[2], data.shape[3]
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    f32 = dict(dtype=torch.float32, device=data.device)
    cy = (torch.arange(H, **f32) + offsets[0]) * step_y
    cx = (torch.arange(W, **f32) + offsets[1]) * step_x
    anchors = [(s * np.sqrt(ratios[0]), s / np.sqrt(ratios[0]))
               for s in sizes]
    anchors += [(sizes[0] * np.sqrt(r), sizes[0] / np.sqrt(r))
                for r in ratios[1:]]
    aw = torch.tensor([a[0] for a in anchors], **f32) / 2.0
    ah = torch.tensor([a[1] for a in anchors], **f32) / 2.0
    gy, gx = torch.meshgrid(cy, cx, indexing="ij")
    gy, gx = gy[:, :, None], gx[:, :, None]
    out = torch.stack([gx - aw, gy - ah, gx + aw, gy + ah],
                      dim=-1).reshape(1, -1, 4)
    if clip:
        out = out.clamp(0.0, 1.0)
    return out.to(data.dtype)


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3, differentiable=False)
def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1.0, negative_mining_ratio=-1.0,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """(loc_target [N, 4A], loc_mask [N, 4A], cls_target [N, A]) for
    anchors [1, A, 4], labels [N, M, >=5] rows (cls, x1, y1, x2, y2),
    cls < 0 padding, and cls_pred [N, C, A]. Each anchor takes its best
    gt; each valid gt claims its best anchor (the last gt wins an anchor
    two claim, as the reference's scatter). With negative_mining_ratio >
    0, the hardest negatives by background probability (stable rank)
    become background and the other negatives ignore_label."""
    A = anchor.shape[1]
    anchors = anchor.reshape(A, 4)
    N, M = label.shape[0], label.shape[1]
    gt_cls = label[:, :, 0]
    gt_box = label[:, :, 1:5]
    valid = gt_cls >= 0                                   # [N, M]
    iou = _iou_corner(anchors, gt_box)                    # [N, A, M]
    iou = torch.where(valid[:, None, :], iou, -1.0)
    best_gt = iou.argmax(dim=2)                           # [N, A]
    best_iou = iou.amax(dim=2)
    best_anchor = iou.argmax(dim=1)                       # [N, M]
    last = _last_write(best_anchor, A)                    # [N, A]
    writer = (last - 1).clamp(min=0)
    claimed = (last > 0) & valid.gather(1, writer)
    pos = claimed | (best_iou >= overlap_threshold)
    match = torch.where(claimed, writer, best_gt)
    mcls = gt_cls.gather(1, match)
    mbox = _sorted_gather(gt_box, match)                  # [N, A, 4]
    cls_t = torch.where(pos, mcls + 1.0, 0.0)
    v = [float(x) for x in variances]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = (anchors[:, 2] - anchors[:, 0]).clamp(min=1e-8)
    ah = (anchors[:, 3] - anchors[:, 1]).clamp(min=1e-8)
    gcx = (mbox[..., 0] + mbox[..., 2]) / 2
    gcy = (mbox[..., 1] + mbox[..., 3]) / 2
    gw = (mbox[..., 2] - mbox[..., 0]).clamp(min=1e-8)
    gh = (mbox[..., 3] - mbox[..., 1]).clamp(min=1e-8)
    loc_t = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                         torch.log(gw / aw) / v[2],
                         torch.log(gh / ah) / v[3]], dim=-1)
    loc_t = torch.where(pos[..., None], loc_t, 0.0)
    loc_m = pos[..., None].expand(N, A, 4).to(loc_t.dtype)
    if negative_mining_ratio > 0:
        e = torch.exp(cls_pred - cls_pred.amax(dim=1, keepdim=True))
        bg = (e / e.sum(dim=1, keepdim=True))[:, 0, :]
        neg_cand = ~pos & (bg < 1.0)
        npos = pos.sum(dim=1, keepdim=True)
        k = (npos * negative_mining_ratio
             + minimum_negative_samples).clamp(max=A)
        score = torch.where(neg_cand, 1.0 - bg, -1.0)
        order = torch.argsort(-score, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        keep_neg = (rank < k) & neg_cand
        cls_t = torch.where(pos, cls_t, torch.where(
            keep_neg, 0.0, float(ignore_label)))
    return loc_t.reshape(N, -1), loc_m.reshape(N, -1), cls_t


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          differentiable=False)
def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                      nms_topk=-1):
    """Decode loc_pred [N, 4A] against anchors [1, A, 4], take each
    anchor's best class of cls_prob [N, C, A], then greedy per-class NMS
    over the score-sorted anchors: [N, A, 6] rows (cls, score, x1, y1,
    x2, y2) in score order, cls -1 where dropped. `nms_topk` is accepted
    and unused, as in the reference."""
    N, C, A = cls_prob.shape
    anchors = anchor.reshape(A, 4)
    v = [float(x) for x in variances]
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    loc = loc_pred.reshape(N, A, 4)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw / 2
    h = torch.exp(loc[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=-1)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    cls_id = cls_prob.argmax(dim=1).to(torch.float32)      # [N, A]
    score = cls_prob.amax(dim=1)
    keep = (cls_id != background_id) & (score > threshold)
    cls_out = torch.where(keep, cls_id - 1.0, -1.0)
    score = torch.where(keep, score, torch.zeros_like(score))
    order = torch.argsort(-score, dim=1, stable=True)
    sboxes = _sorted_gather(boxes, order)
    scls = cls_out.gather(1, order)
    sscore = score.gather(1, order)
    sup = _iou_corner(sboxes, sboxes) > nms_threshold
    if not force_suppress:
        sup &= scls[:, :, None] == scls[:, None, :]
    kept = _greedy_nms(sup, scls >= 0)
    final_cls = torch.where(kept, scls, -1.0)
    return torch.cat([final_cls[..., None], sscore[..., None].to(
        final_cls.dtype), sboxes.to(final_cls.dtype)], dim=-1)


# ---------------------------------------------------------------------------
# bounding-box ops
# ---------------------------------------------------------------------------


def _center_to_corner(b):
    return torch.stack([b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2,
                        b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2],
                       dim=-1)


@register("_contrib_box_iou", differentiable=False)
def box_iou(lhs, rhs, format="corner"):
    """IoU of every box of lhs [..., 4] with every box of rhs [..., 4]:
    lhs.shape[:-1] + rhs.shape[:-1]."""
    a = lhs.reshape(-1, 4)
    b = rhs.reshape(-1, 4)
    if format == "center":
        a, b = _center_to_corner(a), _center_to_corner(b)
    return _iou_corner(a, b).reshape(tuple(lhs.shape[:-1])
                                     + tuple(rhs.shape[:-1]))


@register("_contrib_box_nms", aliases=("_contrib_nms",),
          differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Greedy NMS over data [..., n, K] rows (score at score_index, the
    box at coord_start, the class at id_index when >= 0): rows sorted by
    score (valid ones first), dropped rows -1."""
    shape = data.shape
    flat = data.reshape(-1, shape[-2], shape[-1])
    n, K = flat.shape[1], flat.shape[2]
    score = flat[..., score_index]
    # clamped into the row, as lax.dynamic_slice clamps its start
    start = min(max(int(coord_start), 0), K - 4)
    boxes = flat[..., start:start + 4]
    if in_format == "center":
        boxes = _center_to_corner(boxes)
    valid = score > valid_thresh
    if id_index >= 0:
        ids = flat[..., id_index]
        valid = valid & (ids != background_id)
    else:
        ids = torch.zeros_like(score)
    order = torch.argsort(-torch.where(valid, score, -math.inf), dim=1,
                          stable=True)
    sb = _sorted_gather(boxes, order)
    sid = ids.gather(1, order)
    svalid = valid.gather(1, order)
    if topk > 0:
        svalid = svalid & (torch.arange(n, device=data.device) < topk)
    sup = _iou_corner(sb, sb) > overlap_thresh
    if not force_suppress:
        sup &= sid[:, :, None] == sid[:, None, :]
    kept = _greedy_nms(sup, svalid)
    out = torch.where(kept[..., None], _sorted_gather(flat, order), -1.0)
    return out.reshape(shape)


# ---------------------------------------------------------------------------
# CTC loss: a log-domain forward recursion over time
# ---------------------------------------------------------------------------

#: the log of zero probability: finite, so logaddexp and its gradient stay
#: finite on unreachable states
NEG_INF = -1e30


def ctc_loss_ref(logits, labels, input_lengths, label_lengths, blank=0):
    """Per-sample negative log likelihood of labels [N, L] (int) under
    logits [T, N, C] (pre-softmax), each sample read for its
    input_lengths[n] steps with its first label_lengths[n] labels."""
    T, N, C = logits.shape
    L = labels.shape[1]
    dev = logits.device
    logp = torch.log_softmax(logits, dim=-1)
    S = 2 * L + 1
    ext = torch.full((N, S), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.long()
    ext_valid = torch.arange(S, device=dev)[None, :] < \
        (2 * label_lengths[:, None] + 1)
    can_skip = torch.cat([torch.zeros((N, 2), dtype=torch.bool, device=dev),
                          ext[:, 2:] != ext[:, :-2]], dim=1)
    first = logp[0].gather(1, ext[:, :2])
    alpha = torch.cat([first[:, :1],
                       torch.where(label_lengths > 0, first[:, 1],
                                   NEG_INF)[:, None],
                       torch.full((N, S - 2), NEG_INF, dtype=logp.dtype,
                                  device=dev)], dim=1)
    pad = torch.full((N, 2), NEG_INF, dtype=logp.dtype, device=dev)
    for t in range(1, T):
        prev1 = torch.cat([pad[:, :1], alpha[:, :-1]], dim=1)
        prev2 = torch.where(can_skip, torch.cat([pad, alpha[:, :-2]], dim=1),
                            NEG_INF)
        merged = torch.logaddexp(torch.logaddexp(alpha, prev1), prev2)
        new = torch.where(ext_valid, merged + logp[t].gather(1, ext),
                          NEG_INF)
        alpha = torch.where((t < input_lengths)[:, None], new, alpha)
    last = 2 * label_lengths
    a_last = alpha.gather(1, last[:, None])[:, 0]
    a_prev = alpha.gather(1, (last - 1).clamp(min=0)[:, None])[:, 0]
    a_prev = torch.where(label_lengths > 0, a_prev, NEG_INF)
    return -torch.logaddexp(a_last, a_prev)


@register("_contrib_ctc_loss", aliases=("ctc_loss", "CTCLoss",
                                        "_contrib_CTCLoss"))
def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """CTC loss of data [T, N, C] activations against label [N, L]: with
    blank_label 'first' the blank is 0 and labels are > 0 (0 pads); with
    'last' the blank is C-1 and -1 pads. Lengths default to T and to the
    labels' non-padding count."""
    T, N, C = data.shape
    lab = label.long()
    if blank_label == "first":
        blank = 0
        lab_len = label_lengths if use_label_lengths else (lab > 0).sum(1)
    else:
        blank = C - 1
        lab_len = label_lengths if use_label_lengths else (lab >= 0).sum(1)
        lab = torch.where(lab < 0, 0, lab)
    in_len = data_lengths if use_data_lengths else \
        torch.full((N,), T, device=data.device)
    return ctc_loss_ref(data, lab, in_len.long(), lab_len.long(),
                        blank=blank)


# ---------------------------------------------------------------------------
# count_sketch / fft
# ---------------------------------------------------------------------------


@register("_contrib_count_sketch", differentiable=False)
def count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """out[:, j] = sum of s[i] * data[:, i] over the i with h[i] == j."""
    n, d = data.shape
    hj = h.reshape(-1).long()[:d]
    sj = s.reshape(-1)[:d]
    out = torch.zeros((n, int(out_dim)), dtype=data.dtype,
                      device=data.device)
    return out.index_add(1, hj, data * sj[None, :])


@register("_contrib_fft", differentiable=False)
def fft(data, compute_size=128):
    """FFT over the last axis, real and imaginary parts interleaved."""
    out = torch.fft.fft(data, dim=-1)
    return torch.stack([out.real, out.imag], dim=-1).reshape(
        tuple(data.shape[:-1]) + (2 * data.shape[-1],))


@register("_contrib_ifft", differentiable=False)
def ifft(data, compute_size=128):
    """The real part of the inverse FFT of interleaved (re, im) pairs."""
    c = data.reshape(tuple(data.shape[:-1]) + (data.shape[-1] // 2, 2))
    comp = torch.complex(c[..., 0].float(), c[..., 1].float())
    return torch.fft.ifft(comp, dim=-1).real.to(torch.float32)


# ---------------------------------------------------------------------------
# RCNN proposals
# ---------------------------------------------------------------------------


def _proposals(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
               rpn_post_nms_top_n, threshold, rpn_min_size, scales, ratios,
               feature_stride):
    """(rois [N, post, 5] with column 0 zero, scores [N, post]): anchors
    decoded by the deltas, clipped to the image, small boxes dropped,
    the pre-NMS top n by score (stable), greedy NMS, then the first post
    survivors in score order, written as the reference's scatter writes
    them (row post-1 takes the last write)."""
    N, _, H, W = cls_prob.shape
    A = len(scales) * len(ratios)
    dev = cls_prob.device
    base = float(feature_stride)
    anchors = []
    for r in ratios:
        for s in scales:
            ws = base * s * np.sqrt(1.0 / r)
            hs = base * s * np.sqrt(r)
            anchors.append([-(ws - 1) / 2, -(hs - 1) / 2, (ws - 1) / 2,
                            (hs - 1) / 2])
    anc = torch.tensor(anchors, dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(torch.arange(H, device=dev) * feature_stride,
                            torch.arange(W, device=dev) * feature_stride,
                            indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], dim=-1).reshape(-1, 1, 4)
    all_anchors = (shifts + anc[None]).reshape(-1, 4)
    scores = cls_prob[:, A:].permute(0, 2, 3, 1).reshape(N, -1)
    d = bbox_pred.reshape(N, A, 4, H, W).permute(0, 3, 4, 1, 2).reshape(
        N, -1, 4)
    widths = all_anchors[:, 2] - all_anchors[:, 0] + 1
    heights = all_anchors[:, 3] - all_anchors[:, 1] + 1
    cx = all_anchors[:, 0] + widths / 2
    cy = all_anchors[:, 1] + heights / 2
    pcx = d[..., 0] * widths + cx
    pcy = d[..., 1] * heights + cy
    pw = torch.exp(d[..., 2]) * widths
    ph = torch.exp(d[..., 3]) * heights
    boxes = torch.stack([pcx - pw / 2, pcy - ph / 2, pcx + pw / 2,
                         pcy + ph / 2], dim=-1)
    upper = torch.stack([im_info[:, 1] - 1, im_info[:, 0] - 1,
                         im_info[:, 1] - 1, im_info[:, 0] - 1], dim=-1)
    boxes = torch.minimum(boxes.clamp(min=0), upper[:, None, :])
    keep = ((boxes[..., 2] - boxes[..., 0]) >= rpn_min_size) & \
        ((boxes[..., 3] - boxes[..., 1]) >= rpn_min_size)
    scores = torch.where(keep, scores, -math.inf)
    k = min(rpn_pre_nms_top_n, boxes.shape[1])
    top_scores, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores, idx = top_scores[:, :k], idx[:, :k]
    top_boxes = _sorted_gather(boxes, idx)
    kept = _greedy_nms(_iou_corner(top_boxes, top_boxes) > threshold,
                       torch.isfinite(top_scores))
    post = rpn_post_nms_top_n
    rank = torch.cumsum(kept.to(torch.int64), dim=1) - 1
    sel = kept & (rank < post)
    writer = _last_write(torch.where(sel, rank, post - 1), post)  # [N, post]
    src = (writer - 1).clamp(min=0)
    wrote = writer > 0
    final = torch.where((wrote & sel.gather(1, src))[..., None],
                        _sorted_gather(top_boxes, src), 0.0)
    fscore = torch.where(wrote & sel.gather(1, src),
                         top_scores.gather(1, src), 0.0)
    rois = torch.cat([torch.zeros((N, post, 1), dtype=final.dtype,
                                  device=dev), final], dim=-1)
    return rois, fscore


@register("_contrib_Proposal", aliases=("Proposal",), differentiable=False)
def Proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4, 8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
             output_score=False, iou_loss=False):
    """RPN proposals: rois [N * post, 5] (column 0 zero), and their
    scores [N * post, 1] with output_score."""
    rois, scores = _proposals(cls_prob, bbox_pred, im_info,
                              rpn_pre_nms_top_n, rpn_post_nms_top_n,
                              threshold, rpn_min_size, scales, ratios,
                              feature_stride)
    rois = rois.reshape(-1, 5)
    if output_score:
        return rois, scores.reshape(-1, 1)
    return rois


@register("_contrib_MultiProposal", aliases=("MultiProposal",),
          differentiable=False)
def MultiProposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                  rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                  scales=(4, 8, 16, 32), ratios=(0.5, 1, 2),
                  feature_stride=16, output_score=False, iou_loss=False):
    """Proposal over every image, rois[:, 0] carrying the image index:
    [N * post, 5] (and [N * post, 1] scores with output_score)."""
    N = cls_prob.shape[0]
    rois, scores = _proposals(cls_prob, bbox_pred, im_info,
                              rpn_pre_nms_top_n, rpn_post_nms_top_n,
                              threshold, rpn_min_size, scales, ratios,
                              feature_stride)
    batch_idx = torch.arange(N, dtype=rois.dtype, device=rois.device)
    rois = torch.cat([batch_idx[:, None, None].expand(
        N, rpn_post_nms_top_n, 1), rois[..., 1:]], dim=-1).reshape(-1, 5)
    if output_score:
        return rois, scores.reshape(-1, 1)
    return rois


# ---------------------------------------------------------------------------
# deformable convolution and position-sensitive ROI pooling
# ---------------------------------------------------------------------------


def _bilinear_gather(img, y, x):
    """Bilinear samples of img [B, C, H, W] at float positions y, x
    [B, P], zero outside the map: [B, C, P]. The four corners are summed
    in the reference's order; differentiable in img and in y, x."""
    B, C, H, W = img.shape
    flat = img.reshape(B, C, H * W)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    out = None
    for yy, wy in ((y0, 1.0 - (y - y0)), (y0 + 1.0, y - y0)):
        for xx, wx in ((x0, 1.0 - (x - x0)), (x0 + 1.0, x - x0)):
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            pos = (yy.clamp(0, H - 1).long() * W
                   + xx.clamp(0, W - 1).long())
            w = (wy * wx * inside).to(img.dtype)
            term = flat.gather(2, pos[:, None, :].expand(B, C, -1)) \
                * w[:, None, :]
            out = term if out is None else out + term
    return out


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


@register("_contrib_DeformableConvolution",
          aliases=("DeformableConvolution",))
def DeformableConvolution(data, offset, weight, bias=None, kernel=None,
                          stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                          num_filter=0, num_group=1, num_deformable_group=1,
                          no_bias=False, workspace=1024, layout=None):
    """Deformable convolution (Dai et al. 2017): a convolution whose
    sampling positions are displaced by offset [N, 2 * deformable groups
    * kh * kw, Ho, Wo] (y then x for each tap), sampled bilinearly with
    zero padding; the sampled patches contract with the weights in one
    grouped einsum. Differentiable in data, offset and weight."""
    N, C, H, W = data.shape
    F = weight.shape[0]
    kh, kw = weight.shape[2], weight.shape[3]
    sh, sw = _pair(stride)
    dh, dw = _pair(dilate)
    ph, pw = _pair(pad)
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    K = kh * kw
    G, Gd = num_group, num_deformable_group
    dev = data.device
    ky, kx = torch.meshgrid(torch.arange(kh, device=dev) * dh,
                            torch.arange(kw, device=dev) * dw, indexing="ij")
    base_y = (torch.arange(Ho, device=dev) * sh - ph)[None, :, None] + \
        ky.reshape(K, 1, 1)
    base_x = (torch.arange(Wo, device=dev) * sw - pw)[None, None, :] + \
        kx.reshape(K, 1, 1)
    o = offset.reshape(N, Gd, K, 2, Ho, Wo)
    y = base_y + o[:, :, :, 0]                       # [N, Gd, K, Ho, Wo]
    x = base_x + o[:, :, :, 1]
    cols = _bilinear_gather(data.reshape(N * Gd, C // Gd, H, W),
                            y.reshape(N * Gd, -1), x.reshape(N * Gd, -1))
    cols = cols.reshape(N, G, C // G, K, Ho, Wo)
    wg = weight.reshape(G, F // G, C // G, K)
    out = torch.einsum("gfck,ngckhw->ngfhw", wg.float(), cols.float())
    out = out.reshape(N, F, Ho, Wo).to(data.dtype)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, F, 1, 1)
    return out


def _bin_channels(output_dim, gs, P):
    """The channel each bin (ctop, ph, pw) reads: (ctop*gs + gh)*gs + gw,
    [output_dim, P, P] (static)."""
    gh = np.clip((np.arange(P) * gs) // P, 0, gs - 1)
    return ((np.arange(output_dim)[:, None, None] * gs + gh[None, :, None])
            * gs + gh[None, None, :])


def _check_channels(C, output_dim, gs):
    if C != output_dim * gs * gs:
        raise MXNetError("data channels (%d) != output_dim*group_size^2 "
                         "(%d)" % (C, output_dim * gs * gs))


@register("_contrib_PSROIPooling", aliases=("PSROIPooling",))
def PSROIPooling(data, rois, spatial_scale=1.0, output_dim=1, pooled_size=1,
                 group_size=0):
    """Position-sensitive ROI pooling (R-FCN): rois [R, 5] (batch index,
    x1, y1, x2, y2), rounded and scaled; each of the pooled_size^2 bins
    averages the integer pixels of its sub-window from its own channel:
    [R, output_dim, P, P]. Differentiable in data."""
    P = int(pooled_size)
    gs = int(group_size) if group_size else P
    C, H, W = data.shape[1], data.shape[2], data.shape[3]
    _check_channels(C, output_dim, gs)
    dev = data.device
    chan = torch.as_tensor(_bin_channels(output_dim, gs, P), device=dev)
    d = data[rois[:, 0].long()]                         # [R, C, H, W]
    start_w = torch.round(rois[:, 1]) * spatial_scale
    start_h = torch.round(rois[:, 2]) * spatial_scale
    end_w = (torch.round(rois[:, 3]) + 1.0) * spatial_scale
    end_h = (torch.round(rois[:, 4]) + 1.0) * spatial_scale
    bin_w = (end_w - start_w).clamp(min=0.1)[:, None] / P
    bin_h = (end_h - start_h).clamp(min=0.1)[:, None] / P
    ar = torch.arange(P, device=dev)
    hs = torch.floor(ar * bin_h + start_h[:, None]).clamp(0, H)
    he = torch.ceil((ar + 1) * bin_h + start_h[:, None]).clamp(0, H)
    ws = torch.floor(ar * bin_w + start_w[:, None]).clamp(0, W)
    we = torch.ceil((ar + 1) * bin_w + start_w[:, None]).clamp(0, W)
    hidx = torch.arange(H, device=dev)
    widx = torch.arange(W, device=dev)
    mask_h = ((hidx >= hs[..., None]) & (hidx < he[..., None])).to(d.dtype)
    mask_w = ((widx >= ws[..., None]) & (widx < we[..., None])).to(d.dtype)
    binsum = torch.einsum("roabhw,rah,rbw->roab", d[:, chan], mask_h,
                          mask_w)
    area = (he - hs)[:, None, :, None] * (we - ws)[:, None, None, :]
    return torch.where(area > 0, binsum / area.clamp(min=1.0),
                       0.0).to(data.dtype)


@register("_contrib_DeformablePSROIPooling",
          aliases=("DeformablePSROIPooling",), num_outputs=2)
def DeformablePSROIPooling(data, rois, trans=None, spatial_scale=1.0,
                           output_dim=1, group_size=1, pooled_size=1,
                           part_size=0, sample_per_part=1, trans_std=0.0,
                           no_trans=False):
    """Deformable position-sensitive ROI pooling: each bin averages
    sample_per_part^2 bilinear samples of its channel at positions
    displaced by trans [R, 2 * classes, part, part] (times trans_std and
    the roi's extent); samples outside (-0.5, dim - 0.5) leave the
    average. (pooled [R, output_dim, P, P], sample count). Differentiable
    in data and trans."""
    P = int(pooled_size)
    gs = int(group_size)
    sp = int(sample_per_part)
    part = int(part_size) if part_size else P
    C, H, W = data.shape[1], data.shape[2], data.shape[3]
    _check_channels(C, output_dim, gs)
    use_trans = not (no_trans or trans is None)
    ncls = trans.shape[1] // 2 if use_trans else 1
    if ncls < 1 or output_dim % ncls:
        raise MXNetError("output_dim (%d) must be a positive multiple of "
                         "num_classes (%d) derived from trans channels"
                         % (output_dim, ncls))
    dev = data.device
    R = rois.shape[0]
    chan = torch.as_tensor(_bin_channels(output_dim, gs, P), device=dev)
    cls_of = torch.as_tensor(np.arange(output_dim) // (output_dim // ncls),
                             device=dev)
    d = data[rois[:, 0].long()]                          # [R, C, H, W]
    start_w = torch.round(rois[:, 1]) * spatial_scale - 0.5
    start_h = torch.round(rois[:, 2]) * spatial_scale - 0.5
    end_w = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    end_h = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = (end_w - start_w).clamp(min=0.1)
    rh = (end_h - start_h).clamp(min=0.1)
    bin_h, bin_w = rh / P, rw / P
    sub_h, sub_w = bin_h / sp, bin_w / sp
    if use_trans:
        part_idx = torch.as_tensor(
            np.floor(np.arange(P) / P * part).astype(np.int64), device=dev)
        t = trans.reshape(R, ncls, 2, part, part)[
            :, :, :, part_idx[:, None], part_idx[None, :]] * trans_std
        tx, ty = t[:, :, 0], t[:, :, 1]                  # [R, ncls, P, P]
    else:
        tx = ty = torch.zeros((R, 1, P, P), dtype=data.dtype, device=dev)

    def col(v):
        return v[:, None, None, None]

    ar = torch.arange(P, device=dev)
    hstart = ar[:, None] * col(bin_h) + col(start_h) + ty * col(rh)
    wstart = ar[None, :] * col(bin_w) + col(start_w) + tx * col(rw)
    sa = torch.arange(sp, device=dev)
    y = hstart[..., None, None] + (sa * sub_h[:, None])[
        :, None, None, None, :, None]
    x = wstart[..., None, None] + (sa * sub_w[:, None])[
        :, None, None, None, None, :]
    # samples at exactly -0.5 / dim - 0.5 are kept: the reference skips
    # only strictly outside ones
    valid = (x >= -0.5) & (x <= W - 0.5) & (y >= -0.5) & (y <= H - 0.5)
    yc, xc = torch.broadcast_tensors(y.clamp(0.0, H - 1.0),
                                     x.clamp(0.0, W - 1.0))
    n_bins = output_dim * P * P
    imgs = d[:, chan].reshape(R * n_bins, 1, H, W)
    vb = _bilinear_gather(imgs, yc[:, cls_of].reshape(R * n_bins, -1),
                          xc[:, cls_of].reshape(R * n_bins, -1))
    validb = valid[:, cls_of].reshape(R * n_bins, 1, -1).to(d.dtype)
    s = (vb * validb).sum(dim=-1).reshape(R, output_dim, P, P)
    cnt = valid.sum(dim=(-1, -2)).to(d.dtype)[:, cls_of]   # [R, od, P, P]
    pooled = torch.where(cnt > 0, s / cnt.clamp(min=1.0), 0.0)
    return pooled.to(data.dtype), cnt.to(data.dtype)


@register("_contrib_bipartite_matching", num_outputs=2,
          differentiable=False)
def bipartite_matching(dist, is_ascend=False, threshold=0.5, topk=-1):
    """Greedy bipartite matching over dist [..., n, m]: min(n, m) times
    (at most topk when > 0) the best remaining (row, col) pair (the first
    in row-major order on a tie) is matched if it beats threshold (larger
    is better unless is_ascend), and its row and column leave. Returns
    (row_match [..., n], col_match [..., m]): the matched column / row,
    -1 where none, as float32."""
    batch_shape = tuple(dist.shape[:-2])
    n, m = dist.shape[-2], dist.shape[-1]
    sign = -1.0 if is_ascend else 1.0
    dd = dist.reshape(-1, n, m).to(torch.float32) * sign
    thr = float(np.float32(threshold)) * sign
    iters = min(n, m) if topk is None or topk <= 0 else min(topk, min(n, m))
    B, dev = dd.shape[0], dd.device
    rows = torch.arange(n, device=dev)
    cols = torch.arange(m, device=dev)
    rmatch = torch.full((B, n), -1.0, device=dev)
    cmatch = torch.full((B, m), -1.0, device=dev)
    for _ in range(iters):
        best = dd.reshape(B, -1).argmax(dim=1)
        r, c = best // m, best % m
        ok = dd.reshape(B, -1).gather(1, best[:, None])[:, 0] >= thr
        hit_r = (rows[None, :] == r[:, None]) & ok[:, None]   # [B, n]
        hit_c = (cols[None, :] == c[:, None]) & ok[:, None]   # [B, m]
        rmatch = torch.where(hit_r, c[:, None].float(), rmatch)
        cmatch = torch.where(hit_c, r[:, None].float(), cmatch)
        dd = dd.masked_fill(hit_r[:, :, None] | hit_c[:, None, :],
                            -math.inf)
    return rmatch.reshape(batch_shape + (n,)), \
        cmatch.reshape(batch_shape + (m,))
