"""The rest of `ops/contrib.py` on the port against the JAX reference on
the CPU: the SSD multibox ops, `box_iou`, `box_nms` / `_contrib_nms`,
the CTC loss and its aliases, `count_sketch`, `fft` / `ifft`,
`Proposal` / `MultiProposal`, `DeformableConvolution`, `PSROIPooling`,
`DeformablePSROIPooling` and `bipartite_matching`, with `nd.contrib` /
`sym.contrib` and each name's Symbol shape inference.

The same numpy-seeded inputs go through `mx.nd.<name>` of both packages
(tests/test_torch_tensor_ops.py's harness), and where the reference
differentiates the op, through each package's autodiff (`jax.vjp`, the
port's `torch.autograd.grad`) with one cotangent. Tie cases: equal
scores in NMS, equal IoUs and equal background probabilities in
MultiBoxTarget's matching and mining, and equal entries in
`bipartite_matching`. Shapes follow tests/test_operator.py's contrib
tests (ctc, multibox, box ops, fft, count_sketch, deformable, PSROI,
multi-proposal) and tests/test_op_parity.py's bipartite matching.

Tolerances: integer-valued results (classes, masks, kept rows, matches)
exact; float results 1e-5 (f32; the CTC and deformable gradients too);
values built from the same float32 steps 1e-6.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as ref_registry

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as port_registry

from test_torch_tensor_ops import (ARITH, EXACT, check_case,
                                   check_symbol_shapes, run_nd, vjp_both)

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def boxes(rs, *lead, lo=0.0, hi=1.0):
    """Corner boxes [..., 4] with x1 < x2 and y1 < y2."""
    a = rs.uniform(lo, hi, lead + (2,))
    b = rs.uniform(lo, hi, lead + (2,))
    return np.concatenate([np.minimum(a, b), np.maximum(a, b) + 0.05],
                          axis=-1).astype(np.float32)


def anchors(size=4, sizes=(0.3, 0.6), ratios=(1.0, 2.0, 0.5)):
    return mx.nd.contrib.MultiBoxPrior(
        mx.nd.zeros((1, 3, size, size)), sizes=sizes,
        ratios=ratios).asnumpy()


def det_labels(rs, N, M, n_valid, num_classes=3):
    lab = -np.ones((N, M, 5), np.float32)
    for i in range(N):
        k = n_valid[i]
        lab[i, :k, 0] = rs.randint(0, num_classes, k)
        lab[i, :k, 1:] = boxes(rs, k)
    return lab


def check_outputs(name, arrays, params, tols):
    ref, port = run_nd(name, arrays, params)
    assert len(ref) == len(port) == len(tols), name
    for i, (r, p, tol) in enumerate(zip(ref, port, tols)):
        assert p.shape == r.shape and p.dtype == r.dtype, (name, i)
        np.testing.assert_allclose(p, r, err_msg="%s out %d" % (name, i),
                                   **tol)
    return ref, port


def check_grads(name, arrays, params, tol=F32):
    for i, (rg, pg) in vjp_both(name, arrays, params).items():
        assert pg.shape == rg.shape, (name, i)
        np.testing.assert_allclose(pg, rg, err_msg="%s grad %d" % (name, i),
                                   **tol)


# ---------------------------------------------------------------------------
# SSD multibox ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [
    dict(sizes=(0.5,), ratios=(1.0,)),
    dict(sizes=(0.2, 0.35), ratios=(1.0, 2.0, 0.5)),
    dict(sizes=(0.9,), ratios=(1.0, 3.0), clip=True),
    dict(sizes=(0.3,), ratios=(1.0,), steps=(0.2, 0.25),
         offsets=(0.25, 0.75)),
])
@pytest.mark.parametrize("name", ["_contrib_MultiBoxPrior", "MultiBoxPrior"])
def test_multibox_prior(name, params):
    x = np.zeros((2, 3, 4, 5), np.float32)
    check_case(name, [x], params, ARITH)


def _target_case(rs, N=3, M=4, n_valid=(2, 4, 1), C=4, size=4):
    anc = anchors(size)
    lab = det_labels(rs, N, M, n_valid, C - 1)
    pred = rs.randn(N, C, anc.shape[1]).astype(np.float32)
    return anc, lab, pred


@pytest.mark.parametrize("mining", [
    dict(), dict(negative_mining_ratio=3.0),
    dict(negative_mining_ratio=1.0, minimum_negative_samples=2,
         overlap_threshold=0.3, ignore_label=-2.0,
         variances=(0.2, 0.2, 0.1, 0.1))])
@pytest.mark.parametrize("name", ["_contrib_MultiBoxTarget",
                                  "MultiBoxTarget"])
def test_multibox_target(name, mining):
    anc, lab, pred = _target_case(np.random.RandomState(0))
    check_outputs(name, [anc, lab, pred], mining, [F32, EXACT, EXACT])
    check_symbol_shapes(name, [anc, lab, pred], mining)


def test_multibox_target_ties():
    """Two gts of one box (equal IoUs: the first wins each anchor, the
    last claims their shared best anchor), a gt whose best anchor a
    padding row also points at, and equal background probabilities at
    the mining cut (the stable rank keeps the earlier anchors)."""
    rs = np.random.RandomState(1)
    anc = anchors(4)
    A = anc.shape[1]
    lab = -np.ones((2, 4, 5), np.float32)
    lab[0, 0] = [0, 0.1, 0.1, 0.5, 0.5]
    lab[0, 1] = [1, 0.1, 0.1, 0.5, 0.5]
    lab[0, 2] = [2, 0.6, 0.6, 0.9, 0.9]
    lab[1, 0] = [1, *anc[0, 0]]
    pred = np.zeros((2, 3, A), np.float32)
    pred[:, 0, ::3] = rs.randn(2, len(range(0, A, 3)))
    for mining in (dict(), dict(negative_mining_ratio=2.0),
                   dict(negative_mining_ratio=3.0,
                        minimum_negative_samples=5)):
        ref, _ = check_outputs("MultiBoxTarget", [anc, lab, pred], mining,
                               [F32, EXACT, EXACT])
        assert (ref[2] > 0).any() and (ref[2] == 0).any()


def _detection_case(rs, N=2, C=4, size=4, ties=False):
    anc = anchors(size)
    A = anc.shape[1]
    logits = rs.randn(N, C, A).astype(np.float32) * 2
    if ties:
        logits[:, :, 1::2] = logits[:, :, 0:-1:2]   # equal score pairs
    e = np.exp(logits - logits.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = (rs.randn(N, 4 * A) * 0.5).astype(np.float32)
    return prob, loc, anc


@pytest.mark.parametrize("params", [
    dict(), dict(nms_threshold=0.3, threshold=0.2),
    dict(force_suppress=True, nms_threshold=0.45),
    dict(clip=False, background_id=1, variances=(0.2, 0.2, 0.3, 0.3))])
@pytest.mark.parametrize("ties", [False, True])
def test_multibox_detection(params, ties):
    prob, loc, anc = _detection_case(np.random.RandomState(2), ties=ties)
    for name in ("_contrib_MultiBoxDetection", "MultiBoxDetection"):
        ref, port = check_outputs(name, [prob, loc, anc], params, [F32])
        # classes and scores (and so every keep decision) identical
        np.testing.assert_array_equal(port[0][..., :2], ref[0][..., :2])
    check_symbol_shapes("MultiBoxDetection", [prob, loc, anc], params)


# ---------------------------------------------------------------------------
# box_iou / box_nms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(3)
    lhs = boxes(rs, 2, 3)
    rhs = boxes(rs, 5)
    rhs[1] = lhs[0, 1]      # an equal box: IoU 1
    rhs[2] = [0.2, 0.2, 0.2, 0.6]   # zero area
    check_case("_contrib_box_iou", [lhs, rhs], dict(format=fmt), ARITH)


def _nms_rows(rs, B=2, n=12, ties=True):
    rows = np.zeros((B, n, 6), np.float32)
    rows[..., 0] = rs.randint(0, 3, (B, n))
    rows[..., 1] = rs.uniform(0, 1, (B, n))
    if ties:
        rows[:, 1::3, 1] = rows[:, 0:-1:3, 1]     # equal scores
        rows[:, -1, 1] = 0.0                      # at valid_thresh
    rows[..., 2:] = boxes(rs, B, n, hi=0.6)
    rows[:, 4, 2:] = rows[:, 3, 2:]               # identical boxes
    return rows


@pytest.mark.parametrize("params", [
    dict(), dict(overlap_thresh=0.3, id_index=0),
    dict(overlap_thresh=0.2, id_index=0, force_suppress=True, topk=5),
    dict(valid_thresh=0.3, id_index=0, background_id=1),
    dict(in_format="center", overlap_thresh=0.4),
    dict(coord_start=3, score_index=2, overlap_thresh=0.5)])
@pytest.mark.parametrize("name", ["_contrib_box_nms", "_contrib_nms"])
def test_box_nms(name, params):
    rows = _nms_rows(np.random.RandomState(4))
    check_case(name, [rows], params, EXACT)
    check_case(name, [rows[0]], params, EXACT)


# ---------------------------------------------------------------------------
# CTC
# ---------------------------------------------------------------------------


def _ctc_case(rs, T=12, N=3, C=6, L=4, blank="first"):
    data = rs.randn(T, N, C).astype(np.float32)
    lab_len = np.array([4, 2, 3], np.int32)[:N]
    pad = 0 if blank == "first" else -1
    lo, hi = (1, C) if blank == "first" else (0, C - 1)
    label = np.full((N, L), pad, np.float32)
    for i, k in enumerate(lab_len):
        label[i, :k] = rs.randint(lo, hi, k)
    label[0, 1] = label[0, 0]          # a repeat (no skip between them)
    return data, label, lab_len


@pytest.mark.parametrize("blank", ["first", "last"])
@pytest.mark.parametrize("name", ["_contrib_ctc_loss", "ctc_loss", "CTCLoss",
                                  "_contrib_CTCLoss"])
def test_ctc_loss(name, blank):
    data, label, _ = _ctc_case(np.random.RandomState(5), blank=blank)
    params = dict(blank_label=blank)
    check_outputs(name, [data, label], params, [F32])
    check_grads(name, [data, label], params)
    check_symbol_shapes(name, [data, label], params)


def test_ctc_loss_lengths():
    rs = np.random.RandomState(6)
    data, label, lab_len = _ctc_case(rs, blank="last")
    data_len = np.array([12, 7, 9], np.float32)
    arrays = [data, label, data_len, lab_len.astype(np.float32)]
    params = dict(use_data_lengths=True, use_label_lengths=True,
                  blank_label="last")
    check_outputs("ctc_loss", arrays, params, [F32])
    check_grads("ctc_loss", arrays, params)
    # nd.contrib.CTCLoss is the same op
    got = tmx.nd.contrib.CTCLoss(*[tmx.nd.array(a) for a in arrays],
                                 **params).asnumpy()
    want = mx.nd.contrib.CTCLoss(*[mx.nd.array(a) for a in arrays],
                                 **params).asnumpy()
    np.testing.assert_allclose(got, want, **F32)


# ---------------------------------------------------------------------------
# count_sketch / fft
# ---------------------------------------------------------------------------


def test_count_sketch():
    rs = np.random.RandomState(7)
    x = rs.randn(3, 8).astype(np.float32)
    h = rs.randint(0, 4, (8,)).astype(np.float32)
    s = (rs.randint(0, 2, (8,)) * 2 - 1).astype(np.float32)
    check_case("_contrib_count_sketch", [x, h, s], dict(out_dim=5), ARITH)


def test_fft_ifft():
    rs = np.random.RandomState(8)
    x = rs.randn(2, 3, 8).astype(np.float32)
    check_case("_contrib_fft", [x], {}, F32)
    check_case("_contrib_ifft", [rs.randn(2, 16).astype(np.float32)], {},
               F32)


# ---------------------------------------------------------------------------
# Proposal / MultiProposal
# ---------------------------------------------------------------------------


def _proposal_case(rs, N=2, H=4, W=4, ties=False):
    A = 12
    cls_prob = rs.rand(N, 2 * A, H, W).astype(np.float32)
    if ties:
        cls_prob = np.round(cls_prob * 4) / 4      # many equal scores
    bbox = (rs.randn(N, 4 * A, H, W) * 0.1).astype(np.float32)
    info = np.array([[64, 64, 1.0], [60, 48, 1.0]], np.float32)[:N]
    return cls_prob, bbox, info


@pytest.mark.parametrize("params", [
    dict(rpn_pre_nms_top_n=50, rpn_post_nms_top_n=10),
    dict(rpn_pre_nms_top_n=200, rpn_post_nms_top_n=40, threshold=0.5,
         rpn_min_size=8, output_score=True),
    dict(rpn_pre_nms_top_n=30, rpn_post_nms_top_n=64, output_score=True),
    dict(rpn_pre_nms_top_n=100, rpn_post_nms_top_n=12, scales=(2, 4),
         ratios=(1.0,), feature_stride=8, output_score=True)])
@pytest.mark.parametrize("name", ["_contrib_Proposal", "Proposal",
                                  "_contrib_MultiProposal", "MultiProposal"])
@pytest.mark.parametrize("ties", [False, True])
def test_proposal(name, params, ties):
    if "scales" in params:
        A = len(params["scales"]) * len(params["ratios"])
        rs = np.random.RandomState(9)
        arrays = [rs.rand(2, 2 * A, 4, 4).astype(np.float32),
                  (rs.randn(2, 4 * A, 4, 4) * 0.1).astype(np.float32),
                  np.array([[32, 32, 1.0], [30, 28, 1.0]], np.float32)]
    else:
        arrays = list(_proposal_case(np.random.RandomState(9), ties=ties))
    n_out = 2 if params.get("output_score") else 1
    check_outputs(name, arrays, params, [F32] * n_out)
    check_symbol_shapes(name, arrays, params)


# ---------------------------------------------------------------------------
# deformable convolution and the PSROI poolings
# ---------------------------------------------------------------------------

DCN_CASES = [
    # (x, offset channels factor, weight, params)
    ((2, 4, 6, 6), (3, 4, 3, 3), dict(kernel=(3, 3), pad=(1, 1),
                                      num_filter=3), True),
    ((1, 4, 5, 5), (4, 2, 3, 3), dict(kernel=(3, 3), pad=(1, 1),
                                      num_filter=4, num_group=2,
                                      num_deformable_group=2,
                                      no_bias=True), False),
    ((2, 2, 7, 7), (2, 2, 3, 3), dict(kernel=(3, 3), stride=(2, 2),
                                      dilate=(2, 2), pad=(2, 2),
                                      num_filter=2), True),
    ((1, 2, 4, 4), (2, 2, 3, 3), dict(kernel=(3, 3), num_filter=2,
                                      no_bias=True), False),
]


@pytest.mark.parametrize("case", range(len(DCN_CASES)))
@pytest.mark.parametrize("name", ["_contrib_DeformableConvolution",
                                  "DeformableConvolution"])
def test_deformable_convolution(name, case):
    xs, ws, params, bias = DCN_CASES[case]
    rs = np.random.RandomState(10 + case)
    x = rs.randn(*xs).astype(np.float32)
    w = rs.randn(*ws).astype(np.float32)
    kh, kw = ws[2:]
    sh, sw = params.get("stride", (1, 1))
    dh, dw = params.get("dilate", (1, 1))
    ph, pw = params.get("pad", (0, 0))
    Ho = (xs[2] + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (xs[3] + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    Gd = params.get("num_deformable_group", 1)
    # non-lattice offsets, some reaching past the border
    off = ((rs.rand(xs[0], 2 * Gd * kh * kw, Ho, Wo) - 0.5) * 2.4
           + 0.23).astype(np.float32)
    arrays = [x, off, w] + ([rs.randn(ws[0]).astype(np.float32)]
                            if bias else [])
    check_outputs(name, arrays, params, [F32])
    check_grads(name, arrays, params)
    check_symbol_shapes(name, arrays, params)


def _rois(rs, R, N, H, W):
    x1 = rs.randint(0, W // 2, R)
    y1 = rs.randint(0, H // 2, R)
    return np.stack([rs.randint(0, N, R), x1, y1,
                     x1 + rs.randint(1, W // 2, R),
                     y1 + rs.randint(1, H // 2, R)], 1).astype(np.float32)


@pytest.mark.parametrize("params", [
    dict(spatial_scale=1.0, output_dim=2, pooled_size=2, group_size=2),
    dict(spatial_scale=0.4, output_dim=2, pooled_size=3, group_size=3),
    dict(spatial_scale=0.5, output_dim=3, pooled_size=2)])
@pytest.mark.parametrize("name", ["_contrib_PSROIPooling", "PSROIPooling"])
def test_psroi_pooling(name, params):
    rs = np.random.RandomState(11)
    gs = params.get("group_size") or params["pooled_size"]
    data = rs.randn(2, params["output_dim"] * gs * gs, 8, 8).astype(
        np.float32)
    rois = _rois(rs, 5, 2, 8 / params["spatial_scale"],
                 8 / params["spatial_scale"])
    check_outputs(name, [data, rois], params, [F32])
    check_grads(name, [data, rois], params)
    check_symbol_shapes(name, [data, rois], params)


@pytest.mark.parametrize("params", [
    dict(spatial_scale=1.0, output_dim=2, group_size=2, pooled_size=2,
         sample_per_part=2, trans_std=0.3),
    dict(spatial_scale=0.5, output_dim=4, group_size=2, pooled_size=3,
         part_size=2, sample_per_part=3, trans_std=0.2)])
@pytest.mark.parametrize("name", ["_contrib_DeformablePSROIPooling",
                                  "DeformablePSROIPooling"])
def test_deformable_psroi_pooling(name, params):
    rs = np.random.RandomState(12)
    od, gs, P = params["output_dim"], params["group_size"], \
        params["pooled_size"]
    part = params.get("part_size") or P
    data = rs.randn(2, od * gs * gs, 7, 7).astype(np.float32)
    rois = _rois(rs, 4, 2, 7 / params["spatial_scale"],
                 7 / params["spatial_scale"])
    trans = ((rs.rand(4, 2 * 2, part, part) - 0.5) * 0.8).astype(np.float32)
    check_outputs(name, [data, rois, trans], params, [F32, EXACT])
    check_grads(name, [data, rois, trans], params)
    check_symbol_shapes(name, [data, rois, trans], params)
    # without trans
    no = dict(params, no_trans=True)
    ref = mx.nd.contrib.DeformablePSROIPooling(
        mx.nd.array(data), mx.nd.array(rois), None, **no)
    port = tmx.nd.contrib.DeformablePSROIPooling(
        tmx.nd.array(data), tmx.nd.array(rois), None, **no)
    for r, p in zip(ref, port):
        np.testing.assert_allclose(p.asnumpy(), r.asnumpy(), **F32)


def test_psroi_channel_check_raises():
    data = tmx.nd.zeros((1, 5, 4, 4))
    rois = tmx.nd.array([[0, 0, 0, 2, 2]])
    with pytest.raises(tmx.MXNetError, match="output_dim"):
        tmx.nd.contrib.PSROIPooling(data, rois, output_dim=2, pooled_size=2)


# ---------------------------------------------------------------------------
# bipartite_matching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("params", [
    dict(threshold=0.5), dict(is_ascend=True, threshold=0.5),
    dict(threshold=0.1, topk=2), dict(threshold=-1.0)])
def test_bipartite_matching(params):
    rs = np.random.RandomState(13)
    dist = rs.rand(2, 3, 4, 5).astype(np.float32)
    dist[0, 0, 1, :] = dist[0, 0, 0, :]         # equal rows
    dist[1, 2, :, 3] = dist[1, 2, 0, 0]         # an equal column
    dist[1, 1] = 0.75                           # every entry equal
    check_case("_contrib_bipartite_matching", [dist], params, EXACT)
    small = np.array([[0.9, 0.1, 0.2], [0.8, 0.7, 0.3]], np.float32)
    check_case("_contrib_bipartite_matching", [small], params, EXACT)


# ---------------------------------------------------------------------------
# namespaces
# ---------------------------------------------------------------------------

CONTRIB_15 = ["MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
              "box_iou", "box_nms", "ctc_loss", "count_sketch", "fft",
              "ifft", "Proposal", "MultiProposal", "DeformableConvolution",
              "PSROIPooling", "DeformablePSROIPooling", "bipartite_matching"]


def test_contrib_namespaces_have_the_ops():
    for short in CONTRIB_15 + ["CTCLoss"]:
        for ns in ("nd.contrib", "contrib.ndarray", "sym.contrib"):
            ref_ns, port_ns = mx, tmx
            for part in ns.split("."):
                ref_ns, port_ns = getattr(ref_ns, part), getattr(port_ns,
                                                                 part)
            assert hasattr(port_ns, short) == hasattr(ref_ns, short), \
                (ns, short)
        full = "_contrib_" + short
        assert full in port_registry.OPS, full
        assert port_registry.get(full).differentiable == \
            ref_registry.get(full).differentiable, full
    assert hasattr(tmx.nd.contrib, "CTCLoss")
    # every name (aliases too) of the reference's ops/contrib.py
    import mxnet_tpu.ops.contrib  # noqa: F401
    assert {n for n, od in ref_registry.OPS.items()
            if od.fn.__module__ == "mxnet_tpu.ops.contrib"} <= \
        set(port_registry.OPS)
