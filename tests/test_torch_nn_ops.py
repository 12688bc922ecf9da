"""Port parity for the rest of `ops/nn.py` (hard_sigmoid, softmin,
SoftmaxActivation, LRN, UpSampling, Crop, GridGenerator,
BilinearSampler, SpatialTransformer, ROIPooling, Correlation,
IdentityAttachKLSparseReg, _contrib_AdaptiveAvgPooling2D,
_contrib_BilinearResize2D, _image_to_tensor, _image_normalize) against
the JAX reference on the CPU.

Each case of `test_nn_op_parity` holds values, dtypes, the gradient under
each package's autodiff and Symbol shapes (the helpers of
test_torch_tensor_ops.py). The cases include a shrinking
BilinearResize2D (jax.image.resize antialiases, as torch's antialiased
bilinear interpolation does), multi-input UpSampling (half-pixel
nearest), half-way ROI coordinates (rounded half to even), sampling grids
that leave the image, and correlation shifts that wrap around; a
non-divisible AdaptiveAvgPooling2D raises in both. Mirrors
tests/test_operator.py's test_lrn_l2norm, test_upsampling_bilinear_resize,
test_grid_bilinear_sampler and test_roi_pooling.

Tolerances: arithmetic 1e-6, exp/sqrt/power-based ops (softmin, LRN,
resampling weights) 1e-5; gradients likewise.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as ref_registry

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops import registry as port_registry

from test_torch_tensor_ops import ARITH, EXACT, TRANS, check_case, \
    check_values, rnd

NN_NAMES = ("hard_sigmoid", "softmin", "SoftmaxActivation", "LRN",
            "UpSampling", "Crop", "GridGenerator", "BilinearSampler",
            "SpatialTransformer", "ROIPooling", "Correlation",
            "IdentityAttachKLSparseReg", "_contrib_AdaptiveAvgPooling2D",
            "_contrib_BilinearResize2D", "_image_to_tensor",
            "_image_normalize")


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _affine(rs, n, scale=0.3):
    eye = np.tile(np.array([[1, 0, 0, 0, 1, 0]], np.float32), (n, 1))
    return eye + rnd(rs, n, 6, lo=-scale, hi=scale)


def _rois(rs):
    # (batch, x1, y1, x2, y2); the .5 coordinates round half to even
    return np.array([[0, 0.5, 1.5, 6.5, 5.5], [1, 2.0, 0.0, 7.0, 7.0],
                     [0, 3.2, 2.7, 3.9, 4.1], [1, 1.5, 2.5, 2.5, 3.5]],
                    np.float32)


CASES = {
    "hard_sigmoid": lambda rs: ([rnd(rs, 3, 4, lo=-4, hi=4)],
                                {"alpha": 0.3, "beta": 0.4}, ARITH),
    "softmin": lambda rs: ([rnd(rs, 3, 5, lo=-2, hi=2)], {"axis": 0},
                           TRANS),
    "softmin/temperature": lambda rs: ([rnd(rs, 3, 5, lo=-2, hi=2)],
                                       {"temperature": 2.0}, TRANS),
    "SoftmaxActivation": lambda rs: ([rnd(rs, 2, 3, 4, lo=-2, hi=2)], {},
                                     TRANS),
    "SoftmaxActivation/channel": lambda rs: ([rnd(rs, 2, 3, 4, lo=-2, hi=2)],
                                             {"mode": "channel"}, TRANS),
    "LRN": lambda rs: ([rnd(rs, 2, 6, 3, 3)], {"nsize": 3}, TRANS),
    "LRN/wide": lambda rs: ([rnd(rs, 2, 6, 3, 3)],
                            {"nsize": 5, "alpha": 0.1, "beta": 0.5,
                             "knorm": 1.0}, TRANS),
    "UpSampling": lambda rs: ([rnd(rs, 1, 2, 3, 3)], {"scale": 2}, EXACT),
    "UpSampling/bilinear": lambda rs: ([rnd(rs, 1, 2, 3, 4)],
                                       {"scale": 2,
                                        "sample_type": "bilinear"}, TRANS),
    "UpSampling/concat": lambda rs: ([rnd(rs, 1, 2, 3, 3),
                                      rnd(rs, 1, 3, 5, 4)],
                                     {"scale": 2, "num_args": 2}, EXACT),
    "UpSampling/sum": lambda rs: ([rnd(rs, 1, 2, 4, 6), rnd(rs, 1, 2, 3, 3)],
                                  {"scale": 3, "num_args": 2,
                                   "multi_input_mode": "sum"}, ARITH),
    "Crop": lambda rs: ([rnd(rs, 2, 3, 6, 7)],
                        {"offset": (1, 2), "h_w": (3, 4)}, EXACT),
    "Crop/center": lambda rs: ([rnd(rs, 2, 3, 6, 7)],
                               {"h_w": (3, 4), "center_crop": True}, EXACT),
    "Crop/like": lambda rs: ([rnd(rs, 2, 3, 6, 7), rnd(rs, 1, 1, 4, 5)],
                             {"num_args": 2, "offset": (2, 1)}, EXACT),
    "GridGenerator": lambda rs: ([_affine(rs, 2)],
                                 {"target_shape": (4, 5)}, TRANS),
    "GridGenerator/warp": lambda rs: ([rnd(rs, 2, 2, 4, 5)],
                                      {"transform_type": "warp",
                                       "target_shape": (4, 5)}, EXACT),
    # the grid leaves [-1, 1] on every side
    "BilinearSampler": lambda rs: ([rnd(rs, 2, 3, 5, 6),
                                    rnd(rs, 2, 2, 4, 7, lo=-1.3, hi=1.3)],
                                   {}, TRANS),
    "SpatialTransformer": lambda rs: ([rnd(rs, 2, 3, 6, 6),
                                       _affine(rs, 2, scale=0.5)],
                                      {"target_shape": (5, 4)}, TRANS),
    "ROIPooling": lambda rs: ([rnd(rs, 2, 3, 8, 8), _rois(rs)],
                              {"pooled_size": (2, 3)}, EXACT),
    "ROIPooling/scaled": lambda rs: ([rnd(rs, 2, 3, 8, 8),
                                      (_rois(rs) * [1, 2, 2, 2, 2]).astype(
                                          np.float32)],
                                     {"pooled_size": (3, 3),
                                      "spatial_scale": 0.5}, EXACT),
    "Correlation": lambda rs: ([rnd(rs, 2, 4, 6, 7), rnd(rs, 2, 4, 6, 7)],
                               {"max_displacement": 2}, TRANS),
    "Correlation/abs_pad_stride": lambda rs: (
        [rnd(rs, 2, 4, 6, 7), rnd(rs, 2, 4, 6, 7)],
        {"max_displacement": 2, "pad_size": 2, "stride1": 2, "stride2": 2,
         "is_multiply": False}, TRANS),
    "IdentityAttachKLSparseReg": lambda rs: ([rnd(rs, 4, 6, lo=0.05,
                                                  hi=0.95)],
                                             {"sparseness_target": 0.2,
                                              "penalty": 0.01}, TRANS),
    "_contrib_AdaptiveAvgPooling2D": lambda rs: ([rnd(rs, 2, 3, 6, 8)],
                                                 {"output_size": (3, 2)},
                                                 TRANS),
    "_contrib_AdaptiveAvgPooling2D/global": lambda rs: (
        [rnd(rs, 2, 3, 6, 8)], {}, TRANS),
    "_contrib_BilinearResize2D": lambda rs: ([rnd(rs, 1, 2, 4, 5)],
                                             {"height": 9, "width": 11},
                                             TRANS),
    "_contrib_BilinearResize2D/shrink": lambda rs: (
        [rnd(rs, 1, 2, 9, 13)], {"height": 4, "width": 5}, TRANS),
    "_contrib_BilinearResize2D/mixed": lambda rs: (
        [rnd(rs, 1, 2, 9, 4)], {"height": 5, "width": 10}, TRANS),
    "_contrib_BilinearResize2D/scale": lambda rs: (
        [rnd(rs, 1, 2, 6, 8)], {"scale_height": 0.5, "scale_width": 1.5},
        TRANS),
    "_image_to_tensor": lambda rs: (
        [rs.randint(0, 256, (5, 6, 3)).astype(np.uint8)], {}, ARITH),
    "_image_to_tensor/batch": lambda rs: (
        [rs.randint(0, 256, (2, 5, 6, 3)).astype(np.uint8)], {}, ARITH),
    "_image_normalize": lambda rs: ([rnd(rs, 3, 5, 6, lo=0, hi=1)],
                                    {"mean": (0.4, 0.5, 0.6),
                                     "std": (0.2, 0.3, 0.25)}, TRANS),
    "_image_normalize/batch": lambda rs: ([rnd(rs, 2, 3, 5, 6, lo=0, hi=1)],
                                          {"mean": (0.4, 0.5, 0.6),
                                           "std": (0.2, 0.3, 0.25)}, TRANS),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_nn_op_parity(case):
    name = case.split("/")[0]
    arrays, params, tol = CASES[case](np.random.RandomState(
        sum(map(ord, case)) % 1000))
    check_case(name, arrays, params, tol)


def test_every_nn_name_has_a_case():
    assert {c.split("/")[0] for c in CASES} == set(NN_NAMES)
    ref_nn = {n for n, od in ref_registry.OPS.items()
              if od.fn.__module__ == "mxnet_tpu.ops.nn"}
    assert not sorted(ref_nn - set(port_registry.OPS))


def test_adaptive_avg_pooling_needs_divisible_sizes():
    x = np.random.RandomState(0).rand(1, 2, 5, 7).astype(np.float32)
    with pytest.raises(TypeError):
        mx.nd.contrib.AdaptiveAvgPooling2D(mx.nd.array(x), output_size=2)
    with pytest.raises(TypeError):
        tmx.nd.contrib.AdaptiveAvgPooling2D(tmx.nd.array(x), output_size=2)


def test_roi_pooling_halfway_and_empty_bins():
    """The reference's test input, a ROI at half-way coordinates (2.5
    rounds to 2, 3.5 to 4) and one whose bins no pixel reaches (0)."""
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.array([[0, 0, 0, 3, 3], [0, 2.5, 0.5, 3.5, 2.5],
                     [0, 3, 3, 3, 3]], np.float32)
    _, port = check_values("ROIPooling", [x, rois], {"pooled_size": (2, 2)},
                           EXACT)
    assert port[0][0, 0, 1, 1] == 15.0


def test_identity_kl_sparse_reg_adds_the_penalty():
    data = tmx.nd.array(np.full((4, 3), 0.5, np.float32))
    data.attach_grad()
    with tmx.autograd.record():
        out = tmx.nd.IdentityAttachKLSparseReg(data, sparseness_target=0.1,
                                               penalty=1.0)
    out.backward()
    np.testing.assert_array_equal(out.asnumpy(), data.asnumpy())
    kl = -0.1 / 0.5 + 0.9 / 0.5
    np.testing.assert_allclose(data.grad.asnumpy(), 1.0 + kl, **ARITH)
