"""Port parity for the fused BatchNorm / ReLU / residual epilogue
(mxnet_tpu_torch/ops/fused_bn.py, the K3a-d kernels' plain versions and
the autograd Function) and the BatchNorm ops that select it
(mxnet_tpu_torch/ops/nn.py) against the JAX reference on the CPU.

The reference's Pallas kernels (mxnet_tpu/ops/pallas_fused.py) run in
interpret mode, as tests/test_pallas.py runs them; on CPU tensors the
port's wrappers run their plain versions. Inputs are made with numpy from
a seed and handed to both.

Tolerances (tests/test_pallas.py:92-98, :185-186): float32 outputs 1e-5
(the two sum the statistics in other orders); bfloat16 outputs 3e-2 (one
rounding to 8 mantissa bits, from float32 values that may differ in the
last bits); per-channel sums and float32 gradients 1e-4 (sums over up to
6272 elements taken in another order); bfloat16 gradients rtol 5e-2 /
atol 2e-1 (dz is a bfloat16 tensor in both, and near-cancelling channel
sums of O(1) terms carry ~1e-1 of absolute rounding noise).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import nn as ref_nn
from mxnet_tpu.ops import pallas_fused as pf

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_bn as fb
from mxnet_tpu_torch.ops import nn as port_nn

_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_OUT_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
            "bfloat16": dict(rtol=3e-2, atol=3e-2)}
_SUM_TOL = dict(rtol=1e-4, atol=1e-4)
_GRAD_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=5e-2, atol=2e-1)}
#: [N, C, S] views: a residual-block shape, C=3 with an odd S, and S=1
_SHAPES3 = [(2, 8, 36), (3, 3, 35), (4, 16, 1), (2, 8, 3136)]
#: odd S of Inception-v3's step (17x17, 35x35) and ResNet-50's S that are
#: not whole 16-byte vectors in bfloat16 (7x7, 14x14)
_ODD_S3 = [(2, 8, 289), (2, 8, 1225), (2, 8, 49), (2, 8, 196)]


def _np(t):
    """numpy float32 of a torch tensor or a jax array (bf16 widened)."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _pair(arr, dname):
    """The same numpy float32 values as a jax and a torch array."""
    jd, td = _DT[dname]
    return (jnp.asarray(arr).astype(jd),
            torch.from_numpy(np.array(arr, dtype=np.float32)).to(td))


def _inputs(shape3, dname, seed):
    rng = np.random.RandomState(seed)
    N, C, S = shape3
    x = (rng.randn(N, C, S) * 2 + rng.randn(1, C, 1)).astype(np.float32)
    r = rng.randn(N, C, S).astype(np.float32)
    dy = rng.randn(N, C, S).astype(np.float32)
    g = (rng.rand(C) + 0.5).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    return x, r, dy, g, b


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape3", _SHAPES3)
def test_stats_plain_matches_pallas(dname, shape3):
    """K3a: mean and var = max(E[x^2] - E[x]^2, 0), float32 [C]."""
    x, *_ = _inputs(shape3, dname, 0)
    jx, tx = _pair(x, dname)
    jm, jv = pf._bn_stats(jx, True)
    tm, tv = fb.bn_stats(tx)
    assert tm.dtype == torch.float32 and tv.dtype == torch.float32
    np.testing.assert_allclose(_np(tm), _np(jm), **_SUM_TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **_SUM_TOL)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("shape3", _SHAPES3[:3])
def test_apply_plain_matches_pallas(dname, relu, res, shape3):
    """K3b, the four epilogue variants: y = [relu](x*scale + offset
    [+ residual]) in x's dtype."""
    x, r, _, g, b = _inputs(shape3, dname, 1)
    jx, tx = _pair(x, dname)
    jr, tr = _pair(r, dname) if res else (None, None)
    scale, offset = g * 0.7, b - 0.3
    jy = pf._bn_apply(jx, jnp.asarray(scale)[:, None],
                      jnp.asarray(offset)[:, None], jr, relu, True)
    ty = fb.bn_apply(tx, torch.from_numpy(scale), torch.from_numpy(offset),
                     tr, relu)
    assert ty.dtype == tx.dtype
    np.testing.assert_allclose(_np(ty), _np(jy), **_OUT_TOL[dname])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape3", _SHAPES3 + _ODD_S3)
def test_bwd_reduce_plain_matches_pallas(dname, relu, shape3):
    """K3c: dz (relu only, rounded to the activation dtype) and the
    channel sums of dz and dz * xhat over the same rounded dz."""
    x, r, dy, g, b = _inputs(shape3, dname, 2)
    jx, tx = _pair(x, dname)
    jdy, tdy = _pair(dy, dname)
    jy, ty = _pair(r, dname)        # any signs: the relu mask's source
    mean = x.mean(axis=(0, 2)).astype(np.float32)
    inv = (1.0 / np.sqrt(x.var(axis=(0, 2)) + 1e-5)).astype(np.float32)
    jdz, jsdz, jsdx = pf._bwd_reduce(jdy, jy, jx, jnp.asarray(mean),
                                     jnp.asarray(inv), relu, True)
    tdz, tsdz, tsdx = fb.bn_bwd_reduce(tdy, ty, tx, torch.from_numpy(mean),
                                       torch.from_numpy(inv), relu)
    if relu:
        assert tdz.dtype == tx.dtype
        np.testing.assert_array_equal(_np(tdz), _np(jdz))
    else:
        assert tdz is tdy
    np.testing.assert_allclose(_np(tsdz), _np(jsdz), **_SUM_TOL)
    np.testing.assert_allclose(_np(tsdx), _np(jsdx), **_SUM_TOL)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape3", _SHAPES3[:3])
def test_bwd_dx_plain_matches_pallas(dname, shape3):
    """K3d: dx = c1 * dz + c2 * x + c3 in x's dtype."""
    x, r, dy, g, b = _inputs(shape3, dname, 3)
    jx, tx = _pair(x, dname)
    jdz, tdz = _pair(dy, dname)
    c1, c2, c3 = g, b * 0.1, (g - b) * 0.01
    jdx = pf._bwd_dx(jdz, jx, *(jnp.asarray(c)[:, None]
                                for c in (c1, c2, c3)), True)
    tdx = fb.bn_bwd_dx(tdz, tx, *(torch.from_numpy(c) for c in (c1, c2, c3)))
    assert tdx.dtype == tx.dtype
    np.testing.assert_allclose(_np(tdx), _np(jdx), **_OUT_TOL[dname])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 8, 6, 6), (2, 8, 56, 56)])
def test_fused_bn_act_forward_matches_pallas(dname, shape):
    """y, mean, var of the whole epilogue (relu + residual), as
    tests/test_pallas.py:103 holds the reference."""
    rng = np.random.RandomState(0)
    C = shape[1]
    x, r = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    g = (rng.rand(C) + 0.5).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    jx, tx = _pair(x, dname)
    jr, tr = _pair(r, dname)
    jy, jm, jv = pf.fused_bn_act(jx, jnp.asarray(g), jnp.asarray(b),
                                 eps=1e-3, act="relu", residual=jr,
                                 interpret=True)
    ty, tm, tv = fb.fused_bn_act(tx, torch.from_numpy(g), torch.from_numpy(b),
                                 eps=1e-3, act="relu", residual=tr)
    assert ty.dtype == tx.dtype and ty.shape == tx.shape
    assert tm.dtype == torch.float32 and tv.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **_OUT_TOL[dname])
    np.testing.assert_allclose(_np(tm), _np(jm), **_SUM_TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **_SUM_TOL)


@pytest.mark.parametrize("act,with_res,dname", [
    ("relu", True, "float32"), ("relu", False, "float32"),
    (None, True, "float32"), (None, False, "float32"),
    ("relu", True, "bfloat16")])
def test_fused_bn_act_grads_match_pallas(act, with_res, dname):
    """Gradients of x, gamma, beta and the residual under a loss that also
    uses mean and var (their cotangents reach the backward), against
    jax.grad through the reference's custom VJP (tests/test_pallas.py:136).
    """
    N, C, H, W = 2, 8, 12, 12
    rng = np.random.RandomState(1)
    x = rng.randn(N, C, H, W).astype(np.float32)
    r = rng.randn(N, C, H, W).astype(np.float32)
    g = (rng.rand(C) + 0.5).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    w = rng.randn(N, C, H, W).astype(np.float32)
    eps = 1e-3
    jd, td = _DT[dname]
    if dname == "bfloat16":
        # a pre-activation within bf16 rounding of 0 may flip the relu
        # mask between the two implementations: zero the loss weight there
        # (the reference test's trick, tests/test_pallas.py:151-162)
        xb = np.asarray(jnp.asarray(x).astype(jd).astype(jnp.float32))
        rb = np.asarray(jnp.asarray(r).astype(jd).astype(jnp.float32))
        m = xb.mean(axis=(0, 2, 3), keepdims=True)
        v = xb.var(axis=(0, 2, 3), keepdims=True)
        z = (xb - m) / np.sqrt(v + eps) * g[None, :, None, None] \
            + b[None, :, None, None] + (rb if with_res else 0)
        w = w * (np.abs(z) > 0.02)
    jx, jr, jw = (jnp.asarray(a).astype(jd) for a in (x, r, w))

    def loss_ref(x_, g_, b_, r_):
        y, mean, var = pf.fused_bn_act(x_, g_, b_, eps=eps, act=act,
                                       residual=r_, interpret=True)
        return jnp.sum((y * jw).astype(jnp.float32)) \
            + jnp.sum(jnp.sin(mean) + jnp.cos(var))

    argnums = (0, 1, 2, 3) if with_res else (0, 1, 2)
    want = jax.grad(loss_ref, argnums=argnums)(
        jx, jnp.asarray(g), jnp.asarray(b), jr if with_res else None)

    tx, tr, tw = (torch.from_numpy(a).to(td).requires_grad_(True)
                  for a in (x, r, w))
    tg = torch.from_numpy(g).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    y, mean, var = fb.fused_bn_act(tx, tg, tb, eps=eps, act=act,
                                   residual=tr if with_res else None)
    loss = (y * tw.detach()).float().sum() \
        + (torch.sin(mean) + torch.cos(var)).sum()
    ins = (tx, tg, tb, tr) if with_res else (tx, tg, tb)
    got = torch.autograd.grad(loss, ins)
    for name, a, e, inp in zip(("dx", "dgamma", "dbeta", "dres"), got, want,
                               ins):
        assert a.dtype == inp.dtype, name
        np.testing.assert_allclose(_np(a), _np(e), err_msg=name,
                                   **_GRAD_TOL[dname])


# ---------------------------------------------------------------------------
# the ops that select the fused path (ops/nn.py)
# ---------------------------------------------------------------------------


def _op_inputs(shape, seed=2):
    rng = np.random.RandomState(seed)
    C = shape[1]
    x = rng.randn(*shape).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    g = (rng.rand(C) + 0.5).astype(np.float32)
    b = rng.randn(C).astype(np.float32)
    mm = rng.randn(C).astype(np.float32) * 0.1
    mv = (rng.rand(C) + 0.5).astype(np.float32)
    return x, r, g, b, mm, mv


def _count_fused(monkeypatch):
    """Record the residual each fused_bn_act call of the ops is given."""
    calls = []
    real = port_nn.fused_bn.fused_bn_act
    monkeypatch.setattr(
        port_nn.fused_bn, "fused_bn_act",
        lambda *a, **k: calls.append(k.get("residual")) or real(*a, **k))
    return calls


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("fix_gamma", [False, True])
def test_batchnorm_op_matches_reference(monkeypatch, flag, training,
                                        fix_gamma):
    """The BatchNorm op, flag on and off, training and eval mode:
    (out, batch mean, batch var), and the fused path taken exactly when
    the reference's selection rule says so."""
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", flag)
    x, _, g, b, mm, mv = _op_inputs((2, 8, 7, 7))
    calls = _count_fused(monkeypatch)
    kw = dict(eps=1e-3, fix_gamma=fix_gamma)
    scope = mx.autograd.record() if training else mx.autograd.predict_mode()
    with scope:
        want = ref_nn.BatchNorm(*(jnp.asarray(a) for a in (x, g, b, mm, mv)),
                                **kw)
    tscope = tmx.autograd.train_mode() if training \
        else tmx.autograd.predict_mode()
    with tscope:
        got = port_nn.BatchNorm(*(torch.from_numpy(a)
                                  for a in (x, g, b, mm, mv)), **kw)
    assert len(calls) == int(flag == "1" and training)
    for name, a, e in zip(("out", "mean", "var"), got, want):
        np.testing.assert_allclose(_np(a), _np(e), err_msg=name,
                                   **_OUT_TOL["float32"])


@pytest.mark.parametrize("flag", ["0", "1"])
@pytest.mark.parametrize("act,with_res", [("relu", True), ("relu", False),
                                          (None, True)])
def test_batchnorm_add_relu_op_matches_reference(monkeypatch, flag, act,
                                                 with_res):
    """_contrib_BatchNormAddRelu forward and gradients (x, gamma, beta,
    addend) in training mode, flag on and off, against the reference op
    under jax.grad with the same flag."""
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", flag)
    x, r, g, b, mm, mv = _op_inputs((2, 8, 6, 6), seed=4)
    w = np.random.RandomState(5).randn(*x.shape).astype(np.float32)
    calls = _count_fused(monkeypatch)

    def loss_ref(x_, g_, b_, r_):
        out, mean, var = ref_nn.BatchNormAddRelu(
            x_, g_, b_, jnp.asarray(mm), jnp.asarray(mv),
            addend=r_ if with_res else None, eps=1e-3, fix_gamma=False,
            act_type=act)
        return jnp.sum(out * jnp.asarray(w)) + jnp.sum(mean + var), out

    with mx.autograd.record():
        (_, jout), want = jax.value_and_grad(
            loss_ref, argnums=(0, 1, 2, 3), has_aux=True)(
            *(jnp.asarray(a) for a in (x, g, b, r)))
    tx, tg, tb, tr = (torch.from_numpy(a).requires_grad_(True)
                      for a in (x, g, b, r))
    with tmx.autograd.train_mode():
        out, mean, var = port_nn.BatchNormAddRelu(
            tx, tg, tb, torch.from_numpy(mm), torch.from_numpy(mv),
            addend=tr if with_res else None, eps=1e-3, fix_gamma=False,
            act_type=act)
    loss = (out * torch.from_numpy(w)).sum() + (mean + var).sum()
    got = torch.autograd.grad(loss, (tx, tg, tb, tr) if with_res
                              else (tx, tg, tb))
    assert len(calls) == int(flag == "1")
    np.testing.assert_allclose(_np(out), _np(jout), **_OUT_TOL["float32"])
    for name, a, e in zip(("dx", "dgamma", "dbeta", "daddend"), got, want):
        np.testing.assert_allclose(_np(a), _np(e), err_msg=name,
                                   **_GRAD_TOL["float32"])


def test_selection_keeps_the_composite_outside_the_fused_conditions(
        monkeypatch):
    """Flag on, the reference's rule: channels-last, float64 and eval mode
    keep the composite; an addend of another shape is added outside, after
    the BatchNorm op (which fuses the normalization alone)."""
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", "1")
    calls = _count_fused(monkeypatch)
    x, r, g, b, mm, mv = (torch.from_numpy(a)
                          for a in _op_inputs((2, 4, 5, 4)))
    with tmx.autograd.train_mode():
        port_nn.BatchNorm(x, g[:4], b[:4], mm[:4], mv[:4], axis=3)
        port_nn.BatchNorm(x.double(), g, b, mm, mv)
        assert calls == []
        port_nn.BatchNormAddRelu(x, g, b, mm, mv, addend=r[:, :, :1])
        assert len(calls) == 1 and calls[0] is None
        port_nn.BatchNormAddRelu(x, g, b, mm, mv, addend=r)
        assert len(calls) == 2 and calls[1] is r
    port_nn.BatchNormAddRelu(x, g, b, mm, mv, addend=r)   # not training
    assert len(calls) == 2


def test_gate_names_its_limit():
    assert fb.fused_bn_supported(torch.zeros(2, 8, 6, 6))
    assert fb.fused_bn_supported(torch.zeros(4, 16, dtype=torch.bfloat16))
    assert not fb.fused_bn_supported(torch.zeros(2, 8, 6, 6), axis=3)
    assert not fb.fused_bn_supported(torch.zeros(2, 8, 6, 6,
                                                 dtype=torch.float16))
    assert fb.fused_bn_limit((2, 0, 3), torch.float32) == \
        "empty shape (2, 0, 3)"
    with pytest.raises(MXNetError, match="channels on axis 1"):
        fb.fused_bn_act(torch.zeros(4), torch.ones(4), torch.zeros(4))
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        fb.fused_bn_act(torch.zeros(2, 3, dtype=torch.float64),
                        torch.ones(3), torch.zeros(3))
    with pytest.raises(ValueError, match="act"):
        fb.fused_bn_act(torch.zeros(2, 3), torch.ones(3), torch.zeros(3),
                        act="tanh")


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    x = torch.randn(2, 4, 9)
    before = fb.launch_counts()
    mean, var = fb.bn_stats(x)
    y = fb.bn_apply(x, torch.ones(4), torch.zeros(4), None, True)
    fb.bn_bwd_reduce(y, y, x, mean, torch.rsqrt(var + 1e-5), True)
    fb.bn_bwd_dx(y, x, torch.ones(4), torch.ones(4), torch.zeros(4))
    assert fb.launch_counts() == before
    torch.testing.assert_close(fb.bn_stats(x), fb.bn_stats_plain(x))


def test_call_cost_is_the_references_declared_cost():
    """The bytes and flops chip_smoke.py's bound reads are the reference's
    cost estimates (pallas_fused.py:177, :223, :310, :345)."""
    N, C, S = 4, 8, 49
    n = N * C * S
    assert fb.fused_bn_call_cost("stats", N, C, S, 2) == (3 * n, 2 * n + 8 * C)
    assert fb.fused_bn_call_cost("apply", N, C, S, 4, relu=True,
                                 residual=True) == (4 * n, 12 * n + 8 * C)
    assert fb.fused_bn_call_cost("bwd_reduce", N, C, S, 4, relu=False) == \
        (6 * n, 8 * n + 16 * C)
    assert fb.fused_bn_call_cost("bwd_dx", N, C, S, 2) == \
        (4 * n, 6 * n + 12 * C)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape3", [(2, 5, 49), (3, 3, 196), (2, 7, 3)])
def test_bwd_dx_plain_matches_pallas_across_row_ends(dname, shape3):
    """K3d where rows are not whole 16-byte vectors (S = 49 and 196, the
    14x14 and 7x7 BatchNorms of ResNet-50, and S = 3 below the vector
    width), odd C: the shapes whose vectors the kernel splits between two
    channels."""
    x, r, dy, g, b = _inputs(shape3, dname, 11)
    jx, tx = _pair(x, dname)
    jdz, tdz = _pair(dy, dname)
    c1, c2, c3 = g, b * 0.1, (g - b) * 0.01
    jdx = pf._bwd_dx(jdz, jx, *(jnp.asarray(c)[:, None]
                                for c in (c1, c2, c3)), True)
    tdx = fb.bn_bwd_dx(tdz, tx, *(torch.from_numpy(c) for c in (c1, c2, c3)))
    np.testing.assert_allclose(_np(tdx), _np(jdx), **_OUT_TOL[dname])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape3", [(2, 5, 49), (3, 3, 196), (2, 7, 3)])
def test_stats_plain_matches_pallas_across_row_ends(dname, shape3):
    """K3a where rows are not whole 16-byte vectors (S = 49 and 196) and
    S = 3 below the vector width, with C not a multiple of the kernel's
    channel group (8 channels a span at S = 49 in bfloat16)."""
    x, *_ = _inputs(shape3, dname, 12)
    jx, tx = _pair(x, dname)
    jm, jv = pf._bn_stats(jx, True)
    tm, tv = fb.bn_stats(tx)
    np.testing.assert_allclose(_np(tm), _np(jm), **_SUM_TOL)
    np.testing.assert_allclose(_np(tv), _np(jv), **_SUM_TOL)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu,res", [(False, False), (True, True),
                                      (True, False), (False, True)])
@pytest.mark.parametrize("shape3", [(2, 5, 49), (3, 3, 196), (2, 7, 3)])
def test_apply_plain_matches_pallas_across_row_ends(dname, relu, res,
                                                    shape3):
    """K3b at the shapes whose 16-byte vectors the kernel splits between
    two channels (S = 49, 196) or several (S = 3), odd C."""
    x, r, _, g, b = _inputs(shape3, dname, 13)
    jx, tx = _pair(x, dname)
    jr, tr = _pair(r, dname) if res else (None, None)
    scale, offset = g * 0.7, b - 0.3
    jy = pf._bn_apply(jx, jnp.asarray(scale)[:, None],
                      jnp.asarray(offset)[:, None], jr, relu, True)
    ty = fb.bn_apply(tx, torch.from_numpy(scale), torch.from_numpy(offset),
                     tr, relu)
    np.testing.assert_allclose(_np(ty), _np(jy), **_OUT_TOL[dname])


@pytest.mark.parametrize("itemsize", [2, 4])
def test_stats_cluster_fills_one_wave_at_the_resnet_shapes(itemsize):
    """K3a's grid (C / G channel groups x P blocks, P the cluster size):
    P is 1, 2, 4 or 8 and at most N, and at every BatchNorm shape of a
    batch-256 ResNet-50 step the grid gives each SM about two blocks, or
    one a channel group where there are more groups than that."""
    import chip_smoke as cs
    for C, H, W, *_ in cs.R50_BNS:
        S = H * W
        P = fb._stats_cluster(cs.R50_BATCH, C, S, itemsize)
        V = 16 // itemsize
        G = V // np.gcd(S, V)
        assert C % G == 0 and (G == 1 or G * S // V <= fb._THREADS)
        assert P in (1, 2, 4, 8)
        blocks = C // G * P
        assert blocks >= 256
        assert blocks <= fb._SMS * fb._STATS_BLOCKS_PER_SM or P == 1
    assert fb._stats_cluster(1, 3, 5, 2) == 1
    assert fb._stats_cluster(3, 16, 49, 2) == 2
    assert fb._stats_cluster(256, 3, 49, 2) == 8


def _main_path_bn_shapes():
    """(N, C, S) of every BatchNorm of the two main paths' steps: the 13
    of a batch-256 ResNet-50 step and the 18 of a batch-128 Inception-v3
    step."""
    import chip_smoke as cs
    return ([(cs.R50_BATCH, C, H * W) for C, H, W, *_ in cs.R50_BNS]
            + [(cs.INC_BATCH, C, H * W) for C, H, W, _ in cs.INC_BNS])


#: clusters of P K3c blocks an H100 80GB HBM3 runs at once, by P (the
#: card's cudaOccupancyMaxActiveClusters, printed by chip_smoke.py's
#: phase 8; float32 and bfloat16, relu on and off alike)
_H100_AT_ONCE = {1: 264, 2: 132, 4: 62, 8: 30}


def test_reduce_cluster_fills_one_wave_at_the_main_path_shapes():
    """K3c's grid (C channels x P blocks, P the cluster size): P is 1, 2,
    4 or 8 and at most N, the C clusters all run at once unless P is 1,
    and P is the most that does, at the 31 main-path shapes and the
    ragged ones (C 3 and S 35 at N 7; S 1; C 2048)."""
    shapes = _main_path_bn_shapes()
    assert len(shapes) == 31
    at_once = _H100_AT_ONCE
    for N, C, S in shapes + [(7, 3, 35), (256, 2048, 1), (256, 2048, 49),
                             (1, 3, 5), (3, 16, 49)]:
        P = fb._reduce_cluster(N, C, at_once)
        assert P in (1, 2, 4, 8) and P <= N
        assert C <= at_once[P] or P == 1
        # one more doubling would pass N, the cluster size or the wave
        assert 2 * P > min(fb._MAX_CLUSTER, N) or C > at_once[2 * P]
    assert fb._reduce_cluster(128, 32, at_once) == 4   # Inception 149x149
    assert fb._reduce_cluster(128, 64, at_once) == 2
    assert fb._reduce_cluster(128, 192, at_once) == 1
    assert fb._reduce_cluster(7, 3, at_once) == 4
    assert fb._reduce_cluster(1, 3, at_once) == 1
    assert fb._reduce_cluster(128, 32, {1: 264, 2: 132, 4: 60, 8: 32}) == 8


def test_chip_smoke_inc_bns_are_the_nets_batchnorm_shapes():
    """chip_smoke.INC_BNS (the Inception-v3 shapes tools/bn_ab.py times
    and phase 16 checks its hooks against) is what the model zoo's
    inception_v3 runs at 299x299: 18 shapes, 94 BatchNorms."""
    import chip_smoke as cs
    with tmx.cpu():
        got = cs.inception_bn_shapes(torch, tmx)
    assert got == {(C, H, W): n for C, H, W, n in cs.INC_BNS}
    assert len(got) == 18 and sum(got.values()) == 94


@pytest.mark.parametrize("relu,res,kinds", [
    (False, False, {"stats", "apply", "bwd_reduce", "bwd_dx"}),
    (True, False, {"stats", "bwd_dx"}),
    (False, True, {"stats", "bwd_reduce", "bwd_dx"}),
    (True, True, {"stats", "bwd_dx"})])
def test_chip_smoke_library_calls_only_where_they_compute_the_kernel(
        relu, res, kinds):
    """chip_smoke.bn_library_calls offers a PyTorch call beside a kernel
    only where it computes the kernel's function: batch_norm_elemt
    beside K3b without residual or relu, batch_norm_backward_reduce
    beside K3c without relu, var_mean and batch_norm_backward_elemt
    always; the step sums count the library only over the calls it
    covers, beside the kernel's time over the same calls."""
    import chip_smoke as cs
    N, C, S = 2, 3, 5
    x, dy, r = (torch.randn(N, C, S) for _ in range(3))
    gamma, beta = torch.rand(C) + 0.5, torch.randn(C)
    k = cs.bn_chain(torch, fb, x, dy, r if res else None, gamma, beta, relu)
    calls = cs.bn_library_calls(torch, x, dy, r if res else None, relu,
                                gamma, beta, k)
    assert set(calls) == kinds
    total = cs.bn_totals(("apply",))["apply"]
    for lib_ms, count in ((None, 3), (0.5, 2)):
        cs.bn_add_total(total, {"ms": 1.0, "plain_ms": 4.0, "bound_ms": 0.5,
                                "bound_by": "bytes", "library_ms": lib_ms},
                        count)
    assert total["ms"] == 5.0 and total["bound_ms"] == 2.5
    assert total["library_ms"] == 1.0 and total["library_calls"] == 2
    assert total["ms_library_calls"] == 2.0


@pytest.mark.parametrize("kind", ["bwd_dx", "stats", "apply", "bwd_reduce"])
def test_chip_smoke_bn_dx_rows_hold_the_unaligned_bf16_shapes(kind):
    """chip_smoke.py's phase 8 prints one row per timed shape for K3a-d,
    with the kernel's error at that shape: the rows cover the
    bfloat16 S = 196 and S = 49 BatchNorms (rows that are not whole
    8-element vectors) and the stem in float32, K3a's with torch.var_mean
    beside it, and bn_check records each shape's error (run here on CPU
    tensors, the plain versions standing in for the kernels)."""
    import chip_smoke as cs
    assert kind in cs.SHAPE_ROW_KINDS
    errs = {}
    for C, S in ((3, 196), (5, 49)):
        N = 2
        x = torch.randn(N, C, S).to(torch.bfloat16)
        dy = torch.randn(N, C, S).to(torch.bfloat16)
        cs.bn_check(torch, fb, x, dy, None, torch.rand(C) + 0.5,
                    torch.randn(C), True, "bfloat16", errs, "cpu")
        assert errs[kind, "bfloat16", N, C, S] == 0.0
    shapes = [("bfloat16", C, H, W, n) for C, H, W, _, _, n in cs.R50_BNS]
    shapes.append(("float32",) + cs.R50_BNS[0][:3] + (1,))
    lib = 0.5 if kind == "stats" else None
    rows = [{"card": "-", "dtype": d, "N": cs.R50_BATCH, "C": C, "H": H,
             "W": W, "per_step": n,
             kind: {"ms": 2.0, "bound_ms": 1.0, "library_ms": lib}}
            for d, C, H, W, n in shapes]
    errs.update({(kind, d, cs.R50_BATCH, C, H * W): 1e-3
                 for d, C, H, W, _ in shapes})
    out = cs.bn_shape_rows(rows, errs, kind)
    got = {(r["dtype"], r["S"]) for r in out}
    assert {("bfloat16", 196), ("bfloat16", 49), ("float32", 12544)} <= got
    assert len(out) == 14 and all(r["over_bound"] == 2.0 for r in out)
    assert all(r["max_abs_err"] == 1e-3 for r in out)
    assert all(r["kernel"] == "fused_bn_" + kind for r in out)
    assert all(r["library_ms"] == lib for r in out)
    assert sum(r["per_step"] for r in out if r["dtype"] == "bfloat16") == 53
