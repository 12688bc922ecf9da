"""Fused BatchNorm / ReLU / residual epilogue, forward and backward (port
of `mxnet_tpu/ops/pallas_fused.py`).

Every function works on an [N, C, S] view of a channels-first activation
(S = the flattened spatial size):

- `bn_stats`      (K3a) per-channel E[x] and var = max(E[x^2] - E[x]^2, 0),
  float32 accumulation, in one read of x;
- `bn_apply`      (K3b) y = [relu](x * scale + offset [+ residual]), the
  arithmetic in float32, one rounding to x's dtype;
- `bn_bwd_reduce` (K3c) dz = (y > 0 ? dy : 0) stored in the activation
  dtype (relu only; without relu dz is dy and nothing is written), and
  the per-channel sums of dz and dz * xhat over the same rounded dz;
- `bn_bwd_dx`     (K3d) dx = c1 * dz + c2 * x + c3 with per-channel
  coefficients.

On CUDA tensors each launches its hand-written Hopper kernel in
`csrc/fused_bn.cu` (counted in `<function>.launches`), or raises naming
the limit; there is no fallback. On CPU tensors, and only there, each runs
its plain PyTorch version (`bn_stats_plain`, ...), which the CPU tests
compare with the JAX reference's kernels in interpret mode and
`chip_smoke.py` holds the kernels against on the card.

`fused_bn_act` wires them into a `torch.autograd.Function`, as the
reference's custom VJP does: the per-channel coefficients (inv, scale and
offset; c1, c2 and c3) are computed by plain torch on (C,) vectors outside
the kernels. `MXNET_FUSED_BN_EPILOGUE=1` routes the training-mode
`BatchNorm` and `_contrib_BatchNormAddRelu` ops (ops/nn.py) here.

The reference's TPU gate (`_MAX_GRID` and the divisor blocks of
`_blocks_for`) does not carry over: the kernels mask their own ragged
edges, so any N, C and S are taken; `fused_bn_supported` keeps the
layout and dtype conditions.
"""
from __future__ import annotations

import math
import os

import torch

from ..base import MXNetError

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: threads per block of the reduction kernels (csrc/fused_bn.cu
#: kStatsThreads, kReduceThreads)
_THREADS = 256
#: the H100's streaming multiprocessors
_SMS = 132
#: K3a's blocks a pass aims for per SM: one wave of 2 (an SM holds 4,
#: csrc/fused_bn.cu bn_stats_kernel's launch bounds). On an H100 2 an SM
#: beat 4 at every ResNet-50 shape where the cluster could shrink (e.g.
#: 0.0158 against 0.0192 ms at C 512, S 49 in bfloat16), and 1 an SM lost
#: (tools/bn_stats_sweep.py)
_STATS_BLOCKS_PER_SM = 2
#: most blocks of a cluster (a K3a channel group, a K3c channel): the
#: portable cluster size
_MAX_CLUSTER = 8


def fuse_enabled():
    """MXNET_FUSED_BN_EPILOGUE=1, read at each op call."""
    return os.environ.get("MXNET_FUSED_BN_EPILOGUE", "0") == "1"


def fused_bn_limit(shape, dtype, axis=1):
    """None when the fused path takes an activation of this shape, dtype
    and channel axis, else the condition it breaks, named: channel axis 1
    of at least two dimensions, float32 or bfloat16, no empty dimension.
    These are the reference's selection conditions (`fuse_eligible`)
    without its TPU grid and tiling limits."""
    ndim = len(shape)
    if ndim < 2 or axis % ndim != 1:
        return "channel axis %d of a %d-d tensor: the fused path takes " \
            "channels on axis 1" % (axis, ndim)
    if dtype not in _DTYPE_CODE:
        return "dtype %s: the fused path takes float32 or bfloat16" % (dtype,)
    if any(int(d) == 0 for d in shape):
        return "empty shape %s" % (tuple(shape),)
    return None


def fused_bn_supported(x, axis=1):
    """The Hopper gate of the fused path (see `fused_bn_limit`)."""
    return fused_bn_limit(tuple(x.shape), x.dtype, axis) is None


def fused_bn_call_cost(kind, N, C, S, itemsize, relu=False, residual=False):
    """(flops, bytes) of one kernel call on an [N, C, S] activation: the
    reference's declared costs copied as is (pallas_fused.py:177-178,
    :223-224, :310, :345). Each activation-size input is read once and
    each output written once; the per-channel vectors are the small terms.
    kind: "stats", "apply", "bwd_reduce" or "bwd_dx"."""
    n = N * C * S
    if kind == "stats":
        return 3 * n, n * itemsize + 8 * C
    if kind == "apply":
        return ((2 + int(residual) + int(relu)) * n,
                (3 if residual else 2) * n * itemsize + 8 * C)
    if kind == "bwd_reduce":
        return 6 * n, (4 if relu else 2) * n * itemsize + 16 * C
    if kind == "bwd_dx":
        return 4 * n, 3 * n * itemsize + 12 * C
    raise ValueError("unknown kernel kind %r" % (kind,))


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the card's comparisons)
# ---------------------------------------------------------------------------


def bn_stats_plain(x3):
    """(mean, var) float32 [C] of an [N, C, S] x: one-pass E[x], E[x^2]."""
    N, _, S = x3.shape
    xf = x3.float()
    inv_m = 1.0 / (N * S)
    m = xf.sum((0, 2)) * inv_m
    var = torch.clamp((xf * xf).sum((0, 2)) * inv_m - m * m, min=0.0)
    return m, var


def bn_apply_plain(x3, scale, offset, res3=None, relu=False):
    """y = [relu](x * scale + offset [+ residual]) in x's dtype; scale and
    offset are float32 [C]."""
    z = x3.float() * scale[None, :, None] + offset[None, :, None]
    if res3 is not None:
        z = z + res3.float()
    if relu:
        z = torch.clamp(z, min=0.0)
    return z.to(x3.dtype)


def bn_bwd_reduce_plain(dy3, y3, x3, mean, inv, relu):
    """(dz, sum dz [C], sum dz * xhat [C]); dz is dy3 itself without relu.
    With relu, dz is rounded to dy3's dtype and the sums take the rounded
    values."""
    dy = dy3.float()
    if relu:
        dz = torch.where(y3 > 0, dy, torch.zeros_like(dy)).to(dy3.dtype)
        dzf = dz.float()
    else:
        dz, dzf = dy3, dy
    xh = (x3.float() - mean[None, :, None]) * inv[None, :, None]
    return dz, dzf.sum((0, 2)), (dzf * xh).sum((0, 2))


def bn_bwd_dx_plain(dz3, x3, c1, c2, c3):
    """dx = c1 * dz + c2 * x + c3 in x's dtype; c1..c3 float32 [C]."""
    dx = (dz3.float() * c1[None, :, None] + x3.float() * c2[None, :, None]
          + c3[None, :, None])
    return dx.to(x3.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _library(x3, what):
    """(the `_cuda` module, the kernels' library), after the checks every
    launch on x3 needs; raises naming the condition broken."""
    if x3.device.type != "cuda":
        raise MXNetError("%s: no kernel for device %s" % (what, x3.device))
    if x3.dim() != 3:
        raise MXNetError("%s: x must be [N, C, S], got %s"
                         % (what, tuple(x3.shape)))
    limit = fused_bn_limit(tuple(x3.shape), x3.dtype)
    if limit is not None:
        raise MXNetError("%s: %s" % (what, limit))
    from . import _cuda
    return _cuda, _cuda.library("fused_bn.cu")


def _same(what, ref, **tensors):
    """Each named tensor has ref's shape, dtype and device, contiguous."""
    for name, t in tensors.items():
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype \
                or t.device != ref.device:
            raise MXNetError("%s: %s is %s %s on %s, x is %s %s on %s"
                             % (what, name, tuple(t.shape), t.dtype,
                                t.device, tuple(ref.shape), ref.dtype,
                                ref.device))
        if not t.is_contiguous():
            raise MXNetError("%s: %s must be contiguous" % (what, name))


def _per_channel(what, x3, **vectors):
    """The named (C,) vectors as contiguous float32 on x3's device."""
    C = x3.shape[1]
    out = []
    for name, v in vectors.items():
        if tuple(v.shape) != (C,) or v.device != x3.device:
            raise MXNetError("%s: %s must be [%d] on %s, got %s on %s"
                             % (what, name, C, x3.device, tuple(v.shape),
                                v.device))
        out.append(v.float().contiguous())
    return out


def _stats_cluster(N, C, S, itemsize):
    """K3a's blocks a channel group (its cluster size P: 1, 2, 4 or 8):
    the most that keep the grid of C / G groups x P blocks within
    _STATS_BLOCKS_PER_SM an SM, and no more than N (each block then sums
    N / P rows). G is the kernel's channel group: V / gcd(S, V) channels
    with V = 16 bytes' worth of elements, so that a group's span is whole
    16-byte vectors; 1 where C is not a multiple of it or its span is
    wider than a block (the kernel then takes single elements)."""
    V = 16 // itemsize
    G = V // math.gcd(S, V)
    if C % G or (G > 1 and G * S // V > _THREADS):
        G = 1
    groups, P = C // G, 1
    while (2 * P <= min(_MAX_CLUSTER, N)
           and groups * 2 * P <= _SMS * _STATS_BLOCKS_PER_SM):
        P *= 2
    return P


def _reduce_cluster(N, C, at_once):
    """K3c's blocks a channel (its cluster size P: 1, 2, 4 or 8): the
    most, up to N, with which the C clusters all run at once, one wave;
    `at_once[P]` is how many clusters of P blocks the card holds at once
    (`reduce_clusters_at_once`). Not the blocks an SM holds: a cluster
    lives in one GPC, so an H100 holds fewer clusters of 4 or 8 than its
    blocks would allow, and a grid one cluster past that runs a second
    wave (tools/bn_ab.py's `ms_by_P`)."""
    P = 1
    while 2 * P <= min(_MAX_CLUSTER, N) and C <= at_once[2 * P]:
        P *= 2
    return P


_AT_ONCE = {}


def reduce_clusters_at_once(device, dtype, relu):
    """{P: clusters of P K3c blocks the card runs at once} for P = 1, 2,
    4, 8 (cudaOccupancyMaxActiveClusters through csrc/fused_bn.cu
    mxtt_bn_reduce_max_clusters), asked once per device, dtype and
    relu."""
    key = (device.index, dtype, bool(relu))
    table = _AT_ONCE.get(key)
    if table is None:
        from . import _cuda
        lib = _cuda.library("fused_bn.cu")
        table = {}
        with torch.cuda.device(device):
            for P in (1, 2, 4, 8):
                n = lib.mxtt_bn_reduce_max_clusters(_DTYPE_CODE[dtype],
                                                    int(bool(relu)), P)
                if n < 0:
                    _cuda.check(lib, -n, "fused_bn cluster occupancy query")
                table[P] = n
        _AT_ONCE[key] = table
    return table


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def bn_stats(x3):
    """K3a: (mean, var) float32 [C] of an [N, C, S] x, as `bn_stats_plain`.
    CUDA tensors launch the kernel (counted in `bn_stats.launches`) or
    raise; CPU tensors take `bn_stats_plain`."""
    if x3.device.type == "cpu":
        return bn_stats_plain(x3)
    what = "fused_bn stats"
    _cuda, lib = _library(x3, what)
    _same(what, x3, x=x3)
    N, C, S = x3.shape
    P = _stats_cluster(N, C, S, x3.element_size())
    f32 = dict(dtype=torch.float32, device=x3.device)
    mean, var = torch.empty(C, **f32), torch.empty(C, **f32)
    with torch.cuda.device(x3.device):
        err = lib.mxtt_bn_stats(
            _DTYPE_CODE[x3.dtype], x3.data_ptr(), N, C, S, P, 1.0 / (N * S),
            None, mean.data_ptr(), var.data_ptr(), _stream(x3.device))
    _cuda.check(lib, err, "fused_bn stats kernel launch")
    bn_stats.launches += 1
    return mean, var


def bn_apply(x3, scale, offset, res3=None, relu=False):
    """K3b: y = [relu](x * scale + offset [+ residual]) as
    `bn_apply_plain`. CUDA tensors launch the kernel (counted in
    `bn_apply.launches`) or raise; CPU tensors take `bn_apply_plain`."""
    if x3.device.type == "cpu":
        return bn_apply_plain(x3, scale, offset, res3, relu)
    what = "fused_bn apply"
    _cuda, lib = _library(x3, what)
    _same(what, x3, x=x3, **({} if res3 is None else {"residual": res3}))
    scale, offset = _per_channel(what, x3, scale=scale, offset=offset)
    N, C, S = x3.shape
    y = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        err = lib.mxtt_bn_apply(
            _DTYPE_CODE[x3.dtype], x3.data_ptr(), scale.data_ptr(),
            offset.data_ptr(), None if res3 is None else res3.data_ptr(),
            y.data_ptr(), N, C, S, int(bool(relu)), _stream(x3.device))
    _cuda.check(lib, err, "fused_bn apply kernel launch")
    bn_apply.launches += 1
    return y


def bn_bwd_reduce(dy3, y3, x3, mean, inv, relu):
    """K3c: (dz, sum dz, sum dz * xhat) as `bn_bwd_reduce_plain`. CUDA
    tensors launch the kernel (counted in `bn_bwd_reduce.launches`) or
    raise; CPU tensors take `bn_bwd_reduce_plain`."""
    if x3.device.type == "cpu":
        return bn_bwd_reduce_plain(dy3, y3, x3, mean, inv, relu)
    what = "fused_bn backward reduce"
    _cuda, lib = _library(x3, what)
    _same(what, x3, x=x3, dy=dy3, **({"y": y3} if relu else {}))
    mean, inv = _per_channel(what, x3, mean=mean, inv=inv)
    N, C, S = x3.shape
    P = _reduce_cluster(N, C, reduce_clusters_at_once(x3.device, x3.dtype,
                                                      relu))
    f32 = dict(dtype=torch.float32, device=x3.device)
    sdz, sdx = torch.empty(C, **f32), torch.empty(C, **f32)
    dz = torch.empty_like(dy3) if relu else dy3
    with torch.cuda.device(x3.device):
        err = lib.mxtt_bn_bwd_reduce(
            _DTYPE_CODE[x3.dtype], dy3.data_ptr(),
            y3.data_ptr() if relu else None, x3.data_ptr(), mean.data_ptr(),
            inv.data_ptr(), dz.data_ptr() if relu else None, N, C, S, P,
            None, sdz.data_ptr(), sdx.data_ptr(), _stream(x3.device))
    _cuda.check(lib, err, "fused_bn backward reduce kernel launch")
    bn_bwd_reduce.launches += 1
    return dz, sdz, sdx


def bn_bwd_dx(dz3, x3, c1, c2, c3):
    """K3d: dx = c1 * dz + c2 * x + c3 as `bn_bwd_dx_plain`. CUDA tensors
    launch the kernel (counted in `bn_bwd_dx.launches`) or raise; CPU
    tensors take `bn_bwd_dx_plain`."""
    if x3.device.type == "cpu":
        return bn_bwd_dx_plain(dz3, x3, c1, c2, c3)
    what = "fused_bn backward dx"
    _cuda, lib = _library(x3, what)
    _same(what, x3, x=x3, dz=dz3)
    c1, c2, c3 = _per_channel(what, x3, c1=c1, c2=c2, c3=c3)
    N, C, S = x3.shape
    dx = torch.empty_like(x3)
    with torch.cuda.device(x3.device):
        err = lib.mxtt_bn_bwd_dx(
            _DTYPE_CODE[x3.dtype], dz3.data_ptr(), x3.data_ptr(),
            c1.data_ptr(), c2.data_ptr(), c3.data_ptr(), dx.data_ptr(), N,
            C, S, _stream(x3.device))
    _cuda.check(lib, err, "fused_bn backward dx kernel launch")
    bn_bwd_dx.launches += 1
    return dx


#: kernel launches so far (plain-version calls on the CPU do not count)
bn_stats.launches = 0
bn_apply.launches = 0
bn_bwd_reduce.launches = 0
bn_bwd_dx.launches = 0
KERNELS = (bn_stats, bn_apply, bn_bwd_reduce, bn_bwd_dx)


def launch_counts():
    """(stats, apply, bwd_reduce, bwd_dx) launches so far."""
    return tuple(k.launches for k in KERNELS)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------


def bn_coefficients(gamma, mean, var, sdz, sdx, gm, gv, eps, count):
    """(c1, c2, c3) float32 [C] of dx = c1 * dz + c2 * x + c3, every dBN
    term (the mean and var cotangents gm and gv included) folded as the
    reference folds them (pallas_fused.py:379-385):
    dx = g inv (dz - sum(dz)/M - xhat sum(dz xhat)/M)
         + gm/M + gv 2 (x - mean)/M."""
    inv = torch.rsqrt(var + eps)
    g32 = gamma.float()
    gm32 = torch.zeros_like(mean) if gm is None else gm.float()
    gv32 = torch.zeros_like(var) if gv is None else gv.float()
    inv2 = inv * inv
    c1 = g32 * inv
    c2 = (-g32 * inv2 * sdx + 2.0 * gv32) / count
    c3 = (-g32 * inv * sdz + g32 * inv2 * mean * sdx + gm32
          - 2.0 * gv32 * mean) / count
    return c1, c2, c3


class _FusedBN(torch.autograd.Function):
    """Forward K3a + K3b, backward K3c + K3d. Saves (x3, gamma, mean, var,
    y if relu), as the reference's custom VJP does."""

    @staticmethod
    def forward(ctx, x3, gamma, beta, res3, eps, relu):
        mean, var = bn_stats(x3)
        inv = torch.rsqrt(var + eps)
        scale = gamma.float() * inv
        offset = beta.float() - mean * scale
        y = bn_apply(x3, scale, offset, res3, relu)
        ctx.save_for_backward(x3, gamma, mean, var, y if relu else None)
        ctx.eps, ctx.relu = eps, relu
        ctx.has_res = res3 is not None
        ctx.beta_dtype = beta.dtype
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gm, gv):
        x3, gamma, mean, var, y = ctx.saved_tensors
        N, _, S = x3.shape
        inv = torch.rsqrt(var + ctx.eps)
        gy = gy.to(x3.dtype).contiguous()
        dz, sdz, sdx = bn_bwd_reduce(gy, y, x3, mean, inv, ctx.relu)
        c1, c2, c3 = bn_coefficients(gamma, mean, var, sdz, sdx, gm, gv,
                                     ctx.eps, N * S)
        dx = bn_bwd_dx(dz, x3, c1, c2, c3)
        return (dx, sdx.to(gamma.dtype), sdz.to(ctx.beta_dtype),
                dz if ctx.has_res else None, None, None)


def fused_bn_act(x, gamma, beta, eps=1e-5, act=None, residual=None):
    """Fused training-mode BatchNorm [+ residual add] [+ ReLU].

    x: [N, C, ...] with channels on axis 1, float32 or bfloat16; gamma and
    beta: [C]. Returns (y in x's dtype, batch mean, batch var), the stats
    float32 from one-pass E[x] and E[x^2], the contract of the composite
    path in ops/nn.py's BatchNorm. Differentiable in x, gamma, beta and
    the residual, and takes the cotangents of mean and var."""
    if act not in (None, "relu"):
        raise ValueError("fused epilogue supports act in (None, 'relu'), "
                         "got %r" % (act,))
    limit = fused_bn_limit(tuple(x.shape), x.dtype)
    if limit is not None:
        raise MXNetError("fused_bn_act: %s" % limit)
    N, C = x.shape[0], x.shape[1]
    x3 = x.reshape(N, C, -1).contiguous()
    res3 = None
    if residual is not None:
        # cast and reshape outside the Function, so the residual's
        # cotangent flows back through them
        res3 = residual.reshape(x3.shape).to(x.dtype).contiguous()
    y, mean, var = _FusedBN.apply(x3, gamma, beta, res3, float(eps),
                                  act == "relu")
    return y.reshape(x.shape), mean, var
