"""Card-only checks of the port's CUDA kernels (mxnet_tpu_torch/ops/csrc).

A CUDA kernel has no CPU mode, so every test here needs a GPU and skips
without one. Run them on the card with

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax, which a GPU host running
the port need not have). This file imports neither jax nor mxnet_tpu.
TF32 is off, so float32 matmuls in the engine run in full float32.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import HybridBlock
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(dev, B, Tq, H, Dh, bs, w, q_start, dtype, seed=0):
    rng = np.random.RandomState(seed)
    nb = B * w + 3
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    k, v, q = mk(nb, bs, H, Dh), mk(nb, bs, H, Dh), mk(B, Tq, H, Dh)
    tab = rng.permutation(np.arange(1, nb))[:B * w].reshape(B, w)
    tables = torch.from_numpy(tab.astype(np.int32)).to(dev)
    qs = torch.tensor(q_start, dtype=torch.int32, device=dev)
    return q, k, v, tables, qs


# f32: summation order differs (online softmax by blocks vs one softmax);
# bf16: output rounding to 8 mantissa bits after f32 accumulation
_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh,bs", [(32, 4), (64, 8), (128, 16),
                                   (256, 16), (128, 48), (64, 2), (48, 3)])
@pytest.mark.parametrize("tq", [1, 5])
def test_kernel_matches_plain(dev, dtype, Dh, bs, tq):
    """Ragged rows (position 0, mid-block, last slot, past the table),
    head widths 32..256, a block wider than one warp (48 keys) and blocks
    of 2 and 3 keys."""
    H, B, w = 3, 4, 3
    q_start = [0, bs + bs // 2, w * bs - tq, w * bs + 7]
    q, k, v, tab, qs = _case(dev, B, tq, H, Dh, bs, w, q_start, dtype)
    out = pa.paged_attention(q, k, v, tab, qs, bs)
    ref = pa.paged_attention_plain(q, k, v, tab, qs, bs)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=_TOL[dtype],
                               rtol=_TOL[dtype])


def test_kernel_counts_launches_only(dev):
    q, k, v, tab, qs = _case(dev, 2, 1, 2, 64, 8, 2, [3, 9], torch.float32)
    n0 = pa.paged_attention.launches
    pa.paged_attention(q, k, v, tab, qs, 8)
    pa.paged_attention_plain(q, k, v, tab, qs, 8)
    assert pa.paged_attention.launches == n0 + 1


def test_cuda_wrapper_raises_instead_of_falling_back(dev):
    q, k, v, tab, qs = _case(dev, 2, 1, 2, 64, 8, 2, [3, 9], torch.float32)
    with pytest.raises(MXNetError, match="int32"):
        pa.paged_attention(q, k, v, tab.long(), qs, 8)
    with pytest.raises(MXNetError, match="contiguous"):
        pa.paged_attention(torch.cat([q, q], -1)[..., :64], k, v, tab, qs,
                           8)
    with pytest.raises(MXNetError, match="is on cpu"):
        pa.paged_attention(q, k.cpu(), v, tab, qs, 8)
    q40, k40, v40, tab40, qs40 = _case(dev, 2, 1, 2, 40, 8, 2, [3, 9],
                                       torch.float32)
    with pytest.raises(MXNetError, match="head_dim 40"):
        pa.paged_attention(q40, k40, v40, tab40, qs40, 8)


def test_engine_paged_unsupported_shape_raises(dev):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import (TransformerConfig,
                                        init_transformer_params)
    cfg = TransformerConfig(vocab=32, d_model=80, n_heads=2, n_layers=1,
                            d_ff=64, max_len=32)        # head_dim 40
    params = init_transformer_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    with pytest.raises(MXNetError, match="head_dim 40"):
        serving.Engine(serving.TransformerLM(params, cfg), paged=True,
                       block_size=8, device=dev)


def test_engine_paged_matches_gather_on_card(dev):
    """Engine parity on the card: the kernel path's logits equal the
    gather path's at every step; tokens identical."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import (TransformerConfig,
                                        init_transformer_params)
    cfg = TransformerConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                            d_ff=128, max_len=96)
    params = init_transformer_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    prompts = [[(1 + t) % 64 for t in range(9)],
               [(5 + 2 * t) % 64 for t in range(4)],
               [(7 + 3 * t) % 64 for t in range(37)]]

    def run(paged):
        eng = serving.Engine(serving.TransformerLM(params, cfg),
                             max_batch=4, block_size=8, keep_logits=True,
                             paged=paged, prefill_chunk=16, device=dev)
        seqs = [eng.start(list(p), max_new=12) for p in prompts]
        while any(not s.done for s in seqs):
            eng.decode_step(seqs)
        out = [(s.tokens, np.stack(s.token_logits)) for s in seqs]
        for s in seqs:
            eng.release(s)
        eng.close()
        return out

    n0 = pa.paged_attention.launches
    gathered = run(False)
    assert pa.paged_attention.launches == n0
    paged = run(True)
    assert pa.paged_attention.launches > n0
    for (tg, lg), (tp, lp) in zip(gathered, paged):
        np.testing.assert_allclose(lp, lg, rtol=1e-4, atol=1e-5)
        assert tp == tg


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

#: kernel vs plain: f32 forward and m / l sum in another order (online
#: softmax by 64-key tiles vs one dense softmax), l up to T; f32
#: gradients sum products over up to T rows in another order; bf16
#: outputs are rounded to 8 mantissa bits after f32 arithmetic in both
_FTOL = {torch.float32: (2e-5, 1e-4), torch.bfloat16: (2e-2, 2e-2)}


def _flash_case(dev, BH, T, Tk, D, dtype, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(dev, dtype)
    return mk(BH, T, D), mk(BH, Tk, D), mk(BH, Tk, D), mk(BH, T, D)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T,Tk,causal", [(128, 128, True), (100, 100, True),
                                         (37, 37, True), (1, 1, True),
                                         (100, 75, False), (64, 200, False)])
def test_flash_kernels_match_plain(dev, dtype, D, T, Tk, causal):
    """Forward (out, m, l) and backward (dq, dk, dv) against the plain
    versions: whole and ragged tiles, causal and not, Tk != T."""
    q, k, v, g = _flash_case(dev, 3, T, Tk, D, dtype, seed=T + D)
    scale = D ** -0.5
    out, m, l = fa.flash_attention_fwd(q, k, v, scale, causal)
    ro, rm, rl = fa.flash_fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    tol_f, tol_b = _FTOL[dtype]
    torch.testing.assert_close(out.float(), ro.float(), atol=tol_f,
                               rtol=tol_f)
    torch.testing.assert_close(m, rm, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(l, rl, atol=2e-5, rtol=2e-5)
    grads = fa.flash_attention_bwd(q, k, v, out, m, l, g, scale, causal)
    want = fa.flash_bwd_plain(q, k, v, out, m, l, g, scale, causal)
    torch.cuda.synchronize()
    for a, b in zip(grads, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol_b,
                                   rtol=tol_b)


def test_flash_gradients_repeat_bit_for_bit(dev):
    """No atomics: two backward runs give identical bits."""
    q, k, v, g = _flash_case(dev, 4, 300, 300, 64, torch.float32, seed=1)
    out, m, l = fa.flash_attention_fwd(q, k, v, 0.125, True)
    a = fa.flash_attention_bwd(q, k, v, out, m, l, g, 0.125, True)
    b = fa.flash_attention_bwd(q, k, v, out, m, l, g, 0.125, True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_flash_autograd_through_views(dev):
    """The Function over transposed [B, H, T, D] views (as the
    transformer hands them over) and a non-contiguous gradient."""
    x = torch.randn(2, 70, 4, 64, device=dev, requires_grad=True)
    q = x.transpose(1, 2)
    out = fa.flash_attention(q, q, q, causal=True)
    g = torch.randn(2, 70, 4, 64, device=dev).transpose(1, 2)
    out.backward(g)
    xr = x.detach().clone().requires_grad_(True)
    qr = xr.transpose(1, 2)
    s = (qr @ qr.transpose(-1, -2)) / 8.0
    s = s.masked_fill(torch.ones(70, 70, dtype=torch.bool,
                                 device=dev).triu(1), float("-inf"))
    (torch.softmax(s, -1) @ qr).backward(g)
    torch.testing.assert_close(x.grad, xr.grad, atol=1e-4, rtol=1e-4)


def test_flash_counts_launches_only(dev):
    q, k, v, g = _flash_case(dev, 2, 64, 64, 64, torch.float32)
    n_f, n_b = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out, m, l = fa.flash_attention_fwd(q, k, v, 0.125, True)
    fa.flash_fwd_plain(q, k, v, 0.125, True)
    fa.flash_attention_bwd(q, k, v, out, m, l, g, 0.125, True)
    fa.flash_bwd_plain(q, k, v, out, m, l, g, 0.125, True)
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == (n_f + 1, n_b + 1)


def test_flash_gate_raises_on_cuda(dev):
    q, k, v, _ = _flash_case(dev, 2, 16, 16, 64, torch.float32)
    with pytest.raises(MXNetError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half(), causal=True)
    q48, k48, v48, _ = _flash_case(dev, 2, 16, 16, 48, torch.float32)
    with pytest.raises(MXNetError, match="head_dim 48"):
        fa.flash_attention(q48, k48, v48, causal=True)
    qs, kl, vl, _ = _flash_case(dev, 2, 16, 24, 64, torch.float32)
    with pytest.raises(MXNetError, match="causal"):
        fa.flash_attention(qs, kl, vl, causal=True)
    with pytest.raises(MXNetError, match="on cpu"):
        fa.flash_attention(q, k.cpu(), v, causal=True)


def _pool_case(dev, pool, B, Tq, w, q_start, bs=16, H=4, Dh=128, seed=0):
    """(args, kwargs, q dtype) of one paged_attention call over a float32,
    bfloat16 or int8 pool ("int8_f32"/"int8_bf16": q's dtype after the
    underscore)."""
    if pool.startswith("int8"):
        dt = torch.float32 if pool == "int8_f32" else torch.bfloat16
        q, kq, vq, ks, vs, tab, qs = _int8_case(dev, B, Tq, H, Dh, bs, w,
                                                q_start, dt, seed)
        return (q, kq, vq, tab, qs, bs), dict(k_scale=ks, v_scale=vs), dt
    dt = torch.float32 if pool == "float32" else torch.bfloat16
    q, k, v, tab, qs = _case(dev, B, Tq, H, Dh, bs, w, q_start, dt, seed)
    return (q, k, v, tab, qs, bs), {}, dt


_POOLS = ["float32", "bfloat16", "int8_f32", "int8_bf16"]


def _edge_cases():
    import chip_smoke
    return chip_smoke.PAGED_EDGE_CASES


@pytest.mark.parametrize("pool", _POOLS)
@pytest.mark.parametrize("case", range(8))
def test_paged_edges_match_plain(dev, pool, case):
    """K1's cluster split and query tile at their edges (one live slot,
    live slots around the cluster size, 1024 tokens, a 64-row chunk from
    mid-block, rows whose live counts differ by more than the cluster),
    every pool type, and two calls repeat bit for bit."""
    label, B, Tq, w, q_start = _edge_cases()[case]
    args, kw, dt = _pool_case(dev, pool, B, Tq, w, q_start, seed=case)
    out = pa.paged_attention(*args, **kw)
    again = pa.paged_attention(*args, **kw)
    ref = pa.paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=_TOL[dt],
                               rtol=_TOL[dt])
    assert torch.equal(out, again), label


@pytest.mark.parametrize("pool", _POOLS)
@pytest.mark.parametrize("Dh,tq", [(16, 1), (48, 4), (80, 20), (208, 40)])
def test_paged_head_dims_of_16(dev, pool, Dh, tq):
    """Any head_dim that is a multiple of 16 up to 256: partial 128-column
    groups per lane, and the 32-row tile above 128."""
    args, kw, dt = _pool_case(dev, pool, 3, tq, 5, [0, 37, 80 - tq],
                              bs=16, H=2, Dh=Dh, seed=Dh)
    out = pa.paged_attention(*args, **kw)
    ref = pa.paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=_TOL[dt],
                               rtol=_TOL[dt])


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_paged_gate_smem_matches_the_kernel(dev, itemsize):
    """The gate's row tile and shared-memory size (_row_tile, _smem_bytes)
    are the ones the kernel launches with (mxtt_paged_smem_bytes)."""
    from mxnet_tpu_torch.ops import _cuda
    lib = _cuda.library("paged_attention.cu")
    for Dh in range(16, 257, 16):
        for bs in (1, 3, 16, 32, 48):
            for tq in (1, 4, 5, 16, 17, 32, 64, 65, 500):
                assert pa._smem_bytes(Dh, bs, tq, itemsize) == \
                    lib.mxtt_paged_smem_bytes(tq, Dh, bs, itemsize), \
                    (Dh, bs, tq)


def test_paged_misaligned_pool_raises(dev):
    """A pool that does not start on 16 bytes is refused, not staged."""
    (q, k, v, tab, qs, bs), _, _ = _pool_case(dev, "float32", 2, 1, 2,
                                              [3, 9], bs=8, H=2, Dh=64)
    flat = torch.zeros(k.numel() + 1, device=dev)
    k_off = flat[1:].view(k.shape)
    with pytest.raises(MXNetError, match="16-byte aligned"):
        pa.paged_attention(q, k_off, v, tab, qs, bs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_backward_repeats_bit_for_bit(dev, dtype, D):
    """The tensor-core backward at D 64 and 128 (its two query-tile
    heights), against the plain version and itself."""
    q, k, v, g = _flash_case(dev, 4, 333, 333, D, dtype, seed=D)
    scale = D ** -0.5
    out, m, l = fa.flash_attention_fwd(q, k, v, scale, True)
    a = fa.flash_attention_bwd(q, k, v, out, m, l, g, scale, True)
    b = fa.flash_attention_bwd(q, k, v, out, m, l, g, scale, True)
    want = fa.flash_bwd_plain(q, k, v, out, m, l, g, scale, True)
    torch.cuda.synchronize()
    tol = _FTOL[dtype][1]
    for x, y, w in zip(a, b, want):
        assert torch.equal(x, y)
        torch.testing.assert_close(x.float(), w.float(), atol=tol, rtol=tol)


#: the forward's checks: (D, T, Tk, causal) — one row, ragged tails and
#: whole tiles at every head_dim, a ragged 777 at 128, non-causal Tk != T
_FWD_CASES = [(D, T, T, True) for D in (32, 64, 128)
              for T in (1, 37, 1000)] + [(128, 777, 777, True)] + [
    (D, 300, 517, False) for D in (32, 64, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,T,Tk,causal", _FWD_CASES)
def test_flash_forward_matches_plain_and_repeats(dev, dtype, D, T, Tk,
                                                 causal):
    """The tensor-core forward (out, m, l) against the plain version, and
    against itself bit for bit."""
    q, k, v, _ = _flash_case(dev, 3, T, Tk, D, dtype, seed=T + D + Tk)
    scale = D ** -0.5
    got = fa.flash_attention_fwd(q, k, v, scale, causal)
    again = fa.flash_attention_fwd(q, k, v, scale, causal)
    want = fa.flash_fwd_plain(q, k, v, scale, causal)
    torch.cuda.synchronize()
    tol = _FTOL[dtype][0]
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol,
                               rtol=tol)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_takes_a_negative_scale(dev, dtype):
    """The kernel scales the row max of q k^T, which needs scale >= 0; the
    wrapper hands it -q and -scale for a negative one."""
    q, k, v, _ = _flash_case(dev, 2, 100, 100, 64, dtype, seed=5)
    got = fa.flash_attention_fwd(q, k, v, -0.125, True)
    want = fa.flash_fwd_plain(q, k, v, -0.125, True)
    torch.cuda.synchronize()
    tol = _FTOL[dtype][0]
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol,
                               rtol=tol)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


def test_flash_fwd_smem_matches_the_kernel(dev):
    """The gate's shared-memory size is the one the forward launches with,
    and every head_dim and dtype fits a block's 227 KB."""
    from mxnet_tpu_torch.ops import _cuda
    lib = _cuda.library("flash_attention.cu")
    for dtype, code in fa._DTYPE_CODE.items():
        for D in fa._HEAD_DIMS:
            got = lib.mxtt_flash_fwd_smem_bytes(code, D)
            assert got == fa.flash_fwd_smem_bytes(D, dtype), (D, dtype)
            assert got <= 232448
    assert lib.mxtt_flash_fwd_smem_bytes(0, 48) == -1


# ---------------------------------------------------------------------------
# the paged kernel's int8 variant, int8 weights and quantized serving
# ---------------------------------------------------------------------------


def _int8_case(dev, B, Tq, H, Dh, bs, w, q_start, dtype, seed=0):
    """Float pools quantized per (block, head), as the reference's
    tests/test_serving_quant.py:87 does; q in `dtype`."""
    q, k, v, tab, qs = _case(dev, B, Tq, H, Dh, bs, w, q_start,
                             torch.float32, seed)

    def quant(pool):
        s = pool.abs().amax(dim=(1, 3)).clamp(min=1e-12) / 127.0
        qp = torch.clamp(torch.round(pool / s[:, None, :, None]), -127, 127)
        return qp.to(torch.int8).contiguous(), s.contiguous()

    kq, ks = quant(k)
    vq, vs = quant(v)
    return q.to(dtype), kq, vq, ks, vs, tab, qs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dh", [64, 128])
@pytest.mark.parametrize("bs", [16, 32])
@pytest.mark.parametrize("tq", [1, 4, 64])
def test_int8_kernel_matches_plain(dev, dtype, Dh, bs, tq):
    """q float32 or bfloat16 over an int8 pool: ragged rows (position 0,
    mid-block, last slot, past the table); the tolerances of the float
    kernel, since both dequantize to the same float32 values."""
    H, B, w = 3, 4, 4
    q_start = [0, bs + bs // 2, w * bs - tq, w * bs + 7]
    q, kq, vq, ks, vs, tab, qs = _int8_case(dev, B, tq, H, Dh, bs, w,
                                            q_start, dtype)
    out = pa.paged_attention(q, kq, vq, tab, qs, bs, k_scale=ks, v_scale=vs)
    ref = pa.paged_attention_plain(q, kq, vq, tab, qs, bs, k_scale=ks,
                                   v_scale=vs)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), ref.float(), atol=_TOL[dtype],
                               rtol=_TOL[dtype])


def test_int8_kernel_counts_launches_apart(dev):
    q, kq, vq, ks, vs, tab, qs = _int8_case(dev, 2, 1, 2, 64, 8, 2, [3, 9],
                                            torch.float32)
    n = (pa.paged_attention.launches, pa.paged_attention.launches_int8)
    pa.paged_attention(q, kq, vq, tab, qs, 8, k_scale=ks, v_scale=vs)
    pa.paged_attention_plain(q, kq, vq, tab, qs, 8, k_scale=ks, v_scale=vs)
    assert (pa.paged_attention.launches,
            pa.paged_attention.launches_int8) == (n[0], n[1] + 1)


def test_int8_gate_raises_on_cuda(dev):
    q, kq, vq, ks, vs, tab, qs = _int8_case(dev, 2, 1, 2, 40, 8, 2, [3, 9],
                                            torch.float32)
    with pytest.raises(MXNetError, match="head_dim 40"):
        pa.paged_attention(q, kq, vq, tab, qs, 8, k_scale=ks, v_scale=vs)
    q, kq, vq, ks, vs, tab, qs = _int8_case(dev, 2, 1, 2, 64, 8, 2, [3, 9],
                                            torch.float32)
    with pytest.raises(MXNetError, match="needs k_scale"):
        pa.paged_attention(q, kq, vq, tab, qs, 8)
    with pytest.raises(MXNetError, match="is on cpu"):
        pa.paged_attention(q, kq, vq, tab, qs, 8, k_scale=ks.cpu(),
                           v_scale=vs)
    with pytest.raises(MXNetError, match="dtype"):
        pa.paged_attention(q.half(), kq, vq, tab, qs, 8, k_scale=ks,
                           v_scale=vs)


def test_engine_kv_quant_unsupported_shape_raises(dev):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import (TransformerConfig,
                                        init_transformer_params)
    cfg = TransformerConfig(vocab=32, d_model=80, n_heads=2, n_layers=1,
                            d_ff=64, max_len=32)        # head_dim 40
    params = init_transformer_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    with pytest.raises(MXNetError, match="kv_quant=True.*head_dim 40"):
        serving.Engine(serving.TransformerLM(params, cfg), paged=True,
                       kv_quant=True, block_size=8, device=dev)


def test_int8_matmul_on_card_equals_cpu(dev):
    """torch._int_mm with padded rows is exact: the card's
    dynamic_quant_matmul equals the CPU's int32 product bit for bit, at
    decode (1..8 rows), spec (32) and chunk (64) row counts."""
    from mxnet_tpu_torch.ops import quantization as quant
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(256, 384).astype(np.float32))
    wq, ws = quant.quantize_channelwise(w, axis=1)
    for n in (1, 3, 8, 32, 64):
        x = torch.from_numpy(rng.randn(n, 256).astype(np.float32))
        want = quant.dynamic_quant_matmul(x, wq, ws)
        got = quant.dynamic_quant_matmul(x.to(dev), wq.to(dev), ws.to(dev))
        assert torch.equal(got.cpu(), want), n
    with pytest.raises(MXNetError, match="multiples of 8"):
        quant.dynamic_quant_matmul(torch.zeros(2, 12, device=dev),
                                   torch.zeros(12, 8, dtype=torch.int8,
                                               device=dev),
                                   torch.ones(8, device=dev))


def test_write_kv_quant_on_card_equals_cpu(dev):
    """The quantizing scatter gives the CPU's bytes and scales on the
    card: a prefill chunk, then decode appends that raise one block's
    scale (requantizing its earlier rows), one row aimed at the null
    block."""
    from mxnet_tpu_torch.serving.kv_cache import write_kv_quant
    rng = np.random.RandomState(1)
    L, NB, bs, H, Dh = 2, 6, 8, 2, 64
    pools = {}
    for where in ("cpu", dev):
        pools[where] = [torch.zeros((L, NB, bs, H, Dh), dtype=torch.int8,
                                    device=where) for _ in range(2)] + \
            [torch.zeros((L, NB, H), device=where) for _ in range(2)]
    writes = [(np.arange(8, 21), 1.0), (np.array([21, 22]), 4.0),
              (np.array([23, 3]), 0.5)]
    for slots, mag in writes:
        kn = (mag * rng.randn(len(slots), H, Dh)).astype(np.float32)
        vn = (mag * rng.randn(len(slots), H, Dh)).astype(np.float32)
        for where, (kp, vp, ks, vs) in pools.items():
            write_kv_quant(kp, vp, ks, vs, 1,
                           torch.as_tensor(slots, device=where),
                           torch.as_tensor(kn, device=where),
                           torch.as_tensor(vn, device=where))
    for a, b in zip(pools["cpu"], pools[dev]):
        assert torch.equal(a, b.cpu())


def test_engine_quant_and_spec_on_card(dev):
    """The quantized engine on the card (int8 KV, the kernel's int8
    variant, int8 weights) keeps the float engine's tokens within the
    reference's 0.05 logit budget; speculation and the prefix cache over
    it keep the quantized engine's tokens."""
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import (TransformerConfig,
                                        init_transformer_params)
    cfg = TransformerConfig(vocab=64, d_model=128, n_heads=2, n_layers=2,
                            d_ff=128, max_len=96)
    params = init_transformer_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    prompt = [(7 + 3 * t) % 64 for t in range(37)]

    def run(**kw):
        eng = serving.Engine(serving.TransformerLM(dict(params), cfg),
                             max_batch=2, block_size=16, keep_logits=True,
                             paged=True, device=dev, **kw)
        outs = []
        for p in (prompt, prompt[:30] + [1, 2]):
            seq = eng.start(list(p), max_new=12)
            while not seq.done:
                eng.decode_step([seq])
            outs.append((list(seq.tokens), np.stack(seq.token_logits)))
            eng.release(seq)
        return eng, outs

    def agree(got, ref, margin=0.1):
        """Tokens of `got` equal `ref`'s up to ref's first near-tie (top-2
        logit margin under `margin`, twice the 0.05 budget); returns how
        many were compared."""
        n = 0
        for (tg, _), (tr, lr) in zip(got, ref):
            start = len(tr) - len(lr)
            for j, row in enumerate(lr):
                top2 = np.sort(row)[-2:]
                if top2[1] - top2[0] < margin:
                    break
                assert tg[start + j] == tr[start + j], j
                n += 1
        return n

    n8 = pa.paged_attention.launches_int8
    _, f32 = run()
    eng, q8 = run(kv_quant=True, weight_quant="int8")
    assert pa.paged_attention.launches_int8 > n8
    agree(q8, f32)
    for (tf, lf), (tq, lq) in zip(f32, q8):
        if tq == tf:                  # logits comparable row for row
            assert float(np.abs(lq - lf).max()) < 0.05
    eng, sp = run(kv_quant=True, weight_quant="int8", spec_k=3,
                  draft=serving.self_draft(params, cfg, 1),
                  prefix_cache=True)
    assert eng.spec_passes > 0 and eng.prefix_cache.cow_copies >= 1
    # rejected drafts' rows may raise a block's monotonic scale: tokens
    # agree with the quantized engine's up to its first near-tie
    agree(sp, q8)


# ---------------------------------------------------------------------------
# fused BatchNorm / ReLU / residual (csrc/fused_bn.cu)
# ---------------------------------------------------------------------------

#: kernel vs plain: outputs float32 1e-5 (float32 arithmetic in another
#: order, an FMA where the plain version rounds twice), bfloat16 3e-2 (one
#: rounding to 8 mantissa bits); the statistics 1e-5 in both (float32
#: accumulation of the same values); the channel sums rtol 1e-4 with atol
#: 1e-4 x sqrt(N S), the size of a sum of N S unit terms; dz exact
_BTOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def _bn_case(dev, N, C, S, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (2 * torch.randn(N, C, S, generator=g, device=dev)
         + torch.randn(1, C, 1, generator=g, device=dev)).to(dtype)
    dy = torch.randn(N, C, S, generator=g, device=dev).to(dtype)
    r = torch.randn(N, C, S, generator=g, device=dev).to(dtype)
    gamma = torch.rand(C, generator=g, device=dev) + 0.5
    return x, dy, r, gamma, torch.randn(C, generator=g, device=dev)


def _bn_check_all(x, dy, r, gamma, beta, relu):
    from mxnet_tpu_torch.ops import fused_bn as fb
    N, C, S = x.shape
    tol = _BTOL[x.dtype]
    mean, var = fb.bn_stats(x)
    pm, pv = fb.bn_stats_plain(x)
    inv = torch.rsqrt(var + 1e-5)
    scale, offset = gamma * inv, beta - mean * gamma * inv
    y = fb.bn_apply(x, scale, offset, r, relu)
    py = fb.bn_apply_plain(x, scale, offset, r, relu)
    dz, sdz, sdx = fb.bn_bwd_reduce(dy, y, x, mean, inv, relu)
    pdz, psdz, psdx = fb.bn_bwd_reduce_plain(dy, y, x, mean, inv, relu)
    c = fb.bn_coefficients(gamma, mean, var, sdz, sdx, None, None, 1e-5,
                           N * S)
    dx = fb.bn_bwd_dx(dz, x, *c)
    pdx = fb.bn_bwd_dx_plain(dz, x, *c)
    torch.cuda.synchronize()
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(var, pv, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=tol)
    assert torch.equal(dz, pdz)
    sum_atol = 1e-4 * (N * S) ** 0.5
    torch.testing.assert_close(sdz, psdz, atol=sum_atol, rtol=1e-4)
    torch.testing.assert_close(sdx, psdx, atol=sum_atol, rtol=1e-4)
    torch.testing.assert_close(dx.float(), pdx.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("N,C,S", [(8, 64, 3136), (16, 256, 49),
                                   (7, 3, 35), (64, 512, 1), (3, 5, 4),
                                   (2, 130, 196)])
def test_fused_bn_kernels_match_plain(dev, dtype, relu, res, N, C, S):
    """K3a-d against their plain versions in all four epilogue variants:
    vector loads (S a multiple of the 16-byte vector), single elements
    (odd S, S=1, 49), C=3 and C not a power of two."""
    x, dy, r, gamma, beta = _bn_case(dev, N, C, S, dtype, seed=N + C + S)
    _bn_check_all(x, dy, r if res else None, gamma, beta, relu)


def test_fused_bn_kernels_take_unaligned_tensors(dev):
    """A tensor starting one element past a 16-byte boundary goes the
    single-element way, with the same results."""
    x, dy, r, gamma, beta = _bn_case(dev, 4, 8, 64, torch.float32)
    n = x.numel()

    def shift(t):
        buf = torch.empty(n + 1, device=dev, dtype=t.dtype)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    xs, dys, rs = shift(x), shift(dy), shift(r)
    assert xs.data_ptr() % 16 != 0
    _bn_check_all(xs, dys, rs, gamma, beta, True)


def _bn_dx_check(dz, x, c):
    """K3d against its plain version, and against itself bit for bit."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    got = fb.bn_bwd_dx(dz, x, *c)
    again = fb.bn_bwd_dx(dz, x, *c)
    want = fb.bn_bwd_dx_plain(dz, x, *c)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    tol = _BTOL[x.dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _bn_dx_inputs(dev, N, C, S, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    dz = torch.randn(N, C, S, generator=g, device=dev).to(dtype)
    x = (2 * torch.randn(N, C, S, generator=g, device=dev)).to(dtype)
    c = [torch.randn(C, generator=g, device=dev) for _ in range(3)]
    return dz, x, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,C,S", [(3, 7, 1), (3, 7, 3), (5, 7, 7),
                                   (4, 9, 49), (3, 5, 196), (2, 3, 8),
                                   (1, 3, 7), (2, 65, 12544)])
def test_bn_dx_rows_crossing_vectors(dev, dtype, N, C, S):
    """K3d with odd C, so that vectors cross row ends into the next
    channel (and wrap from the last channel to the first): S below the
    vector width (1, 3, 7), above it and not a multiple (49, 196), a
    multiple (8, 12544), and n % V != 0 (the scalar tail)."""
    _bn_dx_check(*_bn_dx_inputs(dev, N, C, S, dtype, seed=N * C + S))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_dx_misaligned_pointer_takes_the_scalar_path(dev, dtype):
    """dz and x one element past a 16-byte boundary: single elements."""
    dz, x, c = _bn_dx_inputs(dev, 4, 7, 49, dtype, seed=3)

    def shift(t):
        buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    dzs, xs = shift(dz), shift(x)
    assert dzs.data_ptr() % 16 != 0 and xs.data_ptr() % 16 != 0
    _bn_dx_check(dzs, xs, c)
    _bn_dx_check(dzs, x, c)


@pytest.mark.parametrize("S", [7, 49])
def test_bn_dx_64_bit_indices(dev, S):
    """n >= 2^31 elements (bfloat16, 4.3 GB a tensor) takes 64-bit
    indices; checked at both ends and across the 2^31 boundary."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    C = 3
    N = (1 << 31) // (C * S) + 2
    dz = torch.randn(N, C, S, device=dev, dtype=torch.bfloat16)
    x = torch.randn(N, C, S, device=dev, dtype=torch.bfloat16)
    c = [torch.randn(C, device=dev) for _ in range(3)]
    dx = fb.bn_bwd_dx(dz, x, *c)
    edge = (1 << 31) // (C * S)
    for sl in (slice(0, 4), slice(edge - 2, edge + 2), slice(N - 4, N)):
        want = fb.bn_bwd_dx_plain(dz[sl], x[sl], *c)
        torch.testing.assert_close(dx[sl].float(), want.float(), atol=3e-2,
                                   rtol=3e-2)
    del dz, x, dx


def _bn_fwd_check(x, r, relu, seed=0):
    """K3a and K3b against their plain versions; K3a against itself bit
    for bit."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    C = x.shape[1]
    g = torch.Generator(device=x.device).manual_seed(seed)
    scale = torch.rand(C, generator=g, device=x.device) + 0.5
    offset = torch.randn(C, generator=g, device=x.device)
    mean, var = fb.bn_stats(x)
    again = fb.bn_stats(x)
    pm, pv = fb.bn_stats_plain(x)
    y = fb.bn_apply(x, scale, offset, r, relu)
    py = fb.bn_apply_plain(x, scale, offset, r, relu)
    torch.cuda.synchronize()
    assert torch.equal(mean, again[0]) and torch.equal(var, again[1])
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(var, pv, atol=1e-5, rtol=1e-5)
    tol = _BTOL[x.dtype]
    torch.testing.assert_close(y.float(), py.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu,res", [(False, False), (True, True)])
@pytest.mark.parametrize("N,C,S", [(6, 24, 49), (5, 12, 49), (3, 10, 196),
                                   (3, 5, 196), (4, 3, 1), (4, 3, 3),
                                   (5, 16, 1), (3, 8, 3), (2, 3, 7),
                                   (1, 8, 49), (2, 8, 301)])
def test_bn_fwd_channel_groups_and_row_ends(dev, dtype, relu, res, N, C, S):
    """K3a and K3b where a 16-byte vector crosses row ends: S = 49 and
    196 with C a multiple of K3a's channel group (8 and 2 channels a span
    in bfloat16) and not (the single-element path), S below the vector
    width (1, 3, 7), an odd C = 3, N = 1 (a cluster of one block), and an
    S whose channel group is wider than a block (301 in bfloat16: 8
    channels a span of 301 vectors; the single-element path)."""
    x, _, r, _, _ = _bn_case(dev, N, C, S, dtype, seed=N * C + S)
    _bn_fwd_check(x, r if res else None, relu, seed=S)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_fwd_misaligned_pointer_takes_the_scalar_path(dev, dtype):
    """x (and the residual) one element past a 16-byte boundary: K3a and
    K3b take single elements, with the same results."""
    x, _, r, _, _ = _bn_case(dev, 4, 16, 49, dtype, seed=5)

    def shift(t):
        buf = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out
    xs, rs = shift(x), shift(r)
    assert xs.data_ptr() % 16 != 0 and rs.data_ptr() % 16 != 0
    _bn_fwd_check(xs, rs, True)
    _bn_fwd_check(x, rs, True)
    _bn_fwd_check(xs, None, False)


@pytest.mark.parametrize("C,S", [(3, 7), (8, 49)])
def test_bn_fwd_64_bit_indices(dev, C, S):
    """n >= 2^31 elements (bfloat16, 4.3 GB a tensor): K3b checked at
    both ends and across the 2^31 boundary, K3a against its plain
    version (C = 3 takes single elements, C = 8 16-byte vectors)."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    N = (1 << 31) // (C * S) + 2
    x = torch.randn(N, C, S, device=dev, dtype=torch.bfloat16)
    r = torch.randn(N, C, S, device=dev, dtype=torch.bfloat16)
    scale = torch.rand(C, device=dev) + 0.5
    offset = torch.randn(C, device=dev)
    y = fb.bn_apply(x, scale, offset, r, True)
    edge = (1 << 31) // (C * S)
    for sl in (slice(0, 4), slice(edge - 2, edge + 2), slice(N - 4, N)):
        want = fb.bn_apply_plain(x[sl], scale, offset, r[sl], True)
        torch.testing.assert_close(y[sl].float(), want.float(), atol=3e-2,
                                   rtol=3e-2)
    del r, y
    mean, var = fb.bn_stats(x)
    pm, pv = fb.bn_stats_plain(x)
    torch.testing.assert_close(mean, pm, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(var, pv, atol=1e-5, rtol=1e-5)
    del x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,S", [(512, 49), (2048, 49), (256, 196)])
def test_bn_stats_repeats_bit_for_bit_at_small_s(dev, dtype, C, S):
    """K3a at ResNet-50's 7x7 and 14x14 BatchNorms (batch 256), where
    clusters of blocks combine their channel groups' sums: three calls
    give the same bits."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    x = _bn_case(dev, 256, C, S, dtype, seed=C)[0]
    runs = [fb.bn_stats(x) for _ in range(3)]
    torch.cuda.synchronize()
    for mean, var in runs[1:]:
        assert torch.equal(mean, runs[0][0]) and torch.equal(var, runs[0][1])


def test_fused_bn_repeats_bit_for_bit(dev):
    """No atomics: the partial sums combine in a fixed order."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    x, dy, r, gamma, beta = _bn_case(dev, 32, 64, 784, torch.float32)
    a, b = fb.bn_stats(x), fb.bn_stats(x)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    mean, var = a
    inv = torch.rsqrt(var + 1e-5)
    a = fb.bn_bwd_reduce(dy, r, x, mean, inv, True)
    b = fb.bn_bwd_reduce(dy, r, x, mean, inv, True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_fused_bn_counts_launches_only(dev):
    from mxnet_tpu_torch.ops import fused_bn as fb
    x, dy, r, gamma, beta = _bn_case(dev, 2, 8, 36, torch.float32)
    n0 = fb.launch_counts()
    mean, var = fb.bn_stats(x)
    fb.bn_stats_plain(x)
    inv = torch.rsqrt(var + 1e-5)
    y = fb.bn_apply(x, gamma * inv, beta, r, True)
    fb.bn_apply_plain(x, gamma * inv, beta, r, True)
    dz, _, _ = fb.bn_bwd_reduce(dy, y, x, mean, inv, True)
    fb.bn_bwd_dx(dz, x, gamma, gamma, beta)
    assert fb.launch_counts() == tuple(c + 1 for c in n0)
    y, _, _ = fb.fused_bn_act(x.view(2, 8, 6, 6).requires_grad_(True),
                              gamma, beta, act="relu")
    y.sum().backward()
    assert fb.launch_counts() == tuple(c + 2 for c in n0)


def test_fused_bn_gate_raises_on_cuda(dev):
    from mxnet_tpu_torch.ops import fused_bn as fb
    x, dy, r, gamma, beta = _bn_case(dev, 2, 8, 36, torch.float32)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        fb.bn_stats(x.half())
    with pytest.raises(MXNetError, match="must be \\[8\\] on"):
        fb.bn_apply(x, gamma.cpu(), beta, None, False)
    with pytest.raises(MXNetError, match="contiguous"):
        fb.bn_bwd_reduce(dy.transpose(0, 2).contiguous().transpose(0, 2),
                         x, x, gamma, gamma, True)
    with pytest.raises(MXNetError, match="residual is"):
        fb.bn_apply(x, gamma, beta, r.double(), True)
    with pytest.raises(MXNetError, match="\\[N, C, S\\]"):
        fb.bn_stats(x.view(2, 8, 6, 6))


def _bwd_reduce_check(dy, y, x, relu):
    """K3c against its plain version (dz exact, the channel sums within
    the sum tolerance); returns the kernel's outputs."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    N, C, S = x.shape
    mean, var = fb.bn_stats_plain(x)
    inv = torch.rsqrt(var + 1e-5)
    got = fb.bn_bwd_reduce(dy, y, x, mean, inv, relu)
    want = fb.bn_bwd_reduce_plain(dy, y, x, mean, inv, relu)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    sum_atol = 1e-4 * (N * S) ** 0.5
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=sum_atol, rtol=1e-4)
    return got


def _shift(t):
    """t's values in a tensor that starts one element past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


#: (C, S) of the 18 BatchNorm shapes of an Inception-v3 step
_INC_CS = [(C, H * W) for C, H, W, _ in cs.INC_BNS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("C,S", _INC_CS)
def test_bn_bwd_reduce_matches_plain_at_the_inception_shapes(dev, dtype,
                                                             relu, C, S):
    """K3c at each of Inception-v3's BatchNorm shapes (odd S but 64), at
    batch 16: every row's head and tail vectors masked to its own
    elements."""
    x, dy, r, _, _ = _bn_case(dev, 16, C, S, dtype, seed=C + S)
    _bwd_reduce_check(dy, r, x, relu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [289, 49, 8, 7, 1])
def test_bn_bwd_reduce_pointer_offsets(dev, dtype, S):
    """Tensors one element past a 16-byte boundary: dy and x sharing that
    offset (no relu) keep 16-byte vectors with every row's start moved;
    dy and y moved but not the dz the wrapper allocates (relu), or dy
    alone moved, take the same kernel at W = 1. All as the plain
    version."""
    x, dy, r, _, _ = _bn_case(dev, 4, 5, S, dtype, seed=S)
    xs, dys, rs = _shift(x), _shift(dy), _shift(r)
    assert xs.data_ptr() % 16 != 0
    _bwd_reduce_check(dys, None, xs, False)
    _bwd_reduce_check(dys, rs, xs, True)
    _bwd_reduce_check(dys, None, x, False)
    _bwd_reduce_check(dys, r, x, True)


def test_bn_bwd_reduce_64_bit_offsets(dev):
    """n >= 2^31 elements (bfloat16, 4.3 GB a tensor), relu on: dz at both
    ends and across the 2^31 boundary, and the channel sums against the
    plain version's summed over slices of N."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    C, S = 3, 7
    N = (1 << 31) // (C * S) + 2
    dy, y, x = (torch.randn(N, C, S, device=dev, dtype=torch.bfloat16)
                for _ in range(3))
    mean = torch.randn(C, device=dev) * 0.1
    inv = torch.rand(C, device=dev) + 0.5
    dz, sdz, sdx = fb.bn_bwd_reduce(dy, y, x, mean, inv, True)
    edge = (1 << 31) // (C * S)
    for sl in (slice(0, 4), slice(edge - 2, edge + 2), slice(N - 4, N)):
        want = fb.bn_bwd_reduce_plain(dy[sl], y[sl], x[sl], mean, inv, True)
        assert torch.equal(dz[sl], want[0])
    del dz
    want = [torch.zeros(C, device=dev, dtype=torch.float64) for _ in "ab"]
    for n0 in range(0, N, 1 << 24):
        sl = slice(n0, n0 + (1 << 24))
        _, a, b = fb.bn_bwd_reduce_plain(dy[sl], y[sl], x[sl], mean, inv,
                                         True)
        want[0] += a.double()
        want[1] += b.double()
    sum_atol = 1e-4 * (N * S) ** 0.5
    torch.testing.assert_close(sdz.double(), want[0], atol=sum_atol,
                               rtol=1e-4)
    torch.testing.assert_close(sdx.double(), want[1], atol=sum_atol,
                               rtol=1e-4)
    del dy, y, x


@pytest.mark.parametrize("dtype,relu,N,C,S", [
    (torch.float32, False, 128, 32, 1225), (torch.float32, True, 16, 192,
                                            289),
    (torch.bfloat16, True, 256, 64, 49), (torch.bfloat16, False, 256, 2048,
                                          49)])
def test_bn_bwd_reduce_repeats_bit_for_bit(dev, dtype, relu, N, C, S):
    """Clusters of 8, 1 and 4 blocks a channel (the cluster's sums added
    in rank order, no atomics): three calls give the same bits."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    x, dy, r, _, _ = _bn_case(dev, N, C, S, dtype, seed=C)
    mean, var = fb.bn_stats_plain(x)
    inv = torch.rsqrt(var + 1e-5)
    runs = [fb.bn_bwd_reduce(dy, r, x, mean, inv, relu) for _ in range(3)]
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))


def test_bn_bwd_reduce_is_one_launch(dev):
    """One call of K3c launches one kernel on the card (no combining
    pass) in both variants, by torch.profiler's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.ops import fused_bn as fb
    x, dy, r, _, _ = _bn_case(dev, 32, 64, 289, torch.float32)
    mean, var = fb.bn_stats_plain(x)
    inv = torch.rsqrt(var + 1e-5)
    for relu in (False, True):
        fb.bn_bwd_reduce(dy, r, x, mean, inv, relu)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fb.bn_bwd_reduce(dy, r, x, mean, inv, relu)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        assert len(names) == 1 and "bn_bwd_reduce_kernel" in names[0], names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_reduce_clusters_at_once_reads_the_card(dev, dtype):
    """The card's cluster occupancy of K3c: every cluster size runs, no
    more clusters of 2P than of P, and at least one block an SM."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    for relu in (False, True):
        at_once = fb.reduce_clusters_at_once(dev, dtype, relu)
        assert sorted(at_once) == [1, 2, 4, 8]
        assert all(at_once[2 * P] <= at_once[P] for P in (1, 2, 4))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        assert at_once[8] >= 1 and at_once[1] >= sms


def test_bn_library_calls_compute_the_kernels_functions(dev):
    """The PyTorch calls chip_smoke.py times beside K3a-d compute the
    kernels' functions: each agrees with its kernel's outputs on the
    same inputs (float32, no relu or residual, where all four apply)."""
    from mxnet_tpu_torch.ops import fused_bn as fb
    N, C, S = 8, 16, 289
    x, dy, _, gamma, beta = _bn_case(dev, N, C, S, torch.float32, seed=7)
    k = cs.bn_chain(torch, fb, x, dy, None, gamma, beta, False)
    calls = cs.bn_library_calls(torch, x, dy, None, False, gamma, beta, k)
    assert set(calls) == {"stats", "apply", "bwd_reduce", "bwd_dx"}
    sum_atol = 1e-4 * (N * S) ** 0.5
    for kind, (_, err) in calls.items():
        assert err() <= (sum_atol if kind == "bwd_reduce" else 1e-4), kind


def test_fused_bn_autograd_matches_the_composite_on_card(dev):
    """fused_bn_act's Function (all four kernels) against the op's
    composite path under torch.autograd, float32, TF32 off."""
    import os
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.ops import nn as ops_nn
    x, dy, r, gamma, beta = _bn_case(dev, 4, 16, 100, torch.float32, seed=3)
    x4, r4, dy4 = (t.view(4, 16, 10, 10) for t in (x, r, dy))
    outs = {}
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    try:
        for flag in ("1", "0"):
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = flag
            ins = [t.detach().clone().requires_grad_(True)
                   for t in (x4, gamma, beta, r4)]
            with autograd.train_mode():
                out, mean, var = ops_nn.BatchNormAddRelu(
                    ins[0], ins[1], ins[2], torch.zeros_like(gamma),
                    torch.ones_like(gamma), addend=ins[3], eps=1e-5,
                    fix_gamma=False)
            loss = (out * dy4).sum() + (mean.sin() + var.cos()).sum()
            outs[flag] = (out,) + torch.autograd.grad(loss, ins)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior
    for a, b in zip(outs["1"], outs["0"]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_resnet18_trainstep_on_card_matches_the_cpu(dev):
    """A ResNet-18 TrainStep with the fused kernels: the first step's loss
    and gradients on the card against the plain versions on the CPU at
    the same weights (float32, TF32 off; 1e-5 of the loss, 1e-4 relative
    Frobenius a gradient, where the two differ by ~1e-5), then three bf16
    steps with each kernel launched 20 times a step (ResNet-18 v1 has 20
    BatchNorms). The flag-off step is not the oracle here: on the card
    cuDNN picks other, less exact algorithms for the composite path's
    gradients (7e-3 from a float64 step, where the fused path and the
    composite with cuDNN off are 1.6e-3 from it;
    tools/resnet_grad_probe.py --impl port)."""
    import os
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.ops import fused_bn as fb
    from mxnet_tpu_torch.parallel import TrainStep
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (16, 3, 64, 64)).astype(np.float32)
    y = rng.randint(0, 10, (16,))
    res, nets = {}, {}
    try:
        for where in ("cpu", "gpu"):
            ctx = mx.cpu() if where == "cpu" else mx.Context("gpu",
                                                             dev.index or 0)
            with ctx, mx.name.NameManager():
                net = vision.resnet18_v1(classes=10)
                net.initialize(mx.init.Xavier())
                net(mx.nd.zeros((1, 3, 64, 64)))
            if where == "gpu":
                from mxnet_tpu_torch.models import gluon_params_from_numpy
                gluon_params_from_numpy(net, {
                    n: p.data().asnumpy() for n, p in
                    nets["cpu"].collect_params().items()})
            nets[where] = net
            step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": 0.01, "momentum": 0.9})
            dv = ctx.torch_device()
            res[where] = step.loss_and_grads(torch.from_numpy(x).to(dv),
                                             torch.from_numpy(y).to(dv))
        assert float(res["gpu"][0]) == pytest.approx(float(res["cpu"][0]),
                                                     rel=1e-5)
        rel = [float((res["gpu"][1][n].cpu() - g).norm() / g.norm())
               for n, g in res["cpu"][1].items()
               if not ("conv2d" in n and n.endswith("_bias"))]
        assert max(rel) < 1e-4
        bf16 = TrainStep(nets["gpu"], mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", {"learning_rate": 0.01, "momentum": 0.9},
                         dtype="bfloat16")
        n0 = fb.launch_counts()
        xg, yg = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        losses = [float(bf16(xg, yg)) for _ in range(3)]
        assert fb.launch_counts() == tuple(c + 60 for c in n0)
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior


# ---------------------------------------------------------------------------
# K4a-b: the persistent fused-RNN scan (ops/csrc/fused_rnn.cu)
# ---------------------------------------------------------------------------

def _rnn_case(dev, mode, T, N, H, dtype, seed=0):
    from mxnet_tpu_torch.ops import fused_rnn as fr
    a = fr.check_inputs(mode, T, N, H, dtype, seed=seed, device=dev)
    return tuple(a[k] for k in ("px", "h0", "c0", "wh", "dys", "dhT",
                                "dcT"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["lstm", "rnn_relu", "rnn_tanh"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("T,N,H,design", [
    (35, 32, 200, "cluster"), (35, 32, 256, "cluster"),
    (1, 1, 7, "stream"), (35, 7, 203, "cluster"), (35, 33, 200, "cluster"),
    (35, 32, 203, "cluster"), (35, 1, 200, "cluster"),
    (1, 32, 200, "cluster"), (35, 300, 203, "cluster"),
    (35, 32, "edge", "cluster"), (35, 32, "past", "stream"),
    (35, 7, "past", "stream"), (1, 32, "past", "stream"),
    (35, 300, "past", "stream"), (35, 5, 1024, "stream")])
def test_fused_rnn_kernels_match_plain(dev, dtype, mode, reverse, T, N, H,
                                       design):
    """K4a, then K4b on K4a's outputs, against the plain versions fed with
    the kernels' own previous outputs, within the limits chip_smoke.py
    holds them to (ops/fused_rnn.py PLAIN_TOL), each case through the
    design named: the word LM's shape, H 256, ragged ones (T 1, N 1, odd
    N, H off the vector width and the mma tile, N 33's ragged last
    cluster, N 300 in several waves of clusters), a tiny layer, and both
    sides of the design boundary: "edge" the largest H of the cluster
    design, "past" the next one up, which streams (at a ragged N, T 1 and
    N 300 too), as does H 1024."""
    from mxnet_tpu_torch.ops import fused_rnn as fr
    if isinstance(H, str):
        H = fr.cluster_limit(mode, N, dtype) + (H == "past")
    assert fr.rnn_design(mode, N, H, dtype).name == design
    a = fr.check_inputs(mode, T, N, H, dtype, device=dev)
    n0 = fr.design_launch_counts()[design]
    got = fr.chain(mode, a, reverse)
    assert fr.design_launch_counts()[design] == (n0[0] + 1, n0[1] + 1)
    want = fr.fed_plain(mode, a, got, reverse)
    torch.cuda.synchronize()
    for name in fr.OUTPUTS:
        if got[name] is None:
            assert want[name] is None
            continue
        assert fr.plain_mismatch(got[name], want[name]) is None, (
            name, fr.plain_mismatch(got[name], want[name]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("design,N,H", [("cluster", 32, 200),
                                        ("cluster", 300, 200),
                                        ("stream", 300, "past"),
                                        ("stream", 3, 13)])
def test_fused_rnn_repeats_bit_for_bit(dev, dtype, design, N, H):
    """No atomics: two runs give the same bits, dWh included, in both
    designs (the cluster design's dh partials added in rank order, and
    several clusters' dWh rows added in cluster order: 4 at N 32, several
    waves of them at N 300; the streaming design past the cluster
    design's largest H and at a tiny layer)."""
    from mxnet_tpu_torch.ops import fused_rnn as fr
    if isinstance(H, str):
        H = fr.cluster_limit("lstm", N, dtype) + 1
    assert fr.rnn_design("lstm", N, H, dtype).name == design
    px, h0, c0, wh, dys, dhT, dcT = _rnn_case(dev, "lstm", 35, N, H,
                                              dtype, seed=1)
    outs = []
    for _ in range(2):
        ys, cs, hT, cT = fr.rnn_fwd("lstm", px, h0, c0, wh)
        hp, cp = fr._shift_prev(h0, ys, False), fr._shift_prev(c0, cs, False)
        outs.append((ys, hT, cT) + fr.rnn_bwd("lstm", px, None, hp, cp, cs,
                                              wh, dys, dhT, dcT))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_fused_rnn_counts_launches_only(dev):
    from mxnet_tpu_torch.ops import fused_rnn as fr
    px, h0, c0, wh, dys, dhT, dcT = _rnn_case(dev, "lstm", 4, 3, 16,
                                              torch.float32)
    n0 = fr.launch_counts()
    ys, cs, hT, cT = fr.rnn_fwd("lstm", px, h0, c0, wh)
    fr.rnn_fwd_plain("lstm", px, h0, c0, wh)
    hp, cp = fr._shift_prev(h0, ys, False), fr._shift_prev(c0, cs, False)
    fr.rnn_bwd("lstm", px, None, hp, cp, cs, wh, dys, dhT, dcT)
    fr.rnn_bwd_plain("lstm", px, ys, hp, cp, cs, wh, dys, dhT, dcT)
    assert fr.launch_counts() == (n0[0] + 1, n0[1] + 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_word_lm_shape_takes_the_cluster_design(dev, dtype):
    """The word LM's layer (T 35, N 32, H 200, lstm) launches K4a and K4b
    through the cluster design, by the per-design counts."""
    from mxnet_tpu_torch.ops import fused_rnn as fr
    px, h0, c0, wh, dys, dhT, dcT = _rnn_case(dev, "lstm", 35, 32, 200,
                                              dtype)
    n0 = fr.design_launch_counts()
    ys, cs, hT, cT = fr.rnn_fwd("lstm", px, h0, c0, wh)
    hp, cp = fr._shift_prev(h0, ys, False), fr._shift_prev(c0, cs, False)
    fr.rnn_bwd("lstm", px, None, hp, cp, cs, wh, dys, dhT, dcT)
    n1 = fr.design_launch_counts()
    assert n1["cluster"] == (n0["cluster"][0] + 1, n0["cluster"][1] + 1)
    assert n1["stream"] == n0["stream"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["lstm", "rnn_tanh"])
def test_rnn_smem_and_clusters_match_the_kernel(dev, dtype, mode):
    """The chooser's shared memory is the kernel's layout, byte for byte,
    and the clusters it counts on running at once are the card's answer
    for both kernels (at least one of every layout that fits), at the word
    LM's H, 256, the largest H of the cluster design and a tiny one."""
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_rnn as fr
    lib = _cuda.library("fused_rnn.cu")
    dc, mc = fr._DTYPE_CODE[dtype], fr._MODE_CODE[mode]
    for H in (200, 256, fr.cluster_limit(mode, 32, dtype), 13):
        fits = fr.cluster_layouts(mode, 32, H, dtype)
        assert fits
        for P in fr.CLUSTER_BLOCKS:
            for R in fr.CLUSTER_ROWS:
                for bwd in (0, 1):
                    want = fr.cluster_smem_bytes(mode, H, R, P, dtype,
                                                 bool(bwd))
                    assert lib.mxtt_rnn_smem_bytes(dc, mc, H, R, P, bwd) \
                        == want
        for P, R, _, _ in fits:
            n = [lib.mxtt_rnn_max_clusters(dc, mc, H, R, P, bwd)
                 for bwd in (0, 1)]
            assert min(n) >= 1, (H, P, R, n)
            assert fr.clusters_at_once(mode, H, dtype, P, R) == min(n)


def test_rnn_refused_cluster_launch_raises(dev):
    """A cluster launch the card refuses (shared memory past the limit)
    returns its error from the C entry, which the wrapper raises; the
    serial floor launches."""
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_rnn as fr
    lib = _cuda.library("fused_rnn.cu")
    px, h0, c0, wh, *_ = _rnn_case(dev, "lstm", 2, 64, 512, torch.float32)
    assert fr.cluster_smem_bytes("lstm", 512, 64, 8, torch.float32,
                                 False) > fr.SMEM_LIMIT
    ys, cs = torch.empty(2, 64, 512, device=dev), torch.empty(2, 64, 512,
                                                               device=dev)
    hT, cT = torch.empty_like(h0), torch.empty_like(h0)
    err = lib.mxtt_rnn_fwd(0, 0, px.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                           wh.data_ptr(), ys.data_ptr(), cs.data_ptr(),
                           hT.data_ptr(), cT.data_ptr(), 2, 64, 512, 64, 8, 0,
                           torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(MXNetError, match="fused_rnn"):
        _cuda.check(lib, err, "fused_rnn forward kernel launch")
    fr.serial_floor("lstm", 35, 32, 200, torch.bfloat16, dev)()
    torch.cuda.synchronize()


def test_fused_rnn_gate_raises_on_cuda(dev):
    """On a CUDA tensor the kernel runs or the call raises: H past the
    gate, mixed dtypes, a non-contiguous input, and the RNN op with
    fused=True on an out-of-gate layer."""
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.ops import nn as ops_nn
    px, h0, c0, wh, *_ = _rnn_case(dev, "rnn_tanh", 2, 2, 1025,
                                   torch.float32)
    with pytest.raises(MXNetError, match="up to 1024"):
        fr.rnn_fwd("rnn_tanh", px, h0, None, wh)
    px, h0, c0, wh, *_ = _rnn_case(dev, "lstm", 3, 2, 8, torch.float32)
    with pytest.raises(MXNetError, match="mixed"):
        fr.rnn_fwd("lstm", px, h0.bfloat16(), c0, wh)
    with pytest.raises(MXNetError, match="contiguous"):
        fr.rnn_fwd("lstm", px.transpose(0, 1).contiguous().transpose(0, 1),
                   h0, c0, wh)
    x = torch.zeros(3, 2, 4, device=dev, dtype=torch.float16)
    flat = torch.zeros(ops_nn.rnn_param_size(1, 4, 8, False, "lstm"),
                       device=dev, dtype=torch.float16)
    with pytest.raises(MXNetError, match="float32 or bfloat16"):
        ops_nn.RNN(x, flat, torch.zeros(1, 2, 8, device=dev,
                                        dtype=torch.float16),
                   state_size=8, fused=True)
    with pytest.raises(MXNetError, match="mixed dtypes"):
        ops_nn.RNN(x.bfloat16(), flat.bfloat16(),
                   torch.zeros(1, 2, 8, device=dev), state_size=8,
                   fused=True)


def test_word_lm_trainstep_on_card_matches_the_cpu(dev):
    """The bench's word LM (vocab 10000, 2 x 200 LSTM) with
    MXNET_FUSED_RNN=1: the first float32 step's loss and gradients on the
    card (K4a-b) against the CPU's (the plain versions) at the same
    weights, 1e-5 of the loss and 1e-4 relative Frobenius a gradient; then
    three bf16 steps, each launching K4a and K4b twice. The vocab matters
    in bf16: TrainStep casts float token ids to bf16, as the reference's
    does, and at vocab 1000 id 999 rounds to 1000, outside the table (a
    NaN row); below 10000 every id rounds to at most 9984."""
    import os
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import gluon_params_from_numpy
    from mxnet_tpu_torch.ops import fused_rnn as fr
    from mxnet_tpu_torch.parallel import TrainStep
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    rng = np.random.RandomState(0)
    x = rng.randint(0, 10000, (35, 32)).astype(np.float32)
    y = rng.randint(0, 10000, (35 * 32,)).astype(np.int32)
    res, nets = {}, {}
    try:
        for where in ("cpu", "gpu"):
            ctx = mx.cpu() if where == "cpu" else mx.Context("gpu",
                                                             dev.index or 0)
            with ctx, mx.name.NameManager():
                net = mx.models.RNNModel(vocab_size=10000, num_embed=200,
                                         num_hidden=200, num_layers=2,
                                         dropout=0.0)
                net.initialize(mx.init.Xavier())
                net(mx.nd.zeros((35, 32)))
            if where == "gpu":
                gluon_params_from_numpy(net, {
                    n: p.data().asnumpy() for n, p in
                    nets["cpu"].collect_params().items()})
            nets[where] = net
            step = TrainStep(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": 0.1})
            dv = ctx.torch_device()
            res[where] = step.loss_and_grads(torch.from_numpy(x).to(dv),
                                             torch.from_numpy(y).to(dv))
        assert float(res["gpu"][0]) == pytest.approx(float(res["cpu"][0]),
                                                     rel=1e-5)
        rel = [float((res["gpu"][1][n].cpu() - g).norm() / g.norm())
               for n, g in res["cpu"][1].items()]
        assert max(rel) < 1e-4
        bf16 = TrainStep(nets["gpu"], mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                         "sgd", {"learning_rate": 0.1}, dtype="bfloat16")
        n0 = fr.launch_counts()
        xg, yg = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        losses = [float(bf16(xg, yg)) for _ in range(3)]
        assert fr.launch_counts() == tuple(c + 6 for c in n0)
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior


# ---------------------------------------------------------------------------
# BASELINE config 1: the executor's BatchNorm on K3a-d, Module on the card,
# pinned DataLoader batches
# ---------------------------------------------------------------------------


def _bn_module(dev, batch=16):
    import os
    import mxnet_tpu_torch as tmx
    import chip_smoke
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    with tmx.gpu(dev.index or 0):
        mod = tmx.mod.Module(chip_smoke.bn_convnet(tmx.sym))
        mod.bind(data_shapes=[("data", (batch, 1, 28, 28))],
                 label_shapes=[("softmax_label", (batch,))])
        mod.init_params(tmx.init.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
    rng = np.random.RandomState(0)
    batch_ = tmx.io.DataBatch(
        [tmx.nd.array(rng.rand(batch, 1, 28, 28), ctx=tmx.cpu())],
        [tmx.nd.array(rng.randint(0, 10, batch), ctx=tmx.cpu())])
    return tmx, mod, batch_


def test_executor_batchnorm_launches_k3_twice_a_step_and_none_in_inference(
        dev):
    """Two BatchNorm nodes: each K3 kernel launches twice a training step
    (one forward or backward per node) and not at all in score."""
    import os
    from mxnet_tpu_torch.ops import fused_bn as fb
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    try:
        tmx, mod, batch = _bn_module(dev)
        fb.reset_launch_counts()
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        assert fb.launch_counts() == (6, 6, 6, 6)
        fb.reset_launch_counts()
        it = tmx.io.NDArrayIter(batch.data[0].asnumpy(),
                                batch.label[0].asnumpy(), batch_size=16)
        mod.score(it, "acc")
        assert fb.launch_counts() == (0, 0, 0, 0)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior


def test_module_on_the_card_keeps_every_array_there(dev):
    import os
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    try:
        tmx, mod, batch = _bn_module(dev)
        mod.forward_backward(batch)
        mod.update()
        ex = mod._exec
        for d in (ex.arg_dict, ex.grad_dict, ex.aux_dict):
            for n, a in d.items():
                assert a._data.device.type == "cuda", n
        assert all(o._data.device.type == "cuda" for o in ex.outputs)
        args, aux = mod.get_params()
        assert all(a._data.device.type == "cuda"
                   for a in list(args.values()) + list(aux.values()))
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior


def test_dataloader_pin_memory_yields_pinned_batches(dev):
    import mxnet_tpu_torch as tmx
    ds = tmx.gluon.data.ArrayDataset(
        np.random.RandomState(0).randint(0, 255, (10, 4, 4, 1)).astype(
            np.uint8), np.arange(10).astype(np.int32))
    for workers in (0, 2):
        dl = tmx.gluon.data.DataLoader(ds, batch_size=4, pin_memory=True,
                                       num_workers=workers)
        for x, y in dl:
            assert x._data.is_pinned() and y._data.is_pinned()
            assert x._data.device.type == "cpu"
    with tmx.gpu(dev.index or 0):
        dl = tmx.gluon.data.DataLoader(ds, batch_size=4, pin_memory=True,
                                       device_prefetch=2)
    batches = list(dl)
    assert all(x._data.device.type == "cuda" for x, _ in batches)
    np.testing.assert_array_equal(batches[0][0].asnumpy(),
                                  ds._data[0][:4])


def test_hybridized_resnet_launches_k3_once_a_batchnorm_node(dev, tmp_path):
    """resnet18_v1 hybridized with MXNET_FUSED_BN_EPILOGUE=1: each of its
    20 BatchNorm nodes launches each K3 kernel once a training step (the
    cached graph's BatchNorm op; the traced graph has no fused-epilogue
    node), none in inference; its inference outputs match the eager
    call's within 1e-5, and so do those of its export imported onto the
    card."""
    import os
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.ops import fused_bn as fb
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    try:
        with tmx.gpu(dev.index or 0), \
                torch.backends.cudnn.flags(enabled=False):
            with tmx.name.NameManager():
                net = tmx.gluon.model_zoo.vision.resnet18_v1(classes=10)
            net.initialize(tmx.init.Xavier())
            x = tmx.nd.array(np.random.RandomState(0).uniform(
                -1, 1, (4, 3, 64, 64)).astype(np.float32))
            net(x)
            net.hybridize()
            fb.reset_launch_counts()
            for _ in range(2):
                with tmx.autograd.record():
                    loss = (net(x) ** 2).sum()
                loss.backward()
            torch.cuda.synchronize()
            assert net._cached_graph is not None
            assert fb.launch_counts() == (40, 40, 40, 40)
            fb.reset_launch_counts()
            got = net(x).asnumpy()
            assert fb.launch_counts() == (0, 0, 0, 0)
            net.hybridize(False)
            eager = net(x).asnumpy()
            net.hybridize()
            np.testing.assert_allclose(got, eager, rtol=1e-5, atol=1e-5)
            prefix = str(tmp_path / "rn")
            net.export(prefix)
            blk = tmx.gluon.SymbolBlock.imports(
                prefix + "-symbol.json", "data", prefix + "-0000.params",
                ctx=tmx.gpu(dev.index or 0))
            for p in blk.collect_params().values():
                assert p.data()._data.device.type == "cuda", p.name
            out = blk(x)
            assert out._data.device.type == "cuda"
            np.testing.assert_allclose(out.asnumpy(), got, rtol=1e-5,
                                       atol=1e-5)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior


def test_symbol_block_imports_onto_the_card(dev, tmp_path):
    """A model exported on the CPU, imported with ctx=gpu: every
    parameter lands on the card and the logits match the CPU's."""
    import mxnet_tpu_torch as tmx
    with tmx.cpu():
        with tmx.name.NameManager():
            net = tmx.models.LeNet()
        net.initialize(tmx.init.Xavier())
        x = np.random.RandomState(1).rand(2, 1, 28, 28).astype(np.float32)
        want = net(tmx.nd.array(x)).asnumpy()
        prefix = str(tmp_path / "lenet")
        net.export(prefix)
    blk = tmx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                        prefix + "-0000.params",
                                        ctx=tmx.gpu(dev.index or 0))
    for p in blk.collect_params().values():
        assert p.data()._data.device.type == "cuda", p.name
    out = blk(tmx.nd.array(x, ctx=tmx.gpu(dev.index or 0)))
    assert out._data.device.type == "cuda"
    np.testing.assert_allclose(out.asnumpy(), want, rtol=1e-5, atol=1e-6)


def test_bucketing_fused_cell_on_the_card_launches_k4(dev):
    """A FusedRNNCell graph (chip_smoke.bucketing_sym_gen, small width)
    through BucketingModule with MXNET_FUSED_RNN=1: each step launches K4a
    and K4b once a layer, the deferred-batch `sym.zeros` begin states are
    made on the card (a CPU state would make the kernel raise), every
    bucket's arrays stay there, and the first step's outputs match the
    CPU's plain run within ops/fused_rnn.py PLAIN_TOL."""
    import os
    import random
    import chip_smoke
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.ops import fused_rnn as fr
    prior = os.environ.get("MXNET_FUSED_RNN")
    os.environ["MXNET_FUSED_RNN"] = "1"
    try:
        sentences = chip_smoke.bucketing_corpus(np, 80, 50, (3, 10))
        outs = {}
        for where in ("cpu", "card"):
            ctx = tmx.cpu() if where == "cpu" else tmx.gpu(dev.index or 0)
            random.seed(0)
            np.random.seed(0)
            it = tmx.rnn.BucketSentenceIter(sentences, 8, buckets=[5, 10],
                                            invalid_label=0)
            mod = tmx.mod.BucketingModule(
                chip_smoke.bucketing_sym_gen(tmx, 50, 16, 32, 2),
                default_bucket_key=10, context=ctx)
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(tmx.init.Mixed(
                [".*lstm_parameters", ".*"],
                [tmx.init.Uniform(0.1), tmx.init.Xavier()]))
            mod.init_optimizer(optimizer="adam",
                               optimizer_params={"learning_rate": 0.01})
            batches = list(it)[:4]
            fr.reset_launch_counts()
            mod.forward_backward(batches[0])
            outs[where] = mod.get_outputs()[0]._data.cpu()
            mod.update()
            for batch in batches[1:]:
                mod.forward_backward(batch)
                mod.update()
            torch.cuda.synchronize()
            if where == "card":
                assert fr.launch_counts() == (8, 8)
                assert len(mod._buckets) == 2
                for m in mod._buckets.values():
                    for d in (m._exec.arg_dict, m._exec.grad_dict):
                        for n, a in d.items():
                            assert a._data.device.type == "cuda", n
            else:
                assert fr.launch_counts() == (0, 0)
        assert fr.plain_mismatch(outs["card"], outs["cpu"]) is None
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_RNN", None)
        else:
            os.environ["MXNET_FUSED_RNN"] = prior


# ---------------------------------------------------------------------------
# Inception-v3's BatchNorm shapes, the Gluon cells on K4a, the model zoo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,S", [(192, 5041), (96, 1225), (160, 289),
                                 (448, 64)])
def test_fused_bn_kernels_match_plain_at_inception_shapes(dev, dtype, C, S):
    """K3a-d at Inception-v3's odd spatial sizes (71x71, 35x35, 17x17)
    and its 8x8 one, relu off as its BatchNorms run, batch 16."""
    x, dy, _, gamma, beta = _bn_case(dev, 16, C, S, dtype, seed=C + S)
    _bn_check_all(x, dy, None, gamma, beta, False)


def test_gluon_lstm_cells_equal_the_lstm_layer_on_k4a(dev):
    """chip_smoke.py's phase 16d at a small width: a SequentialRNNCell of
    two LSTMCells unrolled against gluon.rnn.LSTM with the same weights
    under MXNET_FUSED_RNN=1 (K4a once a layer), within PLAIN_TOL."""
    import chip_smoke
    mods = {n: getattr(chip_smoke, n) for n in ("CELL_T", "CELL_N",
                                                "CELL_C", "CELL_H")}
    try:
        chip_smoke.CELL_T, chip_smoke.CELL_N = 9, 5
        chip_smoke.CELL_C, chip_smoke.CELL_H = 24, 40
        launches, main = chip_smoke.phase_gluon_cells(torch, np, dev,
                                                      "card test")
    finally:
        for n, v in mods.items():
            setattr(chip_smoke, n, v)
    assert launches == (2, 0)
    assert set(main["losses_card_vs_cpu"]) >= {"L1Loss", "TripletLoss"}


def test_model_zoo_step_on_card_launches_k3_per_batchnorm(dev):
    """One flag-on Gluon step of mobilenetv2_0.25 (depthwise BatchNorms)
    and of a small DenseNet (concat-grown channels) on the card: K3a-d
    once for each BatchNorm block, a finite loss, and the hybridized
    inference logits equal to the eager ones."""
    import os
    import chip_smoke
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.ops import fused_bn as fb
    vision = tmx.gluon.model_zoo.vision
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    try:
        for make, size in ((lambda: vision.get_model(
                "mobilenetv2_0.25", classes=10), 32),
                (lambda: vision.DenseNet(16, 8, (2, 2), classes=10), 64)):
            with tmx.name.NameManager():
                net = make()
            net.initialize(tmx.init.Xavier())
            x, y = chip_smoke.prototype_batch(torch, dev, 8, 10, size, 1)
            x, y = tmx.nd.NDArray(x), tmx.nd.NDArray(y)
            eager = net(x).asnumpy()
            n_bn = len(list(chip_smoke.gluon_batchnorms(tmx, net)))
            trainer = tmx.gluon.Trainer(net.collect_params(), "sgd",
                                        {"learning_rate": 0.01})
            fb.reset_launch_counts()
            loss = chip_smoke.gluon_step(
                tmx, net, trainer, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                x, y)
            torch.cuda.synchronize()
            assert fb.launch_counts() == (n_bn,) * 4
            assert bool(torch.isfinite(loss))
            before = net(x).asnumpy()
            net.hybridize()
            np.testing.assert_allclose(net(x).asnumpy(), before, rtol=1e-5,
                                       atol=1e-5 * np.abs(before).max())
            assert net._cached_graph is not None
            assert eager.shape == (8, 10)
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior


# ---------------------------------------------------------------------------
# the optimizers, TrainStep's remat and probe, DevicePrefetchIter
# ---------------------------------------------------------------------------

_RULE_PARAMS = {
    "sgd": {"momentum": 0.9}, "ccsgd": {"momentum": 0.9},
    "signum": {"momentum": 0.9, "wd_lh": 1e-3}, "ftml": {},
    "lbsgd": {"momentum": 0.9}, "dcasgd": {"momentum": 0.9},
    "nag": {"momentum": 0.9}, "adam": {}, "adagrad": {},
    "rmsprop": {"centered": True, "clip_weights": 0.5}, "adadelta": {},
    "ftrl": {"lamda1": 1e-4}, "adamax": {}, "nadam": {}, "test": {},
}


@pytest.mark.parametrize("name", sorted(_RULE_PARAMS))
def test_optimizer_rules_on_the_card_match_the_cpu(dev, name):
    """Each pure rule, 3 updates on a CUDA tensor against the same on the
    CPU: float32 elementwise math, within 1e-6 relative (the card may
    fuse a multiply-add)."""
    from mxnet_tpu_torch import optimizer as opt_mod
    from mxnet_tpu_torch import optimizer_rules as rules
    opt = opt_mod.create(name, learning_rate=0.02, wd=1e-3,
                         **_RULE_PARAMS[name])
    init, apply_rule = rules.get(opt.rule_name)
    rng = np.random.RandomState(0)
    w0 = torch.from_numpy(rng.uniform(-1, 1, (64, 33)).astype(np.float32))
    gs = [torch.from_numpy(rng.uniform(-1, 1, (64, 33)).astype(np.float32))
          for _ in range(3)]
    out = {}
    for where in ("cpu", dev):
        w = w0.to(where)
        st = init(w, opt.rule_hyper())
        for t, g in enumerate(gs, 1):
            w, st = apply_rule(w, g.to(where), st, 0.02, 1e-3, t,
                               opt.rule_hyper())
        out[str(where)] = [w.cpu()] + [s.cpu() for s in st]
    for a, b in zip(out[str(dev)], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def _bn_block_net(tmx):
    from mxnet_tpu_torch.gluon import nn
    with tmx.name.NameManager():
        net = nn.HybridSequential(prefix="cr_")
        with net.name_scope():
            for _ in range(2):
                blk = nn.HybridSequential()
                with blk.name_scope():
                    blk.add(nn.Conv2D(16, 3, padding=1))
                    blk.add(nn.BatchNorm())
                    blk.add(nn.Activation("relu"))
                    blk.add(nn.Conv2D(16, 3, padding=1))
                    blk.add(nn.BatchNorm())
                net.add(_OneSegment(blk))
            net.add(nn.GlobalAvgPool2D())
            net.add(nn.Dense(10))
    net.initialize(tmx.init.Xavier())
    net(tmx.nd.zeros((2, 3, 16, 16)))
    return net


class _OneSegment(HybridBlock):
    """A block that is not a container: one remat segment."""

    def __init__(self, body, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.body = body

    def hybrid_forward(self, F, x):
        return F.relu(self.body(x))


def test_remat_launch_counts_on_the_card(dev):
    """One step of two conv-BN blocks (4 BatchNorms) with the fused
    epilogue: K3a launches 4 / 8 / 4 times under none / full / io, K3b
    4 / 8 / 8, K3c and K3d 4 each, and the losses agree."""
    import os
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import fused_bn as fb
    from mxnet_tpu_torch.parallel import TrainStep
    prior = os.environ.get("MXNET_FUSED_BN_EPILOGUE")
    os.environ["MXNET_FUSED_BN_EPILOGUE"] = "1"
    try:
        net = _bn_block_net(tmx)
        start = {k: p.data()._data.clone()
                 for k, p in net.collect_params().items()}
        x, y = cs.prototype_batch(torch, dev, 8, 10, 16, 2)
        counts, losses = {}, {}
        for mode in ("none", "full", "io"):
            for k, p in net.collect_params().items():
                p.set_data(start[k].clone())  # the step updates in place
            step = TrainStep(net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
                             {"learning_rate": 0.05}, remat=mode)
            fb.reset_launch_counts()
            losses[mode] = float(step(x, y))
            torch.cuda.synchronize()
            counts[mode] = fb.launch_counts()
        assert counts["none"] == (4, 4, 4, 4), counts
        assert counts["full"] == (8, 8, 4, 4), counts
        assert counts["io"] == (4, 8, 4, 4), counts
        for mode in ("full", "io"):
            assert abs(losses[mode] - losses["none"]) <= \
                1e-5 * abs(losses["none"])
    finally:
        if prior is None:
            os.environ.pop("MXNET_FUSED_BN_EPILOGUE", None)
        else:
            os.environ["MXNET_FUSED_BN_EPILOGUE"] = prior


def test_device_prefetch_orders_the_consumer_stream(dev):
    """Batches staged on the side stream are read correctly by a consumer
    on another stream: it waits on the copy's event, and record_stream
    keeps the memory from reuse while its work runs."""
    import mxnet_tpu_torch as tmx
    x = np.arange(64 * 1024, dtype=np.float32).reshape(64, 1024)
    y = np.arange(64, dtype=np.float32)
    pre = tmx.io.DevicePrefetchIter(
        tmx.io.NDArrayIter(x, y, batch_size=8), depth=3, device=tmx.gpu(0))
    consumer = torch.cuda.Stream(dev)
    got = []
    with torch.cuda.stream(consumer):
        for b in pre:
            assert b.data[0]._data.device == dev
            # a long kernel on the consumer stream first, then the read
            torch.cuda._sleep(1_000_000)
            got.append((b.data[0]._data * 2).sum())
    torch.cuda.synchronize()
    want = [float((x[i:i + 8] * 2).sum()) for i in range(0, 64, 8)]
    assert [float(g) for g in got] == want


def test_probe_is_bit_identical_with_cudnn_convolutions(dev):
    """Two probes of a conv net give the same floats: the probe turns
    cuDNN's deterministic algorithms on for its duration (and back
    off)."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.parallel import TrainStep
    net = _bn_block_net(tmx)
    x, y = cs.prototype_batch(torch, dev, 32, 10, 16, 3)
    step = TrainStep(net, gloss.SoftmaxCrossEntropyLoss(), "adam",
                     {"learning_rate": 0.01})
    step(x, y)
    prior = torch.backends.cudnn.deterministic
    first = step.probe(x, y, seed=1)
    assert all(step.probe(x, y, seed=1) == first for _ in range(3))
    assert torch.backends.cudnn.deterministic == prior


# ---------------------------------------------------------------------------
# BASELINE config 4 (SSD): the multibox and other contrib ops, SSDLite's
# step through K3a-d, custom ops on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", range(16))
def test_ssd_slice_ops_on_the_card_match_the_cpu(dev, case, monkeypatch):
    """Each of chip_smoke.py phase 27d's cases (the slice's 15 op names)
    at a quarter of its batch: the card's output, and its gradients where
    the op is differentiable, within the phase's limit of the CPU's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import registry
    monkeypatch.setattr(cs, "SSD_BATCH", 8)
    monkeypatch.setattr(cs, "SSD_OP_DET_BATCH", 2)
    cases = cs.ssd_op_cases(torch, dev)
    assert len(cases) == 16
    name, make, params, kind = cases[case]
    err, gerr, _, tol, gtol = cs.item2_one(
        torch, mx, registry, name, make(), params, kind, dev, case,
        grads=True)
    assert err <= tol and gerr <= gtol, (name, err, gerr)


def test_multibox_detection_on_the_card_is_greedy_nms(dev):
    import mxnet_tpu_torch as mx
    g = torch.Generator().manual_seed(0)
    A = cs.ssd_anchor_count()
    probs = torch.softmax(torch.randn(4, 21, A, generator=g) * 3, 1).to(dev)
    loc = (torch.randn(4, 4 * A, generator=g) * 0.5).to(dev)
    anchors = cs.ssd_op_cases(torch, dev)[2][1]()[2]
    det = mx.nd.contrib.MultiBoxDetection(
        mx.nd.NDArray(probs), mx.nd.NDArray(loc), mx.nd.NDArray(anchors),
        nms_threshold=0.45)._data
    assert det.device == dev and det.shape == (4, A, 6)
    assert cs.nms_violations(torch, probs, det, 0.45) == 0
    assert int((det[..., 0] >= 0).sum()) > 0


@pytest.mark.parametrize("flag", ["1", "0"])
def test_ssd_step_on_the_card_launches_k3_once_a_batchnorm(dev, flag,
                                                            monkeypatch):
    """One examples/train_ssd.py step of SSDLite (batch 4, 64 x 64) on the
    card: K3a-d 5 times each with the flag on, none with it off, and the
    loss within 1e-4 of the same step on the CPU from the same weights."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models import gluon_params_from_numpy
    from mxnet_tpu_torch.ops import fused_bn as fb
    monkeypatch.setenv("MXNET_FUSED_BN_EPILOGUE", flag)
    module = cs.load_example("train_ssd.py")
    x, y = cs.ssd_batch(np, np.random.RandomState(0), 4, 64, 3, 4)
    losses, arrays = {}, None
    for where in ("cpu", "card"):
        ctx = mx.cpu() if where == "cpu" else mx.gpu(0)
        with ctx:
            with mx.name.NameManager():
                net = module.SSDLite(num_classes=3)
            net.initialize(mx.init.Xavier())
            net(mx.nd.array(x[:1]))
            if arrays is None:
                arrays = {n: p.data().asnumpy()
                          for n, p in net.collect_params().items()}
            gluon_params_from_numpy(net, arrays)
            trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                       {"learning_rate": 0.005})
            n0 = fb.launch_counts()
            loss = cs.ssd_train(mx, net, trainer, module.ssd_loss,
                                mx.nd.array(x), mx.nd.array(y), 4)
            losses[where] = float(loss.asnumpy())
            n1 = fb.launch_counts()
    want = 5 if flag == "1" else 0
    assert tuple(b - a for a, b in zip(n0, n1)) == (want,) * 4
    assert losses["card"] == pytest.approx(losses["cpu"], rel=1e-4)


def test_custom_op_on_the_card_keeps_its_arrays_there(dev):
    """nd.Custom and a bound sym.Custom on card arrays: the op's inputs,
    outputs and gradients all on the card."""
    import mxnet_tpu_torch as mx
    seen = []

    class Scale(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            seen.append((in_data[0].context, mx.current_context()))
            self.assign(out_data[0], req[0], in_data[0] * 3)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0] * 3)

    @mx.operator.register("_card_test_scale")
    class ScaleProp(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Scale()

    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                    ctx=mx.gpu(0))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="_card_test_scale")
    y.backward()
    assert y._data.device == dev and x.grad._data.device == dev
    np.testing.assert_allclose(x.grad.asnumpy(), np.full((2, 3), 3.0))
    s = mx.sym.Custom(mx.sym.Variable("data"), op_type="_card_test_scale")
    exe = s.simple_bind(mx.gpu(0), data=(2, 3))
    out = exe.forward(is_train=True, data=x)[0]
    assert out._data.device == dev
    assert all(c.device_type == "gpu" for pair in seen for c in pair)


# ---------------------------------------------------------------------------
# sparse storage and int8 quantization (ROADMAP item 13's last half)
# ---------------------------------------------------------------------------


def test_sparse_ops_on_card_match_cpu_and_repeat(dev):
    """csr . dense in both forms and merge_rowsparse on the card: equal to
    the CPU within 1e-5 and the same bits run after run (segment sums,
    no float atomics); every output on the card."""
    from mxnet_tpu_torch.ndarray import sparse
    import mxnet_tpu_torch as mx
    rs = np.random.RandomState(0)
    n, d, k = 64, 5000, 20
    cols = rs.randint(0, d, n * k).astype(np.int32)
    indptr = np.arange(0, n * k + 1, k).astype(np.int32)
    vals = rs.rand(n * k).astype(np.float32)
    rhs = rs.randn(d, 3).astype(np.float32)
    g = rs.randn(n, 3).astype(np.float32)
    parts = [(np.sort(rs.choice(d, 50, False)),
              rs.randn(50, 3).astype(np.float32)) for _ in range(3)]
    out = {}
    for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
        x = sparse.CSRNDArray(vals, cols, indptr, (n, d), ctx=ctx)
        rsp = [sparse.RowSparseNDArray(i, v, (d, 3), ctx=ctx)
               for i, v in parts]

        def run():
            m = sparse.merge_rowsparse(rsp)
            return (sparse.dot(x, mx.nd.array(rhs, ctx=ctx))._data,
                    sparse.dot(x, mx.nd.array(g, ctx=ctx),
                               transpose_a=True)._data,
                    m._indices, m._values)
        out[where] = run()
        if where == "card":
            assert all(t.device == dev for t in out[where])
            assert all(torch.equal(a, b) for a, b in zip(run(),
                                                         out[where]))
    for c, h in zip(out["card"], out["cpu"]):
        if c.is_floating_point():
            np.testing.assert_allclose(c.cpu().numpy(), h.numpy(),
                                       rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(c.cpu(), h)


def test_quantized_fc_pads_to_the_int_mm_rule(dev):
    """torch._int_mm wants inner and output extents that are multiples
    of 8: the quantized FullyConnected zero-pads any user shape (exact in
    int32) and slices, equal to the CPU's int32 product."""
    from mxnet_tpu_torch.ops import quantization as q
    g = torch.Generator().manual_seed(0)
    for rows, inner, out in ((5, 36, 10), (33, 12, 7), (64, 2048, 1000)):
        x = torch.randint(-127, 128, (rows, inner), generator=g,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (out, inner), generator=g,
                          dtype=torch.int8)
        r = torch.tensor(1.0)
        want = q.quantized_fully_connected(x, w, -r, r, -r, r,
                                           num_hidden=out, no_bias=True)[0]
        rd = r.to(dev)
        got = q.quantized_fully_connected(x.to(dev), w.to(dev), -rd, rd,
                                          -rd, rd, num_hidden=out,
                                          no_bias=True)[0]
        assert got.device == dev and got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)


def test_quantize_divides_truly_on_card(dev):
    """quantize's scale is 127 / amax divided truly: the card's int8
    values equal the CPU's, at values on a rounding boundary too."""
    from mxnet_tpu_torch.ops import quantization as q
    g = torch.Generator().manual_seed(1)
    x = torch.rand(1 << 16, generator=g) * 6 - 3
    amax = torch.tensor(2.9)
    x[:254] = torch.arange(-127, 127).float() * 2.9 / 127 + 0.5 * 2.9 / 127
    want = q.quantize(x, -amax, amax)[0]
    got = q.quantize(x.to(dev), (-amax).to(dev), amax.to(dev))[0]
    assert torch.equal(got.cpu(), want)


def test_lazy_sgd_and_adam_on_card_match_cpu(dev):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ndarray import sparse
    rs = np.random.RandomState(2)
    w0 = rs.randn(100, 4).astype(np.float32)
    rows = np.array([3, 7, 42, 99], np.int32)
    vals = rs.randn(4, 4).astype(np.float32)
    for name, kw in (("sgd", dict(momentum=0.9, wd=0.01)), ("adam", {})):
        res = {}
        for where, ctx in (("card", mx.gpu(0)), ("cpu", mx.cpu())):
            w = mx.nd.array(w0, ctx=ctx)
            up = mx.optimizer.get_updater(mx.optimizer.create(name, **kw))
            for _ in range(3):
                up(0, sparse.RowSparseNDArray(rows, vals, (100, 4),
                                              ctx=ctx), w)
            res[where] = w.asnumpy()
        np.testing.assert_allclose(res["card"], res["cpu"], rtol=1e-5,
                                   atol=1e-6)
        keep = np.setdiff1d(np.arange(100), rows)
        np.testing.assert_array_equal(res["card"][keep], w0[keep])


def test_exported_word_lm_replays_k4a_across_devices(dev, tmp_path,
                                                     monkeypatch):
    """A word LM exported on the CPU with MXNET_FUSED_RNN=1 and loaded on
    the card: its zero begin states and parameters move with it, and one
    replay launches K4a once a layer (K4b none), within 1e-5 of the CPU's
    logits (the plain version there)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import predict
    from mxnet_tpu_torch.ops import fused_rnn
    monkeypatch.setenv("MXNET_FUSED_RNN", "1")
    with mx.cpu():
        net = mx.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mx.gluon.nn.Embedding(20, 8))
            net.add(mx.gluon.rnn.LSTM(16, layout="NTC", num_layers=2))
            net.add(mx.gluon.nn.Dense(20, flatten=False))
        net.initialize(mx.init.Xavier())
        tok = np.random.RandomState(0).randint(0, 20, (2, 6)).astype(
            np.float32)
        want = net(mx.nd.array(tok)).asnumpy()
        art = str(tmp_path / "lm.mxtpu")
        predict.export_model(net, [("data", (2, 6))], art)
    served = predict.load_exported(art, ctx=mx.gpu(0))
    fused_rnn.reset_launch_counts()
    got = served.forward(data=tok)[0]
    torch.cuda.synchronize()
    assert got._data.device == dev
    assert fused_rnn.launch_counts() == (2, 0)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# test_utils.check_consistency over [cpu, gpu(0)] (chip_smoke.py phases 12b
# and 21a at small sizes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["bn_convnet", "sym_rnn_lstm"])
def test_check_consistency_cpu_vs_card_launches_k3_and_k4(dev, case):
    """One Symbol bound on the CPU and on the card at chip_smoke's
    CONSIST_SCALE (the convolutions without cuDNN): outputs and gradients
    within check_consistency's tol (1e-3); the card launches each K3
    kernel once a BatchNorm node, or K4a and K4b once a layer, and the
    CPU's plain versions launch nothing."""
    import os
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.ops import fused_bn as fb
    from mxnet_tpu_torch.ops import fused_rnn as fr
    if case == "bn_convnet":
        flag, counts, want = "MXNET_FUSED_BN_EPILOGUE", fb.launch_counts, \
            (2,) * 4
        with tmx.name.NameManager():
            sym = cs.bn_convnet(tmx.sym)
        shapes = {"data": (4, 1, 28, 28)}
    else:
        flag, counts, want = "MXNET_FUSED_RNN", fr.launch_counts, (2, 2)
        with tmx.name.NameManager():
            sym = tmx.sym.RNN(tmx.sym.Variable("data"), mode="lstm",
                              state_size=64, num_layers=2, name="lstm")
        shapes = {"data": (7, 5, 16)}
    prior = os.environ.get(flag)
    os.environ[flag] = "1"
    try:
        ctxs = [dict(shapes, ctx=tmx.cpu()),
                dict(shapes, ctx=tmx.gpu(dev.index or 0))]
        errors = {}
        n0 = counts()
        with torch.backends.cudnn.flags(enabled=False):
            outs = tu.check_consistency(sym, ctxs, scale=cs.CONSIST_SCALE,
                                        errors=errors)
        torch.cuda.synchronize()
        launched = tuple(b - a for a, b in zip(n0, counts()))
        # the CPU alone launches nothing
        n1 = counts()
        tu.check_consistency(sym, [ctxs[0], ctxs[0]],
                             scale=cs.CONSIST_SCALE)
        assert counts() == n1
    finally:
        if prior is None:
            os.environ.pop(flag, None)
        else:
            os.environ[flag] = prior
    assert launched == want
    assert errors["outputs"] <= 1.0 and errors["grads"] <= 1.0
    assert len(outs) == 2 and all(np.isfinite(o).all() for o in outs[1])


# ---------------------------------------------------------------------------
# the compile watchdog and the AOT cache on the card (ROADMAP item 11)
# ---------------------------------------------------------------------------

_WARM_LOAD = r"""
import json, sys
from mxnet_tpu_torch import aot
from mxnet_tpu_torch.ops import _cuda
from mxnet_tpu_torch.telemetry import introspect
lib = _cuda.library("fused_bn.cu")
site = introspect.watchdog().site("kernels.fused_bn")
print(json.dumps({"compiles": site.compiles, "hits": site.cache_hits,
                  "entries": aot.cache().entries(),
                  "declared": hasattr(lib, "mxtt_bn_stats")}))
"""


def test_kernel_library_warm_loads_from_the_cache_in_a_fresh_process(
        dev, tmp_path):
    """A cache filled by one process (the library built, or taken from
    _build/, and published) serves a fresh process with zero nvcc builds:
    its watchdog counts one warm load at kernels.fused_bn."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, MXNET_AOT_CACHE_DIR=str(tmp_path),
               PYTHONPATH=root)
    outs = []
    for _ in range(2):
        p = subprocess.run([sys.executable, "-c", _WARM_LOAD], env=env,
                           capture_output=True, text=True, timeout=600,
                           cwd=root)
        assert p.returncode == 0, p.stderr[-3000:]
        outs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    first, second = outs
    assert first["hits"] == 0 and len(first["entries"]) == 1
    assert second == {"compiles": 0, "hits": 1,
                      "entries": first["entries"], "declared": True}


def test_hbm_gate_refuses_a_cuda_step_before_its_update(dev, monkeypatch):
    """The step's measured footprint meets MXNET_HBM_BUDGET_GB before the
    optimizer update: refused, the parameters and the step count stay;
    lifted, the same signature runs with no new first run."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch.parallel import TrainStep
    from mxnet_tpu_torch.telemetry import introspect
    introspect.reset()
    with tmx.gpu(0):
        net = tmx.gluon.nn.Dense(64, in_units=128)
        net.initialize()
        step = TrainStep(net, tmx.gluon.loss.L2Loss(), "sgd",
                         {"learning_rate": 0.1})
        x = tmx.nd.array(np.ones((32, 128), np.float32))
        y = tmx.nd.array(np.zeros((32, 64), np.float32))
        w0 = net.weight.data().asnumpy().copy()
        monkeypatch.setenv("MXNET_HBM_BUDGET_GB", "1e-9")
        with pytest.raises(introspect.HbmBudgetExceeded, match="train.step"):
            step(x, y)
        assert step.t == 0
        np.testing.assert_array_equal(net.weight.data().asnumpy(), w0)
        ev, = introspect.compile_events("train.step")
        assert ev["hbm_bytes"] > ev["memory"]["argument_bytes"] > 0
        monkeypatch.delenv("MXNET_HBM_BUDGET_GB")
        float(step(x, y))
        assert step.t == 1
        assert len(introspect.compile_events("train.step")) == 1
        assert np.abs(net.weight.data().asnumpy() - w0).max() > 0
