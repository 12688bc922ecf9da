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

from mxnet_tpu_torch.base import MXNetError
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
                                   (256, 16), (128, 48)])
@pytest.mark.parametrize("tq", [1, 5])
def test_kernel_matches_plain(dev, dtype, Dh, bs, tq):
    """Ragged rows (position 0, mid-block, last slot, past the table),
    head widths 32..256 and a block wider than one warp (48 keys)."""
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
    q48, k48, v48, tab48, qs48 = _case(dev, 2, 1, 2, 48, 8, 2, [3, 9],
                                       torch.float32)
    with pytest.raises(MXNetError, match="head_dim 48"):
        pa.paged_attention(q48, k48, v48, tab48, qs48, 8)


def test_engine_paged_unsupported_shape_raises(dev):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.models import (TransformerConfig,
                                        init_transformer_params)
    cfg = TransformerConfig(vocab=32, d_model=96, n_heads=2, n_layers=1,
                            d_ff=64, max_len=32)        # head_dim 48
    params = init_transformer_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    with pytest.raises(MXNetError, match="head_dim 48"):
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
    q, kq, vq, ks, vs, tab, qs = _int8_case(dev, 2, 1, 2, 48, 8, 2, [3, 9],
                                            torch.float32)
    with pytest.raises(MXNetError, match="head_dim 48"):
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
    cfg = TransformerConfig(vocab=32, d_model=96, n_heads=2, n_layers=1,
                            d_ff=64, max_len=32)        # head_dim 48
    params = init_transformer_params(cfg, torch.Generator().manual_seed(0),
                                     device=dev)
    with pytest.raises(MXNetError, match="kv_quant=True.*head_dim 48"):
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
