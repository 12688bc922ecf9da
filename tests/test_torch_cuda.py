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
