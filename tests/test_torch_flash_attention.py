"""Port parity for flash attention (mxnet_tpu_torch/ops/flash_attention.py)
against the JAX reference (mxnet_tpu/ops/pallas_attention.py) on the CPU.

The reference's forward runs its Pallas kernel in interpret mode, its
backward is the blockwise lax `_flash_bwd_blockwise`; the port's CPU path
is the kernels' plain versions (`flash_fwd_plain`, `flash_bwd_plain`),
which `chip_smoke.py` and tests/test_torch_cuda.py hold the CUDA kernels
against on the card. Inputs come from numpy seeds and are handed to both.
Tolerances: outputs and m agree to 1e-5 (float32, the two sum in another
order: online softmax by blocks against one dense softmax); l, a sum of
up to T terms each <= 1, to 1e-5 relative; gradients to rtol 1e-4 and
atol 1e-5, the reference suite's own flash-gradient tolerance
(tests/test_pallas.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import pallas_attention as ref
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: (T, Tk, causal, block_q, block_k) — the reference's blocks must tile
#: T and Tk; the ragged T=37 runs as one 37-row block there
_CASES = [(64, 64, True, 32, 32), (64, 64, False, 32, 32),
          (37, 37, True, 37, 37), (64, 48, False, 32, 16)]


def _inputs(BH, T, Tk, D, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((BH, T, D), (BH, Tk, D), (BH, Tk, D)))
    g = rng.standard_normal((BH, T, D)).astype(np.float32)
    return q, k, v, g


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("T,Tk,causal,bq,bk", _CASES)
def test_fwd_plain_matches_reference_kernel(T, Tk, causal, bq, bk):
    q, k, v, _ = _inputs(3, T, Tk, 16, seed=T + Tk)
    scale = 1.0 / np.sqrt(16)
    o, m, l = ref._flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale, causal, bq, bk, True)
    po, pm, pl = fa.flash_fwd_plain(*_t(q, k, v), scale, causal)
    assert po.shape == (3, T, 16) and pm.shape == pl.shape == (3, T, 1)
    assert pm.dtype == pl.dtype == torch.float32
    np.testing.assert_allclose(po.numpy(), np.asarray(o), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pm.numpy(), np.asarray(m), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pl.numpy(), np.asarray(l), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("T,Tk,causal,bq,bk", _CASES)
def test_bwd_plain_matches_reference_blockwise(T, Tk, causal, bq, bk):
    """Both backwards on the same (q, k, v, out, m, l, g)."""
    q, k, v, g = _inputs(2, T, Tk, 16, seed=7 + T)
    scale = 1.0 / np.sqrt(16)
    o, m, l = (np.asarray(a) for a in ref._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, causal, bq,
        bk, True))
    want = ref._flash_bwd_blockwise(*(jnp.asarray(a) for a in
                                      (q, k, v, o, m, l, g)),
                                    scale, causal, bq, bk)
    got = fa.flash_bwd_plain(*_t(q, k, v, o, m, l, g), scale, causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("layout", ["bhtd", "bh_td"])
@pytest.mark.parametrize("T,causal", [(64, True), (64, False), (37, True),
                                      (37, False)])
def test_autograd_matches_jax_grad(layout, T, causal):
    """flash_attention's forward and autograd gradients against jax.grad
    through the reference's flash_attention (interpret mode), over
    [B, H, T, D] and [BH, T, D]."""
    B, H, D = 1, 2, 16
    shape = (B, H, T, D) if layout == "bhtd" else (B * H, T, D)
    rng = np.random.RandomState(T + int(causal))
    q, k, v, w = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))

    blk = 32 if T % 32 == 0 else T     # the reference's kernel, not its
                                       # fallback, at the ragged T too

    def jloss(q, k, v):
        out = ref.flash_attention(q, k, v, causal=causal, block_q=blk,
                                  block_k=blk, interpret=True)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_(True) for t in _t(q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    assert out.shape == shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    for t, b in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_cpu_path_takes_views_and_counts_no_launch():
    """Transposed views (as the transformer hands them over) are taken;
    the plain versions on the CPU are not kernel launches."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((2, 20, 3, 32))
                         .astype(np.float32)).requires_grad_(True)
    q = x.transpose(1, 2)                          # (2, 3, 20, 32) view
    n_f, n_b = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    out = fa.flash_attention(q, q, q, causal=True)
    out.sum().backward()
    want = torch.softmax((q @ q.transpose(-1, -2)) / np.sqrt(32)
                         + torch.full((20, 20), float("-inf")).triu(1), -1) \
        @ q
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    assert x.grad.shape == x.shape and bool(torch.isfinite(x.grad).all())
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == (n_f, n_b)


def test_bf16_plain_rounds_once():
    """bf16 inputs: float32 arithmetic, the output rounded to bf16 once
    (the reference's kernel casts acc / l to the output dtype)."""
    q, k, v, _ = _inputs(2, 24, 24, 32, seed=5)
    tb = [t.to(torch.bfloat16) for t in _t(q, k, v)]
    out, m, l = fa.flash_fwd_plain(*tb, 0.25, True)
    o32, m32, l32 = fa.flash_fwd_plain(*(t.float() for t in tb), 0.25, True)
    assert out.dtype == torch.bfloat16 and m.dtype == torch.float32
    assert torch.equal(out, o32.to(torch.bfloat16))
    assert torch.equal(m, m32) and torch.equal(l, l32)


def test_gate_names_each_limit():
    f32 = torch.float32
    assert fa.flash_supported(64, 1024, 1024, True, f32, bh=64)
    assert fa.flash_supported(128, 1, 7, False, torch.bfloat16)
    assert fa.flash_supported(32, 1000, 1000, True, f32)
    assert "dtype" in fa.flash_limit(64, 8, 8, True, torch.float16)
    assert "head_dim 48" in fa.flash_limit(48, 8, 8, True, f32)
    assert "causal" in fa.flash_limit(64, 8, 9, True, f32)
    assert "empty" in fa.flash_limit(64, 0, 8, False, f32)
    assert "65535" in fa.flash_limit(64, 8, 8, False, f32, bh=70000)


def test_shape_mismatch_raises():
    q = torch.zeros(2, 8, 32)
    with pytest.raises(MXNetError, match="do not match"):
        fa.flash_attention_fwd(q, torch.zeros(2, 8, 16), torch.zeros(2, 8, 16),
                               0.25, False)
    with pytest.raises(MXNetError, match="BH, T, D"):
        fa.flash_attention_fwd(q[0], q[0], q[0], 0.25, False)
    with pytest.raises(MXNetError, match="no kernel"):
        fa._launch_args(q.to("meta"), q.to("meta"), False, "flash")


def test_call_cost_is_the_reference_declaration():
    """The forward cost at nq = T // block_q is the reference's declared
    cost (pallas_attention.py:130-134); the backward's flops are 2.5x."""
    BH, T, Tk, D, bq = 4, 256, 256, 64, 128
    flops, nbytes, trans = fa.flash_call_cost(BH, T, Tk, D, itemsize=2,
                                              nq=T // bq)
    assert flops == 4 * BH * T * Tk * D and trans == BH * T * Tk
    assert nbytes == (2 * BH * T * D * 2 + 2 * BH * (T // bq) * Tk * D * 2
                      + 2 * BH * T * 4)
    live = T * (T + 1) // 2
    bflops, bbytes, _ = fa.flash_call_cost(BH, T, Tk, D, pairs=live,
                                           backward=True)
    assert bflops == 10 * BH * live * D
    assert bbytes == BH * D * 4 * 8 * T + 2 * BH * T * 4
