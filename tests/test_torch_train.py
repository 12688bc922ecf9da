"""Port parity for the training path (mxnet_tpu_torch/models/transformer.py:
`lm_loss`, `train_step`, `make_train_step`, the MoE FFNs) against the JAX
reference (mxnet_tpu/models/transformer.py) on the CPU.

The reference's weights cross over as numpy arrays through
`params_from_numpy`; the same numpy tokens go to both. With
MXNET_FLASH_ATTENTION=1 the reference runs its Pallas flash kernel in
interpret mode and the port the flash kernels' plain versions; with the
flag off both run dense reference attention. The reference suite runs its
matmuls at highest precision (tests/conftest.py) and TF32 is off here.
Tolerances: losses 1e-5 (a float32 mean of log-probabilities near
log(vocab)); gradients rtol 1e-4 / atol 1e-5 (sums taken in another
order through two layers of backward); parameters after three SGD steps
2e-5; MoE logits 1e-5 and its auxiliary 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.models import transformer as ref
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import (TransformerConfig, lm_loss,
                                    make_transformer_train_step,
                                    params_from_numpy, transformer_apply)
from mxnet_tpu_torch.models import transformer as port

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TINY = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64)
#: top-k MoE: B*S = 32 tokens in groups of 8 -> 4 routing groups
_MOE_TOPK = dict(_TINY, n_experts=4, moe_top_k=2, moe_group_size=8)
_MOE_DENSE = dict(_TINY, n_experts=4)


def _both(kw, seed=0):
    jcfg = ref.TransformerConfig(**kw)
    jparams = ref.init_transformer_params(jax.random.PRNGKey(seed), jcfg)
    arrays = {k: np.asarray(v) for k, v in jparams.items()}
    cfg = TransformerConfig(**kw)
    return jparams, arrays, jcfg, cfg


@pytest.fixture(scope="module")
def dense():
    return _both(_TINY)


def _tokens(seed=3, shape=(2, 16), vocab=48):
    return np.random.RandomState(seed).randint(0, vocab, shape) \
        .astype(np.int32)


def _close_dicts(got, want, rtol, atol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("flash", ["1", "0"])
def test_lm_loss_and_grads_match_jax(dense, monkeypatch, flash):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", flash)
    jparams, arrays, jcfg, cfg = dense
    toks = _tokens()
    jloss, jgrads = jax.value_and_grad(ref.lm_loss)(
        jparams, jnp.asarray(toks), jcfg, mesh=None)
    calls = []
    real = port.flash_attention
    monkeypatch.setattr(port, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    params = params_from_numpy(arrays, cfg, "cpu")
    loss, grads = port.lm_loss_and_grads(
        params, torch.from_numpy(toks).long(), cfg)
    assert len(calls) == (cfg.n_layers if flash == "1" else 0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-5)
    _close_dicts(grads, jgrads, rtol=1e-4, atol=1e-5)


def test_three_sgd_steps_match_jax(dense, monkeypatch):
    """train_step x 3 at lr 0.1 (flash on) against the reference's step
    (bench.py's: value_and_grad of lm_loss, then p - lr * g)."""
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "1")
    jparams, arrays, jcfg, cfg = dense
    toks = _tokens(seed=4)

    @jax.jit
    def jstep(p, t):
        loss, g = jax.value_and_grad(ref.lm_loss)(p, t, jcfg, mesh=None)
        return {k: v - 0.1 * g[k] for k, v in p.items()}, loss

    params = params_from_numpy(arrays, cfg, "cpu")
    tt = torch.from_numpy(toks).long()
    jp = jparams
    for _ in range(3):
        jp, jloss = jstep(jp, jnp.asarray(toks))
        same, loss = port.train_step(params, tt, cfg, 0.1)
        assert same is params                    # updated in place
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=1e-5)
    _close_dicts(params, jp, rtol=0, atol=2e-5)


def test_make_train_step_is_seeded_and_learns(monkeypatch):
    """make_transformer_train_step on the CPU: the seed fixes the
    weights, the loss falls on a repeated batch, `run` updates in place."""
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "1")
    cfg = TransformerConfig(**_TINY)
    run, params = make_transformer_train_step(cfg, lr=0.1, seed=5,
                                              device="cpu")
    _, again = make_transformer_train_step(cfg, lr=0.1, seed=5, device="cpu")
    for k in params:
        assert torch.equal(params[k], again[k])
    toks = _tokens(seed=6)
    losses = []
    for _ in range(4):
        out, loss = run(params, toks)
        assert out is params
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert not torch.equal(params["head"], again["head"])


@pytest.mark.parametrize("kw", [_MOE_DENSE, _MOE_TOPK],
                         ids=["dense_dispatch", "topk"])
def test_moe_apply_matches_jax(kw):
    jparams, arrays, jcfg, cfg = _both(kw, seed=1)
    toks = _tokens(seed=8)
    assert ref._moe_groups(toks.size, kw.get("moe_group_size", 4096)) \
        == port._moe_groups(toks.size, cfg.moe_group_size)
    want, waux = ref.transformer_apply(jparams, jnp.asarray(toks), jcfg,
                                       return_aux=True)
    params = params_from_numpy(arrays, cfg, "cpu")
    got, aux = transformer_apply(params, torch.from_numpy(toks).long(), cfg,
                                 return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    np.testing.assert_allclose(float(aux), float(waux), rtol=0, atol=1e-6)
    if cfg.moe_top_k:
        assert float(aux) > 0      # the Switch auxiliary: ~1 at balance


def test_moe_topk_groups_and_capacity():
    """Group count by divisor search; with top-1 routing of 8 tokens
    over 3 experts at capacity 2 (6 slots), the tokens past their
    expert's first 2 are dropped (zero output row) and the rest kept."""
    assert port._moe_groups(32, 8) == 4
    assert port._moe_groups(31, 8) == 1        # prime: no divisor in range
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((1, 8, 4)).astype(np.float32))
    wg = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((3, 4, 6)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((3, 6, 4)).astype(np.float32))
    out, aux = port._route_group_topk(x.reshape(1, 8, 4), wg, w1, w2, 1, 2)
    sel = torch.softmax(x[0] @ wg, -1).argmax(-1)
    kept = torch.zeros(8, dtype=torch.bool)
    for e in range(3):
        idx = (sel == e).nonzero().flatten()[:2]   # first 2 per expert
        kept[idx] = True
    assert bool((out[0][~kept] == 0).all())
    assert bool((out[0][kept].abs().sum(-1) > 0).all())
    assert aux.shape == (1,)


def test_moe_topk_loss_grads_match_jax(monkeypatch):
    monkeypatch.setenv("MXNET_FLASH_ATTENTION", "0")
    jparams, arrays, jcfg, cfg = _both(_MOE_TOPK, seed=2)
    toks = _tokens(seed=9)
    jloss, jgrads = jax.value_and_grad(ref.lm_loss)(
        jparams, jnp.asarray(toks), jcfg, mesh=None)
    params = params_from_numpy(arrays, cfg, "cpu")
    loss, grads = port.lm_loss_and_grads(
        params, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-5)
    _close_dicts(grads, jgrads, rtol=1e-4, atol=1e-5)
    # the same loss through the public entry
    with torch.no_grad():
        again = lm_loss(params, torch.from_numpy(toks).long(), cfg)
    assert float(again) == pytest.approx(float(loss), abs=1e-6)


def test_engine_dense_dispatch_moe_paged_matches_gather():
    """A dense-dispatch MoE config served on the CPU: the paged path's
    logits equal the gather path's at every step, tokens identical, and
    the first token's logits equal transformer_apply's."""
    _, arrays, _, cfg = _both(_MOE_DENSE, seed=3)
    params = params_from_numpy(arrays, cfg, "cpu")
    prompt = [int(t) for t in _tokens(seed=10, shape=(11,))]

    def run(paged):
        eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=2,
                             block_size=8, keep_logits=True, paged=paged,
                             prefill_chunk=8, device="cpu")
        seq = eng.start(list(prompt), max_new=6)
        while not seq.done:
            eng.decode_step([seq])
        eng.release(seq)
        eng.close()
        return seq.tokens, np.stack(seq.token_logits)

    gt, gl = run(False)
    pt, pl = run(True)
    assert pt == gt
    np.testing.assert_allclose(pl, gl, rtol=1e-4, atol=1e-5)
    full = transformer_apply(params, torch.tensor([prompt]), cfg)[0, -1]
    np.testing.assert_allclose(gl[0], full.numpy(), rtol=1e-5, atol=1e-5)


def test_serving_refuses_topk_moe():
    _, arrays, _, cfg = _both(_MOE_TOPK)
    params = params_from_numpy(arrays, cfg, "cpu")
    with pytest.raises(MXNetError, match="top-k MoE"):
        serving.TransformerLM(params, cfg)
