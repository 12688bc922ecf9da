"""Port parity for quantized serving (mxnet_tpu_torch/ops/quantization.py,
mxnet_tpu_torch/predict.py::quantize_lm_params, the Engine's kv_quant and
weight_quant) against the JAX reference, on the CPU.

Tolerances:
- `quantize_channelwise`, `dynamic_quant_matmul`, `quantize_lm_params`:
  EXACT. Both round half to even, divide in the same order and accumulate
  the int8 product exactly in int32 (127^2 * 2048 < 2^31).
- quantized engine logits against the JAX quantized engine (the Pallas
  kernel in interpreter mode): rtol 1e-4 / atol 1e-5, the engine-parity
  tolerance of tests/test_torch_serving.py; tokens identical.
- against the float engine: the reference's own budgets
  (tests/test_serving_quant.py:217-218), max |logit - f32| under 0.01 with
  int8 KV only, under 0.05 with int8 weights.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import predict as jpredict
from mxnet_tpu import serving as jserving
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.ops import quantization as jq
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
from mxnet_tpu_torch.ops import quantization as q
from mxnet_tpu_torch.predict import quantize_lm_params

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TINY = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64)
KV_LOGIT_BUDGET = 0.01
WEIGHT_LOGIT_BUDGET = 0.05


@pytest.fixture(scope="module")
def lm():
    jcfg = jtf.TransformerConfig(**_TINY)
    jparams = jtf.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    cfg = TransformerConfig(**_TINY)
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jparams.items()}, cfg, "cpu")
    return jparams, jcfg, params, cfg


def _prompt(n=20, vocab=48, seed=0):
    return [int(t) for t in np.random.RandomState(seed).randint(1, vocab,
                                                                  size=n)]


@pytest.mark.parametrize("shape,axis", [((32, 96), 1), ((32, 96), 0),
                                        ((3, 8, 5), -1), ((7,), 0)])
def test_quantize_channelwise_exact(shape, axis):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    w[0] *= 50.0                                   # an outlier row
    jqv, js = jq.quantize_channelwise(jnp.asarray(w), axis=axis)
    tq, ts = q.quantize_channelwise(torch.from_numpy(w), axis=axis)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("xshape", [(5, 32), (2, 3, 32), (1, 32)])
def test_dynamic_quant_matmul_exact(xshape):
    rng = np.random.RandomState(1)
    x = rng.randn(*xshape).astype(np.float32)
    w = rng.randn(32, 24).astype(np.float32)
    wq, ws = jq.quantize_channelwise(jnp.asarray(w), axis=1)
    want = jq.dynamic_quant_matmul(jnp.asarray(x), wq, ws)
    got = q.dynamic_quant_matmul(torch.from_numpy(x),
                                 torch.from_numpy(np.asarray(wq)),
                                 torch.from_numpy(np.asarray(ws)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_maybe_quant_matmul_dispatch():
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(4, 16).astype(np.float32))
    w = torch.from_numpy(rng.randn(16, 8).astype(np.float32))
    torch.testing.assert_close(q.maybe_quant_matmul(x, w), x @ w,
                               rtol=0, atol=0)
    wq, ws = q.quantize_channelwise(w, axis=1)
    got = q.maybe_quant_matmul(x.bfloat16(), {"q": wq, "s": ws})
    assert got.dtype == torch.bfloat16           # cast back to x's dtype
    want = q.dynamic_quant_matmul(x.bfloat16(), wq, ws).bfloat16()
    assert torch.equal(got, want)


def test_int8_matmul_raises_on_a_device_without_one():
    x = torch.zeros(2, 16, device="meta")
    w = torch.zeros(16, 8, dtype=torch.int8, device="meta")
    with pytest.raises(MXNetError, match="no int8 matmul for device meta"):
        q.dynamic_quant_matmul(x, w, torch.ones(8, device="meta"))


def test_quantize_lm_params_exact(lm):
    jparams, jcfg, params, cfg = lm
    want = jpredict.quantize_lm_params(jparams, jcfg.n_layers)
    got = quantize_lm_params(params, cfg.n_layers)
    assert set(got) == set(want)
    for name, w in want.items():
        if isinstance(w, dict):
            assert isinstance(got[name], dict), name
            np.testing.assert_array_equal(got[name]["q"].numpy(),
                                          np.asarray(w["q"]))
            np.testing.assert_array_equal(got[name]["s"].numpy(),
                                          np.asarray(w["s"]))
        else:
            assert got[name] is params[name], name   # float, untouched
    assert not isinstance(got["head"], dict)
    with pytest.raises(MXNetError, match="int4"):
        quantize_lm_params(params, cfg.n_layers, mode="int4")


def test_quantize_lm_params_leaves_moe_experts_float():
    cfg = TransformerConfig(**dict(_TINY, n_experts=2))
    from mxnet_tpu_torch.models import init_transformer_params
    params = init_transformer_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    out = quantize_lm_params(params, cfg.n_layers)
    assert isinstance(out["layer0_wqkv"], dict)
    assert out["layer0_w1"] is params["layer0_w1"]        # 3-D stack


def _rollout(eng, prompt, max_new=8):
    seq = eng.start(list(prompt), max_new)
    while not seq.done:
        eng.decode_step([seq])
    out = list(seq.tokens), [np.asarray(x, np.float32)
                             for x in seq.token_logits]
    eng.release(seq)
    eng.close()
    return out


def _max_err(a, b):
    return max(float(np.max(np.abs(x - y))) for x, y in zip(a, b))


_ENG = dict(max_batch=2, block_size=16, keep_logits=True, paged=True)


@pytest.fixture(scope="module")
def jax_quant_runs(lm):
    jparams, jcfg, _, _ = lm
    out = {}
    for key, kw in _MODES.items():
        eng = jserving.Engine(jserving.TransformerLM(dict(jparams), jcfg),
                              **_ENG, **kw)
        out[key] = _rollout(eng, _prompt())
    return out


_MODES = {"kv": dict(kv_quant=True),
          "w": dict(weight_quant="int8"),
          "kv+w": dict(kv_quant=True, weight_quant="int8")}


@pytest.mark.parametrize("mode", ["kv", "w", "kv+w"])
def test_quant_engine_matches_jax_and_budget(lm, jax_quant_runs, mode):
    _, _, params, cfg = lm
    eng = serving.Engine(serving.TransformerLM(dict(params), cfg),
                         device="cpu", **_ENG, **_MODES[mode])
    assert eng.kv_quant is ("kv" in mode)
    assert eng.weight_quant == ("int8" if "w" in mode else None)
    if eng.kv_quant:
        assert eng.cache.k.dtype == torch.int8
        assert eng.cache.k_scale.shape == (cfg.n_layers,
                                           eng.cache.num_blocks,
                                           cfg.n_heads)
    toks, logits = _rollout(eng, _prompt())
    want_toks, want_logits = jax_quant_runs[mode]
    assert toks == want_toks
    for step, (a, b) in enumerate(zip(logits, want_logits)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg="step %d" % step)
    f32_toks, f32_logits = _rollout(
        serving.Engine(serving.TransformerLM(dict(params), cfg),
                       device="cpu", **_ENG), _prompt())
    assert toks == f32_toks
    budget = WEIGHT_LOGIT_BUDGET if "w" in mode else KV_LOGIT_BUDGET
    assert _max_err(logits, f32_logits) < budget


def test_flags_off_is_the_float_stack(lm):
    _, _, params, cfg = lm
    eng = serving.Engine(serving.TransformerLM(dict(params), cfg),
                         device="cpu", **_ENG)
    assert not eng.kv_quant and eng.weight_quant is None
    assert not eng.cache.quantized and eng.cache.k_scale is None
    assert not any(isinstance(w, dict) for w in eng.model.params.values())
    met = serving.ServingMetrics()
    assert "quant" not in met.snapshot(eng, None)
    eng.close()


def test_weight_quant_keeps_float_originals_and_is_idempotent(lm):
    _, _, params, cfg = lm
    m = serving.TransformerLM(dict(params), cfg)
    m.quantize_weights("int8")
    assert m.params["layer0_wqkv"]["q"].dtype == torch.int8
    assert m.params["embed"].dtype == torch.float32
    assert m.params_f32["layer0_wqkv"] is params["layer0_wqkv"]
    before = m.params
    m.quantize_weights("int8")
    assert m.params is before
    with pytest.raises(MXNetError):
        serving.TransformerLM(dict(params), cfg).quantize_weights("int4")


def test_env_flags_enable_quant(lm, monkeypatch):
    monkeypatch.setenv("MXNET_QUANTIZED_KV", "1")
    monkeypatch.setenv("MXNET_QUANTIZED_WEIGHTS", "int8")
    _, _, params, cfg = lm
    eng = serving.Engine(serving.TransformerLM(dict(params), cfg),
                         max_batch=2, block_size=16, paged=True,
                         device="cpu")
    assert eng.kv_quant_requested and eng.kv_quant
    assert eng.weight_quant == "int8"
    eng.close()


def test_gather_path_falls_back_to_the_float_pool(lm):
    _, _, params, cfg = lm
    eng = serving.Engine(serving.TransformerLM(dict(params), cfg),
                         device="cpu", **dict(_ENG, paged=False),
                         kv_quant=True)
    assert not eng.kv_quant and eng.kv_quant_requested
    assert "paged" in eng.kv_quant_fallback
    assert not eng.cache.quantized
    toks, _ = _rollout(eng, _prompt())
    f32_toks, _ = _rollout(
        serving.Engine(serving.TransformerLM(dict(params), cfg),
                       device="cpu", **_ENG), _prompt())
    assert toks == f32_toks


def test_kv_bytes_per_token_matches_jax(lm):
    jparams, jcfg, params, cfg = lm
    for kw in ({}, dict(kv_quant=True)):
        mine = serving.Engine(serving.TransformerLM(dict(params), cfg),
                              device="cpu", **_ENG, **kw)
        ref = jserving.Engine(jserving.TransformerLM(dict(jparams), jcfg),
                              **_ENG, **kw)
        assert mine.kv_bytes_per_token() == ref.kv_bytes_per_token()
        mine.close()
        ref.close()
    nl, nh, dh = cfg.n_layers, cfg.n_heads, cfg.d_model // cfg.n_heads
    assert mine.kv_bytes_per_token() == \
        2 * nl * nh * dh + math.ceil(2 * nl * nh * 4 / 16.0)


def test_reused_block_requantizes_from_zero(lm):
    """A block a finished request leaves behind comes back with its
    scales zeroed, so the next occupant's logits equal a fresh engine's."""
    _, _, params, cfg = lm
    eng = serving.Engine(serving.TransformerLM(dict(params), cfg),
                         device="cpu", **_ENG, kv_quant=True)
    first = eng.start(_prompt(20, seed=3), 8)
    while not first.done:
        eng.decode_step([first])
    eng.release(first)
    toks, logits = _rollout(eng, _prompt())
    fresh_toks, fresh_logits = _rollout(
        serving.Engine(serving.TransformerLM(dict(params), cfg),
                       device="cpu", **_ENG, kv_quant=True), _prompt())
    assert toks == fresh_toks
    assert _max_err(logits, fresh_logits) == 0.0


def test_serve_passthrough_and_quant_gauges(lm):
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=2, block_size=16,
                        paged=True, kv_quant=True, weight_quant="int8",
                        device="cpu")
    try:
        assert srv.engine.kv_quant and srv.engine.weight_quant == "int8"
        out = srv.generate(_prompt(), max_new_tokens=4, timeout=120)
        assert len(out) == 4
        quant = srv.snapshot()["quant"]
        assert quant["serving_kv_quant_enabled"] == 1
        assert quant["serving_weight_quant_enabled"] == 1
        assert quant["serving_kv_quant_bytes_per_token"] == \
            srv.engine.kv_bytes_per_token()
    finally:
        srv.close()
