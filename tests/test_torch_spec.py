"""Port parity for speculative decoding (mxnet_tpu_torch/serving/spec.py
and the Engine's spec path) against the JAX reference, on the CPU.

The reference's weights cross over as numpy arrays. Tolerances:
- `greedy_verify`, `rejection_sample`: identical outputs on the same
  inputs (host code, float64).
- the draft's logits against the reference DraftLM: rtol 1e-4 / atol
  1e-5 (the engine-parity tolerance of tests/test_torch_serving.py).
- spec-on against spec-off (float32 pool): identical tokens and the
  per-emitted-token logits at rtol 1e-4 / atol 1e-5, as the reference's
  own test_spec_greedy_parity_f32; over the int8 pool identical tokens
  (the k+1 pass also writes rejected drafts' rows, which may raise a
  block's monotonic scale, so logits are not bit-equal there).
- the port's spec engine against the reference's: identical tokens.
"""
import numpy as np
import pytest
import torch

import jax

from mxnet_tpu import serving as jserving
from mxnet_tpu.models import transformer as jtf
from mxnet_tpu.serving import spec as jspec
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models import TransformerConfig, params_from_numpy
from mxnet_tpu_torch.serving import spec

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_TINY = dict(vocab=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=64)


@pytest.fixture(scope="module")
def lm():
    jcfg = jtf.TransformerConfig(**_TINY)
    jparams = jtf.init_transformer_params(jax.random.PRNGKey(0), jcfg)
    cfg = TransformerConfig(**_TINY)
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jparams.items()}, cfg, "cpu")
    return jparams, jcfg, params, cfg


def arith_prompt(start, stride, n, vocab=48):
    return [(start + stride * t) % vocab for t in range(n)]


PROMPTS = [arith_prompt(1, 1, 9), arith_prompt(5, 2, 4),
           arith_prompt(7, 3, 13)]


def make_engine(params, cfg, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("block_size", 8)
    kw.setdefault("keep_logits", True)
    kw.setdefault("paged", True)
    return serving.Engine(serving.TransformerLM(dict(params), cfg),
                          device="cpu", **kw)


def spec_engine(params, cfg, draft_layers=1, spec_k=3, **kw):
    return make_engine(params, cfg, spec_k=spec_k,
                       draft=spec.self_draft(params, cfg, draft_layers),
                       **kw)


def drive(eng, prompts, max_new=16):
    seqs = [eng.start(list(p), max_new=max_new) for p in prompts]
    live = [s for s in seqs if not s.done]
    while live:
        eng.decode_step(live)
        live = [s for s in live if not s.done]
    toks = [list(s.tokens) for s in seqs]
    logs = [[np.asarray(r) for r in s.token_logits] for s in seqs]
    for s in seqs:
        eng.release(s)
    return toks, logs


# ---------------------------------------------------------------------------
# verification rules: the same host code on the same inputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argmax,draft,n", [
    ([5, 6, 7], [5, 6], 2), ([5, 6, 7], [5, 9], 2), ([5, 6, 7], [9, 6], 2),
    ([5], [], 0), ([1, 2, 3, 4], [1, 2, 3], 3), ([1, 2, 3, 4], [1, 2, 0], 2),
])
def test_greedy_verify_matches_jax(argmax, draft, n):
    got = spec.greedy_verify(argmax, draft, n)
    assert got == jspec.greedy_verify(argmax, draft, n)
    emitted, acc = got
    assert 1 <= len(emitted) == acc + 1 <= n + 1


@pytest.mark.parametrize("seed", range(6))
def test_rejection_sample_matches_jax(seed):
    rng = np.random.RandomState(seed)
    k, V = 3, 6
    p = rng.dirichlet(np.ones(V), size=k + 1)
    q = rng.dirichlet(np.ones(V), size=k)
    if seed == 0:
        q[0, 2] = 0.0                 # q(d) = 0: accept unconditionally
    if seed == 1:
        q[1] = p[1]                   # p == q: empty residual
    d = [int(rng.randint(V)) for _ in range(k)]
    u = list(rng.uniform(size=k))
    if seed == 1:
        u[1] = 1.0
    r = float(rng.uniform())
    assert spec.rejection_sample(p, q, d, u, r) == \
        jspec.rejection_sample(p, q, d, u, r)


def test_rejection_sample_pinned_hand_computed():
    """The reference's hand-computed cases: a full sweep with the bonus
    drawn from p_k, a rejection resampled from the residual."""
    p = np.array([[0.1, 0.2, 0.5, 0.2], [0.2, 0.4, 0.2, 0.2],
                  [0.1, 0.2, 0.3, 0.4]])
    q = np.array([[0.25, 0.25, 0.25, 0.25], [0.2, 0.4, 0.2, 0.2]])
    assert spec.rejection_sample(p, q, [2, 1], [0.9, 0.999], 0.55) == \
        ([2, 1, 2], 2)
    p = np.array([[0.1, 0.1, 0.2, 0.6], [0.25, 0.25, 0.25, 0.25]])
    q = np.array([[0.4, 0.3, 0.2, 0.1]])
    assert spec.rejection_sample(p, q, [0], [0.5], 0.7) == ([3], 0)


# ---------------------------------------------------------------------------
# the draft
# ---------------------------------------------------------------------------


def test_self_draft_and_draft_logits_match_jax(lm):
    jparams, jcfg, params, cfg = lm
    dparams, dcfg = spec.self_draft(params, cfg, 1)
    jdparams, jdcfg = jspec.self_draft(jparams, jcfg, 1)
    assert set(dparams) == set(jdparams) and dcfg.n_layers == 1
    assert "layer1_wqkv" not in dparams and "head" in dparams
    toks = np.zeros((2, 16), np.int32)
    toks[0, :9] = PROMPTS[0]
    toks[1, :13] = PROMPTS[2]
    lens = np.array([9, 13], np.int32)
    want = jspec.DraftLM(jdparams, jdcfg).logits_at(jax.numpy.asarray(toks),
                                                    jax.numpy.asarray(lens))
    got = spec.DraftLM(dparams, dcfg).logits_at(
        torch.from_numpy(toks.astype(np.int64)), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(MXNetError, match="n_layers"):
        spec.self_draft(params, cfg, 3)


# ---------------------------------------------------------------------------
# parity: spec-on == spec-off, and == the reference's spec engine
# ---------------------------------------------------------------------------


def test_spec_greedy_parity_f32(lm):
    _, _, params, cfg = lm
    t_ref, l_ref = drive(make_engine(params, cfg), PROMPTS)
    eng = spec_engine(params, cfg)
    assert eng.spec and eng.spec_fallback is None
    assert eng.decode_tokens_per_step() == 4
    t_spec, l_spec = drive(eng, PROMPTS)
    assert t_spec == t_ref
    for ref_rows, spec_rows in zip(l_ref, l_spec):
        assert len(ref_rows) == len(spec_rows)
        for a, b in zip(ref_rows, spec_rows):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
    assert eng.spec_passes >= 1
    assert eng.spec_proposed_tokens >= eng.spec_passes
    total_gen = sum(len(t) for t in t_spec) - sum(len(p) for p in PROMPTS)
    assert total_gen > eng.spec_passes + len(PROMPTS)   # multi-token passes
    assert any(kind == "spec" for kind, _ in eng._sigs)
    eng.audit_quiescent()


def test_spec_over_int8_pool_token_identical(lm):
    """The reference's test_spec_decode_over_quant_pool_token_identical:
    speculation over the int8 pool emits the tokens of the same quantized
    engine without speculation, and accepts drafts."""
    _, _, params, cfg = lm
    t_ref, _ = drive(make_engine(params, cfg, kv_quant=True), PROMPTS)
    eng = spec_engine(params, cfg, draft_layers=2, kv_quant=True)
    assert eng.spec and eng.kv_quant
    t_spec, _ = drive(eng, PROMPTS)
    assert t_spec == t_ref
    assert eng.spec_accepted_tokens > 0


@pytest.mark.parametrize("quant", [{}, dict(kv_quant=True,
                                            weight_quant="int8")])
def test_spec_engine_matches_jax_spec_engine(lm, quant):
    """Same draft, same k, same pool precision: the port's speculating
    engine emits the reference's tokens and accepts the same drafts.
    With int8 weights the float draft disagrees with the quantized
    target now and then, so rejected rows raise block scales — in both
    frameworks alike."""
    jparams, jcfg, params, cfg = lm
    jeng = jserving.Engine(jserving.TransformerLM(dict(jparams), jcfg),
                           max_batch=4, block_size=8, keep_logits=True,
                           paged=True, spec_k=3,
                           draft=jspec.self_draft(jparams, jcfg, 1),
                           **quant)
    want, _ = drive(jeng, PROMPTS)
    jeng.close()
    eng = spec_engine(params, cfg, **quant)
    got, _ = drive(eng, PROMPTS)
    assert got == want
    assert (eng.spec_passes, eng.spec_accepted_tokens) == \
        (jeng.spec_passes, jeng.spec_accepted_tokens)


def test_spec_accounting_and_token_history(lm):
    _, _, params, cfg = lm
    k = 3
    eng = spec_engine(params, cfg, spec_k=k)
    s = eng.start(arith_prompt(4, 1, 7), max_new=14)
    emitted_total, passes = 0, 0
    while not s.done:
        eng.decode_step([s])
        ls = eng.last_spec
        assert ls is not None and not ls["fallback"]
        assert 1 <= ls["emitted"] <= ls["batch"] * (k + 1)
        assert ls["accepted"] <= ls["proposed"] <= ls["batch"] * k
        emitted_total += ls["emitted"]
        passes += 1
    assert len(s.tokens) == 7 + 1 + emitted_total
    assert eng.spec_passes == passes
    eng.release(s)
    eng.audit_quiescent()


def test_spec_respects_max_total_budget(lm):
    _, _, params, cfg = lm
    eng = spec_engine(params, cfg, spec_k=3)
    ref = make_engine(params, cfg)
    for max_new in (1, 2, 5):
        t_spec, _ = drive(eng, [arith_prompt(6, 1, 5)], max_new=max_new)
        t_ref, _ = drive(ref, [arith_prompt(6, 1, 5)], max_new=max_new)
        assert t_spec == t_ref
        assert len(t_spec[0]) == 5 + max_new
    eng.audit_quiescent()


def test_draft_fault_degrades_token_identical(lm, monkeypatch):
    """Non-finite draft logits: the batch runs the plain step, counted as
    a fallback, and the tokens stay the plain path's."""
    _, _, params, cfg = lm
    t_ref, _ = drive(make_engine(params, cfg), PROMPTS[:1], max_new=6)
    eng = spec_engine(params, cfg)
    real = eng.draft.logits_at
    monkeypatch.setattr(eng.draft, "logits_at",
                        lambda t, l: torch.full_like(real(t, l),
                                                     float("nan")))
    t_spec, _ = drive(eng, PROMPTS[:1], max_new=6)
    assert t_spec == t_ref
    # 4 faulted passes; the last step has no room for a proposal, so it
    # scores the target's own token without calling the draft
    assert eng.spec_fallbacks == 4 and eng.spec_passes == 1
    assert eng.spec_proposed_tokens == 0


# ---------------------------------------------------------------------------
# configuration: env flags, fallbacks, scheduler price, server metrics
# ---------------------------------------------------------------------------


def test_spec_env_enablement(lm, monkeypatch):
    _, _, params, cfg = lm
    monkeypatch.setenv("MXNET_SPEC_DECODE", "1")
    monkeypatch.setenv("MXNET_SPEC_K", "2")
    monkeypatch.setenv("MXNET_SPEC_DRAFT_LAYERS", "1")
    eng = make_engine(params, cfg)
    assert eng.spec and eng.spec_k == 2 and eng.draft.cfg.n_layers == 1
    monkeypatch.setenv("MXNET_QUANTIZED_WEIGHTS", "int8")
    eng = make_engine(params, cfg)
    # a weight-quantized target drafts from its float originals
    assert not isinstance(eng.draft.params["layer0_wqkv"], dict)
    assert isinstance(eng.model.params["layer0_wqkv"], dict)


def test_spec_fallback_reasons(lm):
    jparams, jcfg, params, cfg = lm
    e = make_engine(params, cfg, spec=True)
    assert not e.spec and "no draft" in e.spec_fallback
    e = spec_engine(params, cfg, paged=False)
    assert not e.spec and "paged" in e.spec_fallback
    other = TransformerConfig(**dict(_TINY, vocab=40))
    from mxnet_tpu_torch.models import init_transformer_params
    op = init_transformer_params(other, torch.Generator().manual_seed(0),
                                 device="cpu")
    e = make_engine(params, cfg, draft=(op, other))
    assert not e.spec and "vocab" in e.spec_fallback
    short = TransformerConfig(**dict(_TINY, max_len=32))
    sp = init_transformer_params(short, torch.Generator().manual_seed(0),
                                 device="cpu")
    e = make_engine(params, cfg, draft=(sp, short))
    assert not e.spec and "max_len" in e.spec_fallback
    with pytest.raises(MXNetError, match="spec_k"):
        spec_engine(params, cfg, spec_k=0)
    with pytest.raises(MXNetError, match="draft"):
        make_engine(params, cfg, draft=object())
    # the reference records the same configuration reasons
    j = jserving.Engine(jserving.TransformerLM(dict(jparams), jcfg),
                        max_batch=2, block_size=8, paged=True, spec=True)
    assert "no draft" in j.spec_fallback
    j.close()


def test_scheduler_prices_speculating_sequence_at_k_plus_1():
    class FakeEngine:
        def can_admit(self, plen, max_new):
            return True

        def prefill_tokens_per_step(self, plen):
            return 8

        def decode_tokens_per_step(self):
            return 4                              # k = 3

    sched = serving.Scheduler(max_batch=8, token_budget=16)
    for _ in range(3):
        sched.submit(serving.Request([1, 2, 3]))
    sched.running = [object(), object()]          # 2 x 4 scored tokens
    admitted, _ = sched.admit(FakeEngine())
    assert len(admitted) == 1                     # 8 + 8 = 16; +8 > 16
    assert sched.spent_tokens(FakeEngine()) == 8


def test_server_spec_metrics(lm):
    _, _, params, cfg = lm
    srv = serving.serve((params, cfg), max_batch=2, block_size=8,
                        paged=True, spec_k=3,
                        draft=spec.self_draft(params, cfg, 1), device="cpu")
    try:
        outs = [srv.generate(p, max_new_tokens=10, timeout=120)
                for p in PROMPTS[:2]]
        assert all(len(o) == 10 for o in outs)
        snap = srv.snapshot()
    finally:
        srv.close()
    sp = snap["spec"]
    assert sp["k"] == 3 and sp["passes"] > 0 and sp["fallbacks"] == 0
    assert 0 < sp["accepted_tokens"] <= sp["proposed_tokens"]
    assert sp["acceptance_rate"] == pytest.approx(
        sp["accepted_tokens"] / sp["proposed_tokens"])
    assert 1.0 <= sp["accepted_per_pass"] <= 4.0
    assert snap["engine"]["spec_decode"] is True
    # every generated token is counted, bursts included: prefill's first
    # token is not a decode token
    assert snap["throughput"]["tokens_generated"] == 2 * 9
    assert snap["paths"]["paged_decode_steps"] == sp["passes"]
