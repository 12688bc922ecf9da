"""Port parity for the compile watchdog (mxnet_tpu_torch/telemetry/
introspect.py) against the JAX reference, on the CPU.

Mirrors the backend-free cases of tests/test_introspect.py: attribution
by argument and axis (a decode bucket crossing included), duplicates on
an engine restart, one first run under racing threads, counters per
engine over a shared or re-bound adapter, a failing compile region,
spans and flight events, the train.step and predict.export sites, the
MXNET_TELEMETRY=0 kill switch and the two budgets. `diff_reason`, the
budget parsers and the HLO comms reading give the reference's exact text
and errors on the same inputs. The HBM gate needs a device reading, which
the CPU has not: its cases stand a fixed footprint in for the card's
(`_fake_memory`), and hold that a refused TrainStep writes nothing and a
refused serving step fails its batch with the pool whole. The comms
ledger runs a 2-rank gloo ZeRO-1 TrainStep: reduce-scatter and
all-gather each read the parameter bytes, the reference's analytic pin.
Jax and the reference are imported inside the tests: the gloo ranks
import this module.
"""
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import serving, telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.telemetry import introspect

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _fresh_watchdog():
    introspect.reset()
    telemetry.default_registry().reset()
    telemetry.tracing.clear()
    telemetry.flight().clear()
    with tmx.cpu():
        yield
    introspect.reset()
    telemetry.default_registry().reset()
    telemetry.tracing.clear()
    telemetry.flight().clear()


def tiny_lm():
    from mxnet_tpu_torch.models.transformer import (TransformerConfig,
                                                     init_transformer_params)
    cfg = TransformerConfig(vocab=48, d_model=32, n_heads=4, n_layers=2,
                            d_ff=64, max_len=64)
    params = init_transformer_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    return params, cfg


def arith_prompt(seed, lo, n):
    rng = np.random.RandomState(seed)
    return [int(t) for t in rng.randint(lo, 40, n)]


# ---------------------------------------------------------------------------
# text parity with the reference
# ---------------------------------------------------------------------------

SIG_CASES = [
    ((), (((4, 8), "float32", "cpu"),)),
    ((((4, 8), "float32", "cpu"),), (((4, 16), "float32", "cpu"),)),
    ((((4, 8), "float32", "cpu"), ((8, 2), "float32", "cpu")),
     (((4, 16), "float32", "cpu"), ((16, 2), "float32", "cpu"))),
    ((((4,), "float32", "cpu"),), (((4,), "bfloat16", "cpu"),)),
    ((((4,), "float32", "cpu"),), (((4,), "float32", "cuda:0"),)),
    ((((4,), "float32", "cpu"),), (((4, 1), "float32", "cpu"),)),
    ((("static", "bool", "True"),), (("static", "bool", "False"),)),
    ((((2,), "int64", "cpu"), ((3,), "int64", "cpu")),
     (((2,), "int64", "cpu"), ((4,), "int64", "cpu"))),
]


@pytest.mark.parametrize("case", range(len(SIG_CASES) + 2))
def test_diff_reason_text_matches_reference(case):
    from mxnet_tpu.telemetry import introspect as ref
    if case < len(SIG_CASES):
        old, new = SIG_CASES[case]
        cached = [tuple((leaf,) for leaf in old)] if old else []
        new_sig = tuple((leaf,) for leaf in new)
        if case == 7:      # one argument of two leaves
            cached = [(old,)]
            new_sig = (new,)
    elif case == len(SIG_CASES):
        cached = [((((4,), "float32", "cpu"),),)]
        new_sig = ((((4,), "float32", "cpu"),), (((1,), "int32", "cpu"),))
    else:
        s = (((2, 2), "float32", "cpu"),)
        cached = [(s, s)]
        new_sig = (s, s)
    for names in (None, ("lhs", "rhs")):
        assert introspect.diff_reason(names, cached, new_sig) == \
            ref.diff_reason(names, cached, new_sig)


@pytest.mark.parametrize("var,value", [
    ("MXNET_COMPILE_BUDGET", "3"), ("MXNET_COMPILE_BUDGET", "3:raise"),
    ("MXNET_COMPILE_BUDGET", "3:bogus"), ("MXNET_COMPILE_BUDGET", "x:warn"),
    ("MXNET_COMPILE_BUDGET", ""), ("MXNET_HBM_BUDGET_GB", "0.5"),
    ("MXNET_HBM_BUDGET_GB", "2:warn"), ("MXNET_HBM_BUDGET_GB", "big"),
    ("MXNET_HBM_BUDGET_GB", "1:nope")])
def test_budget_parsers_match_reference(monkeypatch, var, value):
    from mxnet_tpu.telemetry import introspect as ref
    monkeypatch.setenv(var, value)
    fn = "compile_budget" if var == "MXNET_COMPILE_BUDGET" \
        else "hbm_budget_bytes"
    outs = []
    for mod in (introspect, ref):
        try:
            outs.append(("ok", getattr(mod, fn)()))
        except Exception as e:             # both packages' MXNetError
            outs.append(("err", type(e).__name__, str(e)))
    assert outs[0] == outs[1]


def test_comms_from_hlo_matches_reference():
    from mxnet_tpu.telemetry import introspect as ref
    hlo = """
  %rs = f32[256]{0} reduce-scatter(f32[1024]{0} %g), dimensions={0}
  %ag = f32[1024]{0} all-gather(f32[256]{0} %w), dimensions={0}
  %ar = bf16[8,4]{1,0} all-reduce(bf16[8,4]{1,0} %x), to_apply=%sum
  %s = (f32[16]{0}, f32[64]{0}) all-gather-start(f32[16]{0} %y)
  %d = f32[64]{0} all-gather-done((f32[16]{0}, f32[64]{0}) %s)
  %cp = s32[2,2]{1,0} collective-permute(s32[2,2]{1,0} %z)
"""
    assert introspect.comms_from_hlo(hlo) == ref.comms_from_hlo(hlo)
    assert introspect.comms_from_hlo(hlo)["reduce_scatter"] == \
        {"bytes": 4096, "ops": 1}
    assert introspect.comms_ledger(hlo)["total_bytes"] == \
        sum(k["bytes"] for k in ref.comms_from_hlo(hlo).values())


# ---------------------------------------------------------------------------
# attribution
# ---------------------------------------------------------------------------


def test_attribution_names_argument_and_axis():
    f = introspect.instrument(lambda a, b: a @ b, site="probe.mm",
                              argnames=("lhs", "rhs"))
    f(torch.ones(4, 8), torch.ones(8, 2))
    f(torch.ones(4, 16), torch.ones(16, 2))
    evs = introspect.compile_events("probe.mm")
    assert len(evs) == 2
    assert evs[0]["reason"] == ("first compilation at this site (timed "
                                "with first execution)")
    assert "lhs: shape (4, 8) -> (4, 16) (axis 1)" in evs[1]["reason"]
    assert "rhs: shape (8, 2) -> (16, 2) (axis 0)" in evs[1]["reason"]
    f(torch.ones(4, 16), torch.ones(16, 2))
    assert len(introspect.compile_events("probe.mm")) == 2
    assert f.compiles == 2 and f._cache_size() == 2


def test_attribution_dtype_and_static():
    f = introspect.instrument(lambda a, flag: a * (2 if flag else 3),
                              site="probe.static", argnames=("a", "flag"))
    f(torch.ones(4), True)
    f(torch.ones(4, dtype=torch.bfloat16), True)
    f(torch.ones(4, dtype=torch.bfloat16), False)
    evs = introspect.compile_events("probe.static")
    assert "a: dtype float32 -> bfloat16" in evs[1]["reason"]
    assert "flag: static True -> False" in evs[2]["reason"]


def test_ndarray_and_tensor_share_a_signature():
    f = introspect.instrument(lambda a: a * 2, site="probe.mix",
                              argnames=("a",))
    x = torch.ones(4, 4)
    f(x)
    f(tmx.nd.array(np.ones((4, 4), np.float32)))
    assert f.compiles == 1
    assert introspect.signature((x, 3)) == (
        (((4, 4), "float32", "cpu"),), (("static", "int", "3"),))


def test_decode_bucket_change_attributed(monkeypatch):
    """The acceptance case: the decode batch crossing a bucket (1 -> 2
    live sequences) emits an event naming the changed argument and axis.
    The engine is driven directly (the reference's test staggers two
    client threads, whose overlap a loaded host can lose)."""
    monkeypatch.delenv("MXNET_PAGED_ATTENTION", raising=False)
    params, cfg = tiny_lm()
    eng = serving.Engine(serving.TransformerLM(params, cfg), max_batch=4,
                         block_size=8, device="cpu")
    first = eng.start(arith_prompt(0, 1, 5), max_new=8)
    eng.decode_step([first])
    second = eng.start(arith_prompt(1, 1, 9), max_new=8)
    while not (first.done and second.done):
        eng.decode_step([first, second])
    evs = introspect.compile_events("serving.decode")
    assert evs and evs[0]["reason"].startswith(
        "first compilation at this site")
    bucket = [e for e in evs[1:]
              if "tokens" in e["reason"] and "axis 0" in e["reason"]]
    assert bucket, [e["reason"] for e in evs]
    assert "tokens: shape (1,) -> (2,) (axis 0)" in bucket[0]["reason"]
    assert all(e["phase"] == "decode" for e in evs)
    assert eng.decode_compilations == len(evs)


@pytest.mark.parametrize("paged", [False, True])
def test_engine_restart_attributed_as_duplicate(monkeypatch, paged):
    params, cfg = tiny_lm()
    prompt = arith_prompt(0, 1, 5)
    for _ in range(2):
        srv = serving.serve((params, cfg), max_batch=2, block_size=8,
                            device="cpu", paged=paged)
        try:
            assert len(srv.generate(prompt, max_new_tokens=4,
                                    timeout=120)) == 4
            assert srv.engine.decode_compilations >= 1
            assert srv.engine.prefill_compilations >= 1
        finally:
            srv.close()
    evs = introspect.compile_events("serving.decode")
    first = [e for e in evs if not e["duplicate"]]
    dups = [e for e in evs if e["duplicate"]]
    assert first and dups, evs
    assert all("new instance" in e["reason"] for e in dups)
    assert introspect.watchdog().site("serving.decode").duplicates == \
        len(dups)


def test_concurrent_first_calls_compile_once():
    calls = []

    def fn(a):
        calls.append(1)
        time.sleep(0.05)
        return a @ a.T

    f = introspect.instrument(fn, site="probe.race")
    x = torch.ones(16, 16)
    threads = [threading.Thread(target=f, args=(x,)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert f.compiles == 1 and len(calls) == 8
    assert len(introspect.compile_events("probe.race")) == 1


def test_shared_transformer_adapter_rebind_counts_stay_per_engine():
    params, cfg = tiny_lm()
    adapter = serving.TransformerLM(params, cfg)
    e1 = serving.Engine(adapter, max_batch=2, block_size=8, device="cpu")
    seq = e1.start(arith_prompt(0, 1, 5), max_new=2)
    while not seq.done:
        e1.decode_step([seq])
    assert e1.prefill_compilations >= 1
    p1, d1 = e1.prefill_compilations, e1.decode_compilations
    e2 = serving.Engine(adapter, max_batch=2, block_size=8, device="cpu")
    assert e2.prefill_compilations == 0
    seq = e2.start(arith_prompt(0, 1, 5), max_new=2)
    while not seq.done:
        e2.decode_step([seq])
    assert e2.prefill_compilations >= 1
    assert (e1.prefill_compilations, e1.decode_compilations) == (p1, d1)


def test_dispatch_counts_stay_per_thread():
    """The per-thread seam under replica threads: a compile paid on one
    thread never shows in another's bracket."""
    f = introspect.instrument(lambda a: a + 1, site="probe.tls")
    seen = {}

    def worker(i):
        mark = introspect.dispatch_mark()
        f(torch.ones(i + 1))
        seen[i] = introspect.dispatch_compiles_since(mark)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    mark = introspect.dispatch_mark()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert seen == {0: 1, 1: 1, 2: 1, 3: 1}
    assert introspect.dispatch_compiles_since(mark) == 0


def test_compile_region_failure_not_recorded():
    with pytest.raises(RuntimeError, match="boom"):
        with introspect.compile_region("probe.fail"):
            raise RuntimeError("boom")
    assert introspect.compile_events("probe.fail") == []
    assert introspect.watchdog().site("probe.fail").compiles == 0


def test_warm_load_counts_apart_from_compiles():
    mark, wmark = introspect.dispatch_mark(), introspect.dispatch_warm_mark()
    introspect.record_warm_load("kernels.x", 0.01)
    with introspect.compile_region("kernels.y", phase="build"):
        pass
    assert introspect.dispatch_warm_loads_since(wmark) == 1
    assert introspect.dispatch_compiles_since(mark) == 1
    wd = introspect.watchdog()
    assert wd.site("kernels.x").cache_hits == 1
    assert wd.site("kernels.x").compiles == 0
    ev = introspect.compile_events("kernels.x")[0]
    assert ev["cache_hit"] and "AOT cache" in ev["reason"]
    reg = telemetry.default_registry()
    assert reg.counter("compile_cache_hits").value == 1


# ---------------------------------------------------------------------------
# metrics / spans / flight / kill switch
# ---------------------------------------------------------------------------


def test_compile_recorded_as_span_and_flight_event():
    f = introspect.instrument(lambda a: a + 1, site="probe.rec")
    f(torch.ones(4))
    spans = [s for s in telemetry.spans() if s["name"] == "compile"]
    assert spans and spans[0]["attrs"]["site"] == "probe.rec"
    assert spans[0]["cat"] == "compile"
    flight = [e for e in telemetry.flight().events()
              if e["name"] == "compile"]
    assert flight and flight[0]["site"] == "probe.rec"
    text = telemetry.default_registry().prometheus_text()
    assert "compile_seconds_bucket" in text
    assert "compile_probe_rec_total" in text
    # the CPU has no device reading: no memory gauges, no footprint
    assert "exec_probe_rec_hbm_bytes" not in text
    assert "hbm_bytes" not in introspect.compile_events("probe.rec")[0]


def test_train_step_site_records():
    from mxnet_tpu_torch.parallel import TrainStep
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    step = TrainStep(net, tmx.gluon.loss.L2Loss(), "sgd",
                     {"learning_rate": 0.1})
    float(step(tmx.nd.ones((4, 3)), tmx.nd.zeros((4, 2))))
    evs = introspect.compile_events("train.step")
    assert len(evs) == 1 and evs[0]["phase"] == "train"
    float(step(tmx.nd.ones((4, 3)), tmx.nd.zeros((4, 2))))
    assert len(introspect.compile_events("train.step")) == 1
    float(step(tmx.nd.ones((8, 3)), tmx.nd.zeros((8, 2))))
    evs = introspect.compile_events("train.step")
    assert len(evs) == 2
    assert "x: shape (4, 3) -> (8, 3) (axis 0)" in evs[1]["reason"]
    step.probe(tmx.nd.ones((4, 3)), tmx.nd.zeros((4, 2)), seed=3)
    step.probe(tmx.nd.ones((4, 3)), tmx.nd.zeros((4, 2)), seed=4)
    assert len(introspect.compile_events("train.probe")) == 1
    assert step.warm_loads == 0


def test_export_region_records(tmp_path):
    net = tmx.gluon.nn.Dense(4, in_units=8)
    net.initialize()
    net(tmx.nd.ones((1, 8)))
    path = str(tmp_path / "m.mxtpu")
    tmx.predict.export_model(net, [("data", (1, 8))], path)
    evs = introspect.compile_events("predict.export")
    assert len(evs) == 1
    assert evs[0]["phase"] == "export"
    assert evs[0]["reason"] == \
        "explicit compile region (path=%s)" % path


def test_telemetry_kill_switch_makes_recording_noop(monkeypatch):
    monkeypatch.setenv("MXNET_TELEMETRY", "0")
    f = introspect.instrument(lambda a: a * 2, site="probe.off")
    f(torch.ones(4))
    f(torch.ones(8))
    reg = telemetry.default_registry()
    assert "compile_total" not in reg.prometheus_text()
    assert telemetry.spans() == []
    assert telemetry.flight().events() == []
    assert f.compiles == 2 and f._cache_size() == 2
    assert len(introspect.compile_events("probe.off")) == 2
    monkeypatch.delenv("MXNET_TELEMETRY")
    f(torch.ones(16))
    assert "compile_total" in reg.prometheus_text()


# ---------------------------------------------------------------------------
# budgets
# ---------------------------------------------------------------------------


def test_compile_budget_warn_then_raise(monkeypatch):
    monkeypatch.setenv("MXNET_COMPILE_BUDGET", "1")
    f = introspect.instrument(lambda a: a + 1, site="probe.bud")
    f(torch.ones(2))
    with pytest.warns(RuntimeWarning, match="compile budget overrun"):
        f(torch.ones(3))
    reg = telemetry.default_registry()
    assert reg.counter("compile_budget_overruns_total").value >= 1
    monkeypatch.setenv("MXNET_COMPILE_BUDGET", "1:raise")
    with pytest.raises(introspect.CompileBudgetExceeded):
        f(torch.ones(4))
    f(torch.ones(3))            # a seen signature stays free


GB = 1024.0 ** 3


@pytest.fixture
def _fake_memory(monkeypatch):
    """A first run's measured footprint of 0.5 GB wherever one runs:
    what a card's reading gives, which the CPU has not."""
    def measure(self, out=None):
        self.memory = {"argument_bytes": 0, "output_bytes": 0,
                       "temp_bytes": int(0.25 * GB), "code_bytes": 0,
                       "alias_bytes": 0, "hbm_bytes": int(0.5 * GB)}
        self.seconds = time.perf_counter() - self.t0
        self.measured = True
    monkeypatch.setattr(introspect._Run, "measure", measure)


def test_hbm_budget_gate(monkeypatch, _fake_memory):
    monkeypatch.setenv("MXNET_HBM_BUDGET_GB", "0.25")
    calls = []

    def fn(a):
        calls.append(1)
        return a @ a.T

    f = introspect.instrument(fn, site="probe.hbm")
    with pytest.raises(introspect.HbmBudgetExceeded, match="probe.hbm"):
        f(torch.ones(8, 8))
    # a same-sig retry is refused WITHOUT running and without reading as
    # a duplicate ...
    with pytest.raises(introspect.HbmBudgetExceeded):
        f(torch.ones(8, 8))
    assert len(calls) == 1 and f.compiles == 1
    evs = introspect.compile_events("probe.hbm")
    assert len(evs) == 1 and not evs[0]["duplicate"]
    assert evs[0]["hbm_bytes"] == int(0.5 * GB)
    assert "exec_probe_hbm_hbm_bytes" in \
        telemetry.default_registry().prometheus_text()
    # ... and lifting the budget admits it with no new first run
    monkeypatch.setenv("MXNET_HBM_BUDGET_GB", "64")
    assert f(torch.ones(8, 8)).shape == (8, 8)
    assert f.compiles == 1 and len(calls) == 2
    monkeypatch.setenv("MXNET_HBM_BUDGET_GB", "0.25:warn")
    g = introspect.instrument(fn, site="probe.hbm2")
    with pytest.warns(RuntimeWarning, match="MXNET_HBM_BUDGET_GB"):
        assert g(torch.ones(8, 8)).shape == (8, 8)
    monkeypatch.setenv("MXNET_HBM_BUDGET_GB", "64")
    h = introspect.instrument(fn, site="probe.hbm3")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        h(torch.ones(4, 4))


def test_hbm_refused_train_step_writes_nothing(monkeypatch, _fake_memory):
    from mxnet_tpu_torch.parallel import TrainStep
    net = tmx.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    step = TrainStep(net, tmx.gluon.loss.L2Loss(), "sgd",
                     {"learning_rate": 0.1, "momentum": 0.9})
    x, y = tmx.nd.ones((4, 3)), tmx.nd.zeros((4, 2))
    before = {n: p.data().asnumpy().copy()
              for n, p in net.collect_params().items()}
    monkeypatch.setenv("MXNET_HBM_BUDGET_GB", "1e-9")
    with pytest.raises(introspect.HbmBudgetExceeded, match="train.step"):
        step(x, y)
    with pytest.raises(introspect.HbmBudgetExceeded):
        step(x, y)
    assert step.t == 0
    for n, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), before[n])
    assert all(float(s.abs().sum()) == 0.0
               for st in step._opt_state for s in st)
    monkeypatch.delenv("MXNET_HBM_BUDGET_GB")
    float(step(x, y))
    assert step.t == 1
    assert len(introspect.compile_events("train.step")) == 1
    assert any(np.abs(p.data().asnumpy() - before[n]).max() > 0
               for n, p in net.collect_params().items())


def test_hbm_refused_serving_step_fails_its_batch(monkeypatch,
                                                  _fake_memory):
    """A refused serving step fails its batch through the engine's fault
    path, and the pool's accounting stays whole."""
    params, cfg = tiny_lm()
    monkeypatch.setenv("MXNET_HBM_BUDGET_GB", "1e-9")
    srv = serving.serve((params, cfg), max_batch=2, block_size=8,
                        device="cpu")
    try:
        with pytest.raises(MXNetError, match="MXNET_HBM_BUDGET_GB"):
            srv.generate(arith_prompt(0, 1, 5), max_new_tokens=4,
                         timeout=120)
        pool = srv.engine.cache.pool
        deadline = time.time() + 30
        while pool.in_use and time.time() < deadline:
            time.sleep(0.01)
        assert pool.in_use == 0
        monkeypatch.delenv("MXNET_HBM_BUDGET_GB")
        assert len(srv.generate(arith_prompt(0, 1, 5), max_new_tokens=4,
                                timeout=120)) == 4
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# the comms ledger: a 2-rank gloo ZeRO-1 step
# ---------------------------------------------------------------------------


def rank_zero1():
    """On each rank: a {'dp': 2} sharded_update TrainStep's first step,
    and the watchdog's train.step ledger with the parameter bytes."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import TrainStep, build_mesh
    from mxnet_tpu_torch.telemetry import introspect as wd
    with mx.cpu():
        mesh = build_mesh({"dp": 2}).to("cpu")
        with mx.name.NameManager():
            net = mx.gluon.nn.HybridSequential(prefix="z_")
            with net.name_scope():
                net.add(mx.gluon.nn.Dense(8, activation="relu"))
                net.add(mx.gluon.nn.Dense(4))
        net.initialize(mx.init.Xavier())
        net(mx.nd.zeros((1, 6)))
        step = TrainStep(net, mx.gluon.loss.L2Loss(), "sgd",
                         {"learning_rate": 0.1}, mesh=mesh,
                         sharded_update=True)
        x = mx.nd.array(np.ones((4, 6), np.float32))
        y = mx.nd.array(np.zeros((4, 4), np.float32))
        float(step(x, y))
        float(step(x, y))
        pbytes = sum(p.data()._data.numel() * 4
                     for p in net.collect_params().values())
        text = mx.telemetry.default_registry().prometheus_text()
        return {"ledger": wd.site_comms("train.step"), "param_bytes": pbytes,
                "gauge": "comms_train_step_reduce_scatter_bytes" in text,
                "events": len(wd.compile_events("train.step"))}


def test_comms_ledger_zero1_reads_param_bytes():
    from mxnet_tpu_torch.parallel.launch import run_world
    outs = run_world("test_torch_introspect:rank_zero1", 2, device="cpu",
                     paths=[HERE], timeout=300)
    for out in outs:
        kinds = out["ledger"]["kinds"]
        # every parameter's first axis splits over 2 ranks here, so the
        # whole gradient is reduce-scattered and the whole weight gathered
        assert kinds["reduce_scatter"]["bytes"] == out["param_bytes"]
        assert kinds["all_gather"]["bytes"] == out["param_bytes"]
        assert kinds["reduce_scatter"]["ops"] == \
            kinds["all_gather"]["ops"] == 4
        assert out["gauge"] and out["events"] == 1
