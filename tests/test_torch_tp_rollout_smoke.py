"""chip_smoke.py's phase 26 (live rollout and tensor-parallel serving)
rehearsed on the CPU at a tiny size: the phase's own code end to end, the
card's K1 replaced by its plain version behind a counting wrapper and the
emulated windows `["cpu"] * k`. 26a's rollout runs on the wall clock with
the phase's own windows and faults; 26b's int8 bound is twice the JAX
reference's own int8 tp=2 vs tp=1 error at this tiny width, measured
here by tools/quant_logit_probe.py's reference mode on the same weights
and prompt.
"""
import functools
import importlib.util
import os
import threading

import numpy as np
import torch

import chip_smoke as cs
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.serving import engine as eng_mod

TINY = dict(vocab=512, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_len=256)
#: ROLL_TTFT_FACTOR: the CPU's first tokens wait on the interpreter
#: lock, not on a card, and spread wider than the card's
SIZES = dict(PROMPT_LEN=16, GEN=12, ROLL_PROMPT=(8, 32), ROLL_GEN=(4, 16),
             ROLL_REQUESTS=12, ROLL_PINNED_GEN=6, TP_PROMPTS=4, TP_STEPS=8,
             ROLL_TTFT_FACTOR=12.0)


def reference_tp_quant_err():
    """The reference's int8 tp=2 vs int8 tp=1 error at TINY, through the
    probe tool with its config set to the rehearsal's."""
    path = os.path.join(os.path.dirname(cs.__file__), "tools",
                        "quant_logit_probe.py")
    spec = importlib.util.spec_from_file_location("quant_logit_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    probe.CFG, probe.PROMPT_LEN, probe.GEN = (TINY, SIZES["PROMPT_LEN"],
                                              SIZES["GEN"])
    err, rows, _ = probe.run_reference(tp=2)
    assert rows == SIZES["GEN"] and err > 0
    return err


def test_chip_smoke_phase_26_rehearses_on_the_cpu(monkeypatch, capsys):
    ref_err = reference_tp_quant_err()
    monkeypatch.setattr(cs, "BENCH_CFG", TINY)
    for name, value in SIZES.items():
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "REF_TP_QUANT_LOGIT_ERR", ref_err)
    monkeypatch.setattr(cs, "TP_QUANT_BOUND", 2 * ref_err)
    plain = pa.paged_attention
    lock = threading.Lock()

    @functools.wraps(plain)
    def counting(q, *args, **kwargs):
        out = plain(q, *args, **kwargs)
        with lock:                    # replica and watcher threads at once
            if kwargs.get("k_scale") is not None:
                counting.launches_int8 += 1
            else:
                counting.launches += 1
        return out

    counting.launches = counting.launches_int8 = 0
    monkeypatch.setattr(pa, "paged_attention", counting)
    monkeypatch.setattr(eng_mod, "paged_attention", counting)
    launches, int8, out = cs.phase_tp_rollout(torch, np, torch.device("cpu"),
                                              "cpu rehearsal")
    a, b, c = out["26a"], out["26b"], out["26c"]
    assert a["canaries"] == [1, 3, 4] and a["requests_lost_or_failed"] == 0
    assert {k: r["probe"] for k, r in a["rejections"].items()} == {
        "2": "digest", "3": "judge", "5": "divergence"}
    assert [g[0] for g in a["gate_ms"]] == [1, 3, 4, 5]
    for k in cs.TP_DEGREES:
        assert b["tp%d" % k]["rows_compared"] > 0
        assert b["tp%d" % k]["tp_cache_variant"] == "tp%d@%s" % (
            k, ",".join(["cpu"] * k))
    assert b["int8_tp2"]["max_abs_err_vs_int8_tp1"] <= 2 * ref_err
    assert b["fallback"] == {"tp": 1, "k1_launches": b["fallback"][
        "k1_launches"], "reason": "tp=2 needs 2 devices, have 0"}
    assert c["migrations"] == 4
    assert launches == sum(v for k, v in out["k1_launches"].items()
                           if k != "26b_int8") > 0
    assert int8 == b["int8_tp2"]["k1_int8_launches"] > 0
    printed = capsys.readouterr().out
    for line in ("rollout 26a (cpu rehearsal): ", "tp 26b (cpu rehearsal): ",
                 "tp hop 26c (cpu rehearsal): "):
        assert line in printed
