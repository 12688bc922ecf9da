"""chip_smoke.py's phase 23 (the multi-replica door on K1) rehearsed on the
CPU at a tiny size: the card's K1 replaced by its plain version behind a
counting wrapper, the engines' default device the CPU. Routing, the
chaos drill, prefill/decode roles and autoscale pass their own checks —
token identity against the gather oracle, availability, leak audits,
K1 launches against the replicas' steps and chunks — where the card and
the CPU are one device.
"""
import functools
import threading

import numpy as np
import torch

import chip_smoke as cs
from mxnet_tpu_torch import base
from mxnet_tpu_torch.ops import paged_attention as pa
from mxnet_tpu_torch.serving import engine as eng_mod

TINY = dict(vocab=512, d_model=64, n_heads=4, n_layers=2, d_ff=128,
            max_len=256)
SIZES = dict(FLEET_PROMPT=(8, 48), FLEET_GEN=(4, 40), DRILL_PROMPT=(8, 32),
             DRILL_GEN=(4, 24), DRILL_PIN_GEN=120, ROLES_SHARED=64,
             ROLES_SUFFIX=8, ROLES_PROMPT=(8, 32), ROLES_GEN=(4, 24),
             FLEET_BURST=40, DRILL_BEAT_AGE_S=2.0, DRILL_WEDGE_S=4.0)


def test_chip_smoke_phase_23_rehearses_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(cs, "BENCH_CFG", TINY)
    for name, value in SIZES.items():
        monkeypatch.setattr(cs, name, value)
    real = base.resolve_device
    monkeypatch.setattr(eng_mod, "resolve_device", lambda device=None: real(
        "cpu" if device is None else device))
    plain = pa.paged_attention
    lock = threading.Lock()

    @functools.wraps(plain)
    def counting(q, *args, **kwargs):
        out = plain(q, *args, **kwargs)
        with lock:                    # several replica threads at once
            counting.launches += 1
        return out

    counting.launches = 0
    monkeypatch.setattr(pa, "paged_attention", counting)
    monkeypatch.setattr(eng_mod, "paged_attention", counting)
    launches, out = cs.phase_fleet(torch, np, torch.device("cpu"), "cpu")
    assert launches == sum(out["kernel_launches"].values()) > 0
    assert out["drill"]["faults"] == ["wedge", "kill", "poison", "exhaust",
                                      "crash_loop"]
    assert out["drill"]["availability"] == 1.0
    assert out["roles"]["migrations"] == 12
    assert out["autoscale"]["decisions"] == [None, "up", None, None, "down"]
    assert "fleet path (phase 23): " in capsys.readouterr().out
