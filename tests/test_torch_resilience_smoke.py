"""chip_smoke.py phase 25 (training resilience) rehearsed on the CPU at a
tiny size: the phase's own code end to end. 25a in process (the
resumed run bit-identical to the straight one, K4a-b once a layer a
step), then the drills of `python -m mxnet_tpu_torch.tools.chaos_train`
on the CPU: 25b's faults, 25c's pod of 2 gloo ranks (dead, killed
mid-save and hung ranks, same-shape and elastic relaunches) and 25d's
supervised campaign. The word LM is cut to vocab 50, width 16, bptt 5,
batch 4. On the CPU the plain versions of K4a-b run; in process they are
wrapped to count as the card's launches do, and the drills' processes
count none, beside the count their steps and probes call for.
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mxnet_tpu_torch.ops import fused_rnn as fr
from mxnet_tpu_torch.tools.chaos_train import ELASTIC_RTOL

SIZES = {"LM_VOCAB": 50, "LM_EMBED": 16, "LM_HIDDEN": 16, "LM_BPTT": 5,
         "LM_BATCH": 4}


@pytest.fixture(scope="module")
def phase25():
    saved = {k: getattr(cs, k) for k in SIZES}
    kernels = {k.__name__: k for k in fr.KERNELS}
    for name, value in SIZES.items():
        setattr(cs, name, value)

    def counting(kernel):
        @functools.wraps(kernel)
        def run(*args, **kwargs):
            out = kernel(*args, **kwargs)
            kernel.launches += 1
            return out
        return run
    for name, kernel in kernels.items():
        setattr(fr, name, counting(kernel))
    try:
        yield cs.phase_resilience(torch, np, torch.device("cpu"),
                                  "cpu rehearsal")
    finally:
        for name, value in saved.items():
            setattr(cs, name, value)
        for name, kernel in kernels.items():
            setattr(fr, name, kernel)


def test_phase25_rehearses_on_the_cpu(phase25):
    total, summary = phase25
    a = summary["25a"]
    assert a["tensors_differing"] == 0 and a["max_abs_diff"] == 0.0
    steps = cs.RES_STEPS
    # 25a's launches: LM_LAYERS a step, the resumed run's split included,
    # and one forward a layer for each of the three nets' deferred init
    assert a["k4_per_step"] == (cs.LM_LAYERS, cs.LM_LAYERS)
    assert a["k4_launches"][1] == 2 * steps * cs.LM_LAYERS
    assert a["k4_launches"][0] == a["k4_launches"][1] + 3 * cs.LM_LAYERS
    assert a["ckpt_bytes"] > 0 and a["restore_ms"] > 0
    for leg in ("25b", "25c", "25d"):
        assert summary[leg]["k4_launches"] == [0, 0], leg
        assert summary[leg]["k4_expected"][0] >= steps * cs.LM_LAYERS, leg
    assert total == tuple(a["k4_launches"])
    errs = summary["25c"]["legs_s"]["elastic_rel_err"]
    assert set(errs) == {"eval_loss", "step_loss", "param_sumsq"}
    assert max(errs.values()) <= ELASTIC_RTOL == summary["25c"][
        "elastic_rtol"]
    hung = summary["25c"]["legs_s"]["survivor_exit_hung"]
    assert hung["timeout"]["rc"] == 1 and hung["grace"]["rc"] == 83
    flags = summary["25d"]["legs_s"]["A_straggler_flags"]
    assert flags and {str(f["host"]) for f in flags} == {"1"}
    assert min(f["ratio"] for f in flags) >= 3.0
