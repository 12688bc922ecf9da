#!/usr/bin/env python3
"""Where AOTInductor's compile time goes on this host: phase 30b's word LM
(chip_smoke.lm_export: phase 11's width, MXNET_FUSED_RNN=1) exported on
the card, then compiled for it by predict.compile_for_cpp under cProfile
twice in this process (cold, then warm), with the profile's largest
cumulative entries and every subprocess the cold compile ran (its
seconds and command); then, in a fresh process each, once with
Inductor's precompiled headers off, once with one compile thread and
once with the base ISAs' probe builds skipped (cpp.vec_isa_ok;
compile_for_cpp now skips every probe for the card).

    python tools/aoti_compile_probe.py [--child MODE ART]   # repo root

Prints one JSON line a reading after the card's name and power limit.
Imports nothing of JAX.
"""
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def compile_once(art, mode):
    import torch._inductor.config as cfg
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import predict
    patch = {"no_pch": {"aot_inductor.precompile_headers": False},
             "one_thread": {"compile_threads": 1},
             "vec_isa_ok": {"cpp.vec_isa_ok": True}}.get(mode, {})
    with cfg.patch(patch):
        t0 = time.perf_counter()
        predict.compile_for_cpp(art, ctx=mx.gpu(0))
        return time.perf_counter() - t0


def main():
    import numpy as np
    import torch
    if len(sys.argv) == 4 and sys.argv[1] == "--child":
        print(json.dumps({"mode": sys.argv[2],
                          "s": compile_once(sys.argv[3], sys.argv[2])}))
        return 0
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    import torch._inductor.config as cfg
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"compile_threads": cfg.compile_threads,
                      "cpus": os.cpu_count(),
                      "worker_start_method": getattr(
                          cfg, "worker_start_method", None)}), flush=True)
    dev = torch.device("cuda", 0)
    tmp = tempfile.mkdtemp(prefix="aoti_probe_")
    os.environ["MXNET_FUSED_RNN"] = "1"
    with mx.gpu(0):
        _, _, art, export_s = cs.lm_export(torch, np, mx, dev, tmp)
    print(json.dumps({"export_s": export_s}), flush=True)
    ran = []
    popen_init, popen_wait = subprocess.Popen.__init__, subprocess.Popen.wait

    def init(self, args, *a, **k):
        self._t0, self._cmd = time.perf_counter(), args
        return popen_init(self, args, *a, **k)

    def wait(self, *a, **k):
        rc = popen_wait(self, *a, **k)
        if getattr(self, "_t0", None) is not None:
            cmd = self._cmd if isinstance(self._cmd, str) else \
                " ".join(map(str, self._cmd))
            ran.append((time.perf_counter() - self._t0, cmd[:160]))
            self._t0 = None
        return rc
    subprocess.Popen.__init__, subprocess.Popen.wait = init, wait
    for what in ("cold", "warm"):
        del ran[:]
        prof = cProfile.Profile()
        prof.enable()
        s = compile_once(art, "")
        prof.disable()
        buf = io.StringIO()
        pstats.Stats(prof, stream=buf).sort_stats("cumulative").print_stats(
            70)
        print(json.dumps({"compile": what, "s": s}), flush=True)
        print(buf.getvalue()[-14000:] if what == "cold" else "", flush=True)
        print(json.dumps({"subprocesses_" + what: sorted(ran)[::-1][:30],
                          "total_s": sum(r[0] for r in ran)}), flush=True)
    subprocess.Popen.__init__, subprocess.Popen.wait = popen_init, \
        popen_wait
    for mode in ("vec_isa_ok", "no_pch", "one_thread"):
        p = subprocess.run([sys.executable, __file__, "--child", mode, art],
                           capture_output=True, text=True)
        print(p.stdout.strip().splitlines()[-1] if p.returncode == 0
              else p.stderr[-2000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
