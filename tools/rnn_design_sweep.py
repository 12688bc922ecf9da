#!/usr/bin/env python3
"""Which design of the fused-RNN scan kernels (ops/csrc/fused_rnn.cu, K4a
and K4b) is fastest where, on one card: the readings behind
ops/fused_rnn.py `rnn_design`.

- The grid: at each (mode, dtype, N, H) of GRID and TINY, T 35, every
  design the kernels take there -- the streaming design, and the cluster
  design at each (P blocks, R batch rows a cluster) of P_CHOICES x
  R_CHOICES whose blocks fit shared memory and CLUSTER_ELEMS, in as many
  waves as the card needs -- launched through the port's wrappers with
  that design forced, held to the plain versions (fused_rnn.fed_plain,
  PLAIN_TOL) and timed by chip_smoke.time_ms, K4a and K4b, with the
  clusters the card runs at once (mxtt_rnn_max_clusters). Each point's
  summary names rnn_design's own choice, the design fastest over K4a +
  K4b, and the times of both and of the streaming design.
- The path's shape (T 35, N 32, H 200, lstm): the cluster design over P 8
  and 16 and R 8, 16 and 32, bfloat16 products on the tensor cores and,
  from a copy of the source built with them on the CUDA cores, float32,
  each beside its serial floor (mxtt_rnn_floor) and the clusters the card
  runs at once (mxtt_rnn_max_clusters).

    python tools/rnn_design_sweep.py [OUT.jsonl]   # NVIDIA GPU, repo root

Every row goes to OUT.jsonl (when given) as a JSON line; the summaries
print. Imports nothing of JAX.
"""
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import attention_ab as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402

T_STEPS = 35
P_CHOICES = (1, 2, 4, 8, 16)
R_CHOICES = (8, 16, 32)
#: (mode, dtype name, N, H): small to large layers, the path's batch to
#: eight of it, both dtypes, a simple mode
GRID = ([("lstm", "bfloat16", N, H) for H in (13, 32, 64, 128, 200, 256)
         for N in (3, 32, 64, 128, 256)]
        + [("lstm", "bfloat16", 512, H) for H in (200, 256)]
        + [("lstm", "float32", N, H) for H in (13, 64, 200)
           for N in (3, 32, 128, 256)]
        + [("rnn_tanh", "bfloat16", N, H) for H in (200, 512)
           for N in (32, 256)])
#: tiny layers, where the two designs cross
TINY = ([("lstm", dname, N, H) for dname in ("bfloat16", "float32")
         for N in (1, 3, 8, 16, 32) for H in (4, 8, 13, 16, 24, 32)]
        + [("rnn_tanh", "bfloat16", N, H) for N in (1, 8, 16, 32)
           for H in (8, 16, 32, 64, 128)])
#: the line of fused_rnn.cu that puts bfloat16 products on the tensor
#: cores, and the same with them on the CUDA cores
MMA_ON = "constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;"
MMA_OFF = "constexpr bool kMma = false;"


@contextlib.contextmanager
def forced(fr, d):
    """The wrappers launch design `d` whatever the shape."""
    chooser = fr.rnn_design
    fr.rnn_design = lambda mode, N, H, dtype, at_once=None: d
    try:
        yield
    finally:
        fr.rnn_design = chooser


def label(d):
    return "stream" if d.name == "stream" else "P%d R%d" % (d.P, d.rows)


def candidates(fr, mode, N, H, dtype):
    """Every design the kernels take at this shape."""
    bn = fr.batch_tile(N)
    out = [fr.RnnDesign("stream", 0, bn, -(-N // bn),
                        fr.stream_smem_bytes(mode, H, bn, False),
                        fr.stream_smem_bytes(mode, H, bn, True))]
    seen = set()
    for P in P_CHOICES:
        for rows in R_CHOICES:
            R = min(rows, N)
            if (P, R) in seen or \
                    R * fr.cluster_units(H, P, dtype) > fr.CLUSTER_ELEMS:
                continue
            seen.add((P, R))
            f, b = (fr.cluster_smem_bytes(mode, H, R, P, dtype, bwd)
                    for bwd in (False, True))
            if max(f, b) <= fr.SMEM_LIMIT:
                out.append(fr.RnnDesign("cluster", P, R, -(-N // R) * P, f, b))
    return out


def measure(torch, fr, mode, a, d, n=10):
    """(K4a ms, K4b ms, the outputs off PLAIN_TOL) of design `d` on `a`."""
    lstm = mode == "lstm"
    with forced(fr, d):
        got = fr.chain(mode, a)
        want = fr.fed_plain(mode, a, got)
        bad = {k: fr.plain_mismatch(got[k], want[k]) for k in fr.OUTPUTS
               if got[k] is not None}
        ys, cs_ = got["ys"], got["cs"]
        hprev = fr._shift_prev(a["h0"], ys, False)
        cprev = fr._shift_prev(a["c0"], cs_, False) if lstm else None
        c0 = a["c0"] if lstm else None
        fwd = cs.time_ms(torch, lambda: fr.rnn_fwd(
            mode, a["px"], a["h0"], c0, a["wh"]), n)
        bwd = cs.time_ms(torch, lambda: fr.rnn_bwd(
            mode, a["px"] if lstm else None, None if lstm else ys, hprev,
            cprev, cs_, a["wh"], a["dys"], a["dhT"],
            a["dcT"] if lstm else None), n)
    return fwd, bwd, {k: v for k, v in bad.items() if v}


def grid(torch, fr, lib, dev, card, out):
    for mode, dname, N, H in GRID + TINY:
        dtype = getattr(torch, dname)
        a = fr.check_inputs(mode, T_STEPS, N, H, dtype, seed=N + H,
                            device=dev)
        times = {}
        for d in candidates(fr, mode, N, H, dtype):
            fwd, bwd, bad = measure(torch, fr, mode, a, d)
            row = {"card": card, "mode": mode, "dtype": dname, "T": T_STEPS,
                   "N": N, "H": H, "design": label(d), "fwd_ms": fwd,
                   "bwd_ms": bwd, "off_tolerance": bad}
            if d.name == "cluster":
                row["max_active_clusters"] = [lib.mxtt_rnn_max_clusters(
                    fr._DTYPE_CODE[dtype], fr._MODE_CODE[mode], H, d.rows,
                    d.P, bwd_) for bwd_ in (0, 1)]
                row["clusters"] = d.blocks // d.P
            out(row)
            if bad:
                raise SystemExit("%s %s N=%d H=%d %s off PLAIN_TOL: %s"
                                 % (mode, dname, N, H, label(d), bad))
            times[label(d)] = (fwd, bwd)
        chosen = label(fr.rnn_design(mode, N, H, dtype))
        fastest = min(times, key=lambda k: sum(times[k]))
        s = {"card": card, "mode": mode, "dtype": dname, "N": N, "H": H,
             "chosen": chosen, "chosen_ms": times[chosen],
             "fastest": fastest, "fastest_ms": times[fastest],
             "stream_ms": times["stream"]}
        print(json.dumps(s), flush=True)
        out(dict(s, summary=True))


def path_shape(torch, fr, _cuda, lib, dev, card, out):
    """The cluster design at the path's shape over (P, R), bfloat16 on the
    tensor cores and on the CUDA cores, float32."""
    with open(os.path.join(_cuda._CSRC, "fused_rnn.cu")) as f:
        src = f.read()
    if src.count(MMA_ON) != 1:
        raise SystemExit("fused_rnn.cu moved: %r not found once" % MMA_ON)
    path = os.path.join(_cuda.BUILD_DIR, "fused_rnn_cuda_cores.cu")
    with open(path, "w") as f:
        f.write(src.replace(MMA_ON, MMA_OFF))
    simt = ab.build(_cuda, path, "cuda-cores-fused_rnn")
    T, N, H = cs.LM_BPTT, cs.LM_BATCH, cs.LM_HIDDEN
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        a = fr.check_inputs("lstm", T, N, H, dtype, seed=1234, device=dev)
        builds = (("tensor cores", lib), ("CUDA cores", simt)) \
            if dname == "bfloat16" else (("CUDA cores", lib),)
        for d in candidates(fr, "lstm", N, H, dtype):
            if d.P not in (8, 16):
                continue
            for products, built in builds:
                _cuda._libs["fused_rnn.cu"] = built
                try:
                    fwd, bwd, bad = measure(torch, fr, "lstm", a, d, 20)
                    with forced(fr, d):
                        floor = cs.time_ms(torch, fr.serial_floor(
                            "lstm", T, N, H, dtype, dev), 20)
                finally:
                    _cuda._libs["fused_rnn.cu"] = lib
                row = {"card": card, "shape": "path", "dtype": dname,
                       "design": label(d), "products": products,
                       "smem": [d.fwd_smem, d.bwd_smem], "fwd_ms": fwd,
                       "bwd_ms": bwd, "serial_floor_ms": floor,
                       "off_tolerance": bad,
                       "max_active_clusters": [lib.mxtt_rnn_max_clusters(
                           fr._DTYPE_CODE[dtype], 0, H, d.rows, d.P, b)
                           for b in (0, 1)]}
                print(json.dumps(row), flush=True)
                out(row)


def main():
    import torch
    if not torch.cuda.is_available() or len(sys.argv) > 2:
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_rnn as fr
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    print(card)
    lib = _cuda.library("fused_rnn.cu")
    sink = open(sys.argv[1], "w") if len(sys.argv) == 2 else None

    def out(row):
        if sink is not None:
            sink.write(json.dumps(row) + "\n")
            sink.flush()
    try:
        path_shape(torch, fr, _cuda, lib, dev, card, out)
        grid(torch, fr, lib, dev, card, out)
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
