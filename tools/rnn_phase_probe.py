#!/usr/bin/env python3
"""Where one step of the cluster design's K4a and K4b goes, on the card: a
copy of ops/csrc/fused_rnn.cu with clock64() probes at the phase
boundaries of each step (block 0, thread 0), built beside the port's
kernels and run through the port's wrappers (fused_rnn.chain) at the word
LM's shape (T 35, N 32, H 200, lstm) in bfloat16 and float32. Prints the
mean cycles a step and of each phase over the inner steps:

  K4b: elementwise (dpre) + barrier | partial dh product + pushes |
       arrive + dpx stores | dWh step | next inputs + cp.async wait +
       barrier | next pre product | cluster wait | partial sums + barrier
  K4a: product + barrier | gates | pushes + arrive | stores + next px |
       cluster wait

Thread 0's clock: a phase that ends in a barrier holds the slowest
thread's time, the others thread 0's own. The probes are inserted by
exact source text; the script stops if the kernels' text has moved.

    python tools/rnn_phase_probe.py   # NVIDIA GPU, repo root

Imports nothing of JAX.
"""
import ctypes
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

#: (source text, the same with probes) for each phase boundary; PROBE(o, k)
#: stores clock64() of step s at g_prof[o + 10 s + k]
PROBES = [
    ("""    const int64_t tn = reverse ? t + 1 : t - 1;
    const bool last = s == steps - 1;""",
     """    const int64_t tn = reverse ? t + 1 : t - 1;
    const bool last = s == steps - 1;
    PROBE(0, 0)"""),
    ("""    __syncthreads();
    float* rv = recv + (s & 1) * p.P * L.Rp * L.U;
    partial_dh(dps, whs, part, p.nr, L);
    __syncthreads();
    push_partials(cluster, part, rv, p, H, L);
    cluster_arrive();""",
     """    __syncthreads();
    PROBE(0, 1)
    float* rv = recv + (s & 1) * p.P * L.Rp * L.U;
    partial_dh(dps, whs, part, p.nr, L);
    __syncthreads();
    push_partials(cluster, part, rv, p, H, L);
    PROBE(0, 2)
    cluster_arrive();"""),
    ("""    dwh_step(dps, hs, dwh, p.nr, L);
    if (!last) {
      fetch(tn, x);
      cp_async_wait();
      __syncthreads();
      if (MODE == kLstm) product_nt(hn, whs, pre, rows4, L);
    }
    cluster_wait();""",
     """    PROBE(0, 3)
    dwh_step(dps, hs, dwh, p.nr, L);
    PROBE(0, 4)
    if (!last) {
      fetch(tn, x);
      cp_async_wait();
      __syncthreads();
      PROBE(0, 5)
      if (MODE == kLstm) product_nt(hn, whs, pre, rows4, L);
    }
    PROBE(0, 6)
    cluster_wait();
    PROBE(0, 7)"""),
    ("""      dh[e] = v;
      if (last) dh0[(p.row0 + n) * H + p.u0 + ul] = from_f<T>(v);
    }
    __syncthreads();
  }""",
     """      dh[e] = v;
      if (last) dh0[(p.row0 + n) * H + p.u0 + ul] = from_f<T>(v);
    }
    __syncthreads();
    PROBE(0, 8)
  }"""),
    ("""    const int64_t t = reverse ? steps - 1 - s : s;
    const bool last = s == steps - 1;
    product_nt(hb + (s & 1) * L.Rp * L.LD, whs, pre, rows4, L);
    __syncthreads();""",
     """    const int64_t t = reverse ? steps - 1 - s : s;
    const bool last = s == steps - 1;
    PROBE(1024, 0)
    product_nt(hb + (s & 1) * L.Rp * L.LD, whs, pre, rows4, L);
    __syncthreads();
    PROBE(1024, 1)"""),
    ("""    if (!last) {
      __syncthreads();
      push_slice(cluster, hn, p, L);
      cluster_arrive();
    }""",
     """    PROBE(1024, 2)
    if (!last) {
      __syncthreads();
      push_slice(cluster, hn, p, L);
      cluster_arrive();
    }
    PROBE(1024, 3)"""),
    ("""    if (!last) cluster_wait();
  }
}""",
     """    PROBE(1024, 4)
    if (!last) cluster_wait();
    PROBE(1024, 5)
  }
}"""),
]
HEADER = ("""namespace {

constexpr int kThreads = 512;""",
          """__device__ long long g_prof[2048];
#define PROBE(o, k) \\
  if (threadIdx.x == 0 && blockIdx.x == 0 && s < 64) \\
    g_prof[(o) + s * 10 + (k)] = clock64();
namespace {

constexpr int kThreads = 512;""")
ENTRY = """
extern "C" int mxtt_rnn_prof(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 2048);
}
"""


def probed_source(src):
    for old, new in [HEADER] + PROBES:
        if src.count(old) != 1:
            raise SystemExit("fused_rnn.cu moved: probe text not found once:"
                             "\n" + old)
        src = src.replace(old, new)
    return src + ENTRY


def main():
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    import attention_ab as ab
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _cuda
    from mxnet_tpu_torch.ops import fused_rnn as fr
    with open(os.path.join(_cuda._CSRC, "fused_rnn.cu")) as f:
        src = probed_source(f.read())
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    path = os.path.join(_cuda.BUILD_DIR, "fused_rnn_probed.cu")
    with open(path, "w") as f:
        f.write(src)
    lib = ab.build(_cuda, path, "probed-fused_rnn")
    lib.mxtt_rnn_prof.argtypes = [ctypes.c_void_p]
    # the wrappers launch through the library _cuda hands them
    _cuda._libs["fused_rnn.cu"] = lib
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi())
    buf = (ctypes.c_longlong * 2048)()
    T, N, H = cs.LM_BPTT, cs.LM_BATCH, cs.LM_HIDDEN
    for dname in ("bfloat16", "float32"):
        a = fr.check_inputs("lstm", T, N, H, getattr(torch, dname), seed=1,
                            device=dev)
        for _ in range(3):
            fr.chain("lstm", a)
        torch.cuda.synchronize()
        assert lib.mxtt_rnn_prof(ctypes.addressof(buf)) == 0
        v = list(buf)
        for name, off, k in (("K4b", 0, 9), ("K4a", 1024, 6)):
            steps = [[v[off + s * 10 + j] for j in range(k)]
                     for s in range(T)]
            inner = steps[1:-1]
            phases = [sum(st[j + 1] - st[j] for st in inner) / len(inner)
                      for j in range(k - 1)]
            step = sum(steps[s + 1][0] - steps[s][0]
                       for s in range(1, T - 2)) / (T - 3)
            print("%s %s: %.0f cycles a step; phases %s"
                  % (dname, name, step, ["%.0f" % x for x in phases]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
