#!/usr/bin/env python3
"""K5 (user kernels through `mxnet_tpu_torch.rtc`) of two source trees side
by side on one card, and the launch path's host cost.

1. Compiles this tree's `chip_smoke.RTC_SOURCE` and TMA_SOURCE with
   NVRTC's ptxas report (registers, spills, shared memory of each kernel)
   and, where the toolkit's `cuobjdump` is found, counts the 16-byte
   global loads, shared loads and bulk copies in the SASS.
2. Holds each tree's three kernels to their plain versions at phase
   29c's sizes (its own `chip_smoke.rtc_run`, compiled by this tree's
   rtc), then times them by `chip_smoke.time_ms` (device time) in turns,
   base, this, this, base, beside the block sum's other design
   (TMA_SOURCE: a persistent ring of shared memory filled by TMA bulk
   copies) and the PyTorch call computing each function.
3. With --sweep, times the kernels at other settings (vectors in flight,
   threads a block; the TMA ring's stages).
4. Times the launch path: the host microseconds of one
   `CudaKernel.launch` of a one-thread kernel over LAUNCHES launches,
   beside `torch.mul`'s dispatch on a 4-element tensor and the launch's
   parts, in a fresh process of each tree, in the same turns.

    python3 tools/rtc_probe.py BASE_DIR [--sweep]   # NVIDIA GPU, repo root
    python3 tools/rtc_probe.py                      # this tree alone

BASE_DIR is another checkout (e.g. `git archive <commit> | tar -x -C
_archive/base`). Prints JSON lines, the card's name and power limit first.
Imports nothing of JAX.
"""
import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

#: the block sum's other design, timed beside RTC_SOURCE's (the first one
#: this port wrote for Hopper): a persistent kernel, one block an SM, whose
#: dynamic shared memory (TMA_STAGES x TMA_CHUNK floats, 128 KB, so the
#: launch opts in past 48 KB) is a ring filled by TMA bulk copies on
#: mbarriers. It lost to RTC_SOURCE's by 2.0-2.4 % on an H100 and stays
#: runnable here: PERF.md's times of it come from this script, and the
#: verdict is the card's and the toolkit's, to be read again on another
#: card or toolkit
TMA_CHUNK, TMA_STAGES, TMA_THREADS = 8192, 4, 256
TMA_SOURCE = r"""
struct alignas(16) V4 { float x, y, z, w; };

__device__ __forceinline__ bool aligned16(const void *p) {
  return ((unsigned long long)p & 15ull) == 0;
}

// block_sum_tma: out[t] = the sum of tile t (`tile` floats at x + t * tile;
// a [rows, cols] array cut into tiles along its rows is `tiles` of them in
// flat order). A persistent kernel: one block an SM, block b taking tiles
// b, b + gridDim.x, ... Its dynamic shared memory is a ring of SUM_STAGES
// stages, each filled by one TMA bulk copy (cp.async.bulk) of `chunk`
// floats, issued by one thread, whose completion arrives on the stage's
// mbarrier (the transaction count set by arrive.expect_tx). While the next
// stages load, the block sums the one that has arrived (16-byte reads from
// shared memory, 4 lanes a thread), waits for every thread to have read
// it, and hands it back to the loader; each tile's sum ends in warp
// shuffles and one float written. A bulk copy's source, destination and
// size must be multiples of 16 bytes: torch's allocations are 256-byte
// aligned and a chunk is a multiple of 4 floats, else the kernel traps.
// No cluster is launched, so the .shared::cluster destination is this
// block's own shared memory.
#define SUM_THREADS 256
#define SUM_CHUNK 8192
#define SUM_STAGES 4

__device__ __forceinline__ unsigned smem_u32(const void *p) {
  unsigned a;
  asm volatile("{ .reg .u64 t; cvta.to.shared.u64 t, %1; cvt.u32.u64 %0, t; }"
               : "=r"(a) : "l"(p));
  return a;
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile("{ .reg .pred p;"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
                 " selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_load(unsigned dst, const float *src,
                                          unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

extern "C" __global__ void __launch_bounds__(SUM_THREADS, 1)
block_sum_tma(const float *__restrict__ x, float *__restrict__ out, int tiles,
          int tile) {
  extern __shared__ float ring[];  // 16-byte aligned, or a trap
  __shared__ unsigned long long full[SUM_STAGES];
  __shared__ float warp_sums[SUM_THREADS / 32];
  const int chunk = tile < SUM_CHUNK ? tile : SUM_CHUNK;
  const unsigned ring0 = smem_u32(ring), bar0 = smem_u32(full);
  if (tile % chunk != 0 || chunk % 4 != 0 || !aligned16(x) || (ring0 & 15))
    __trap();
  const int per_tile = tile / chunk;
  const int mine = tiles > (int)blockIdx.x
                       ? (tiles - 1 - (int)blockIdx.x) / gridDim.x + 1 : 0;
  const int chunks = mine * per_tile;
  const unsigned bytes = 4u * chunk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < SUM_STAGES; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // chunk c of this block -> stage c % SUM_STAGES
  auto issue = [&](int c) {
    const long long t = blockIdx.x + (long long)(c / per_tile) * gridDim.x;
    const float *src = x + t * tile + (long long)(c % per_tile) * chunk;
    const int s = c % SUM_STAGES;
    mbar_expect_tx(bar0 + 8 * s, bytes);
    bulk_load(ring0 + 4u * SUM_CHUNK * s, src, bytes, bar0 + 8 * s);
  };
  if (threadIdx.x == 0)
    for (int c = 0; c < SUM_STAGES && c < chunks; ++c) issue(c);
  const V4 *rv = reinterpret_cast<const V4 *>(ring);
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % SUM_STAGES;
    mbar_wait(bar0 + 8 * s, (c / SUM_STAGES) & 1);
    const V4 *buf = rv + s * (SUM_CHUNK / 4);
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int i = threadIdx.x; i < chunk / 4; i += SUM_THREADS) {
      const V4 v = buf[i];
      a0 += v.x; a1 += v.y; a2 += v.z; a3 += v.w;
    }
    acc += (a0 + a1) + (a2 + a3);
    __syncthreads();  // every thread has read stage s: reload it
    if (threadIdx.x == 0 && c + SUM_STAGES < chunks) issue(c + SUM_STAGES);
    if ((c + 1) % per_tile == 0) {
      acc = warp_sum(acc);
      if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
      __syncthreads();
      if (threadIdx.x < 32) {
        float v = threadIdx.x < SUM_THREADS / 32 ? warp_sums[threadIdx.x]
                                                 : 0.f;
        v = warp_sum(v);
        if (threadIdx.x == 0)
          out[blockIdx.x + (long long)(c / per_tile) * gridDim.x] = v;
      }
      acc = 0.f;
    }
  }
}
"""
#: the TMA design's rings swept: (floats a stage, stages)
TMA_SWEEP = ((8192, 4), (4096, 12), (16384, 3))
#: the elementwise kernels swept: (vectors a thread before its stores,
#: threads a block), each on the grid rtc_grid gives them
ELEMENTWISE_SWEEP = ((2, 256), (4, 256), (8, 256), (4, 128), (4, 512))
#: block_sum swept: (vectors in flight a thread, threads a block)
SUM_SWEEP = ((4, 256), (8, 256), (16, 256), (4, 512), (8, 128))


def variant(defines, threads):
    """RTC_SOURCE with its #defines and launch bounds replaced."""
    src = cs.RTC_SOURCE.replace("__launch_bounds__(256)",
                                "__launch_bounds__(%d)" % threads)
    for name, value in defines.items():
        old = "#define %s " % name
        assert old in src, name
        src = src.replace(old, "#define %s %d //" % (name, value))
    return src


def tma_source(chunk, stages):
    src = TMA_SOURCE
    for name, value in (("SUM_CHUNK", chunk), ("SUM_STAGES", stages)):
        src = src.replace("#define %s " % name,
                          "#define %s %d //" % (name, value))
    return src


def tma_blocks(tiles, sms):
    """The TMA design's persistent grid: at most one block an SM, as few
    as keep every block's tile count the busiest one's."""
    return -(-tiles // -(-tiles // sms))


LAUNCHES = 1000

#: run in a fresh process from a tree's root: the host us of one
#: CudaKernel.launch of a tiny kernel, and of torch.mul on 4 floats
LAUNCH_PATH = r"""
import json, time, torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import rtc
n = int(__import__("sys").argv[1])
k = rtc.CudaModule('extern "C" __global__ void tiny(float *y, int n)'
                   ' { if (threadIdx.x < n) y[threadIdx.x] += 1.0f; }'
                   ).get_kernel("tiny", "float *y, int n")
ctx = mx.gpu(0)
y = mx.nd.NDArray(torch.zeros(4, device="cuda"))
t4 = torch.zeros(4, device="cuda")
out = {}
for rnd in range(2):
    for _ in range(50):
        k.launch([y, 4], ctx, (1,), (32,))
        torch.mul(t4, 2.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        k.launch([y, 4], ctx, (1,), (32,))
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _ in range(n):
        torch.mul(t4, 2.0)
    t3 = time.perf_counter()
    torch.cuda.synchronize()
    out = {"launch_us": 1e6 * (t1 - t0) / n, "torch_mul_us": 1e6 * (t3 - t2) / n}
# the launch's parts, where this tree has them
parts = {"pack_args": lambda: rtc.pack_args(k.params, [y, 4], ctx),
         "current_stream": lambda: torch.cuda.current_stream(0).cuda_stream,
         "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(0)}
if hasattr(rtc, "_context_is_current"):
    lib = rtc._libcuda()
    parts["context_is_current"] = lambda: rtc._context_is_current(lib, 0)
for name, fn in parts.items():
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    out[name + "_us"] = 1e6 * (time.perf_counter() - t0) / n
assert float(y._data[0]) == 2 * (50 + n), float(y._data[0])
print(json.dumps(out))
"""


def load_chip_smoke(tree, name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tree, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sass_counts(cubin):
    """{instruction: count} of the 16-byte loads and bulk copies in a
    CUBIN's SASS, or None without cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    with tempfile.NamedTemporaryFile(suffix=".cubin") as f:
        f.write(cubin)
        f.flush()
        sass = subprocess.run([tool, "-sass", f.name], capture_output=True,
                              text=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = {"LDG.E.128": 0, "STG.E.128": 0, "UBLKCP": 0,
                       "LDS.128": 0, "SYNCS": 0}
        elif fn:
            for op in out[fn]:
                if op in line:
                    out[fn][op] += 1
    return out


def sweep(torch, mx, rtc, dev, X, Y, O, S, x, y):
    """Time RTC_SOURCE's kernels at ELEMENTWISE_SWEEP / SUM_SWEEP's
    settings and the TMA design at TMA_SWEEP's rings on phase 29c's
    arrays, each held to its plain version first."""
    n, a, tile = cs.RTC_N, cs.RTC_SAXPY_A, cs.RTC_TILE
    tiles = n // tile
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ulp = torch.finfo(torch.float32).eps * ((a * x).abs() + y.abs())
    parts = x.view(-1, tile).double()
    yk, out, sums = Y._data, O._data, S._data

    def sum_err():
        return float(((sums.double() - parts.sum(-1)).abs()
                      / parts.abs().sum(-1)).max())
    for unroll, threads in ELEMENTWISE_SWEEP:
        mod = rtc.CudaModule(variant({"UNROLL": unroll}, threads))
        kd = mod.get_kernel(*cs.RTC_KERNELS[0])
        ks = mod.get_kernel(*cs.RTC_KERNELS[1])
        grid = ((cs.rtc_grid(n, sms, unroll, threads),), (threads,))
        out.zero_()
        yk.copy_(y)
        kd.launch([X, O, n], mx.gpu(0), *grid)
        ks.launch([X, Y, a, n], mx.gpu(0), *grid)
        torch.cuda.synchronize()
        ok = bool(torch.equal(out, x + x)) and float(
            ((yk - (y + a * x)).abs() / ulp).max()) <= cs.RTC_SAXPY_ULPS
        print(json.dumps({
            "elementwise": [unroll, threads], "blocks": grid[0][0], "ok": ok,
            "double_ms": cs.time_ms(torch, lambda: kd.launch(
                [X, O, n], mx.gpu(0), *grid), n=20),
            "saxpy_ms": cs.time_ms(torch, lambda: ks.launch(
                [X, Y, a, n], mx.gpu(0), *grid), n=20)}), flush=True)
    for unroll, threads in SUM_SWEEP:
        k = rtc.CudaModule(variant({"SUM_UNROLL": unroll}, threads)
                           ).get_kernel(*cs.RTC_KERNELS[2])

        def call():
            k.launch([X, S, tiles, tile], mx.gpu(0), (tiles,), (threads,))
        sums.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        print(json.dumps({"block_sum": [unroll, threads], "err": sum_err(),
                          "ms": cs.time_ms(torch, call, n=20)}), flush=True)
    for chunk, stages in TMA_SWEEP:
        k = rtc.CudaModule(tma_source(chunk, stages)).get_kernel(
            "block_sum_tma", cs.RTC_KERNELS[2][1])

        def call():
            k.launch([X, S, tiles, tile], mx.gpu(0),
                     (tma_blocks(tiles, sms),), (TMA_THREADS,),
                     shared_mem=4 * chunk * stages)
        sums.fill_(float("nan"))
        call()
        torch.cuda.synchronize()
        print(json.dumps({"block_sum_tma": [chunk, stages],
                          "err": sum_err(),
                          "ms": cs.time_ms(torch, call, n=20)}), flush=True)


def launch_path(tree):
    p = subprocess.run([sys.executable, "-c", LAUNCH_PATH, str(LAUNCHES)],
                       cwd=tree, capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=tree))
    if p.returncode:
        raise SystemExit("launch path in %s failed:\n%s" % (tree,
                                                           p.stderr[-3000:]))
    return json.loads(p.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", nargs="?", default=None)
    ap.add_argument("--sweep", action="store_true",
                    help="also time the kernels at other settings")
    args = ap.parse_args()
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import rtc
    if not torch.cuda.is_available():
        raise SystemExit("rtc_probe needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    print(card, flush=True)
    mod = rtc.CudaModule(cs.RTC_SOURCE, options=("--ptxas-options=-v",))
    tma = rtc.CudaModule(tma_source(TMA_CHUNK, TMA_STAGES),
                         options=("--ptxas-options=-v",))
    print(json.dumps({"ptxas": (mod.log + tma.log).strip().splitlines(),
                      "sass": dict(sass_counts(mod.cubin) or {},
                                   **(sass_counts(tma.cubin) or {}))}),
          flush=True)
    trees = {"this": cs}
    if args.base:
        trees["base"] = load_chip_smoke(os.path.abspath(args.base),
                                        "base_chip_smoke")
    order = ["base", "this", "this", "base"] if args.base else ["this"]
    tma_k = tma.get_kernel("block_sum_tma", cs.RTC_KERNELS[2][1])
    rows = []
    with mx.gpu(0):
        runs = {}
        for name, tree in trees.items():
            calls, _, errs, compile_ms = tree.rtc_run(torch, mx, dev)
            runs[name] = calls
            print(json.dumps({"tree": name, "compile_ms": compile_ms,
                              "errs": errs}), flush=True)
        x, y = cs.rtc_inputs(torch, dev, cs.RTC_N, cs.DEPLOY_SEED)
        tiles = cs.RTC_N // cs.RTC_TILE
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        X, S = mx.nd.NDArray(x), mx.nd.NDArray(torch.empty(tiles,
                                                           device=dev))

        def tma_call():
            tma_k.launch([X, S, tiles, cs.RTC_TILE], mx.gpu(0),
                         (tma_blocks(tiles, sms),), (TMA_THREADS,),
                         shared_mem=4 * TMA_CHUNK * TMA_STAGES)
        tma_call()
        torch.cuda.synchronize()
        parts = x.view(-1, cs.RTC_TILE).double()
        tma_err = float(((S._data.double() - parts.sum(-1)).abs()
                         / parts.abs().sum(-1)).max())
        for turn, name in enumerate(order):
            row = {"turn": turn, "tree": name}
            for k, (fn, _, lib, nbytes) in runs[name].items():
                row[k + "_ms"] = cs.time_ms(torch, fn, n=20)
                row[k + "_bound_ms"] = 1e3 * nbytes / cs.HBM_BYTES_S
                if turn == 0:
                    row[k + "_library_ms"] = cs.time_ms(torch, lib, n=20)
            row["block_sum_tma_ms"] = cs.time_ms(torch, tma_call, n=20)
            row["block_sum_tma_err"] = tma_err
            print(json.dumps(row), flush=True)
            rows.append(row)
        if args.sweep:
            sweep(torch, mx, rtc, dev, X, mx.nd.NDArray(y.clone()),
                  mx.nd.NDArray(torch.empty_like(x)), S, x, y)
    paths = {"this": ROOT}
    if args.base:
        paths["base"] = os.path.abspath(args.base)
    launch = []
    for turn, name in enumerate(order):
        r = dict(turn=turn, tree=name, launches=LAUNCHES,
                 **launch_path(paths[name]))
        print(json.dumps(r), flush=True)
        launch.append(r)
    print(json.dumps({"card": card, "kernels": rows, "launch_path": launch}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
