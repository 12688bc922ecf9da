// Fused BatchNorm / ReLU / residual epilogue kernels for Hopper (sm_90a).
//
// Replaces the four TPU kernels of mxnet_tpu/ops/pallas_fused.py, which
// every training-mode BatchNorm of a model-zoo ResNet runs through when
// MXNET_FUSED_BN_EPILOGUE=1 (53 BatchNorms a ResNet-50 step):
//
//   K3a _stats_kernel       mean, var = E[x], max(E[x^2] - E[x]^2, 0)
//                           per channel, float32 accumulation;
//   K3b _apply_kernel       y = [relu](x * scale + offset [+ residual]);
//   K3c _bwd_reduce_kernel  dz = (y > 0 ? dy : 0) rounded to the
//                           activation type (relu only; else dz is dy and
//                           nothing is written), and per channel sum(dz),
//                           sum(dz * xhat), xhat = (x - mean) * inv, over
//                           the same rounded dz;
//   K3d _bwd_dx_kernel      dx = c1 * dz + c2 * x + c3.
//
// Every kernel works on the [N, C, S] view of a channels-first activation
// (S = the flattened spatial size): channel c is N runs of S contiguous
// elements, run n starting at (n * C + c) * S. The activation type T is
// float or __nv_bfloat16; all arithmetic is float32 and each output is
// rounded once. The per-channel vectors (scale, offset, mean, inv, c1..c3)
// are float32, computed by the caller on (C,) vectors as the reference
// computes them outside its kernels. Offsets are 64-bit where a tensor has
// 2^31 elements or more (the stem activation of a batch-256 ResNet-50 step
// is 205.5 M elements), 32-bit below.
//
// What bounds them: device-memory bytes. Each reads one to three
// activation-sized tensors and writes at most one, with 3 to 6 flops an
// element (mxnet_tpu_torch/ops/fused_bn.py fused_bn_call_cost, the
// reference's declared costs): under one flop a byte, far below the card's
// float32 ridge of about 20. So every byte is moved once, in 16-byte
// vectors, with enough of them in flight, and few instructions a byte.
//
//   * K3b and K3d: one flat pass (bn_flat_kernel) over the N * C * S
//     elements, the per-element expression a functor (ApplyOp, DxOp) and
//     the streamed operands (x and the residual; dz and x) its only
//     difference. The vector width W is a compile-time constant, 16
//     bytes' worth, or 1 where a pointer is not 16-byte aligned; vectors
//     are cut from the flat tensor, so alignment depends on the base
//     pointers alone and S = 49 or 196 in bfloat16 keeps whole vectors (an
//     n % W tail is a separate scalar step). (c, s) is computed once a
//     vector, in 32 bits by a multiply and shift (FastDiv) below 2^31
//     elements. For S >= W a vector spans at most two channels: c's
//     coefficients are loaded once, c + 1's only where the vector crosses
//     a row end (S < W keeps a per-element walk, right for S = 1). Relu
//     and the residual are template parameters. Each thread keeps four
//     vectors in flight over a grid of the blocks the SMs hold at once.
//     The expressions and their order are the reference's, in float32,
//     rounded once; FMA contraction as in the earlier per-element pass
//     (x * scale + offset is one FMA), so the outputs are bit for bit
//     those of the per-element pass this one replaced.
//   * K3a (bn_stats_kernel): a block owns a group of G channels and a
//     range of n. For each n, channels g G .. g G + G - 1 are one
//     contiguous span of G * S elements; G = V / gcd(S, V) (V = 16 bytes'
//     worth of T) makes the span whole 16-byte vectors (S = 49 in
//     bfloat16: G = 8, 49 vectors; S = 196: G = 2), so every S takes
//     16-byte loads. A block's active threads are a whole number of spans
//     wide, so each thread always takes the same vector position of the
//     span and keeps one float32 sum of x and of x^2 per element of its
//     vector, each element's channel fixed for the thread (in two levels:
//     16 trips' sums, then their sum). Four vectors in flight a thread.
//     The block adds its per-element sums by channel in shared memory, in
//     a fixed order (G = 1: a warp-shuffle then shared-memory tree). The P
//     blocks of a channel group form a thread-block cluster: after a
//     cluster barrier, the group's first block reads the others' sums
//     through distributed shared memory in rank order (in double), and
//     writes mean and var = max(E[x^2] - mean^2, 0). No atomics, no
//     workspace and no second launch; a result repeats bit for bit. The
//     wrapper sizes P for about two blocks an SM, one wave. A C not a
//     multiple of G (or a group too wide for a block, or an unaligned x)
//     takes the same kernel at W = 1, G = 1.
//   * K3c (bn_bwd_reduce_kernel): a block walks whole rows (n, c) of one
//     channel, each row covered by the aligned 16-byte vectors that
//     overlap it, the head and tail masked to the row's own elements (so
//     odd S keeps 16-byte loads; dz is stored through the same vectors).
//     A thread steps its (row, vector) pair without a division and keeps
//     four vectors in flight; the P blocks of a channel form a cluster
//     whose rank 0 adds their sums through distributed shared memory in
//     rank order (in double), as K3a does: one launch, no workspace, a
//     result that repeats bit for bit. Pointers that do not share one
//     offset mod 16 bytes take the same kernel at W = 1.
//
// The kernels launch on the caller's stream, allocate nothing (the
// wrapper allocates the outputs) and do not synchronise;
// each C entry returns the launch's error, or cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// elements of T in one 16-byte vector
template <typename T>
struct Vec {
  static constexpr int V = 16 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[Vec<T>::V]) {
  uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int k = 0; k < Vec<T>::V; ++k) out[k] = to_f(e[k]);
}

template <typename T>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[Vec<T>::V]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int k = 0; k < Vec<T>::V; ++k) e[k] = from_f<T>(in[k]);
  *reinterpret_cast<uint4*>(p) = u;
}

// sum of a and of b over the block, in a fixed order; valid in thread 0
__device__ __forceinline__ void block_sum2(float& a, float& b) {
  __shared__ float sh[2][32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) {
    sh[0][w] = a;
    sh[1][w] = b;
  }
  __syncthreads();
  if (w == 0) {
    const int nw = blockDim.x >> 5;
    a = l < nw ? sh[0][l] : 0.f;
    b = l < nw ? sh[1][l] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
  }
}

// n / d for 0 <= n < 2^31 and a divisor d >= 1 fixed for the launch: a
// multiply and a shift, mul = ceil(2^(31 + L) / d) with L = ceil(log2 d)
// (mul = 0 stands for d = 1). Exact over that range: the rounding of mul
// adds less than n / 2^(31 + L) < 1 / d to n / d.
struct FastDiv {
  uint32_t mul, shr;
};

FastDiv fast_div(uint32_t d) {
  FastDiv f{0u, 0u};
  if (d > 1) {
    uint32_t L = 0;
    while ((1ull << L) < d) ++L;
    f.mul = static_cast<uint32_t>(((1ull << (31 + L)) + d - 1) / d);
    f.shr = L - 1;  // __umulhi has shifted by 32 already
  }
  return f;
}

__device__ __forceinline__ uint32_t divide(uint32_t n, uint32_t /*d*/,
                                           FastDiv f) {
  return f.mul == 0u ? n : __umulhi(n, f.mul) >> f.shr;
}
__device__ __forceinline__ int64_t divide(int64_t n, int64_t d, FastDiv) {
  return n / d;
}

// W consecutive elements as float32: one 16-byte load (W = V) or one
// element (W = 1)
template <typename T, int W>
__device__ __forceinline__ void load_w(const T* p, float (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = to_f(*p);
  } else {
    static_assert(W == Vec<T>::V, "a vector is 16 bytes");
    load_vec(p, v);
  }
}

template <typename T, int W>
__device__ __forceinline__ void store_w(T* p, const float (&v)[W]) {
  if constexpr (W == 1) {
    *p = from_f<T>(v[0]);
  } else if constexpr (sizeof(T) == 2) {  // bfloat16: rounded in pairs
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < W / 2; ++k)
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    store_vec(p, v);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// ---------------------------------------------------------------------------
// K3a: per-channel mean and var
// ---------------------------------------------------------------------------

// The W elements at p, as loaded (converted to float32 when summed)
template <typename T, int W>
using Raw = std::conditional_t<W == 1, T, uint4>;

template <typename T, int W>
__device__ __forceinline__ Raw<T, W> load_raw(const T* p) {
  if constexpr (W == 1) {
    return *p;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int W>
__device__ __forceinline__ void unpack(const Raw<T, W>& r, float (&v)[W]) {
  if constexpr (W == 1) {
    v[0] = to_f(r);
  } else {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int k = 0; k < W; ++k) v[k] = to_f(e[k]);
  }
}

// Grid: C / G channel groups x P blocks, one cluster of P blocks a group;
// block rank r of group g sums rows [r per, r per + per) of channels
// [g G, g G + G). The span of one row is Q = G S / W vectors; the block's
// first Tp threads take its vectors j = t, t + Tp, ... For G > 1 (which
// needs Q <= kStatsThreads) Tp is the largest multiple of Q <=
// kStatsThreads, so thread t always takes position t % Q and each of its
// W sums belongs to one channel; for G = 1 every element is channel g's
// and Tp = kStatsThreads.
constexpr int kStatsThreads = 256;

template <typename T, typename I, int W>
__global__ void __launch_bounds__(kStatsThreads, 1024 / kStatsThreads)
    bn_stats_kernel(const T* __restrict__ x, I N, I C, I S, int G, I Q,
                    FastDiv dQ, float inv_m, float* __restrict__ mean,
                    float* __restrict__ var) {
  constexpr int U = 4;
  constexpr int V = Vec<T>::V;
  __shared__ float blk[2][V];  // this block's sums, by channel of the group
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned P = cluster.num_blocks(), rank = cluster.block_rank();
  const I g = blockIdx.x / P;
  const I per = (N + P - 1) / P;
  const I n0 = rank * per < N ? rank * per : N;
  const I n1 = n0 + per < N ? n0 + per : N;
  const I units = (n1 - n0) * Q;
  const I Tp = G > 1 ? (kStatsThreads / Q) * Q : kStatsThreads;
  const I t = threadIdx.x;
  const T* base = x + (n0 * C + g * G) * S;
  const I row = C * S;

  // a thread's sums in two levels: a chunk of kTrips trips into ca, cb,
  // each chunk's into a, b (one float32 sum over 10^5 positive terms is
  // biased by ~1e-4; over 64 and then 10^5 / 64, by ~1e-6)
  constexpr int kTrips = 16;
  float a[W], b[W];
#pragma unroll
  for (int e = 0; e < W; ++e) a[e] = b[e] = 0.f;
  if (t < Tp) {
    for (I c0 = t; c0 < units; c0 += kTrips * U * Tp) {
      float ca[W], cb[W];
#pragma unroll
      for (int e = 0; e < W; ++e) ca[e] = cb[e] = 0.f;
      for (int k = 0; k < kTrips; ++k) {
        const I j0 = c0 + k * U * Tp;
        if (j0 >= units) break;
        Raw<T, W> raw[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const I j = j0 + u * Tp;
          if (j < units) {
            const I n = divide(j, Q, dQ);
            raw[u] = load_raw<T, W>(base + n * row + (j - n * Q) * W);
          }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + u * Tp < units) {
            float v[W];
            unpack<T, W>(raw[u], v);
#pragma unroll
            for (int e = 0; e < W; ++e) {
              ca[e] += v[e];
              cb[e] += v[e] * v[e];
            }
          }
        }
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        a[e] += ca[e];
        b[e] += cb[e];
      }
    }
  }

  if (G == 1) {  // every element of the block is channel g's
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      sa += a[e];
      sb += b[e];
    }
    block_sum2(sa, sb);
    if (t == 0) {
      blk[0][0] = sa;
      blk[1][0] = sb;
    }
  } else {
    // thread t = r Q + p holds span elements p W .. p W + W - 1 of row
    // lane r: at sh[t W + e] = sh[r L + p W + e], L = Q W. Warp k < G then
    // adds channel k's S elements of each of the R row lanes.
    __shared__ float sh[2][kStatsThreads * W];
    if (t < Tp) {
#pragma unroll
      for (int e = 0; e < W; ++e) {
        sh[0][t * W + e] = a[e];
        sh[1][t * W + e] = b[e];
      }
    }
    __syncthreads();
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    if (w < G) {
      const I R = Tp / Q, L = Q * W;
      // lane l walks m = l, l + 32, ... of the R x S elements, (r, s)
      // stepped without a division
      const I dr = 32 / S, ds = 32 % S;
      I r = static_cast<I>(l) / S, s = static_cast<I>(l) % S;
      float sa = 0.f, sb = 0.f;
      for (; r < R; r += dr) {
        const I i = r * L + w * S + s;
        sa += sh[0][i];
        sb += sh[1][i];
        s += ds;
        if (s >= S) {
          s -= S;
          ++r;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
      }
      if (l == 0) {
        blk[0][w] = sa;
        blk[1][w] = sb;
      }
    }
  }

  cluster.sync();  // every block of the group has written blk
  if (rank == 0 && t < static_cast<I>(G)) {
    double sa = 0.0, sb = 0.0;
    for (unsigned r = 0; r < P; ++r) {
      const float* rb = cluster.map_shared_rank(&blk[0][0], r);
      sa += rb[t];
      sb += rb[V + t];
    }
    const I c = g * G + t;
    if (c < C) {
      const float m = static_cast<float>(sa) * inv_m;
      const float q = static_cast<float>(sb) * inv_m;
      mean[c] = m;
      var[c] = fmaxf(q - m * m, 0.f);
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its blk
}

template <typename T, typename I, int W>
cudaError_t bn_stats_launch(const T* x, int64_t N, int64_t C, int64_t S,
                            int G, int P, float inv_m, float* mean,
                            float* var, cudaStream_t st) {
  const int64_t Q = G * S / W;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C / G * P));
  cfg.blockDim = dim3(kStatsThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(P);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, bn_stats_kernel<T, I, W>, x, static_cast<I>(N),
      static_cast<I>(C), static_cast<I>(S), G, static_cast<I>(Q),
      fast_div(static_cast<uint32_t>(Q)), inv_m, mean, var);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

int gcd(int64_t a, int64_t b) {
  while (b != 0) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return static_cast<int>(a);
}

// K3a's launch: 16-byte vectors and G = V / gcd(S, V) channels a span
// where x is 16-byte aligned, C % G == 0 and the span fits a block's
// threads; else single elements, one channel a span.
template <typename T>
cudaError_t bn_stats_entry(const void* x, int64_t N, int64_t C, int64_t S,
                           int P, float inv_m, float* mean, float* var,
                           cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  const T* xv = static_cast<const T*>(x);
  const int G = V / gcd(S, V);
  const bool vec = aligned16(x) && C % G == 0 &&
                   (G == 1 || G * S / V <= kStatsThreads);
  if (N * C * S <= INT32_MAX)
    return vec ? bn_stats_launch<T, uint32_t, V>(xv, N, C, S, G, P, inv_m,
                                                 mean, var, st)
               : bn_stats_launch<T, uint32_t, 1>(xv, N, C, S, 1, P, inv_m,
                                                 mean, var, st);
  return vec ? bn_stats_launch<T, int64_t, V>(xv, N, C, S, G, P, inv_m, mean,
                                              var, st)
             : bn_stats_launch<T, int64_t, 1>(xv, N, C, S, 1, P, inv_m, mean,
                                              var, st);
}

// ---------------------------------------------------------------------------
// K3c: relu mask, dz store, per-channel sums of dz and dz * xhat
// ---------------------------------------------------------------------------

// Replaces mxnet_tpu/ops/pallas_fused.py::_bwd_reduce_kernel. Bound by
// device-memory bytes: it reads dy and x (and y with relu) once and writes
// dz once with relu, 2 passes over the activation without relu and 4 with
// (fused_bn_call_cost("bwd_reduce")), at 6 flops an element.
//
// The design keeps every byte in 16-byte vectors whatever S is, with no
// index math inside a row and one launch:
//   * a unit is one aligned W-element vector that overlaps a row (n, c);
//     a row's Q units cover its S elements, the head and tail units
//     masked to the row's own elements (the neighbouring channels' bytes
//     they also read are the only extra: two vectors a row at most, 1/73
//     at S = 289 in float32). dz goes out through the same vectors: whole
//     16-byte stores in the middle, the row's own elements at its ends.
//     Where dy, x, y and dz do not share one offset mod 16 bytes, W = 1.
//   * the block's units (its rows x Q) are dealt to its threads in turn,
//     each thread stepping its (row, unit) pair by the block's width with
//     an add and a compare: one division a thread, none an element; the
//     row's start (n C + c) S is one multiply a unit;
//   * four units in flight a thread, float32 sums by vector lane over 16
//     trips, then a thread's sum, a warp-shuffle and shared-memory tree;
//   * channel c's P blocks (P <= 8: the wrapper takes the most with which
//     all C clusters run at once, asking the card, mxtt_bn_reduce_max_
//     clusters) form a thread-block cluster: after a cluster barrier rank 0
//     adds the blocks' sums through distributed shared memory in rank
//     order, in double, and writes sum(dz) and sum(dz xhat). No atomics,
//     no workspace and no second launch; a result repeats bit for bit.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/bn_ab.py, in turns with
// the earlier design of C x P chunk blocks, a [2, C, P] workspace and a
// combining launch): a float32 batch-128 Inception-v3 step's 94 calls
// 4.46 ms against 8.40 (bound 2.74; 1.13-1.24x the bound at S >= 5041,
// 1.6-2.3x at S = 1225 and 289, 2.6-3.6x at S = 64, where a call moves
// ~25 MB and launch and latency rule), a bfloat16 batch-256 ResNet-50
// step's 53 calls 7.49 ms against 9.83 (bound 5.77; 1.3-1.6x at S = 196,
// 2.1-2.7x at S = 49). tools/bn_reduce_sweep.py times U and the launch
// bounds' blocks an SM: U = 4 at 2 blocks was within 3 % of the best of
// six builds on both steps; at 3 or 4 blocks (fewer registers a thread)
// the ResNet-50 step's calls took twice as long.
constexpr int kReduceThreads = 256;

template <typename T, int W>
__device__ __forceinline__ void store_raw(T* p, const T (&v)[W]) {
  if constexpr (W == 1) {
    *p = v[0];
  } else {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < W; ++k) e[k] = v[k];
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// Grid: C x P blocks, one cluster of P blocks a channel; block rank q of
// channel c sums rows n in [q per, q per + per). Pointers are the
// tensors' own less o0 elements, so that virtual element o0 + i (element
// i of the tensor) lies in vector (o0 + i) / W at an aligned address.
template <typename T, typename I, int W, bool kRelu>
__global__ void __launch_bounds__(kReduceThreads, 2)
    bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                         const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ inv, T* __restrict__ dz,
                         I N, I C, I S, I Q, I o0, float* __restrict__ sdz,
                         float* __restrict__ sdx) {
  constexpr int U = 4;  // units in flight a thread
  constexpr int kTrips = 16;
  using UI = std::make_unsigned_t<I>;
  __shared__ float blk[2];  // this block's sums
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned P = cluster.num_blocks(), rank = cluster.block_rank();
  const I c = blockIdx.x / P;
  const I per = (N + P - 1) / P;
  const I n0 = rank * per < N ? rank * per : N;
  const I rows = (n0 + per < N ? n0 + per : N) - n0;
  const float m = __ldg(mean + c), iv = __ldg(inv + c);
  // thread t's units are t, t + kReduceThreads, ... of the block's rows x Q
  const I dr = kReduceThreads / Q, dk = kReduceThreads % Q;
  I r = static_cast<I>(threadIdx.x) / Q, k = static_cast<I>(threadIdx.x) % Q;

  float a = 0.f, b = 0.f;
  while (r < rows) {
    float ca[W], cb[W];
#pragma unroll
    for (int e = 0; e < W; ++e) ca[e] = cb[e] = 0.f;
    for (int trip = 0; trip < kTrips && r < rows; ++trip) {
      I vg[U], off[U];  // vector index; its first element's place in the row
      bool live[U];
      Raw<T, W> rdy[U], rx[U], ry[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        live[u] = false;
        if (r < rows) {
          const UI start = static_cast<UI>(((n0 + r) * C + c) * S + o0);
          vg[u] = static_cast<I>(start / W) + k;
          off[u] = k * W - static_cast<I>(start % W);
          // unit 0 always holds the row's first element; a later one
          // holds some element when it starts inside the row
          live[u] = k == 0 || static_cast<UI>(off[u]) < static_cast<UI>(S);
          k += dk;
          r += dr;
          if (k >= Q) {
            k -= Q;
            ++r;
          }
        }
        if (live[u]) {
          rdy[u] = load_raw<T, W>(dy + vg[u] * W);
          rx[u] = load_raw<T, W>(x + vg[u] * W);
          if constexpr (kRelu) ry[u] = load_raw<T, W>(y + vg[u] * W);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!live[u]) continue;
        bool in[W];  // element e is the row's
#pragma unroll
        for (int e = 0; e < W; ++e)
          in[e] = static_cast<UI>(off[u] + e) < static_cast<UI>(S);
        float g[W], xv[W];
        unpack<T, W>(rdy[u], g);
        unpack<T, W>(rx[u], xv);
        if constexpr (kRelu) {
          float yv[W];
          unpack<T, W>(ry[u], yv);
          T z[W];
#pragma unroll
          for (int e = 0; e < W; ++e) {
            z[e] = from_f<T>(yv[e] > 0.f ? g[e] : 0.f);
            g[e] = to_f(z[e]);
          }
          T* out = dz + vg[u] * W;
          if (in[0] && in[W - 1]) {  // the elements in a row are contiguous
            store_raw<T, W>(out, z);
          } else {
#pragma unroll
            for (int e = 0; e < W; ++e)
              if (in[e]) out[e] = z[e];
          }
        }
#pragma unroll
        for (int e = 0; e < W; ++e) {
          ca[e] += in[e] ? g[e] : 0.f;
          cb[e] += in[e] ? g[e] * ((xv[e] - m) * iv) : 0.f;
        }
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      a += ca[e];
      b += cb[e];
    }
  }

  block_sum2(a, b);
  if (threadIdx.x == 0) {
    blk[0] = a;
    blk[1] = b;
  }
  cluster.sync();  // every block of the channel has written blk
  if (rank == 0 && threadIdx.x == 0) {
    double sa = 0.0, sb = 0.0;
    for (unsigned q = 0; q < P; ++q) {
      const float* rb = cluster.map_shared_rank(blk, q);
      sa += rb[0];
      sb += rb[1];
    }
    sdz[c] = static_cast<float>(sa);
    sdx[c] = static_cast<float>(sb);
  }
  cluster.sync();  // no block leaves while rank 0 reads its blk
}

template <typename T, typename I, int W, bool kRelu>
cudaError_t bn_bwd_reduce_launch(const T* dy, const T* y, const T* x,
                                 const float* mean, const float* inv, T* dz,
                                 int64_t N, int64_t C, int64_t S, int o0,
                                 int P, float* sdz, float* sdx,
                                 cudaStream_t st) {
  // units a row: the vectors a row covers where it starts latest in its
  // first vector (row starts o0 + m S fall on o0 mod gcd(S, W))
  const int64_t g = gcd(S, W);
  const int64_t Q = (W - g + o0 % g + S - 1) / W + 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(C * P));
  cfg.blockDim = dim3(kReduceThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(P);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, bn_bwd_reduce_kernel<T, I, W, kRelu>, dy, y, x, mean, inv, dz,
      static_cast<I>(N), static_cast<I>(C), static_cast<I>(S),
      static_cast<I>(Q), static_cast<I>(o0), sdz, sdx);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

// p less o elements (null stays null)
template <typename T>
T* back(const void* p, int o) {
  return p == nullptr ? nullptr
                      : reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(p) -
                                             o * sizeof(T));
}

template <typename T, typename I, bool kRelu>
cudaError_t bn_bwd_reduce_width(const void* dy, const void* y, const void* x,
                                const float* mean, const float* inv, void* dz,
                                int64_t N, int64_t C, int64_t S, int o0,
                                bool vec, int P, float* sdz, float* sdx,
                                cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  if (vec)
    return bn_bwd_reduce_launch<T, I, V, kRelu>(
        back<const T>(dy, o0), back<const T>(y, o0), back<const T>(x, o0),
        mean, inv, back<T>(dz, o0), N, C, S, o0, P, sdz, sdx, st);
  return bn_bwd_reduce_launch<T, I, 1, kRelu>(
      static_cast<const T*>(dy), static_cast<const T*>(y),
      static_cast<const T*>(x), mean, inv, static_cast<T*>(dz), N, C, S, 0,
      P, sdz, sdx, st);
}

// cudaOccupancyMaxActiveClusters of K3c's vector kernel at clusters of P
template <typename T, bool kRelu>
cudaError_t bn_bwd_reduce_max_clusters(int P, int* n) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(P));
  cfg.blockDim = dim3(kReduceThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(P);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      n, bn_bwd_reduce_kernel<T, uint32_t, Vec<T>::V, kRelu>, &cfg);
  if (e != cudaSuccess) cudaGetLastError();  // not left for the next launch
  return e;
}

// K3c's launch: 16-byte vectors where dy, x (and y, dz) share one offset
// mod 16 bytes (o0 elements), else single elements; 32-bit offsets while
// the last vector's end fits
template <typename T>
cudaError_t bn_bwd_reduce_entry(const void* dy, const void* y, const void* x,
                                const float* mean, const float* inv, void* dz,
                                int64_t N, int64_t C, int64_t S, int P,
                                float* sdz, float* sdx, cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  const uintptr_t o = reinterpret_cast<uintptr_t>(dy) & 15u;
  bool vec = o % sizeof(T) == 0 &&
             (reinterpret_cast<uintptr_t>(x) & 15u) == o;
  if (y != nullptr)
    vec = vec && (reinterpret_cast<uintptr_t>(y) & 15u) == o &&
          (reinterpret_cast<uintptr_t>(dz) & 15u) == o;
  const int o0 = vec ? static_cast<int>(o / sizeof(T)) : 0;
  const bool small = N * C * S + 2 * V <= INT32_MAX;
  if (y != nullptr)
    return small ? bn_bwd_reduce_width<T, uint32_t, true>(
                       dy, y, x, mean, inv, dz, N, C, S, o0, vec, P, sdz,
                       sdx, st)
                 : bn_bwd_reduce_width<T, int64_t, true>(
                       dy, y, x, mean, inv, dz, N, C, S, o0, vec, P, sdz,
                       sdx, st);
  return small ? bn_bwd_reduce_width<T, uint32_t, false>(
                     dy, y, x, mean, inv, dz, N, C, S, o0, vec, P, sdz, sdx,
                     st)
               : bn_bwd_reduce_width<T, int64_t, false>(
                     dy, y, x, mean, inv, dz, N, C, S, o0, vec, P, sdz, sdx,
                     st);
}

// ---------------------------------------------------------------------------
// K3b and K3d: one flat pass with a per-channel affine expression
// ---------------------------------------------------------------------------

// K3b: z = [relu](x * scale + offset [+ residual]); streams x [, residual]
template <bool kRes, bool kRelu>
struct ApplyOp {
  static constexpr int kIn = kRes ? 2 : 1, kCoef = 2;
  __device__ __forceinline__ float operator()(const float (&v)[kIn],
                                              const float (&k)[kCoef]) const {
    float z = v[0] * k[0] + k[1];
    if constexpr (kRes) z += v[1];
    if constexpr (kRelu) z = fmaxf(z, 0.f);
    return z;
  }
};

// K3d: dx = dz * c1 + x * c2 + c3; streams dz, x
struct DxOp {
  static constexpr int kIn = 2, kCoef = 3;
  __device__ __forceinline__ float operator()(const float (&v)[kIn],
                                              const float (&k)[kCoef]) const {
    return v[0] * k[0] + v[1] * k[1] + k[2];
  }
};

// the streamed operands, the per-channel coefficients and the output
template <typename T, typename Op>
struct FlatArgs {
  const T* in[Op::kIn];
  const float* coef[Op::kCoef];
  T* out;
};

// op over the W elements from flat index i0 of [N, C, S]
template <typename I, int W, typename Op>
__device__ __forceinline__ void flat_unit(
    float (&o)[W], const float (&v)[Op::kIn][W], I i0, I S, I C,
    FastDiv dS, FastDiv dC, const float* const (&coef)[Op::kCoef]) {
  constexpr int K = Op::kCoef;
  const Op op{};
  const I row = divide(i0, S, dS);
  const I s = i0 - row * S;
  const I c = row - divide(row, C, dC) * C;
  float x[Op::kIn], k[K];
  if (W == 1 || S >= W) {  // at most one row end inside the unit
    float a[K], b[K];
#pragma unroll
    for (int j = 0; j < K; ++j) a[j] = b[j] = __ldg(coef[j] + c);
    const I left = S - s;  // elements of the unit in row `row`
    if (W > 1 && left < W) {
      const I cn = c + 1 == C ? 0 : c + 1;
#pragma unroll
      for (int j = 0; j < K; ++j) b[j] = __ldg(coef[j] + cn);
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const bool first = e < left;
#pragma unroll
      for (int j = 0; j < K; ++j) k[j] = first ? a[j] : b[j];
#pragma unroll
      for (int i = 0; i < Op::kIn; ++i) x[i] = v[i][e];
      o[e] = op(x, k);
    }
  } else {  // S < W: the unit may cross several row ends
    I ss = s, cc = c;
#pragma unroll
    for (int e = 0; e < W; ++e) {
#pragma unroll
      for (int j = 0; j < K; ++j) k[j] = __ldg(coef[j] + cc);
#pragma unroll
      for (int i = 0; i < Op::kIn; ++i) x[i] = v[i][e];
      o[e] = op(x, k);
      if (++ss == S) {
        ss = 0;
        if (++cc == C) cc = 0;
      }
    }
  }
}

// U units of W elements in flight per thread and trip; then the n % W
// elements after the last whole unit, one a thread
template <typename T, typename I, int W, int U, typename Op>
__global__ void __launch_bounds__(kThreads)
    bn_flat_kernel(const FlatArgs<T, Op> p, I n, I S, I C, FastDiv dS,
                   FastDiv dC) {
  constexpr int kIn = Op::kIn;
  const I units = n / W;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  const I g = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (I u0 = g; u0 < units; u0 += U * stride) {
    float v[U][kIn][W];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const I u = u0 + j * stride;
      if (u < units) {
#pragma unroll
        for (int i = 0; i < kIn; ++i) load_w<T, W>(p.in[i] + u * W, v[j][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const I u = u0 + j * stride;
      if (u < units) {
        float o[W];
        flat_unit<I, W, Op>(o, v[j], u * W, S, C, dS, dC, p.coef);
        store_w<T, W>(p.out + u * W, o);
      }
    }
  }
  if (W > 1 && g < n - units * W) {
    const I i = units * W + g;
    float v1[kIn][1], o1[1];
#pragma unroll
    for (int k = 0; k < kIn; ++k) v1[k][0] = to_f(p.in[k][i]);
    flat_unit<I, 1, Op>(o1, v1, i, S, C, dS, dC, p.coef);
    p.out[i] = from_f<T>(o1[0]);
  }
}

template <typename T, typename I, int W, typename Op>
cudaError_t flat_launch(const FlatArgs<T, Op>& a, int64_t n, int64_t C,
                        int64_t S, cudaStream_t st) {
  constexpr int U = 4;
  const auto kernel = bn_flat_kernel<T, I, W, U, Op>;
  // as many blocks as the SMs hold at once (each thread then walks its
  // share of the tensor), fewer for a small tensor
  static const int resident = [&] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    return sms * per_sm > 0 ? sms * per_sm : 132;
  }();
  const int64_t units = n / W;
  const int64_t need = (units + kThreads * U - 1) / (kThreads * U);
  const int blocks = static_cast<int>(
      need < 1 ? 1 : (need < resident ? need : resident));
  kernel<<<blocks, kThreads, 0, st>>>(
      a, static_cast<I>(n), static_cast<I>(S), static_cast<I>(C),
      fast_div(static_cast<uint32_t>(S)), fast_div(static_cast<uint32_t>(C)));
  return cudaGetLastError();
}

// 16-byte vectors where every streamed pointer is 16-byte aligned, else
// single elements; 32-bit indices below 2^31 elements
template <typename T, typename Op>
cudaError_t flat_entry(const FlatArgs<T, Op>& a, int64_t n, int64_t C,
                       int64_t S, cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  bool vec = aligned16(a.out);
  for (int i = 0; i < Op::kIn; ++i) vec = vec && aligned16(a.in[i]);
  if (n <= INT32_MAX)
    return vec ? flat_launch<T, uint32_t, V, Op>(a, n, C, S, st)
               : flat_launch<T, uint32_t, 1, Op>(a, n, C, S, st);
  return vec ? flat_launch<T, int64_t, V, Op>(a, n, C, S, st)
             : flat_launch<T, int64_t, 1, Op>(a, n, C, S, st);
}

template <typename T, typename Op>
cudaError_t bn_apply_launch(const T* x, const T* residual, const float* scale,
                            const float* offset, T* y, int64_t n, int64_t C,
                            int64_t S, cudaStream_t st) {
  FlatArgs<T, Op> a;
  a.in[0] = x;
  if constexpr (Op::kIn == 2) a.in[1] = residual;
  a.coef[0] = scale;
  a.coef[1] = offset;
  a.out = y;
  return flat_entry<T, Op>(a, n, C, S, st);
}

template <typename T, bool kRes>
cudaError_t bn_apply_entry(const void* x, const void* scale,
                           const void* offset, const void* residual, void* y,
                           int64_t n, int64_t C, int64_t S, int relu,
                           cudaStream_t st) {
  const T* xv = static_cast<const T*>(x);
  const T* rv = static_cast<const T*>(residual);
  const float* k0 = static_cast<const float*>(scale);
  const float* k1 = static_cast<const float*>(offset);
  T* out = static_cast<T*>(y);
  return relu ? bn_apply_launch<T, ApplyOp<kRes, true>>(xv, rv, k0, k1, out,
                                                        n, C, S, st)
              : bn_apply_launch<T, ApplyOp<kRes, false>>(xv, rv, k0, k1, out,
                                                         n, C, S, st);
}

template <typename T>
cudaError_t bn_dx_entry(const void* dz, const void* x, const void* c1,
                        const void* c2, const void* c3, void* dx, int64_t n,
                        int64_t C, int64_t S, cudaStream_t st) {
  FlatArgs<T, DxOp> a;
  a.in[0] = static_cast<const T*>(dz);
  a.in[1] = static_cast<const T*>(x);
  a.coef[0] = static_cast<const float*>(c1);
  a.coef[1] = static_cast<const float*>(c2);
  a.coef[2] = static_cast<const float*>(c3);
  a.out = static_cast<T*>(dx);
  return flat_entry<T, DxOp>(a, n, C, S, st);
}

}  // namespace

#define MXTT_DISPATCH(dtype, T, ...)   \
  if ((dtype) == 0) {                  \
    using T = float;                   \
    __VA_ARGS__;                       \
  } else if ((dtype) == 1) {           \
    using T = __nv_bfloat16;           \
    __VA_ARGS__;                       \
  } else {                             \
    return cudaErrorInvalidValue;      \
  }

// K3a. P: blocks a channel group (the cluster size, 1 to 8); part: unused
// (K3a keeps no workspace; the argument keeps the entry's signature);
// mean, var: float32 [C].
extern "C" int mxtt_bn_stats(int dtype, const void* x, int64_t N, int64_t C,
                             int64_t S, int P, float inv_m, void* part,
                             void* mean, void* var, void* stream) {
  (void)part;
  if (P < 1 || P > 8) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MXTT_DISPATCH(dtype, T,
                return static_cast<int>(bn_stats_entry<T>(
                    x, N, C, S, P, inv_m, static_cast<float*>(mean),
                    static_cast<float*>(var), st)));
}

// K3b. residual may be null; scale, offset: float32 [C].
extern "C" int mxtt_bn_apply(int dtype, const void* x, const void* scale,
                             const void* offset, const void* residual,
                             void* y, int64_t N, int64_t C, int64_t S,
                             int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = N * C * S;
  if (residual != nullptr) {
    MXTT_DISPATCH(dtype, T,
                  return static_cast<int>(bn_apply_entry<T, true>(
                      x, scale, offset, residual, y, n, C, S, relu, st)));
  }
  MXTT_DISPATCH(dtype, T,
                return static_cast<int>(bn_apply_entry<T, false>(
                    x, scale, offset, nullptr, y, n, C, S, relu, st)));
}

// K3c. y and dz are null without relu; P: blocks a channel (the cluster
// size, 1 to 8); part: unused (K3c keeps no workspace; the argument keeps
// the entry's signature); sdz, sdx: float32 [C].
extern "C" int mxtt_bn_bwd_reduce(int dtype, const void* dy, const void* y,
                                  const void* x, const void* mean,
                                  const void* inv, void* dz, int64_t N,
                                  int64_t C, int64_t S, int P, void* part,
                                  void* sdz, void* sdx, void* stream) {
  (void)part;
  if (P < 1 || P > 8) return cudaErrorInvalidValue;
  if ((y == nullptr) != (dz == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MXTT_DISPATCH(dtype, T,
                return static_cast<int>(bn_bwd_reduce_entry<T>(
                    dy, y, x, static_cast<const float*>(mean),
                    static_cast<const float*>(inv), dz, N, C, S, P,
                    static_cast<float*>(sdz), static_cast<float*>(sdx), st)));
}

// How many clusters of P K3c blocks (relu 0 or 1) the card runs at once
// (cudaOccupancyMaxActiveClusters); a negative value is a CUDA error.
extern "C" int mxtt_bn_reduce_max_clusters(int dtype, int relu, int P) {
  if (P < 1 || P > 8) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
  MXTT_DISPATCH(dtype, T,
                e = relu ? bn_bwd_reduce_max_clusters<T, true>(P, &n)
                         : bn_bwd_reduce_max_clusters<T, false>(P, &n));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// K3d. c1, c2, c3: float32 [C].
extern "C" int mxtt_bn_bwd_dx(int dtype, const void* dz, const void* x,
                              const void* c1, const void* c2, const void* c3,
                              void* dx, int64_t N, int64_t C, int64_t S,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MXTT_DISPATCH(dtype, T,
                return static_cast<int>(bn_dx_entry<T>(
                    dz, x, c1, c2, c3, dx, N * C * S, C, S, st)));
}

#undef MXTT_DISPATCH

extern "C" const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
