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
//   * K3c: grid of C x P blocks, block (c, p) summing the p-th of P equal
//     chunks of channel c's N * S elements into float32 partials (a
//     warp-shuffle then shared-memory tree, in a fixed order), written to
//     a [2, C, P] workspace; a second tiny kernel adds each channel's P
//     partials in a fixed order (in double). With S % V == 0 each thread
//     takes whole vectors, else single elements.
//
// The kernels launch on the caller's stream, allocate nothing (the
// wrapper allocates outputs and K3c's workspace) and do not synchronise;
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

// i / d for non-negative i and d; 32-bit division where both fit
__device__ __forceinline__ int64_t div_idx(int64_t i, int64_t d, bool small) {
  return small ? static_cast<int64_t>(static_cast<uint32_t>(i) /
                                      static_cast<uint32_t>(d))
               : i / d;
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
// K3c: relu mask, dz store, per-channel partial sums of dz and dz * xhat
// ---------------------------------------------------------------------------

// The chunk [u0, u1) of channel c's units (a unit is one vector when vec,
// else one element), as 64-bit element offsets: calls f(offset, vec).
struct Chunk {
  int64_t c, u0, u1, unit;
};

__device__ __forceinline__ Chunk chunk_of(int64_t C, int64_t S, int64_t M,
                                          int P, int unit) {
  Chunk k;
  k.c = blockIdx.x / P;
  const int64_t p = blockIdx.x % P;
  const int64_t U = M / unit;
  const int64_t per = (U + P - 1) / P;
  k.u0 = p * per;
  k.u1 = k.u0 + per < U ? k.u0 + per : U;
  k.unit = unit;
  return k;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_reduce_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                         const T* __restrict__ x,
                         const float* __restrict__ mean,
                         const float* __restrict__ inv, T* __restrict__ dz,
                         int64_t C, int64_t S, int64_t M, int P, int vec,
                         float* __restrict__ part) {
  constexpr int V = Vec<T>::V;
  const Chunk k = chunk_of(C, S, M, P, vec ? V : 1);
  const bool small = M <= INT32_MAX;
  const bool relu = y != nullptr;
  const float m = mean[k.c], iv = inv[k.c];
  float a = 0.f, b = 0.f;
  for (int64_t u = k.u0 + threadIdx.x; u < k.u1; u += blockDim.x) {
    const int64_t j = u * k.unit;
    const int64_t n = div_idx(j, S, small);
    const int64_t off = (n * C + k.c) * S + (j - n * S);
    if (vec) {
      float g[V], xv[V];
      load_vec(dy + off, g);
      load_vec(x + off, xv);
      if (relu) {
        float yv[V];
        load_vec(y + off, yv);
#pragma unroll
        for (int e = 0; e < V; ++e)
          g[e] = to_f(from_f<T>(yv[e] > 0.f ? g[e] : 0.f));
        store_vec(dz + off, g);
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        a += g[e];
        b += g[e] * ((xv[e] - m) * iv);
      }
    } else {
      float g = to_f(dy[off]);
      if (relu) {
        const T r = from_f<T>(to_f(y[off]) > 0.f ? g : 0.f);
        dz[off] = r;
        g = to_f(r);
      }
      a += g;
      b += g * ((to_f(x[off]) - m) * iv);
    }
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    part[k.c * P + blockIdx.x % P] = a;
    part[(C + k.c) * P + blockIdx.x % P] = b;
  }
}

// Each channel's P partials added in a fixed order (in double)
__global__ void bn_combine_kernel(const float* __restrict__ part, int64_t C,
                                  int P, float* __restrict__ out0,
                                  float* __restrict__ out1) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= C) return;
  double a = 0.0, b = 0.0;
  for (int p = 0; p < P; ++p) {
    a += part[c * P + p];
    b += part[(C + c) * P + p];
  }
  out0[c] = static_cast<float>(a);
  out1[c] = static_cast<float>(b);
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

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

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

// K3c. y and dz are null without relu; part: float32 [2, C, P]; sdz, sdx:
// float32 [C].
extern "C" int mxtt_bn_bwd_reduce(int dtype, const void* dy, const void* y,
                                  const void* x, const void* mean,
                                  const void* inv, void* dz, int64_t N,
                                  int64_t C, int64_t S, int P, void* part,
                                  void* sdz, void* sdx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((y == nullptr) != (dz == nullptr)) return cudaErrorInvalidValue;
  const int V = 16 / elem_size(dtype);
  const int vec = (S % V == 0) && aligned16(dy) && aligned16(x) &&
                  (y == nullptr || (aligned16(y) && aligned16(dz)));
  float* pt = static_cast<float*>(part);
  MXTT_DISPATCH(dtype, T,
                bn_bwd_reduce_kernel<T><<<static_cast<unsigned>(C * P),
                                          kThreads, 0, st>>>(
                    static_cast<const T*>(dy), static_cast<const T*>(y),
                    static_cast<const T*>(x), static_cast<const float*>(mean),
                    static_cast<const float*>(inv), static_cast<T*>(dz), C, S,
                    N * S, P, vec, pt));
  bn_combine_kernel<<<static_cast<unsigned>((C + 127) / 128), 128, 0, st>>>(
      pt, C, P, static_cast<float*>(sdz), static_cast<float*>(sdx));
  return static_cast<int>(cudaGetLastError());
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
