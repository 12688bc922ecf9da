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
// computes them outside its kernels. Offsets are 64-bit: the stem
// activation of a batch-256 ResNet-50 step is 205.5 M elements.
//
// What bounds them: device-memory bytes. Each reads one to three
// activation-sized tensors and writes at most one, with 3 to 6 flops an
// element (mxnet_tpu_torch/ops/fused_bn.py fused_bn_call_cost, the
// reference's declared costs): under one flop a byte, far below the card's
// float32 ridge of about 20.
//
// What the design does about it: every element is read once and written
// once, in 16-byte vector loads and stores where alignment allows, with a
// grid sized to fill the 132 SMs several times over.
//   * K3a and K3c: grid of C x P blocks, block (c, p) summing the p-th of P
//     equal chunks of channel c's N * S elements into float32 partials
//     (a warp-shuffle then shared-memory tree, in a fixed order), written
//     to a [2, C, P] workspace. A second tiny kernel adds each channel's P
//     partials in a fixed order (in double) and emits the result. There
//     are no atomics, so a result repeats bit for bit from run to run.
//     The reference carried its sums across a sequential TPU grid in
//     scratch memory; Hopper's blocks run in no order, hence the two
//     passes. A chunk walks its elements in S-long runs' order; with
//     S % V == 0 (V = 16 bytes / sizeof(T)) each thread takes whole
//     vectors, else single elements.
//   * K3b: one flat grid-stride pass over the N * C * S elements, V
//     consecutive elements a thread, c = (i / S) % C computed once a
//     vector (in 32 bits where the tensor has fewer than 2^31 elements)
//     and stepped across row ends inside it.
//   * K3d: a flat pass of its own, with few instructions a byte. On the
//     K3b-shaped pass it ran at 2.5x its bytes bound in bfloat16 and 1.7x
//     in float32 (more elements a byte, more time over the bound): it
//     issued three coefficient loads an element, per-element guards for a
//     runtime vector width, and 64-bit index arithmetic. Here the vector
//     width W is a compile-time constant (16 bytes' worth, or 1 where a
//     pointer is not 16-byte aligned; an n % W tail is a separate scalar
//     step), vectors are cut from the flat tensor (so alignment depends on
//     the base pointers alone, and S = 49 or 196 in bfloat16 keeps whole
//     vectors), and (c, s) is computed once a vector, in 32 bits by a
//     multiply and shift where n < 2^31. For S >= W a vector spans at most
//     two channels: c's coefficients are loaded once, c + 1's only when
//     the vector crosses a row end (S < W keeps a general per-element
//     walk, right for S = 1). Each thread has four independent vectors in
//     flight an iteration, over a grid of as many blocks as the SMs hold
//     at once. The expression and its order are those of the K3b-shaped
//     pass: dx = dz * c1 + x * c2 + c3 in float32, rounded once.
//
// The kernels launch on the caller's stream, allocate nothing (the
// wrapper allocates outputs and the workspace) and do not synchronise;
// each C entry returns cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// K3a: per-channel partial sums of x and x^2
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, int64_t C, int64_t S, int64_t M,
                    int P, int vec, float* __restrict__ part) {
  constexpr int V = Vec<T>::V;
  const Chunk k = chunk_of(C, S, M, P, vec ? V : 1);
  const bool small = M <= INT32_MAX;
  float a = 0.f, b = 0.f;
  for (int64_t u = k.u0 + threadIdx.x; u < k.u1; u += blockDim.x) {
    const int64_t j = u * k.unit;
    const int64_t n = div_idx(j, S, small);
    const int64_t off = (n * C + k.c) * S + (j - n * S);
    if (vec) {
      float v[V];
      load_vec(x + off, v);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        a += v[e];
        b += v[e] * v[e];
      }
    } else {
      const float v = to_f(x[off]);
      a += v;
      b += v * v;
    }
  }
  block_sum2(a, b);
  if (threadIdx.x == 0) {
    part[k.c * P + blockIdx.x % P] = a;
    part[(C + k.c) * P + blockIdx.x % P] = b;
  }
}

// ---------------------------------------------------------------------------
// K3c: relu mask, dz store, per-channel partial sums of dz and dz * xhat
// ---------------------------------------------------------------------------

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

// Each channel's P partials added in a fixed order (in double). stats:
// out0 = mean, out1 = var = max(E[x^2] - mean^2, 0); else the two sums.
__global__ void bn_combine_kernel(const float* __restrict__ part, int64_t C,
                                  int P, float inv_m, int stats,
                                  float* __restrict__ out0,
                                  float* __restrict__ out1) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (c >= C) return;
  double a = 0.0, b = 0.0;
  for (int p = 0; p < P; ++p) {
    a += part[c * P + p];
    b += part[(C + c) * P + p];
  }
  if (stats) {
    const float m = static_cast<float>(a) * inv_m;
    const float q = static_cast<float>(b) * inv_m;
    out0[c] = m;
    out1[c] = fmaxf(q - m * m, 0.f);
  } else {
    out0[c] = static_cast<float>(a);
    out1[c] = static_cast<float>(b);
  }
}

// ---------------------------------------------------------------------------
// K3b and K3d: flat elementwise passes with a per-channel affine
// ---------------------------------------------------------------------------

// K3b: op(x, r) = x * p0[c] + p1[c] (+ r) (then relu)
// K3d: op(x, r) = r * p0[c] + x * p1[c] + p2[c]  (r = dz)
template <typename T, bool kDx>
__global__ void __launch_bounds__(kThreads)
    bn_affine_kernel(const T* __restrict__ x, const T* __restrict__ r,
                     const float* __restrict__ p0,
                     const float* __restrict__ p1,
                     const float* __restrict__ p2, T* __restrict__ out,
                     int64_t n, int64_t C, int64_t S, int relu, int vec) {
  constexpr int V = Vec<T>::V;
  const int unit = vec ? V : 1;
  const int64_t units = (n + unit - 1) / unit;
  const bool small = n <= INT32_MAX;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       u < units; u += stride) {
    const int64_t i0 = u * unit;
    const int64_t row = div_idx(i0, S, small);
    int64_t s = i0 - row * S;
    int64_t c = row - div_idx(row, C, small) * C;
    float xv[V], rv[V], o[V];
    const bool whole = vec && i0 + V <= n;
    const int cnt = whole ? V : static_cast<int>(n - i0 < unit ? n - i0
                                                               : unit);
    if (whole) {
      load_vec(x + i0, xv);
      if (r != nullptr) load_vec(r + i0, rv);
    } else {
      for (int e = 0; e < cnt; ++e) {
        xv[e] = to_f(x[i0 + e]);
        rv[e] = r != nullptr ? to_f(r[i0 + e]) : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (e < cnt) {
        float z;
        if (kDx) {
          z = rv[e] * p0[c] + xv[e] * p1[c] + p2[c];
        } else {
          z = xv[e] * p0[c] + p1[c];
          if (r != nullptr) z += rv[e];
          if (relu) z = fmaxf(z, 0.f);
        }
        o[e] = z;
        if (++s == S) {
          s = 0;
          if (++c == C) c = 0;
        }
      }
    }
    if (whole) {
      store_vec(out + i0, o);
    } else {
      for (int e = 0; e < cnt; ++e) out[i0 + e] = from_f<T>(o[e]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3d: dx = c1[c] dz + c2[c] x + c3[c]
// ---------------------------------------------------------------------------

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

// dx over the W elements from flat index i0 of [N, C, S]
template <typename I, int W>
__device__ __forceinline__ void dx_unit(float (&o)[W], const float (&d)[W],
                                        const float (&xv)[W], I i0, I S,
                                        I C, FastDiv dS, FastDiv dC,
                                        const float* __restrict__ c1,
                                        const float* __restrict__ c2,
                                        const float* __restrict__ c3) {
  const I row = divide(i0, S, dS);
  const I s = i0 - row * S;
  const I c = row - divide(row, C, dC) * C;
  if (W == 1 || S >= W) {  // at most one row end inside the unit
    const float a1 = __ldg(c1 + c), a2 = __ldg(c2 + c), a3 = __ldg(c3 + c);
    float b1 = a1, b2 = a2, b3 = a3;
    const I left = S - s;  // elements of the unit in row `row`
    if (W > 1 && left < W) {
      const I cn = c + 1 == C ? 0 : c + 1;
      b1 = __ldg(c1 + cn);
      b2 = __ldg(c2 + cn);
      b3 = __ldg(c3 + cn);
    }
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const bool first = e < left;
      o[e] = d[e] * (first ? a1 : b1) + xv[e] * (first ? a2 : b2) +
             (first ? a3 : b3);
    }
  } else {  // S < W: the unit may cross several row ends
    I ss = s, cc = c;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      o[e] = d[e] * __ldg(c1 + cc) + xv[e] * __ldg(c2 + cc) + __ldg(c3 + cc);
      if (++ss == S) {
        ss = 0;
        if (++cc == C) cc = 0;
      }
    }
  }
}

// U units of W elements in flight per thread and trip; then the n % W
// elements after the last whole unit, one a thread
template <typename T, typename I, int W, int U>
__global__ void __launch_bounds__(kThreads)
    bn_dx_kernel(const T* __restrict__ dz, const T* __restrict__ x,
                 const float* __restrict__ c1, const float* __restrict__ c2,
                 const float* __restrict__ c3, T* __restrict__ dx, I n, I S,
                 I C, FastDiv dS, FastDiv dC) {
  const I units = n / W;
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  const I g = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (I u0 = g; u0 < units; u0 += U * stride) {
    float d[U][W], xv[U][W];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const I u = u0 + j * stride;
      if (u < units) {
        load_w<T, W>(dz + u * W, d[j]);
        load_w<T, W>(x + u * W, xv[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const I u = u0 + j * stride;
      if (u < units) {
        float o[W];
        dx_unit<I, W>(o, d[j], xv[j], u * W, S, C, dS, dC, c1, c2, c3);
        store_w<T, W>(dx + u * W, o);
      }
    }
  }
  if (W > 1 && g < n - units * W) {
    const I i = units * W + g;
    float d1[1] = {to_f(dz[i])}, x1[1] = {to_f(x[i])}, o1[1];
    dx_unit<I, 1>(o1, d1, x1, i, S, C, dS, dC, c1, c2, c3);
    dx[i] = from_f<T>(o1[0]);
  }
}

template <typename T, typename I, int W>
cudaError_t bn_dx(const T* dz, const T* x, const float* c1, const float* c2,
                  const float* c3, T* dx, int64_t n, int64_t C, int64_t S,
                  cudaStream_t st) {
  constexpr int U = 4;
  const auto kernel = bn_dx_kernel<T, I, W, U>;
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
      dz, x, c1, c2, c3, dx, static_cast<I>(n), static_cast<I>(S),
      static_cast<I>(C), fast_div(static_cast<uint32_t>(S)),
      fast_div(static_cast<uint32_t>(C)));
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int elem_size(int dtype) { return dtype == 0 ? 4 : 2; }

int affine_blocks(int64_t units) {
  // at most 32 blocks of 256 threads an SM on 132 SMs; fewer for a
  // small tensor
  const int64_t most = 132 * 32;
  const int64_t need = (units + kThreads - 1) / kThreads;
  return static_cast<int>(need < most ? (need > 0 ? need : 1) : most);
}

// K3d's launch: 16-byte vectors where dz, x and dx are 16-byte aligned,
// else single elements; 32-bit indices below 2^31 elements.
template <typename T>
cudaError_t bn_dx_entry(const void* dz, const void* x, const void* c1,
                        const void* c2, const void* c3, void* dx, int64_t n,
                        int64_t C, int64_t S, cudaStream_t st) {
  constexpr int V = Vec<T>::V;
  const T* d = static_cast<const T*>(dz);
  const T* xv = static_cast<const T*>(x);
  const float* a = static_cast<const float*>(c1);
  const float* b = static_cast<const float*>(c2);
  const float* c = static_cast<const float*>(c3);
  T* out = static_cast<T*>(dx);
  const bool vec = aligned16(dz) && aligned16(x) && aligned16(dx);
  if (n <= INT32_MAX)
    return vec ? bn_dx<T, uint32_t, V>(d, xv, a, b, c, out, n, C, S, st)
               : bn_dx<T, uint32_t, 1>(d, xv, a, b, c, out, n, C, S, st);
  return vec ? bn_dx<T, int64_t, V>(d, xv, a, b, c, out, n, C, S, st)
             : bn_dx<T, int64_t, 1>(d, xv, a, b, c, out, n, C, S, st);
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

// K3a. part: float32 [2, C, P] workspace; mean, var: float32 [C].
extern "C" int mxtt_bn_stats(int dtype, const void* x, int64_t N, int64_t C,
                             int64_t S, int P, float inv_m, void* part,
                             void* mean, void* var, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = 16 / elem_size(dtype);
  const int vec = (S % V == 0) && aligned16(x);
  float* pt = static_cast<float*>(part);
  MXTT_DISPATCH(dtype, T,
                bn_stats_kernel<T><<<static_cast<unsigned>(C * P), kThreads,
                                     0, st>>>(static_cast<const T*>(x), C, S,
                                              N * S, P, vec, pt));
  bn_combine_kernel<<<static_cast<unsigned>((C + 127) / 128), 128, 0, st>>>(
      pt, C, P, inv_m, 1, static_cast<float*>(mean),
      static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}

// K3b. residual may be null; scale, offset: float32 [C].
extern "C" int mxtt_bn_apply(int dtype, const void* x, const void* scale,
                             const void* offset, const void* residual,
                             void* y, int64_t N, int64_t C, int64_t S,
                             int relu, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = 16 / elem_size(dtype);
  const int64_t n = N * C * S;
  const int vec = aligned16(x) && aligned16(y) &&
                  (residual == nullptr || aligned16(residual));
  const int blocks = affine_blocks(vec ? (n + V - 1) / V : n);
  MXTT_DISPATCH(dtype, T,
                bn_affine_kernel<T, false><<<blocks, kThreads, 0, st>>>(
                    static_cast<const T*>(x), static_cast<const T*>(residual),
                    static_cast<const float*>(scale),
                    static_cast<const float*>(offset), nullptr,
                    static_cast<T*>(y), n, C, S, relu, vec));
  return static_cast<int>(cudaGetLastError());
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
      pt, C, P, 0.f, 0, static_cast<float*>(sdz), static_cast<float*>(sdx));
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
