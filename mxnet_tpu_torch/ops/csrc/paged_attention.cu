// Ragged paged attention for Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas_paged.py::_kernel, the TPU kernel that
// runs every paged decode step, every chunked-prefill step and every
// speculative scoring pass of the serving engine (one launch per layer),
// over a float32 / bfloat16 pool or, with `quant=True`, an int8 pool.
//
// What it computes: for each batch row b, head h and query row i,
//   out[b, i, h] = softmax_t(q[b, i, h] . K[t] * scale) @ V
// over the keys of row b's block table whose position t is <= q_start[b]+i
// (the ragged mask, which is also the causal mask inside a prefill chunk).
// Softmax statistics and the accumulator are float32 whatever the pool
// dtype; the output is written in the pool dtype as acc / max(l, 1e-20),
// with the same -inf guards as the reference's online softmax.
//
// The int8 variant (the reference's quant=True branch): the pools hold
// int8 and two (num_blocks, H) float32 tables hold one scale per (block,
// head). Each live block is dequantized while it is staged into shared
// memory, k = float(k_int8) * k_scale[block, h] (and likewise v), before
// any product, in the reference's order; everything after staging is the
// float kernel's, statistics in float32, output in q's dtype (float32 or
// bfloat16). Only the scales of live blocks are read.
//
// What bounds it: device-memory bytes (mxnet_tpu_torch/ops/paged_attention.py
// paged_call_cost). Each key and value element is used by Tq query rows
// for 2 flops each: Tq / 2 flops per float32 byte, 0.5 at decode (Tq = 1)
// and 16 at a 32-row prefill chunk, under the card's float32 ridge of
// about 20 (67 TFLOP/s over 3.35 TB/s). An int8 pool moves a quarter of
// the float32 pool's K/V bytes for the same flops.
//
// What the design does about it:
//   * it reads only live blocks: a query row at position p walks table
//     slots 0 .. p / block_size and never touches a dead slot, so the
//     bytes follow the true sequence lengths, not the padded table width;
//   * scores and probabilities never leave the chip: each block of K and
//     V is staged once in shared memory, scored and folded into an online
//     softmax held in registers; nothing but the output is written back.
//
// Layout. Grid (B * H, Tq): one thread block per (row b, head h, query
// row i), four warps each. The warps split the row's live table slots
// (warp w takes slots w, w + 4, ...), each with its own shared-memory
// copy of one (block_size, Dh) K and V slice, converted to float32, and
// its own running max / denominator / accumulator (lane l holds output
// columns l, l + 32, ...). The block reads q_start[b] and its own table
// row from device memory (Hopper has no scalar prefetch). At the end the
// four partial softmaxes are merged through shared memory. A pool token
// is H * Dh elements apart from the next one; the K/V slice of head h
// starts h * Dh into it.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;  // paged_attention.py _WARPS must match
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Shared memory, in floats: the query row, each warp's K and V slices
// (rows padded to Dh + 1 so that lanes reading one column of different
// rows hit different banks), and the merge area (max, denominator and
// accumulator of every warp). paged_attention.py _smem_bytes must match.
__host__ __device__ inline size_t smem_floats(int Dh, int bs) {
  return (size_t)Dh + (size_t)kWarps * 2 * bs * (Dh + 1) +
         (size_t)kWarps * (Dh + 2);
}

// T: q and out; P: the pools (T, or int8_t with the scale tables);
// NC = Dh / 32 output columns per lane
template <typename T, typename P, int NC>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const P* __restrict__ k_pool,
                           const P* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ tables,
                           const int* __restrict__ q_start,
                           T* __restrict__ out, int Tq, int H, int w, int bs,
                           float scale) {
  constexpr int Dh = NC * 32;
  constexpr int ld = Dh + 1;
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* q_s = smem;
  float* k_s = smem + Dh + (size_t)warp * 2 * bs * ld;
  float* v_s = k_s + (size_t)bs * ld;
  float* m_s = smem + Dh + (size_t)kWarps * 2 * bs * ld;
  float* l_s = m_s + kWarps;
  float* a_s = l_s + kWarps;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int i = blockIdx.y;
  const int qpos = q_start[b] + i;  // true position of this query row
  const long long tok = (long long)H * Dh;
  const long long row = ((long long)b * Tq + i) * H + h;

  for (int d = threadIdx.x; d < Dh; d += kThreads)
    q_s[d] = to_f32(q[row * Dh + d]);
  __syncthreads();

  // the last table slot holding a key at or before qpos; slots past it
  // are dead for this row and are never read
  int last = qpos / bs;
  if (last > w - 1) last = w - 1;
  const int* tab = tables + (long long)b * w;

  float m = -INFINITY;
  float l = 0.f;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int j = warp; j <= last; j += kWarps) {
    const int blk = tab[j];
    const long long base = (long long)blk * bs * tok + (long long)h * Dh;
    __syncwarp();  // the previous slot's reads are done before overwriting
    if constexpr (kQuant) {
      // dequantize while staging: one scale per (block, head)
      const float ks = k_scale[(long long)blk * H + h];
      const float vs = v_scale[(long long)blk * H + h];
      for (int e = lane; e < bs * Dh; e += 32) {
        const int t = e / Dh;
        const int d = e - t * Dh;
        k_s[t * ld + d] = to_f32(k_pool[base + t * tok + d]) * ks;
        v_s[t * ld + d] = to_f32(v_pool[base + t * tok + d]) * vs;
      }
    } else {
      for (int e = lane; e < bs * Dh; e += 32) {
        const int t = e / Dh;
        const int d = e - t * Dh;
        k_s[t * ld + d] = to_f32(k_pool[base + t * tok + d]);
        v_s[t * ld + d] = to_f32(v_pool[base + t * tok + d]);
      }
    }
    __syncwarp();
    // keys of this block, 32 at a time: lane u scores key t0 + u
    for (int t0 = 0; t0 < bs; t0 += 32) {
      const int t = t0 + lane;
      const bool live = t < bs && j * bs + t <= qpos;
      float s = -INFINITY;
      if (live) {
        const float* kr = k_s + t * ld;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < Dh; ++d) dot = fmaf(q_s[d], kr[d], dot);
        s = dot * scale;
      }
      const float m_new = fmaxf(m, warp_max(s));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = live ? expf(s - m_safe) : 0.f;
      const float alpha = isfinite(m) ? expf(m - m_safe) : 0.f;
      l = alpha * l + warp_sum(p);
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] *= alpha;
      const int nt = min(32, bs - t0);
      for (int u = 0; u < nt; ++u) {
        const float pu = __shfl_sync(kFull, p, u);
        const float* vr = v_s + (t0 + u) * ld;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[c] = fmaf(pu, vr[lane + 32 * c], acc[c]);
      }
      m = m_new;
    }
  }

  // merge the four warps' partial softmaxes
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) a_s[warp * Dh + lane + 32 * c] = acc[c];
  __syncthreads();
  float mx = -INFINITY;
  for (int u = 0; u < kWarps; ++u) mx = fmaxf(mx, m_s[u]);
  const float mx_safe = isfinite(mx) ? mx : 0.f;
  float wt[kWarps];
  float den = 0.f;
  for (int u = 0; u < kWarps; ++u) {
    wt[u] = isfinite(m_s[u]) ? expf(m_s[u] - mx_safe) : 0.f;
    den += wt[u] * l_s[u];
  }
  den = fmaxf(den, 1e-20f);
  for (int d = threadIdx.x; d < Dh; d += kThreads) {
    float o = 0.f;
    for (int u = 0; u < kWarps; ++u) o = fmaf(wt[u], a_s[u * Dh + d], o);
    out[row * Dh + d] = from_f32<T>(o / den);
  }
}

template <typename T, typename P, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* q_start, void* out, int B,
                   int Tq, int H, int w, int bs, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(NC * 32, bs) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, P, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B * H, Tq);
  paged_attention_kernel<T, P, NC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), k_scale, v_scale, tables, q_start,
      static_cast<T*>(out), Tq, H, w, bs, scale);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch(int Dh, const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* tables, const int* q_start, void* out, int B,
                     int Tq, int H, int w, int bs, float scale,
                     cudaStream_t stream) {
  switch (Dh) {
#define MXTT_CASE(NC)                                                        \
  case NC * 32:                                                              \
    return launch<T, P, NC>(q, k, v, k_scale, v_scale, tables, q_start, out, \
                            B, Tq, H, w, bs, scale, stream);
    MXTT_CASE(1)
    MXTT_CASE(2)
    MXTT_CASE(3)
    MXTT_CASE(4)
    MXTT_CASE(5)
    MXTT_CASE(6)
    MXTT_CASE(7)
    MXTT_CASE(8)
#undef MXTT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. pool_dtype: the same code
// as dtype, or 2 = int8, which needs k_scale and v_scale, (num_blocks, H)
// float32. q and out are (B, Tq, H, Dh); the pools (num_blocks, bs, H,
// Dh); tables (B, w) int32; q_start (B,) int32. All contiguous on the
// current device. Returns a cudaError_t.
extern "C" int mxtt_paged_attention(int dtype, int pool_dtype, const void* q,
                                    const void* k, const void* v,
                                    const void* k_scale, const void* v_scale,
                                    const void* tables, const void* q_start,
                                    void* out, int B, int Tq, int H, int Dh,
                                    int w, int bs, float scale,
                                    void* stream) {
  const int* tab = static_cast<const int*>(tables);
  const int* qs = static_cast<const int*>(q_start);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pool_dtype == 2 && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && pool_dtype == 0)
    return (int)dispatch<float, float>(Dh, q, k, v, ks, vs, tab, qs, out, B,
                                       Tq, H, w, bs, scale, st);
  if (dtype == 1 && pool_dtype == 1)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(
        Dh, q, k, v, ks, vs, tab, qs, out, B, Tq, H, w, bs, scale, st);
  if (dtype == 0 && pool_dtype == 2)
    return (int)dispatch<float, int8_t>(Dh, q, k, v, ks, vs, tab, qs, out, B,
                                        Tq, H, w, bs, scale, st);
  if (dtype == 1 && pool_dtype == 2)
    return (int)dispatch<__nv_bfloat16, int8_t>(Dh, q, k, v, ks, vs, tab, qs,
                                                out, B, Tq, H, w, bs, scale,
                                                st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
