// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas_attention.py::_kernel, the TPU forward
// kernel (reached through _flash_fwd and flash_attention), and its
// backward _flash_bwd_blockwise (plain lax in the reference, the
// custom_vjp's bwd). The transformer's training step runs one forward
// and one backward per layer when MXNET_FLASH_ATTENTION=1.
//
// What it computes, for each row bh of [BH, T, D] q and [BH, Tk, D] k, v
// (keys after the query masked when causal, which needs Tk == T):
//   forward:  s = q k^T * scale; out = softmax(s) v, plus the float32 row
//             max m and denominator l = sum exp(s - m), [BH, T] each;
//   backward: delta = sum_d dO * O; p = exp(s - m) / l, recomputed;
//             dv = p^T dO; dp = dO v^T; ds = p (dp - delta) scale;
//             dq = ds k; dk = ds^T q.
// The reference's guards are kept: exp(s - m_safe) with m_safe = 0 where
// m is -inf, p = 0 where the score is masked, l clamped at 1e-20.
// Arithmetic is float32 for float32 and bfloat16 inputs alike; outputs
// are written in the input dtype, m and l in float32.
//
// What bounds it on this card: operations. At the training path's shape
// (BH = 64, T = 1024, D = 64, causal) the forward does about 128 flops
// per float32 byte it must move, against a float32 ridge of about 20
// (67 TFLOP/s over 3.35 TB/s). The backward does 2.5 times the
// forward's flops on twice its bytes.
//
// What the design does about it: it keeps every operand of the inner
// products in shared memory and registers and does 4 x 8 multiply-adds
// per thread for every 12 shared-memory loads of 16 bytes; scores and
// probabilities never reach device memory; causal runs skip the tiles
// above the diagonal. It runs on the CUDA cores: wgmma, TMA and a
// cp.async pipeline are later work.
//
// Layout. A tile is 16 x 8 threads (128, four warps). Thread (ty, tx)
// owns tile rows ty + 16 i (i < RI) and tile columns tx + 8 j (j < 8),
// so the eight lanes that share a row sit in one warp (row max and sum
// by three shuffles) and each warp owns its rows outright: a row of
// probabilities written to shared memory is read back only by its own
// warp, behind __syncwarp. Operands are staged as float32 rows padded
// to D + 4 floats, so that the eight rows read by one 16-byte load land
// in eight different bank groups. For the products with V (or dO, Q, K)
// lane tx owns output columns 4 tx + 32 c .. + 3.
//   forward: one block per (bh, 64-row q tile), looping over 64-key
//            tiles up to the diagonal; the online softmax (running max,
//            denominator, accumulator) lives in registers. Blocks are
//            issued longest first (the last q tile has the most keys).
//   dq:      one block per (bh, 64-row q tile), looping over key tiles.
//   dk, dv:  one block per (bh, key tile of 64, or 32 at D = 128),
//            looping over the 64-row q tiles at or below the diagonal.
//   delta:   one warp per row, before the other two.
// No atomics: each output element is written by one thread, in one
// order, so gradients repeat bit for bit from run to run. The ragged
// tail (T or Tk not a multiple of the tile) is masked: rows past the
// end are staged as zeros, never read, and never written.
//
// Every kernel launches on the caller's stream, allocates nothing and
// does not synchronise; each C entry returns the first CUDA error of its
// launches (cudaGetLastError() after each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTX = 8;        // lanes across a tile row
constexpr int kTY = 16;       // thread rows
constexpr int kBC = 64;       // tile columns: 8 lanes x 8
constexpr int kCJ = kBC / kTX;
constexpr int kBQ = 64;       // query rows of a forward / dq tile (RI = 4)
constexpr int kPad = 4;       // floats of padding per staged D-row
constexpr int kLP = kBC + 8;  // row stride of the probability tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(a, b);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(c, d);
}

__device__ __forceinline__ float row_max(float v) {  // over the 8 lanes
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 1));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 4));
}

__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  v += __shfl_xor_sync(kFull, v, 2);
  return v + __shfl_xor_sync(kFull, v, 4);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane4(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Stage rows [0, nrows) of a contiguous [*, D] tensor (src at its first
// row) into shared memory as float32 rows of stride D + kPad; rows at or
// past `valid` are zeros and are not read.
template <typename T, int D>
__device__ void load_tile(float* dst, const T* src, int nrows, int valid) {
  constexpr int LD = D + kPad;
  constexpr int kVec = 16 / sizeof(T);  // elements in one 16-byte load
  constexpr int V = D / kVec;
  for (int e = threadIdx.x; e < nrows * V; e += kThreads) {
    const int r = e / V;
    const int c = (e - r * V) * kVec;
    float* out = dst + r * LD + c;
    if (r >= valid) {
      for (int u = 0; u < kVec; u += 4)
        store4(out + u, 0.f, 0.f, 0.f, 0.f);
      continue;
    }
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(out) = raw;
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 a = __bfloat1622float2(h[0]);
      const float2 b = __bfloat1622float2(h[1]);
      const float2 x = __bfloat1622float2(h[2]);
      const float2 y = __bfloat1622float2(h[3]);
      store4(out, a.x, a.y, b.x, b.y);
      store4(out + 4, x.x, x.y, y.x, y.y);
    }
  }
}

// acc[i][c] += sum_k A[ty + 16 i][k] * B[k][4 tx + 32 c .. + 3] over the
// kBC columns of A (stride kLP, rows of this warp) and rows of B (stride
// D + kPad).
template <int D, int RI>
__device__ __forceinline__ void accumulate_av(float (&acc)[RI][D / 32][4],
                                              const float* A, const float* B,
                                              int tx, int ty) {
  constexpr int LD = D + kPad;
  constexpr int NC = D / 32;
  for (int k = 0; k < kBC; k += 4) {
    float4 a[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + kTY * i) * kLP + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 b =
            *reinterpret_cast<const float4*>(B + (k + u) * LD + 4 * tx + 32 * c);
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float w = lane4(a[i], u);
          acc[i][c][0] = fmaf(w, b.x, acc[i][c][0]);
          acc[i][c][1] = fmaf(w, b.y, acc[i][c][1]);
          acc[i][c][2] = fmaf(w, b.z, acc[i][c][2]);
          acc[i][c][3] = fmaf(w, b.w, acc[i][c][3]);
        }
      }
    }
  }
}

// s[i][j] = A[ty + 16 i] . B[tx + 8 j] over D (both stride D + kPad).
template <int D, int RI>
__device__ __forceinline__ void row_dots(float (&s)[RI][kCJ], const float* A,
                                         const float* B, int tx, int ty) {
  constexpr int LD = D + kPad;
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < kCJ; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 a[RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + kTY * i) * LD + d);
#pragma unroll
    for (int j = 0; j < kCJ; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(B + (tx + kTX * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RI; ++i) s[i][j] = dot4(a[i], b, s[i][j]);
    }
  }
}

// Write rows ty + 16 i of acc (scaled by mul[i]) to out rows r0 + ... that
// are < nvalid; out is a contiguous [*, D] tensor at row 0.
template <typename T, int D, int RI>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[RI][D / 32][4],
                                           const float (&mul)[RI], int r0,
                                           int nvalid, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = r0 + ty + kTY * i;
    if (r >= nvalid) continue;
    T* row = out + (size_t)r * D;
#pragma unroll
    for (int c = 0; c < D / 32; ++c)
      store4(row + 4 * tx + 32 * c, acc[i][c][0] * mul[i],
             acc[i][c][1] * mul[i], acc[i][c][2] * mul[i],
             acc[i][c][3] * mul[i]);
  }
}

template <int D>
constexpr size_t fwd_smem_floats() {
  return (size_t)(kBQ + 2 * kBC) * (D + kPad) + (size_t)kBQ * kLP;
}
template <int D>
constexpr size_t dq_smem_floats() {
  return (size_t)(2 * kBQ + 2 * kBC) * (D + kPad) + (size_t)kBQ * kLP;
}
template <int D, int RI>
constexpr size_t dkv_smem_floats() {
  return (size_t)(2 * kTY * RI + 2 * kBC) * (D + kPad) +
         (size_t)kTY * RI * kLP + 3 * kBC;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Tq, int Tk, float scale, int causal) {
  constexpr int RI = kBQ / kTY;
  constexpr int NC = D / 32;
  constexpr int LD = D + kPad;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBC * LD;
  float* Ps = Vs + kBC * LD;

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kBQ;
  const size_t bh = blockIdx.y;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  load_tile<T, D>(Qs, q + (bh * Tq + q0) * D, kBQ, Tq - q0);

  float m[RI], l[RI], o[RI][NC][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.f;
  }

  // causal: key tiles past this tile's last query row are dead
  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += kBC) {
    __syncthreads();  // the previous tile's K/V reads are done
    load_tile<T, D>(Ks, kb + (size_t)k0 * D, kBC, Tk - k0);
    load_tile<T, D>(Vs, vb + (size_t)k0 * D, kBC, Tk - k0);
    __syncthreads();

    float s[RI][kCJ];
    row_dots<D, RI>(s, Qs, Ks, tx, ty);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + kTY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kj = k0 + tx + kTX * j;
        const bool live = kj < Tk && (!causal || kj <= qi);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - m_safe) : 0.f;
        sum += p;
        Ps[(ty + kTY * i) * kLP + tx + kTX * j] = p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
    }
    __syncwarp();  // this warp's probability rows are written
    accumulate_av<D, RI>(o, Ps, Vs, tx, ty);
    __syncwarp();
  }

  float inv[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) inv[i] = 1.f / fmaxf(l[i], 1e-20f);
  store_rows<T, D, RI>(out + bh * Tq * D, o, inv, q0, Tq, tx, ty);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = q0 + ty + kTY * i;
      if (r < Tq) {
        m_out[bh * Tq + r] = m[i];
        l_out[bh * Tq + r] = l[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(256)
    flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ g,
                           float* __restrict__ delta, long long rows) {
  const long long r = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // whole warps only: no shuffle below is split
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(g[r * D + d]), to_f32(o[r * D + d]), acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) delta[r] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ g,
                        const float* __restrict__ m,
                        const float* __restrict__ l,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Tq, int Tk, float scale, int causal) {
  constexpr int RI = kBQ / kTY;
  constexpr int NC = D / 32;
  constexpr int LD = D + kPad;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Gs = Qs + kBQ * LD;
  float* Ks = Gs + kBQ * LD;
  float* Vs = Ks + kBC * LD;
  float* Ss = Vs + kBC * LD;

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kBQ;
  const size_t bh = blockIdx.y;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  load_tile<T, D>(Qs, q + (bh * Tq + q0) * D, kBQ, Tq - q0);
  load_tile<T, D>(Gs, g + (bh * Tq + q0) * D, kBQ, Tq - q0);

  // this thread's rows: max (0 where -inf), clamped denominator, delta;
  // rows past the end get values that keep their (unwritten) math finite
  float m_safe[RI], ll[RI], dd[RI], acc[RI][NC][4];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = q0 + ty + kTY * i;
    const float mr = r < Tq ? m[bh * Tq + r] : 0.f;
    m_safe[i] = isfinite(mr) ? mr : 0.f;
    ll[i] = r < Tq ? fmaxf(l[bh * Tq + r], 1e-20f) : 1.f;
    dd[i] = r < Tq ? delta[bh * Tq + r] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.f;
  }

  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  for (int k0 = 0; k0 < kend; k0 += kBC) {
    __syncthreads();
    load_tile<T, D>(Ks, kb + (size_t)k0 * D, kBC, Tk - k0);
    load_tile<T, D>(Vs, vb + (size_t)k0 * D, kBC, Tk - k0);
    __syncthreads();

    float s[RI][kCJ], dp[RI][kCJ];
    row_dots<D, RI>(s, Qs, Ks, tx, ty);
    row_dots<D, RI>(dp, Gs, Vs, tx, ty);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qi = q0 + ty + kTY * i;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int kj = k0 + tx + kTX * j;
        const bool live = kj < Tk && (!causal || kj <= qi);
        const float p = live ? expf(s[i][j] * scale - m_safe[i]) / ll[i] : 0.f;
        Ss[(ty + kTY * i) * kLP + tx + kTX * j] = p * (dp[i][j] - dd[i]) * scale;
      }
    }
    __syncwarp();
    accumulate_av<D, RI>(acc, Ss, Ks, tx, ty);
    __syncwarp();
  }
  float one[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) one[i] = 1.f;
  store_rows<T, D, RI>(dq + bh * Tq * D, acc, one, q0, Tq, tx, ty);
}

template <typename T, int D, int RI>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int Tq,
                         int Tk, float scale, int causal) {
  constexpr int BR = kTY * RI;  // keys of this block
  constexpr int NC = D / 32;
  constexpr int LD = D + kPad;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + BR * LD;
  float* Qs = Vs + BR * LD;
  float* Gs = Qs + kBC * LD;
  float* Ps = Gs + kBC * LD;
  float* Ms = Ps + BR * kLP;
  float* Ls = Ms + kBC;
  float* Ds = Ls + kBC;

  const int tx = threadIdx.x % kTX;
  const int ty = threadIdx.x / kTX;
  const int k0 = blockIdx.x * BR;
  const size_t bh = blockIdx.y;
  load_tile<T, D>(Ks, k + (bh * Tk + k0) * D, BR, Tk - k0);
  load_tile<T, D>(Vs, v + (bh * Tk + k0) * D, BR, Tk - k0);

  float dk_acc[RI][NC][4], dv_acc[RI][NC][4];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_acc[i][c][e] = dv_acc[i][c][e] = 0.f;

  // causal: query tiles wholly before this block's first key are dead
  const int qstart = causal ? (k0 / kBC) * kBC : 0;
  for (int q0 = qstart; q0 < Tq; q0 += kBC) {
    __syncthreads();
    load_tile<T, D>(Qs, q + (bh * Tq + q0) * D, kBC, Tq - q0);
    load_tile<T, D>(Gs, g + (bh * Tq + q0) * D, kBC, Tq - q0);
    for (int e = threadIdx.x; e < kBC; e += kThreads) {
      const int r = q0 + e;
      const float mr = r < Tq ? m[bh * Tq + r] : 0.f;
      Ms[e] = isfinite(mr) ? mr : 0.f;
      Ls[e] = r < Tq ? fmaxf(l[bh * Tq + r], 1e-20f) : 1.f;
      Ds[e] = r < Tq ? delta[bh * Tq + r] : 0.f;
    }
    __syncthreads();

    // rows are keys, columns are queries
    float p[RI][kCJ], dp[RI][kCJ];
    row_dots<D, RI>(p, Ks, Qs, tx, ty);
    row_dots<D, RI>(dp, Vs, Gs, tx, ty);
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int kj = k0 + ty + kTY * i;
#pragma unroll
      for (int j = 0; j < kCJ; ++j) {
        const int c = tx + kTX * j;
        const int qj = q0 + c;
        const bool live = qj < Tq && kj < Tk && (!causal || kj <= qj);
        p[i][j] = live ? expf(p[i][j] * scale - Ms[c]) / Ls[c] : 0.f;
        dp[i][j] = p[i][j] * (dp[i][j] - Ds[c]) * scale;  // ds
        Ps[(ty + kTY * i) * kLP + c] = p[i][j];
      }
    }
    __syncwarp();
    accumulate_av<D, RI>(dv_acc, Ps, Gs, tx, ty);  // dv += p^T dO
    __syncwarp();
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < kCJ; ++j)
        Ps[(ty + kTY * i) * kLP + tx + kTX * j] = dp[i][j];
    __syncwarp();
    accumulate_av<D, RI>(dk_acc, Ps, Qs, tx, ty);  // dk += ds^T q
    __syncwarp();
  }
  float one[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) one[i] = 1.f;
  store_rows<T, D, RI>(dk + bh * Tk * D, dk_acc, one, k0, Tk, tx, ty);
  store_rows<T, D, RI>(dv + bh * Tk * D, dv_acc, one, k0, Tk, tx, ty);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* m, float* l, int BH, int Tq, int Tk, float scale,
                int causal, cudaStream_t st) {
  const size_t smem = fwd_smem_floats<D>() * sizeof(float);
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Tq + kBQ - 1) / kBQ, BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), m, l, Tq, Tk, scale,
      causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const float* m, const float* l, const void* g, float* delta,
                void* dq, void* dk, void* dv, int BH, int Tq, int Tk,
                float scale, int causal, cudaStream_t st) {
  constexpr int RI = D >= 128 ? 2 : 4;  // dk/dv accumulators fit registers
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const long long rows = (long long)BH * Tq;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(o), gt, delta, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_q = dq_smem_floats<D>() * sizeof(float);
  e = allow_smem(flash_bwd_dq_kernel<T, D>, smem_q);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D><<<dim3((Tq + kBQ - 1) / kBQ, BH), kThreads,
                              smem_q, st>>>(qt, kt, vt, gt, m, l, delta,
                                            static_cast<T*>(dq), Tq, Tk,
                                            scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_kv = dkv_smem_floats<D, RI>() * sizeof(float);
  e = allow_smem(flash_bwd_dkv_kernel<T, D, RI>, smem_kv);
  if (e != cudaSuccess) return e;
  constexpr int BR = kTY * RI;
  flash_bwd_dkv_kernel<T, D, RI><<<dim3((Tk + BR - 1) / BR, BH), kThreads,
                                   smem_kv, st>>>(
      qt, kt, vt, gt, m, l, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      Tq, Tk, scale, causal);
  return cudaGetLastError();
}

}  // namespace

#define MXTT_DISPATCH(CALL)                                  \
  switch (dtype * 1000 + D) {                                \
    case 32: return (int)CALL(float, 32);                    \
    case 64: return (int)CALL(float, 64);                    \
    case 128: return (int)CALL(float, 128);                  \
    case 1032: return (int)CALL(__nv_bfloat16, 32);          \
    case 1064: return (int)CALL(__nv_bfloat16, 64);          \
    case 1128: return (int)CALL(__nv_bfloat16, 128);         \
    default: return (int)cudaErrorInvalidValue;              \
  }

// dtype: 0 = float32, 1 = bfloat16. q is [BH, T, D]; k, v [BH, Tk, D];
// out [BH, T, D]; m, l [BH, T] float32. All contiguous on the current
// device; D in {32, 64, 128}; causal needs Tk == T. Returns a cudaError_t.
extern "C" int mxtt_flash_fwd(int dtype, const void* q, const void* k,
                              const void* v, void* out, void* m, void* l,
                              int BH, int T, int Tk, int D, float scale,
                              int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* lf = static_cast<float*>(l);
#define MXTT_FWD(TYPE, DIM) \
  fwd<TYPE, DIM>(q, k, v, out, mf, lf, BH, T, Tk, scale, causal, st)
  MXTT_DISPATCH(MXTT_FWD)
#undef MXTT_FWD
}

// The same shapes; o is the forward's output, g the gradient of it, both
// [BH, T, D]; delta is float32 [BH, T] scratch; dq, dk, dv take q, k, v's
// shapes. Launches three kernels (delta, dq, dk/dv) in that order.
extern "C" int mxtt_flash_bwd(int dtype, const void* q, const void* k,
                              const void* v, const void* o, const void* m,
                              const void* l, const void* g, void* delta,
                              void* dq, void* dk, void* dv, int BH, int T,
                              int Tk, int D, float scale, int causal,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(delta);
#define MXTT_BWD(TYPE, DIM)                                                \
  bwd<TYPE, DIM>(q, k, v, o, mf, lf, g, df, dq, dk, dv, BH, T, Tk, scale, \
                 causal, st)
  MXTT_DISPATCH(MXTT_BWD)
#undef MXTT_BWD
}

#undef MXTT_DISPATCH

extern "C" const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
