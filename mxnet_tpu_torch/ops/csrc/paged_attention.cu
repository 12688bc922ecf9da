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
// dtype; the output is written in q's dtype as acc / max(l, 1e-20), with
// the same -inf guards as the reference's online softmax.
//
// The int8 variant (the reference's quant=True branch): the pools hold
// int8 and two (num_blocks, H) float32 tables hold one scale per (block,
// head). Each element is dequantized in registers where it is used,
// k = float(k_int8) * k_scale[block, h] (and likewise v), before any
// product, in the reference's order; statistics in float32, output in q's
// dtype (float32 or bfloat16). Only the scales of live blocks are read.
//
// What bounds it: a call moves little (0.25-3.5 us of device-memory bytes
// at the serving shapes: paged_attention.py paged_call_cost), so it is
// bound by latency: how many SMs take part, how many loads are in flight
// at once, and how many times a block is staged.
//
// What the design does about it:
//   * a thread-block cluster per (row b, head h, query tile) splits the
//     row's live table slots across its C <= 8 blocks (flash-decoding):
//     block r of the cluster takes slots [r n / C, (r + 1) n / C) of the
//     tile's n live slots, so a decode step of 8 rows x 4 heads fills 256
//     blocks, not 32. Each block folds its slots into its own float32
//     online softmax (m, l, acc) per query row; the partials are merged
//     through distributed shared memory, in rank order 0..C-1, inside the
//     same launch: no second kernel, no atomics, the same bits every run.
//     A block whose range holds no live key contributes (-inf, 0, 0).
//     cluster.sync() comes before any block reads its peers' partials and
//     again before any block exits;
//   * one cluster serves a tile of up to 64 query rows (a prefill chunk,
//     the k + 1 rows of a spec-score pass, or the one row of a decode
//     step): each K/V block is staged once and scored by every row of the
//     tile, each row against its own causal limit q_start[b] + i;
//   * K and V blocks are staged with 16-byte cp.async copies, double
//     buffered: the next slot's blocks load while the current one is
//     scored. An int8 block stays int8 in shared memory (a quarter of the
//     float32 bytes) and is widened in registers;
//   * it reads only live blocks: slots past the tile's last row's limit
//     are never staged, so the bytes follow the true sequence lengths,
//     not the padded table width.
// Products stay on the CUDA cores in float32 (decode does 0.5 flops per
// float32 byte; a 64-row chunk is scored in a few microseconds).
//
// Layout. A block is NW warps: four for a tile of 4 or 16 rows, sixteen
// for 64 (eight for 32). Warp w owns the tile's query rows w, w + NW, ...
// (RW <= 4 of them): lane l scores key t0 + l of the staged block
// against each of them (K rows padded by 16 bytes, so the 16-byte loads
// of eight lanes fall in distinct banks), folds the scores into the rows'
// running max and denominator, and parks the probabilities in shared
// memory; then lane l accumulates output columns 4 l .. 4 l + 3 (+ 128 c)
// of every row from the staged V block. At the end each warp writes its
// rows' (m, l, acc) into shared memory (acc over the query tile, whose
// float32 copy is no longer read), and cluster block r merges rows r,
// r + C, ... from all C blocks. A pool token is H * Dh elements apart
// from the next one; head h's slice starts h * Dh into it.
//
// The kernel launches on the caller's stream (cudaLaunchKernelEx with a
// cluster dimension), allocates nothing and does not synchronise; the C
// entry returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kPadBytes = 16;   // per staged K/V row
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 staged bytes as float32 values (4 float32, 8 bfloat16 or 16 int8
// elements), an int8 element times its block's scale
__device__ __forceinline__ void widen16(const float* p, float* x, float) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* x,
                                        float) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float2 f = __bfloat1622float2(h[u]);
    x[2 * u] = f.x;
    x[2 * u + 1] = f.y;
  }
}
__device__ __forceinline__ void widen16(const int8_t* p, float* x, float s) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int u = 0; u < 16; ++u)
    x[u] = static_cast<float>(static_cast<int8_t>(w[u / 4] >> (8 * (u % 4)))) * s;
}

// four consecutive staged elements as float32 (V columns 4 l .. 4 l + 3)
__device__ __forceinline__ float4 widen4(const float* p, float) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p, float) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 widen4(const int8_t* p, float s) {
  const int w = *reinterpret_cast<const int*>(p);
  return make_float4(static_cast<float>(static_cast<int8_t>(w)) * s,
                     static_cast<float>(static_cast<int8_t>(w >> 8)) * s,
                     static_cast<float>(static_cast<int8_t>(w >> 16)) * s,
                     static_cast<float>(static_cast<int8_t>(w >> 24)) * s);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(p)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(p)[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Query rows a cluster serves: 4 for decode and spec score (a warp per
// row), 16, or 64 (32 at Dh > 128, to bound the accumulator's
// registers), four rows a warp. paged_attention.py's gate copies this
// and smem_bytes (_row_tile, _smem_bytes); the card tests hold its copy
// to mxtt_paged_smem_bytes.
__host__ __device__ inline int row_tile(int Tq, int Dh) {
  if (Tq <= 4) return 4;
  if (Tq <= 16) return 16;
  return Dh > 128 ? 32 : 64;
}

// Shared memory of one block, in bytes: the query tile as float32 (later the accumulators), the
// rows' m and l, the probability rows (32 keys per row), and two stages
// of K and V blocks in the pool's dtype, rows padded by 16 bytes.
__host__ __device__ inline size_t smem_bytes(int TQ, int Dh, int bs,
                                             int pool_itemsize) {
  return (size_t)TQ * Dh * 4 + (size_t)TQ * 2 * 4 + (size_t)TQ * 32 * 4 +
         (size_t)4 * bs * ((size_t)Dh * pool_itemsize + kPadBytes);
}

// T: q and out; P: the pools (T, or int8_t with the scale tables);
// RW: query rows per warp; NW: warps; NC: 128-column groups per lane
template <typename T, typename P, int RW, int NW, int NC>
__global__ void __launch_bounds__(NW * 32)
    paged_attention_kernel(const T* __restrict__ q,
                           const P* __restrict__ k_pool,
                           const P* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ tables,
                           const int* __restrict__ q_start,
                           T* __restrict__ out, int Tq, int H, int Dh, int w,
                           int bs, float scale) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int TQ = RW * NW;
  constexpr int kThreads = NW * 32;
  constexpr int VE = 16 / sizeof(P);  // elements in one 16-byte load
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [TQ][Dh], then acc
  float* m_s = q_s + (size_t)TQ * Dh;            // [TQ]
  float* l_s = m_s + TQ;                         // [TQ]
  float* p_s = l_s + TQ;                         // [TQ][32]
  char* stage = reinterpret_cast<char*>(p_s + TQ * 32);
  const int ld = Dh * (int)sizeof(P) + kPadBytes;  // staged row, bytes
  const size_t blk_bytes = (size_t)bs * ld;
  // stage s: K at stage + 2 s blk_bytes, V after it

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int i0 = blockIdx.z * TQ;             // first query row of the tile
  const int R = min(TQ, Tq - i0);             // rows in this tile
  const int qs = q_start[b];
  const long long tok = (long long)H * Dh;    // pool elements per token
  const int* tab = tables + (long long)b * w;

  // the tile's live slots: up to the last row's limit; this block's share
  const int qlast = qs + i0 + R - 1;
  const int n_live = qlast < 0 ? 0 : min(w, qlast / bs + 1);
  const int j_begin = (int)((long long)rank * n_live / C);
  const int j_end = (int)((long long)(rank + 1) * n_live / C);

  const int chunks = Dh * (int)sizeof(P) / 16;  // 16-byte pieces per row
  auto issue = [&](int j, int s) {
    const long long blk = tab[j];
    const P* kg = k_pool + blk * bs * tok + (long long)h * Dh;
    const P* vg = v_pool + blk * bs * tok + (long long)h * Dh;
    char* ks = stage + (size_t)2 * s * blk_bytes;
    char* vs = ks + blk_bytes;
    for (int e = threadIdx.x; e < bs * chunks; e += kThreads) {
      const int t = e / chunks;
      const int c = e - t * chunks;
      cp_async16(ks + (size_t)t * ld + c * 16, kg + t * tok + c * VE);
      cp_async16(vs + (size_t)t * ld + c * 16, vg + t * tok + c * VE);
    }
  };
  if (j_begin < j_end) issue(j_begin, 0);
  cp_async_commit();

  // the query tile as float32, 16 bytes a load (rows past R are never
  // read)
  constexpr int QV = 16 / sizeof(T);
  const int qchunks = Dh / QV;
  for (int e = threadIdx.x; e < R * qchunks; e += kThreads) {
    const int r = e / qchunks;
    const int d = (e - r * qchunks) * QV;
    const T* src = q + (((long long)b * Tq + i0 + r) * H + h) * Dh + d;
    float x[QV];
    widen16(src, x, 1.f);
#pragma unroll
    for (int u = 0; u < QV; u += 4)
      store4(q_s + (size_t)r * Dh + d + u,
             make_float4(x[u], x[u + 1], x[u + 2], x[u + 3]));
  }

  float m[RW], l[RW], acc[RW][NC][4];
#pragma unroll
  for (int ii = 0; ii < RW; ++ii) {
    m[ii] = -INFINITY;
    l[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[ii][c][0] = acc[ii][c][1] = acc[ii][c][2] = acc[ii][c][3] = 0.f;
  }
  float* p_w = p_s + warp * RW * 32;  // this warp's probability rows

  for (int j = j_begin; j < j_end; ++j) {
    const int s = (j - j_begin) & 1;
    if (j + 1 < j_end) {
      issue(j + 1, s ^ 1);  // the next slot loads while this one is scored
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slot j's blocks (and the query tile) are visible
    float ksc = 1.f, vsc = 1.f;
    if constexpr (kQuant) {
      const long long blk = tab[j];
      ksc = k_scale[blk * H + h];
      vsc = v_scale[blk * H + h];
    }
    const P* ks = reinterpret_cast<const P*>(stage + (size_t)2 * s * blk_bytes);
    const P* vs = reinterpret_cast<const P*>(stage + (size_t)(2 * s + 1) * blk_bytes);
    const int ldp = ld / (int)sizeof(P);  // staged row, elements

    for (int t0 = 0; t0 < bs; t0 += 32) {
      const int t = t0 + lane;
      const int kpos = j * bs + t;
      float sc[RW];
#pragma unroll
      for (int ii = 0; ii < RW; ++ii) sc[ii] = 0.f;
      if (t < bs) {
        const P* kr = ks + (size_t)t * ldp;
        for (int d = 0; d < Dh; d += VE) {
          float kv[VE];
          widen16(kr + d, kv, ksc);
#pragma unroll
          for (int ii = 0; ii < RW; ++ii) {
            const float* qr = q_s + (size_t)(warp + NW * ii) * Dh + d;
#pragma unroll
            for (int u = 0; u < VE; u += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + u);
              sc[ii] = fmaf(qv.x, kv[u], sc[ii]);
              sc[ii] = fmaf(qv.y, kv[u + 1], sc[ii]);
              sc[ii] = fmaf(qv.z, kv[u + 2], sc[ii]);
              sc[ii] = fmaf(qv.w, kv[u + 3], sc[ii]);
            }
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < RW; ++ii) {
        const int r = warp + NW * ii;
        const bool live = t < bs && r < R && kpos <= qs + i0 + r;
        const float sv = live ? sc[ii] * scale : -INFINITY;
        const float m_new = fmaxf(m[ii], warp_max(sv));
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float p = live ? expf(sv - m_safe) : 0.f;
        const float alpha = isfinite(m[ii]) ? expf(m[ii] - m_safe) : 0.f;
        l[ii] = alpha * l[ii] + warp_sum(p);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[ii][c][e] *= alpha;
        m[ii] = m_new;
        p_w[ii * 32 + lane] = p;
      }
      __syncwarp();
      const int nt = min(32, bs - t0);
      for (int u = 0; u < nt; ++u) {
        const P* vr = vs + (size_t)(t0 + u) * ldp;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int d = 4 * lane + 128 * c;
          if (d >= Dh) continue;
          const float4 vv = widen4(vr + d, vsc);
#pragma unroll
          for (int ii = 0; ii < RW; ++ii) {
            const float pu = p_w[ii * 32 + u];
            acc[ii][c][0] = fmaf(pu, vv.x, acc[ii][c][0]);
            acc[ii][c][1] = fmaf(pu, vv.y, acc[ii][c][1]);
            acc[ii][c][2] = fmaf(pu, vv.z, acc[ii][c][2]);
            acc[ii][c][3] = fmaf(pu, vv.w, acc[ii][c][3]);
          }
        }
      }
      __syncwarp();  // the probability rows are read before the next chunk
    }
    __syncthreads();  // every warp is done with stage s before its reuse
  }

  // this block's partials, over its own rows of the (no longer read)
  // query tile; the barrier also orders them after the tile's staging
  // when the block had no live slot
  __syncthreads();
#pragma unroll
  for (int ii = 0; ii < RW; ++ii) {
    const int r = warp + NW * ii;
    if (r >= R) continue;
    if (lane == 0) {
      m_s[r] = m[ii];
      l_s[r] = l[ii];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * lane + 128 * c;
      if (d < Dh)
        store4(q_s + (size_t)r * Dh + d,
               make_float4(acc[ii][c][0], acc[ii][c][1], acc[ii][c][2],
                           acc[ii][c][3]));
    }
  }
  cluster.sync();  // every block's partials are written

  // block `rank` merges rows rank, rank + C, ... from all C blocks, in
  // rank order
  for (int r = rank + C * warp; r < R; r += C * NW) {
    float mk[kMaxCluster], wk[kMaxCluster];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      mk[k] = k < C ? cluster.map_shared_rank(m_s, k)[r] : -INFINITY;
      mx = fmaxf(mx, mk[k]);
    }
    const float mx_safe = isfinite(mx) ? mx : 0.f;
    float den = 0.f;
#pragma unroll
    for (int k = 0; k < kMaxCluster; ++k) {
      wk[k] = isfinite(mk[k]) ? expf(mk[k] - mx_safe) : 0.f;
      if (k < C) den += wk[k] * cluster.map_shared_rank(l_s, k)[r];
    }
    den = fmaxf(den, 1e-20f);
    T* orow = out + (((long long)b * Tq + i0 + r) * H + h) * Dh;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = 4 * lane + 128 * c;
      if (d >= Dh) continue;
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < kMaxCluster; ++k) {
        if (k >= C) break;
        const float4 a = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(q_s, k) + (size_t)r * Dh + d);
        o.x = fmaf(wk[k], a.x, o.x);
        o.y = fmaf(wk[k], a.y, o.y);
        o.z = fmaf(wk[k], a.z, o.z);
        o.w = fmaf(wk[k], a.w, o.w);
      }
      store4(orow + d, make_float4(o.x / den, o.y / den, o.z / den,
                                   o.w / den));
    }
  }
  cluster.sync();  // no block exits while a peer may still read it
}

template <typename T, typename P, int RW, int NW, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* tables, const int* q_start, void* out, int B,
                   int Tq, int H, int Dh, int w, int bs, float scale,
                   cudaStream_t stream) {
  constexpr int TQ = RW * NW;
  auto kernel = paged_attention_kernel<T, P, RW, NW, NC>;
  const size_t smem = smem_bytes(TQ, Dh, bs, (int)sizeof(P));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int C = w < 1 ? 1 : (w < kMaxCluster ? w : kMaxCluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, B * H, (Tq + TQ - 1) / TQ);
  cfg.blockDim = dim3(NW * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), k_scale, v_scale, tables, q_start,
      static_cast<T*>(out), Tq, H, Dh, w, bs, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* tables, const int* q_start, void* out, int B,
                     int Tq, int H, int Dh, int w, int bs, float scale,
                     cudaStream_t stream) {
  if (Dh < 16 || Dh > 256 || Dh % 16) return cudaErrorInvalidValue;
  const int tile = row_tile(Tq, Dh);
#define MXTT_CASE(RW, NW, NC)                                                \
  if (tile == RW * NW && (Dh > 128) == (NC == 2))                            \
    return launch<T, P, RW, NW, NC>(q, k, v, k_scale, v_scale, tables,       \
                                    q_start, out, B, Tq, H, Dh, w, bs, scale, \
                                    stream);
  MXTT_CASE(1, 4, 1)
  MXTT_CASE(4, 4, 1)
  MXTT_CASE(4, 16, 1)
  MXTT_CASE(1, 4, 2)
  MXTT_CASE(4, 4, 2)
  MXTT_CASE(4, 8, 2)
#undef MXTT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (q and out): 0 = float32, 1 = bfloat16. pool_dtype: the same code
// as dtype, or 2 = int8, which needs k_scale and v_scale, (num_blocks, H)
// float32. q and out are (B, Tq, H, Dh); the pools (num_blocks, bs, H,
// Dh); tables (B, w) int32; q_start (B,) int32. All contiguous on the
// current device, q, out and the pools 16-byte aligned, Dh a multiple of
// 16 in [16, 256]. Returns a cudaError_t.
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
    return (int)dispatch<float, float>(q, k, v, ks, vs, tab, qs, out, B, Tq,
                                       H, Dh, w, bs, scale, st);
  if (dtype == 1 && pool_dtype == 1)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(
        q, k, v, ks, vs, tab, qs, out, B, Tq, H, Dh, w, bs, scale, st);
  if (dtype == 0 && pool_dtype == 2)
    return (int)dispatch<float, int8_t>(q, k, v, ks, vs, tab, qs, out, B, Tq,
                                        H, Dh, w, bs, scale, st);
  if (dtype == 1 && pool_dtype == 2)
    return (int)dispatch<__nv_bfloat16, int8_t>(q, k, v, ks, vs, tab, qs, out,
                                                B, Tq, H, Dh, w, bs, scale,
                                                st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory, in bytes, of one block of the launch that
// serves Tq query rows at this head_dim, block size and pool itemsize:
// paged_attention.py's gate (_smem_bytes) is held to it on the card.
extern "C" long long mxtt_paged_smem_bytes(int Tq, int Dh, int bs,
                                           int pool_itemsize) {
  return (long long)smem_bytes(row_tile(Tq, Dh), Dh, bs, pool_itemsize);
}

extern "C" const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
