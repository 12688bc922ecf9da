// Persistent fused-RNN scan kernels for Hopper (sm_90a).
//
// Replaces the two TPU kernels of mxnet_tpu/ops/pallas_rnn.py, which every
// lstm / rnn_relu / rnn_tanh layer-direction of the `RNN` op runs through
// when MXNET_FUSED_RNN=1 (the word-LM LSTM: 2 layers, one direction, so
// two of each a training step):
//
//   K4a _fwd_kernel  one layer-direction's whole recurrence in one launch:
//                    pre_t = px_t + round(h_{t-1}) wh^T, the gates (lstm:
//                    i, f, g, o; rnn_relu; rnn_tanh), the cell update; h and
//                    c carried in float32, ys / cs stored rounded to the
//                    activation type, hT / cT emitted at the last step;
//   K4b _bwd_kernel  the reverse-time backward: the gates recomputed from
//                    px and the saved (rounded) h_{t-1}, c_{t-1}, c_t, the
//                    fused dGates / dCell / dH chain with dh and dc carried
//                    in float32, dpre stored rounded as dpx and used
//                    rounded for dh_{t-1} = dpre wh and for
//                    dWh = sum_t dpre_t^T h_{t-1} (float32).
//
// Layouts, as the reference's: px and dpx [T, N, G*H] (gate blocks of H
// along the last axis, lstm G = 4 in the order i, f, g, o), every sequence
// [T, N, H], states [N, H], wh [G*H, H] row-major, dWh float32 [G*H, H].
// The activation type T is float or __nv_bfloat16 for every input and
// output but dWh; the rounding points are the reference's
// (pallas_rnn.py:231, :241, :251, :384, :391): the product takes h rounded
// to T, ys and cs are stored rounded while the carries stay float32, dpre
// is rounded before both of its products. The direction is an index map:
// the forward walks t = 0..T-1 (T-1..0 for a reverse layer), the backward
// the other way; nothing is flipped in memory.
//
// What bounds them: not bytes. At the word LM's shape (T 35, N 32, H 200,
// bf16) K4a must move 3.1 MB and K4b 6.4 MB (the reference's declared
// costs), about 1 and 2 us at 3.35 TB/s. The recurrence makes each of the
// T steps wait for the last one's h, so the floor is T times one step's
// latency: the step's product, the exchange of h (K4a) or of the dh
// partials (K4b) between the blocks that share a batch row, and a barrier.
// mxtt_rnn_floor measures the exchange and barrier alone (T steps of it,
// nothing else), the floor this design's synchronisation sets: about
// 1.4 us a step on an H100 (tools/rnn_ab.py; PERF.md has the readings).
//
// Two designs; ops/fused_rnn.py `rnn_design` picks one from (mode, N, H,
// dtype) before the launch:
//
// * The cluster design (every shape whose slices fit shared memory, but tiny
//   layers; the clusters run in as many waves as N needs, and rnn_design
//   picks the layout with the fewest). A thread-block cluster of P blocks
//   (16, 8 or 4) owns R batch rows (8, 16 or 32) for the whole sequence;
//   block r owns the hidden units [r U, r U + U), U = ceil(H / P) rounded up
//   to a 16-byte vector, and keeps the G rows of wh of each of them resident
//   in shared memory for all T steps (no wh traffic a step). Owning whole
//   units gives a block all G gate pre-activations of its units, so the cell
//   update needs no exchange and c, dc stay in the block (in registers, as do
//   each step's inputs, loaded a step ahead). K4a's step: the product [R, H]
//   x [H, G U] from the slice, the gates, round(h_t) of the block's units
//   into its own next h buffer, then that slice copied in 16-byte vectors
//   into every other block's through distributed shared memory, and one
//   cluster barrier (ys / cs stored after the arrive). K4b's step: dpre of
//   the block's units (rounded, stored as dpx after the arrive), its partial
//   dh_{t-1} over its own G U rows of wh for every k, each 4-column vector
//   pushed to that column's owner, then a split barrier: while it waits, off
//   the serial chain, the block adds this step's dWh rows (float32 in shared
//   memory, each block owning its G U rows) and recomputes the next step's
//   pre from the saved h_{t-1} (copied in by cp.async during the step); after
//   it, each block adds its units' P partials in rank order. In bfloat16 the
//   three products run on the tensor cores (mma.sync m16n8k16, ldmatrix and
//   ldmatrix.trans fragments; dWh's step sum in fresh accumulators, then
//   added in float32); float32 takes the CUDA cores (FMAs from the resident
//   slice in 16-byte shared-memory vectors, a thread a tile of 4 rows): TF32
//   would need three products, and a permuted k for the non-transposed wh
//   of dh = dpre wh, for products that are not the step's bottleneck. At the word LM's shape (P 16, R 8, 4
//   clusters) a block keeps 64 x 200 of wh and uses 45 KB (K4a) / 150 KB
//   (K4b) of shared memory in bfloat16, 70 KB / 151 KB in float32. Several
//   clusters add their dWh through a workspace in cluster order. No atomics:
//   every result repeats bit for bit.
//
// * The streaming design (the first port's, kept for the shapes whose slices
//   do not fit, up to H 1024, and for layers of at most 16 rows and 64 gate
//   rows, where its step is the shorter): one thread block owns bn rows of
//   the batch and nothing passes between blocks; its rows' h (rounded) and c
//   live in shared memory in float32, and each step streams wh from L2: a
//   warp takes whole rows j of wh, its lanes 16-byte vectors along k, reduced
//   across lanes by shuffles. K4b forms dh_{t-1} = dpre wh with threads along
//   k, the G*H reduction split into up to four slices added in a fixed order;
//   dWh is a separate tiled product over all T*N rows, each output summed in
//   one fixed order.
//
// Ragged edges are masked: N not a multiple of R, H not a multiple of P
// (the last blocks own fewer units, or none), of the vector width or of
// the mma tile (zero rows and columns in shared memory), T 1.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each C entry returns the launch's error or
// cudaGetLastError() (a cluster the card cannot schedule is refused at
// launch and returned).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// rows of wh a warp has in flight at once in the streaming step's product
constexpr int kRows = 4;
// at most this many slices of the streaming K4b's G*H reduction of dh
constexpr int kMaxSlices = 4;

enum Mode { kLstm = 0, kRelu = 1, kTanh = 2 };

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

// v rounded to T and back
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// pre[n * GH + j] = px_t[n * GH + j] + sum_k hs[n * H + k] * wh[j * H + k]
// for the block's rows n < nrows and every gate row j < GH. hs holds the
// rows' h rounded to T, in float32 (zero for n >= nrows). A warp takes
// kRows rows of wh at a time; with vec (H a multiple of the vector width
// and wh 16-byte aligned) a lane reads 16-byte vectors along k.
template <typename T, int BN>
__device__ void step_product(const T* __restrict__ wh, const float* hs,
                             const T* __restrict__ px_t, int nrows, int GH,
                             int H, bool vec, float* pre) {
  constexpr int V = Vec<T>::V;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int j0 = warp * kRows; j0 < GH; j0 += kWarps * kRows) {
    float acc[kRows][BN];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int n = 0; n < BN; ++n) acc[r][n] = 0.f;
    if (vec) {
      const int nv = H / V;
      for (int c = lane; c < nv; c += 32) {
        float w[kRows][V];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int j = j0 + r;
          if (j < GH) {
            load_vec(wh + static_cast<int64_t>(j) * H + c * V, w[r]);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) w[r][v] = 0.f;
          }
        }
#pragma unroll
        for (int n = 0; n < BN; ++n) {
          float h[V];
          const float4* hp = reinterpret_cast<const float4*>(hs + n * H + c * V);
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            const float4 f = hp[q];
            h[4 * q] = f.x;
            h[4 * q + 1] = f.y;
            h[4 * q + 2] = f.z;
            h[4 * q + 3] = f.w;
          }
#pragma unroll
          for (int r = 0; r < kRows; ++r)
#pragma unroll
            for (int v = 0; v < V; ++v) acc[r][n] = fmaf(w[r][v], h[v], acc[r][n]);
        }
      }
    } else {
      for (int k = lane; k < H; k += 32) {
        float w[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int j = j0 + r;
          w[r] = j < GH ? to_f(wh[static_cast<int64_t>(j) * H + k]) : 0.f;
        }
#pragma unroll
        for (int n = 0; n < BN; ++n) {
          const float h = hs[n * H + k];
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[r][n] = fmaf(w[r], h, acc[r][n]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int n = 0; n < BN; ++n) acc[r][n] = warp_sum(acc[r][n]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = j0 + r;
        if (j >= GH) continue;
#pragma unroll
        for (int n = 0; n < BN; ++n)
          if (n < nrows)
            pre[n * GH + j] =
                to_f(px_t[static_cast<int64_t>(n) * GH + j]) + acc[r][n];
      }
    }
  }
}

// K4a, streaming design: grid of ceil(N / BN) blocks, block b owning
// batch rows [b * BN, b * BN + nrows). Dynamic shared memory: pre
// [BN, G*H], hs [BN, H], c [BN, H] (lstm), all float32.
template <typename T, int MODE, int BN>
__global__ void __launch_bounds__(kThreads)
    rnn_fwd_stream(const T* __restrict__ px, const T* __restrict__ h0,
                   const T* __restrict__ c0, const T* __restrict__ wh,
                   T* __restrict__ ys, T* __restrict__ cs,
                   T* __restrict__ hT, T* __restrict__ cT, int steps, int N,
                   int H, int reverse, int vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int G = MODE == kLstm ? 4 : 1;
  const int GH = G * H;
  float* pre = smem;
  float* hs = pre + BN * GH;
  float* cst = hs + BN * H;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int nrows = N - row0 < BN ? static_cast<int>(N - row0) : BN;

  for (int i = threadIdx.x; i < BN * H; i += kThreads) {
    const int n = i / H;
    const int64_t g = (row0 + n) * H + (i - n * H);
    hs[i] = n < nrows ? to_f(h0[g]) : 0.f;
    if (MODE == kLstm) cst[i] = n < nrows ? to_f(c0[g]) : 0.f;
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    const int64_t t = reverse ? steps - 1 - s : s;
    const bool last = s == steps - 1;
    step_product<T, BN>(wh, hs, px + (t * N + row0) * GH, nrows, GH, H, vec,
                        pre);
    __syncthreads();
    for (int i = threadIdx.x; i < nrows * H; i += kThreads) {
      const int n = i / H;
      const int u = i - n * H;
      const int64_t g = (t * N + row0 + n) * H + u;
      const float* p = pre + n * GH;
      float h2;
      if (MODE == kLstm) {
        const float ig = sigmoid(p[u]);
        const float fg = sigmoid(p[H + u]);
        const float gg = tanhf(p[2 * H + u]);
        const float og = sigmoid(p[3 * H + u]);
        const float c2 = fg * cst[i] + ig * gg;
        h2 = og * tanhf(c2);
        cst[i] = c2;
        cs[g] = from_f<T>(c2);
        if (last) cT[(row0 + n) * H + u] = from_f<T>(c2);
      } else if (MODE == kRelu) {
        h2 = fmaxf(p[u], 0.f);
      } else {
        h2 = tanhf(p[u]);
      }
      hs[i] = round_t<T>(h2);
      ys[g] = from_f<T>(h2);
      if (last) hT[(row0 + n) * H + u] = from_f<T>(h2);
    }
    __syncthreads();
  }
}

// K4b's scan, streaming design: the same tiling as K4a, time walked the
// other way. Dynamic shared memory: pre [BN, G*H] (the recomputed
// pre-activations, then the rounded dpre in place), hs [BN, H], dh
// [BN, H], dc [BN, H] (lstm), partial sums [slices, BN, H], all float32.
template <typename T, int MODE, int BN>
__global__ void __launch_bounds__(kThreads)
    rnn_bwd_stream(const T* __restrict__ px, const T* __restrict__ ys,
                   const T* __restrict__ hprev, const T* __restrict__ cprev,
                   const T* __restrict__ cs, const T* __restrict__ wh,
                   const T* __restrict__ dys, const T* __restrict__ dhT,
                   const T* __restrict__ dcT, T* __restrict__ dpx,
                   T* __restrict__ dh0, T* __restrict__ dc0, int steps, int N,
                   int H, int reverse, int vec, int slices) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int G = MODE == kLstm ? 4 : 1;
  const int GH = G * H;
  float* pre = smem;
  float* hs = pre + BN * GH;
  float* dhc = hs + BN * H;
  float* dcc = dhc + BN * H;
  float* part = dcc + BN * H;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int nrows = N - row0 < BN ? static_cast<int>(N - row0) : BN;

  for (int i = threadIdx.x; i < BN * GH; i += kThreads) pre[i] = 0.f;
  for (int i = threadIdx.x; i < BN * H; i += kThreads) {
    const int n = i / H;
    const int64_t g = (row0 + n) * H + (i - n * H);
    hs[i] = 0.f;
    dhc[i] = n < nrows ? to_f(dhT[g]) : 0.f;
    if (MODE == kLstm) dcc[i] = n < nrows ? to_f(dcT[g]) : 0.f;
  }
  __syncthreads();

  const int chunk = (GH + slices - 1) / slices;
  for (int s = 0; s < steps; ++s) {
    const int64_t t = reverse ? s : steps - 1 - s;
    const bool last = s == steps - 1;
    const int64_t seq0 = (t * N + row0) * H;  // row0's unit 0 at step t
    if (MODE == kLstm) {
      for (int i = threadIdx.x; i < nrows * H; i += kThreads)
        hs[i] = to_f(hprev[seq0 + i]);
      __syncthreads();
      step_product<T, BN>(wh, hs, px + (t * N + row0) * GH, nrows, GH, H, vec,
                          pre);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < nrows * H; i += kThreads) {
      const int n = i / H;
      const int u = i - n * H;
      const float dh = dhc[i] + to_f(dys[seq0 + i]);
      float* p = pre + n * GH;
      T* dp = dpx + (t * N + row0 + n) * GH;
      if (MODE == kLstm) {
        const float ig = sigmoid(p[u]);
        const float fg = sigmoid(p[H + u]);
        const float gg = tanhf(p[2 * H + u]);
        const float og = sigmoid(p[3 * H + u]);
        const float tc = tanhf(to_f(cs[seq0 + i]));
        const float d_o = dh * tc;
        const float dc = dcc[i] + dh * og * (1.f - tc * tc);
        const float d[4] = {dc * gg * ig * (1.f - ig),
                            dc * to_f(cprev[seq0 + i]) * fg * (1.f - fg),
                            dc * ig * (1.f - gg * gg),
                            d_o * og * (1.f - og)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T r = from_f<T>(d[q]);
          dp[q * H + u] = r;
          p[q * H + u] = to_f(r);
        }
        const float dcp = dc * fg;
        dcc[i] = dcp;
        if (last) dc0[(row0 + n) * H + u] = from_f<T>(dcp);
      } else {
        const float y = to_f(ys[seq0 + i]);
        const float d = MODE == kRelu ? (y > 0.f ? dh : 0.f)
                                      : dh * (1.f - y * y);
        const T r = from_f<T>(d);
        dp[u] = r;
        p[u] = to_f(r);
      }
    }
    __syncthreads();
    // dh_{t-1}[n, k] = sum_j dpre[n, j] wh[j, k]: slice q sums its chunk
    // of j, the slices are added in order below
    for (int i = threadIdx.x; i < slices * H; i += kThreads) {
      const int q = i / H;
      const int k = i - q * H;
      const int j1 = min(GH, (q + 1) * chunk);
      float acc[BN];
#pragma unroll
      for (int n = 0; n < BN; ++n) acc[n] = 0.f;
      for (int j = q * chunk; j < j1; ++j) {
        const float w = to_f(wh[static_cast<int64_t>(j) * H + k]);
#pragma unroll
        for (int n = 0; n < BN; ++n) acc[n] = fmaf(pre[n * GH + j], w, acc[n]);
      }
#pragma unroll
      for (int n = 0; n < BN; ++n) part[(q * BN + n) * H + k] = acc[n];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BN * H; i += kThreads) {
      const int n = i / H;
      const int k = i - n * H;
      float v = part[n * H + k];
      for (int q = 1; q < slices; ++q) v += part[(q * BN + n) * H + k];
      dhc[i] = v;
      if (last && n < nrows) dh0[(row0 + n) * H + k] = from_f<T>(v);
    }
    __syncthreads();
  }
}

// dWh[j, k] = sum_m dpx[m, j] * hprev[m, k] over the M = T * N rows, in
// float32, one 32 x 32 output tile a block, each output summed over m in
// order (no atomics, no split of m).
constexpr int kTile = 32;
constexpr int kDwhThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kDwhThreads)
    rnn_dwh_kernel(const T* __restrict__ dpx, const T* __restrict__ hprev,
                   float* __restrict__ dwh, int64_t M, int GH, int H) {
  __shared__ float a[kTile][kTile + 1];
  __shared__ float b[kTile][kTile + 1];
  const int j0 = blockIdx.y * kTile, k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int64_t m0 = 0; m0 < M; m0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kDwhThreads) {
      const int r = e / kTile, c = e % kTile;
      const int64_t m = m0 + r;
      const int j = j0 + c, k = k0 + c;
      a[r][c] = (m < M && j < GH) ? to_f(dpx[m * GH + j]) : 0.f;
      b[r][c] = (m < M && k < H) ? to_f(hprev[m * H + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      const float a0 = a[r][2 * ty], a1 = a[r][2 * ty + 1];
      const float b0 = b[r][2 * tx], b1 = b[r][2 * tx + 1];
      acc[0][0] = fmaf(a0, b0, acc[0][0]);
      acc[0][1] = fmaf(a0, b1, acc[0][1]);
      acc[1][0] = fmaf(a1, b0, acc[1][0]);
      acc[1][1] = fmaf(a1, b1, acc[1][1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y) {
      const int j = j0 + 2 * ty + x, k = k0 + 2 * tx + y;
      if (j < GH && k < H) dwh[static_cast<int64_t>(j) * H + k] = acc[x][y];
    }
}

// ---------------------------------------------------------------------------
// The cluster design (wh resident across a thread-block cluster)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int rup(int a, int b) {
  return (a + b - 1) / b * b;
}

// One block's shared memory in the cluster design, in bytes from the
// start of the dynamic buffer. Block r of a cluster of P owns the hidden
// units [r U, r U + U) (U = ceil(H / P) rounded up to a 16-byte vector of
// T, so slices move between blocks as whole vectors; the last blocks may
// own fewer or none) and keeps the G rows of wh of each unit: local row
// g U + ul is wh's row g H + r U + ul. Rows and columns past the valid
// ones are zero, so every product may run over whole tiles. Strides are
// one 16-byte vector past a multiple of 32 bytes, so rows fall on other
// banks.
struct Layout {
  int U, GU, GUp, KP, LD, LDG, LDW, Rp;
  int whs, h, pre, dwh, dps, part, recv, bytes;
};

template <typename T>
__host__ __device__ inline Layout layout(int G, int H, int R, int P,
                                         bool bwd) {
  // bfloat16 pads rows and gate rows to the mma tile (16), float32 to 4
  constexpr int pad = sizeof(T) == 4 ? 4 : 16;
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
  constexpr int sz = static_cast<int>(sizeof(T));
  Layout L = {};
  L.U = rup((H + P - 1) / P, vec);
  L.GU = G * L.U;
  L.GUp = rup(L.GU, pad);
  L.KP = rup(H, 16);
  L.LD = L.KP + vec;
  L.LDG = L.GUp + vec;
  L.LDW = L.KP + 8;  // dWh rows: 8-byte pairs of lanes on other banks
  L.Rp = rup(R, pad);
  int o = 0;
  L.whs = o;                                      // wh slice [GUp][LD] T
  o += rup(L.GUp * L.LD * sz, 16);
  if (bwd) {
    L.dwh = o;                                    // dWh rows [GU][LDW] f32
    o += L.GU * L.LDW * 4;
  }
  L.h = o;                        // h (K4a) or h_{t-1} (K4b) [2][Rp][LD] T
  o += rup(2 * L.Rp * L.LD * sz, 16);
  L.pre = o;                                      // products [Rp][GUp] f32
  o += rup(L.Rp * L.GUp * 4, 16);
  if (bwd) {
    L.dps = o;                                    // rounded dpre [Rp][LDG] T
    o += rup(L.Rp * L.LDG * sz, 16);
    L.part = o;                                   // dh partial [Rp][LDW] f32
    o += L.Rp * L.LDW * 4;
    L.recv = o;                                   // dh partials [2][P][Rp][U]
    o += rup(2 * P * L.Rp * L.U * 4, 16);
  }
  L.bytes = o;
  return L;
}

// a 16-byte vector of T from shared memory, as float32
__device__ __forceinline__ void lds(const float* p, float (&o)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  o[0] = f.x;
  o[1] = f.y;
  o[2] = f.z;
  o[3] = f.w;
}
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(e[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// bfloat16 mma.sync m16n8k16 with float32 accumulators, fragments by
// ldmatrix (the helpers of flash_attention.cu)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// bfloat16 products take the tensor cores (mma.sync), float32 products the
// CUDA cores (the source note says why)
template <typename T>
constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;

// pre[n][j] = sum_k h[n][k] wh_s[j][k] (the forward's product, and K4b's
// recomputation of it) for rows n < rows4 (nr rounded up to 4) and local
// gate rows j < GU. CUDA cores: a thread takes 4 rows and gate rows j and
// j + ceil(GU / 2), 16-byte vectors along k; a warp's lanes share rows.
template <typename T>
__device__ void product_nt_simt(const T* h, const T* w, float* pre, int rows4,
                                const Layout& L) {
  constexpr int V = Vec<T>::V;
  const int LT = (L.GU + 1) >> 1;
  const int tiles = (rows4 >> 2) * LT;
  for (int tile = threadIdx.x; tile < tiles; tile += kThreads) {
    const int nt = tile / LT, j0 = tile - nt * LT, j1 = j0 + LT;
    const T* a = h + nt * 4 * L.LD;
    const T* b0 = w + j0 * L.LD;
    const T* b1 = w + j1 * L.LD;
    float acc[4][2] = {};
    for (int k = 0; k < L.KP; k += V) {
      float w0[V], w1[V];
      lds(b0 + k, w0);
      lds(b1 + k, w1);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float x[V];
        lds(a + m * L.LD + k, x);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          acc[m][0] = fmaf(x[v], w0[v], acc[m][0]);
          acc[m][1] = fmaf(x[v], w1[v], acc[m][1]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float* o = pre + (nt * 4 + m) * L.GUp;
      o[j0] = acc[m][0];
      if (j1 < L.GU) o[j1] = acc[m][1];
    }
  }
}

// The same product on the tensor cores (bfloat16): a warp takes a 16-row
// tile by 16 gate rows, both operands by ldmatrix from shared memory
// (wh_s's rows are the B operand's columns, as k in q k^T).
__device__ void product_nt_mma(const __nv_bfloat16* h,
                               const __nv_bfloat16* w, float* pre,
                               const Layout& L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NT = L.GUp / 16, tasks = (L.Rp / 16) * NT;
  for (int task = warp; task < tasks; task += kWarps) {
    const int mt = task / NT, nt = task - mt * NT;
    const __nv_bfloat16* ap =
        h + (mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * L.LD +
        8 * (lane >> 4);
    const __nv_bfloat16* bp =
        w + (nt * 16 + (lane & 7) + 8 * (lane >> 4)) * L.LD +
        8 * ((lane >> 3) & 1);
    float c[2][4] = {};
    for (int k = 0; k < L.KP; k += 16) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, ap + k);
      ldsm_x4(bf, bp + k);
      mma_bf16(c[0], af, bf[0], bf[1]);
      mma_bf16(c[1], af, bf[2], bf[3]);
    }
    const int row = mt * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = nt * 16 + 8 * j + 2 * (lane & 3);
      if (col < L.GU) {
        pre[row * L.GUp + col] = c[j][0];
        pre[(row + 8) * L.GUp + col] = c[j][2];
      }
      if (col + 1 < L.GU) {
        pre[row * L.GUp + col + 1] = c[j][1];
        pre[(row + 8) * L.GUp + col + 1] = c[j][3];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void product_nt(const T* h, const T* w, float* pre,
                                           int rows4, const Layout& L) {
  if constexpr (kMma<T>)
    product_nt_mma(h, w, pre, L);
  else
    product_nt_simt(h, w, pre, rows4, L);
}

// K4b's dh partial: part[n][k] = sum_j dps[n][j] wh_s[j][k] over the
// block's own gate rows j, for every k (push_partials sends it on).
// CUDA cores: a thread takes 4 rows by one 16-byte vector along k.
template <typename T>
__device__ void partial_dh_simt(const T* dps, const T* w, float* part,
                                int nr, const Layout& L) {
  constexpr int V = Vec<T>::V;
  const int KT = L.KP / V;
  const int tiles = ((nr + 3) >> 2) * KT;
  for (int tile = threadIdx.x; tile < tiles; tile += kThreads) {
    const int nt = tile / KT, k0 = (tile - nt * KT) * V;
    const T* a = dps + nt * 4 * L.LDG;
    float acc[4][V] = {};
    for (int j = 0; j < L.GU; ++j) {
      float x[V];
      lds(w + j * L.LD + k0, x);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float d = to_f(a[m * L.LDG + j]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = fmaf(d, x[v], acc[m][v]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      float4* o = reinterpret_cast<float4*>(part + (nt * 4 + m) * L.LDW + k0);
#pragma unroll
      for (int v = 0; v < V / 4; ++v)
        o[v] = make_float4(acc[m][4 * v], acc[m][4 * v + 1], acc[m][4 * v + 2],
                           acc[m][4 * v + 3]);
    }
  }
}

// The same on the tensor cores: a warp takes a 16-row tile by 16 columns
// k; wh_s is the B operand as stored ([j][k], j the reduction), so its
// fragments come by ldmatrix.trans (as v in p v).
__device__ void partial_dh_mma(const __nv_bfloat16* dps,
                               const __nv_bfloat16* w, float* part,
                               const Layout& L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NT = L.KP / 16, tasks = (L.Rp / 16) * NT;
  for (int task = warp; task < tasks; task += kWarps) {
    const int mt = task / NT, nt = task - mt * NT;
    const __nv_bfloat16* ap =
        dps + (mt * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * L.LDG +
        8 * (lane >> 4);
    const __nv_bfloat16* bp =
        w + ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.LD + nt * 16 +
        8 * (lane >> 4);
    float c[2][4] = {};
    for (int j = 0; j < L.GUp; j += 16) {
      uint32_t af[4], bf[4];
      ldsm_x4(af, ap + j);
      ldsm_x4_t(bf, bp + j * L.LD);
      mma_bf16(c[0], af, bf[0], bf[1]);
      mma_bf16(c[1], af, bf[2], bf[3]);
    }
    const int row = mt * 16 + (lane >> 2);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = nt * 16 + 8 * q + 2 * (lane & 3);
      *reinterpret_cast<float2*>(part + row * L.LDW + k) =
          make_float2(c[q][0], c[q][1]);
      *reinterpret_cast<float2*>(part + (row + 8) * L.LDW + k) =
          make_float2(c[q][2], c[q][3]);
    }
  }
}

template <typename T>
__device__ __forceinline__ void partial_dh(const T* dps, const T* w,
                                           float* part, int nr,
                                           const Layout& L) {
  if constexpr (kMma<T>)
    partial_dh_mma(dps, w, part, L);
  else
    partial_dh_simt(dps, w, part, nr, L);
}

// dWh_s[j][k] += sum_n dps[n][j] h[n][k], this step's sum formed in fresh
// registers and then added to the float32 rows in shared memory (so the
// sum over steps is float32 additions in step order). CUDA cores: a
// thread takes 4 gate rows by one 16-byte vector along k.
template <typename T>
__device__ void dwh_step_simt(const T* dps, const T* h, float* dwh, int nr,
                              const Layout& L) {
  constexpr int V = Vec<T>::V;
  const int KT = L.KP / V;
  const int tiles = ((L.GU + 3) >> 2) * KT;
  for (int tile = threadIdx.x; tile < tiles; tile += kThreads) {
    const int jt = tile / KT, k0 = (tile - jt * KT) * V, j0 = jt * 4;
    float acc[4][V] = {};
    for (int n = 0; n < nr; ++n) {
      float x[V];
      lds(h + n * L.LD + k0, x);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float d = to_f(dps[n * L.LDG + j0 + m]);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = fmaf(d, x[v], acc[m][v]);
      }
    }
    // the tile's rows: all loads first, then the stores
    float4 f[4][V / 4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int v = 0; v < V / 4; ++v)
        f[m][v] = j0 + m < L.GU ? reinterpret_cast<const float4*>(
                                      dwh + (j0 + m) * L.LDW + k0)[v]
                                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (j0 + m >= L.GU) break;
      float4* o = reinterpret_cast<float4*>(dwh + (j0 + m) * L.LDW + k0);
#pragma unroll
      for (int v = 0; v < V / 4; ++v)
        o[v] = make_float4(f[m][v].x + acc[m][4 * v],
                           f[m][v].y + acc[m][4 * v + 1],
                           f[m][v].z + acc[m][4 * v + 2],
                           f[m][v].w + acc[m][4 * v + 3]);
    }
  }
}

// The same on the tensor cores: a warp takes 16 gate rows by 16 columns;
// both operands are stored with the reduction (the batch row) first, so
// both fragments come by ldmatrix.trans.
__device__ void dwh_step_mma(const __nv_bfloat16* dps, const __nv_bfloat16* h,
                             float* dwh, const Layout& L) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int NT = L.KP / 16, tasks = (L.GUp / 16) * NT;
  for (int task = warp; task < tasks; task += kWarps) {
    const int mt = task / NT, nt = task - mt * NT;
    const __nv_bfloat16* ap = dps + ((lane & 7) + 8 * (lane >> 4)) * L.LDG +
                              mt * 16 + 8 * ((lane >> 3) & 1);
    const __nv_bfloat16* bp = h + ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.LD +
                              nt * 16 + 8 * (lane >> 4);
    float c[2][4] = {};
    for (int n = 0; n < L.Rp; n += 16) {
      uint32_t af[4], bf[4];
      ldsm_x4_t(af, ap + n * L.LDG);
      ldsm_x4_t(bf, bp + n * L.LD);
      mma_bf16(c[0], af, bf[0], bf[1]);
      mma_bf16(c[1], af, bf[2], bf[3]);
    }
    // the four pairs of this lane: all loads first, then the stores
    const int row = mt * 16 + (lane >> 2);
    float2* o[2][2];
    float2 f[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        o[q][half] = reinterpret_cast<float2*>(
            dwh + (row + 8 * half) * L.LDW + nt * 16 + 8 * q + 2 * (lane & 3));
        f[q][half] =
            row + 8 * half < L.GU ? *o[q][half] : make_float2(0.f, 0.f);
      }
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (row + 8 * half >= L.GU) continue;
        f[q][half].x += c[q][2 * half];
        f[q][half].y += c[q][2 * half + 1];
        *o[q][half] = f[q][half];
      }
  }
}

template <typename T>
__device__ __forceinline__ void dwh_step(const T* dps, const T* h, float* dwh,
                                         int nr, const Layout& L) {
  if constexpr (kMma<T>)
    dwh_step_mma(dps, h, dwh, L);
  else
    dwh_step_simt(dps, h, dwh, nr, L);
}

// the block's slice of wh: local row g U + ul <- wh row g H + u0 + ul
template <typename T>
__device__ void load_slice(const T* __restrict__ wh, T* whs, int H, int u0,
                           int nu, const Layout& L) {
  for (int i = threadIdx.x; i < L.GUp * L.LD; i += kThreads) {
    const int j = i / L.LD, k = i - j * L.LD;
    const int g = j / L.U, ul = j - g * L.U;
    whs[i] = (j < L.GU && ul < nu && k < H)
                 ? wh[static_cast<int64_t>(g * H + u0 + ul) * H + k]
                 : from_f<T>(0.f);
  }
}

// rows [row0, row0 + nr) of a [*, H] sequence at step t into h [Rp][LD]
template <typename T>
__device__ void load_rows(const T* __restrict__ seq, T* h, int64_t base,
                          int nr, int H, const Layout& L) {
  for (int i = threadIdx.x; i < nr * H; i += kThreads) {
    const int n = i / H;
    h[n * L.LD + (i - n * H)] = seq[base + i];
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The block's place: P and its rank in the cluster, the cluster's batch
// rows [row0, row0 + nr) and the block's units [u0, u0 + nu).
struct Place {
  int P, rank, nr, u0, nu;
  int64_t row0;
};

__device__ __forceinline__ Place place(cg::cluster_group& cluster, int N,
                                       int H, int R, int U) {
  Place p;
  p.P = static_cast<int>(cluster.num_blocks());
  p.rank = static_cast<int>(cluster.block_rank());
  p.row0 = static_cast<int64_t>(blockIdx.x / p.P) * R;
  p.nr = N - p.row0 < R ? static_cast<int>(N - p.row0) : R;
  p.u0 = p.rank * U;
  p.nu = H - p.u0 < U ? (H - p.u0 > 0 ? H - p.u0 : 0) : U;
  return p;
}

// The exchange, in 16-byte vectors through distributed shared memory.
// K4a: the block's slice of the next h buffer (its units of each of its
// rows, written locally) into the same place of every other block's.
template <typename T>
__device__ void push_slice(cg::cluster_group& cluster, T* hn, const Place& p,
                           const Layout& L) {
  constexpr int V = 16 / sizeof(T);
  const int peers = p.P - 1, nv = (p.nu + V - 1) / V;
  if (peers == 0) return;
  for (int i = threadIdx.x; i < p.nr * nv * peers; i += kThreads) {
    const int q = i % peers, nvq = i / peers;
    const int n = nvq / nv, v = nvq - n * nv;
    const int off = n * L.LD + p.u0 + v * V;
    const uint4 v16 = *reinterpret_cast<const uint4*>(hn + off);
    *reinterpret_cast<uint4*>(
        cluster.map_shared_rank(hn + off, q + (q >= p.rank))) = v16;
  }
}

// K4b: the block's dh partial for every k into k's owner s = k / U, at
// slot `rank` of s's receive buffer `recv` ([P][Rp][U] for this parity);
// U is a multiple of 4, so a vector of 4 columns has one owner.
__device__ void push_partials(cg::cluster_group& cluster, const float* part,
                              float* recv, const Place& p, int H,
                              const Layout& L) {
  const int nv = (H + 3) >> 2;
  for (int i = threadIdx.x; i < p.nr * nv; i += kThreads) {
    const int n = i / nv, k = (i - n * nv) * 4, s = k / L.U;
    float* dst = recv + (p.rank * L.Rp + n) * L.U + (k - s * L.U);
    *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, s)) =
        *reinterpret_cast<const float4*>(part + n * L.LDW + k);
  }
}

// A thread's elements of the block's (batch row, unit) pairs: i = tid +
// e kThreads for e < kElems, (n, ul) = (i / nu, i % nu). rnn_design keeps
// R nu <= kElems kThreads, so the carries and the prefetched inputs of a
// step fit in registers.
constexpr int kElems = 2;

// K4a, cluster design. Grid: ceil(N / R) clusters of P blocks. Each step:
// the block's product from its resident slice, the gates and cell update
// of its units (c carried in registers, px prefetched a step ahead), then
// round(h_t) of its units goes into every block's h buffer of the next
// parity through distributed shared memory; the block arrives at the
// cluster barrier, stores ys / cs (off the barrier's release), prefetches
// the next step's px and waits. Why two buffers suffice: a block writes
// buffer (s + 1) & 1 in step s, after the barrier of step s - 1; every
// block read that buffer in step s - 1, before arriving at that barrier.
// The next reads of it come after the barrier of step s, which no block
// passes before every block has written.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    rnn_fwd_cluster(const T* __restrict__ px, const T* __restrict__ h0,
                    const T* __restrict__ c0, const T* __restrict__ wh,
                    T* __restrict__ ys, T* __restrict__ cs,
                    T* __restrict__ hT, T* __restrict__ cT, int steps, int N,
                    int H, int R, int reverse) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int G = MODE == kLstm ? 4 : 1;
  const Layout L = layout<T>(G, H, R, cluster.num_blocks(), false);
  const Place p = place(cluster, N, H, R, L.U);
  const int64_t GH = G * H;
  T* whs = reinterpret_cast<T*>(sm + L.whs);
  T* hb = reinterpret_cast<T*>(sm + L.h);
  float* pre = reinterpret_cast<float*>(sm + L.pre);
  const int ne = p.nr * p.nu;

  load_slice(wh, whs, H, p.u0, p.nu, L);
  for (int i = threadIdx.x; i < 2 * L.Rp * L.LD; i += kThreads)
    hb[i] = from_f<T>(0.f);
  __syncthreads();
  load_rows(h0, hb, p.row0 * H, p.nr, H, L);
  float c[kElems];
  T x[kElems][G];  // px of the step, converted at use (no wait at the load)
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = threadIdx.x + e * kThreads;
    if (i >= ne) continue;
    const int n = i / p.nu, u = p.u0 + (i - n * p.nu);
    if (MODE == kLstm) c[e] = to_f(c0[(p.row0 + n) * H + u]);
    const int64_t m = (reverse ? steps - 1 : 0) * static_cast<int64_t>(N) +
                      p.row0 + n;
#pragma unroll
    for (int g = 0; g < G; ++g) x[e][g] = px[m * GH + g * H + u];
  }
  cluster.sync();  // every block runs and has its buffers before a push

  const int rows4 = (p.nr + 3) & ~3;
  for (int s = 0; s < steps; ++s) {
    const int64_t t = reverse ? steps - 1 - s : s;
    const bool last = s == steps - 1;
    product_nt(hb + (s & 1) * L.Rp * L.LD, whs, pre, rows4, L);
    __syncthreads();
    T* hn = hb + ((s + 1) & 1) * L.Rp * L.LD;
    T hv[kElems], cv[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i >= ne) continue;
      const int n = i / p.nu, ul = i - n * p.nu, u = p.u0 + ul;
      const float* q = pre + n * L.GUp + ul;
      float h2;
      if (MODE == kLstm) {
        const float ig = sigmoid(to_f(x[e][0]) + q[0]);
        const float fg = sigmoid(to_f(x[e][1]) + q[L.U]);
        const float gg = tanhf(to_f(x[e][2]) + q[2 * L.U]);
        const float og = sigmoid(to_f(x[e][3]) + q[3 * L.U]);
        c[e] = fg * c[e] + ig * gg;
        h2 = og * tanhf(c[e]);
        cv[e] = from_f<T>(c[e]);
      } else if (MODE == kRelu) {
        h2 = fmaxf(to_f(x[e][0]) + q[0], 0.f);
      } else {
        h2 = tanhf(to_f(x[e][0]) + q[0]);
      }
      hv[e] = from_f<T>(h2);
      if (!last) hn[n * L.LD + u] = hv[e];
    }
    if (!last) {
      __syncthreads();
      push_slice(cluster, hn, p, L);
      cluster_arrive();
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i >= ne) continue;
      const int n = i / p.nu, u = p.u0 + (i - n * p.nu);
      const int64_t m = t * N + p.row0 + n;
      ys[m * H + u] = hv[e];
      if (MODE == kLstm) cs[m * H + u] = cv[e];
      if (last) {
        hT[(p.row0 + n) * H + u] = hv[e];
        if (MODE == kLstm) cT[(p.row0 + n) * H + u] = cv[e];
      } else {
        const int64_t mn = (reverse ? t - 1 : t + 1) * N + p.row0 + n;
#pragma unroll
        for (int g = 0; g < G; ++g) x[e][g] = px[mn * GH + g * H + u];
      }
    }
    if (!last) cluster_wait();
  }
}

// rows [row0, row0 + nr) of a [*, H] sequence from `base` into h [Rp][LD]:
// 16-byte cp.async copies when every row is whole 16-byte vectors (wait
// with cp_async_wait), else a synchronous copy
template <typename T>
__device__ void load_rows_async(const T* __restrict__ seq, T* h, int64_t base,
                                int nr, int H, const Layout& L) {
  constexpr int V = 16 / sizeof(T);
  if ((H % V) != 0 || (reinterpret_cast<uintptr_t>(seq) & 15u) != 0) {
    load_rows(seq, h, base, nr, H, L);
    return;
  }
  const int per = H / V;
  for (int i = threadIdx.x; i < nr * per; i += kThreads) {
    const int n = i / per, v = i - n * per;
    const T* src = seq + base + static_cast<int64_t>(n) * H + v * V;
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(h + n * L.LD + v * V));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// K4b, cluster design: the same clusters and slices, time walked the
// other way; dh and dc carried in registers. Step s:
//   1. start copying the next step's h_{t-1} rows into the other h buffer;
//   2. dh = carry + dys and dc give dpre of the block's units from the
//      gates (pre_t, computed in step s - 1, and the inputs prefetched
//      then), kept rounded in shared memory;
//   3. the partial dh_{t-1} over the block's own gate rows, for every k,
//      pushed to k's owner (slot = this block's rank, buffer = parity);
//   4. arrive at the cluster barrier; while the others arrive, off the
//      serial chain: the stores of dpx (rounded dpre), the next step's
//      inputs into registers, this step's dWh rows, and pre for the next
//      step from the copied h_{t-1} (it does not depend on the carry);
//   5. wait; each block adds its units' P partials in rank order (a fixed
//      sum: every run repeats bit for bit).
// The receive buffers alternate by parity for the reason K4a's h buffers
// do. dWh rows stay in shared memory and are written once at the end,
// into dwh (one cluster) or into the cluster's slice of a workspace that
// rnn_dwh_sum adds in cluster order.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
    rnn_bwd_cluster(const T* __restrict__ px, const T* __restrict__ ys,
                    const T* __restrict__ hprev, const T* __restrict__ cprev,
                    const T* __restrict__ cs, const T* __restrict__ wh,
                    const T* __restrict__ dys, const T* __restrict__ dhT,
                    const T* __restrict__ dcT, T* __restrict__ dpx,
                    T* __restrict__ dh0, T* __restrict__ dc0,
                    float* __restrict__ dwh_out, int steps, int N, int H,
                    int R, int reverse) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int G = MODE == kLstm ? 4 : 1;
  // the inputs of an element's step: dys, then px's G gates, cs, c_{t-1}
  // (lstm) or ys (the simple modes)
  constexpr int NX = MODE == kLstm ? 7 : 2;
  const Layout L = layout<T>(G, H, R, cluster.num_blocks(), true);
  const Place p = place(cluster, N, H, R, L.U);
  const int64_t GH = G * H;
  T* whs = reinterpret_cast<T*>(sm + L.whs);
  float* dwh = reinterpret_cast<float*>(sm + L.dwh);
  T* hb = reinterpret_cast<T*>(sm + L.h);
  float* pre = reinterpret_cast<float*>(sm + L.pre);
  T* dps = reinterpret_cast<T*>(sm + L.dps);
  float* part = reinterpret_cast<float*>(sm + L.part);
  float* recv = reinterpret_cast<float*>(sm + L.recv);
  const int ne = p.nr * p.nu;

  // the inputs of step t into x (for the elements this thread owns)
  auto fetch = [&](int64_t t, T (&x)[kElems][NX]) {
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i >= ne) continue;
      const int n = i / p.nu, u = p.u0 + (i - n * p.nu);
      const int64_t m = t * N + p.row0 + n;
      x[e][0] = dys[m * H + u];
      if (MODE == kLstm) {
#pragma unroll
        for (int g = 0; g < G; ++g) x[e][1 + g] = px[m * GH + g * H + u];
        x[e][5] = cs[m * H + u];
        x[e][6] = cprev[m * H + u];
      } else {
        x[e][1] = ys[m * H + u];
      }
    }
  };

  load_slice(wh, whs, H, p.u0, p.nu, L);
  for (int i = threadIdx.x; i < L.GU * L.LDW; i += kThreads) dwh[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * L.Rp * L.LD; i += kThreads)
    hb[i] = from_f<T>(0.f);
  for (int i = threadIdx.x; i < L.Rp * L.LDG; i += kThreads)
    dps[i] = from_f<T>(0.f);
  float dh[kElems], dc[kElems];
  T x[kElems][NX];  // a step's inputs, converted at use
#pragma unroll
  for (int e = 0; e < kElems; ++e) {
    const int i = threadIdx.x + e * kThreads;
    if (i >= ne) continue;
    const int n = i / p.nu, u = p.u0 + (i - n * p.nu);
    dh[e] = to_f(dhT[(p.row0 + n) * H + u]);
    if (MODE == kLstm) dc[e] = to_f(dcT[(p.row0 + n) * H + u]);
  }
  const int64_t t0 = reverse ? 0 : steps - 1;
  fetch(t0, x);
  __syncthreads();
  const int rows4 = (p.nr + 3) & ~3;
  load_rows(hprev, hb, (t0 * N + p.row0) * H, p.nr, H, L);
  if (MODE == kLstm) {
    __syncthreads();
    product_nt(hb, whs, pre, rows4, L);
  }
  cluster.sync();  // every block runs and has its buffers before a push

  for (int s = 0; s < steps; ++s) {
    const int64_t t = reverse ? s : steps - 1 - s;
    const int64_t tn = reverse ? t + 1 : t - 1;
    const bool last = s == steps - 1;
    T* hs = hb + (s & 1) * L.Rp * L.LD;         // h_{t-1} of this step
    T* hn = hb + ((s + 1) & 1) * L.Rp * L.LD;   // of the next
    if (!last) load_rows_async(hprev, hn, (tn * N + p.row0) * H, p.nr, H, L);
    T dp[kElems][G];
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i >= ne) continue;
      const int n = i / p.nu, ul = i - n * p.nu;
      const float d_h = dh[e] + to_f(x[e][0]);
      T* dl = dps + n * L.LDG + ul;
      if (MODE == kLstm) {
        const float* q = pre + n * L.GUp + ul;
        const float ig = sigmoid(to_f(x[e][1]) + q[0]);
        const float fg = sigmoid(to_f(x[e][2]) + q[L.U]);
        const float gg = tanhf(to_f(x[e][3]) + q[2 * L.U]);
        const float og = sigmoid(to_f(x[e][4]) + q[3 * L.U]);
        const float th = tanhf(to_f(x[e][5]));
        const float d_o = d_h * th;
        const float d_c = dc[e] + d_h * og * (1.f - th * th);
        const float d[4] = {d_c * gg * ig * (1.f - ig),
                            d_c * to_f(x[e][6]) * fg * (1.f - fg),
                            d_c * ig * (1.f - gg * gg),
                            d_o * og * (1.f - og)};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dp[e][g] = from_f<T>(d[g]);
          dl[g * L.U] = dp[e][g];
        }
        dc[e] = d_c * fg;
      } else {
        const float y = to_f(x[e][1]);
        const float d = MODE == kRelu ? (y > 0.f ? d_h : 0.f)
                                      : d_h * (1.f - y * y);
        dp[e][0] = from_f<T>(d);
        dl[0] = dp[e][0];
      }
    }
    __syncthreads();
    float* rv = recv + (s & 1) * p.P * L.Rp * L.U;
    partial_dh(dps, whs, part, p.nr, L);
    __syncthreads();
    push_partials(cluster, part, rv, p, H, L);
    cluster_arrive();
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i >= ne) continue;
      const int n = i / p.nu, u = p.u0 + (i - n * p.nu);
      T* o = dpx + (t * N + p.row0 + n) * GH + u;
#pragma unroll
      for (int g = 0; g < G; ++g) o[g * H] = dp[e][g];
      if (MODE == kLstm && last)
        dc0[(p.row0 + n) * H + u] = from_f<T>(dc[e]);
    }
    dwh_step(dps, hs, dwh, p.nr, L);
    if (!last) {
      fetch(tn, x);
      cp_async_wait();
      __syncthreads();
      if (MODE == kLstm) product_nt(hn, whs, pre, rows4, L);
    }
    cluster_wait();
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      const int i = threadIdx.x + e * kThreads;
      if (i >= ne) continue;
      const int n = i / p.nu, ul = i - n * p.nu;
      float v = rv[n * L.U + ul];
      for (int r = 1; r < p.P; ++r) v += rv[(r * L.Rp + n) * L.U + ul];
      dh[e] = v;
      if (last) dh0[(p.row0 + n) * H + p.u0 + ul] = from_f<T>(v);
    }
    __syncthreads();
  }
  float* out = dwh_out + static_cast<int64_t>(blockIdx.x / p.P) * GH * H;
  for (int i = threadIdx.x; i < L.GU * H; i += kThreads) {
    const int j = i / H, k = i - j * H;
    const int g = j / L.U, ul = j - g * L.U;
    if (ul < p.nu)
      out[static_cast<int64_t>(g * H + p.u0 + ul) * H + k] =
          dwh[j * L.LDW + k];
  }
}

// dwh[i] = sum over clusters c, in order, of work[c][i]
__global__ void rnn_dwh_sum(const float* __restrict__ work,
                            float* __restrict__ dwh, int64_t count,
                            int clusters) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < count; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float v = work[i];
    for (int c = 1; c < clusters; ++c) v += work[c * count + i];
    dwh[i] = v;
  }
}

// The serial floor of the cluster design: K4a's launch, shared memory and
// exchange (each block pushes its units' h to every block, one cluster
// barrier a step), for the same number of steps, with no product, no
// gates and no global memory.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    rnn_floor_cluster(int steps, int N, int H, int R, int G) {
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Layout L = layout<T>(G, H, R, cluster.num_blocks(), false);
  const Place p = place(cluster, N, H, R, L.U);
  T* hb = reinterpret_cast<T*>(sm + L.h);
  cluster.sync();
  for (int s = 0; s < steps; ++s) {
    T* hn = hb + ((s + 1) & 1) * L.Rp * L.LD;
    const T hv = from_f<T>(static_cast<float>(s));
    for (int i = threadIdx.x; i < p.nr * p.nu; i += kThreads) {
      const int n = i / p.nu;
      hn[n * L.LD + p.u0 + (i - n * p.nu)] = hv;
    }
    __syncthreads();
    push_slice(cluster, hn, p, L);
    cluster.sync();
  }
}

// A cluster launch of `kernel`: ceil(N / R) clusters of P blocks, the
// layout's dynamic shared memory.
template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, int N, int R, int P, size_t smem,
                           cudaStream_t st, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess && P > 8)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) {
    cudaGetLastError();  // not left behind for the next launch's check
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((N + R - 1) / R * P));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(P);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int gates(int mode) { return mode == kLstm ? 4 : 1; }

// the rows of wh take 16-byte vectors: H a multiple of the vector width
// and wh aligned
int vec_ok(int dtype, const void* wh, int H) {
  const int V = dtype == 0 ? 4 : 8;
  return H % V == 0 && aligned16(wh);
}

// slices of the streaming K4b's dh_{t-1} reduction: enough (H, slice)
// threads to use the block, at most kMaxSlices
int slices_for(int H) {
  int s = kThreads / H;
  return s < 1 ? 1 : (s > kMaxSlices ? kMaxSlices : s);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int MODE, int BN>
cudaError_t launch_fwd_stream(const void* px, const void* h0, const void* c0,
                              const void* wh, void* ys, void* cs, void* hT,
                              void* cT, int steps, int N, int H, int reverse,
                              int vec, cudaStream_t st) {
  const int GH = gates(MODE) * H;
  const size_t smem = sizeof(float) * static_cast<size_t>(BN) * (GH + 2 * H);
  auto kernel = rnn_fwd_stream<T, MODE, BN>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = static_cast<unsigned>((N + BN - 1) / BN);
  kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(px), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<const T*>(wh),
      static_cast<T*>(ys), static_cast<T*>(cs), static_cast<T*>(hT),
      static_cast<T*>(cT), steps, N, H, reverse, vec);
  return cudaGetLastError();
}

template <typename T, int MODE, int BN>
cudaError_t launch_bwd_stream(const void* px, const void* ys,
                              const void* hprev, const void* cprev,
                              const void* cs, const void* wh, const void* dys,
                              const void* dhT, const void* dcT, void* dpx,
                              void* dh0, void* dc0, int steps, int N, int H,
                              int reverse, int vec, cudaStream_t st) {
  const int GH = gates(MODE) * H;
  const int slices = slices_for(H);
  const size_t smem = sizeof(float) * static_cast<size_t>(BN) *
                      (GH + 3 * H + static_cast<size_t>(slices) * H);
  auto kernel = rnn_bwd_stream<T, MODE, BN>;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const unsigned blocks = static_cast<unsigned>((N + BN - 1) / BN);
  kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const T*>(px), static_cast<const T*>(ys),
      static_cast<const T*>(hprev), static_cast<const T*>(cprev),
      static_cast<const T*>(cs), static_cast<const T*>(wh),
      static_cast<const T*>(dys), static_cast<const T*>(dhT),
      static_cast<const T*>(dcT), static_cast<T*>(dpx), static_cast<T*>(dh0),
      static_cast<T*>(dc0), steps, N, H, reverse, vec, slices);
  return cudaGetLastError();
}

template <typename T, int MODE>
cudaError_t launch_fwd_cluster(const void* px, const void* h0, const void* c0,
                               const void* wh, void* ys, void* cs, void* hT,
                               void* cT, int steps, int N, int H, int R, int P,
                               int reverse, cudaStream_t st) {
  const Layout L = layout<T>(gates(MODE), H, R, P, false);
  if (R * L.U > kElems * kThreads) return cudaErrorInvalidValue;
  return launch_cluster(
      rnn_fwd_cluster<T, MODE>, N, R, P, L.bytes, st,
      static_cast<const T*>(px), static_cast<const T*>(h0),
      static_cast<const T*>(c0), static_cast<const T*>(wh),
      static_cast<T*>(ys), static_cast<T*>(cs), static_cast<T*>(hT),
      static_cast<T*>(cT), steps, N, H, R, reverse);
}

// K4b's cluster launch, then (more than one cluster) the sum of the
// clusters' dWh slices of `work` [clusters, G*H, H]
template <typename T, int MODE>
cudaError_t launch_bwd_cluster(const void* px, const void* ys,
                               const void* hprev, const void* cprev,
                               const void* cs, const void* wh,
                               const void* dys, const void* dhT,
                               const void* dcT, void* dpx, void* dh0,
                               void* dc0, void* dwh, void* work, int steps,
                               int N, int H, int R, int P, int reverse,
                               cudaStream_t st) {
  const int clusters = (N + R - 1) / R;
  if (clusters > 1 && work == nullptr) return cudaErrorInvalidValue;
  float* out = static_cast<float*>(clusters > 1 ? work : dwh);
  const Layout L = layout<T>(gates(MODE), H, R, P, true);
  if (R * L.U > kElems * kThreads) return cudaErrorInvalidValue;
  cudaError_t e = launch_cluster(
      rnn_bwd_cluster<T, MODE>, N, R, P, L.bytes, st,
      static_cast<const T*>(px), static_cast<const T*>(ys),
      static_cast<const T*>(hprev), static_cast<const T*>(cprev),
      static_cast<const T*>(cs), static_cast<const T*>(wh),
      static_cast<const T*>(dys), static_cast<const T*>(dhT),
      static_cast<const T*>(dcT), static_cast<T*>(dpx), static_cast<T*>(dh0),
      static_cast<T*>(dc0), out, steps, N, H, R, reverse);
  if (e != cudaSuccess || clusters == 1) return e;
  const int64_t count = static_cast<int64_t>(gates(MODE)) * H * H;
  const int64_t blocks = (count + 255) / 256 < 1024 ? (count + 255) / 256
                                                     : 1024;
  rnn_dwh_sum<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      static_cast<const float*>(work), static_cast<float*>(dwh), count,
      clusters);
  return cudaGetLastError();
}

// shared memory of one block of the cluster design
long long cluster_bytes(int dtype, int mode, int H, int R, int P, bool bwd) {
  return dtype == 0 ? layout<float>(gates(mode), H, R, P, bwd).bytes
                    : layout<__nv_bfloat16>(gates(mode), H, R, P, bwd).bytes;
}

// cudaOccupancyMaxActiveClusters of one cluster kernel at its launch
template <typename T, int MODE>
cudaError_t max_clusters(int H, int R, int P, bool bwd, int* n) {
  const size_t smem = layout<T>(gates(MODE), H, R, P, bwd).bytes;
  const void* k =
      bwd ? reinterpret_cast<const void*>(rnn_bwd_cluster<T, MODE>)
          : reinterpret_cast<const void*>(rnn_fwd_cluster<T, MODE>);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess && P > 8)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(P));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(P);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(n, k, &cfg);
  }
  if (e != cudaSuccess) cudaGetLastError();  // not left for the next launch
  return e;
}

}  // namespace

#define MXTT_RNN_DISPATCH(dtype, mode, bn, CALL)                          \
  do {                                                                    \
    if ((bn) != 1 && (bn) != 2 && (bn) != 4) return cudaErrorInvalidValue; \
    const int key_ = ((dtype) * 3 + (mode)) * 3 + ((bn) == 1 ? 0 : (bn) == 2 ? 1 : 2); \
    switch (key_) {                                                       \
      case 0: err = CALL(float, kLstm, 1); break;                         \
      case 1: err = CALL(float, kLstm, 2); break;                         \
      case 2: err = CALL(float, kLstm, 4); break;                         \
      case 3: err = CALL(float, kRelu, 1); break;                         \
      case 4: err = CALL(float, kRelu, 2); break;                         \
      case 5: err = CALL(float, kRelu, 4); break;                         \
      case 6: err = CALL(float, kTanh, 1); break;                         \
      case 7: err = CALL(float, kTanh, 2); break;                         \
      case 8: err = CALL(float, kTanh, 4); break;                         \
      case 9: err = CALL(__nv_bfloat16, kLstm, 1); break;                 \
      case 10: err = CALL(__nv_bfloat16, kLstm, 2); break;                \
      case 11: err = CALL(__nv_bfloat16, kLstm, 4); break;                \
      case 12: err = CALL(__nv_bfloat16, kRelu, 1); break;                \
      case 13: err = CALL(__nv_bfloat16, kRelu, 2); break;                \
      case 14: err = CALL(__nv_bfloat16, kRelu, 4); break;                \
      case 15: err = CALL(__nv_bfloat16, kTanh, 1); break;                \
      case 16: err = CALL(__nv_bfloat16, kTanh, 2); break;                \
      default: err = CALL(__nv_bfloat16, kTanh, 4); break;                \
    }                                                                     \
  } while (0)

#define MXTT_RNN_MODES(dtype, mode, CALL)                                 \
  do {                                                                    \
    switch ((dtype) * 3 + (mode)) {                                       \
      case 0: err = CALL(float, kLstm); break;                            \
      case 1: err = CALL(float, kRelu); break;                            \
      case 2: err = CALL(float, kTanh); break;                            \
      case 3: err = CALL(__nv_bfloat16, kLstm); break;                    \
      case 4: err = CALL(__nv_bfloat16, kRelu); break;                    \
      default: err = CALL(__nv_bfloat16, kTanh); break;                   \
    }                                                                     \
  } while (0)

// dtype 0 float32, 1 bfloat16; mode 0 lstm, 1 rnn_relu, 2 rnn_tanh
static bool rnn_args_ok(int dtype, int mode, int rows, int P) {
  if (dtype != 0 && dtype != 1) return false;
  if (mode < 0 || mode > 2) return false;
  return P == 0 || (P >= 1 && P <= 16 && rows >= 1);
}

// K4a. c0, cs and cT are null outside lstm. P = 0: the streaming design,
// `rows` batch rows a block (1, 2 or 4); P in 1..16: the cluster design,
// clusters of P blocks owning `rows` batch rows each.
extern "C" int mxtt_rnn_fwd(int dtype, int mode, const void* px,
                            const void* h0, const void* c0, const void* wh,
                            void* ys, void* cs, void* hT, void* cT, int steps,
                            int N, int H, int rows, int P, int reverse,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!rnn_args_ok(dtype, mode, rows, P)) return cudaErrorInvalidValue;
  if ((mode == kLstm) != (c0 != nullptr && cs != nullptr && cT != nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (P == 0) {
    const int vec = vec_ok(dtype, wh, H);
#define MXTT_FWD(T, MODE, BN)                                                  \
  launch_fwd_stream<T, MODE, BN>(px, h0, c0, wh, ys, cs, hT, cT, steps, N, H, \
                                 reverse, vec, st)
    MXTT_RNN_DISPATCH(dtype, mode, rows, MXTT_FWD);
#undef MXTT_FWD
  } else {
#define MXTT_FWD(T, MODE)                                                   \
  launch_fwd_cluster<T, MODE>(px, h0, c0, wh, ys, cs, hT, cT, steps, N, H, \
                              rows, P, reverse, st)
    MXTT_RNN_MODES(dtype, mode, MXTT_FWD);
#undef MXTT_FWD
  }
  return static_cast<int>(err);
}

// K4b: the scan and dWh (float32 [G*H, H]). px, cprev, cs, dcT and dc0
// are used for lstm only (null otherwise), ys for the simple modes only
// (null for lstm). P and rows as in mxtt_rnn_fwd. The cluster design with
// more than one cluster needs `work`, float32 [clusters, G*H, H].
extern "C" int mxtt_rnn_bwd(int dtype, int mode, const void* px,
                            const void* ys, const void* hprev,
                            const void* cprev, const void* cs, const void* wh,
                            const void* dys, const void* dhT, const void* dcT,
                            void* dpx, void* dh0, void* dc0, void* dwh,
                            void* work, int steps, int N, int H, int rows,
                            int P, int reverse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!rnn_args_ok(dtype, mode, rows, P)) return cudaErrorInvalidValue;
  const bool lstm = mode == kLstm;
  if (lstm != (px != nullptr && cprev != nullptr && cs != nullptr &&
               dcT != nullptr && dc0 != nullptr))
    return cudaErrorInvalidValue;
  if (!lstm && ys == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  if (P != 0) {
#define MXTT_BWD(T, MODE)                                                   \
  launch_bwd_cluster<T, MODE>(px, ys, hprev, cprev, cs, wh, dys, dhT, dcT, \
                              dpx, dh0, dc0, dwh, work, steps, N, H, rows, \
                              P, reverse, st)
    MXTT_RNN_MODES(dtype, mode, MXTT_BWD);
#undef MXTT_BWD
    return static_cast<int>(err);
  }
  const int vec = vec_ok(dtype, wh, H);
#define MXTT_BWD(T, MODE, BN)                                                 \
  launch_bwd_stream<T, MODE, BN>(px, ys, hprev, cprev, cs, wh, dys, dhT, dcT, \
                                 dpx, dh0, dc0, steps, N, H, reverse, vec, st)
  MXTT_RNN_DISPATCH(dtype, mode, rows, MXTT_BWD);
#undef MXTT_BWD
  if (err != cudaSuccess) return static_cast<int>(err);
  const int GH = gates(mode) * H;
  const dim3 grid((H + kTile - 1) / kTile, (GH + kTile - 1) / kTile);
  const int64_t M = static_cast<int64_t>(steps) * N;
  if (dtype == 0) {
    rnn_dwh_kernel<float><<<grid, kDwhThreads, 0, st>>>(
        static_cast<const float*>(dpx), static_cast<const float*>(hprev),
        static_cast<float*>(dwh), M, GH, H);
  } else {
    rnn_dwh_kernel<__nv_bfloat16><<<grid, kDwhThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dpx),
        static_cast<const __nv_bfloat16*>(hprev), static_cast<float*>(dwh), M,
        GH, H);
  }
  return static_cast<int>(cudaGetLastError());
}

#undef MXTT_RNN_DISPATCH

// The cluster design's serial floor: `steps` cluster barriers with K4a's
// exchange and launch (P, rows), no arithmetic.
extern "C" int mxtt_rnn_floor(int dtype, int mode, int steps, int N, int H,
                              int rows, int P, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!rnn_args_ok(dtype, mode, rows, P) || P == 0)
    return cudaErrorInvalidValue;
  const size_t smem = cluster_bytes(dtype, mode, H, rows, P, false);
  const int G = gates(mode);
  cudaError_t err =
      dtype == 0
          ? launch_cluster(rnn_floor_cluster<float>, N, rows, P, smem, st,
                           steps, N, H, rows, G)
          : launch_cluster(rnn_floor_cluster<__nv_bfloat16>, N, rows, P, smem,
                           st, steps, N, H, rows, G);
  return static_cast<int>(err);
}

// Shared memory of one block of the cluster design's K4a (bwd 0) or K4b
// (bwd 1), in bytes (ops/fused_rnn.py cluster_smem_bytes mirrors it).
extern "C" long long mxtt_rnn_smem_bytes(int dtype, int mode, int H,
                                         int rows, int P, int bwd) {
  return cluster_bytes(dtype, mode, H, rows, P, bwd != 0);
}

// How many clusters of the cluster design's K4a (bwd 0) or K4b (bwd 1)
// the card runs at once (cudaOccupancyMaxActiveClusters); a negative
// value is a CUDA error.
extern "C" int mxtt_rnn_max_clusters(int dtype, int mode, int H, int rows,
                                     int P, int bwd) {
  if (!rnn_args_ok(dtype, mode, rows, P) || P == 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  cudaError_t err = cudaSuccess;
#define MXTT_OCC(T, MODE) max_clusters<T, MODE>(H, rows, P, bwd != 0, &n)
  MXTT_RNN_MODES(dtype, mode, MXTT_OCC);
#undef MXTT_OCC
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

#undef MXTT_RNN_MODES

extern "C" const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
