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
// per float32 byte it must move (about 254 per bfloat16 byte), against a
// ridge of about 20 for float32 on the CUDA cores (67 TFLOP/s over 3.35
// TB/s), about 50 for 3xTF32 on the tensor cores (495 / 3 TFLOP/s) and
// about 295 for bfloat16 (989 TFLOP/s). The backward does 2.5 times the
// forward's flops on twice its bytes.
//
// What the design does about it: both directions run their products on
// the tensor cores (mma.sync; float32 as TF32 split three ways, below),
// stage their tiles in the input dtype with 16-byte cp.async copies,
// double-buffered so that the next tile loads while the current one is
// multiplied, and keep the probabilities in registers.
//
// Forward: one block per (bh, 64-row q tile), four warps, each owning 16
// query rows; blocks are issued longest first. Q is staged once (in
// bfloat16 its fragments then stay in registers); tiles of 64 keys
// stream up to the diagonal, and a warp skips a tile that holds no live
// key for its rows. Per tile a warp computes s = q k^T, masks it (only
// on the diagonal tile and the ragged tail), runs the online softmax in
// registers (row maxima and sums by trees, across a fragment's quad by
// two shuffles; each thread keeps its share of the row sum, added across
// the quad once at the end; exp(x - m) as 2^((x - m) log2 e) on the
// special-function unit), rescales its running output and adds p v,
// summed in fresh registers. Products are issued so that consecutive
// ones go to different accumulators. out, m and l are written by one
// thread each. On the card, expf's longer instruction sequence and
// blocks of eight warps (128 query rows) were both slower.
//   float32:  s = q k^T and p v in 3xTF32 m16n8k8, p as the A fragment of
//             the second product through the permuted k index (below).
//   bfloat16: m16n8k16 bfloat16 products, twice the work of a TF32
//             m16n8k8 per instruction, with ldmatrix fragments (.trans
//             for v): s = q k^T is one product, exact in float32 but for
//             the additions; p is split into two bfloat16 parts (hi = p
//             rounded, lo = the rest rounded), two products, so that p
//             keeps ~16 bits as the reference's float32 p v does. The
//             shared 3xTF32 path (one product for s, two for p v) took
//             0.183 ms at the training shape against cuDNN's 0.039
//             (tools/attention_ab.py, chip_smoke.py; H100 80GB HBM3,
//             700 W).
//
// Backward: the products run on the tensor cores (mma.sync, TF32 split
// three ways for float32 accuracy, below), in two kernels that together
// compute seven products where a kernel with a dq reduction would compute
// five, because that needs atomics or a dq partial per key tile (134 MB
// at the training shape). Each stages the next tile with 16-byte
// cp.async copies while the current one is multiplied.
//   dq:      one block per (bh, 64-row q tile), last tile first; each warp
//            owns 16 query rows: s = q k^T and dp = dO v^T per 64-key
//            tile, ds in registers, dq += ds k.
//   dk, dv:  one block per (bh, 64-key tile), first tile first; each warp
//            owns 16 keys: s^T = k q^T and dp^T = v dO^T per query tile
//            (64 rows, 32 at D = 128) at or below the diagonal, p^T and
//            ds^T in registers, dv += p^T dO and dk += ds^T q.
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
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kBC = 64;  // keys of a tile
constexpr int kBQ = 64;  // query rows of a forward / dq tile
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// tensor-core products, shared by the forward and the backward
// ---------------------------------------------------------------------------

// The forward's two products and the backward's five run on the tensor
// cores: mma.sync m16n8k8 over TF32 operands with float32
// accumulators, each product split into three (3xTF32): x = hi + lo and
// a b = hi_a hi_b + hi_a lo_b + lo_a hi_b, which keeps the error at
// float32's level (the lo lo term is below it). In the backward,
// bfloat16 inputs are exact in TF32, so their lo parts are 0 and their lo
// terms are skipped; p and ds stay float32 and keep theirs (m16n8k16 bf16
// products would round them to 8 bits, or take two products each to
// split them, as the forward's bfloat16 path does with p).
// A warp owns 16 rows of its block's tile. Fragments are read from shared
// memory rows of D + 16 / sizeof(T) elements (a 16-byte pad), so that the
// eight lanes that read one fragment column, or the four pairs that read
// one permuted fragment row, hit distinct banks. The probabilities and
// dS never leave registers: the k index of the second product is
// permuted (logical k = t and t + 4 at physical columns 2 t and 2 t + 1),
// under which an accumulator fragment of one product is the A fragment of
// the next, and the B fragment is read with the same permutation.

// x = hi + lo: hi is x rounded to TF32 (to nearest, ties away, on the bit
// pattern), lo = x - hi exactly, passed whole: the tensor core reads the
// top 19 bits of a TF32 operand. Integer arithmetic, because
// cvt.rna.tf32.f32 issues at a fraction of the ALU rate: with it the
// splits, not the products, set both kernels' time on an H100
// (tools/attention_ab.py against a tree that splits with it).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t b = __float_as_uint(x);
  hi = (b + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first. An operand read from
// bfloat16 data is exact in TF32 (its lo part is 0), so its lo term is
// skipped: a bfloat16 q k^T takes one product, not three.
template <bool kExactA, bool kExactB>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (!kExactA) mma_tf32(c, a.lo, b.hi);
  if constexpr (!kExactB) mma_tf32(c, a.hi, b.lo);
  mma_tf32(c, a.hi, b.hi);
}

// A fragment of the 16 x 8 block at (r0, k0) of a row-major tile
template <int LD, typename T>
__device__ __forceinline__ FragA frag_a(const T* X, int r0, int k0, int g,
                                        int t) {
  FragA f;
  const T* p = X + (r0 + g) * LD + k0 + t;
  split(to_f32(*p), f.hi[0], f.lo[0]);
  split(to_f32(p[8 * LD]), f.hi[1], f.lo[1]);
  split(to_f32(p[4]), f.hi[2], f.lo[2]);
  split(to_f32(p[8 * LD + 4]), f.hi[3], f.lo[3]);
  return f;
}

// B fragment (k0 .. k0 + 7) x (n0 .. n0 + 7) of a tile stored n-major,
// X[n][k] (B = X^T: the keys of Q K^T, the queries of K Q^T)
template <int LD, typename T>
__device__ __forceinline__ FragB frag_b_n(const T* X, int n0, int k0, int g,
                                          int t) {
  FragB f;
  const T* p = X + (n0 + g) * LD + k0 + t;
  split(to_f32(*p), f.hi[0], f.lo[0]);
  split(to_f32(p[4]), f.hi[1], f.lo[1]);
  return f;
}

// B fragment of a tile stored k-major, X[k][n], rows read in the
// permuted order (physical rows k0 + 2 t and k0 + 2 t + 1)
template <int LD, typename T>
__device__ __forceinline__ FragB frag_b_k(const T* X, int k0, int n0, int g,
                                          int t) {
  FragB f;
  const T* p = X + (k0 + 2 * t) * LD + n0 + g;
  split(to_f32(*p), f.hi[0], f.lo[0]);
  split(to_f32(p[LD]), f.hi[1], f.lo[1]);
  return f;
}

// an accumulator fragment (16 x 8) as the A fragment of the next product,
// under the permuted k order
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// acc[c] += sum_n A_n B_(n, c) over the 8-column tiles c of a product
// whose A fragments are the accumulator fragments a[n] (16 x 8 each) and
// whose B is a tile stored k-major. Each call sums into fresh registers,
// eight column tiles at a time, and adds them to acc once: the tensor
// core truncates each addition into its accumulator, so a chain of a few
// hundred products into one accumulator (dq over the key tiles, dk and
// dv over the query tiles) would drift by ~1e-4 relative.
template <int NA, int NC, int LD, bool kExactB, typename T>
__device__ __forceinline__ void accumulate_tile(float (&acc)[NC][4],
                                                const float (&a)[NA][4],
                                                const T* B, int g, int t) {
#pragma unroll
  for (int c0 = 0; c0 < NC; c0 += 8) {
    float tile[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      tile[c][0] = tile[c][1] = tile[c][2] = tile[c][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const FragA f = frag_a_from_c(a[n]);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + c < NC)
          mma3<false, kExactB>(tile[c], f,
                               frag_b_k<LD>(B, 8 * n, 8 * (c0 + c), g, t));
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c0 + c < NC)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c0 + c][e] += tile[c][e];
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
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

// Stage rows [r0, r0 + nrows) of a contiguous [*, D] tensor (at its row
// 0) with 16-byte cp.async copies into rows of LD elements; rows at or
// past `nvalid` are filled with zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0,
                                           int nrows, int nvalid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int CH = D / kVec;
  for (int e = threadIdx.x; e < nrows * CH; e += kThreads) {
    const int r = e / CH;
    const int c = (e - r * CH) * kVec;
    const bool ok = r0 + r < nvalid;
    cp_async16(dst + r * LD + c, src + (size_t)(ok ? r0 + r : 0) * D + c,
               ok ? 16 : 0);
  }
}

// elements of a staged row: D and a 16-byte pad
template <typename T, int D>
__host__ __device__ constexpr int tile_ld() {
  return D + 16 / (int)sizeof(T);
}
// forward: the Q tile (64 rows), two stages of K and V tiles (64 keys)
template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return (size_t)(kBQ + 4 * kBC) * tile_ld<T, D>() * sizeof(T);
}
// dq: Q and dO tiles (64 rows), two stages of K and V tiles (64 keys)
template <typename T, int D>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * kBQ + 4 * kBC) * tile_ld<T, D>() * sizeof(T);
}
// dk/dv: K and V tiles (64 keys), two stages of Q and dO tiles (BR rows)
// and of the rows' m, l and delta
template <typename T, int D, int BR>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * kBC + 4 * BR) * tile_ld<T, D>() * sizeof(T) +
         (size_t)2 * 3 * BR * sizeof(float);
}

// The forward's bfloat16 path: mma.sync m16n8k16 over bfloat16 operands
// with float32 accumulators, fragments loaded by ldmatrix (.trans for v,
// whose rows are keys). Its A fragment of p is the accumulator fragments
// of s in their natural order: keys 16 j .. 16 j + 15 are n-tiles 2 j and
// 2 j + 1 of s.

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bfloat16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 (16-byte aligned)
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

// (x, y) = hi + lo in bfloat16 pairs: hi rounded to nearest, lo = the
// rest rounded, ~16 bits of x and y between them
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - f.x, y - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// s += q k^T over D for a warp's 16 rows (Q rows r0 ..) and a tile's 64
// keys: one bfloat16 product per 16 x 8 x 16 step, exact but for the
// additions into the accumulator
template <int D, int LD>
__device__ __forceinline__ void scores_bf16(float (&s)[kBC / 8][4],
                                            const uint32_t (&qa)[D / 16][4],
                                            const __nv_bfloat16* Kt,
                                            int lane) {
  const int half = lane / 16;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    const uint32_t (&a)[4] = qa[kk / 16];
#pragma unroll
    for (int n = 0; n < kBC / 8; n += 2) {
      uint32_t b[4];  // keys of n-tiles n and n + 1, d kk .. kk + 15
      ldsm_x4(b, Kt + (8 * n + lane % 8 + 8 * half) * LD + kk +
                     8 * ((lane / 8) % 2));
      mma_bf16(s[n], a, b[0], b[1]);
      mma_bf16(s[n + 1], a, b[2], b[3]);
    }
  }
}

// acc[c] += p v over a tile's 64 keys: p (the float32 accumulator
// fragments of s) split into two bfloat16 parts, as the reference's p v
// is a float32 product, each part one bfloat16 product, the small part
// first. Sums into fresh registers, eight column tiles at a time, and
// adds them to acc once, as accumulate_tile does.
template <int NC, int LD>
__device__ __forceinline__ void add_pv_bf16(float (&acc)[NC][4],
                                            const float (&p)[kBC / 8][4],
                                            const __nv_bfloat16* Vt,
                                            int lane) {
  constexpr int NB = NC < 8 ? NC : 8;  // column tiles summed at a time
  uint32_t ph[kBC / 16][4], pl[kBC / 16][4];
#pragma unroll
  for (int j = 0; j < kBC / 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* f = p[2 * j + q / 2] + 2 * (q % 2);
      split_bf16(f[0], f[1], ph[j][q], pl[j][q]);
    }
  const int half = lane / 16;
#pragma unroll
  for (int c0 = 0; c0 < NC; c0 += NB) {
    float tile[NB][4];
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tile[c][0] = tile[c][1] = tile[c][2] = tile[c][3] = 0.f;
#pragma unroll
    for (int j = 0; j < kBC / 16; ++j) {
      uint32_t b[NB / 2][4];  // keys 16 j .., column tiles c0 + 2 i, + 1
#pragma unroll
      for (int i = 0; i < NB / 2; ++i)
        ldsm_x4_t(b[i], Vt + (16 * j + lane % 16) * LD + 8 * (c0 + 2 * i) +
                            8 * half);
      // independent accumulators back to back: the lo parts, then the hi
#pragma unroll
      for (int c = 0; c < NB; ++c)
        mma_bf16(tile[c], pl[j], b[c / 2][2 * (c % 2)],
                 b[c / 2][2 * (c % 2) + 1]);
#pragma unroll
      for (int c = 0; c < NB; ++c)
        mma_bf16(tile[c], ph[j], b[c / 2][2 * (c % 2)],
                 b[c / 2][2 * (c % 2) + 1]);
    }
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + c][e] += tile[c][e];
  }
}

// acc[c] += p v as accumulate_tile computes it (the same products in the
// same order into each accumulator), issued so that consecutive products
// go to different accumulators: the forward's float32 p v. It holds
// eight B fragments at once, registers the backward's kernels do not
// have at D = 128, which keep accumulate_tile.
template <int NA, int NC, int LD>
__device__ __forceinline__ void accumulate_tile_fwd(float (&acc)[NC][4],
                                                    const float (&a)[NA][4],
                                                    const float* B, int g,
                                                    int t) {
  constexpr int NB = NC < 8 ? NC : 8;
#pragma unroll
  for (int c0 = 0; c0 < NC; c0 += NB) {
    float tile[NB][4];
#pragma unroll
    for (int c = 0; c < NB; ++c)
      tile[c][0] = tile[c][1] = tile[c][2] = tile[c][3] = 0.f;
#pragma unroll
    for (int n = 0; n < NA; ++n) {
      const FragA f = frag_a_from_c(a[n]);
      FragB fb[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        fb[c] = frag_b_k<LD>(B, 8 * n, 8 * (c0 + c), g, t);
#pragma unroll
      for (int c = 0; c < NB; ++c) mma_tf32(tile[c], f.lo, fb[c].hi);
#pragma unroll
      for (int c = 0; c < NB; ++c) mma_tf32(tile[c], f.hi, fb[c].lo);
#pragma unroll
      for (int c = 0; c < NB; ++c) mma_tf32(tile[c], f.hi, fb[c].hi);
    }
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c0 + c][e] += tile[c][e];
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// 2^x on the special-function unit (ex2.approx.ftz, ~2 ulp); 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     int Tq, int Tk, float scale, int causal) {
  constexpr int LD = tile_ld<T, D>();
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int NK = kBC / 8;  // key columns of a tile, in fragments
  constexpr int ND = D / 8;
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + kBQ * LD;  // [2][kBC][LD], then Vs [2][kBC][LD]
  T* Vs = Ks + 2 * kBC * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = blockIdx.y;
  // the last query tile has the most keys: it is issued first
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * kBQ;
  const int r0 = q0 + 16 * warp;  // this warp's first row
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  // causal: key tiles past this tile's last query row are dead
  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  const int ntiles = (kend + kBC - 1) / kBC;
  stage_rows<T, D, LD>(Qs, q + bh * Tq * D, q0, kBQ, Tq);
  stage_rows<T, D, LD>(Ks, kb, 0, kBC, Tk);
  stage_rows<T, D, LD>(Vs, vb, 0, kBC, Tk);
  cp_async_commit();
  const float scale2 = scale * kLog2e;  // exp(x - m) = 2^((x - m) log2 e)

  // this thread's two rows (gq and gq + 8 of the warp's 16): the running
  // max, its share of the running sum, and its columns of the output
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c) o[c][0] = o[c][1] = o[c][2] = o[c][3] = 0.f;
  uint32_t qa[kBf16 ? D / 16 : 1][4];  // bfloat16: this warp's Q fragments

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBC;
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // the next K/V tile loads during this one
      stage_rows<T, D, LD>(Ks + (buf ^ 1) * kBC * LD, kb, k0 + kBC, kBC, Tk);
      stage_rows<T, D, LD>(Vs + (buf ^ 1) * kBC * LD, vb, k0 + kBC, kBC, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kBf16) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D; kk += 16)
          ldsm_x4(qa[kk / 16], Qs + (16 * warp + lane % 16) * LD + kk +
                                   8 * (lane / 16));
      }
    }
    // a warp whose rows are all past the end, or (causal) all before the
    // tile's first key, has nothing to add from it
    if (r0 < Tq && (!causal || k0 <= r0 + 15)) {
      const T* Kt = Ks + buf * kBC * LD;
      const T* Vt = Vs + buf * kBC * LD;
      float s[NK][4];
#pragma unroll
      for (int n = 0; n < NK; ++n)
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if constexpr (kBf16) {
        scores_bf16<D, LD>(s, qa, Kt, lane);
      } else {
#pragma unroll
        for (int kk = 0; kk < D; kk += 8) {  // mma3's products and order,
          const FragA aq = frag_a<LD>(Qs, 16 * warp, kk, gq, tq);
          FragB bk[NK];  // consecutive ones into different accumulators
#pragma unroll
          for (int n = 0; n < NK; ++n)
            bk[n] = frag_b_n<LD>(Kt, 8 * n, kk, gq, tq);
#pragma unroll
          for (int n = 0; n < NK; ++n) mma_tf32(s[n], aq.lo, bk[n].hi);
#pragma unroll
          for (int n = 0; n < NK; ++n) mma_tf32(s[n], aq.hi, bk[n].lo);
#pragma unroll
          for (int n = 0; n < NK; ++n) mma_tf32(s[n], aq.hi, bk[n].hi);
        }
      }
      // mask only where a key of the tile is dead for a row of this warp
      // (the diagonal tile, the ragged tail); the row max of the scaled
      // scores is the scaled max, as scaling by scale >= 0 is monotone
      const bool inside = k0 + kBC <= Tk && (!causal || k0 + kBC - 1 <= r0);
      if (!inside) {
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * n + 2 * tq + (e & 1);
            const int qi = r0 + gq + 8 * (e >> 1);
            if (kj >= Tk || (causal && kj > qi)) s[n][e] = -INFINITY;
          }
      }
      float mx[2];  // by a tree: short dependency chains
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t[NK];
#pragma unroll
        for (int n = 0; n < NK; ++n)
          t[n] = fmaxf(s[n][2 * h], s[n][2 * h + 1]);
#pragma unroll
        for (int w = NK / 2; w > 0; w /= 2)
#pragma unroll
          for (int n = 0; n < w; ++n) t[n] = fmaxf(t[n], t[n + w]);
        mx[h] = t[0];
      }
      float msl[2], alpha[2];  // m_safe log2 e; the old sums' rescale
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float t = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
        t = fmaxf(t, __shfl_xor_sync(kFull, t, 2));
        const float m_new = fmaxf(m[h], t * scale);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        msl[h] = m_safe * kLog2e;
        alpha[h] = exp2_approx((m[h] - m_safe) * kLog2e);  // 0 if m = -inf
        m[h] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NK; ++n)  // a masked score gives 2^-inf = 0
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = exp2_approx(fmaf(s[n][e], scale2, -msl[e >> 1]));
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // this thread's share, by a tree
        float t[NK];
#pragma unroll
        for (int n = 0; n < NK; ++n) t[n] = s[n][2 * h] + s[n][2 * h + 1];
#pragma unroll
        for (int w = NK / 2; w > 0; w /= 2)
#pragma unroll
          for (int n = 0; n < w; ++n) t[n] += t[n + w];
        l[h] = alpha[h] * l[h] + t[0];
      }
#pragma unroll
      for (int c = 0; c < ND; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c][e] *= alpha[e >> 1];
      if constexpr (kBf16)  // o += p v
        add_pv_bf16<ND, LD>(o, s, Vt, lane);
      else
        accumulate_tile_fwd<NK, ND, LD>(o, s, Vt, gq, tq);
    }
    __syncthreads();  // the tile is read before its stage is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int r = r0 + gq + 8 * h;
    if (r >= Tq) continue;
    const float inv = 1.f / fmaxf(l[h], 1e-20f);
    T* row = out + (bh * Tq + r) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c)
      store2(row + 8 * c + 2 * tq, o[c][2 * h] * inv, o[c][2 * h + 1] * inv);
    if (tq == 0) {
      m_out[bh * Tq + r] = m[h];
      l_out[bh * Tq + r] = l[h];
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
  constexpr int LD = tile_ld<T, D>();
  constexpr bool kX = std::is_same<T, __nv_bfloat16>::value;  // exact
  constexpr int NK = kBC / 8;  // key columns of a tile, in fragments
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Gs = Qs + kBQ * LD;
  T* Ks = Gs + kBQ * LD;  // [2][kBC][LD], then Vs [2][kBC][LD]
  T* Vs = Ks + 2 * kBC * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = blockIdx.x;
  // the last query tile has the most keys: it is issued first
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * kBQ;
  const T* kb = k + bh * Tk * D;
  const T* vb = v + bh * Tk * D;
  stage_rows<T, D, LD>(Qs, q + bh * Tq * D, q0, kBQ, Tq);
  stage_rows<T, D, LD>(Gs, g + bh * Tq * D, q0, kBQ, Tq);

  // this thread's two rows: max (0 where -inf), clamped denominator,
  // delta; rows past the end take values that keep their math finite
  float m_safe[2], inv_l[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + gq + 8 * h;
    const float mr = r < Tq ? m[bh * Tq + r] : 0.f;
    m_safe[h] = isfinite(mr) ? mr : 0.f;
    inv_l[h] = r < Tq ? 1.f / fmaxf(l[bh * Tq + r], 1e-20f) : 1.f;
    dd[h] = r < Tq ? delta[bh * Tq + r] : 0.f;
  }

  const int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  const int ntiles = (kend + kBC - 1) / kBC;
  stage_rows<T, D, LD>(Ks, kb, 0, kBC, Tk);
  stage_rows<T, D, LD>(Vs, vb, 0, kBC, Tk);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kBC;
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // the next K/V tile loads during this one
      stage_rows<T, D, LD>(Ks + (buf ^ 1) * kBC * LD, kb, k0 + kBC, kBC, Tk);
      stage_rows<T, D, LD>(Vs + (buf ^ 1) * kBC * LD, vb, k0 + kBC, kBC, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Kt = Ks + buf * kBC * LD;
    const T* Vt = Vs + buf * kBC * LD;

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      const FragA aq = frag_a<LD>(Qs, 16 * warp, kk, gq, tq);
      const FragA ag = frag_a<LD>(Gs, 16 * warp, kk, gq, tq);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        mma3<kX, kX>(s[n], aq, frag_b_n<LD>(Kt, 8 * n, kk, gq, tq));
        mma3<kX, kX>(dp[n], ag, frag_b_n<LD>(Vt, 8 * n, kk, gq, tq));
      }
    }
    // ds = p (dp - delta) scale, p recomputed from m and l; a fragment
    // wholly inside the live region skips the mask
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      const int klast = k0 + 8 * n + 7;
      const bool inside = klast < Tk && (!causal || klast <= q0 + 16 * warp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int qi = q0 + 16 * warp + gq + 8 * h;
        const int kj = k0 + 8 * n + 2 * tq + (e & 1);
        const bool live = inside || (kj < Tk && (!causal || kj <= qi));
        const float p = live ? expf(s[n][e] * scale - m_safe[h]) * inv_l[h] : 0.f;
        dp[n][e] = p * (dp[n][e] - dd[h]) * scale;
      }
    }
    accumulate_tile<NK, ND, LD, kX>(acc, dp, Kt, gq, tq);  // dq += ds k
    __syncthreads();  // the tile is read before its stage is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + 16 * warp + gq + 8 * h;
    if (r >= Tq) continue;
    T* row = dq + (bh * Tq + r) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) store2(row + 8 * c + 2 * tq, acc[c][2 * h], acc[c][2 * h + 1]);
  }
}

template <typename T, int D, int BR>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ g,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, T* __restrict__ dv, int Tq,
                         int Tk, float scale, int causal) {
  constexpr int LD = tile_ld<T, D>();
  constexpr bool kX = std::is_same<T, __nv_bfloat16>::value;  // exact
  constexpr int NQ = BR / 8;  // query columns of a tile, in fragments
  constexpr int ND = D / 8;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);
  T* Vs = Ks + kBC * LD;
  T* Qs = Vs + kBC * LD;   // [2][BR][LD]
  T* Gs = Qs + 2 * BR * LD;  // [2][BR][LD]
  float* Ms = reinterpret_cast<float*>(Gs + 2 * BR * LD);  // [2][BR]
  float* Ls = Ms + 2 * BR;
  float* Ds = Ls + 2 * BR;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const size_t bh = blockIdx.x;
  const int k0 = blockIdx.y * kBC;  // the first key tiles have the most rows
  const T* qb = q + bh * Tq * D;
  const T* gb = g + bh * Tq * D;
  stage_rows<T, D, LD>(Ks, k + bh * Tk * D, k0, kBC, Tk);
  stage_rows<T, D, LD>(Vs, v + bh * Tk * D, k0, kBC, Tk);

  // a query tile, its dO tile and its rows' m, l, delta into stage `st`
  auto issue = [&](int q0, int st) {
    stage_rows<T, D, LD>(Qs + st * BR * LD, qb, q0, BR, Tq);
    stage_rows<T, D, LD>(Gs + st * BR * LD, gb, q0, BR, Tq);
    for (int e = threadIdx.x; e < BR; e += kThreads) {
      const int r = q0 + e;
      if (r < Tq) {
        cp_async4(Ms + st * BR + e, m + bh * Tq + r);
        cp_async4(Ls + st * BR + e, l + bh * Tq + r);
        cp_async4(Ds + st * BR + e, delta + bh * Tq + r);
      } else {  // rows past the end: values that keep their math finite
        Ms[st * BR + e] = 0.f;
        Ls[st * BR + e] = 1.f;
        Ds[st * BR + e] = 0.f;
      }
    }
  };

  // causal: query tiles wholly before this block's first key are dead
  const int qstart = causal ? (k0 / BR) * BR : 0;
  const int ntiles = qstart < Tq ? (Tq - qstart + BR - 1) / BR : 0;
  if (ntiles > 0) issue(qstart, 0);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int q0 = qstart + it * BR;
    const int buf = it & 1;
    if (it + 1 < ntiles) {  // the next query tile loads during this one
      issue(q0 + BR, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Qt = Qs + buf * BR * LD;
    const T* Gt = Gs + buf * BR * LD;
    const float* Mt = Ms + buf * BR;
    const float* Lt = Ls + buf * BR;
    const float* Dt = Ds + buf * BR;

    // rows are keys, columns are queries: s^T = K Q^T, dp^T = V dO^T
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 8) {
      const FragA ak = frag_a<LD>(Ks, 16 * warp, kk, gq, tq);
      const FragA av = frag_a<LD>(Vs, 16 * warp, kk, gq, tq);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        mma3<kX, kX>(s[n], ak, frag_b_n<LD>(Qt, 8 * n, kk, gq, tq));
        mma3<kX, kX>(dp[n], av, frag_b_n<LD>(Gt, 8 * n, kk, gq, tq));
      }
    }
    // p and ds; each thread's two query columns of a fragment share their
    // m, 1 / l and delta, and a fragment wholly inside the live region
    // skips the mask
    const int klast = k0 + 16 * warp + 15;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int c = 8 * n + 2 * tq;
      const float2 mr = *reinterpret_cast<const float2*>(Mt + c);
      const float2 lr = *reinterpret_cast<const float2*>(Lt + c);
      const float2 dr = *reinterpret_cast<const float2*>(Dt + c);
      const float ms[2] = {isfinite(mr.x) ? mr.x : 0.f,
                           isfinite(mr.y) ? mr.y : 0.f};
      const float il[2] = {1.f / fmaxf(lr.x, 1e-20f), 1.f / fmaxf(lr.y, 1e-20f)};
      const float dd[2] = {dr.x, dr.y};
      const bool inside = q0 + 8 * n + 7 < Tq && klast < Tk &&
                          (!causal || klast <= q0 + 8 * n);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e & 1;
        const int kj = k0 + 16 * warp + gq + 8 * (e >> 1);
        const int qj = q0 + c + j;
        const bool live = inside || (qj < Tq && kj < Tk && (!causal || kj <= qj));
        const float p = live ? expf(s[n][e] * scale - ms[j]) * il[j] : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dd[j]) * scale;  // ds
      }
    }
    accumulate_tile<NQ, ND, LD, kX>(dv_acc, s, Gt, gq, tq);   // += p^T dO
    accumulate_tile<NQ, ND, LD, kX>(dk_acc, dp, Qt, gq, tq);  // += ds^T q
    __syncthreads();  // the tile is read before its stage is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = k0 + 16 * warp + gq + 8 * h;
    if (r >= Tk) continue;
    T* rk = dk + (bh * Tk + r) * D;
    T* rv = dv + (bh * Tk + r) * D;
#pragma unroll
    for (int c = 0; c < ND; ++c) {
      store2(rk + 8 * c + 2 * tq, dk_acc[c][2 * h], dk_acc[c][2 * h + 1]);
      store2(rv + 8 * c + 2 * tq, dv_acc[c][2 * h], dv_acc[c][2 * h + 1]);
    }
  }
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
  const size_t smem = fwd_smem_bytes<T, D>();
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
  constexpr int BR = D >= 128 ? 32 : 64;  // dk/dv accumulators fit registers
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const long long rows = (long long)BH * Tq;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(o), gt, delta, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_q = dq_smem_bytes<T, D>();
  e = allow_smem(flash_bwd_dq_kernel<T, D>, smem_q);
  if (e != cudaSuccess) return e;
  flash_bwd_dq_kernel<T, D><<<dim3(BH, (Tq + kBQ - 1) / kBQ), kThreads,
                              smem_q, st>>>(qt, kt, vt, gt, m, l, delta,
                                            static_cast<T*>(dq), Tq, Tk,
                                            scale, causal);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem_kv = dkv_smem_bytes<T, D, BR>();
  e = allow_smem(flash_bwd_dkv_kernel<T, D, BR>, smem_kv);
  if (e != cudaSuccess) return e;
  flash_bwd_dkv_kernel<T, D, BR><<<dim3(BH, (Tk + kBC - 1) / kBC), kThreads,
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
// device; D in {32, 64, 128}; causal needs Tk == T; scale >= 0 (the
// caller negates q for a negative scale). Returns a cudaError_t.
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

// The forward's dynamic shared memory in bytes (flash_fwd_smem_bytes in
// ops/flash_attention.py is held to it on the card); -1 for a dtype or D
// the kernels do not take.
extern "C" long long mxtt_flash_fwd_smem_bytes(int dtype, int D) {
  switch (dtype * 1000 + D) {
    case 32: return (long long)fwd_smem_bytes<float, 32>();
    case 64: return (long long)fwd_smem_bytes<float, 64>();
    case 128: return (long long)fwd_smem_bytes<float, 128>();
    case 1032: return (long long)fwd_smem_bytes<__nv_bfloat16, 32>();
    case 1064: return (long long)fwd_smem_bytes<__nv_bfloat16, 64>();
    case 1128: return (long long)fwd_smem_bytes<__nv_bfloat16, 128>();
    default: return -1;
  }
}

extern "C" const char* mxtt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
