// Causal softmax attention of the demo LM, forward and backward, bf16 in
// and out, on Hopper's tensor cores.
//
// Replaces: operator_forge/tpu/demo.py::_attention, lines 86-92 (scores,
// scale, causal mask, softmax, @ v), which XLA fuses on the TPU, and its
// transpose under jax.value_and_grad in train_step (lines 121-127).  The
// QKV and output projections around it stay torch.matmul.
//
// Forward numerics follow the reference's cast points:
//   score = bf16(q . k)      f32 accumulation, one rounding, then f32
//   score / sqrt(f32(head_dim)), an IEEE division; masked entries -1e30
//   y = exp(score - max) / sum   max and sum over all of the row's keys
//   p = bf16(y)                  rounded once
//   out = bf16(sum_j p_j v_j)    f32 accumulation, one rounding
// An online softmax that rescales partial sums rounds the sum differently
// and cannot give the reference's p, so every row's max and sum are taken
// over all its keys before any p.
//
// The backward follows JAX's autodiff of the same lines, with
// jax.nn.softmax's custom JVP y * (x' - sum(y * x')):
//   dV = bf16(sum_q p[q,k] dO[q])        the rounded p
//   dP = f32(bf16(dO . v))
//   dS = y * (dP - D),  D_q = sum_k y[q,k] dP[q,k]   the f32 y, summed
//        directly: flash's rowsum(dO * O) needs O = P V exactly, which the
//        two roundings break
//   dS_bf = bf16(where(mask, dS, 0) / sqrt(f32(head_dim))), a division
//   dQ = bf16(dS_bf K),  dK = bf16(dS_bf^T Q)
//
// Bound on an H100 SXM.  At DemoConfig() (batch 8, seq 64, 4 heads of 32)
// the forward reads the QKV product once (393,216 B) and writes the output
// once (131,072 B), 0.52 MB: 0.16 us at 3.35 TB/s, against 8.5 MFLOP of
// causal products, 0.01 us at the bf16 tensor rate.  The backward reads
// QKV and dO and writes dQKV, 0.92 MB: 0.27 us, against 21 MFLOP of five
// causal products (the score recompute, dP, dV, dQ, dK), 0.02 us.  Both lie
// far below one launch; what is left to win there is latency.  At the
// benchmark's long rows the products bound it: Pythia-1.4B's [4, 2048, 16,
// 128] backward is 172 GFLOP, 0.17 ms (its first launch's three products,
// S, dP and dQ, 0.10 ms), GPT-2 medium's [16, 1024, 16, 64] 0.087 ms (dQ's
// 0.052), each against 235 MB of QKV, dO and dQKV, 0.07 ms.
//
// Design.  Products are mma.sync.aligned.m16n8k16 bf16 -> f32 on the
// tensor cores, but for the backward's first launch on long rows (below).
// A block is 4 warps over one tile of 16 rows (query rows in the forward
// and the backward's first launch, key rows in its second) of one (head,
// batch): 128 blocks at DemoConfig(), about one per SM, where 64-row tiles
// would keep 32 of 132 SMs busy.  Each of the 4 warps takes 16 keys of
// every 64 (or, in the second launch, every 4th query tile), so that 4
// warps share an SM's latency; their partial row maxima, sums and
// products are combined through shared memory in warp order.  q, k, v and
// dO are read out of their [b, s, *] tensors through strides, and every
// result is written straight into [b, s, *], so the head split and merge
// cost no copies.  Tiles arrive in shared memory by 16-byte cp.async (or
// element by element where head_dim is not a multiple of 8), as bf16 rows
// padded with zeros to the next of 16, 32, 64 or 128 columns, plus 8 so
// that ldmatrix hits 32 banks; operands come out by ldmatrix, and V, dO and
// the backward's other row-major B operands by ldmatrix.trans.  The
// forward keeps S = Q K^T in registers (a warp's 16 keys of a 16-row tile
// are 2 n-tiles, 8 f32 a thread), takes the row max and sum there with
// quad shuffles, and repacks the rounded p from the C fragment into the A
// fragment of P V, so p never leaves registers.  Rows of more than 64 keys
// go 64 keys at a time; each thread keeps its raw bf16 scores (exact) in
// shared memory, 32 KB a block at seq 1024, and the softmax reads them
// back.  Divisions are IEEE's without nvcc's branches (div_fast below).
//
// The backward is two launches with no atomics and no [b, h, s, s]
// scratch, so its sums run in a fixed order and repeat bit for bit.  The
// first, per query tile, recomputes the scores and the softmax, computes
// dP, D and dS_bf in registers, writes dQ and each row's max, sum and D
// (three f32 [b, h, s] arrays).  It has two designs of one algorithm,
// chosen by long_rows from the row, the head and the grid: rows of at most
// one chunk of 64 keys, heads of at most 32 columns or not a multiple of 8
// (or bases not 16-byte aligned), or a grid of 64-row tiles below one
// block for every two SMs, take the forward's 16-row tiles and its code,
// spilling each row's scores and dP to shared memory (128 KB a block at
// Pythia's 2048 keys); the rest take 64-row tiles, one warp for every 16
// whole rows, that stream K and V twice (the statistics with the sum and D
// carried online, then dQ) and recompute the scores rather than keep them,
// on wgmma with TMA (its section below: 0.77 ms at Pythia's shape and
// 0.47 at GPT-2's, against 3.97 and 2.23 for 16-row tiles).  The second,
// per key tile, walks the query tiles in ascending order (a warp's next
// tile of q and dO in flight while the current one is used), recomputes the
// scores and dP with the same operands in the same roles and k-order, so
// y = exp(score - max) / sum comes out with the first launch's bits,
// stages its p and dS_bf tile in shared memory to transpose them, and sums
// dK and dV in registers.
//
// That is the tiles path, the main path's.  The shapes it does not take
// (heads over 128, rows whose spilled scores overflow shared memory, more
// than 65535 batches or heads) go to the stream path, whose section below
// says how it is built; causal_attention_tiles says which path a shape takes.

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;        // rows of a tile: one mma row tile
constexpr int kChunk = 64;       // keys a forward pass takes at a time
constexpr int kWarps = 4;        // warps of a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHeadDim = 128;
constexpr float kMasked = -1e30f;  // the reference's finite mask fill

// the PTX wrappers and packing, shared with mlp.cu (common.cuh)
using of::cp_async16;
using of::cp_async_commit;
using of::cp_async_wait;
using of::hi_of;
using of::ldsm_x4;
using of::ldsm_x4_trans;
using of::lo_of;
using of::mma;
using of::pack;
using of::smem_u32;
// wgmma's fences and descriptors, mbarriers and TMA, shared with mlp.cu
using of::bar_expect;
using of::bar_init;
using of::bar_wait;
using of::encode_tiled;
using of::EncodeTiled;
using of::tma_load;
using of::wg_commit;
using of::wg_desc;
using of::wg_fence;
using of::wg_wait;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Division, exactly as IEEE's (the reference divides twice: the scores
// by sqrt(head_dim), exp by the row sum).  nvcc's own division branches
// to a called slow path for some operands, zeros among them; a branch per
// entry breaks up the independent work of a fragment, and division then
// takes most of these kernels' time (PERF.md has the numbers).  For a
// divisor b in [1, 2^20] with inv = __frcp_rn(b), q = a inv corrected
// once by its residual, which an FMA gives exactly, is the rounded
// quotient while a is 0 or normal and a / b normal (Markstein's
// theorem).  `divide` checks every numerator of a fragment array first
// and divides them all without a branch when each is in that range, else
// entry by entry.
__device__ __forceinline__ bool quotient_in_range(float a) {
  const float abs_a = fabsf(a);
  return abs_a <= 0x1p96f && (abs_a >= 0x1p-96f || abs_a == 0.0f);
}

__device__ __forceinline__ float div_fast(float a, float b, float inv) {
  const float q = __fmul_rn(a, inv);
  return fmaf(fmaf(-q, b, a), inv, q);
}

// x[nt][i] /= b[i >> 1]: the divisor of the fragment's row g or g + 8
template <int kN>
__device__ __forceinline__ void divide(float (&x)[kN][4], const float (&b)[2],
                                       const float (&inv)[2]) {
  bool fast = true;
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) fast = fast & quotient_in_range(x[nt][i]);
  if (fast) {
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[nt][i] = div_fast(x[nt][i], b[i >> 1], inv[i >> 1]);
  } else {
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[nt][i] = quotient_in_range(x[nt][i]) ? div_fast(x[nt][i], b[i >> 1], inv[i >> 1])
                                               : __fdiv_rn(x[nt][i], b[i >> 1]);
  }
}

// reductions over the 4 threads of a quad, which share a fragment's row;
// each step adds two values in either order, so all 4 get the same bits
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- fragments ----------------------------------------------------------
// In an m16n8 C fragment a thread (lane = 4 g + t) holds c[i] at row
// g + 8 (i >> 1), column 2 t + (i & 1).

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ int frag_row(int i) { return (lane_id() >> 2) + 8 * (i >> 1); }
__device__ __forceinline__ int frag_col(int i) { return 2 * (lane_id() & 3) + (i & 1); }

// Row stride, in elements, of a staged tile with kHdp columns: 16 bytes
// over a multiple of 32, so the 8 rows an ldmatrix reads hit 32 banks.
template <int kHdp>
__host__ __device__ constexpr int ld_of() { return kHdp + 8; }

// Stage rows [r0, r0 + n) of one head (src at its first column, row stride
// `stride` elements) into dst [rows_pad][ld] bf16: 16-byte cp.async where
// vec (head_dim a multiple of 8, 16-byte aligned rows), else element by
// element; zeros in columns [hd, kHdp) and rows [n, rows_pad).  Thread
// `tid` of the kStagers threads that stage; the caller commits the
// cp.async group.
template <int kHdp, int kStagers>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, size_t stride, int r0,
                                      int n, int rows_pad, int hd, bool vec, int tid) {
  constexpr int ld = ld_of<kHdp>();
  if (vec) {
    constexpr int kPerRow = kHdp / 8;
    for (int i = tid; i < rows_pad * kPerRow; i += kStagers) {
      const int r = i / kPerRow, c = (i - r * kPerRow) * 8;
      bf16* d = dst + r * ld + c;
      if (r < n && c < hd) {
        cp_async16(d, src + (size_t)(r0 + r) * stride + c);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    for (int i = tid; i < rows_pad * kHdp; i += kStagers) {
      const int r = i / kHdp, c = i - r * kHdp;
      dst[r * ld + c] = (r < n && c < hd) ? src[(size_t)(r0 + r) * stride + c]
                                          : __float2bfloat16(0.0f);
    }
  }
}

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

// acc = A B^T over kHdp, 16 x 16 in two n-tiles: A the warp's 16 rows at
// a, B 16 rows at b (both row-major, ld), as the "col" operand; 0 unless
// live.  The k-steps run in ascending order from a zero accumulator, so a
// product of the same rows gives the same bits wherever it runs.
template <int kHdp>
__device__ __forceinline__ void product_abt(float (&acc)[2][4], const bf16* a, const bf16* b,
                                            bool live) {
  constexpr int ld = ld_of<kHdp>();
  const int lane = lane_id();
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  if (!live) return;
#pragma unroll
  for (int kk = 0; kk < kHdp; kk += 16) {
    uint32_t af[4], bf[4];
    ldsm_x4(af, a + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + kk + (lane >> 4) * 8);
    ldsm_x4(bf, b + ((lane & 7) + (lane >> 4) * 8) * ld + kk + ((lane >> 3) & 1) * 8);
    mma(acc[0], af, bf[0], bf[1]);
    mma(acc[1], af, bf[2], bf[3]);
  }
}

// out[kHdp / 8 n-tiles] += A B for one k-step of 16: A a 16-row fragment
// in registers, B rows [k0, k0 + 16) of b (row-major [k][n], row stride
// ld), read by ldmatrix.trans.
template <int kHdp, int ld = ld_of<kHdp>()>
__device__ __forceinline__ void product_ab(float (&out)[kHdp / 8][4], const uint32_t (&a)[4],
                                           const bf16* b, int k0) {
  const int lane = lane_id();
#pragma unroll
  for (int dp = 0; dp < kHdp / 16; ++dp) {
    uint32_t bf[4];
    ldsm_x4_trans(bf, b + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + dp * 16 +
                          (lane >> 4) * 8);
    mma(out[2 * dp], a, bf[0], bf[1]);
    mma(out[2 * dp + 1], a, bf[2], bf[3]);
  }
}

// The A fragment of a 16 x 16 k-step from the two n-tiles of C fragments
// that hold it, each value rounded to bf16.
__device__ __forceinline__ void a_from_pair(uint32_t (&a)[4], const float (&c0)[4],
                                            const float (&c1)[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c)[2][4]) {
  a_from_pair(a, c[0], c[1]);
}

// sqrt(head_dim), the reference's divisor of the scores, and its
// correctly rounded reciprocal, for both rows of a fragment
struct Root {
  float root[2], inv[2];
};

__device__ __forceinline__ Root root_of(int hd) {
  const float root = sqrtf((float)hd), inv = __frcp_rn(root);
  return {{root, root}, {inv, inv}};
}

// s[nt] becomes the scores of 16 rows from their f32 products: bf16,
// divided by sqrt(head_dim), or the fill where the key lies after the
// query (rows q0 + frag_row, keys key0 + 8 nt + frag_col).
template <int kN>
__device__ __forceinline__ void to_scores(float (&s)[kN][4], int q0, int key0,
                                          const Root& root) {
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = round_bf16(s[nt][i]);
  divide(s, root.root, root.inv);
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (key0 + 8 * nt + frag_col(i) > q0 + frag_row(i)) s[nt][i] = kMasked;
}

// Per-thread spill of a warp's 16 keys of a chunk (2 n-tiles) as bf16
// pairs, lane-major so that a warp's 32 words fall in 32 banks; only the
// thread that wrote a value reads it back.
constexpr int kSpillWords = 4 * 32;  // words a warp spills per chunk

__device__ __forceinline__ void spill(uint32_t* at, const float (&s)[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    at[(2 * nt) * 32 + lane_id()] = pack(s[nt][0], s[nt][1]);
    at[(2 * nt + 1) * 32 + lane_id()] = pack(s[nt][2], s[nt][3]);
  }
}

__device__ __forceinline__ void unspill(float (&s)[2][4], const uint32_t* at) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    const uint32_t u = at[(2 * nt) * 32 + lane_id()], w = at[(2 * nt + 1) * 32 + lane_id()];
    s[nt][0] = lo_of(u);
    s[nt][1] = hi_of(u);
    s[nt][2] = lo_of(w);
    s[nt][3] = hi_of(w);
  }
}

// v, each warp's value for the thread's two rows (already reduced over
// its quad), becomes the max or the sum over the block's warps, taken in
// warp order through red [kWarps][16], so every thread gets the same bits.
// Each call takes its own red.
template <bool kMax>
__device__ __forceinline__ void across_warps(float (&v)[2], float* red) {
  const int warp = threadIdx.x >> 5;
  if ((lane_id() & 3) == 0) {
    red[warp * kRows + frag_row(0)] = v[0];
    red[warp * kRows + frag_row(2)] = v[1];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float acc = red[frag_row(2 * h)];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float x = red[w * kRows + frag_row(2 * h)];
      acc = kMax ? fmaxf(acc, x) : acc + x;
    }
    v[h] = acc;
  }
}

// s = exp(s - max) in place; exp(-1e30 - max) is exactly 0
template <int kN>
__device__ __forceinline__ void exps(float (&s)[kN][4], const float (&m)[2]) {
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = expf(s[nt][i] - m[i >> 1]);
}

// y = e / sum in place, the sums of the fragment's two rows
template <int kN>
__device__ __forceinline__ void normalize(float (&e)[kN][4], const float (&l)[2]) {
  const float inv_l[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  divide(e, l, inv_l);
}

// y = exp(score - max) / sum in place over scores
template <int kN>
__device__ __forceinline__ void to_probs(float (&s)[kN][4], const float (&m)[2],
                                         const float (&l)[2]) {
  exps(s, m);
  normalize(s, l);
}

// The softmax statistics of the block's 16 query rows: max and sum over
// all keys [0, n_keys), for the thread's two rows.  Warp w takes keys
// [16 w, 16 w + 16) of each chunk of 64, in s.  With kOne (n_keys <= 64)
// ks holds every key already and s ends as exp(score - max); otherwise the
// block stages K a chunk at a time into ks, and each warp spills its raw
// bf16 scores of every chunk to `spilled`, in order.  The forward and the
// backward both call this, so they see the same y.
template <int kHdp, bool kOne>
__device__ __forceinline__ void softmax_stats(float (&s)[2][4], float (&m)[2], float (&l)[2],
                                              float* red, const bf16* qs, bf16* ks,
                                              uint32_t* spilled, const bf16* k_src,
                                              size_t stride, int q0, int n_keys, int hd,
                                              bool vec, const Root& root) {
  constexpr int ld = ld_of<kHdp>();
  const int warp = threadIdx.x >> 5;
  const int chunks = kOne ? 1 : (n_keys + kChunk - 1) / kChunk;
  m[0] = m[1] = kMasked;
  for (int c = 0; c < chunks; ++c) {
    const int key0 = c * kChunk, n = min(kChunk, n_keys - key0);
    if (!kOne) {
      __syncthreads();
      stage<kHdp, kThreads>(ks, k_src, stride, key0, n, round16(n), hd, vec, threadIdx.x);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    product_abt<kHdp>(s, qs, ks + 16 * warp * ld, 16 * warp < n);
    if (!kOne) spill(spilled + (c * kWarps + warp) * kSpillWords, s);
    to_scores(s, q0, key0 + 16 * warp, root);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) m[i >> 1] = fmaxf(m[i >> 1], s[nt][i]);
  }
  m[0] = quad_max(m[0]);
  m[1] = quad_max(m[1]);
  across_warps<true>(m, red);
  l[0] = l[1] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    if (!kOne) {
      unspill(s, spilled + (c * kWarps + warp) * kSpillWords);
      to_scores(s, q0, c * kChunk + 16 * warp, root);
    }
    exps(s, m);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) l[i >> 1] += s[nt][i];
  }
  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  across_warps<false>(l, red + kWarps * kRows);
}

// dp becomes dS_bf before its rounding: y (dP - D) / sqrt(head_dim) where
// the key is at or before the query, else 0
template <int kN>
__device__ __forceinline__ void to_grad_scores(float (&dp)[kN][4], const float (&y)[kN][4],
                                               const float (&big_d)[2], int q0, int key0,
                                               const Root& root) {
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dp[nt][i] = key0 + 8 * nt + frag_col(i) <= q0 + frag_row(i)
                      ? y[nt][i] * (dp[nt][i] - big_d[i >> 1]) : 0.0f;
  divide(dp, root.root, root.inv);
}

// The block's kWarps partial 16-row C-fragment arrays c, summed in warp
// order through partial [kWarps][16][ld] f32, stored as bf16 to dst (row
// stride `stride`) in rows < rows and columns < hd.  The caller has made
// sure that no thread still reads what partial overlays.
template <int kHdp>
__device__ __forceinline__ void store_warp_sum(float* partial, const float (&c)[kHdp / 8][4],
                                               bf16* dst, size_t stride, int rows, int hd) {
  constexpr int ld = ld_of<kHdp>();
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int nt = 0; nt < kHdp / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(partial + (warp * kRows + frag_row(2 * h)) * ld + 8 * nt +
                                 frag_col(0)) = make_float2(c[nt][2 * h], c[nt][2 * h + 1]);
  __syncthreads();
  for (int e = threadIdx.x; e < rows * hd; e += kThreads) {
    const int r = e / hd, col = e - r * hd;
    const float* from = partial + r * ld + col;
    float sum = from[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum += from[w * kRows * ld];
    dst[(size_t)r * stride + col] = __float2bfloat16(sum);
  }
}

// Shared memory of each kernel, in bytes.
template <int kHdp>
size_t tile_bytes(int rows) { return (size_t)rows * ld_of<kHdp>() * sizeof(bf16); }

constexpr size_t red_bytes(int n) { return (size_t)n * kWarps * kRows * sizeof(float); }

// each warp's spilled 16 keys of every chunk
__host__ __device__ int spill_words(int s) {
  return (s + kChunk - 1) / kChunk * kWarps * kSpillWords;
}

size_t spill_bytes(int s) { return spill_words(s) * sizeof(uint32_t); }

// the query tile, K and V chunks (the warps' partial outputs take them
// over at the end), max and sum, the spilled scores
template <int kHdp, bool kOne>
size_t fwd_smem(int s) {
  return tile_bytes<kHdp>(kRows + 2 * kChunk) + red_bytes(2) + (kOne ? 0 : spill_bytes(s));
}

// as the forward, with dO's tile, D, and the spilled dP
template <int kHdp, bool kOne>
size_t bwd_dq_smem(int s) {
  return tile_bytes<kHdp>(2 * kRows + 2 * kChunk) + red_bytes(3) +
         (kOne ? 0 : 2 * spill_bytes(s));
}

// K and V tiles; per warp, two buffers of q and dO (which the warps'
// partial dK and dV take over after the walk) and its p and dS tiles
template <int kHdp>
size_t bwd_dkv_smem() {
  return tile_bytes<kHdp>(2 * kRows + kWarps * 4 * kRows) +
         kWarps * 2 * (size_t)kRows * 24 * sizeof(bf16);
}

// ---- kernels ------------------------------------------------------------

// Forward: one block of kWarps warps per (query tile, head, batch); warp w
// takes keys [16 w, 16 w + 16) of each chunk of 64.
template <int kHdp, bool kOne>
__global__ void __launch_bounds__(kThreads)
causal_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int s,
                        int n_heads, int hd, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = ld_of<kHdp>();
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [16][ld]  the query tile
  bf16* ks = qs + kRows * ld;                // [64][ld]  keys
  bf16* vs = ks + kChunk * ld;               // [64][ld]  values
  float* red = reinterpret_cast<float*>(vs + kChunk * ld);             // [2][warps][16]
  uint32_t* spilled = reinterpret_cast<uint32_t*>(red + 2 * kWarps * kRows);
  float* partial = reinterpret_cast<float*>(ks);  // [warps][16][ld], at the end

  const int warp = threadIdx.x >> 5;
  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const int q0 = blockIdx.x * kRows;
  const int rows = min(kRows, s - q0);
  const int n_keys = q0 + rows;  // later keys are masked for every row
  const bf16* base = qkv + (size_t)blockIdx.z * s * stride + (size_t)blockIdx.y * hd;
  const Root root = root_of(hd);

  stage<kHdp, kThreads>(qs, base, stride, q0, rows, kRows, hd, vec, threadIdx.x);
  if (kOne)
    stage<kHdp, kThreads>(ks, base + d, stride, 0, n_keys, round16(n_keys), hd, vec, threadIdx.x);
  cp_async_commit();
  if (kOne) {
    stage<kHdp, kThreads>(vs, base + 2 * d, stride, 0, n_keys, round16(n_keys), hd, vec,
                          threadIdx.x);
    cp_async_commit();
    cp_async_wait<1>();  // q and k; v still in flight
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  float sc[2][4], m[2], l[2];
  softmax_stats<kHdp, kOne>(sc, m, l, red, qs, ks, spilled, base + d, stride, q0, n_keys, hd,
                            vec, root);

  float o[kHdp / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHdp / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.0f;
  const int chunks = kOne ? 1 : (n_keys + kChunk - 1) / kChunk;
  for (int c = 0; c < chunks; ++c) {
    const int key0 = c * kChunk, n = min(kChunk, n_keys - key0);
    if (kOne) {
      cp_async_wait<0>();
      __syncthreads();
      normalize(sc, l);
    } else {
      __syncthreads();
      stage<kHdp, kThreads>(vs, base + 2 * d, stride, key0, n, round16(n), hd, vec, threadIdx.x);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      unspill(sc, spilled + (c * kWarps + warp) * kSpillWords);
      to_scores(sc, q0, key0 + 16 * warp, root);
      to_probs(sc, m, l);
    }
    // p = bf16(y) straight from the C fragments into the A fragment
    if (16 * warp < n) {
      uint32_t a[4];
      a_from_c(a, sc);
      product_ab<kHdp>(o, a, vs, 16 * warp);
    }
  }
  __syncthreads();  // every warp is done with k and v
  store_warp_sum<kHdp>(partial, o,
                       out + ((size_t)blockIdx.z * s + q0) * d + (size_t)blockIdx.y * hd, d, rows,
                       hd);
}

// Backward, first launch: one block of kWarps warps per (query tile, head,
// batch), the keys split as in the forward.  Writes dQ, and each row's
// max, sum and D for the second launch.
template <int kHdp, bool kOne>
__global__ void __launch_bounds__(kThreads)
causal_attention_bwd_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                               bf16* __restrict__ dqkv, float* __restrict__ stats, int s,
                               int n_heads, int hd, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = ld_of<kHdp>();
  bf16* qs = reinterpret_cast<bf16*>(smem);  // [16][ld]  the query tile
  bf16* dos = qs + kRows * ld;               // [16][ld]  its rows of dO
  bf16* ks = dos + kRows * ld;               // [64][ld]  keys
  bf16* vs = ks + kChunk * ld;               // [64][ld]  values
  float* red = reinterpret_cast<float*>(vs + kChunk * ld);  // [3][warps][16]
  uint32_t* spilled = reinterpret_cast<uint32_t*>(red + 3 * kWarps * kRows);  // raw scores
  uint32_t* dp_spilled = spilled + (kOne ? 0 : spill_words(s));  // dP
  float* partial = reinterpret_cast<float*>(ks);  // [warps][16][ld], at the end

  const int warp = threadIdx.x >> 5;
  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const int q0 = blockIdx.x * kRows;
  const int rows = min(kRows, s - q0);
  const int n_keys = q0 + rows;
  const bf16* base = qkv + (size_t)blockIdx.z * s * stride + (size_t)blockIdx.y * hd;
  const bf16* dbase = dout + (size_t)blockIdx.z * s * d + (size_t)blockIdx.y * hd;
  const Root root = root_of(hd);

  stage<kHdp, kThreads>(qs, base, stride, q0, rows, kRows, hd, vec, threadIdx.x);
  if (kOne)
    stage<kHdp, kThreads>(ks, base + d, stride, 0, n_keys, round16(n_keys), hd, vec, threadIdx.x);
  cp_async_commit();
  stage<kHdp, kThreads>(dos, dbase, d, q0, rows, kRows, hd, vec, threadIdx.x);
  if (kOne)
    stage<kHdp, kThreads>(vs, base + 2 * d, stride, 0, n_keys, round16(n_keys), hd, vec,
                          threadIdx.x);
  cp_async_commit();
  if (kOne) {
    cp_async_wait<1>();  // q and k; dO and v still in flight
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  float y[2][4], m[2], l[2];
  softmax_stats<kHdp, kOne>(y, m, l, red, qs, ks, spilled, base + d, stride, q0, n_keys, hd, vec,
                            root);
  const int chunks = kOne ? 1 : (n_keys + kChunk - 1) / kChunk;

  // dP = bf16(dO . v) and D = sum_k y dP over the unmasked keys
  float dp[2][4], big_d[2] = {0.0f, 0.0f};
  for (int c = 0; c < chunks; ++c) {
    const int key0 = c * kChunk, n = min(kChunk, n_keys - key0);
    if (kOne) {
      cp_async_wait<0>();
      __syncthreads();
      normalize(y, l);
    } else {
      __syncthreads();
      stage<kHdp, kThreads>(vs, base + 2 * d, stride, key0, n, round16(n), hd, vec, threadIdx.x);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      unspill(y, spilled + (c * kWarps + warp) * kSpillWords);
      to_scores(y, q0, key0 + 16 * warp, root);
      to_probs(y, m, l);
    }
    product_abt<kHdp>(dp, dos, vs + 16 * warp * ld, 16 * warp < n);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dp[nt][i] = round_bf16(dp[nt][i]);
        if (key0 + 16 * warp + 8 * nt + frag_col(i) <= q0 + frag_row(i))
          big_d[i >> 1] = fmaf(y[nt][i], dp[nt][i], big_d[i >> 1]);
      }
    if (!kOne) spill(dp_spilled + (c * kWarps + warp) * kSpillWords, dp);
  }
  big_d[0] = quad_sum(big_d[0]);
  big_d[1] = quad_sum(big_d[1]);
  across_warps<false>(big_d, red + 2 * kWarps * kRows);

  // dS_bf = bf16(where(mask, y (dP - D), 0) / root), then dQ = bf16(dS_bf K)
  float dq[kHdp / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHdp / 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    const int key0 = c * kChunk, n = min(kChunk, n_keys - key0);
    if (!kOne) {
      __syncthreads();
      stage<kHdp, kThreads>(ks, base + d, stride, key0, n, round16(n), hd, vec, threadIdx.x);
      cp_async_commit();
      unspill(y, spilled + (c * kWarps + warp) * kSpillWords);
      to_scores(y, q0, key0 + 16 * warp, root);
      to_probs(y, m, l);
      unspill(dp, dp_spilled + (c * kWarps + warp) * kSpillWords);
      cp_async_wait<0>();
      __syncthreads();
    }
    to_grad_scores(dp, y, big_d, q0, key0 + 16 * warp, root);
    if (16 * warp < n) {
      uint32_t a[4];
      a_from_c(a, dp);
      product_ab<kHdp>(dq, a, ks, 16 * warp);
    }
  }
  __syncthreads();  // every warp is done with k and v
  store_warp_sum<kHdp>(partial, dq,
                       dqkv + ((size_t)blockIdx.z * s + q0) * stride + (size_t)blockIdx.y * hd,
                       stride, rows, hd);

  // the rows' statistics, [3][b][h][s]: max, sum, D
  if (warp == 0 && (lane_id() & 3) == 0) {
    const size_t plane = (size_t)gridDim.z * n_heads * s;
    const size_t row0 = ((size_t)blockIdx.z * n_heads + blockIdx.y) * s + q0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(2 * h);
      if (r < rows) {
        stats[row0 + r] = m[h];
        stats[plane + row0 + r] = l[h];
        stats[2 * plane + row0 + r] = big_d[h];
      }
    }
  }
}

// Backward, second launch: one block of kWarps warps per (key tile,
// head, batch); warp w takes the query tiles w, w + kWarps, ... at or
// after the key tile, in ascending order, and the warps' partial dK =
// bf16(sum_q dS_bf[q,k] q[q]) and dV = bf16(sum_q p[q,k] dO[q]) are summed
// in warp order.
template <int kHdp>
__global__ void __launch_bounds__(kThreads)
causal_attention_bwd_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                                const float* __restrict__ stats, bf16* __restrict__ dqkv, int s,
                                int n_heads, int hd, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ld = ld_of<kHdp>();
  constexpr int lp = 24;  // row stride of the p and dS tiles: 16 + 8
  constexpr int kStep = kRows * kWarps;  // a warp's stride over the query tiles
  const int warp = threadIdx.x >> 5, lane = lane_id();
  bf16* ks = reinterpret_cast<bf16*>(smem);      // [16][ld]  the key tile
  bf16* vs = ks + kRows * ld;                    // [16][ld]  its values
  bf16* tiles = vs + kRows * ld;                 // [warps][2][2][16][ld]
  bf16* qs = tiles + warp * 4 * kRows * ld;      // this warp's 2 query tiles
  bf16* dos = qs + 2 * kRows * ld;               // and their dO
  bf16* ps = tiles + kWarps * 4 * kRows * ld + warp * 2 * kRows * lp;  // [16][lp] p[q][key]
  bf16* dss = ps + kRows * lp;                   // [16][lp]  dS_bf[q][key]
  float* partial = reinterpret_cast<float*>(tiles);  // [2][warps][16][ld], after the walk

  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const int k0 = blockIdx.x * kRows;
  const int kn = min(kRows, s - k0);
  const bf16* base = qkv + (size_t)blockIdx.z * s * stride + (size_t)blockIdx.y * hd;
  const bf16* dbase = dout + (size_t)blockIdx.z * s * d + (size_t)blockIdx.y * hd;
  const size_t plane = (size_t)gridDim.z * n_heads * s;
  const float* row_stats = stats + ((size_t)blockIdx.z * n_heads + blockIdx.y) * s;
  const Root root = root_of(hd);
  const int first = k0 + warp * kRows;  // queries before k0 see none of the keys

  stage<kHdp, kThreads>(ks, base + d, stride, k0, kn, kRows, hd, vec, threadIdx.x);
  stage<kHdp, kThreads>(vs, base + 2 * d, stride, k0, kn, kRows, hd, vec, threadIdx.x);
  if (first < s) {
    const int rows = min(kRows, s - first);
    stage<kHdp, 32>(qs, base, stride, first, rows, kRows, hd, vec, lane);
    stage<kHdp, 32>(dos, dbase, d, first, rows, kRows, hd, vec, lane);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  float dk[kHdp / 8][4], dv[kHdp / 8][4];
#pragma unroll
  for (int nt = 0; nt < kHdp / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[nt][i] = dv[nt][i] = 0.0f;

  for (int q0 = first, buf = 0; q0 < s; q0 += kStep, buf ^= 1) {
    const int rows = min(kRows, s - q0);
    bf16* qb = qs + buf * kRows * ld;
    bf16* db = dos + buf * kRows * ld;
    float m[2], l[2], big_d[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(2 * h);
      const bool in = r < rows;
      m[h] = in ? row_stats[q0 + r] : 0.0f;
      l[h] = in ? row_stats[plane + q0 + r] : 1.0f;
      big_d[h] = in ? row_stats[2 * plane + q0 + r] : 0.0f;
    }
    __syncwarp();  // every lane is done with the other buffer and the p, dS tiles
    if (q0 + kStep < s) {
      const int next = min(kRows, s - q0 - kStep);
      bf16* q_next = qs + (buf ^ 1) * kRows * ld;
      bf16* d_next = dos + (buf ^ 1) * kRows * ld;
      stage<kHdp, 32>(q_next, base, stride, q0 + kStep, next, kRows, hd, vec, lane);
      stage<kHdp, 32>(d_next, dbase, d, q0 + kStep, next, kRows, hd, vec, lane);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    // the first launch's products for these 16 queries and 16 keys, in
    // the same roles: queries as the A rows, keys as the B columns; then
    // its y, and dS_bf before the rounding
    float y[2][4], dp[2][4];
    product_abt<kHdp>(y, qb, ks, true);
    product_abt<kHdp>(dp, db, vs, true);
    to_scores(y, q0, k0, root);
    to_probs(y, m, l);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (frag_row(i) >= rows) y[nt][i] = 0.0f;  // past the last query
        dp[nt][i] = round_bf16(dp[nt][i]);
      }
    to_grad_scores(dp, y, big_d, q0, k0, root);
    // p and dS_bf to shared memory, [query][key], to read back transposed
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = frag_row(2 * h) * lp + 8 * nt + frag_col(0);
        *reinterpret_cast<uint32_t*>(ps + at) = pack(y[nt][2 * h], y[nt][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dss + at) = pack(dp[nt][2 * h], dp[nt][2 * h + 1]);
      }
    __syncwarp();
    // A = p^T and dS^T: rows the tile's keys, k the 16 queries
    uint32_t a_p[4], a_ds[4];
    const int mi = lane >> 3;
    const int at = ((lane & 7) + (mi >> 1) * 8) * lp + (mi & 1) * 8;
    ldsm_x4_trans(a_p, ps + at);
    ldsm_x4_trans(a_ds, dss + at);
    product_ab<kHdp>(dv, a_p, db, 0);
    product_ab<kHdp>(dk, a_ds, qb, 0);
  }

  // the warps' partial sums, added in warp order
  __syncthreads();  // every warp is done with its q and dO tiles
  bf16* dst = dqkv + ((size_t)blockIdx.z * s + k0) * stride + (size_t)blockIdx.y * hd;
  store_warp_sum<kHdp>(partial, dk, dst + d, stride, kn, hd);
  store_warp_sum<kHdp>(partial + kWarps * kRows * ld, dv, dst + 2 * d, stride, kn, hd);
}

// ---- the stream path: long rows, wide heads, many heads or batches ------
//
// Every shape the tiles path does not take: rows whose spilled scores would
// overflow shared memory, heads wider than kMaxHeadDim, more than 65535
// batches or heads.  It computes what the tiles path computes, with the
// same cast points, and keeps nothing that grows with the sequence or the
// head in shared memory:
// - every product is the tiles path's mma.sync m16n8k16 bf16 -> f32 from
//   ldmatrix (.trans for the row-major B operands), on tiles staged by
//   16-byte cp.async, or element by element where head_dim % 8 != 0 or a
//   base is not 16-byte aligned;
// - a block takes a tile of 64 rows, so each staged chunk of the other
//   side serves 64 rows, not one: 4 warps of 16 rows (query rows in the
//   forward and the backward's first launch, key rows in its second).  On
//   a grid of fewer than two blocks an SM, a block has kG = 2 groups of
//   them, which split each chunk of the other side (its keys, or its
//   queries) and add their maxima, sums and partial outputs in group
//   order: twice the warps, half of each one's walk.  The grid is flat,
//   heaviest tiles first, so any batch and head count launch;
// - the other side streams through shared memory in chunks (64 keys, or 32
//   queries in the second launch) into two buffers, the next chunk in
//   flight while the current one is used (`stream`);
// - the head goes in column chunks of kC: a score sums over them in f32
//   registers and rounds once at the end.  Up to heads of 256 one chunk
//   holds the head (kResident): Q (and dO) stay in shared memory, K and V
//   come whole-row, and an output product reads its B operand out of the
//   score tiles.  Wider heads go 64 columns a chunk, Q and dO streaming
//   beside K and V, and each output product stages its own B tile;
// - an output (out, dQ, dK, dV) is a warp's register accumulator of kO
//   columns: 128, or 256 for out and dQ at heads of 256 with two groups
//   (whose warps hold half the scores); a wider head takes one more pass
//   over the other side for each further kO columns (in the second launch
//   a grid axis instead, since there no statistics pass would repeat);
// - the softmax statistics come from passes: a max pass and a sum pass over
//   every key, then the pass that uses p, each rescoring with the same
//   operands in the same k-order, so every pass has the same bits.  The max
//   pass takes the max of the raw f32 products and scores only that:
//   bf16 rounding and the division by sqrt(head_dim) never decrease, so
//   the score of the max is the max of the scores, bit for bit.  The
//   backward's first launch writes each row's max, sum and D into stats
//   [3, b, h, s] for the second, which rescores in the same roles (queries
//   as the A rows, keys as the B columns) and stages its p and dS_bf tiles
//   to transpose them.
// Sums run in a fixed order and nothing is atomic, so a launch repeats bit
// for bit.  Products of a pair the mask leaves, where the bound counts 2
// forward and 5 backward: 4 (max, sum, p.v) and 11 (four rescorings, two
// dO.v, dQ; rescoring, dO.v, dV, dK) where one chunk holds the head; each
// further output pass rescores once more.

constexpr int kSTile = 64;               // rows of a block's tile
constexpr int kSThreads = 128;           // a block's threads for each group of warps
constexpr int kSChunk = 64;              // keys a chunk of a query tile's walk
constexpr int kSQueries = 32;            // queries a chunk of a key tile's walk
constexpr int kSp = 24;                  // row stride of the staged p, dS_bf: 16 + 8

// Let a kernel take as much dynamic shared memory as a block may have.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return of::set_attribute_once(reinterpret_cast<const void*>(kernel),
                                cudaFuncAttributeMaxDynamicSharedMemorySize, of::kMaxSmemBytes);
}

template <int kN>
__device__ __forceinline__ void zero(float (&x)[kN][4]) {
#pragma unroll
  for (int nt = 0; nt < kN; ++nt) x[nt][0] = x[nt][1] = x[nt][2] = x[nt][3] = 0.0f;
}

// Run stages [0, n): issue(t) starts stage t's copies into buffer t & 1,
// compute(t) uses them, with stage t + 1 in flight.  Every thread of the
// block calls it.
template <typename Issue, typename Compute>
__device__ __forceinline__ void stream(int n, const Issue& issue, const Compute& compute) {
  issue(0);
  cp_async_commit();
  for (int t = 0; t < n; ++t) {
    if (t + 1 < n) {
      issue(t + 1);  // the buffer compute(t - 1) read, which every warp is done with
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    compute(t);
    __syncthreads();
  }
}

// acc[2 np], acc[2 np + 1] += A B^T over kC columns for B's 16-row pairs
// np < live: A 16 rows at a, B at b (both row-major, ld_of<kC>), k-steps
// ascending, so the same operands give the same bits in every pass.
template <int kC, int kPairs, bool kAll = false>
__device__ __forceinline__ void mma_abt_pairs(float (&acc)[2 * kPairs][4], const bf16* a,
                                              const bf16* b, int live) {
  constexpr int ld = ld_of<kC>();
  const int lane = lane_id();
#pragma unroll
  for (int kk = 0; kk < kC; kk += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + kk + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kPairs; ++np)
      if (kAll || np < live) {
        uint32_t bf[4];
        ldsm_x4(bf, b + (16 * np + (lane & 7) + (lane >> 4) * 8) * ld + kk + ((lane >> 3) & 1) * 8);
        mma(acc[2 * np], af, bf[0], bf[1]);
        mma(acc[2 * np + 1], af, bf[2], bf[3]);
      }
  }
}

// (a chunk whose pairs are all live, nearly every one, runs without a test
// in the loop, so the compiler can issue its loads ahead)
template <int kC, int kPairs>
__device__ __forceinline__ void mma_abt(float (&acc)[2 * kPairs][4], const bf16* a, const bf16* b,
                                        int live) {
  if (live == kPairs)
    mma_abt_pairs<kC, kPairs, true>(acc, a, b, live);
  else
    mma_abt_pairs<kC, kPairs>(acc, a, b, live);
}

// s[nt] becomes the scores of 16 rows from their f32 products, as
// to_scores makes them; the mask is looked at only where the keys [key0,
// key0 + 8 kN) reach past the first row r0 (near the diagonal).
template <int kN>
__device__ __forceinline__ void stream_scores(float (&s)[kN][4], int r0, int key0,
                                              const Root& root) {
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = round_bf16(s[nt][i]);
  divide(s, root.root, root.inv);
  if (key0 + 8 * kN - 1 > r0) {
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (key0 + 8 * nt + frag_col(i) > r0 + frag_row(i)) s[nt][i] = kMasked;
  }
}

// dp becomes dS_bf before its rounding, as to_grad_scores makes it, the
// mask looked at only near the diagonal
template <int kN>
__device__ __forceinline__ void stream_grad_scores(float (&dp)[kN][4], const float (&y)[kN][4],
                                                   const float (&big_d)[2], int r0, int key0,
                                                   const Root& root) {
  const bool near = key0 + 8 * kN - 1 > r0;
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dp[nt][i] = !near || key0 + 8 * nt + frag_col(i) <= r0 + frag_row(i)
                      ? y[nt][i] * (dp[nt][i] - big_d[i >> 1]) : 0.0f;
  divide(dp, root.root, root.inv);
}

// The 16-key pairs of a 64-key chunk at key0 that any of rows [r0, r0 + 16)
// sees; the rest are masked for all of them.
__device__ __forceinline__ int live_pairs(int r0, int key0) {
  const int x = r0 + 15 - key0;
  return x < 0 ? 0 : min(4, x / 16 + 1);
}

// A warp's 16-row accumulator of kO columns, rounded to bf16, into dst (its
// first row and column; rows `stride` apart) in rows < rows and columns <
// cols.
template <int kO>
__device__ __forceinline__ void store_rows(const float (&c)[kO / 8][4], bf16* dst, size_t stride,
                                           int rows, int cols) {
#pragma unroll
  for (int nt = 0; nt < kO / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = frag_row(i), col = 8 * nt + frag_col(i);
      if (r < rows && col < cols) dst[(size_t)r * stride + col] = __float2bfloat16(c[nt][i]);
    }
}

// Where a stream block is: its tile and plane (head, batch), and its chunk
// of output columns.  Ids run over the planes fastest, then the output
// chunks, then the tiles by falling cost, so the heaviest start first.
struct StreamBlock {
  int tile, head, batch, out;
};

__device__ __forceinline__ StreamBlock stream_block(int tiles, int planes, int n_heads, int nout,
                                                    bool last_heaviest) {
  const int id = blockIdx.x, plane = id % planes, rest = id / planes;
  const int out = rest % nout, rank = rest / nout;
  return {last_heaviest ? tiles - 1 - rank : rank, plane % n_heads, plane / n_heads, out};
}

// acc, a warp's partial output, becomes the sum of the two groups' (group
// 0's first) in group 0's warps, through `partial` ([kO / 2][128] f32,
// each thread's own slots); the caller has made sure that no thread still
// reads what partial overlays.  Returns whether this warp holds the sum.
template <int kO>
__device__ __forceinline__ bool add_groups(float (&acc)[kO / 8][4], float* partial) {
  const int slot = threadIdx.x & (kSThreads - 1);
  const bool upper = threadIdx.x >= kSThreads;
  if (upper) {
#pragma unroll
    for (int nt = 0; nt < kO / 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) partial[(4 * nt + i) * kSThreads + slot] = acc[nt][i];
  }
  __syncthreads();
  if (upper) return false;
#pragma unroll
  for (int nt = 0; nt < kO / 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += partial[(4 * nt + i) * kSThreads + slot];
  return true;
}

// A query tile walking its keys: at stage t key chunk t / nc and column
// chunk t % nc, K (and V for the backward) in two buffers; Q (and dO)
// resident where one column chunk holds the head (nc == 1), else streamed
// beside them.  Its 4 kG warps are 4 row groups of 16 rows by kG key
// groups, group g taking keys [64 g / kG, 64 (g + 1) / kG) of each chunk;
// with two groups a row's maxima, sums and partial outputs meet through
// shared memory in group order.  The forward and the backward's first
// launch share it, so both see the same scores.
template <int kC, int kG>
struct QueryTile {
  static constexpr int kLd = ld_of<kC>(), kTile = kSTile * kLd;
  static constexpr int kPairs = 4 / kG, kN = 2 * kPairs;  // a warp's 16-key pairs, n-tiles
  bf16 *qs, *dos, *ks, *vs;  // staged tiles
  float* red;                // [3][2][64]: the groups' partial maxima, sums, D
  const bf16 *q, *k, *v, *dout;  // column 0 of the head in row 0 of the plane
  size_t stride, dstride;    // row strides of q, k, v and of dO
  int q0, rows, n_keys, nc, hd;
  int wq0, kb;               // the warp's first row; its group's first key of a chunk
  bool vec;
  Root root;

  __device__ int stages() const { return (n_keys + kSChunk - 1) / kSChunk * nc; }

  // Q (and dO with kGrad) where they stay resident; the caller's first
  // stage commits them
  template <bool kGrad>
  __device__ void issue_resident() const {
    if (nc > 1) return;
    stage<kC, kSThreads * kG>(qs, q, stride, q0, rows, kSTile, hd, vec, threadIdx.x);
    if (kGrad) stage<kC, kSThreads * kG>(dos, dout, dstride, q0, rows, kSTile, hd, vec, threadIdx.x);
  }

  // stage t's copies: K (and V with kGrad), and Q (and dO) where they stream
  template <bool kGrad>
  __device__ void issue(int t) const {
    const int j = t / nc, c = t - j * nc, at = (t & 1) * kTile, key0 = j * kSChunk;
    const int n = min(kSChunk, n_keys - key0), c0 = c * kC;
    constexpr int kT = kSThreads * kG;
    stage<kC, kT>(ks + at, k + c0, stride, key0, n, kSChunk, hd - c0, vec, threadIdx.x);
    if (kGrad) stage<kC, kT>(vs + at, v + c0, stride, key0, n, kSChunk, hd - c0, vec, threadIdx.x);
    if (nc > 1) {
      stage<kC, kT>(qs + at, q + c0, stride, q0, rows, kSTile, hd - c0, vec, threadIdx.x);
      if (kGrad)
        stage<kC, kT>(dos + at, dout + c0, dstride, q0, rows, kSTile, hd - c0, vec, threadIdx.x);
    }
  }

  // Stage t's products: sc += the warp's rows' q . k over this column chunk
  // for its group's keys (and dp += dO . v with kGrad); at the chunk's
  // last column chunk sc becomes their scores (with kRaw the raw products,
  // -inf where masked) and on(key chunk, the group's first key, live
  // pairs) runs.
  template <bool kGrad, typename On, bool kRaw = false>
  __device__ void score(float (&sc)[kN][4], float (&dp)[kN][4], int t, const On& on) const {
    const int j = t / nc, c = t - j * nc, at = (t & 1) * kTile, key0 = j * kSChunk + kb;
    const int live = min(kPairs, live_pairs(wq0, key0));
    const int own = (nc > 1 ? at : 0) + (wq0 - q0) * kLd;
    if (c == 0) {
      zero(sc);
      if (kGrad) zero(dp);
    }
    mma_abt<kC, kPairs>(sc, qs + own, ks + at + kb * kLd, live);
    if (kGrad) mma_abt<kC, kPairs>(dp, dos + own, vs + at + kb * kLd, live);
    if (c == nc - 1) {
      if (!kRaw) {
        stream_scores(sc, wq0, key0, root);
      } else if (key0 + 8 * kN - 1 > wq0) {
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (key0 + 8 * nt + frag_col(i) > wq0 + frag_row(i)) sc[nt][i] = -INFINITY;
      }
      on(j, key0, live);
    }
  }

  // v, the warp's value for the thread's two rows over its group's keys
  // (reduced over the quad), becomes the max or the sum of the two
  // groups', group 0's first; `which` picks one of red's three areas, each
  // used once a launch.
  template <bool kMax>
  __device__ void across_groups(float (&v)[2], int which) const {
    if (kG == 1) return;
    float* area = red + which * 2 * kSTile;
    const int row = wq0 - q0 + frag_row(0);
    if ((lane_id() & 3) == 0) {
      area[(kb ? kSTile : 0) + row] = v[0];
      area[(kb ? kSTile : 0) + row + 8] = v[1];
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a = area[row + 8 * h], b = area[kSTile + row + 8 * h];
      v[h] = kMax ? fmaxf(a, b) : a + b;
    }
  }

  // The max and the sum over every key of the thread's two rows: two
  // passes (the first stage also commits what issue_resident staged).  The
  // max is taken over the raw products, then scored; each row sees key 0.
  __device__ void stats(float (&m)[2], float (&l)[2], float (&sc)[kN][4]) const {
    float unused[kN][4];
    const int n = stages();
    float raw[2] = {-INFINITY, -INFINITY};
    stream(n, [&](int t) { this->template issue<false>(t); }, [&](int t) {
      auto on = [&](int, int, int) {
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) raw[i >> 1] = fmaxf(raw[i >> 1], sc[nt][i]);
      };
      this->template score<false, decltype(on), true>(sc, unused, t, on);
    });
    raw[0] = quad_max(raw[0]);
    raw[1] = quad_max(raw[1]);
    across_groups<true>(raw, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the score of the max, as to_scores takes it
      const float x = round_bf16(raw[h]);
      m[h] = quotient_in_range(x) ? div_fast(x, root.root[h], root.inv[h])
                                  : __fdiv_rn(x, root.root[h]);
    }
    l[0] = l[1] = 0.0f;
    stream(n, [&](int t) { this->template issue<false>(t); }, [&](int t) {
      this->template score<false>(sc, unused, t, [&](int, int, int) {
        exps(sc, m);
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) l[i >> 1] += sc[nt][i];
      });
    });
    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    across_groups<false>(l, 1);
  }

  // the warp's place: rows [wq0, wq0 + 16), keys kb + [0, 64 / kG) of a
  // chunk
  __device__ void place(int warp) {
    wq0 = q0 + 16 * (warp & 3);
    kb = 64 / kG * (warp >> 2);
  }
};

// Forward: one block per (query tile, head, batch); out = bf16(sum p v).
template <int kC, int kO, int kG>
__global__ void __launch_bounds__(kSThreads * kG, 3 - kG)
attention_stream_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int s, int n_heads,
                        int hd, int tiles, int planes, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kResident = kC >= kO;  // one column chunk holds the head
  constexpr int kTile = QueryTile<kC, kG>::kTile, kOut = kSTile * ld_of<kO>();
  constexpr int kN = QueryTile<kC, kG>::kN;
  const StreamBlock at = stream_block(tiles, planes, n_heads, 1, true);
  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const int q0 = at.tile * kSTile, rows = min(kSTile, s - q0);
  const bf16* base = qkv + (size_t)at.batch * s * stride + (size_t)at.head * hd;
  QueryTile<kC, kG> w;
  w.qs = reinterpret_cast<bf16*>(smem);        // Q: [1 or 2][64][ld]
  w.ks = w.qs + (kResident ? 1 : 2) * kTile;   // K: [2][64][ld]
  bf16* vs = w.ks + 2 * kTile;                 // V's output columns: [2][64][ld_of<kO>]
  w.red = reinterpret_cast<float*>(vs + 2 * kOut);
  w.dos = w.vs = nullptr;
  w.q = base, w.k = base + d, w.v = base + 2 * d, w.dout = nullptr;
  w.stride = stride, w.dstride = 0;
  w.q0 = q0, w.rows = rows, w.n_keys = q0 + rows, w.hd = hd;
  w.place(threadIdx.x >> 5);
  w.nc = kResident ? 1 : (hd + kC - 1) / kC;
  w.vec = vec, w.root = root_of(hd);

  float sc[kN][4], m[2], l[2];
  w.template issue_resident<false>();
  w.stats(m, l, sc);
  const int n = w.stages();
  bf16* dst = out + ((size_t)at.batch * s + w.wq0) * d + (size_t)at.head * hd;
  for (int o0 = 0; o0 < hd; o0 += kO) {
    float acc[kO / 8][4];
    zero(acc);
    stream(n, [&](int t) {
      w.template issue<false>(t);
      const int j = t / w.nc, key0 = j * kSChunk;
      if (t - j * w.nc == w.nc - 1)  // the chunk's values, with its last column chunk
        stage<kO, kSThreads * kG>(vs + (j & 1) * kOut, w.v + o0, stride, key0,
                             min(kSChunk, w.n_keys - key0), kSChunk, hd - o0, vec, threadIdx.x);
    }, [&](int t) {
      w.template score<false>(sc, sc, t, [&](int j, int, int live) {
        to_probs(sc, m, l);
        const bf16* vt = vs + (j & 1) * kOut;
#pragma unroll
        for (int kk = 0; kk < kN / 2; ++kk)
          if (kk < live) {  // p = bf16(y) from the C fragments into the A fragment
            uint32_t a[4];
            a_from_pair(a, sc[2 * kk], sc[2 * kk + 1]);
            product_ab<kO>(acc, a, vt, w.kb + 16 * kk);
          }
      });
    });
    if (kG == 1 || add_groups<kO>(acc, reinterpret_cast<float*>(w.ks)))
      store_rows<kO>(acc, dst + o0, d, q0 + rows - w.wq0, hd - o0);
    __syncthreads();  // partial is read before the next pass stages over it
  }
}

// Backward, first launch: one block per (query tile, head, batch).  Writes
// dQ and each row's max, sum and D into stats [3][b][h][s].
template <int kC, int kO, int kG>
__global__ void __launch_bounds__(kSThreads * kG, 3 - kG)
attention_stream_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                           bf16* __restrict__ dqkv, float* __restrict__ stats, int s,
                           int n_heads, int hd, int tiles, int planes, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kResident = kC >= kO;
  constexpr int kTile = QueryTile<kC, kG>::kTile, kOut = kSTile * ld_of<kO>();
  constexpr int kN = QueryTile<kC, kG>::kN;
  const StreamBlock at = stream_block(tiles, planes, n_heads, 1, true);
  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const int q0 = at.tile * kSTile, rows = min(kSTile, s - q0);
  const bf16* base = qkv + (size_t)at.batch * s * stride + (size_t)at.head * hd;
  QueryTile<kC, kG> w;
  w.qs = reinterpret_cast<bf16*>(smem);        // Q: [1 or 2][64][ld]
  w.dos = w.qs + (kResident ? 1 : 2) * kTile;  // dO: [1 or 2][64][ld]
  w.ks = w.dos + (kResident ? 1 : 2) * kTile;  // K: [2][64][ld]
  w.vs = w.ks + 2 * kTile;                     // V: [2][64][ld]
  bf16* kos = w.vs + 2 * kTile;                // K's output columns: [2][64][ld_of<kO>], streaming
  w.red = reinterpret_cast<float*>(kos + (kResident ? 0 : 2 * kOut));
  w.q = base, w.k = base + d, w.v = base + 2 * d;
  w.dout = dout + (size_t)at.batch * s * d + (size_t)at.head * hd;
  w.stride = stride, w.dstride = d;
  w.q0 = q0, w.rows = rows, w.n_keys = q0 + rows, w.hd = hd;
  w.place(threadIdx.x >> 5);
  w.nc = kResident ? 1 : (hd + kC - 1) / kC;
  w.vec = vec, w.root = root_of(hd);

  float sc[kN][4], dp[kN][4], m[2], l[2];
  w.template issue_resident<true>();
  w.stats(m, l, sc);
  const int n = w.stages();

  // D = sum_k y dP over the unmasked keys, dP = bf16(dO . v)
  float big_d[2] = {0.0f, 0.0f};
  stream(n, [&](int t) { w.template issue<true>(t); }, [&](int t) {
    w.template score<true>(sc, dp, t, [&](int, int key0, int) {
      to_probs(sc, m, l);
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dp[nt][i] = round_bf16(dp[nt][i]);
          if (key0 + 8 * kN - 1 <= w.wq0 || key0 + 8 * nt + frag_col(i) <= w.wq0 + frag_row(i))
            big_d[i >> 1] = fmaf(sc[nt][i], dp[nt][i], big_d[i >> 1]);
        }
    });
  });
  big_d[0] = quad_sum(big_d[0]);
  big_d[1] = quad_sum(big_d[1]);
  w.template across_groups<false>(big_d, 2);

  // dS_bf = bf16(where(mask, y (dP - D), 0) / root), then dQ = bf16(dS_bf K)
  bf16* dst = dqkv + ((size_t)at.batch * s + w.wq0) * stride + (size_t)at.head * hd;
  for (int o0 = 0; o0 < hd; o0 += kO) {
    float acc[kO / 8][4];
    zero(acc);
    stream(n, [&](int t) {
      w.template issue<true>(t);
      const int j = t / w.nc, key0 = j * kSChunk;
      if (!kResident && t - j * w.nc == w.nc - 1)  // the chunk's keys' output columns
        stage<kO, kSThreads * kG>(kos + (j & 1) * kOut, w.k + o0, stride, key0,
                             min(kSChunk, w.n_keys - key0), kSChunk, hd - o0, vec, threadIdx.x);
    }, [&](int t) {
      w.template score<true>(sc, dp, t, [&](int j, int key0, int live) {
        to_probs(sc, m, l);
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) dp[nt][i] = round_bf16(dp[nt][i]);
        stream_grad_scores(dp, sc, big_d, w.wq0, key0, w.root);
#pragma unroll
        for (int kk = 0; kk < kN / 2; ++kk)
          if (kk < live) {
            uint32_t a[4];
            a_from_pair(a, dp[2 * kk], dp[2 * kk + 1]);
            if (kResident)  // stage t is key chunk j, its K tile whole-row
              product_ab<kO, ld_of<kC>()>(acc, a, w.ks + (j & 1) * kTile + o0, w.kb + 16 * kk);
            else
              product_ab<kO>(acc, a, kos + (j & 1) * kOut, w.kb + 16 * kk);
          }
      });
    });
    if (kG == 1 || add_groups<kO>(acc, reinterpret_cast<float*>(w.ks)))
      store_rows<kO>(acc, dst + o0, stride, q0 + rows - w.wq0, hd - o0);
    __syncthreads();  // partial is read before the next pass stages over it
  }

  // the rows' statistics, [3][b][h][s]: max, sum, D
  if (w.kb == 0 && (lane_id() & 3) == 0) {
    const size_t plane = (size_t)planes * s;
    const size_t row0 = ((size_t)at.batch * n_heads + at.head) * s + w.wq0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(2 * h);
      if (w.wq0 + r < s) {
        stats[row0 + r] = m[h];
        stats[plane + row0 + r] = l[h];
        stats[2 * plane + row0 + r] = big_d[h];
      }
    }
  }
}

// Backward, second launch: one block per (key tile, head, batch, chunk of
// kO output columns); warp w owns the tile's keys [16 (w % 4), + 16) and
// walks the queries at or after the tile in chunks of 32, ascending, its
// group taking 32 / kG of each chunk's: dK = bf16(sum_q dS_bf[q,k] q[q]),
// dV = bf16(sum_q p[q,k] dO[q]).
template <int kC, int kO, int kG>
__global__ void __launch_bounds__(kSThreads * kG, 3 - kG)
attention_stream_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                            const float* __restrict__ stats, bf16* __restrict__ dqkv, int s,
                            int n_heads, int hd, int tiles, int planes, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kResident = kC >= kO;
  constexpr int kT = kSThreads * kG, kMt = 2 / kG;  // threads; a warp's m-tiles of a chunk
  constexpr int lc = ld_of<kC>(), kKeyTile = kSTile * lc;
  constexpr int kQTile = kSQueries * lc, kQOut = kSQueries * ld_of<kO>();
  const int nc = kResident ? 1 : (hd + kC - 1) / kC, nout = (hd + kO - 1) / kO;
  const int warp = threadIdx.x >> 5, lane = lane_id(), group = warp >> 2;
  bf16* ks = reinterpret_cast<bf16*>(smem);        // K: [1 or 2][64][lc]
  bf16* vs = ks + (kResident ? 1 : 2) * kKeyTile;  // V: [1 or 2][64][lc]
  bf16* qs = vs + (kResident ? 1 : 2) * kKeyTile;  // Q: [2][32][lc]
  bf16* dos = qs + 2 * kQTile;                     // dO: [2][32][lc]
  bf16* qos = dos + 2 * kQTile;      // Q's output columns: [2][32][ld_of<kO>], streaming
  bf16* doos = qos + (kResident ? 0 : 2 * kQOut);  // dO's, likewise
  // the warp's p[q][key] and dS_bf[q][key]: [16 kMt][kSp] each
  bf16* ps = doos + (kResident ? 0 : 2 * kQOut) + warp * 2 * 16 * kMt * kSp;
  bf16* dss = ps + 16 * kMt * kSp;

  const StreamBlock at = stream_block(tiles, planes, n_heads, nout, false);
  const int d = n_heads * hd, o0 = at.out * kO;
  const size_t stride = 3 * (size_t)d;
  const int k0 = at.tile * kSTile, kn = min(kSTile, s - k0), wk0 = k0 + 16 * (warp & 3);
  const bf16* base = qkv + (size_t)at.batch * s * stride + (size_t)at.head * hd;
  const bf16* dbase = dout + (size_t)at.batch * s * d + (size_t)at.head * hd;
  const size_t plane = (size_t)planes * s;
  const float* row_stats = stats + ((size_t)at.batch * n_heads + at.head) * s;
  const Root root = root_of(hd);
  const int n = (s - k0 + kSQueries - 1) / kSQueries * nc;

  if (kResident) {  // the key tile stays; committed with the first stage
    stage<kC, kT>(ks, base + d, stride, k0, kn, kSTile, hd, vec, threadIdx.x);
    stage<kC, kT>(vs, base + 2 * d, stride, k0, kn, kSTile, hd, vec, threadIdx.x);
  }
  float sc[kMt][2][4], dp[kMt][2][4], dk[kO / 8][4], dv[kO / 8][4];
  zero(dk);
  zero(dv);
  stream(n, [&](int t) {
    const int j = t / nc, c = t - j * nc, buf = t & 1, c0 = c * kC;
    const int qj = k0 + kSQueries * j, qn = min(kSQueries, s - qj);
    stage<kC, kT>(qs + buf * kQTile, base + c0, stride, qj, qn, kSQueries, hd - c0, vec,
                  threadIdx.x);
    stage<kC, kT>(dos + buf * kQTile, dbase + c0, d, qj, qn, kSQueries, hd - c0, vec,
                  threadIdx.x);
    if (!kResident) {
      stage<kC, kT>(ks + buf * kKeyTile, base + d + c0, stride, k0, kn, kSTile, hd - c0, vec,
                    threadIdx.x);
      stage<kC, kT>(vs + buf * kKeyTile, base + 2 * d + c0, stride, k0, kn, kSTile, hd - c0,
                    vec, threadIdx.x);
      if (c == nc - 1) {  // the chunk's output columns of q and dO
        stage<kO, kT>(qos + (j & 1) * kQOut, base + o0, stride, qj, qn, kSQueries, hd - o0,
                      vec, threadIdx.x);
        stage<kO, kT>(doos + (j & 1) * kQOut, dbase + o0, d, qj, qn, kSQueries, hd - o0, vec,
                      threadIdx.x);
      }
    }
  }, [&](int t) {
    const int j = t / nc, c = t - j * nc, buf = t & 1;
    const int qj = k0 + kSQueries * j;
    // the first launch's products in the same roles: the group's query rows
    // of the chunk (m-tiles group kMt + i) as A, the warp's 16 keys as B; an
    // m-tile whose rows all come before the keys is masked whole, skipped
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < kMt; ++i) {
        zero(sc[i]);
        zero(dp[i]);
      }
    }
    const int key_at = (kResident ? 0 : buf * kKeyTile) + 16 * (warp & 3) * lc;
#pragma unroll
    for (int i = 0; i < kMt; ++i) {
      const int mt = group * kMt + i;
      if (qj + 16 * mt + 15 >= wk0) {
        mma_abt<kC, 1>(sc[i], qs + buf * kQTile + 16 * mt * lc, ks + key_at, 1);
        mma_abt<kC, 1>(dp[i], dos + buf * kQTile + 16 * mt * lc, vs + key_at, 1);
      }
    }
    if (c < nc - 1) return;
    // y with the rows' statistics, then dS_bf before its rounding; p and
    // dS_bf to shared memory, [query][key], to read back transposed
#pragma unroll
    for (int i = 0; i < kMt; ++i) {
      const int r0 = qj + 16 * (group * kMt + i);
      float m[2], l[2], big_d[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + frag_row(2 * h);
        const bool in = r < s;
        m[h] = in ? row_stats[r] : 0.0f;
        l[h] = in ? row_stats[plane + r] : 1.0f;
        big_d[h] = in ? row_stats[2 * plane + r] : 0.0f;
      }
      stream_scores(sc[i], r0, wk0, root);
      to_probs(sc[i], m, l);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (r0 + frag_row(e) >= s) sc[i][nt][e] = 0.0f;  // past the last query
          dp[i][nt][e] = round_bf16(dp[i][nt][e]);
        }
      stream_grad_scores(dp[i], sc[i], big_d, r0, wk0, root);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = (16 * i + frag_row(2 * h)) * kSp + 8 * nt + frag_col(0);
          *reinterpret_cast<uint32_t*>(ps + e) = pack(sc[i][nt][2 * h], sc[i][nt][2 * h + 1]);
          *reinterpret_cast<uint32_t*>(dss + e) = pack(dp[i][nt][2 * h], dp[i][nt][2 * h + 1]);
        }
    }
    __syncwarp();
    // A = p^T and dS^T: rows the warp's keys, k 16 queries of the chunk
    const int mi = lane >> 3;
    const int e = ((lane & 7) + (mi >> 1) * 8) * kSp + (mi & 1) * 8;
#pragma unroll
    for (int i = 0; i < kMt; ++i) {
      const int kk = group * kMt + i;
      if (qj + 16 * kk + 15 >= wk0) {
        uint32_t a_p[4], a_ds[4];
        ldsm_x4_trans(a_p, ps + 16 * i * kSp + e);
        ldsm_x4_trans(a_ds, dss + 16 * i * kSp + e);
        if (kResident) {  // stage t is query chunk j, its tiles whole-row
          product_ab<kO, lc>(dv, a_p, dos + buf * kQTile + o0, 16 * kk);
          product_ab<kO, lc>(dk, a_ds, qs + buf * kQTile + o0, 16 * kk);
        } else {
          product_ab<kO>(dv, a_p, doos + (j & 1) * kQOut, 16 * kk);
          product_ab<kO>(dk, a_ds, qos + (j & 1) * kQOut, 16 * kk);
        }
      }
    }
  });
  // with two groups, each one's sums added in group order (over what was
  // staged: the walk is done)
  if (kG == 2) {
    float* partial = reinterpret_cast<float*>(smem);
    add_groups<kO>(dk, partial);
    __syncthreads();
    if (!add_groups<kO>(dv, partial)) return;
  }
  bf16* dst = dqkv + ((size_t)at.batch * s + wk0) * stride + (size_t)at.head * hd + o0;
  store_rows<kO>(dk, dst + d, stride, k0 + kn - wk0, hd - o0);
  store_rows<kO>(dv, dst + 2 * d, stride, k0 + kn - wk0, hd - o0);
}

// ---- wgmma: a warpgroup's 64-row products, operands in shared memory ----
//
// A tile of wgmma operands is bf16 [kHdp / 64][rows][64]: halves of 64
// columns, each row 128 bytes with its 16-byte units swizzled (unit u of
// row r at u ^ (r & 7)), 1024-byte aligned.  The same tile of K serves
// S = Q K^T (K-major: 8-row groups 1024 bytes apart) and dQ += dS K
// (MN-major: the keys' 8-row groups 1024 bytes apart, the column halves
// rows * 128 bytes apart).  In a warpgroup's accumulator warp w holds rows
// [16 w, 16 w + 16) in mma.sync's C fragment, n-tile j at d[4 j, 4 j + 4),
// and its A fragment in registers is mma.sync's: the elementwise code is
// the mma.sync path's.

// d (+)= A B^T, m64n64k16: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B, m64n64k16: A in registers (each warp's 16 rows as mma.sync's A
// fragment), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A B, m64n128k16: A in registers (each warp's 16 rows as mma.sync's A
// fragment), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the compiler may not move reads of a wgmma's accumulator above its wait
template <int kN>
__device__ __forceinline__ void wg_keep(float (&d)[kN][4]) {
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+f"(d[nt][i])::"memory");
}

// kN n-tiles of C fragments as one wgmma accumulator, register for register
template <int kN>
__device__ __forceinline__ float (&flat(float (&d)[kN][4]))[4 * kN] {
  return *reinterpret_cast<float(*)[4 * kN]>(&d[0][0]);
}

// Tensor maps of qkv [b, s, 3, h, head_dim] and dO [b, s, h, head_dim],
// boxes of 64 columns by 64 rows of one head, 128-byte swizzled: the
// swizzled tiles above.  Columns past head_dim and rows past s read as 0.
struct TensorMaps {
  CUtensorMap qkv, dout;
};

// needs head_dim a multiple of 8 and 16-byte aligned bases (`vec`)
cudaError_t tensor_maps(TensorMaps* maps, const bf16* qkv, const bf16* dout, int b, int s,
                        int n_heads, int hd) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t row = (cuuint64_t)hd * sizeof(bf16), d = row * n_heads;
  const cuuint64_t qkv_dims[5] = {(cuuint64_t)hd, (cuuint64_t)n_heads, 3, (cuuint64_t)s,
                                  (cuuint64_t)b};
  const cuuint64_t qkv_strides[4] = {row, d, 3 * d, 3 * d * s};
  const cuuint64_t dout_dims[4] = {(cuuint64_t)hd, (cuuint64_t)n_heads, (cuuint64_t)s,
                                   (cuuint64_t)b};
  const cuuint64_t dout_strides[3] = {row, d, d * s};
  const cuuint32_t qkv_box[5] = {64, 1, 1, kSChunk, 1}, dout_box[4] = {64, 1, kSChunk, 1};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  auto one = [&](CUtensorMap* map, const bf16* base, cuuint32_t rank, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box) {
    return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<bf16*>(base), dims,
                  strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  };
  if (!one(&maps->qkv, qkv, 5, qkv_dims, qkv_strides, qkv_box) ||
      !one(&maps->dout, dout, 4, dout_dims, dout_strides, dout_box))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// acc = A B^T over kHdp: A and B tiles of 64 rows; k-steps ascending from
// zero, as mma.sync's
template <int kHdp>
__device__ __forceinline__ void wg_abt(float (&acc)[8][4], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kHdp; kk += 16) {
    const int at = (kk >> 6) * kSChunk * 64 + (kk & 63);
    wgmma_ss_n64(flat(acc), wg_desc(a + at, 16, 1024), wg_desc(b + at, 16, 1024), kk > 0);
  }
}

// acc += A B over the chunk's 64 keys: A (64 rows x 64 keys) in registers,
// four k-steps; B the chunk's tile, MN-major
template <int kHdp>
__device__ __forceinline__ void wg_ab(float (&acc)[kHdp / 8][4], const uint32_t (&a)[4][4],
                                      const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t desc = wg_desc(b + kk * 16 * 64, kSChunk * 128, 1024);
    if constexpr (kHdp == 128)
      wgmma_rs_n128(flat(acc), a[kk], desc);
    else
      wgmma_rs_n64(flat(acc), a[kk], desc);
  }
}

// ---- the tiles path's dQ on long rows: 64-row tiles, two passes --------
//
// The backward's first launch where a row has more than one chunk of keys,
// the head is one of 64 or 128 columns that TMA can read (head_dim a
// multiple of 8, 16-byte aligned bases) and the grid of 64-row tiles fills
// half the SMs (long_rows below).  A block takes 64 query rows of one
// (head, batch): one warpgroup, each warp owning 16 whole rows, so a row's
// max, sum, D and dQ never leave its warp's registers.  Q and dO stay in
// shared memory; K and V stream through a ring of two chunks of 64 keys,
// the next chunk's copy in flight while one is used.  Nothing in shared
// memory grows with the row: 97 KB a block at heads of 128, two blocks an
// SM (49 KB, three, at 64).  Two passes over the keys, each product from
// the same operands in the same k-order as the second launch's mma.sync, so
// both passes and the second launch see the same bits of every score and
// dP (wgmma's products equal mma.sync's bit for bit, as checked on an H100):
//   1. S = Q K^T and dP = bf16(dO V^T); the row's running max m; the sum
//      l = sum exp(score - m) and D~ = sum exp(score - m) dP, both rescaled
//      by exp(m_old - m) when the max grows; at the end D = D~ / l, an
//      IEEE division.  These are the 16-row design's sums in another f32
//      order; the max is the same bits.
//   2. S and dP again; y = exp(score - m) / l from the final m and l only;
//      dS_bf = bf16(where(mask, y (dP - D), 0) / sqrt(head_dim)), repacked
//      from the C fragments into the A fragment of dQ += dS_bf K.
// Five products a pair the mask leaves, all on wgmma: S and dP from
// swizzled tiles that TMA fills behind one mbarrier a slot, the scores'
// work overlapping dP's product, and dQ's product left in flight while the
// next chunk's S and dP are issued.  The grid runs over (head, batch,
// tile), the tiles last and heaviest first.

// x rounded to bf16 in place, two values a conversion
template <int kN>
__device__ __forceinline__ void round_pairs(float (&x)[kN][4]) {
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t u = pack(x[nt][2 * h], x[nt][2 * h + 1]);
      x[nt][2 * h] = lo_of(u);
      x[nt][2 * h + 1] = hi_of(u);
    }
}

// divide's quotients, its range check taken in four independent chains
// rather than one chain through every value
template <int kN>
__device__ __forceinline__ void divide4(float (&x)[kN][4], const float (&b)[2],
                                        const float (&inv)[2]) {
  bool fast[4] = {true, true, true, true};
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) fast[i] = fast[i] & quotient_in_range(x[nt][i]);
  if ((fast[0] & fast[1]) & (fast[2] & fast[3])) {
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[nt][i] = div_fast(x[nt][i], b[i >> 1], inv[i >> 1]);
  } else {
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[nt][i] = quotient_in_range(x[nt][i]) ? div_fast(x[nt][i], b[i >> 1], inv[i >> 1])
                                               : __fdiv_rn(x[nt][i], b[i >> 1]);
  }
}

// x /= sqrt(head_dim): where the root is a power of two, a product by its
// inverse, which is the same correctly rounded quotient
template <int kN>
__device__ __forceinline__ void by_root(float (&x)[kN][4], const Root& root, bool pow2) {
  if (pow2) {
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[nt][i] *= root.inv[0];
  } else {
    divide4(x, root.root, root.inv);
  }
}

// as stream_scores, with the above
template <int kN>
__device__ __forceinline__ void long_scores(float (&s)[kN][4], int r0, int key0, const Root& root,
                                            bool pow2) {
  round_pairs(s);
  by_root(s, root, pow2);
  if (key0 + 8 * kN - 1 > r0) {
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (key0 + 8 * nt + frag_col(i) > r0 + frag_row(i)) s[nt][i] = kMasked;
  }
}

// as stream_grad_scores, with the above
template <int kN>
__device__ __forceinline__ void long_grad_scores(float (&dp)[kN][4], const float (&y)[kN][4],
                                                 const float (&big_d)[2], int r0, int key0,
                                                 const Root& root, bool pow2) {
  const bool near = key0 + 8 * kN - 1 > r0;
#pragma unroll
  for (int nt = 0; nt < kN; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dp[nt][i] = !near || key0 + 8 * nt + frag_col(i) <= r0 + frag_row(i)
                      ? y[nt][i] * (dp[nt][i] - big_d[i >> 1]) : 0.0f;
  by_root(dp, root, pow2);
}

// the long-row design's ring: chunks of keys in flight, each K then V
constexpr int kLongStages = 2;

// Q and dO, then the ring, 64 rows a tile, swizzled; 1 KB to align them,
// then the barriers: Q and dO's, then a slot's each
template <int kHdp>
size_t long_dq_smem() {
  return (size_t)(2 + 2 * kLongStages) * kSChunk * kHdp * sizeof(bf16) + 1024 +
         (kLongStages + 1) * sizeof(uint64_t);
}

template <int kHdp>
__global__ void __launch_bounds__(128)
causal_attention_bwd_dq_kernel(bf16* __restrict__ dqkv, float* __restrict__ stats, int s,
                               int n_heads, int hd, const __grid_constant__ TensorMaps maps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kTileEls = kSChunk * kHdp;  // a tile of 64 rows
  bf16* qs = reinterpret_cast<bf16*>(smem + ((1024 - (smem_u32(smem) & 1023)) & 1023));
  bf16* dos = qs + kTileEls;    // 64 rows of Q, then of dO
  bf16* ring = dos + kTileEls;  // [kLongStages][K, V][64 rows]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + kLongStages * 2 * kTileEls);

  const int warp = threadIdx.x >> 5;
  const int head = blockIdx.x, batch = blockIdx.y, tile = gridDim.z - 1 - blockIdx.z;
  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const int q0 = tile * kSChunk, wq0 = q0 + 16 * warp;  // the tile's, the warp's first row
  // every chunk has keys that the tile's rows see
  const int chunks = (min(q0 + kSChunk, s) + kSChunk - 1) / kSChunk, stages = 2 * chunks;
  const Root root = root_of(hd);
  const bool pow2 = (__float_as_uint(root.root[0]) & 0x7fffffu) == 0;  // heads of 4^k

  // stage t: chunk t mod chunks (pass 1, then pass 2) into slot t mod
  // kLongStages; one thread asks TMA for K's and V's tiles, counted on the
  // slot's barrier
  auto issue = [&](int t) {
    if (threadIdx.x != 0 || t >= stages) return;
    const int key0 = (t < chunks ? t : t - chunks) * kSChunk;
    bf16* ks = ring + (t % kLongStages) * 2 * kTileEls;
    uint64_t* bar = bars + 1 + t % kLongStages;
    bar_expect(bar, 2 * kTileEls * sizeof(bf16));
#pragma unroll
    for (int half = 0; half < kHdp / 64; ++half) {
      tma_load(ks + half * kSChunk * 64, maps.qkv, {64 * half, head, 1, key0, batch}, bar);
      tma_load(ks + kTileEls + half * kSChunk * 64, maps.qkv, {64 * half, head, 2, key0, batch},
               bar);
    }
  };
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j <= kLongStages; ++j) bar_init(bars + j);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bar_expect(bars, 2 * kTileEls * sizeof(bf16));
#pragma unroll
    for (int half = 0; half < kHdp / 64; ++half) {
      tma_load(qs + half * kSChunk * 64, maps.qkv, {64 * half, head, 0, q0, batch}, bars);
      tma_load(dos + half * kSChunk * 64, maps.dout, {64 * half, head, q0, batch}, bars);
    }
  }
#pragma unroll
  for (int t = 0; t < kLongStages - 1; ++t) issue(t);
  bar_wait(bars, 0);

  float sc[8][4], dp[8][4], dq[kHdp / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, big_d[2] = {0.0f, 0.0f}, inv_l[2];
  zero(dq);
  for (int t = 0; t < stages; ++t) {
    bar_wait(bars + 1 + t % kLongStages, (t / kLongStages) & 1);  // stage t is in
    if (t == chunks) {  // pass 1 is done: the row's sum and D
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = quad_sum(l[h]);
        inv_l[h] = __frcp_rn(l[h]);
        big_d[h] = __fdiv_rn(quad_sum(big_d[h]), l[h]);
      }
    }
    const int key0 = (t < chunks ? t : t - chunks) * kSChunk;
    const bf16* ks = ring + (t % kLongStages) * 2 * kTileEls;
    // S, then dP, queued behind the last chunk's dQ product; the scores'
    // work runs while dP's product does
    wg_fence();
    wg_abt<kHdp>(sc, qs, ks);
    wg_commit();
    wg_abt<kHdp>(dp, dos, ks + kTileEls);
    wg_commit();
    wg_wait<1>();  // S is in, and every group before it: the last chunk's dQ
    wg_keep(sc);
    // Stage t + kLongStages - 1 refills the slot of chunk t - 1, whose
    // products (S, dP and dQ) every warp has now waited for: TMA may not
    // write a wgmma's operand before that wgmma's wait_group.
    __syncthreads();
    issue(t + kLongStages - 1);
    long_scores(sc, wq0, key0, root, pow2);
    if (t < chunks) {
      float top[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) top[i >> 1] = fmaxf(top[i >> 1], sc[nt][i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        top[h] = quad_max(top[h]);
        if (top[h] > m[h]) {  // exp(-inf) is 0: the first chunk keeps nothing
          const float r = expf(m[h] - top[h]);
          l[h] *= r;
          big_d[h] *= r;
          m[h] = top[h];
        }
      }
      exps(sc, m);  // exactly 0 where masked
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) l[i >> 1] += sc[nt][i];
      wg_wait<0>();
      wg_keep(dp);
      round_pairs(dp);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) big_d[i >> 1] = fmaf(sc[nt][i], dp[nt][i], big_d[i >> 1]);
    } else {
      exps(sc, m);
      divide4(sc, l, inv_l);  // y
      wg_wait<0>();
      wg_keep(dp);
      round_pairs(dp);
      long_grad_scores(dp, sc, big_d, wq0, key0, root, pow2);
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) a_from_pair(a[kk], dp[2 * kk], dp[2 * kk + 1]);
      wg_fence();
      wg_ab<kHdp>(dq, a, ks);
      wg_commit();  // waited for with the next chunk's S, or after the walk
    }
  }
  wg_wait<0>();
  wg_keep(dq);
  if (wq0 >= s) return;  // the warp's rows lie past the sequence

  store_rows<kHdp>(dq, dqkv + ((size_t)batch * s + wq0) * stride + (size_t)head * hd, stride,
                   s - wq0, hd);
  // the rows' statistics, [3][b][h][s]: max, sum, D
  if ((lane_id() & 3) == 0) {
    const size_t size = (size_t)gridDim.y * n_heads * s;
    const size_t row0 = ((size_t)batch * n_heads + head) * s + wq0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = frag_row(2 * h);
      if (wq0 + r < s) {
        stats[row0 + r] = m[h];
        stats[size + row0 + r] = l[h];
        stats[2 * size + row0 + r] = big_d[h];
      }
    }
  }
}

// Shared memory of the stream kernels, in bytes; with one column chunk
// (kC >= kO) Q and dO, or K and V, stay, and no output tile is staged but V
// (the two key groups' maxima, sums and D after them: 3 x 2 x 64 floats)
constexpr size_t kRedBytes = 3 * 2 * kSTile * sizeof(float);

template <int kC, int kO>
size_t stream_fwd_smem() {
  return ((kC >= kO ? 1 : 2) + 2) * tile_bytes<kC>(kSTile) + 2 * tile_bytes<kO>(kSTile) +
         kRedBytes;
}

template <int kC, int kO>
size_t stream_dq_smem() {
  return ((kC >= kO ? 2 : 4) + 4) * tile_bytes<kC>(kSTile) +
         (kC >= kO ? 0 : 2 * tile_bytes<kO>(kSTile)) + kRedBytes;
}

template <int kC, int kO>
size_t stream_dkv_smem() {
  return (kC >= kO ? 2 : 4) * tile_bytes<kC>(kSTile) + 4 * tile_bytes<kC>(kSQueries) +
         (kC >= kO ? 0 : 4 * tile_bytes<kO>(kSQueries)) +
         2 * 4 * kSQueries * kSp * sizeof(bf16);
}

// The stream path's grid: tiles of 64 rows over every plane (and, for the
// second launch, every chunk of output columns), at most CUDA's 2^31 - 1
// blocks.
struct StreamGrid {
  int tiles, planes;
  long long blocks;
};

StreamGrid stream_grid(int b, int s, int n_heads, int nout) {
  const long long tiles = (s + kSTile - 1) / kSTile, planes = (long long)b * n_heads;
  return {(int)tiles, (int)std::min(planes, (long long)INT_MAX), tiles * planes * nout};
}

// Two groups of warps a block where the grid has fewer than two blocks an
// SM (kG in the kernels' comment).
int sm_count() {
  static const int sms = [] {
    int device = 0, count = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    return count;
  }();
  return sms;
}

bool two_groups(long long blocks) { return blocks < 2LL * sm_count(); }

template <int kC, int kO, int kG>
cudaError_t launch_stream_fwd_groups(const StreamGrid& grid, const bf16* qkv, bf16* out, int s,
                              int n_heads, int hd, cudaStream_t st) {
  const cudaError_t err = allow_smem(attention_stream_kernel<kC, kO, kG>);
  if (err != cudaSuccess) return err;
  attention_stream_kernel<kC, kO, kG><<<(unsigned)grid.blocks, kSThreads * kG,
                                        stream_fwd_smem<kC, kO>(), st>>>(
      qkv, out, s, n_heads, hd, grid.tiles, grid.planes, hd % 8 == 0 && of::aligned16(qkv, out));
  return cudaGetLastError();
}

template <int kC, int kO>
cudaError_t launch_stream_fwd(const bf16* qkv, bf16* out, int b, int s, int n_heads, int hd,
                              cudaStream_t st) {
  const StreamGrid grid = stream_grid(b, s, n_heads, 1);
  if (grid.blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  // with two groups a warp's scores take half the registers, and a head of
  // 256 takes its output in one pass
  constexpr int kO2 = kC == 256 ? 256 : kO;
  return two_groups(grid.blocks)
             ? launch_stream_fwd_groups<kC, kO2, 2>(grid, qkv, out, s, n_heads, hd, st)
             : launch_stream_fwd_groups<kC, kO, 1>(grid, qkv, out, s, n_heads, hd, st);
}

template <int kC, int kO, int kG>
cudaError_t launch_stream_dq(const StreamGrid& grid, const bf16* qkv, const bf16* dout,
                             bf16* dqkv, float* stats, int s, int n_heads, int hd, bool vec,
                             cudaStream_t st) {
  const cudaError_t err = allow_smem(attention_stream_dq_kernel<kC, kO, kG>);
  if (err != cudaSuccess) return err;
  attention_stream_dq_kernel<kC, kO, kG><<<(unsigned)grid.blocks, kSThreads * kG,
                                           stream_dq_smem<kC, kO>(), st>>>(
      qkv, dout, dqkv, stats, s, n_heads, hd, grid.tiles, grid.planes, vec);
  return cudaGetLastError();
}

template <int kC, int kO, int kG>
cudaError_t launch_stream_dkv(const StreamGrid& grid, const bf16* qkv, const bf16* dout,
                              const float* stats, bf16* dqkv, int s, int n_heads, int hd,
                              bool vec, cudaStream_t st) {
  const cudaError_t err = allow_smem(attention_stream_dkv_kernel<kC, kO, kG>);
  if (err != cudaSuccess) return err;
  attention_stream_dkv_kernel<kC, kO, kG><<<(unsigned)grid.blocks, kSThreads * kG,
                                            stream_dkv_smem<kC, kO>(), st>>>(
      qkv, dout, stats, dqkv, s, n_heads, hd, grid.tiles, grid.planes, vec);
  return cudaGetLastError();
}

template <int kC, int kO>
cudaError_t launch_stream_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv, float* stats, int b,
                              int s, int n_heads, int hd, cudaStream_t st) {
  const StreamGrid dq = stream_grid(b, s, n_heads, 1);
  const StreamGrid dkv = stream_grid(b, s, n_heads, (hd + kO - 1) / kO);
  if (dkv.blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const bool vec = hd % 8 == 0 && of::aligned16(qkv, dout, dqkv);
  constexpr int kO2 = kC == 256 ? 256 : kO;  // as the forward's
  const cudaError_t err =
      two_groups(dq.blocks)
          ? launch_stream_dq<kC, kO2, 2>(dq, qkv, dout, dqkv, stats, s, n_heads, hd, vec, st)
          : launch_stream_dq<kC, kO, 1>(dq, qkv, dout, dqkv, stats, s, n_heads, hd, vec, st);
  if (err != cudaSuccess) return err;
  return two_groups(dkv.blocks)
             ? launch_stream_dkv<kC, kO, 2>(dkv, qkv, dout, stats, dqkv, s, n_heads, hd, vec, st)
             : launch_stream_dkv<kC, kO, 1>(dkv, qkv, dout, stats, dqkv, s, n_heads, hd, vec, st);
}

// f.run<kC, kO>(): the column chunk of the scores and of an output pass.
// One chunk holds a head of at most 256 (padded as the tiles path pads
// it, then to 256); wider heads go 64 columns a score chunk.  An output
// pass takes at most 128 columns.
template <typename F>
cudaError_t stream_dispatch(int head_dim, const F& f) {
  if (head_dim <= 16) return f.template run<16, 16>();
  if (head_dim <= 32) return f.template run<32, 32>();
  if (head_dim <= 64) return f.template run<64, 64>();
  if (head_dim <= 128) return f.template run<128, 128>();
  if (head_dim <= 256) return f.template run<256, 128>();
  return f.template run<64, 128>();
}

struct StreamForward {
  const bf16* qkv;
  bf16* out;
  int b, s, n_heads, hd;
  cudaStream_t st;
  template <int kC, int kO>
  cudaError_t run() const { return launch_stream_fwd<kC, kO>(qkv, out, b, s, n_heads, hd, st); }
};

struct StreamBackward {
  const bf16* qkv;
  const bf16* dout;
  bf16* dqkv;
  float* stats;
  int b, s, n_heads, hd;
  cudaStream_t st;
  template <int kC, int kO>
  cudaError_t run() const {
    return launch_stream_bwd<kC, kO>(qkv, dout, dqkv, stats, b, s, n_heads, hd, st);
  }
};

template <int kHdp, bool kOne>
cudaError_t launch_fwd(const bf16* qkv, bf16* out, int b, int s, int n_heads, int hd,
                       cudaStream_t st) {
  const size_t smem = fwd_smem<kHdp, kOne>(s);
  const cudaError_t err = allow_smem(causal_attention_kernel<kHdp, kOne>);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRows - 1) / kRows, n_heads, b);
  // 16-byte loads need head_dim a multiple of 8 and 16-byte aligned bases
  causal_attention_kernel<kHdp, kOne><<<grid, kThreads, smem, st>>>(
      qkv, out, s, n_heads, hd, hd % 8 == 0 && of::aligned16(qkv, out));
  return cudaGetLastError();
}

// the two designs of the backward's first launch share a name, and are
// told apart by their template arguments and their parameters
using DqKernel = void (*)(const bf16*, const bf16*, bf16*, float*, int, int, int, bool);
using LongDqKernel = void (*)(bf16*, float*, int, int, int, TensorMaps);

// Whether the first launch takes the long-row design, given 16-byte aligned
// bases: rows of more than one chunk of keys, heads that wgmma and TMA take
// (padded to 64 or 128 columns, head_dim a multiple of 8), on a grid of
// 64-row tiles of at least one block for every two SMs.  Below that the
// 16-row tiles' grid, 4x larger, keeps more SMs at work (measured on the
// card: the long-row design is 1.2-4.9x faster from 128 blocks up, 0.7-1.0x
// at 32 blocks and fewer, either way at 64; PERF.md).
bool long_rows(int b, int s, int n_heads, int head_dim) {
  const long long blocks = (long long)(s + kSChunk - 1) / kSChunk * b * n_heads;
  return s > kChunk && head_dim > 32 && head_dim % 8 == 0 && 2 * blocks >= sm_count();
}

template <int kHdp, bool kOne>
cudaError_t launch_dq(const bf16* qkv, const bf16* dout, bf16* dqkv, float* stats, int b, int s,
                      int n_heads, int hd, bool vec, cudaStream_t st) {
  if constexpr (!kOne && kHdp >= 64) {
    if (vec && long_rows(b, s, n_heads, hd)) {
      TensorMaps maps{};
      cudaError_t err = tensor_maps(&maps, qkv, dout, b, s, n_heads, hd);
      if (err != cudaSuccess) return err;
      const LongDqKernel kernel = causal_attention_bwd_dq_kernel<kHdp>;
      err = allow_smem(kernel);
      if (err != cudaSuccess) return err;
      // the tiles last, heaviest first: the longest rows start in the first wave
      const dim3 grid(n_heads, b, (s + kSChunk - 1) / kSChunk);
      kernel<<<grid, 128, long_dq_smem<kHdp>(), st>>>(dqkv, stats, s, n_heads, hd, maps);
      return cudaGetLastError();
    }
  }
  const DqKernel kernel = causal_attention_bwd_dq_kernel<kHdp, kOne>;
  const cudaError_t err = allow_smem(kernel);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRows - 1) / kRows, n_heads, b);
  kernel<<<grid, kThreads, bwd_dq_smem<kHdp, kOne>(s), st>>>(qkv, dout, dqkv, stats, s, n_heads,
                                                              hd, vec);
  return cudaGetLastError();
}

template <int kHdp, bool kOne>
cudaError_t launch_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv, float* stats, int b, int s,
                       int n_heads, int hd, cudaStream_t st) {
  const bool vec = hd % 8 == 0 && of::aligned16(qkv, dout, dqkv);
  cudaError_t err = launch_dq<kHdp, kOne>(qkv, dout, dqkv, stats, b, s, n_heads, hd, vec, st);
  if (err != cudaSuccess) return err;
  err = allow_smem(causal_attention_bwd_dkv_kernel<kHdp>);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRows - 1) / kRows, n_heads, b);
  causal_attention_bwd_dkv_kernel<kHdp><<<grid, kThreads, bwd_dkv_smem<kHdp>(), st>>>(
      qkv, dout, stats, dqkv, s, n_heads, hd, vec);
  return cudaGetLastError();
}

// f.run<kHdp, kOne>(): the padded head width, and whether one chunk holds
// every key
template <typename F>
cudaError_t dispatch(int s, int head_dim, const F& f) {
  const bool one = s <= kChunk;
  if (head_dim <= 16) return one ? f.template run<16, true>() : f.template run<16, false>();
  if (head_dim <= 32) return one ? f.template run<32, true>() : f.template run<32, false>();
  if (head_dim <= 64) return one ? f.template run<64, true>() : f.template run<64, false>();
  return one ? f.template run<128, true>() : f.template run<128, false>();
}

struct Forward {
  const bf16* qkv;
  bf16* out;
  int b, s, n_heads, hd;
  cudaStream_t st;
  template <int kHdp, bool kOne>
  cudaError_t run() const { return launch_fwd<kHdp, kOne>(qkv, out, b, s, n_heads, hd, st); }
};

struct Backward {
  const bf16* qkv;
  const bf16* dout;
  bf16* dqkv;
  float* stats;
  int b, s, n_heads, hd;
  cudaStream_t st;
  template <int kHdp, bool kOne>
  cudaError_t run() const {
    return launch_bwd<kHdp, kOne>(qkv, dout, dqkv, stats, b, s, n_heads, hd, st);
  }
};

// Whether the tiles path takes a shape: heads of up to kMaxHeadDim, batch
// and heads within the grid's y and z, and every kernel's shared memory
// (the spilled scores grow with the row) within a block's.
struct SmemNeed {
  int s;
  size_t* bytes;
  template <int kHdp, bool kOne>
  cudaError_t run() const {
    *bytes = std::max({fwd_smem<kHdp, kOne>(s), bwd_dq_smem<kHdp, kOne>(s), bwd_dkv_smem<kHdp>()});
    return cudaSuccess;
  }
};

bool tiles_take(int b, int s, int n_heads, int head_dim) {
  if (head_dim > kMaxHeadDim || b > 65535 || n_heads > 65535) return false;
  size_t bytes = 0;
  dispatch(s, head_dim, SmemNeed{s, &bytes});
  return bytes <= (size_t)of::kMaxSmemBytes;
}

bool valid(int b, int s, int n_heads, int head_dim) {
  return b >= 1 && s >= 1 && n_heads >= 1 && head_dim >= 1;
}

}  // namespace

extern "C" {

const char* of_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// 1 where the tiles path takes the shape, 0 where the stream path does.
int causal_attention_tiles(int b, int s, int n_heads, int head_dim) {
  return valid(b, s, n_heads, head_dim) && tiles_take(b, s, n_heads, head_dim);
}

// 1 where the backward's first launch takes the long-row design (64-row
// tiles, two passes) on 16-byte aligned bases, 0 where it takes 16-row
// tiles or the stream path.
int causal_attention_bwd_rows64(int b, int s, int n_heads, int head_dim) {
  return causal_attention_tiles(b, s, n_heads, head_dim) && long_rows(b, s, n_heads, head_dim);
}

// qkv: bf16 [b, s, 3 * n_heads * head_dim], contiguous; out: bf16
// [b, s, n_heads * head_dim], contiguous.  Returns cudaGetLastError().
int causal_attention_bf16(const void* qkv, void* out, int b, int s, int n_heads, int head_dim,
                          void* stream) {
  if (!valid(b, s, n_heads, head_dim)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tiles_take(b, s, n_heads, head_dim))
    return stream_dispatch(head_dim, StreamForward{static_cast<const bf16*>(qkv),
                                                   static_cast<bf16*>(out), b, s, n_heads,
                                                   head_dim, st});
  const Forward f{static_cast<const bf16*>(qkv), static_cast<bf16*>(out), b, s, n_heads,
                  head_dim, st};
  return dispatch(s, head_dim, f);
}

// qkv: bf16 [b, s, 3d] as in the forward; dout: bf16 [b, s, d]; dqkv: bf16
// [b, s, 3d]; stats: f32 [3, b, n_heads, s] (each row's softmax max, sum
// and D, handed from the first launch to the second), all contiguous,
// d = n_heads * head_dim.  Two launches on one stream; returns
// cudaGetLastError().
int causal_attention_bwd_bf16(const void* qkv, const void* dout, void* dqkv, void* stats, int b,
                              int s, int n_heads, int head_dim, void* stream) {
  if (!valid(b, s, n_heads, head_dim)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tiles_take(b, s, n_heads, head_dim))
    return stream_dispatch(head_dim, StreamBackward{static_cast<const bf16*>(qkv),
                                                    static_cast<const bf16*>(dout),
                                                    static_cast<bf16*>(dqkv),
                                                    static_cast<float*>(stats), b, s, n_heads,
                                                    head_dim, st});
  const Backward f{static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                   static_cast<bf16*>(dqkv), static_cast<float*>(stats), b, s, n_heads,
                   head_dim, st};
  return dispatch(s, head_dim, f);
}

}  // extern "C"
