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
// Bound on an H100 SXM at DemoConfig() (batch 8, seq 64, 4 heads of 32):
// the forward reads the QKV product once (393,216 B) and writes the output
// once (131,072 B), 0.52 MB: 0.16 us at 3.35 TB/s, against 8.5 MFLOP of
// causal products, 0.01 us at the bf16 tensor rate.  The backward reads
// QKV and dO and writes dQKV, 0.92 MB: 0.27 us, against 21 MFLOP of five
// causal products (the score recompute, dP, dV, dQ, dK), 0.02 us.  Both lie
// far below one launch; what is left to win is latency: of the loads, of
// the chains of products, and of the steps between them.
//
// Design.  Every product is an mma.sync.aligned.m16n8k16 bf16 -> f32 on
// the tensor cores.  A block is 4 warps over one tile of 16 rows (query
// rows in the forward and the backward's first launch, key rows in its
// second) of one (head, batch): 128 blocks at DemoConfig(), about one per
// SM.  wgmma is not the tool at these shapes: its 64-row tile per (batch,
// head) would keep 32 of 132 SMs busy, where 16-row tiles keep 128 busy,
// and a 16-row tile is mma.sync's.  Each of the 4 warps takes 16 keys of
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
// first, per query tile, recomputes the scores and the softmax with the
// forward's own code, computes dP, D and dS_bf in registers, writes dQ and
// each row's max, sum and D (three f32 [b, h, s] arrays).  The second, per
// key tile, walks the query tiles in ascending order (a warp's next tile
// of q and dO in flight while the current one is used), recomputes the
// scores and dP with the same operands in the same roles and k-order, so
// y = exp(score - max) / sum comes out with the first launch's bits,
// stages its p and dS_bf tile in shared memory to transpose them, and sums
// dK and dV in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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
__device__ __forceinline__ void divide(float (&x)[2][4], const float (&b)[2],
                                       const float (&inv)[2]) {
  bool fast = true;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) fast = fast & quotient_in_range(x[nt][i]);
  if (fast) {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[nt][i] = div_fast(x[nt][i], b[i >> 1], inv[i >> 1]);
  } else {
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
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
// in registers, B rows [k0, k0 + 16) of b (row-major [k][n], ld), read by
// ldmatrix.trans.
template <int kHdp>
__device__ __forceinline__ void product_ab(float (&out)[kHdp / 8][4], const uint32_t (&a)[4],
                                           const bf16* b, int k0) {
  constexpr int ld = ld_of<kHdp>();
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
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack(c[0][0], c[0][1]);
  a[1] = pack(c[0][2], c[0][3]);
  a[2] = pack(c[1][0], c[1][1]);
  a[3] = pack(c[1][2], c[1][3]);
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
__device__ __forceinline__ void to_scores(float (&s)[2][4], int q0, int key0,
                                          const Root& root) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = round_bf16(s[nt][i]);
  divide(s, root.root, root.inv);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
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
__device__ __forceinline__ void exps(float (&s)[2][4], const float (&m)[2]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[nt][i] = expf(s[nt][i] - m[i >> 1]);
}

// y = e / sum in place, the sums of the fragment's two rows
__device__ __forceinline__ void normalize(float (&e)[2][4], const float (&l)[2]) {
  const float inv_l[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  divide(e, l, inv_l);
}

// y = exp(score - max) / sum in place over scores
__device__ __forceinline__ void to_probs(float (&s)[2][4], const float (&m)[2],
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
__device__ __forceinline__ void to_grad_scores(float (&dp)[2][4], const float (&y)[2][4],
                                               const float (&big_d)[2], int q0, int key0,
                                               const Root& root) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
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

// ---- the rows path: long rows, wide heads, many heads or batches --------
//
// One warp per row, f32 FMAs, the other side's rows staged chunk by chunk
// as f32 ([chunk][hd + 1]) and re-scored in every pass, so it takes any
// sequence and any head up to kRowsMaxHeadDim.  The cast points are the
// reference's, as above: score = bf16(q . k) / sqrt(hd) (an IEEE division),
// a max pass, a sum pass, then y = exp(score - max) / sum and p = bf16(y).
// Every sum over the other side runs in ascending order from 0, kept for
// each of the row's columns in shared memory, so a launch repeats bit for
// bit; the dot products are four FMA chains over the head, and a pair is
// scored with the same bits wherever it is scored.

constexpr int kRowsChunk = 64;          // most rows of the other side staged at a time
constexpr int kRowsMaxHeadDim = 3072;   // the widest head whose rows fit in shared memory
constexpr int kSmemFloats = of::kMaxSmemBytes / sizeof(float);

// the score of a pair from the f32 product: bf16, then / sqrt(hd)
__device__ __forceinline__ float score_of(float product, float root) {
  return __fdiv_rn(round_bf16(product), root);
}

// dS_bf before the product: bf16(y (dP - D) / sqrt(hd))
__device__ __forceinline__ float grad_score_of(float y, float dp, float big_d, float root) {
  return round_bf16(__fdiv_rn(__fmul_rn(y, __fsub_rn(dp, big_d)), root));
}

// Where a block of the rows path is: its plane (head, batch) and first row.
struct RowsBlock {
  int head, batch, r0, rows;
};

__device__ __forceinline__ RowsBlock rows_block(size_t id, int row_blocks, int s, int n_heads) {
  const size_t plane = id / row_blocks;
  const int r0 = (int)(id % row_blocks) * kWarps;
  return {(int)(plane % n_heads), (int)(plane / n_heads), r0, min(kWarps, s - r0)};
}

// The softmax statistics of query row `row` (q in qr, f32) over keys
// [0, row] of the block's keys [0, n_keys): the max (from the fill, as the
// tiles path takes it) and the sum, in two passes that stage K chunk by
// chunk into ks.  Every warp of the block calls it.
__device__ __forceinline__ void rows_stats(float& mx, float& l, const float* qr, float* ks,
                                           const bf16* k_src, size_t stride, int row, bool live,
                                           int n_keys, int hd, int chunk, bool vec, float root) {
  const int lane = lane_id(), ld = hd + 1;
  const int seen = live ? row + 1 : 0;
  mx = kMasked;
  for (int k0 = 0; k0 < n_keys; k0 += chunk) {
    const int kn = min(chunk, n_keys - k0);
    __syncthreads();
    of::stage_rows(ks, k_src, stride, k0, kn, hd, ld, vec);
    __syncthreads();
    for (int j = k0 + lane; j < min(k0 + kn, seen); j += 32)
      mx = fmaxf(mx, score_of(of::dot(qr, ks + (j - k0) * ld, hd), root));
  }
  mx = of::warp_max(mx);
  l = 0.0f;
  for (int k0 = 0; k0 < n_keys; k0 += chunk) {
    const int kn = min(chunk, n_keys - k0);
    __syncthreads();
    of::stage_rows(ks, k_src, stride, k0, kn, hd, ld, vec);
    __syncthreads();
    for (int j = k0 + lane; j < min(k0 + kn, seen); j += 32)
      l += expf(score_of(of::dot(qr, ks + (j - k0) * ld, hd), root) - mx);
  }
  l = of::warp_sum(l);
}

// Forward: one warp per query row; out = bf16(sum_j p_j v_j).
__global__ void __launch_bounds__(kThreads)
attention_rows_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int s, int n_heads,
                      int hd, int chunk, int row_blocks, bool vec) {
  extern __shared__ float fsmem[];
  const int warp = threadIdx.x >> 5, lane = lane_id(), ld = hd + 1;
  const RowsBlock at = rows_block(blockIdx.x, row_blocks, s, n_heads);
  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)at.batch * s * stride + (size_t)at.head * hd;
  float* ks = fsmem;                 // [chunk][ld]
  float* vs = ks + chunk * ld;       // [chunk][ld]
  float* qs = vs + chunk * ld;       // [kWarps][hd]
  float* acc = qs + kWarps * hd;     // [kWarps][hd]
  float* pbuf = acc + kWarps * hd;   // [kWarps][chunk]
  const int row = at.r0 + warp, n_keys = at.r0 + at.rows;
  const bool live = warp < at.rows;
  float* qr = qs + warp * hd;
  float* sum = acc + warp * hd;
  float* pb = pbuf + warp * chunk;
  if (live)
    for (int c = lane; c < hd; c += 32) {
      qr[c] = __bfloat162float(base[(size_t)row * stride + c]);
      sum[c] = 0.0f;
    }
  const float root = sqrtf((float)hd);
  float mx, l;
  rows_stats(mx, l, qr, ks, base + d, stride, row, live, n_keys, hd, chunk, vec, root);
  const int seen = live ? row + 1 : 0;
  for (int k0 = 0; k0 < n_keys; k0 += chunk) {
    const int kn = min(chunk, n_keys - k0), end = min(k0 + kn, seen);
    __syncthreads();
    of::stage_rows(ks, base + d, stride, k0, kn, hd, ld, vec);
    of::stage_rows(vs, base + 2 * d, stride, k0, kn, hd, ld, vec);
    __syncthreads();
    if (k0 >= end) continue;
    for (int j = k0 + lane; j < end; j += 32)
      pb[j - k0] = round_bf16(
          __fdiv_rn(expf(score_of(of::dot(qr, ks + (j - k0) * ld, hd), root) - mx), l));
    __syncwarp();
    for (int c = lane; c < hd; c += 32) {
      float a = sum[c];
      for (int j = k0; j < end; ++j) a = fmaf(pb[j - k0], vs[(j - k0) * ld + c], a);
      sum[c] = a;
    }
    __syncwarp();
  }
  if (!live) return;
  bf16* dst = out + ((size_t)at.batch * s + row) * d + (size_t)at.head * hd;
  for (int c = lane; c < hd; c += 32) dst[c] = __float2bfloat16(sum[c]);
}

// Backward, first launch: one warp per query row.  Writes dQ and the row's
// max, sum and D into stats [3][b][h][s] for the second launch.
__global__ void __launch_bounds__(kThreads)
attention_rows_dq_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                         bf16* __restrict__ dqkv, float* __restrict__ stats, int b, int s,
                         int n_heads, int hd, int chunk, int row_blocks, bool vec) {
  extern __shared__ float fsmem[];
  const int warp = threadIdx.x >> 5, lane = lane_id(), ld = hd + 1;
  const RowsBlock at = rows_block(blockIdx.x, row_blocks, s, n_heads);
  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)at.batch * s * stride + (size_t)at.head * hd;
  const bf16* dbase = dout + (size_t)at.batch * s * d + (size_t)at.head * hd;
  float* ks = fsmem;                  // [chunk][ld]
  float* vs = ks + chunk * ld;        // [chunk][ld]
  float* own = vs + chunk * ld;       // [kWarps][2][hd]  q and dO
  float* acc = own + 2 * kWarps * hd; // [kWarps][hd]
  float* bufs = acc + kWarps * hd;    // [kWarps][chunk]
  const int row = at.r0 + warp, n_keys = at.r0 + at.rows;
  const bool live = warp < at.rows;
  float* qr = own + 2 * warp * hd;
  float* dor = qr + hd;
  float* sum = acc + warp * hd;
  float* dsb = bufs + warp * chunk;
  if (live)
    for (int c = lane; c < hd; c += 32) {
      qr[c] = __bfloat162float(base[(size_t)row * stride + c]);
      dor[c] = __bfloat162float(dbase[(size_t)row * d + c]);
      sum[c] = 0.0f;
    }
  const float root = sqrtf((float)hd);
  float mx, l;
  rows_stats(mx, l, qr, ks, base + d, stride, row, live, n_keys, hd, chunk, vec, root);
  const int seen = live ? row + 1 : 0;
  // D = sum_j y_j dP_j, dP = bf16(dO . v)
  float big_d = 0.0f;
  for (int k0 = 0; k0 < n_keys; k0 += chunk) {
    const int kn = min(chunk, n_keys - k0);
    __syncthreads();
    of::stage_rows(ks, base + d, stride, k0, kn, hd, ld, vec);
    of::stage_rows(vs, base + 2 * d, stride, k0, kn, hd, ld, vec);
    __syncthreads();
    for (int j = k0 + lane; j < min(k0 + kn, seen); j += 32) {
      const float y =
          __fdiv_rn(expf(score_of(of::dot(qr, ks + (j - k0) * ld, hd), root) - mx), l);
      big_d = fmaf(y, round_bf16(of::dot(dor, vs + (j - k0) * ld, hd)), big_d);
    }
  }
  big_d = of::warp_sum(big_d);
  // dQ = bf16(sum_j dS_bf_j k_j)
  for (int k0 = 0; k0 < n_keys; k0 += chunk) {
    const int kn = min(chunk, n_keys - k0), end = min(k0 + kn, seen);
    __syncthreads();
    of::stage_rows(ks, base + d, stride, k0, kn, hd, ld, vec);
    of::stage_rows(vs, base + 2 * d, stride, k0, kn, hd, ld, vec);
    __syncthreads();
    if (k0 >= end) continue;
    for (int j = k0 + lane; j < end; j += 32) {
      const float y =
          __fdiv_rn(expf(score_of(of::dot(qr, ks + (j - k0) * ld, hd), root) - mx), l);
      dsb[j - k0] = grad_score_of(y, round_bf16(of::dot(dor, vs + (j - k0) * ld, hd)), big_d,
                                  root);
    }
    __syncwarp();
    for (int c = lane; c < hd; c += 32) {
      float a = sum[c];
      for (int j = k0; j < end; ++j) a = fmaf(dsb[j - k0], ks[(j - k0) * ld + c], a);
      sum[c] = a;
    }
    __syncwarp();
  }
  if (!live) return;
  bf16* dst = dqkv + ((size_t)at.batch * s + row) * stride + (size_t)at.head * hd;
  for (int c = lane; c < hd; c += 32) dst[c] = __float2bfloat16(sum[c]);
  if (lane == 0) {
    const size_t plane = (size_t)b * n_heads * s;
    const size_t r = ((size_t)at.batch * n_heads + at.head) * s + row;
    stats[r] = mx;
    stats[plane + r] = l;
    stats[2 * plane + r] = big_d;
  }
}

// Backward, second launch: one warp per key row, over the queries at or
// after it: dK = bf16(sum_q dS_bf q), dV = bf16(sum_q p dO).
__global__ void __launch_bounds__(kThreads)
attention_rows_dkv_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                          const float* __restrict__ stats, bf16* __restrict__ dqkv, int b, int s,
                          int n_heads, int hd, int chunk, int row_blocks, bool vec) {
  extern __shared__ float fsmem[];
  const int warp = threadIdx.x >> 5, lane = lane_id(), ld = hd + 1;
  const RowsBlock at = rows_block(blockIdx.x, row_blocks, s, n_heads);
  const int d = n_heads * hd;
  const size_t stride = 3 * (size_t)d;
  const bf16* base = qkv + (size_t)at.batch * s * stride + (size_t)at.head * hd;
  const bf16* dbase = dout + (size_t)at.batch * s * d + (size_t)at.head * hd;
  const size_t plane = (size_t)b * n_heads * s;
  const float* row_stats = stats + ((size_t)at.batch * n_heads + at.head) * s;
  float* qs = fsmem;                   // [chunk][ld]  queries
  float* dos = qs + chunk * ld;        // [chunk][ld]  their dO
  float* own = dos + chunk * ld;       // [kWarps][2][hd]  k and v
  float* acc = own + 2 * kWarps * hd;  // [kWarps][2][hd]  dK and dV
  float* bufs = acc + 2 * kWarps * hd; // [kWarps][2][chunk]  p and dS_bf
  float* st = bufs + 2 * kWarps * chunk;  // [3][chunk]  the queries' max, sum, D
  const int row = at.r0 + warp;
  const bool live = warp < at.rows;
  float* kr = own + 2 * warp * hd;
  float* vr = kr + hd;
  float* dk = acc + 2 * warp * hd;
  float* dv = dk + hd;
  float* pb = bufs + 2 * warp * chunk;
  float* db = pb + chunk;
  if (live)
    for (int c = lane; c < hd; c += 32) {
      kr[c] = __bfloat162float(base[(size_t)row * stride + d + c]);
      vr[c] = __bfloat162float(base[(size_t)row * stride + 2 * d + c]);
      dk[c] = dv[c] = 0.0f;
    }
  const float root = sqrtf((float)hd);
  const int first = live ? row : s;  // the queries that see this key: [row, s)
  for (int q0 = at.r0; q0 < s; q0 += chunk) {
    const int qn = min(chunk, s - q0);
    __syncthreads();
    of::stage_rows(qs, base, stride, q0, qn, hd, ld, vec);
    of::stage_rows(dos, dbase, d, q0, qn, hd, ld, vec);
    for (int i = threadIdx.x; i < qn; i += blockDim.x) {
      st[i] = row_stats[q0 + i];
      st[chunk + i] = row_stats[plane + q0 + i];
      st[2 * chunk + i] = row_stats[2 * plane + q0 + i];
    }
    __syncthreads();
    const int from = max(q0, first), to = q0 + qn;
    if (from >= to) continue;
    for (int i = from + lane; i < to; i += 32) {
      const int o = i - q0;
      const float y = __fdiv_rn(
          expf(score_of(of::dot(qs + o * ld, kr, hd), root) - st[o]), st[chunk + o]);
      pb[o] = round_bf16(y);
      db[o] = grad_score_of(y, round_bf16(of::dot(dos + o * ld, vr, hd)), st[2 * chunk + o],
                            root);
    }
    __syncwarp();
    for (int c = lane; c < hd; c += 32) {
      float a_k = dk[c], a_v = dv[c];
      for (int i = from; i < to; ++i) {
        a_k = fmaf(db[i - q0], qs[(i - q0) * ld + c], a_k);
        a_v = fmaf(pb[i - q0], dos[(i - q0) * ld + c], a_v);
      }
      dk[c] = a_k;
      dv[c] = a_v;
    }
    __syncwarp();
  }
  if (!live) return;
  bf16* dst = dqkv + ((size_t)at.batch * s + row) * stride + (size_t)at.head * hd;
  for (int c = lane; c < hd; c += 32) {
    dst[d + c] = __float2bfloat16(dk[c]);
    dst[2 * d + c] = __float2bfloat16(dv[c]);
  }
}

// The rows path's launch shape: rows of other side staged at a time, and
// the grid's row blocks a plane (0 where either does not fit).
struct RowsShape {
  int chunk, row_blocks;
  size_t smem;
};

RowsShape rows_shape(int b, int s, int n_heads, int hd, int fixed, int per_row) {
  const long long row_blocks = (s + kWarps - 1) / kWarps;
  int chunk = min(min(kRowsChunk, s), (kSmemFloats - fixed) / per_row);
  if (hd > kRowsMaxHeadDim || chunk < 1 || row_blocks * b * n_heads >= (1LL << 31))
    return {0, 0, 0};
  return {chunk, (int)row_blocks, sizeof(float) * ((size_t)fixed + (size_t)chunk * per_row)};
}

bool rows_vec(int hd, const void* a, const void* b, const void* c) {
  return hd % 8 == 0 && of::aligned16(a, b, c);
}

cudaError_t launch_rows_fwd(const bf16* qkv, bf16* out, int b, int s, int n_heads, int hd,
                            cudaStream_t st) {
  // fixed: q rows and sums; a staged key: k, v and a p of each warp
  const RowsShape shape = rows_shape(b, s, n_heads, hd, 2 * kWarps * hd, 2 * (hd + 1) + kWarps);
  if (shape.chunk == 0) return cudaErrorInvalidValue;
  const cudaError_t err = of::set_attribute_once(
      reinterpret_cast<const void*>(attention_rows_kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, of::kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  attention_rows_kernel<<<shape.row_blocks * b * n_heads, kThreads, shape.smem, st>>>(
      qkv, out, s, n_heads, hd, shape.chunk, shape.row_blocks, rows_vec(hd, qkv, out, qkv));
  return cudaGetLastError();
}

cudaError_t launch_rows_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv, float* stats, int b,
                            int s, int n_heads, int hd, cudaStream_t st) {
  const RowsShape dq = rows_shape(b, s, n_heads, hd, 3 * kWarps * hd, 2 * (hd + 1) + kWarps);
  const RowsShape dkv =
      rows_shape(b, s, n_heads, hd, 4 * kWarps * hd, 2 * (hd + 1) + 2 * kWarps + 3);
  if (dq.chunk == 0 || dkv.chunk == 0) return cudaErrorInvalidValue;
  cudaError_t err = of::set_attribute_once(reinterpret_cast<const void*>(attention_rows_dq_kernel),
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           of::kMaxSmemBytes);
  if (err == cudaSuccess)
    err = of::set_attribute_once(reinterpret_cast<const void*>(attention_rows_dkv_kernel),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, of::kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  const bool vec = rows_vec(hd, qkv, dout, dqkv);
  attention_rows_dq_kernel<<<dq.row_blocks * b * n_heads, kThreads, dq.smem, st>>>(
      qkv, dout, dqkv, stats, b, s, n_heads, hd, dq.chunk, dq.row_blocks, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attention_rows_dkv_kernel<<<dkv.row_blocks * b * n_heads, kThreads, dkv.smem, st>>>(
      qkv, dout, stats, dqkv, b, s, n_heads, hd, dkv.chunk, dkv.row_blocks, vec);
  return cudaGetLastError();
}

// Let a kernel take as much dynamic shared memory as a block may have.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel) {
  return of::set_attribute_once(reinterpret_cast<const void*>(kernel),
                                cudaFuncAttributeMaxDynamicSharedMemorySize, of::kMaxSmemBytes);
}

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

template <int kHdp, bool kOne>
cudaError_t launch_bwd(const bf16* qkv, const bf16* dout, bf16* dqkv, float* stats, int b, int s,
                       int n_heads, int hd, cudaStream_t st) {
  const size_t smem_dq = bwd_dq_smem<kHdp, kOne>(s), smem_dkv = bwd_dkv_smem<kHdp>();
  cudaError_t err = allow_smem(causal_attention_bwd_dq_kernel<kHdp, kOne>);
  if (err != cudaSuccess) return err;
  err = allow_smem(causal_attention_bwd_dkv_kernel<kHdp>);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRows - 1) / kRows, n_heads, b);
  const bool vec = hd % 8 == 0 && of::aligned16(qkv, dout, dqkv);
  causal_attention_bwd_dq_kernel<kHdp, kOne><<<grid, kThreads, smem_dq, st>>>(
      qkv, dout, dqkv, stats, s, n_heads, hd, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  causal_attention_bwd_dkv_kernel<kHdp><<<grid, kThreads, smem_dkv, st>>>(
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

// 1 where the tiles path takes the shape, 0 where the rows path does.
int causal_attention_tiles(int b, int s, int n_heads, int head_dim) {
  return valid(b, s, n_heads, head_dim) && tiles_take(b, s, n_heads, head_dim);
}

// qkv: bf16 [b, s, 3 * n_heads * head_dim], contiguous; out: bf16
// [b, s, n_heads * head_dim], contiguous.  Returns cudaGetLastError().
int causal_attention_bf16(const void* qkv, void* out, int b, int s, int n_heads, int head_dim,
                          void* stream) {
  if (!valid(b, s, n_heads, head_dim)) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!tiles_take(b, s, n_heads, head_dim))
    return launch_rows_fwd(static_cast<const bf16*>(qkv), static_cast<bf16*>(out), b, s, n_heads,
                           head_dim, st);
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
    return launch_rows_bwd(static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                           static_cast<bf16*>(dqkv), static_cast<float*>(stats), b, s, n_heads,
                           head_dim, st);
  const Backward f{static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
                   static_cast<bf16*>(dqkv), static_cast<float*>(stats), b, s, n_heads,
                   head_dim, st};
  return dispatch(s, head_dim, f);
}

}  // extern "C"
