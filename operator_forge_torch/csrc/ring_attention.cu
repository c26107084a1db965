// One block step of causal ring attention, forward and backward.
//
// Forward: f32 scores of a rank's query block against the K/V block
// visiting it, the causal mask from the two blocks' ring positions, and the
// online-softmax update of the carry (m, num, den), in place.
//
// Replaces: operator_forge/tpu/demo.py::_ring_attention_body.step, lines
// 276-298 (einsum, scale, mask, block max, shift guard, correction, exp,
// the two sums), which XLA fuses on the TPU, and its transpose, which
// jax.grad derives through the ring's scan.  The ppermute of the K/V block
// (lines 296-297) stays outside: torch.distributed moves the blocks.
//
// Forward numerics follow the reference line for line, in f32:
//   score = (q . k) * scale, scale = 1 / sqrt(f32(d))   a product, as :281
//   masked where origin*s + j > my*s + i, with -inf      :282-284
//   new_m = max(m, block max)                             :285-286
//   shift = isinf(new_m) ? 0 : new_m                      :289, exact
//   correction = exp(m - shift), p = exp(score - shift)   :290-291
//   num = num * correction + sum_j p_j v_j               :292-294
//   den = den * correction + sum_j p_j                    :295
// The two carry updates round the product and then the sum, as the
// reference's separate multiply and add do (no contraction into an FMA);
// the dot products are f32 FMAs (no TF32, which keeps ~3 digits).  A
// masked key adds exp(-inf) = 0 to both sums, so only the keys a row sees
// are visited.  A block from a later ring position (origin > my) masks
// every key of every query: the reference then leaves the carry as it was
// (correction exp(0) == 1 and p == 0 where m is finite; m == -inf only
// before any block was seen, when num and den are still 0), so every
// block returns at once and the carry keeps its bits.  It is still one
// launch.
//
// Backward, from the forward's final m and den and each row's
// D = sum(dout * out) (out = num / den in f32), for the keys a query sees:
//   p  = exp(score - m) / den                 the block's probabilities
//   dS = p * (dout . v - D) * scale           the transpose of "* scale"
//   dq += sum_j dS_ij k_j,  dk_j += sum_i dS_ij q_i,  dv_j += sum_i p_ij dout_i
// into f32 accumulators, in place, with the same roundings in both
// kernels: the score's product by scale, the shift, expf, the division
// (IEEE's in the row kernel; in the tiled kernel the quotient from a
// refined reciprocal corrected by its residual, IEEE's or one f32 ulp
// from it, without the slow path's branch) and dS's three steps, each
// rounded.  The row kernel scores a pair with the forward's FMA order (four
// chains over d); the tiled kernel with one FMA chain over d in ascending
// order, for both roles.  No TF32: it keeps about 3 digits, and the sums
// are held to 2e-5.  A later block adds nothing: its blocks return at once
// and the accumulators keep their bits.
//
// Bound on an H100 SXM at the ring of DemoConfig()'s heads, seq 64 over 4
// ranks ([8, 4, 16, 32] f32 per rank, an earlier block): the forward reads
// q, k, v (196,608 B) and the carry (69,632 B) once and writes the carry
// once (69,632 B), 0.34 MB: 0.10 us at 3.35 TB/s, against 1.0 MFLOP of the
// two products at the f32 rate outside the tensor cores, 0.016 us.  The
// backward reads q, k, v and dout (262,144 B) and m, den and D (6,144 B),
// and reads and writes dq, dk and dv (393,216 B): 661,504 B, 0.197 us,
// against some 2.6 MFLOP of five products, 0.04 us.  Both are bound by
// bytes, and in practice by one launch.  The ring's gradient also runs the
// backward at blocks of 64 to 4096 keys (chip_smoke.py's rows), where the
// five products of 2 d FLOP a pair the mask leaves (s^2 earlier, s (s + 1)
// / 2 on the diagonal) bound it by the f32 rate, 67 TFLOP/s: 0.00125 ms at
// [1, 4, 256, 32] earlier, 0.0200 ms at [1, 4, 1024, 32] earlier, 0.160 ms
// at [1, 4, 4096, 32] on the diagonal.  The forward at those blocks is
// bound the same way by its two products and the softmax, 4 d + 4
// operations a pair: 0.0661 ms at [1, 4, 4096, 32] on the diagonal,
// 0.132 ms earlier.  At Gemma 7B's heads of 256 the same counts bound the
// forward at 0.0644 ms and the backward at 0.160 ms at [1, 4, 1024, 256]
// earlier, and at 0.515 and 1.28 ms at [1, 4, 4096, 256] on the diagonal.
//
// Forward design: four kernels, one launch a call, chosen by shape
// (fwd_plan).  Blocks under kFwdTileMinSeq keys with heads of up to
// kShortHeadDim and at most 65535 batches and heads take ring_step_kernel,
// one warp per query row on a (row group, head, batch) grid, so the chain
// of dependent work a row needs runs in parallel over every row of the
// step: at the shape above 512 warps in 128 blocks of 4.  A block stages
// the keys and values its rows see into shared memory as f32 rows padded
// to d + 1, with 16-byte loads where d allows (bf16 is widened there):
// both at once when they fit in one chunk of 128 keys, else the keys chunk
// by chunk and then the values.  Lane j scores keys j, j + 32, ... of each
// chunk against the row's q, broadcast from shared memory, with four
// independent FMA chains over d; the warp's scores stay in its own row of
// shared memory, so the block max is taken, by warp shuffles, before any
// exp, as the reference takes it.  p replaces the score in place; lane c
// then owns output columns c, c + 32, ... and sums p_j v_j over the row's
// keys in two chains (even and odd keys), p read by every lane from the
// warp's row.
// Blocks of kFwdTileMinSeq keys and more, and blocks of kTileMinSeq keys
// and more with over 65535 batches or heads, take ring_step_tiled_kernel
// where heads are up to kTileHeadDim wide: a tile of 32 or 64 query rows a
// block, on a flat grid, heaviest tiles first, shares each staged chunk of
// 64 keys (and values) among its rows, and each 16-byte shared load among
// four FMAs, a thread holding 4 x 4 scores in registers, one ascending FMA
// chain over d each.  It keeps no score row: it walks the chunks the
// causal mask leaves twice, first for each row's max (over its 16 threads
// by shuffles, and over a cluster's blocks through distributed shared
// memory), then scoring again with the same code, so the same bits, for p,
// the row sums and p v, which add into 4 rows x kNc columns of registers a
// thread, in ascending key order.  Chunks arrive by cp.async into two
// buffers, the next in flight while this one is used.  Tile height and
// clusters go by grid size (fwd_plan).
// Heads over kTileHeadDim take ring_step_wide_kernel from kTileMinSeq keys
// (and under it past heads of kWideResident): the tiled kernel's two walks
// with the head in column chunks, so that any width runs without a cap.
// A 64-row tile scores each 64-key chunk kWideC columns at a time, the
// thread's 16 FMA chains running on across the column chunks in ascending
// order (so both walks give the same bits); q stays staged for heads up to
// kWideResident (66.5 KB at 256) and streams beside each key chunk past
// them.  Every chunk, of keys, q or values, arrives by cp.async into one of
// two slots of a pipeline, the next in flight while this one is used.
// Walk two writes p to shared memory and adds p times the values' chunks of
// kWideC columns into 4 rows x 4 columns a chunk of each thread's
// registers: 256 output columns a walk, so a head of 256 is scored twice
// and a wider head once more for each further 256 columns.  Two blocks of
// a cluster split the key walk of a short grid as the tiled kernel's do.
// What none of these takes, blocks under kTileMinSeq keys with more than
// 65535 batches or heads or with heads of kTileHeadDim to kWideResident,
// goes to ring_step_long_kernel, a warp a row on a flat grid, which also
// scores the keys twice, chunk by chunk, and takes the output columns 128
// at a time.
//
// Backward design: each output has one writer, so no sum needs an atomic.
// Query rows sum dq over the keys they see; key rows sum dk and dv over the
// queries that see them.  Blocks of at least kTileMinSeq keys with heads of
// up to kTileHeadDim take the tiled kernel, two roles in one launch, which
// shares each staged chunk of the other side among a tile of 32 or 64 rows
// and each shared load among several FMAs: a thread holds 4 x 4 pairs'
// scores and dout . v in registers, 16-byte loads feeding 16 FMAs of each,
// forms p and dS there, passes them through shared memory, and adds them
// times the other side's rows into its 4 rows' sums of its columns, which
// stay in registers over every chunk.  Chunks of 64 rows arrive by
// cp.async into two buffers, the next in flight while this one is used;
// only the chunks the causal mask leaves are staged.  The tile's height
// goes by grid size (bwd_plan): 64 rows where their grid gives every SM two
// blocks, else 32; 64-row tiles of a diagonal block go in pairs (t with
// tiles - 1 - t), so that every block does the same work.  Where long
// tiles still leave the card short of blocks, the two blocks of a cluster
// share each tile's chunks, and the second's sums reach the first through
// distributed shared memory, which adds them after its own.  Its launch
// bounds ask for as many blocks an SM as shared memory holds.
// Heads over kTileHeadDim take ring_step_bwd_wide_kernel from kTileMinSeq
// rows (and under it past heads of kWideResident): 64-row tiles in three
// roles, dq, dk and dv, so that a thread's sums stay at 64 registers for
// 256 output columns a pass, a wider head taking one more pass, on the
// grid, for each further 256.  Per chunk of the other side, the tile's and
// the other side's rows arrive kWideC columns at a time through the
// forward's pipeline and add into the 4 x 4 scores (and, for dq and dk,
// dout . v) of each thread; dS (or, for dv, p) goes to shared memory, and
// each of the pass's kWideC-column chunks of k, q or dout then adds into
// the thread's 4 x 4 sums of it.  dv never scores dout . v.  Diagonal
// tiles go in pairs; elsewhere two blocks of a cluster split each tile's
// chunks from kSplitChunks chunks (wide_bwd_plan).
// Shorter blocks take the row kernel, up to heads of kWideResident: a warp
// a row (the first half of the grid query rows, the second key rows), a
// block of kWarps rows staging the other side chunk by chunk; lane j
// computes the score, p, dout . v and dS of the pairs j, j + 32, ... of the
// chunk into the warp's buffers, and then lane c adds p and dS times the
// staged rows into the row's f32 sums of columns c, c + 32, ..., which sit
// in shared memory.  Each sum of every kernel runs over the other side in
// ascending order from 0 and is added to its accumulator once at the end.
//
// Every sum of every kernel runs in a fixed order with no atomics, so a
// launch repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kChunk = 128;         // most keys or values staged at a time
constexpr int kWarps = 4;           // rows per block
constexpr int kMaxSeq = 1024;       // the longest block whose score rows stay in shared memory
constexpr int kShortHeadDim = 128;  // the widest head of the forward's first kernel
constexpr int kCols = kShortHeadDim / 32;  // output columns a lane owns at a time
constexpr int kSmemFloats = of::kMaxSmemBytes / sizeof(float);

// Stage rows [r0, r0 + n) of one head's [s, hd] plane into dst [n][ld].
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int n,
                                      int hd, int ld, bool vec) {
  of::stage_rows(dst, src, hd, r0, n, hd, ld, vec);
}

using of::div_by;
using of::dot;
using of::recip;
using of::widen;

// the keys staged at a time, for a block whose fixed shared memory takes
// `fixed` floats and each staged key `per_key` floats: at most kChunk and
// at most s, and a multiple of 32 where fewer than both fit but at least
// 32 do; 0 where none fits
int chunk_for(int s, int fixed, int per_key) {
  const int most = min(kChunk, s);
  int chunk = min(most, (kSmemFloats - fixed) / per_key);
  if (chunk < most && chunk >= 32) chunk -= chunk % 32;
  return max(chunk, 0);
}

// ---- forward ------------------------------------------------------------

// Blocks of up to kMaxSeq keys, heads of up to kShortHeadDim and up to
// 65535 batches and heads, on a (row group, head, batch) grid: the warp's
// scores stay in its row of shared memory.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ring_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ m,
                 float* __restrict__ num, float* __restrict__ den, int s,
                 int hd, int q_block, int k_block, bool vec) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = hd + 1;
  const int q0 = blockIdx.x * kWarps;
  const int rows = min(kWarps, s - q0);
  // query i sits at q_block*s + i and key j at k_block*s + j, so key j is
  // seen by row i when j <= lag + i
  const long long lag = (long long)(q_block - k_block) * s;
  const int n_keys = (int)max(0LL, min((long long)s, lag + q0 + rows));
  if (n_keys == 0) return;  // a later block: the carry stays as it is

  const int chunk = min(kChunk, n_keys);
  const bool together = n_keys <= kChunk;  // keys and values staged at once
  float* ks = smem;                        // [chunk][ld]  staged keys
  float* vs = ks + chunk * ld;             // [chunk][ld]  staged values
  float* qs = vs + chunk * ld;             // [kWarps][hd] the rows' q
  float* sc = qs + kWarps * hd;            // [kWarps][s]  scores, then p

  const size_t plane = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = plane * s * hd;
  const int row = q0 + warp;
  const bool live = warp < rows;
  // the keys this row sees: [0, seen)
  const int seen = live ? (int)max(0LL, min((long long)s, lag + row + 1)) : 0;
  float* qr = qs + warp * hd;
  float* pr = sc + warp * s;
  if (live)
    for (int c = lane; c < hd; c += 32) qr[c] = widen(q[base + (size_t)row * hd + c]);
  const float scale = 1.0f / sqrtf((float)hd);

  // scores of the keys this row sees, and their max
  float block_max = -INFINITY;
  for (int k0 = 0; k0 < n_keys; k0 += kChunk) {
    const int kn = min(kChunk, n_keys - k0);
    if (k0 > 0) __syncthreads();
    stage(ks, k + base, k0, kn, hd, ld, vec);
    if (together) stage(vs, v + base, k0, kn, hd, ld, vec);
    __syncthreads();
    for (int j = k0 + lane; j < min(k0 + kn, seen); j += 32) {
      const float* kr = ks + (j - k0) * ld;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      int c = 0;
      for (; c + 4 <= hd; c += 4) {
        a0 = fmaf(qr[c], kr[c], a0);
        a1 = fmaf(qr[c + 1], kr[c + 1], a1);
        a2 = fmaf(qr[c + 2], kr[c + 2], a2);
        a3 = fmaf(qr[c + 3], kr[c + 3], a3);
      }
      for (; c < hd; ++c) a0 = fmaf(qr[c], kr[c], a0);
      const float score = __fmul_rn((a0 + a1) + (a2 + a3), scale);
      pr[j] = score;
      block_max = fmaxf(block_max, score);
    }
  }
  block_max = of::warp_max(block_max);

  // the new running max, the guarded shift, the correction, p in place of
  // the score, and den
  const size_t at = plane * s + row;
  float correction = 1.0f;
  if (live) {
    const float m_old = m[at];
    const float new_m = fmaxf(m_old, block_max);
    const float shift = isinf(new_m) ? 0.0f : new_m;
    correction = expf(m_old - shift);
    float total = 0.0f;
    for (int j = lane; j < seen; j += 32) {
      const float p = expf(pr[j] - shift);
      pr[j] = p;
      total += p;
    }
    total = of::warp_sum(total);
    if (lane == 0) {
      m[at] = new_m;
      den[at] = __fadd_rn(__fmul_rn(den[at], correction), total);
    }
  }
  __syncwarp();

  // p @ v for output columns lane, lane + 32, ...: even and odd keys apart
  float even[kCols], odd[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) even[e] = odd[e] = 0.0f;
  for (int k0 = 0; k0 < n_keys; k0 += kChunk) {
    const int kn = min(kChunk, n_keys - k0);
    if (!together) {
      __syncthreads();
      stage(vs, v + base, k0, kn, hd, ld, vec);
      __syncthreads();
    }
    const int end = min(k0 + kn, seen);
    int j = k0;
    for (; j + 2 <= end; j += 2) {
      const float p0 = pr[j], p1 = pr[j + 1];
      const float* v0 = vs + (j - k0) * ld;
      const float* v1 = v0 + ld;
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const int c = lane + 32 * e;
        if (c < hd) {
          even[e] = fmaf(p0, v0[c], even[e]);
          odd[e] = fmaf(p1, v1[c], odd[e]);
        }
      }
    }
    if (j < end) {
      const float p0 = pr[j];
      const float* v0 = vs + (j - k0) * ld;
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const int c = lane + 32 * e;
        if (c < hd) even[e] = fmaf(p0, v0[c], even[e]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int e = 0; e < kCols; ++e) {
    const int c = lane + 32 * e;
    if (c < hd) {
      float* out = num + at * hd + c;
      *out = __fadd_rn(__fmul_rn(*out, correction), even[e] + odd[e]);
    }
  }
}

// Any block, head and batch on one flat grid: the keys
// are scored twice, chunk by chunk, once for the block max and once for
// exp, the sums and p v, with the same FMA order and so the same bits as
// the kernel above; p is kept for one chunk at a time, and a head wider
// than 32 * kCols takes its output columns that many at a time.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ring_step_long_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ m,
                      float* __restrict__ num, float* __restrict__ den, int s, int hd,
                      int q_block, int k_block, bool vec, int chunk, int row_blocks) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = hd + 1;
  const size_t plane = blockIdx.x / row_blocks;
  const int q0 = (blockIdx.x % row_blocks) * kWarps;
  const int rows = min(kWarps, s - q0);
  const long long lag = ((long long)q_block - k_block) * s;
  const int n_keys = (int)max(0LL, min((long long)s, lag + q0 + rows));
  if (n_keys == 0) return;  // a later block: the carry stays as it is

  float* ks = smem;                // [chunk][ld]  staged keys
  float* vs = ks + chunk * ld;     // [chunk][ld]  staged values
  float* qs = vs + chunk * ld;     // [kWarps][hd] the rows' q
  float* ps = qs + kWarps * hd;    // [kWarps][chunk] p of the chunk's keys
  const size_t base = plane * s * hd;
  const int row = q0 + warp;
  const bool live = warp < rows;
  const int seen = live ? (int)max(0LL, min((long long)s, lag + row + 1)) : 0;
  float* qr = qs + warp * hd;
  float* pr = ps + warp * chunk;
  if (live)
    for (int c = lane; c < hd; c += 32) qr[c] = widen(q[base + (size_t)row * hd + c]);
  const float scale = 1.0f / sqrtf((float)hd);

  float block_max = -INFINITY;
  for (int k0 = 0; k0 < n_keys; k0 += chunk) {
    const int kn = min(chunk, n_keys - k0);
    if (k0 > 0) __syncthreads();
    stage(ks, k + base, k0, kn, hd, ld, vec);
    __syncthreads();
    for (int j = k0 + lane; j < min(k0 + kn, seen); j += 32)
      block_max = fmaxf(block_max, __fmul_rn(dot(qr, ks + (j - k0) * ld, hd), scale));
  }
  block_max = of::warp_max(block_max);

  const size_t at = plane * s + row;
  const float m_old = live ? m[at] : 0.0f;
  const float new_m = fmaxf(m_old, block_max);
  const float shift = isinf(new_m) ? 0.0f : new_m;
  const float correction = expf(m_old - shift);
  float total = 0.0f;
  for (int g0 = 0; g0 < hd; g0 += 32 * kCols) {
    float even[kCols], odd[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) even[e] = odd[e] = 0.0f;
    for (int k0 = 0; k0 < n_keys; k0 += chunk) {
      const int kn = min(chunk, n_keys - k0);
      const int end = min(k0 + kn, seen);
      __syncthreads();
      stage(ks, k + base, k0, kn, hd, ld, vec);
      stage(vs, v + base, k0, kn, hd, ld, vec);
      __syncthreads();
      for (int j = k0 + lane; j < end; j += 32) {
        const float p = expf(__fmul_rn(dot(qr, ks + (j - k0) * ld, hd), scale) - shift);
        pr[j - k0] = p;
        if (g0 == 0) total += p;
      }
      __syncwarp();
      int j = k0;
      for (; j + 2 <= end; j += 2) {
        const float p0 = pr[j - k0], p1 = pr[j - k0 + 1];
        const float* v0 = vs + (j - k0) * ld;
        const float* v1 = v0 + ld;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const int c = g0 + lane + 32 * e;
          if (c < hd) {
            even[e] = fmaf(p0, v0[c], even[e]);
            odd[e] = fmaf(p1, v1[c], odd[e]);
          }
        }
      }
      if (j < end) {
        const float p0 = pr[j - k0];
        const float* v0 = vs + (j - k0) * ld;
#pragma unroll
        for (int e = 0; e < kCols; ++e) {
          const int c = g0 + lane + 32 * e;
          if (c < hd) even[e] = fmaf(p0, v0[c], even[e]);
        }
      }
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const int c = g0 + lane + 32 * e;
        if (c < hd) {
          float* out = num + at * hd + c;
          *out = __fadd_rn(__fmul_rn(*out, correction), even[e] + odd[e]);
        }
      }
    }
  }
  total = of::warp_sum(total);
  if (live && lane == 0) {
    m[at] = new_m;
    den[at] = __fadd_rn(__fmul_rn(den[at], correction), total);
  }
}

// ---- backward -----------------------------------------------------------

// The first row_blocks * planes blocks take query rows (dq), the rest key
// rows (dk, dv); "other" is the side a row sums over.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ring_step_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ den,
                     const float* __restrict__ big_d, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int s, int hd,
                     int q_block, int k_block, bool vec, int chunk, int row_blocks,
                     unsigned int planes) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ld = hd + 1;
  const size_t half = (size_t)row_blocks * planes;
  const bool keys = blockIdx.x >= half;  // this block's rows are keys
  const size_t id = keys ? blockIdx.x - half : blockIdx.x;
  const size_t plane = id / row_blocks;
  const int r0 = (int)(id % row_blocks) * kWarps;
  const int rows = min(kWarps, s - r0);
  // query i sees key j when j <= lag + i
  const long long lag = ((long long)q_block - k_block) * s;
  // the others the block's rows pair with: [o_begin, o_end)
  const int o_begin = keys ? (int)min((long long)s, max(0LL, r0 - lag)) : 0;
  const int o_end = keys ? s : (int)max(0LL, min((long long)s, lag + r0 + rows));
  if (o_begin >= o_end) return;  // a later block: the accumulators stay as they are

  float* as = smem;                // [chunk][ld] keys (query rows) or queries (key rows)
  float* bs = as + chunk * ld;     // [chunk][ld] values, or dout
  float* own = bs + chunk * ld;    // [kWarps][2][hd] the rows' q and dout, or k and v
  float* acc = own + 2 * kWarps * hd;    // [kWarps][2][hd] dq, or dk and dv
  float* buf = acc + 2 * kWarps * hd;    // [kWarps][2][chunk] p and dS
  float* st = buf + 2 * kWarps * chunk;  // [3][chunk] the staged queries' m, den, D

  const size_t base = plane * s * hd;
  const int row = r0 + warp;
  const bool live = warp < rows;
  float* x = own + 2 * warp * hd;  // q, or k
  float* y = x + hd;               // dout, or v
  float* sum0 = acc + 2 * warp * hd;
  float* sum1 = sum0 + hd;
  float* pb = buf + 2 * warp * chunk;
  float* db = pb + chunk;
  if (live) {
    const T* xs = keys ? k : q;
    const T* ys = keys ? v : dout;
    for (int c = lane; c < hd; c += 32) {
      x[c] = widen(xs[base + (size_t)row * hd + c]);
      y[c] = widen(ys[base + (size_t)row * hd + c]);
      sum0[c] = sum1[c] = 0.0f;
    }
  }
  // the row's own range of others
  int lo = 0, hi = 0;
  if (live) {
    lo = keys ? (int)min((long long)s, max(0LL, row - lag)) : 0;
    hi = keys ? s : (int)max(0LL, min((long long)s, lag + row + 1));
  }
  const size_t at = plane * s + row;
  const float m_row = live && !keys ? m[at] : 0.0f;
  const float den_row = live && !keys ? den[at] : 1.0f;
  const float d_row = live && !keys ? big_d[at] : 0.0f;
  const float scale = 1.0f / sqrtf((float)hd);
  const T* a_src = keys ? q : k;
  const T* b_src = keys ? dout : v;

  for (int c0 = o_begin; c0 < o_end; c0 += chunk) {
    const int n = min(chunk, o_end - c0);
    __syncthreads();  // the rows are loaded; every warp is done with the last chunk
    stage(as, a_src + base, c0, n, hd, ld, vec);
    stage(bs, b_src + base, c0, n, hd, ld, vec);
    if (keys)
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        st[i] = m[plane * s + c0 + i];
        st[chunk + i] = den[plane * s + c0 + i];
        st[2 * chunk + i] = big_d[plane * s + c0 + i];
      }
    __syncthreads();
    const int from = max(c0, lo), to = min(c0 + n, hi);
    if (from >= to) continue;
    // p and dS of the row's pairs in this chunk
    for (int o = from + lane; o < to; o += 32) {
      const float* ar = as + (o - c0) * ld;
      const float* br = bs + (o - c0) * ld;
      const float raw = keys ? dot(ar, x, hd) : dot(x, ar, hd);
      const float dp = keys ? dot(br, y, hd) : dot(y, br, hd);
      const float mi = keys ? st[o - c0] : m_row;
      const float deni = keys ? st[chunk + o - c0] : den_row;
      const float di = keys ? st[2 * chunk + o - c0] : d_row;
      const float p = __fdiv_rn(expf(__fmul_rn(raw, scale) - mi), deni);
      pb[o - c0] = p;
      db[o - c0] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, di)), scale);
    }
    __syncwarp();
    // dq += dS k, or dk += dS^T q and dv += p^T dout, in ascending order
    for (int c = lane; c < hd; c += 32) {
      float a0 = sum0[c], a1 = sum1[c];
      for (int o = from; o < to; ++o) {
        a0 = fmaf(db[o - c0], as[(o - c0) * ld + c], a0);
        if (keys) a1 = fmaf(pb[o - c0], bs[(o - c0) * ld + c], a1);
      }
      sum0[c] = a0;
      sum1[c] = a1;
    }
    __syncwarp();
  }
  if (!live) return;
  for (int c = lane; c < hd; c += 32) {
    const size_t e = at * hd + c;
    if (keys) {
      dk[e] = __fadd_rn(dk[e], sum0[c]);
      dv[e] = __fadd_rn(dv[e], sum1[c]);
    } else {
      dq[e] = __fadd_rn(dq[e], sum0[c]);
    }
  }
}

// ---- register tiles ----------------------------------------------------

constexpr int kTileOthers = 64;     // others (keys, or queries) staged a chunk
constexpr int kTileHeadDim = 128;   // the widest head of the tiled kernel

// acc + x . y, one FMA chain in ascending order
__device__ __forceinline__ float dot4(float4 x, float4 y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

// kNc (2, 4 or 8) consecutive floats of shared memory, 8- or 16-byte aligned
template <int kNc>
__device__ __forceinline__ void load_cols(float (&out)[kNc], const float* p) {
  if constexpr (kNc % 4 == 0) {
#pragma unroll
    for (int e = 0; e < kNc; e += 4) {
      const float4 w = *reinterpret_cast<const float4*>(p + e);
      out[e] = w.x, out[e + 1] = w.y, out[e + 2] = w.z, out[e + 3] = w.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < kNc; e += 2) {
      const float2 w = *reinterpret_cast<const float2*>(p + e);
      out[e] = w.x, out[e + 1] = w.y;
    }
  }
}

// Stage rows [r0, r0 + n) of one head's [s, hd] plane into dst [kRows][ld]
// as f32: 16-byte cp.async copies for f32 rows where vec, else loads that
// widen; rows n .. kRows - 1 become zeros.  Columns hd .. ld stay as they
// are (zeros, set once).  The caller commits and waits.
template <typename T, int kRows>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src, int r0, int n,
                                           int hd, int ld, bool vec) {
  bool copied = false;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      const int per_row = hd / 4;
      for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
        const int j = i / per_row, c = (i - j * per_row) * 4;
        of::cp_async16(dst + j * ld + c, src + (size_t)(r0 + j) * hd + c);
      }
      copied = true;
    }
  }
  if (!copied) of::stage_rows(dst, src, hd, r0, n, hd, ld, vec);
  for (int i = threadIdx.x; i < (kRows - n) * hd; i += blockDim.x) {
    const int j = n + i / hd;
    dst[j * ld + i % hd] = 0.0f;
  }
}

// A tiled kernel's shared memory, in bytes: `own` planes of the tile's
// rows, `stages` buffers of the other side's two planes, and `bufs`
// buffers [kTileOthers][rows + 4] of p or dS; the backward's by default
__host__ __device__ constexpr size_t tiled_smem(int kTy, int kNc, int stages, int own = 2,
                                                int bufs = 2) {
  return sizeof(float) * ((size_t)own * 4 * kTy * (16 * kNc + 4) +
                          (size_t)stages * 2 * kTileOthers * (16 * kNc + 4) +
                          (size_t)bufs * kTileOthers * (4 * kTy + 4));
}

// The blocks of a tiled kernel an SM's shared memory holds (233,472 bytes,
// 1 KB of it kept a block), from its shared memory with two buffers and
// with one: its launch bounds ask for them, so that registers never cut
// the warps an SM keeps in flight first
__host__ __device__ constexpr int resident(size_t two, size_t one) {
  return (int)(233472 / ((two <= (size_t)of::kMaxSmemBytes ? two : one) + 1024));
}

// Columns hd .. 16 kNc of `rows` staged rows from `dst`, kLd floats apart,
// set to zeros: the FMA chains and the 16-byte loads run past hd
template <int kNc>
__device__ __forceinline__ void zero_pad(float* dst, int rows, int hd, int ld) {
  constexpr int kW = 16 * kNc;
  if (hd < kW)
    for (int i = threadIdx.x; i < rows * (kW - hd); i += blockDim.x)
      dst[(i / (kW - hd)) * ld + hd + i % (kW - hd)] = 0.0f;
}

// sc[a][b] += x row ty + kTy a . y row tx + 16 b over columns c .. c + 3,
// rows kLd floats apart: a step of each of the 16 pairs' FMA chains, in
// ascending order, fed by 16-byte shared loads
template <int kTy, int kLd>
__device__ __forceinline__ void score_step(float (&sc)[4][4], const float* x, const float* y,
                                           int ty, int tx, int c) {
  float4 xs[4], ys[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) xs[a] = *reinterpret_cast<const float4*>(x + (ty + kTy * a) * kLd + c);
#pragma unroll
  for (int b = 0; b < 4; ++b) ys[b] = *reinterpret_cast<const float4*>(y + (tx + 16 * b) * kLd + c);
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) sc[a][b] = dot4(xs[a], ys[b], sc[a][b]);
}

// Part p's run [x, y) of the others [begin, end) cut into `parts` runs
// of whole chunks of kTileOthers, in rank order
__device__ __forceinline__ int2 part_range(int begin, int end, int part, int parts) {
  const long long per =
      (long long)((end - begin + kTileOthers - 1) / kTileOthers + parts - 1) / parts * kTileOthers;
  return make_int2((int)min((long long)end, begin + part * per),
                   (int)min((long long)end, begin + (part + 1) * per));
}

// ---- forward, tiled -----------------------------------------------------

// The tiled forward's shared memory with `stages` buffers of keys and
// values, in bytes: q of the tile's rows, the staged chunks, p, and one
// more row of p's width for the part's row max
__host__ __device__ constexpr size_t fwd_smem(int kTy, int kNc, int stages) {
  return tiled_smem(kTy, kNc, stages, 1, 1) + sizeof(float) * (4 * kTy + 4);
}

// One tile of the tiled forward step: kRows = 4 * kTy query rows from r0
// against the keys they see, in chunks of kTileOthers staged through
// `stages` (1 or 2) cp.async buffers, walked twice.  Thread (ty, tx)
// scores its rows ty + kTy a against the chunk's keys tx + 16 b (a, b < 4)
// in registers (score_step).  Pass one keeps each row's running max; its
// max over the 16 tx (and the parts) gives the shift and the correction
// before any exp, as the reference takes the block max.  Pass two scores
// again with the same code, so with the same bits, forms p, adds it into
// the row's sum, writes it to shared memory, and adds p times the staged
// values into the thread's 4 x kNc sums, columns tx kNc .., in registers,
// in ascending key order.  Returns at once for a later block.  With more
// than one of `parts` (the blocks of a cluster), part p takes the p-th run
// of whole chunks: the parts' row maxima meet through distributed shared
// memory before pass two, and part 0 adds the others' sums to its own in
// rank order before it writes.
template <typename T, int kTy, int kNc>
__device__ __forceinline__ void fwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, float* __restrict__ m,
                                         float* __restrict__ num, float* __restrict__ den,
                                         float* smem, int s, int hd, long long lag, bool vec,
                                         int stages, size_t plane, int r0, int part, int parts) {
  constexpr int kRows = 4 * kTy;   // query rows of a tile
  constexpr int kN = kTileOthers;  // keys of a chunk
  constexpr int kLd = 16 * kNc + 4;
  constexpr int kLdB = kRows + 4;  // row stride of the p buffer
  const int tid = threadIdx.x, lane = tid & 31;
  // a warp holds 2 ty by the 16 tx: a row's max and sum are shuffles
  // within half a warp
  const int ty = (tid >> 5) * 2 + (lane >> 4), tx = lane & 15;
  const int rows = min(kRows, s - r0);
  // query i sees key j when j <= lag + i: the keys the tile sees
  const int n_keys = (int)max(0LL, min((long long)s, lag + r0 + rows));
  if (n_keys == 0) return;  // a later block: the carry stays as it is
  const int2 range = part_range(0, n_keys, part, parts);
  const int lo = range.x, hi = range.y;

  float* own_q = smem;                        // [kRows][kLd] q
  float* kv = own_q + kRows * kLd;            // [stages][2][kN][kLd] keys and values
  float* p_buf = kv + stages * 2 * kN * kLd;  // [kN][kLdB] p, own rows in slot order
  float* row_max = p_buf + kN * kLdB;         // [kRows] the part's row max

  const float scale = 1.0f / sqrtf((float)hd);
  const size_t stat = plane * s, base = stat * hd;
  const int hd4 = (hd + 3) & ~3;
  // step i < n_chunks scores chunk i; step n_chunks + i scores it again
  // beside its values
  const int n_chunks = (hi - lo + kN - 1) / kN;
  const int steps = 2 * n_chunks;
  const auto stage_step = [&](int step, float* dst) {
    const int o0 = lo + (step < n_chunks ? step : step - n_chunks) * kN;
    stage_tile<T, kN>(dst, k + base, o0, min(kN, hi - o0), hd, kLd, vec);
    if (step >= n_chunks) stage_tile<T, kN>(dst + kN * kLd, v + base, o0, min(kN, hi - o0), hd, kLd, vec);
  };

  float rmax[4], total[4], new_m[4], shift[4], corr[4], acc[4][kNc];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    rmax[a] = -INFINITY;
    total[a] = 0.0f;
#pragma unroll
    for (int e = 0; e < kNc; ++e) acc[a][e] = 0.0f;
  }
  if (lo < hi) {
    zero_pad<kNc>(own_q, kRows + 2 * stages * kN, hd, kLd);
    stage_tile<T, kRows>(own_q, q + base, r0, rows, hd, kLd, vec);
    stage_step(0, kv);
    of::cp_async_commit();
  }

  const auto run_step = [&](int step) {
    const bool second = step >= n_chunks;
    const int o0 = lo + (second ? step - n_chunks : step) * kN;
    const int n = min(kN, hi - o0);
    // with two buffers the next step's copies fly during this one
    if (stages == 2 && step + 1 < steps) stage_step(step + 1, kv + ((step + 1) & 1) * 2 * kN * kLd);
    of::cp_async_commit();
    if (stages == 2)
      of::cp_async_wait<1>();  // all but the next step's copies
    else
      of::cp_async_wait<0>();
    __syncthreads();
    const float* ks = kv + (step & (stages - 1)) * 2 * kN * kLd;
    const float* vs = ks + kN * kLd;

    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < hd4; c += 4) score_step<kTy, kLd>(sc, own_q, ks, ty, tx, c);

    // pass one: the running max of the scores the mask leaves; pass two:
    // their p, zeros elsewhere, into the row sums and the buffer, where
    // key o's row holds own row ty + kTy a at slot 4 ty + a
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int o = o0 + tx + 16 * b;
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int r = r0 + ty + kTy * a;
        const bool live = r < s && o < hi && o <= lag + r;
        const float score = __fmul_rn(sc[a][b], scale);
        if (!second) {
          if (live) rmax[a] = fmaxf(rmax[a], score);
        } else {
          pv[a] = live ? expf(score - shift[a]) : 0.0f;
          total[a] += pv[a];
        }
      }
      if (second)
        *reinterpret_cast<float4*>(p_buf + (tx + 16 * b) * kLdB + 4 * ty) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
    }
    if (second) {
      __syncthreads();
      // num += p v over the chunk's keys in ascending order
      for (int j = 0; j < n; ++j) {
        const float4 p4 = *reinterpret_cast<const float4*>(p_buf + j * kLdB + 4 * ty);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        float vr[kNc];
        load_cols<kNc>(vr, vs + j * kLd + tx * kNc);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < kNc; ++e) acc[a][e] = fmaf(pv[a], vr[e], acc[a][e]);
      }
    }
    __syncthreads();  // every thread is done with this step's buffers
    if (stages == 1 && step + 1 < steps) stage_step(step + 1, kv);
  };

  int step = 0;
  for (; step < n_chunks; ++step) run_step(step);
  // each row's block max over the 16 tx, then over the parts
#pragma unroll
  for (int a = 0; a < 4; ++a)
    for (int o = 8; o > 0; o >>= 1)
      rmax[a] = fmaxf(rmax[a], __shfl_xor_sync(0xffffffffu, rmax[a], o));
  cg::cluster_group cluster = cg::this_cluster();
  if (parts > 1) {
    if (tx == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a) row_max[ty + kTy * a] = rmax[a];
    cluster.sync();
    for (int from = 0; from < parts; ++from) {
      if (from == part) continue;
      const float* theirs = cluster.map_shared_rank(row_max, from);
#pragma unroll
      for (int a = 0; a < 4; ++a) rmax[a] = fmaxf(rmax[a], theirs[ty + kTy * a]);
    }
  }
  // the new running max, the guarded shift and the correction
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + kTy * a;
    const float m_old = r < s ? m[stat + r] : -INFINITY;
    new_m[a] = fmaxf(m_old, rmax[a]);
    shift[a] = isinf(new_m[a]) ? 0.0f : new_m[a];
    corr[a] = expf(m_old - shift[a]);
  }
  for (; step < steps; ++step) run_step(step);
#pragma unroll
  for (int a = 0; a < 4; ++a)
    for (int o = 8; o > 0; o >>= 1) total[a] += __shfl_xor_sync(0xffffffffu, total[a], o);

  if (parts > 1) {
    // the other parts' sums, thread by thread, in their shared memory (free
    // now, below row_max), which part 0 adds to its own in rank order
    constexpr int kPer = 4 * kNc + 4;
    if (part > 0)
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        smem[tid * kPer + 4 * kNc + a] = total[a];
#pragma unroll
        for (int e = 0; e < kNc; ++e) smem[tid * kPer + a * kNc + e] = acc[a][e];
      }
    cluster.sync();
    if (part == 0)
      for (int from = 1; from < parts; ++from) {
        const float* theirs = cluster.map_shared_rank(smem, from) + tid * kPer;
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          total[a] = __fadd_rn(total[a], theirs[4 * kNc + a]);
#pragma unroll
          for (int e = 0; e < kNc; ++e) acc[a][e] = __fadd_rn(acc[a][e], theirs[a * kNc + e]);
        }
      }
    cluster.sync();  // the parts' shared memory outlives part 0's reads
    if (part > 0) return;
  }

  // the carry, rounding the product and then the sum
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + kTy * a;
    if (r >= s) continue;
    if (tx == 0) {
      m[stat + r] = new_m[a];
      den[stat + r] = __fadd_rn(__fmul_rn(den[stat + r], corr[a]), total[a]);
    }
#pragma unroll
    for (int e = 0; e < kNc; ++e) {
      const int c = tx * kNc + e;
      if (c >= hd) continue;
      const size_t at = (stat + r) * hd + c;
      num[at] = __fadd_rn(__fmul_rn(num[at], corr[a]), acc[a][e]);
    }
  }
}

// The forward step on register tiles, for heads of up to kTileHeadDim, in
// blocks of 16 * kTy threads.  Block b of the grid is part b % parts of
// unit u = b / parts, which takes plane u % planes and tile tiles - 1 - u
// / planes: heaviest first, as on the diagonal a tile's keys grow with its
// index, so that the lightest tiles fill the grid's last blocks.
template <typename T, int kTy, int kNc>
__global__ void __launch_bounds__(kTy * 16, resident(fwd_smem(kTy, kNc, 2), fwd_smem(kTy, kNc, 1)))
ring_step_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, float* __restrict__ m, float* __restrict__ num,
                       float* __restrict__ den, int s, int hd, int q_block, int k_block,
                       bool vec, int tiles, unsigned int planes, int stages, int parts) {
  extern __shared__ __align__(16) float tile_smem[];
  const int part = (int)(blockIdx.x % parts);
  const unsigned int unit = blockIdx.x / parts;
  const int t = tiles - 1 - (int)(unit / planes);
  const long long lag = ((long long)q_block - k_block) * s;
  fwd_tile<T, kTy, kNc>(q, k, v, m, num, den, tile_smem, s, hd, lag, vec, stages, unit % planes,
                        t * 4 * kTy, part, parts);
}

// ---- backward, tiled ----------------------------------------------------

// One tile of the tiled backward step: kRows = 4 * kTy rows from r0, query
// rows (dq) or key rows (dk, dv), against the other side in chunks of
// kTileOthers rows staged through `stages` (1 or 2) cp.async buffers.
// Thread (ty, tx) holds the scores and dout . v of its own rows ty + kTy a
// and the chunk's others tx + 16 b (a, b < 4), 16 pairs, in registers,
// each an FMA chain over d in ascending order fed by 16-byte shared loads;
// writes dS (and, for key rows, p) to shared memory; and then adds dS times
// the other side's rows (or dS^T q and p^T dout) into its 4 x kNc outputs,
// columns tx kNc .., in registers, in ascending order of the other side.
// Returns at once where the mask leaves the tile no pair.  With more than
// one of `parts` (the blocks of a cluster), part p takes the p-th run of
// whole chunks; the parts' sums reach part 0 through distributed shared
// memory, and part 0 adds them to its own in rank order before it writes.
template <typename T, int kTy, int kNc>
__device__ __forceinline__ void bwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                                         const T* __restrict__ v, const T* __restrict__ dout,
                                         const float* __restrict__ m,
                                         const float* __restrict__ den,
                                         const float* __restrict__ big_d, float* __restrict__ dq,
                                         float* __restrict__ dk, float* __restrict__ dv,
                                         float* smem, int s, int hd, long long lag, bool vec,
                                         int stages, bool keys, size_t plane, int r0,
                                         int part, int parts) {
  constexpr int kRows = 4 * kTy;         // own rows of a tile
  constexpr int kN = kTileOthers;        // others of a chunk
  constexpr int kW = 16 * kNc;           // staged columns, zeros past hd
  constexpr int kLd = kW + 4;            // row stride: 8 rows 4 banks apart
  constexpr int kLdB = kRows + 4;        // row stride of the dS and p buffers
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a warp holds 4 consecutive ty by 8 consecutive tx
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  const int rows = min(kRows, s - r0);
  // query i sees key j when j <= lag + i: the others the tile pairs with
  const int o_begin = keys ? (int)min((long long)s, max(0LL, r0 - lag)) : 0;
  const int o_end = keys ? s : (int)max(0LL, min((long long)s, lag + r0 + rows));
  if (o_begin >= o_end) return;  // a later block: the accumulators stay as they are
  // this part's others: [lo, hi)
  const int2 range = part_range(o_begin, o_end, part, parts);
  const int lo = range.x, hi = range.y;

  float* own_x = smem;                    // [kRows][kLd] q, or k
  float* own_y = own_x + kRows * kLd;     // [kRows][kLd] dout, or v
  float* other = own_y + kRows * kLd;     // [stages][2][kN][kLd] k and v, or q and dout
  float* ds_buf = other + stages * 2 * kN * kLd;  // [kN][kLdB] dS, own rows in slot order
  float* p_buf = ds_buf + kN * kLdB;              // [kN][kLdB] p (key rows)

  const float scale = 1.0f / sqrtf((float)hd);
  const size_t stat = plane * s;
  float acc0[4][kNc], acc1[4][kNc];  // dq, or dk and dv
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int e = 0; e < kNc; ++e) acc0[a][e] = acc1[a][e] = 0.0f;
  if (lo < hi) {
    zero_pad<kNc>(own_x, 2 * kRows + 2 * stages * kN, hd, kLd);
    const size_t base = plane * s * hd;
    const T* a_src = keys ? q : k;
    const T* b_src = keys ? dout : v;
    stage_tile<T, kRows>(own_x, (keys ? k : q) + base, r0, rows, hd, kLd, vec);
    stage_tile<T, kRows>(own_y, (keys ? v : dout) + base, r0, rows, hd, kLd, vec);
    stage_tile<T, kN>(other, a_src + base, lo, min(kN, hi - lo), hd, kLd, vec);
    stage_tile<T, kN>(other + kN * kLd, b_src + base, lo, min(kN, hi - lo), hd, kLd, vec);
    of::cp_async_commit();

    // the thread's 4 query rows' m, den (and its reciprocal) and D: its own
    // rows ty + kTy a, loaded here, for query tiles; for key tiles the
    // chunk's others tx + 16 b, loaded with each chunk
    float qm[4], qden[4], qinv[4], qd[4];
    const auto load_stats = [&](int first, int stride, int end) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = first + stride * a;
        const bool live = i < end;
        qm[a] = live ? m[stat + i] : 0.0f;
        qden[a] = live ? den[stat + i] : 1.0f;
        qd[a] = live ? big_d[stat + i] : 0.0f;
        qinv[a] = recip(qden[a]);
      }
    };
    if (!keys) load_stats(r0 + ty, kTy, s);
    const int hd4 = (hd + 3) & ~3;
    const int n_chunks = (hi - lo + kN - 1) / kN;

    for (int chunk = 0; chunk < n_chunks; ++chunk) {
      const int o0 = lo + chunk * kN;
      const int n = min(kN, hi - o0);
      // with two buffers the next chunk's copies fly during this one
      if (stages == 2 && chunk + 1 < n_chunks) {
        float* next = other + ((chunk + 1) & 1) * 2 * kN * kLd;
        const int n_next = min(kN, hi - o0 - kN);
        stage_tile<T, kN>(next, a_src + base, o0 + kN, n_next, hd, kLd, vec);
        stage_tile<T, kN>(next + kN * kLd, b_src + base, o0 + kN, n_next, hd, kLd, vec);
      }
      of::cp_async_commit();
      if (keys) load_stats(o0 + tx, 16, hi);
      if (stages == 2)
        of::cp_async_wait<1>();  // all but the next chunk's copies
      else
        of::cp_async_wait<0>();
      __syncthreads();
      const float* a_rows = other + (chunk & (stages - 1)) * 2 * kN * kLd;
      const float* b_rows = a_rows + kN * kLd;

      // scores (own x . other a) and dout . v (own y . other b) of the
      // thread's 16 pairs
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sc[a][b] = dp[a][b] = 0.0f;
      // a step at a time: unrolled, the loop costs registers (so blocks an
      // SM) and gained no time on the card
#pragma unroll 1
      for (int c = 0; c < hd4; c += 4) {
        score_step<kTy, kLd>(sc, own_x, a_rows, ty, tx, c);
        score_step<kTy, kLd>(dp, own_y, b_rows, ty, tx, c);
      }

      // p and dS of the pairs the mask leaves, zeros elsewhere, into the
      // buffers: other o's row holds own row ty + kTy a at slot 4 ty + a
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int o = o0 + tx + 16 * b;
        float pv[4], dsv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = r0 + ty + kTy * a;
          const long long i = keys ? o : r, j = keys ? r : o;
          const bool live = r < s && o < hi && j <= lag + i;
          // the query's stats (constant indices: the arrays stay in registers)
          const float mi = keys ? qm[b] : qm[a], di = keys ? qd[b] : qd[a];
          const float p = div_by(expf(__fmul_rn(sc[a][b], scale) - mi), keys ? qden[b] : qden[a],
                                 keys ? qinv[b] : qinv[a]);
          pv[a] = live ? p : 0.0f;
          dsv[a] = live ? __fmul_rn(__fmul_rn(p, __fsub_rn(dp[a][b], di)), scale) : 0.0f;
        }
        const int at = (tx + 16 * b) * kLdB + 4 * ty;
        *reinterpret_cast<float4*>(ds_buf + at) = make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
        if (keys) *reinterpret_cast<float4*>(p_buf + at) = make_float4(pv[0], pv[1], pv[2], pv[3]);
      }
      __syncthreads();

      // dq += dS k, or dk += dS^T q and dv += p^T dout, over the chunk's
      // others in ascending order
      for (int o = 0; o < n; ++o) {
        const float4 d4 = *reinterpret_cast<const float4*>(ds_buf + o * kLdB + 4 * ty);
        const float dsv[4] = {d4.x, d4.y, d4.z, d4.w};
        float ar[kNc];
        load_cols<kNc>(ar, a_rows + o * kLd + tx * kNc);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < kNc; ++e) acc0[a][e] = fmaf(dsv[a], ar[e], acc0[a][e]);
        if (keys) {
          const float4 p4 = *reinterpret_cast<const float4*>(p_buf + o * kLdB + 4 * ty);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
          float br[kNc];
          load_cols<kNc>(br, b_rows + o * kLd + tx * kNc);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int e = 0; e < kNc; ++e) acc1[a][e] = fmaf(pv[a], br[e], acc1[a][e]);
        }
      }
      __syncthreads();  // every thread is done with this chunk's buffers
      if (stages == 1 && chunk + 1 < n_chunks) {
        const int n_next = min(kN, hi - o0 - kN);
        stage_tile<T, kN>(other, a_src + base, o0 + kN, n_next, hd, kLd, vec);
        stage_tile<T, kN>(other + kN * kLd, b_src + base, o0 + kN, n_next, hd, kLd, vec);
      }
    }
  }

  if (parts > 1) {
    // the other parts' sums, thread by thread, in their shared memory (free
    // now), which part 0 adds to its own in rank order
    constexpr int kPer = 2 * 4 * kNc;
    cg::cluster_group cluster = cg::this_cluster();
    if (part > 0)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < kNc; ++e) {
          smem[tid * kPer + a * kNc + e] = acc0[a][e];
          smem[tid * kPer + (4 + a) * kNc + e] = acc1[a][e];
        }
    cluster.sync();
    if (part == 0)
      for (int from = 1; from < parts; ++from) {
        const float* theirs = cluster.map_shared_rank(smem, from) + tid * kPer;
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int e = 0; e < kNc; ++e) {
            acc0[a][e] = __fadd_rn(acc0[a][e], theirs[a * kNc + e]);
            acc1[a][e] = __fadd_rn(acc1[a][e], theirs[(4 + a) * kNc + e]);
          }
      }
    cluster.sync();  // the parts' shared memory outlives part 0's reads
    if (part > 0) return;
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + kTy * a;
    if (r >= s) continue;
#pragma unroll
    for (int e = 0; e < kNc; ++e) {
      const int c = tx * kNc + e;
      if (c >= hd) continue;
      const size_t at = (stat + r) * hd + c;
      if (keys) {
        dk[at] = __fadd_rn(dk[at], acc0[a][e]);
        dv[at] = __fadd_rn(dv[at], acc1[a][e]);
      } else {
        dq[at] = __fadd_rn(dq[at], acc0[a][e]);
      }
    }
  }
}

// The backward step on register tiles, for heads of up to kTileHeadDim,
// in blocks of 16 * kTy threads.  Block b of the grid is part b % parts of
// unit u = b / parts, which takes role u % 2 (0: query rows) of plane u / 2
// % planes and tile t = u / 2 / planes; where `paired` (a diagonal block)
// also tile tiles - 1 - t, so that its work under the causal mask is the
// same for every t.
template <typename T, int kTy, int kNc>
__global__ void __launch_bounds__(kTy * 16, resident(tiled_smem(kTy, kNc, 2), tiled_smem(kTy, kNc, 1)))
ring_step_bwd_tiled_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ m, const float* __restrict__ den,
                           const float* __restrict__ big_d, float* __restrict__ dq,
                           float* __restrict__ dk, float* __restrict__ dv, int s, int hd,
                           int q_block, int k_block, bool vec, int tiles, unsigned int planes,
                           int stages, bool paired, int parts) {
  extern __shared__ __align__(16) float tile_smem[];
  const int part = (int)(blockIdx.x % parts);
  const unsigned int unit = blockIdx.x / parts;
  const bool keys = unit & 1;
  const unsigned int rank = unit >> 1;
  const size_t plane = rank % planes;
  const int t = (int)(rank / planes);
  const long long lag = ((long long)q_block - k_block) * s;
  bwd_tile<T, kTy, kNc>(q, k, v, dout, m, den, big_d, dq, dk, dv, tile_smem, s, hd, lag, vec,
                        stages, keys, plane, t * 4 * kTy, part, parts);
  if (paired && tiles - 1 - t != t) {
    __syncthreads();
    bwd_tile<T, kTy, kNc>(q, k, v, dout, m, den, big_d, dq, dk, dv, tile_smem, s, hd, lag, vec,
                          stages, keys, plane, (tiles - 1 - t) * 4 * kTy, part, parts);
  }
}

// ---- wide heads: register tiles over column chunks ----------------------

constexpr int kWideTy = 16;               // a wide tile's rows are 4 kWideTy, its threads 16 kWideTy
constexpr int kWideRows = 4 * kWideTy;
constexpr int kWideC = 64;                // columns of a staged chunk
constexpr int kWideLd = kWideC + 4;       // its row stride: 8 rows 4 banks apart
constexpr int kWidePass = 4;              // output chunks a pass: 256 columns
constexpr int kWideResident = 256;        // the widest head whose query tile stays staged
constexpr long long kWideFullGrid = 128;  // about a wide block for each of the card's 132 SMs

__host__ __device__ constexpr int round_up(int x, int to) { return (x + to - 1) / to * to; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Stage rows [r0, r0 + n) of one head's [s, hd] plane, columns [c0, c0 +
// w) with w = min(width, hd - c0), into dst [rows][ld] as f32: 16-byte
// cp.async copies for f32 rows where vec, else loads that widen.  Every
// other value of dst's rows x width becomes 0, so that the FMA chains and
// the sums run over zeros past hd and past the last row.  A whole chunk
// (w == width) takes the branch whose row length the compiler knows.  The
// caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_cols(float* dst, int ld, int rows, int width,
                                           const T* __restrict__ src, int r0, int n, int hd, int c0,
                                           bool vec) {
  const int w = min(width, hd - c0);
  const auto copy = [&](int cols) {
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        const int per_row = cols / 4;
        for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
          const int j = i / per_row, c = (i - j * per_row) * 4;
          of::cp_async16(dst + j * ld + c, src + (size_t)(r0 + j) * hd + c0 + c);
        }
        return;
      }
    }
    of::stage_rows(dst, src + c0, hd, r0, n, cols, ld, vec);
  };
  if (w == width)
    copy(width);
  else
    copy(w);
  if (n < rows || w < width)
    for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
      const int j = i / width, c = i - j * width;
      if (j >= n || c >= w) dst[j * ld + c] = 0.0f;
    }
}

// Run items [0, n) through two slots of shared memory: issue(t, b) starts
// item t's copies into slot b, compute(t, b) uses them, with item t + 1 in
// flight meanwhile.  One barrier an item: it sees item t's copies land and
// every thread done with item t - 1, whose slot then takes item t + 1 (a
// third slot, two items in flight, gained nothing on the card).  Every
// thread of the block calls it; it ends with a barrier, so the slots are
// free after it.
template <typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int n, const Issue& issue, const Compute& compute) {
  if (n <= 0) return;
  issue(0, 0);
  of::cp_async_commit();
  for (int t = 0; t < n; ++t) {
    of::cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n) {
      issue(t + 1, (t + 1) & 1);
      of::cp_async_commit();
    }
    compute(t, t & 1);
  }
  __syncthreads();
}

// sc[a][b] += x row ty + kWideTy a . y row tx + 16 b over kWideC columns,
// x's rows ldx floats apart and y's kWideLd: the next steps of the 16
// pairs' FMA chains, in ascending column order, fed by 16-byte shared loads
__device__ __forceinline__ void score_chunk(float (&sc)[4][4], const float* x, int ldx,
                                            const float* y, int ty, int tx) {
  const float* xr = x + ty * ldx;
  const float* yr = y + tx * kWideLd;
#pragma unroll 1
  for (int c = 0; c < kWideC; c += 4) {
    float4 xs[4], ys[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) xs[a] = *reinterpret_cast<const float4*>(xr + kWideTy * a * ldx + c);
#pragma unroll
    for (int b = 0; b < 4; ++b) ys[b] = *reinterpret_cast<const float4*>(yr + 16 * b * kWideLd + c);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) sc[a][b] = dot4(xs[a], ys[b], sc[a][b]);
  }
}

// The sum of row a (< 4) and column 4 g + e (g < kWidePass, e < 4) among a
// thread's 16 kWidePass output sums
__host__ __device__ constexpr int sum_at(int a, int g, int e) { return (a * kWidePass + g) * 4 + e; }

// acc[sum_at(a, g, e)] += w[j][4 ty + a] y[j][4 tx + e] over rows j < n of
// a staged output chunk g (y, rows kWideLd floats apart) and of the
// buffer w (rows kLdB apart): the chunk's step of the thread's 4 x 4 sums,
// in ascending order of j; g is the same for every thread, the indices
// into acc constant
template <int kLdB>
__device__ __forceinline__ void add_chunk(float* acc, const float* w, const float* y, int n, int g,
                                          int ty, int tx) {
#pragma unroll
  for (int gg = 0; gg < kWidePass; ++gg) {
    if (gg != g) continue;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float4 w4 = *reinterpret_cast<const float4*>(w + j * kLdB + 4 * ty);
      const float4 y4 = *reinterpret_cast<const float4*>(y + j * kWideLd + 4 * tx);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w}, yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[sum_at(a, gg, e)] = fmaf(wv[a], yv[e], acc[sum_at(a, gg, e)]);
    }
  }
}

// A thread's sums of the other parts of its cluster, added to its own in
// rank order by part 0: each part past 0 leaves its kCount floats in its
// shared memory at `at` (free by then), part 0 reads them there.  Returns
// whether this block is part 0.
template <int kCount>
__device__ __forceinline__ bool gather_parts(float (&sums)[kCount], float* at, int part, int parts) {
  cg::cluster_group cluster = cg::this_cluster();
  float* mine = at + threadIdx.x * kCount;
  if (part > 0)
#pragma unroll
    for (int i = 0; i < kCount; ++i) mine[i] = sums[i];
  cluster.sync();
  if (part == 0)
    for (int from = 1; from < parts; ++from) {
      const float* theirs = cluster.map_shared_rank(mine, from);
#pragma unroll
      for (int i = 0; i < kCount; ++i) sums[i] = __fadd_rn(sums[i], theirs[i]);
    }
  cluster.sync();  // the parts' shared memory outlives part 0's reads
  return part == 0;
}

// The wide forward's shared memory, as offsets in floats: the tile's row
// maxima at 0 (read by a cluster's other blocks), then q where it stays
// staged (heads of one output pass), two slots of the pipeline, p; and
// after each pass, from kWideRows on, where the parts' sums meet (16
// kWidePass + 4 floats a thread)
struct WideFwdLayout {
  int slots, p, total;
};

__host__ __device__ inline WideFwdLayout wide_fwd_layout(bool resident, int hd) {
  const int q = resident ? kWideRows * (round_up(hd, kWideC) + 4) : 0;
  const int slot = (resident ? kTileOthers : kWideRows + kTileOthers) * kWideLd;
  WideFwdLayout l;
  l.slots = kWideRows + q;
  l.p = l.slots + 2 * slot;
  l.total = imax(l.p + kTileOthers * (kWideRows + 4), kWideRows + 16 * kWideTy * (16 * kWidePass + 4));
  return l;
}

// One tile of the wide forward step: kWideRows query rows from r0 against
// the keys they see, in chunks of kTileOthers keys, each scored a
// kWideC-column chunk at a time through `pipeline`: thread (ty, tx) holds
// the scores of its rows ty + kWideTy a and the chunk's keys tx + 16 b in
// registers, one FMA chain over d in ascending order that runs on across
// the column chunks.  q stays staged where kRes (heads up to
// kWideResident), else streams beside each key chunk.  Pass one keeps each
// row's running max (over the 16 tx, then over the parts, as the tiled
// forward does); pass two scores again with the same code, so with the
// same bits, forms p into the row sums and shared memory, and adds p times
// each staged kWideC-column chunk of values into the thread's 4 rows x 4
// columns of that chunk, in registers, in ascending key order: 256 output
// columns a pass, and a head wider than that one more pass two for each
// further 256.  With more than one of `parts` (the blocks of a cluster),
// part p takes the p-th run of whole key chunks; the parts' maxima meet
// before pass two, and part 0 adds the others' sums to its own in rank
// order before it writes, so every part has read m before it is written.
template <typename T, bool kRes>
__device__ __forceinline__ void wide_fwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, float* __restrict__ m,
                                              float* __restrict__ num, float* __restrict__ den,
                                              float* smem, int s, int hd, long long lag, bool vec,
                                              size_t plane, int r0, int part, int parts) {
  constexpr int kTy = kWideTy;
  constexpr int kRows = kWideRows;  // query rows of a tile
  constexpr int kN = kTileOthers;   // keys of a chunk
  constexpr int kLdB = kRows + 4;   // row stride of the p buffer
  constexpr int kSlot = (kRes ? kN : kRows + kN) * kWideLd;
  const int tid = threadIdx.x, lane = tid & 31;
  // a warp holds 2 ty by the 16 tx: a row's max and sum are shuffles
  // within half a warp
  const int ty = (tid >> 5) * 2 + (lane >> 4), tx = lane & 15;
  const int rows = min(kRows, s - r0);
  // query i sees key j when j <= lag + i: the keys the tile sees
  const int n_keys = (int)max(0LL, min((long long)s, lag + r0 + rows));
  if (n_keys == 0) return;  // a later block: the carry stays as it is
  const int2 range = part_range(0, n_keys, part, parts);
  const int lo = range.x, hi = range.y;
  const WideFwdLayout lay = wide_fwd_layout(kRes, hd);
  float* row_max = smem;             // [kRows] the part's row max
  float* own_q = smem + kRows;       // [kRows][ldq] q, where kRes
  float* slots = smem + lay.slots;   // [2][kSlot] (q and) keys, or values
  float* p_buf = smem + lay.p;       // [kN][kLdB] p, own rows in slot order
  const int ldq = kRes ? round_up(hd, kWideC) + 4 : kWideLd;

  const float scale = 1.0f / sqrtf((float)hd);
  const size_t stat = plane * s, base = stat * hd;
  const int n_chunks = (hi - lo + kN - 1) / kN;
  const int n_cols = (hd + kWideC - 1) / kWideC;  // the head's column chunks
  if (kRes && lo < hi) stage_cols(own_q, ldq, kRows, ldq - 4, q + base, r0, rows, hd, 0, vec);

  // column chunk kc of key chunk c (and of q where it streams)
  const auto issue_keys = [&](int c, int kc, float* slot) {
    const int o0 = lo + c * kN;
    if (!kRes) stage_cols(slot, kWideLd, kRows, kWideC, q + base, r0, rows, hd, kc * kWideC, vec);
    stage_cols(kRes ? slot : slot + kRows * kWideLd, kWideLd, kN, kWideC, k + base, o0,
               min(kN, hi - o0), hd, kc * kWideC, vec);
  };
  float sc[4][4];
  const auto score = [&](int kc, const float* slot) {
    if (kc == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) sc[a][b] = 0.0f;
    score_chunk(sc, kRes ? own_q + kc * kWideC : slot, ldq, kRes ? slot : slot + kRows * kWideLd,
                ty, tx);
  };

  // pass one: the running max of the scores the mask leaves
  float rmax[4], new_m[4], shift[4], corr[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) rmax[a] = -INFINITY;
  pipeline(
      n_chunks * n_cols,
      [&](int t, int b) { issue_keys(t / n_cols, t % n_cols, slots + b * kSlot); },
      [&](int t, int b) {
        const int kc = t % n_cols;
        score(kc, slots + b * kSlot);
        if (kc < n_cols - 1) return;
        const int o0 = lo + t / n_cols * kN;
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int o = o0 + tx + 16 * bb, r = r0 + ty + kTy * a;
            if (r < s && o < hi && o <= lag + r) rmax[a] = fmaxf(rmax[a], __fmul_rn(sc[a][bb], scale));
          }
      });
  // each row's block max over the 16 tx, then over the parts
#pragma unroll
  for (int a = 0; a < 4; ++a)
    for (int o = 8; o > 0; o >>= 1) rmax[a] = fmaxf(rmax[a], __shfl_xor_sync(0xffffffffu, rmax[a], o));
  if (parts > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (tx == 0)
#pragma unroll
      for (int a = 0; a < 4; ++a) row_max[ty + kTy * a] = rmax[a];
    cluster.sync();
    for (int from = 0; from < parts; ++from) {
      if (from == part) continue;
      const float* theirs = cluster.map_shared_rank(row_max, from);
#pragma unroll
      for (int a = 0; a < 4; ++a) rmax[a] = fmaxf(rmax[a], theirs[ty + kTy * a]);
    }
  }
  // the new running max, the guarded shift and the correction
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + kTy * a;
    const float m_old = r < s ? m[stat + r] : -INFINITY;
    new_m[a] = fmaxf(m_old, rmax[a]);
    shift[a] = isinf(new_m[a]) ? 0.0f : new_m[a];
    corr[a] = expf(m_old - shift[a]);
  }

  for (int op = 0; op * kWidePass < n_cols; ++op) {
    // pass two: each key chunk scored again, then its values' chunks of
    // this output pass
    const int groups = min(kWidePass, n_cols - op * kWidePass);
    const int per = n_cols + groups;
    float sums[16 * kWidePass + 4];  // the 4 x 4 sums of each chunk (sum_at), then the row sums
    float* total = sums + 16 * kWidePass;
#pragma unroll
    for (int i = 0; i < 16 * kWidePass + 4; ++i) sums[i] = 0.0f;
    pipeline(
        n_chunks * per,
        [&](int t, int b) {
          const int c = t / per, j = t % per;
          float* slot = slots + b * kSlot;
          if (j < n_cols) {
            issue_keys(c, j, slot);
          } else {
            const int o0 = lo + c * kN;
            stage_cols(slot, kWideLd, kN, kWideC, v + base, o0, min(kN, hi - o0), hd,
                       (op * kWidePass + j - n_cols) * kWideC, vec);
          }
        },
        [&](int t, int b) {
          const int j = t % per;
          const float* slot = slots + b * kSlot;
          const int o0 = lo + t / per * kN;
          if (j >= n_cols) {
            // num += p v over the chunk's keys, value chunk j - n_cols
            add_chunk<kLdB>(sums, p_buf, slot, min(kN, hi - o0), j - n_cols, ty, tx);
            return;
          }
          score(j, slot);
          if (j < n_cols - 1) return;
          // p of the pairs the mask leaves, zeros elsewhere, into the row
          // sums and the buffer, where key o's row holds own row ty + kTy
          // a at slot 4 ty + a
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            float pv[4];
#pragma unroll
            for (int a = 0; a < 4; ++a) {
              const int o = o0 + tx + 16 * bb, r = r0 + ty + kTy * a;
              const bool live = r < s && o < hi && o <= lag + r;
              pv[a] = live ? expf(__fmul_rn(sc[a][bb], scale) - shift[a]) : 0.0f;
              total[a] += pv[a];
            }
            *reinterpret_cast<float4*>(p_buf + (tx + 16 * bb) * kLdB + 4 * ty) =
                make_float4(pv[0], pv[1], pv[2], pv[3]);
          }
        });
#pragma unroll
    for (int a = 0; a < 4; ++a)
      for (int o = 8; o > 0; o >>= 1) total[a] += __shfl_xor_sync(0xffffffffu, total[a], o);
    if (parts > 1 && !gather_parts(sums, smem + kRows, part, parts)) continue;

    // the carry, rounding the product and then the sum
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = r0 + ty + kTy * a;
      if (r >= s) continue;
      if (op == 0 && tx == 0) {
        m[stat + r] = new_m[a];
        den[stat + r] = __fadd_rn(__fmul_rn(den[stat + r], corr[a]), total[a]);
      }
#pragma unroll
      for (int g = 0; g < kWidePass; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (op * kWidePass + g) * kWideC + 4 * tx + e;
          if (c >= hd) continue;
          const size_t at = (stat + r) * hd + c;
          num[at] = __fadd_rn(__fmul_rn(num[at], corr[a]), sums[sum_at(a, g, e)]);
        }
    }
  }
}

// The forward step for heads over kTileHeadDim.  Block b of the grid is
// part b % parts of unit u = b / parts, which takes plane u % planes and
// tile tiles - 1 - u / planes, heaviest first.
template <typename T, bool kRes>
__global__ void __launch_bounds__(16 * kWideTy, 1)
ring_step_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      float* __restrict__ m, float* __restrict__ num, float* __restrict__ den,
                      int s, int hd, int q_block, int k_block, bool vec, int tiles,
                      unsigned int planes, int parts) {
  extern __shared__ __align__(16) float tile_smem[];
  const int part = (int)(blockIdx.x % parts);
  const unsigned int unit = blockIdx.x / parts;
  const int t = tiles - 1 - (int)(unit / planes);
  const long long lag = ((long long)q_block - k_block) * s;
  wide_fwd_tile<T, kRes>(q, k, v, m, num, den, tile_smem, s, hd, lag, vec, unit % planes,
                         t * kWideRows, part, parts);
}

// The wide backward's shared memory, in floats: two slots, each a scoring
// chunk's kWideC columns of the tile's two planes and the other side's
// two (or an output chunk's of the other side); then dS (or p)
__host__ __device__ constexpr int wide_bwd_slot() {
  return 2 * (kWideRows + kTileOthers) * kWideLd;
}

__host__ __device__ constexpr size_t wide_bwd_smem() {
  return sizeof(float) *
         ((size_t)2 * wide_bwd_slot() + (size_t)kTileOthers * (kWideRows + 4));
}

// One tile of the wide backward step: kWideRows rows from r0 in one of
// three roles, query rows summing dq (role 0), key rows summing dk (1) or
// dv (2), against the other side in chunks of kTileOthers rows.  Per chunk,
// `pipeline` stages kWideC columns at a time of the tile's rows (q, or k)
// and the other side's (k, or q), and, for dq and dk, of dout and v; thread
// (ty, tx) adds them into the scores (and dout . v) of its own rows ty +
// kWideTy a and the chunk's others tx + 16 b, FMA chains over d in
// ascending order that run on across the column chunks; then forms p and
// dS as the tiled backward does, dS (or, for dv, p) into shared memory;
// then takes each of the output pass `op`'s chunks of kWideC columns of
// the other side (k, q or dout) and adds dS (or p) times it into its 4 rows
// x 4 columns of that chunk, in registers, in ascending order of the other
// side: 256 columns a pass.  Returns at once where the mask leaves the
// tile no pair.  Parts of a cluster split the other side's chunks and meet
// as the tiled backward's do.
template <typename T>
__device__ __forceinline__ void wide_bwd_tile(const T* __restrict__ q, const T* __restrict__ k,
                                              const T* __restrict__ v, const T* __restrict__ dout,
                                              const float* __restrict__ m,
                                              const float* __restrict__ den,
                                              const float* __restrict__ big_d,
                                              float* __restrict__ dq, float* __restrict__ dk,
                                              float* __restrict__ dv, float* smem, int s, int hd,
                                              long long lag, bool vec, int role, size_t plane,
                                              int r0, int part, int parts, int op) {
  constexpr int kTy = kWideTy;
  constexpr int kRows = kWideRows;  // own rows of a tile
  constexpr int kN = kTileOthers;   // others of a chunk
  constexpr int kLdB = kRows + 4;   // row stride of the dS (or p) buffer
  constexpr int kSlot = wide_bwd_slot();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // a warp holds 4 consecutive ty by 8 consecutive tx
  const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);
  const bool keys = role != 0;  // the tile's rows are keys
  const bool grad = role != 2;  // the sums take dS (dq, dk), not p (dv)
  const int rows = min(kRows, s - r0);
  // query i sees key j when j <= lag + i: the others the tile pairs with
  const int o_begin = keys ? (int)min((long long)s, max(0LL, r0 - lag)) : 0;
  const int o_end = keys ? s : (int)max(0LL, min((long long)s, lag + r0 + rows));
  if (o_begin >= o_end) return;  // a later block: the accumulators stay as they are
  const int2 range = part_range(o_begin, o_end, part, parts);
  const int lo = range.x, hi = range.y;

  float* slots = smem;                // [2][kSlot]
  float* w_buf = slots + 2 * kSlot;   // [kN][kLdB] dS or p, own rows in slot order
  const float scale = 1.0f / sqrtf((float)hd);
  const size_t stat = plane * s, base = stat * hd;
  const T* x_src = (keys ? k : q) + base;    // own rows, scored
  const T* y_src = (keys ? v : dout) + base;
  const T* a_src = (keys ? q : k) + base;    // the other side, scored
  const T* b_src = (keys ? dout : v) + base;
  const T* o_src = role == 2 ? b_src : a_src;  // what the sums take: k, q or dout
  float* out = role == 0 ? dq : role == 1 ? dk : dv;
  const int n_chunks = (hi - lo + kN - 1) / kN;
  const int n_cols = (hd + kWideC - 1) / kWideC;  // the head's column chunks
  const int groups = min(kWidePass, n_cols - kWidePass * op);
  const int per = n_cols + groups;

  float acc[16 * kWidePass];  // the 4 x 4 sums of each output chunk (sum_at)
#pragma unroll
  for (int i = 0; i < 16 * kWidePass; ++i) acc[i] = 0.0f;
  // the thread's 4 query rows' m, den (and its reciprocal) and D: its own
  // rows ty + kTy a, loaded here, for query tiles; for key tiles the
  // chunk's others tx + 16 b, loaded with each chunk
  float qm[4], qden[4], qinv[4], qd[4];
  const auto load_stats = [&](int from, int stride, int end) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = from + stride * a;
      const bool live = i < end;
      qm[a] = live ? m[stat + i] : 0.0f;
      qden[a] = live ? den[stat + i] : 1.0f;
      qd[a] = live ? big_d[stat + i] : 0.0f;
      qinv[a] = recip(qden[a]);
    }
  };
  if (!keys) load_stats(r0 + ty, kTy, s);

  float sc[4][4], dp[4][4];
  pipeline(
      n_chunks * per,
      [&](int t, int b) {
        const int j = t % per, o0 = lo + t / per * kN, n = min(kN, hi - o0);
        float* slot = slots + b * kSlot;
        if (j >= n_cols) {
          stage_cols(slot, kWideLd, kN, kWideC, o_src, o0, n, hd,
                     (kWidePass * op + j - n_cols) * kWideC, vec);
          return;
        }
        const int c0 = j * kWideC;
        float* others = slot + 2 * kRows * kWideLd;
        stage_cols(slot, kWideLd, kRows, kWideC, x_src, r0, rows, hd, c0, vec);
        stage_cols(others, kWideLd, kN, kWideC, a_src, o0, n, hd, c0, vec);
        if (grad) {
          stage_cols(slot + kRows * kWideLd, kWideLd, kRows, kWideC, y_src, r0, rows, hd, c0, vec);
          stage_cols(others + kN * kWideLd, kWideLd, kN, kWideC, b_src, o0, n, hd, c0, vec);
        }
      },
      [&](int t, int b) {
        const int j = t % per, o0 = lo + t / per * kN;
        const float* slot = slots + b * kSlot;
        if (j >= n_cols) {
          // dq += dS k, dk += dS^T q or dv += p^T dout over the chunk's
          // others, output chunk j - n_cols
          add_chunk<kLdB>(acc, w_buf, slot, min(kN, hi - o0), j - n_cols, ty, tx);
          return;
        }
        if (j == 0) {
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int bb = 0; bb < 4; ++bb) sc[a][bb] = dp[a][bb] = 0.0f;
          if (keys) load_stats(o0 + tx, 16, hi);
        }
        const float* others = slot + 2 * kRows * kWideLd;
        score_chunk(sc, slot, kWideLd, others, ty, tx);
        if (grad) score_chunk(dp, slot + kRows * kWideLd, kWideLd, others + kN * kWideLd, ty, tx);
        if (j < n_cols - 1) return;
        // p, and for dq and dk dS, of the pairs the mask leaves, zeros
        // elsewhere, into the buffer: other o's row holds own row ty + kTy
        // a at slot 4 ty + a
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const int o = o0 + tx + 16 * bb;
          float wv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int r = r0 + ty + kTy * a;
            const long long i = keys ? o : r, jj = keys ? r : o;
            const bool live = r < s && o < hi && jj <= lag + i;
            // the query's stats (constant indices: the arrays stay in registers)
            const float mi = keys ? qm[bb] : qm[a], di = keys ? qd[bb] : qd[a];
            const float p = div_by(expf(__fmul_rn(sc[a][bb], scale) - mi),
                                   keys ? qden[bb] : qden[a], keys ? qinv[bb] : qinv[a]);
            wv[a] = !live ? 0.0f : grad ? __fmul_rn(__fmul_rn(p, __fsub_rn(dp[a][bb], di)), scale) : p;
          }
          *reinterpret_cast<float4*>(w_buf + (tx + 16 * bb) * kLdB + 4 * ty) =
              make_float4(wv[0], wv[1], wv[2], wv[3]);
        }
      });

  if (parts > 1 && !gather_parts(acc, smem, part, parts)) return;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = r0 + ty + kTy * a;
    if (r >= s) continue;
#pragma unroll
    for (int g = 0; g < kWidePass; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (kWidePass * op + g) * kWideC + 4 * tx + e;
        if (c >= hd) continue;
        const size_t at = (stat + r) * hd + c;
        out[at] = __fadd_rn(out[at], acc[sum_at(a, g, e)]);
      }
  }
}

// The backward step for heads over kTileHeadDim.  Block b of the grid is
// part b % parts of unit u = b / parts, which takes output pass u % ops
// (256 columns) of role u / ops % 3 (dq, dk, dv) of plane u / ops / 3 %
// planes and tile t = u / ops / 3 / planes; where `paired` (a diagonal
// block) also tile tiles - 1 - t, so that its work under the causal mask
// is the same for every t.
template <typename T>
__global__ void __launch_bounds__(16 * kWideTy, 1)
ring_step_bwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ m, const float* __restrict__ den,
                          const float* __restrict__ big_d, float* __restrict__ dq,
                          float* __restrict__ dk, float* __restrict__ dv, int s, int hd,
                          int q_block, int k_block, bool vec, int tiles, unsigned int planes,
                          bool paired, int parts, int ops) {
  extern __shared__ __align__(16) float tile_smem[];
  const int part = (int)(blockIdx.x % parts);
  const unsigned int unit = blockIdx.x / parts;
  const int op = (int)(unit % ops);
  const int role = (int)(unit / ops % 3);
  const unsigned int rank = unit / ops / 3;
  const size_t plane = rank % planes;
  const int t = (int)(rank / planes);
  const long long lag = ((long long)q_block - k_block) * s;
  wide_bwd_tile<T>(q, k, v, dout, m, den, big_d, dq, dk, dv, tile_smem, s, hd, lag, vec, role,
                   plane, t * kWideRows, part, parts, op);
  if (paired && tiles - 1 - t != t) {
    __syncthreads();
    wide_bwd_tile<T>(q, k, v, dout, m, den, big_d, dq, dk, dv, tile_smem, s, hd, lag, vec, role,
                     plane, (tiles - 1 - t) * kWideRows, part, parts, op);
  }
}

// ---- launches -----------------------------------------------------------

// the grid's row blocks a plane, or 0 where the grid would be too large
int row_blocks_of(int b, int h, int s, int blocks_per_row_block) {
  const long long row_blocks = (s + kWarps - 1) / kWarps;
  const long long total = row_blocks * b * h * blocks_per_row_block;
  return total < (1LL << 31) ? (int)row_blocks : 0;
}

bool valid(int b, int h, int s, int hd, int q_block, int k_block) {
  return b >= 1 && h >= 1 && s >= 1 && hd >= 1 && q_block >= 0 && k_block >= 0;
}

struct FwdArgs {
  const void *q, *k, *v;
  void *m, *num, *den;
  int s, hd, q_block, k_block;
  bool vec;
  cudaStream_t stream;
};

struct BwdArgs {
  const void *q, *k, *v, *dout, *m, *den, *big_d;
  void *dq, *dk, *dv;
  int s, hd, q_block, k_block;
  bool vec;
  cudaStream_t stream;
};

// How a tiled launch lays out its grid: rows a tile (64 or 32, or 0 where
// a row kernel takes the step), the blocks of a cluster that share each
// tile's chunks, and whether a block takes tiles t and tiles - 1 - t
struct TilePlan {
  int rows, parts;
  bool paired;
};

// Blocks of a tiled grid of `roles` roles (the backward's query and key
// rows, the forward's query rows), one a tile or a pair of tiles, before
// its parts.
long long tile_blocks(long long planes, int s, int rows, bool paired, int roles) {
  const long long tiles = (s + rows - 1) / rows;
  return roles * planes * (paired ? (tiles + 1) / 2 : tiles);
}

// The backward's plan for a step of `planes` heads of s rows and hd
// columns: rows 0 where the row kernel takes the step, a head wider than
// kTileHeadDim or a block of fewer than kTileMinSeq rows, where the row
// kernel's many small blocks finish sooner.  Otherwise 64 rows, which
// share each staged chunk among more rows, where their grid gives every
// SM two blocks (kFullGrid) and so hides the latency of each; else 32
// rows, whose grid of twice the blocks fills the card sooner.  64-row
// tiles go in pairs on the diagonal, so that each block's work is the
// same and the grid ends in one wave; 32-row tiles never do, since halving
// a grid that does not fill the card costs more than the imbalance.  Two
// blocks of a cluster share each tile's chunks where tiles are long (at
// least kSplitChunks chunks) and the grid of whole tiles leaves the card
// short of blocks, so that no tile's walk of its chunks, one after
// another, sets the launch's time alone; an unpaired diagonal block's grid
// counts half, as its tiles' work averages half the longest's.  Shorter
// tiles leave a part too little to do, and four parts cost more in their
// cluster than they save.
constexpr int kTileMinSeq = 64;
constexpr long long kFullGrid = 256;
constexpr int kSplitChunks = 4;

// The number of the wide kernels' output passes of 256 columns a head of
// hd takes
int wide_passes(int hd) { return (hd + kWidePass * kWideC - 1) / (kWidePass * kWideC); }

// The wide backward's plan, for heads over kTileHeadDim, set by timing the
// plans at heads of 256 on the card: the row kernel under kTileMinSeq rows up
// to heads of kWideResident, where its many small blocks finish sooner;
// else 64-row tiles of three roles, in pairs on the diagonal, and
// elsewhere two parts of a cluster sharing each tile's chunks from
// kSplitChunks chunks, at every grid size the card was timed at (a wide
// block holds an SM's registers alone, so that even a grid of some 800
// blocks ends in an uneven last wave).
TilePlan wide_bwd_plan(int s, int hd, bool diagonal) {
  if (s < kTileMinSeq && hd <= kWideResident) return {0, 1, false};
  return {kWideRows, !diagonal && s >= kSplitChunks * kTileOthers ? 2 : 1, diagonal};
}

TilePlan bwd_plan(long long planes, int s, int hd, bool diagonal) {
  if (hd > kTileHeadDim) return wide_bwd_plan(s, hd, diagonal);
  if (s < kTileMinSeq) return {0, 1, false};
  const int rows = tile_blocks(planes, s, 64, diagonal, 2) >= kFullGrid ? 64 : 32;
  const bool paired = diagonal && rows == 64;
  const long long blocks = tile_blocks(planes, s, rows, paired, 2);
  const bool split = s >= kSplitChunks * kTileOthers &&
                     (diagonal && !paired ? blocks / 2 : blocks) < kFullGrid;
  return {rows, split ? 2 : 1, paired};
}

// f(kTy, kNc) as std::integral_constants for a plan's rows and a head of
// hd: 16 or 8 rows a thread column, 2, 4 or 8 columns a thread
template <typename F>
int by_tile(const TilePlan& plan, int hd, F f) {
  const auto width = [&](auto ty) {
    if (hd <= 32) return f(ty, std::integral_constant<int, 2>());
    if (hd <= 64) return f(ty, std::integral_constant<int, 4>());
    return f(ty, std::integral_constant<int, 8>());
  };
  return plan.rows == 64 ? width(std::integral_constant<int, 16>())
                         : width(std::integral_constant<int, 8>());
}

// `kernel` on a flat grid of `blocks` blocks of `threads` threads, in
// clusters of `parts`, with `smem` bytes of dynamic shared memory
template <typename... P, typename... A>
int launch_clusters(void (*kernel)(P...), long long blocks, int threads, size_t smem, int parts,
                    cudaStream_t stream, A... args) {
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  const cudaError_t err = of::set_attribute_once(
      reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
      of::kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = parts;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned int)blocks);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t launched = cudaLaunchKernelEx(&config, kernel, args...);
  return launched != cudaSuccess ? launched : cudaGetLastError();
}

// ---- forward launches ---------------------------------------------------

// The forward's plan, set by timing every plan at the ring's blocks in
// one run (PERF.md): ring_step_kernel keeps the blocks under
// kFwdTileMinSeq keys that it takes (heads of up to kShortHeadDim, at most
// 65535 batches and heads), where its many small blocks finish sooner.
// The tiled kernel takes the rest up to heads of kTileHeadDim from
// kTileMinSeq keys: 64 rows a tile where their grid has kFullGrid blocks,
// else 32, as the backward's; never in pairs, which cost more than the
// imbalance they remove; and two blocks of a cluster sharing each tile's
// chunks from kSplitChunks chunks while the grid of whole tiles has fewer
// than twice kFullGrid blocks: a forward block needs less shared memory
// and fewer registers than a backward one, so more of them fit an SM at
// once, and the split pays up to twice the grid.  ring_step_long_kernel
// takes what is left: heads over kTileHeadDim, and blocks under
// kTileMinSeq keys with more than 65535 batches or heads.
constexpr int kFwdTileMinSeq = 256;

bool short_block(int b, int h, int s, int hd) {
  return s <= kMaxSeq && hd <= kShortHeadDim && b <= 65535 && h <= 65535;
}

// The wide forward's plan, for heads over kTileHeadDim, set by timing the
// plans at heads of 256 on the card: ring_step_long_kernel under kTileMinSeq
// keys up to heads of kWideResident, where its many small blocks finish
// sooner; else 64-row tiles, two parts of a cluster sharing each tile's
// chunks from kSplitChunks chunks where the grid has fewer blocks than
// kWideFullGrid
TilePlan wide_fwd_plan(long long planes, int s, int hd) {
  if (s < kTileMinSeq && hd <= kWideResident) return {0, 1, false};
  const bool split = s >= kSplitChunks * kTileOthers &&
                     tile_blocks(planes, s, kWideRows, false, 1) < kWideFullGrid;
  return {kWideRows, split ? 2 : 1, false};
}

TilePlan fwd_plan(int b, int h, int s, int hd) {
  const long long planes = (long long)b * h;
  if (hd > kTileHeadDim) return wide_fwd_plan(planes, s, hd);
  if ((short_block(b, h, s, hd) && s < kFwdTileMinSeq) || s < kTileMinSeq)
    return {0, 1, false};
  const int rows = tile_blocks(planes, s, 64, false, 1) >= kFullGrid ? 64 : 32;
  const bool split = s >= kSplitChunks * kTileOthers &&
                     tile_blocks(planes, s, rows, false, 1) < 2 * kFullGrid;
  return {rows, split ? 2 : 1, false};
}

template <typename T, int kTy, int kNc>
int launch_fwd_tiled(const FwdArgs& a, long long planes, const TilePlan& plan) {
  const long long tiles = (a.s + 4 * kTy - 1) / (4 * kTy);
  const int stages = fwd_smem(kTy, kNc, 2) <= (size_t)of::kMaxSmemBytes ? 2 : 1;
  return launch_clusters(
      ring_step_tiled_kernel<T, kTy, kNc>,
      plan.parts * tile_blocks(planes, a.s, 4 * kTy, false, 1), 16 * kTy,
      fwd_smem(kTy, kNc, stages), plan.parts, a.stream, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), static_cast<float*>(a.m),
      static_cast<float*>(a.num), static_cast<float*>(a.den), a.s, a.hd, a.q_block, a.k_block,
      a.vec, (int)tiles, (unsigned int)planes, stages, plan.parts);
}

template <typename T, bool kRes>
int launch_fwd_wide(const FwdArgs& a, long long planes, const TilePlan& plan) {
  const long long tiles = (a.s + kWideRows - 1) / kWideRows;
  return launch_clusters(
      ring_step_wide_kernel<T, kRes>, plan.parts * tile_blocks(planes, a.s, kWideRows, false, 1),
      16 * kWideTy, sizeof(float) * wide_fwd_layout(kRes, a.hd).total, plan.parts, a.stream,
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<float*>(a.m), static_cast<float*>(a.num), static_cast<float*>(a.den), a.s, a.hd,
      a.q_block, a.k_block, a.vec, (int)tiles, (unsigned int)planes, plan.parts);
}

// One launch of the plan's kernel; rows 0: ring_step_kernel where the
// block is short, else ring_step_long_kernel
template <typename T>
int launch_fwd(const FwdArgs& a, int b, int h, const TilePlan& plan) {
  const long long planes = (long long)b * h;
  if (plan.rows && a.hd > kTileHeadDim)
    return a.hd <= kWideResident ? launch_fwd_wide<T, true>(a, planes, plan)
                                 : launch_fwd_wide<T, false>(a, planes, plan);
  if (plan.rows)
    return by_tile(plan, a.hd, [&](auto ty, auto nc) {
      return launch_fwd_tiled<T, decltype(ty)::value, decltype(nc)::value>(a, planes, plan);
    });
  const int s = a.s, hd = a.hd;
  const int row_blocks = row_blocks_of(b, h, s, 1);
  if (row_blocks == 0) return cudaErrorInvalidValue;
  const bool rows_kernel = short_block(b, h, s, hd);
  const void* kernel = rows_kernel ? reinterpret_cast<const void*>(ring_step_kernel<T>)
                                   : reinterpret_cast<const void*>(ring_step_long_kernel<T>);
  const cudaError_t err = of::set_attribute_once(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, of::kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  if (rows_kernel) {
    const int chunk = min(kChunk, s);
    const size_t smem = sizeof(float) * ((size_t)2 * chunk * (hd + 1) +
                                         (size_t)kWarps * hd + (size_t)kWarps * s);
    const dim3 grid((s + kWarps - 1) / kWarps, h, b);
    ring_step_kernel<T><<<grid, 32 * kWarps, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<float*>(a.m), static_cast<float*>(a.num), static_cast<float*>(a.den),
        s, hd, a.q_block, a.k_block, a.vec);
    return cudaGetLastError();
  }
  const int chunk = chunk_for(s, kWarps * hd, 2 * (hd + 1) + kWarps);
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * chunk * (hd + 1) + (size_t)kWarps * hd +
                                       (size_t)kWarps * chunk);
  ring_step_long_kernel<T><<<row_blocks * b * h, 32 * kWarps, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<float*>(a.m), static_cast<float*>(a.num), static_cast<float*>(a.den),
      s, hd, a.q_block, a.k_block, a.vec, chunk, row_blocks);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* m, void* num, void* den, int b,
           int h, int s, int hd, int q_block, int k_block, void* stream) {
  if (!valid(b, h, s, hd, q_block, k_block)) return cudaErrorInvalidValue;
  // 16-byte loads need whole 16-byte pieces of a row and aligned planes
  const bool vec = (hd * (int)sizeof(T)) % 16 == 0 && of::aligned16(q, k, v);
  const FwdArgs args{q, k, v, m, num, den, s, hd, q_block, k_block, vec,
                     static_cast<cudaStream_t>(stream)};
  return launch_fwd<T>(args, b, h, fwd_plan(b, h, s, hd));
}

// ---- backward launches --------------------------------------------------

template <typename T, int kTy, int kNc>
int launch_bwd_tiled(const BwdArgs& a, long long planes, const TilePlan& plan) {
  const long long tiles = (a.s + 4 * kTy - 1) / (4 * kTy);
  const int stages = tiled_smem(kTy, kNc, 2) <= (size_t)of::kMaxSmemBytes ? 2 : 1;
  return launch_clusters(
      ring_step_bwd_tiled_kernel<T, kTy, kNc>,
      plan.parts * tile_blocks(planes, a.s, 4 * kTy, plan.paired, 2), 16 * kTy,
      tiled_smem(kTy, kNc, stages), plan.parts, a.stream, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.m), static_cast<const float*>(a.den),
      static_cast<const float*>(a.big_d), static_cast<float*>(a.dq), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.s, a.hd, a.q_block, a.k_block, a.vec, (int)tiles,
      (unsigned int)planes, stages, plan.paired, plan.parts);
}

template <typename T>
int launch_bwd_wide(const BwdArgs& a, long long planes, const TilePlan& plan) {
  const long long tiles = (a.s + kWideRows - 1) / kWideRows;
  const int passes = wide_passes(a.hd);
  return launch_clusters(
      ring_step_bwd_wide_kernel<T>,
      plan.parts * passes * tile_blocks(planes, a.s, kWideRows, plan.paired, 3), 16 * kWideTy,
      wide_bwd_smem(), plan.parts, a.stream, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.m), static_cast<const float*>(a.den),
      static_cast<const float*>(a.big_d), static_cast<float*>(a.dq), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.s, a.hd, a.q_block, a.k_block, a.vec, (int)tiles,
      (unsigned int)planes, plan.paired, plan.parts, passes);
}

// One launch of the plan's kernel; rows 0: ring_step_bwd_kernel
template <typename T>
int launch_bwd_plan(const BwdArgs& a, int b, int h, const TilePlan& plan) {
  const long long planes = (long long)b * h;
  if (plan.rows && a.hd > kTileHeadDim) return launch_bwd_wide<T>(a, planes, plan);
  if (plan.rows)
    return by_tile(plan, a.hd, [&](auto ty, auto nc) {
      return launch_bwd_tiled<T, decltype(ty)::value, decltype(nc)::value>(a, planes, plan);
    });
  const int s = a.s, hd = a.hd;
  const int row_blocks = row_blocks_of(b, h, s, 2);
  if (row_blocks == 0) return cudaErrorInvalidValue;
  const cudaError_t err = of::set_attribute_once(
      reinterpret_cast<const void*>(ring_step_bwd_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, of::kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  const int chunk = chunk_for(s, 4 * kWarps * hd, 2 * (hd + 1) + 2 * kWarps + 3);
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * chunk * (hd + 1) + (size_t)4 * kWarps * hd +
                                       (size_t)(2 * kWarps + 3) * chunk);
  ring_step_bwd_kernel<T><<<2 * row_blocks * (unsigned int)planes, 32 * kWarps, smem,
                            a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.m),
      static_cast<const float*>(a.den), static_cast<const float*>(a.big_d),
      static_cast<float*>(a.dq), static_cast<float*>(a.dk), static_cast<float*>(a.dv), s, hd,
      a.q_block, a.k_block, a.vec, chunk, row_blocks, (unsigned int)planes);
  return cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* m,
               const void* den, const void* big_d, void* dq, void* dk, void* dv, int b, int h,
               int s, int hd, int q_block, int k_block, void* stream) {
  if (!valid(b, h, s, hd, q_block, k_block)) return cudaErrorInvalidValue;
  const bool vec = (hd * (int)sizeof(T)) % 16 == 0 && of::aligned16(q, k, v, dout);
  const BwdArgs args{q,  k,  v, dout, m,       den,     big_d, dq,
                     dk, dv, s, hd,   q_block, k_block, vec,   static_cast<cudaStream_t>(stream)};
  return launch_bwd_plan<T>(args, b, h, bwd_plan((long long)b * h, s, hd, q_block == k_block));
}

}  // namespace

extern "C" {

const char* of_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// q, k, v: [b, h, s, hd] contiguous, f32 (ring_step_f32) or bf16
// (ring_step_bf16); m, den: f32 [b, h, s, 1]; num: f32 [b, h, s, hd], all
// contiguous and updated in place.  q_block and k_block are the ring
// positions of the query block and of the visiting K/V block.  Returns
// cudaGetLastError().
int ring_step_f32(const void* q, const void* k, const void* v, void* m, void* num,
                  void* den, int b, int h, int s, int hd, int q_block, int k_block,
                  void* stream) {
  return launch<float>(q, k, v, m, num, den, b, h, s, hd, q_block, k_block, stream);
}

int ring_step_bf16(const void* q, const void* k, const void* v, void* m, void* num,
                   void* den, int b, int h, int s, int hd, int q_block, int k_block,
                   void* stream) {
  return launch<__nv_bfloat16>(q, k, v, m, num, den, b, h, s, hd, q_block, k_block,
                               stream);
}

// q, k, v, dout: [b, h, s, hd] contiguous, f32 (ring_step_bwd_f32) or
// bf16 (ring_step_bwd_bf16); m, den, big_d: f32 [b, h, s, 1], the forward's
// final carry and each row's sum(dout * out); dq, dk, dv: f32 [b, h, s,
// hd], the accumulators, updated in place.  One launch; returns
// cudaGetLastError().
int ring_step_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                      const void* m, const void* den, const void* big_d, void* dq, void* dk,
                      void* dv, int b, int h, int s, int hd, int q_block, int k_block,
                      void* stream) {
  return launch_bwd<float>(q, k, v, dout, m, den, big_d, dq, dk, dv, b, h, s, hd, q_block,
                           k_block, stream);
}

int ring_step_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                       const void* m, const void* den, const void* big_d, void* dq, void* dk,
                       void* dv, int b, int h, int s, int hd, int q_block, int k_block,
                       void* stream) {
  return launch_bwd<__nv_bfloat16>(q, k, v, dout, m, den, big_d, dq, dk, dv, b, h, s, hd,
                                   q_block, k_block, stream);
}

}  // extern "C"
