// One block step of causal ring attention: f32 scores of a rank's query
// block against the K/V block visiting it, the causal mask from the two
// blocks' ring positions, and the online-softmax update of the carry
// (m, num, den), in place.
//
// Replaces: operator_forge/tpu/demo.py::_ring_attention_body.step, lines
// 276-298 (einsum, scale, mask, block max, shift guard, correction, exp,
// the two sums), which XLA fuses on the TPU.  The ppermute of the K/V
// block (lines 296-297) stays outside: torch.distributed moves the blocks.
//
// Numerics follow the reference line for line, in f32:
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
// Bound on an H100 SXM at the ring of DemoConfig()'s heads, seq 64 over 4
// ranks ([8, 4, 16, 32] f32 per rank, an earlier block): the step reads q,
// k, v (196,608 B) and the carry (69,632 B) once and writes the carry once
// (69,632 B), 0.34 MB: 0.10 us at 3.35 TB/s, against 1.0 MFLOP of the two
// products at the f32 rate outside the tensor cores, 0.016 us.  So it is
// bound by bytes, and in practice by one launch and the chain of dependent
// steps inside it.
//
// Design: one warp per query row, so the chain of dependent work a row
// needs runs in parallel over every row of the step: at the shape above
// 512 warps in 128 blocks of 4, over (group of rows, head, batch).  A
// block stages the keys and values its rows see into shared memory as f32
// rows padded to d + 1, with 16-byte loads where d allows (bf16 is widened
// there): both at once when they fit in one chunk of 128 keys, else the
// keys chunk by chunk and then the values.  Lane j scores keys j, j + 32,
// ... of each chunk against the row's q, broadcast from shared memory,
// with four independent FMA chains over d; the warp's scores stay in its
// own row of shared memory, so the block max is taken, by warp shuffles,
// before any exp, as the reference takes it.  p replaces the score in
// place; lane c then owns output columns c, c + 32, ... and sums p_j v_j
// over the row's keys in two chains (even and odd keys), p read by every
// lane from the warp's row.  Every sum runs in a fixed order with no
// atomics, so a launch repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 128;       // keys or values staged at a time
constexpr int kWarps = 4;         // query rows per block
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSeq = 1024;
constexpr int kCols = kMaxHeadDim / 32;  // output columns a lane owns

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// Stage rows [r0, r0 + n) of one head's [s, hd] plane into dst [n][ld] as
// f32, 16 bytes a load where `vec` (hd a multiple of 16 bytes' worth of T).
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int n,
                                      int hd, int ld, bool vec) {
  constexpr int kPer = 16 / sizeof(T);
  if (vec) {
    const int per_row = hd / kPer;
    for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
      const int j = i / per_row, c = (i - j * per_row) * kPer;
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + j) * hd + c);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kPer; ++e) dst[j * ld + c + e] = widen(vals[e]);
    }
  } else {
    for (int i = threadIdx.x; i < n * hd; i += blockDim.x) {
      const int j = i / hd, c = i - j * hd;
      dst[j * ld + c] = widen(src[(size_t)(r0 + j) * hd + c]);
    }
  }
}

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

template <typename T>
int launch(const void* q, const void* k, const void* v, void* m, void* num,
           void* den, int b, int h, int s, int hd, int q_block, int k_block,
           void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || s < 1 || s > kMaxSeq ||
      hd < 1 || hd > kMaxHeadDim || q_block < 0 || k_block < 0)
    return cudaErrorInvalidValue;
  const cudaError_t err = of::set_attribute_once(
      reinterpret_cast<const void*>(ring_step_kernel<T>),
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      of::kMaxSmemBytes);
  if (err != cudaSuccess) return err;
  // 16-byte loads need whole 16-byte pieces of a row and aligned planes
  const bool vec = (hd * (int)sizeof(T)) % 16 == 0 && of::aligned16(q, k, v);
  const int chunk = min(kChunk, s);
  const size_t smem = sizeof(float) * ((size_t)2 * chunk * (hd + 1) +
                                       (size_t)kWarps * hd + (size_t)kWarps * s);
  const dim3 grid((s + kWarps - 1) / kWarps, h, b);
  ring_step_kernel<T><<<grid, 32 * kWarps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(m), static_cast<float*>(num), static_cast<float*>(den),
      s, hd, q_block, k_block, vec);
  return cudaGetLastError();
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

}  // extern "C"
