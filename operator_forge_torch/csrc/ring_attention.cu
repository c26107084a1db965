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
// the dot products are f32 FMA chains (no TF32, which keeps ~3 digits).
// A block from a later ring position (origin > my) masks every key of
// every query: the reference then leaves the carry as it was (correction
// exp(0) == 1 and p == 0 where m is finite; m == -inf only before any
// block was seen, when num and den are still 0), so every block returns at
// once and the carry keeps its bits.  It is still one launch.
//
// Bound on an H100 SXM at the ring of DemoConfig()'s heads, seq 64 over 4
// ranks ([8, 4, 16, 32] f32 per rank, an earlier block): the step reads q,
// k, v (196,608 B) and the carry (69,632 B) once and writes the carry once
// (69,632 B), 0.34 MB: 0.10 us at 3.35 TB/s, against 1.0 MFLOP of the two
// products at the f32 rate outside the tensor cores, 0.016 us.  So it is
// bound by bytes, and in practice by the cost of one launch; this first
// version aims at the reference's order of arithmetic with no extra copies.
//
// Design: blocks of 128 threads over (tile of 16 query rows, head, batch),
// as in causal_attention.cu.  The tile's q rows and 64 staged rows of k or
// v live in shared memory as f32 rows padded to d + 1 (a warp walking 32
// rows hits 32 banks); bf16 inputs are widened there.  The tile's scores
// for the whole visiting block stay in shared memory (16 x s floats, 64 KB
// at s 1024, over the 48 KB default, so the launch raises the limit), so
// the block max is taken before any exp, as the reference takes it.  Only
// keys that some row of the tile sees are scored: all s of an earlier
// block, those up to the tile's last query on the diagonal.  One warp per
// row then takes the max, the shift, the correction, p and the sum of p,
// and the threads sum p @ v for the (row, column) outputs they own, in key
// order.  Sums run in a fixed order with no atomics, so a launch repeats
// bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 16;         // query rows per block
constexpr int kKeys = 64;         // key or value rows staged at a time
constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSeq = 1024;
constexpr int kAcc = kRows * kMaxHeadDim / kThreads;  // outputs per thread

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage rows [r0, r0 + n) of one head's [s, hd] plane into dst [n][ld] as
// f32; rows at or past `limit` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n,
                                      int limit, int hd, int ld) {
  for (int i = threadIdx.x; i < n * hd; i += kThreads) {
    const int j = i / hd, c = i - j * hd;
    dst[j * ld + c] = r0 + j < limit ? widen(src[(size_t)(r0 + j) * hd + c]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ring_step_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, float* __restrict__ m,
                 float* __restrict__ num, float* __restrict__ den, int s,
                 int hd, int q_block, int k_block) {
  extern __shared__ float smem[];
  __shared__ float correction_of[kRows];
  const int ld = hd + 1;
  float* qs = smem;               // [kRows][ld]  the query tile
  float* kv = qs + kRows * ld;    // [kKeys][ld]  staged keys or values
  float* sc = kv + kKeys * ld;    // [kRows][s]   scores, then p

  const int q0 = blockIdx.x * kRows;
  const int rows = min(kRows, s - q0);
  // query i sits at q_block*s + i and key j at k_block*s + j, so key j is
  // seen by row r when j <= lag + q0 + r
  const long long lag = (long long)(q_block - k_block) * s;
  const int n_keys = (int)max(0LL, min((long long)s, lag + q0 + rows));
  if (n_keys == 0) return;        // a later block: the carry stays as it is

  const size_t plane = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = plane * s * hd;
  const float scale = 1.0f / sqrtf((float)hd);
  const int tid = threadIdx.x;

  stage(qs, q + base, q0, kRows, s, hd, ld);
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int kn = min(kKeys, n_keys - k0);
    __syncthreads();
    stage(kv, k + base, k0, kn, s, hd, ld);
    __syncthreads();
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i - r * kKeys;
      if (r >= rows || j >= kn) continue;
      const int key = k0 + j;
      float score = -INFINITY;
      if ((long long)key <= lag + q0 + r) {
        const float* qr = qs + r * ld;
        const float* kr = kv + j * ld;
        float acc = 0.0f;
        for (int c = 0; c < hd; ++c) acc = fmaf(qr[c], kr[c], acc);
        score = __fmul_rn(acc, scale);
      }
      sc[r * s + key] = score;
    }
  }
  __syncthreads();

  // one warp per row: the block max, the new running max, the guarded
  // shift, the correction, p = exp(score - shift) in place, and den
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* row = sc + r * s;
    float block_max = -INFINITY;
    for (int j = lane; j < n_keys; j += 32) block_max = fmaxf(block_max, row[j]);
    block_max = warp_max(block_max);
    const size_t at = plane * s + q0 + r;
    const float m_old = m[at];
    const float new_m = fmaxf(m_old, block_max);
    const float shift = isinf(new_m) ? 0.0f : new_m;
    const float correction = expf(m_old - shift);
    float total = 0.0f;
    for (int j = lane; j < n_keys; j += 32) {
      const float p = expf(row[j] - shift);
      row[j] = p;
      total += p;
    }
    total = warp_sum(total);
    if (lane == 0) {
      m[at] = new_m;
      den[at] = __fadd_rn(__fmul_rn(den[at], correction), total);
      correction_of[r] = correction;
    }
  }

  // num = num * correction + p @ v, the (row, column) outputs of this
  // thread: i = tid + e * kThreads, row i / hd
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int kn = min(kKeys, n_keys - k0);
    __syncthreads();
    stage(kv, v + base, k0, kn, s, hd, ld);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int i = tid + e * kThreads;
      const int r = i / hd, c = i - r * hd;
      if (i >= kRows * hd || r >= rows) continue;
      const float* p = sc + r * s + k0;
      float a = acc[e];
      for (int j = 0; j < kn; ++j) a = fmaf(p[j], kv[j * ld + c], a);
      acc[e] = a;
    }
  }
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int i = tid + e * kThreads;
    const int r = i / hd, c = i - r * hd;
    if (i >= kRows * hd || r >= rows) continue;
    float* out = num + (plane * s + q0 + r) * hd + c;
    *out = __fadd_rn(__fmul_rn(*out, correction_of[r]), acc[e]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* m, void* num,
           void* den, int b, int h, int s, int hd, int q_block, int k_block,
           void* stream) {
  if (b < 1 || b > 65535 || h < 1 || h > 65535 || s < 1 || s > kMaxSeq ||
      hd < 1 || hd > kMaxHeadDim || q_block < 0 || k_block < 0)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(kRows + kKeys) * (hd + 1) + (size_t)kRows * s);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_step_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((s + kRows - 1) / kRows, h, b);
  ring_step_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(m), static_cast<float*>(num), static_cast<float*>(den),
      s, hd, q_block, k_block);
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
