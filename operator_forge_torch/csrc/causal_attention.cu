// Causal softmax attention of the demo LM's forward pass, bf16 in and out.
//
// Replaces: operator_forge/tpu/demo.py::_attention, lines 86-92 (scores,
// scale, causal mask, softmax, @ v), which XLA fuses on the TPU.  The QKV
// and output projections around it stay torch.matmul.
//
// Numerics follow the reference's cast points:
//   score = bf16(q . k)      f32 accumulation, one rounding, then f32
//   score / sqrt(f32(head_dim)), a division; masked entries are -1e30
//   p = bf16(exp(score - max) / sum)   softmax in f32, rounded once
//   out = bf16(sum_j p_j v_j)          f32 accumulation, one rounding
// A flash-style kernel that keeps the scores in f32 and normalises at the
// end cannot reproduce the two bf16 roundings, so this kernel takes two
// passes over the keys: every score of a query tile first, then the
// weighted sum of v with the rounded probabilities.
//
// Bound on an H100 SXM at DemoConfig() (batch 8, seq 64, 4 heads of 32):
// it reads the QKV product once (393,216 B) and writes the output once
// (131,072 B), 0.52 MB in all: 0.16 us at 3.35 TB/s.  Its causal products
// are 8.5 MFLOP: 0.01 us at the bf16 tensor rate.  Both lie far below the
// cost of one launch, so this first version aims at one launch with no
// extra copies and exact cast points; its own time is set by the latency
// of its serial FMA chains at 4 warps per SM (PERF.md has the numbers).
//
// Design: one block of 128 threads per (query tile of 16 rows, head,
// batch), 128 blocks at DemoConfig(), about one per SM.  q, k and v are
// read out of the [b, s, 3d] product through strides and the output is
// written straight into [b, s, d], so the head split and merge cost no
// copies.  Keys are staged 64 at a time in shared memory as f32 rows
// padded to head_dim + 1, so that a warp walking 32 rows hits 32 banks;
// only keys at or before the tile's last query are read.  A tile's scores
// stay in shared memory (16 x seq floats, 64 KB at seq 1024).  Products
// are f32 FMAs in serial chains, one dot product or output sum at a time;
// the tensor cores (mma, wgmma) and TMA are left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 16;         // query rows per block
constexpr int kKeys = 64;         // keys staged in shared memory at a time
constexpr int kThreads = 128;
constexpr int kMaxHeadDim = 128;
constexpr int kMaxSeq = 1024;
constexpr int kAcc = kRows * kMaxHeadDim / kThreads;  // outputs per thread
constexpr float kMasked = -1e30f;  // the reference's finite mask fill

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage keys [k0, k0 + kn) of one head of k (offset d) or v (offset 2d).
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      size_t row_stride, int k0, int kn,
                                      int hd, int ld) {
  for (int i = threadIdx.x; i < kn * hd; i += kThreads) {
    const int j = i / hd, c = i - j * hd;
    dst[j * ld + c] = __bfloat162float(src[(size_t)(k0 + j) * row_stride + c]);
  }
}

__global__ void __launch_bounds__(kThreads)
causal_attention_kernel(const __nv_bfloat16* __restrict__ qkv,
                        __nv_bfloat16* __restrict__ out,
                        int s, int n_heads, int hd) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;               // [kRows][ld]  the query tile
  float* kv = qs + kRows * ld;    // [kKeys][ld]  staged keys or values
  float* sc = kv + kKeys * ld;    // [kRows][s]   scores, then probabilities

  const int d = n_heads * hd;
  const size_t row_stride = 3 * (size_t)d;
  const int q0 = blockIdx.x * kRows;
  const int rows = min(kRows, s - q0);
  const int n_keys = q0 + rows;   // later keys are masked for every row
  const __nv_bfloat16* base =
      qkv + (size_t)blockIdx.z * s * row_stride + (size_t)blockIdx.y * hd;
  const int tid = threadIdx.x;

  for (int i = tid; i < kRows * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    qs[r * ld + c] =
        r < rows ? __bfloat162float(base[(size_t)(q0 + r) * row_stride + c]) : 0.0f;
  }

  // pass 1: scores
  const float root = sqrtf((float)hd);
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int kn = min(kKeys, n_keys - k0);
    __syncthreads();
    stage(kv, base + d, row_stride, k0, kn, hd, ld);
    __syncthreads();
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i - r * kKeys;
      if (r >= rows || j >= kn) continue;
      const int key = k0 + j;
      float score = kMasked;
      if (key <= q0 + r) {
        const float* qr = qs + r * ld;
        const float* kr = kv + j * ld;
        float acc = 0.0f;
        for (int c = 0; c < hd; ++c) acc = fmaf(qr[c], kr[c], acc);
        score = round_bf16(acc) / root;
      }
      sc[r * s + key] = score;
    }
  }
  __syncthreads();

  // softmax, one warp per row; exp(-1e30 - max) is exactly 0
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < rows; r += kThreads / 32) {
    float* row = sc + r * s;
    float m = -INFINITY;
    for (int j = lane; j < n_keys; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float total = 0.0f;
    for (int j = lane; j < n_keys; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      total += e;
    }
    total = warp_sum(total);
    for (int j = lane; j < n_keys; j += 32) row[j] = round_bf16(row[j] / total);
  }

  // pass 2: p @ v; thread tid owns outputs tid + e * kThreads of the tile
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int kn = min(kKeys, n_keys - k0);
    __syncthreads();
    stage(kv, base + 2 * d, row_stride, k0, kn, hd, ld);
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
    out[((size_t)blockIdx.z * s + q0 + r) * d + (size_t)blockIdx.y * hd + c] =
        __float2bfloat16(acc[e]);
  }
}

}  // namespace

extern "C" {

const char* of_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// qkv: bf16 [b, s, 3 * n_heads * head_dim], contiguous; out: bf16
// [b, s, n_heads * head_dim], contiguous.  Returns cudaGetLastError().
int causal_attention_bf16(const void* qkv, void* out, int b, int s,
                          int n_heads, int head_dim, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || s > kMaxSeq || n_heads < 1 ||
      n_heads > 65535 || head_dim < 1 || head_dim > kMaxHeadDim)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(kRows + kKeys) * (head_dim + 1) + (size_t)kRows * s);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        causal_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((s + kRows - 1) / kRows, n_heads, b);
  causal_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      s, n_heads, head_dim);
  return cudaGetLastError();
}

}  // extern "C"
