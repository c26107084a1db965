// Causal softmax attention of the demo LM, forward and backward, bf16 in
// and out.
//
// Replaces: operator_forge/tpu/demo.py::_attention, lines 86-92 (scores,
// scale, causal mask, softmax, @ v), which XLA fuses on the TPU, and its
// transpose under jax.value_and_grad in train_step (lines 121-127).  The
// QKV and output projections around it stay torch.matmul.
//
// Forward numerics follow the reference's cast points:
//   score = bf16(q . k)      f32 accumulation, one rounding, then f32
//   score / sqrt(f32(head_dim)), a division; masked entries are -1e30
//   y = exp(score - max) / sum          softmax in f32
//   p = bf16(y)                          rounded once
//   out = bf16(sum_j p_j v_j)            f32 accumulation, one rounding
// A flash-style kernel that keeps the scores in f32 and normalises at the
// end cannot reproduce the two bf16 roundings, so the forward takes two
// passes over the keys: every score of a query tile first, then the
// weighted sum of v with the rounded probabilities.
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
// Every product sums in f32 and rounds once.  Both directions recompute y
// through the same device function, so the backward's y and p agree with
// the forward's bit for bit.
//
// Bound on an H100 SXM at DemoConfig() (batch 8, seq 64, 4 heads of 32):
// the forward reads the QKV product once (393,216 B) and writes the output
// once (131,072 B), 0.52 MB: 0.16 us at 3.35 TB/s, against 8.5 MFLOP of
// causal products, 0.01 us at the bf16 tensor rate.  The backward reads
// QKV and dO and writes dQKV, 0.92 MB: 0.27 us, against 21 MFLOP of five
// causal products (the score recompute, dP, dV, dQ, dK), 0.02 us.  All lie
// far below the cost of one launch, so these first versions aim at exact
// cast points with no extra copies; their time is set by the latency of
// serial FMA chains at 4 warps per SM (PERF.md has the numbers).
//
// Design: blocks of 128 threads over (tile of 16 rows, head, batch), 128
// blocks at DemoConfig(), about one per SM.  q, k, v and dO are read out of
// their [b, s, *] tensors through strides and every result is written
// straight into [b, s, *], so the head split and merge cost no copies.
// Rows are staged 64 at a time in shared memory as f32 rows padded to
// head_dim + 1, so that a warp walking 32 rows hits 32 banks; only keys at
// or before the tile's last query are read.  A query tile's scores stay in
// shared memory (16 x seq floats, 64 KB at seq 1024).  The backward is two
// launches with no atomics, so its sums run in a fixed order and repeat
// bit for bit: the first, per query tile, computes y, dP, D and dS_bf,
// writes dQ, and leaves p and dS_bf in a [b, h, s, s] bf16 scratch; the
// second, per key tile, sums dK and dV over the queries in order.  Products
// are f32 FMAs in serial chains; the tensor cores (mma, wgmma) and TMA are
// left to a later version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 16;         // query (or key) rows per block
constexpr int kKeys = 64;         // rows staged in shared memory at a time
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

// Stage rows [r0, r0 + n) of one head (src points at its first column)
// into dst [n][ld] as f32.
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      size_t row_stride, int r0, int n,
                                      int hd, int ld) {
  for (int i = threadIdx.x; i < n * hd; i += kThreads) {
    const int j = i / hd, c = i - j * hd;
    dst[j * ld + c] = __bfloat162float(src[(size_t)(r0 + j) * row_stride + c]);
  }
}

// Stage a tile of kRows rows starting at r0, zero past the n that exist.
__device__ __forceinline__ void load_tile(float* dst, const __nv_bfloat16* src,
                                          size_t row_stride, int r0, int n,
                                          int hd, int ld) {
  for (int i = threadIdx.x; i < kRows * hd; i += kThreads) {
    const int r = i / hd, c = i - r * hd;
    dst[r * ld + c] =
        r < n ? __bfloat162float(src[(size_t)(r0 + r) * row_stride + c]) : 0.0f;
  }
}

// Softmax of query rows [q0, q0 + rows) (tile qs) against keys [0, n_keys)
// of k_base into sc [kRows][s]: y in f32, or p = bf16(y) when kRound.
// The forward and the backward both call this, so they see the same y.
template <bool kRound>
__device__ void softmax_tile(const __nv_bfloat16* k_base, size_t row_stride,
                             const float* qs, float* kv, float* sc, int s,
                             int hd, int ld, int q0, int rows, int n_keys) {
  const int tid = threadIdx.x;
  const float root = sqrtf((float)hd);
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int kn = min(kKeys, n_keys - k0);
    __syncthreads();
    stage(kv, k_base, row_stride, k0, kn, hd, ld);
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

  // one warp per row; exp(-1e30 - max) is exactly 0
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
    for (int j = lane; j < n_keys; j += 32) {
      const float y = row[j] / total;
      row[j] = kRound ? round_bf16(y) : y;
    }
  }
}

// acc[e] += sum_j w[r][k0 + j] * rows[j][c] over the kn staged rows, for
// the outputs (r, c) this thread owns: i = tid + e * kThreads, r = i / hd.
__device__ __forceinline__ void weighted_sum(float* acc, const float* w, int w_ld,
                                             int k0, const float* staged, int kn,
                                             int n_rows, int hd, int ld) {
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int i = threadIdx.x + e * kThreads;
    const int r = i / hd, c = i - r * hd;
    if (i >= kRows * hd || r >= n_rows) continue;
    const float* p = w + r * w_ld + k0;
    float a = acc[e];
    for (int j = 0; j < kn; ++j) a = fmaf(p[j], staged[j * ld + c], a);
    acc[e] = a;
  }
}

// Write the tile's outputs (r, c) to dst (row stride row_stride), bf16.
__device__ __forceinline__ void store_tile(__nv_bfloat16* dst, size_t row_stride,
                                           const float* acc, int n_rows, int hd) {
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int i = threadIdx.x + e * kThreads;
    const int r = i / hd, c = i - r * hd;
    if (i >= kRows * hd || r >= n_rows) continue;
    dst[(size_t)r * row_stride + c] = __float2bfloat16(acc[e]);
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
  float* sc = kv + kKeys * ld;    // [kRows][s]   probabilities

  const int d = n_heads * hd;
  const size_t row_stride = 3 * (size_t)d;
  const int q0 = blockIdx.x * kRows;
  const int rows = min(kRows, s - q0);
  const int n_keys = q0 + rows;   // later keys are masked for every row
  const __nv_bfloat16* base =
      qkv + (size_t)blockIdx.z * s * row_stride + (size_t)blockIdx.y * hd;

  load_tile(qs, base, row_stride, q0, rows, hd, ld);
  softmax_tile<true>(base + d, row_stride, qs, kv, sc, s, hd, ld, q0, rows, n_keys);

  // p @ v
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int kn = min(kKeys, n_keys - k0);
    __syncthreads();
    stage(kv, base + 2 * d, row_stride, k0, kn, hd, ld);
    __syncthreads();
    weighted_sum(acc, sc, s, k0, kv, kn, rows, hd, ld);
  }
  store_tile(out + ((size_t)blockIdx.z * s + q0) * d + (size_t)blockIdx.y * hd,
             d, acc, rows, hd);
}

// Backward, first launch: one block per (query tile, head, batch).
// Writes dQ, and p and dS_bf of the tile's rows (keys at or before each
// query) into the [b, h, s, s] scratch for the second launch.
__global__ void __launch_bounds__(kThreads)
causal_attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ qkv,
                               const __nv_bfloat16* __restrict__ dout,
                               __nv_bfloat16* __restrict__ dqkv,
                               __nv_bfloat16* __restrict__ p_out,
                               __nv_bfloat16* __restrict__ ds_out,
                               int s, int n_heads, int hd) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qs = smem;               // [kRows][ld]  the query tile
  float* dos = qs + kRows * ld;   // [kRows][ld]  its rows of dO
  float* kv = dos + kRows * ld;   // [kKeys][ld]  staged keys or values
  float* sc = kv + kKeys * ld;    // [kRows][s]   y
  float* dp = sc + kRows * s;     // [kRows][s]   dP, then dS_bf

  const int d = n_heads * hd;
  const size_t row_stride = 3 * (size_t)d;
  const int q0 = blockIdx.x * kRows;
  const int rows = min(kRows, s - q0);
  const int n_keys = q0 + rows;
  const __nv_bfloat16* base =
      qkv + (size_t)blockIdx.z * s * row_stride + (size_t)blockIdx.y * hd;
  const __nv_bfloat16* dbase =
      dout + (size_t)blockIdx.z * s * d + (size_t)blockIdx.y * hd;
  const int tid = threadIdx.x;

  load_tile(qs, base, row_stride, q0, rows, hd, ld);
  load_tile(dos, dbase, d, q0, rows, hd, ld);
  softmax_tile<false>(base + d, row_stride, qs, kv, sc, s, hd, ld, q0, rows, n_keys);

  // dP = bf16(dO . v) for keys at or before each query
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int kn = min(kKeys, n_keys - k0);
    __syncthreads();
    stage(kv, base + 2 * d, row_stride, k0, kn, hd, ld);
    __syncthreads();
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, j = i - r * kKeys;
      const int key = k0 + j;
      if (r >= rows || j >= kn || key > q0 + r) continue;
      const float* dr = dos + r * ld;
      const float* vr = kv + j * ld;
      float acc = 0.0f;
      for (int c = 0; c < hd; ++c) acc = fmaf(dr[c], vr[c], acc);
      dp[r * s + key] = round_bf16(acc);
    }
  }
  __syncthreads();

  // one warp per row: D, then dS_bf (0 where masked) into dp, and p and
  // dS_bf to the scratch
  const float root = sqrtf((float)hd);
  const int warp = tid >> 5, lane = tid & 31;
  const size_t plane = ((size_t)blockIdx.z * n_heads + blockIdx.y) * s;
  for (int r = warp; r < rows; r += kThreads / 32) {
    const int last = q0 + r;      // the row's last unmasked key
    const float* y = sc + r * s;
    float* g = dp + r * s;
    float part = 0.0f;
    for (int j = lane; j <= last; j += 32) part = fmaf(y[j], g[j], part);
    const float big_d = warp_sum(part);
    __nv_bfloat16* p_row = p_out + (plane + last) * s;
    __nv_bfloat16* ds_row = ds_out + (plane + last) * s;
    for (int j = lane; j < n_keys; j += 32) {
      float ds = 0.0f;
      if (j <= last) {
        ds = round_bf16(y[j] * (g[j] - big_d) / root);
        p_row[j] = __float2bfloat16(y[j]);
        ds_row[j] = __float2bfloat16(ds);
      }
      g[j] = ds;
    }
  }

  // dQ = bf16(dS_bf K)
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
  for (int k0 = 0; k0 < n_keys; k0 += kKeys) {
    const int kn = min(kKeys, n_keys - k0);
    __syncthreads();
    stage(kv, base + d, row_stride, k0, kn, hd, ld);
    __syncthreads();
    weighted_sum(acc, dp, s, k0, kv, kn, rows, hd, ld);
  }
  store_tile(dqkv + ((size_t)blockIdx.z * s + q0) * row_stride + (size_t)blockIdx.y * hd,
             row_stride, acc, rows, hd);
}

// Backward, second launch: one block per (key tile, head, batch).  Sums
// dK = bf16(sum_q dS_bf[q,k] q[q]) and dV = bf16(sum_q p[q,k] dO[q]) over
// the queries at or after each key, in ascending order.
__global__ void __launch_bounds__(kThreads)
causal_attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ qkv,
                                const __nv_bfloat16* __restrict__ dout,
                                const __nv_bfloat16* __restrict__ p_in,
                                const __nv_bfloat16* __restrict__ ds_in,
                                __nv_bfloat16* __restrict__ dqkv,
                                int s, int n_heads, int hd) {
  extern __shared__ float smem[];
  const int ld = hd + 1;
  float* qb = smem;               // [kKeys][ld]    staged queries' q
  float* db = qb + kKeys * ld;    // [kKeys][ld]    their dO
  float* pb = db + kKeys * ld;    // [kKeys][kRows] p[q][key], the tile's keys
  float* sb = pb + kKeys * kRows; // [kKeys][kRows] dS_bf[q][key]

  const int d = n_heads * hd;
  const size_t row_stride = 3 * (size_t)d;
  const int k0 = blockIdx.x * kRows;
  const int kn = min(kRows, s - k0);
  const __nv_bfloat16* base =
      qkv + (size_t)blockIdx.z * s * row_stride + (size_t)blockIdx.y * hd;
  const __nv_bfloat16* dbase =
      dout + (size_t)blockIdx.z * s * d + (size_t)blockIdx.y * hd;
  const size_t plane = ((size_t)blockIdx.z * n_heads + blockIdx.y) * s;

  float acc_k[kAcc], acc_v[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc_k[e] = acc_v[e] = 0.0f;
  // queries before k0 see none of the tile's keys
  for (int qc = k0; qc < s; qc += kKeys) {
    const int qn = min(kKeys, s - qc);
    __syncthreads();
    stage(qb, base, row_stride, qc, qn, hd, ld);
    stage(db, dbase, d, qc, qn, hd, ld);
    for (int i = threadIdx.x; i < kKeys * kRows; i += kThreads) {
      const int j = i / kRows, kk = i - j * kRows;
      const int q = qc + j, key = k0 + kk;
      // only entries the first launch wrote: key <= q
      const bool live = j < qn && kk < kn && key <= q;
      const size_t at = (plane + q) * s + key;
      pb[i] = live ? __bfloat162float(p_in[at]) : 0.0f;
      sb[i] = live ? __bfloat162float(ds_in[at]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int i = threadIdx.x + e * kThreads;
      const int r = i / hd, c = i - r * hd;
      if (i >= kRows * hd || r >= kn) continue;
      float a_k = acc_k[e], a_v = acc_v[e];
      for (int j = 0; j < qn; ++j) {
        a_k = fmaf(sb[j * kRows + r], qb[j * ld + c], a_k);
        a_v = fmaf(pb[j * kRows + r], db[j * ld + c], a_v);
      }
      acc_k[e] = a_k;
      acc_v[e] = a_v;
    }
  }
  __nv_bfloat16* dst =
      dqkv + ((size_t)blockIdx.z * s + k0) * row_stride + (size_t)blockIdx.y * hd;
  store_tile(dst + d, row_stride, acc_k, kn, hd);
  store_tile(dst + 2 * d, row_stride, acc_v, kn, hd);
}

bool valid(int b, int s, int n_heads, int head_dim) {
  return b >= 1 && b <= 65535 && s >= 1 && s <= kMaxSeq && n_heads >= 1 &&
         n_heads <= 65535 && head_dim >= 1 && head_dim <= kMaxHeadDim;
}

// Raise a kernel's dynamic shared memory limit where it needs over 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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
  if (!valid(b, s, n_heads, head_dim)) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(kRows + kKeys) * (head_dim + 1) + (size_t)kRows * s);
  const cudaError_t err = allow_smem(causal_attention_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRows - 1) / kRows, n_heads, b);
  causal_attention_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
      s, n_heads, head_dim);
  return cudaGetLastError();
}

// qkv: bf16 [b, s, 3d] as in the forward; dout: bf16 [b, s, d]; dqkv: bf16
// [b, s, 3d]; p_scratch and ds_scratch: bf16 [b, n_heads, s, s] each, all
// contiguous, d = n_heads * head_dim.  Two launches on one stream; returns
// cudaGetLastError().
int causal_attention_bwd_bf16(const void* qkv, const void* dout, void* dqkv,
                              void* p_scratch, void* ds_scratch, int b, int s,
                              int n_heads, int head_dim, void* stream) {
  if (!valid(b, s, n_heads, head_dim)) return cudaErrorInvalidValue;
  const size_t ld = head_dim + 1;
  const size_t smem_dq =
      sizeof(float) * ((2 * kRows + kKeys) * ld + 2 * (size_t)kRows * s);
  const size_t smem_dkv = sizeof(float) * (2 * kKeys * ld + 2 * kKeys * kRows);
  cudaError_t err = allow_smem(causal_attention_bwd_dq_kernel, smem_dq);
  if (err != cudaSuccess) return err;
  err = allow_smem(causal_attention_bwd_dkv_kernel, smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kRows - 1) / kRows, n_heads, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qkv_p = static_cast<const __nv_bfloat16*>(qkv);
  const auto* dout_p = static_cast<const __nv_bfloat16*>(dout);
  auto* dqkv_p = static_cast<__nv_bfloat16*>(dqkv);
  auto* p_p = static_cast<__nv_bfloat16*>(p_scratch);
  auto* ds_p = static_cast<__nv_bfloat16*>(ds_scratch);
  causal_attention_bwd_dq_kernel<<<grid, kThreads, smem_dq, st>>>(
      qkv_p, dout_p, dqkv_p, p_p, ds_p, s, n_heads, head_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  causal_attention_bwd_dkv_kernel<<<grid, kThreads, smem_dkv, st>>>(
      qkv_p, dout_p, p_p, ds_p, dqkv_p, s, n_heads, head_dim);
  return cudaGetLastError();
}

}  // extern "C"
