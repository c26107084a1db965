// RMSNorm's forward over the last dim, writing f32 or bf16.
//
// Replaces: operator_forge/tpu/demo.py::_rmsnorm, lines 71-73, and, for a
// bf16 output, the astype(bf16) of the product that reads it (lines 78
// and 97), which XLA fuses into the dot's operand on the TPU.  Per row of
// d values x, in f32:
//   norm = sqrt(sum(x * x) / d + 1e-6)
//   y    = x / norm * gain
// Each product, sum, division and the square root rounds as the
// reference's separate operations do (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no contraction into an FMA).  A bf16 y is that f32 value
// rounded once, to nearest even: the bits of the f32 output followed by
// PyTorch's cast.  Rows of 128 columns square and sum in the order of
// rmsnorm_bwd.cu's rows in registers, so the two compute one norm.
//
// Bound on an H100 SXM: it reads x and gain once and writes y once; at
// DemoConfig()'s [512, 128] to bf16 that is 393,728 B, 0.12 us at
// 3.35 TB/s (the wide step's [4096, 128], 3,146,240 B, 0.94 us), below a
// launch; its 4 operations a value are nothing beside that.  Bound by
// bytes, in practice by the launch.
//
// Design: rows of up to 1024 columns (a multiple of 4, aligned tensors)
// go a warp a row, 4 rows a block, so DemoConfig()'s 512 rows make 128
// blocks: a lane holds up to 8 float4 of its row in registers (one at 128
// columns), a shuffle butterfly sums the squares, and the lane writes its
// values back 16 bytes (f32) or 8 bytes (bf16) at a time.  Wider or odd
// rows go a block a row: the row is staged once into shared memory with
// 16-byte cp.async copies (up to 57,856 values) and both passes read it
// there; past that both read device memory.  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;  // warp path: a warp a row
constexpr int kMaxLoads = 8;      // warp path: the most float4 a lane holds
constexpr int kRowThreads = 256;  // block path: threads a row
constexpr int kStageBytes = of::kMaxSmemBytes - 1024;
constexpr float kEps = 1e-6f;

__device__ __forceinline__ float norm_of(float sq, int d) {
  return __fsqrt_rn(__fadd_rn(__fdiv_rn(sq, static_cast<float>(d)), kEps));
}

__device__ __forceinline__ void store4(float* y, float a, float b, float c, float e) {
  *reinterpret_cast<float4*>(y) = make_float4(a, b, c, e);
}

__device__ __forceinline__ void store4(__nv_bfloat16* y, float a, float b, float c, float e) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, e);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(y) = raw;
}

// A warp a row, K float4 a lane: lane l holds columns (k * 32 + l) * 4 ..
// + 3.
template <typename OutT, int K>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
rmsnorm_warp(const float* __restrict__ x, const float* __restrict__ gain, OutT* __restrict__ y,
             long long n_rows, int d) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const float* xr = x + row * d;
  float4 v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * 32 + lane) * 4;
    v[k] = c < d ? *reinterpret_cast<const float4*>(xr + c) : make_float4(0, 0, 0, 0);
  }
  float sq = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sq = __fadd_rn(sq, __fmul_rn(v[k].x, v[k].x));
    sq = __fadd_rn(sq, __fmul_rn(v[k].y, v[k].y));
    sq = __fadd_rn(sq, __fmul_rn(v[k].z, v[k].z));
    sq = __fadd_rn(sq, __fmul_rn(v[k].w, v[k].w));
  }
  const float norm = norm_of(of::warp_sum(sq), d);
  OutT* yr = y + row * d;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = (k * 32 + lane) * 4;
    if (c < d) {
      const float4 g = *reinterpret_cast<const float4*>(gain + c);
      store4(yr + c, __fmul_rn(__fdiv_rn(v[k].x, norm), g.x),
             __fmul_rn(__fdiv_rn(v[k].y, norm), g.y), __fmul_rn(__fdiv_rn(v[k].z, norm), g.z),
             __fmul_rn(__fdiv_rn(v[k].w, norm), g.w));
    }
  }
}

// A block a row, staged into shared memory (kStaged) or read twice from
// device memory.
template <typename OutT, bool kStaged>
__global__ void __launch_bounds__(kRowThreads)
rmsnorm_block(const float* __restrict__ x, const float* __restrict__ gain, OutT* __restrict__ y,
              int d, bool vec) {
  extern __shared__ float4 smem4[];
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const float* src = x + row * d;
  if constexpr (kStaged) {
    float* staged = reinterpret_cast<float*>(smem4);
    of::stage_row(staged, src, d, vec);
    src = staged;
  }
  float sq = 0.0f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) sq = __fadd_rn(sq, __fmul_rn(src[c], src[c]));
  const float norm = norm_of(of::block_sum(sq, red), d);
  OutT* yr = y + row * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x)
    yr[c] = of::narrow<OutT>(__fmul_rn(__fdiv_rn(src[c], norm), gain[c]));
}

template <typename OutT, int K>
cudaError_t launch_warp(const float* x, const float* gain, OutT* y, long long n_rows, int d,
                        cudaStream_t stream) {
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  rmsnorm_warp<OutT, K><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(x, gain, y, n_rows, d);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch(const void* xv, const void* gainv, void* yv, long long n_rows, int d,
                   void* streamv) {
  if (n_rows < 1 || d < 1 || n_rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xv);
  const float* gain = static_cast<const float*>(gainv);
  OutT* y = static_cast<OutT*>(yv);
  const auto stream = static_cast<cudaStream_t>(streamv);
  const bool vec = d % 4 == 0 && of::aligned16(x, gain, y);
  const int loads = (d + 127) / 128;
  if (vec && loads <= kMaxLoads) {
    const auto run = loads == 1   ? launch_warp<OutT, 1>
                     : loads == 2 ? launch_warp<OutT, 2>
                     : loads <= 4 ? launch_warp<OutT, 4>
                                  : launch_warp<OutT, kMaxLoads>;
    return run(x, gain, y, n_rows, d, stream);
  }
  const size_t bytes = (size_t)d * sizeof(float);
  if (bytes <= (size_t)kStageBytes) {
    const auto kernel = rmsnorm_block<OutT, true>;
    const cudaError_t err = of::set_attribute_once(
        reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)n_rows, kRowThreads, (bytes + 15) / 16 * 16, stream>>>(x, gain, y, d,
                                                                                vec);
  } else {
    rmsnorm_block<OutT, false><<<(unsigned)n_rows, kRowThreads, 0, stream>>>(x, gain, y, d,
                                                                              false);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* of_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x: f32 [n_rows, d] contiguous; gain: f32 [d]; y: [n_rows, d] contiguous,
// f32 (rmsnorm_f32) or bf16 (rmsnorm_bf16), written.  One launch; returns
// cudaGetLastError().
int rmsnorm_f32(const void* x, const void* gain, void* y, long long n_rows, int d, void* stream) {
  return launch<float>(x, gain, y, n_rows, d, stream);
}

int rmsnorm_bf16(const void* x, const void* gain, void* y, long long n_rows, int d,
                 void* stream) {
  return launch<__nv_bfloat16>(x, gain, y, n_rows, d, stream);
}

}  // extern "C"
