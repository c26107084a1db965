// RMSNorm's backward in one launch: dx row by row and dgain, the column sum
// of dy * xhat over every row, on one thread-block cluster.
//
// Replaces: the backward of operator_forge/tpu/demo.py::_rmsnorm, lines
// 71-73, which XLA derives and fuses on the TPU.  With xhat = x / norm and
// u = dy * gain, in f32 as the reference's forward rounds:
//   norm  = sqrt(mean(x * x) + 1e-6)          the forward's norm, recomputed
//   dx    = (u - xhat * mean(u * xhat)) / norm
//   dgain = sum over rows of dy * xhat
// Each product, sum, division and the square root round as the reference's
// separate operations do (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no
// contraction into an FMA, divisions stay divisions); the row and column
// sums run in another order than PyTorch's, so the port holds the kernel
// to rtol 1e-5 and atol 1e-6 of each output's max.
//
// Bound on an H100 SXM at DemoConfig()'s [512, 128]: it reads x and dy and
// writes dx (786,432 B) and reads gain and writes dgain (1,024 B): 0.235 us
// at 3.35 TB/s, against some 11 f32 operations an element at 67 TFLOP/s,
// 0.011 us.  Bound by bytes, and in practice by one launch.
//
// Design: one cluster of C = 16 blocks (non-portable: the most Hopper
// takes, and faster on an H100 than the portable 8), one launch, no
// scratch in device memory and no atomics.  Block r of the cluster takes
// rows [r R, (r + 1) R), R = ceil(rows / C), split into contiguous runs
// among up to 32 warps; a warp takes one row at a time.  A row of up to 128
// columns (a multiple of 4: the model's widths) sits in registers, read
// and written 16 bytes a lane at a time, so its loads go out together;
// a wider or odd row is strided by the lanes in three passes, the later
// two finding it in L1.  A row of more than kMaxCols columns takes one
// launch a window of columns: each launch reduces every row whole (the
// norm and mean(u * xhat) need it) and writes dx and dgain of its window,
// so the column sums stay within shared memory at any width.  Windows also
// narrow until enough warps fit that none chains more than kMaxChain rows
// into its f32 column sums, whose rounding grows with the chain (as long
// as 32 warps a block suffice).  Offsets are 64-bit.
// The warp writes dx and adds dy * xhat into its own f32 column sums in
// shared memory, in row order.  Then the block adds its warps' sums in
// warp order and stores each column's total into the shared memory of the
// block that owns the column (distributed shared memory, `map_shared_rank`),
// one slot per sending block; one `cluster.sync()` publishes the stores,
// and each block sums its columns' C slots in rank order and writes dgain.
// A barrier arrival at the start, awaited before the stores, makes sure
// every block of the cluster runs before another writes into it.  Every
// sum runs in a fixed order, so a launch repeats bit for bit.  Storing
// into the owner, rather than reading from every block, needs one cluster
// barrier and no remote load, whose latency would come in series.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;
constexpr int kMaxWarps = 32;
constexpr int kMaxCols = 16384;  // the widest window of columns a launch takes
constexpr int kMaxChain = 1024;  // the most rows a warp's column sums should chain
constexpr float kEps = 1e-6f;

__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// the two halves of a cluster barrier (cluster.sync() is both at once)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float norm_of(float sq, float fd) {
  return __fsqrt_rn(__fadd_rn(__fdiv_rn(of::warp_sum(sq), fd), kEps));
}

// One row, its lanes striding any number of columns: a pass for the norm
// (prefetching dy and the gain into L1), one for mean(u * xhat), both over
// the whole row, and one that writes dx of the window [c0, c0 + dc) and
// adds dy * xhat into the warp's column sums `mine` of the window.
__device__ __forceinline__ void row_any(const float* __restrict__ xr,
                                        const float* __restrict__ dyr,
                                        const float* __restrict__ gain, float* __restrict__ dxr,
                                        float* mine, int d, int c0, int dc, int lane) {
  const float fd = static_cast<float>(d);
  float sq = 0.0f;
#pragma unroll 4
  for (int c = lane; c < d; c += 32) {
    const float v = xr[c];
    sq = __fadd_rn(sq, __fmul_rn(v, v));
    prefetch_l1(dyr + c);
    prefetch_l1(gain + c);
  }
  const float norm = norm_of(sq, fd);
  float ux = 0.0f;
#pragma unroll 4
  for (int c = lane; c < d; c += 32) {
    const float xhat = __fdiv_rn(xr[c], norm);
    ux = __fadd_rn(ux, __fmul_rn(__fmul_rn(dyr[c], gain[c]), xhat));
  }
  const float mean_ux = __fdiv_rn(of::warp_sum(ux), fd);
#pragma unroll 4
  for (int c = c0 + lane; c < c0 + dc; c += 32) {
    const float dyc = dyr[c];
    const float xhat = __fdiv_rn(xr[c], norm);
    const float u = __fmul_rn(dyc, gain[c]);
    dxr[c] = __fdiv_rn(__fsub_rn(u, __fmul_rn(xhat, mean_ux)), norm);
    mine[c - c0] = __fadd_rn(mine[c - c0], __fmul_rn(dyc, xhat));
  }
}

// One row of d <= 128 columns, d a multiple of 4, held in registers: lane
// l owns columns 4 l .. 4 l + 3, read and written 16 bytes at a time; `g`
// holds the gain's, loaded once a warp.
__device__ __forceinline__ void row_in_registers(const float* __restrict__ xr,
                                                 const float* __restrict__ dyr, const float4 g,
                                                 float* __restrict__ dxr, float* mine, int d,
                                                 int lane) {
  const int c = 4 * lane;
  const bool inside = c < d;
  const float4 x4 = inside ? *reinterpret_cast<const float4*>(xr + c) : make_float4(0, 0, 0, 0);
  const float4 d4 = inside ? *reinterpret_cast<const float4*>(dyr + c) : make_float4(0, 0, 0, 0);
  float xv[4] = {x4.x, x4.y, x4.z, x4.w};
  const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
  const float gv[4] = {g.x, g.y, g.z, g.w};
  float sq = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) sq = __fadd_rn(sq, __fmul_rn(xv[e], xv[e]));
  const float fd = static_cast<float>(d);
  const float norm = norm_of(sq, fd);
  float ux = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    xv[e] = __fdiv_rn(xv[e], norm);  // xhat from here on
    ux = __fadd_rn(ux, __fmul_rn(__fmul_rn(dv[e], gv[e]), xv[e]));
  }
  const float mean_ux = __fdiv_rn(of::warp_sum(ux), fd);
  if (!inside) return;
  const float4 s4 = *reinterpret_cast<float4*>(mine + c);
  const float sk[4] = {s4.x, s4.y, s4.z, s4.w};
  float out[4], part[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float u = __fmul_rn(dv[e], gv[e]);
    out[e] = __fdiv_rn(__fsub_rn(u, __fmul_rn(xv[e], mean_ux)), norm);
    part[e] = __fadd_rn(sk[e], __fmul_rn(dv[e], xv[e]));
  }
  *reinterpret_cast<float4*>(dxr + c) = make_float4(out[0], out[1], out[2], out[3]);
  *reinterpret_cast<float4*>(mine + c) = make_float4(part[0], part[1], part[2], part[3]);
}

// kInRegisters: rows in registers (d % 4 == 0, d <= 128, 16-byte aligned
// tensors); else any d.  The launch writes dx and dgain of the columns
// [c0, c0 + dc), the whole row with kInRegisters.
template <bool kInRegisters>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
rmsnorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gain,
                   const float* __restrict__ dy, float* __restrict__ dx,
                   float* __restrict__ dgain, int n_rows, int d, int c0, int dc,
                   int rows_per_block) {
  extern __shared__ float4 smem4[];
  float* sums = reinterpret_cast<float*>(smem4);  // [warps][dc]: each warp's column sums
  cg::cluster_group cluster = cg::this_cluster();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  // a block may write another's shared memory only once that block runs:
  // arrive now, wait after the rows
  cluster_arrive_relaxed();

  float* mine = sums + (size_t)warp * dc;
  for (int c = lane; c < dc; c += 32) mine[c] = 0.0f;

  const int per_warp = (rows_per_block + warps - 1) / warps;
  const int block_end = min(n_rows, (rank + 1) * rows_per_block);
  const int r0 = rank * rows_per_block + warp * per_warp;
  const int r1 = min(block_end, r0 + per_warp);
  if constexpr (kInRegisters) {
    const float4 g = 4 * lane < d ? *reinterpret_cast<const float4*>(gain + 4 * lane)
                                  : make_float4(0, 0, 0, 0);
    for (int r = r0; r < r1; ++r)
      row_in_registers(x + (size_t)r * d, dy + (size_t)r * d, g, dx + (size_t)r * d, mine, d,
                       lane);
  } else {
    for (int r = r0; r < r1; ++r)
      row_any(x + (size_t)r * d, dy + (size_t)r * d, gain, dx + (size_t)r * d, mine, d, c0, dc,
              lane);
  }
  __syncthreads();
  cluster_wait();

  // the block's column sums, its warps' added in warp order, each stored
  // into the inbox of the block that owns the column, in this block's slot
  const int share = (dc + kCluster - 1) / kCluster;  // columns a block owns
  float* inbox = sums + (size_t)warps * dc;          // [kCluster][share]
  for (int c = threadIdx.x; c < dc; c += blockDim.x) {
    float s = sums[c];
#pragma unroll 8
    for (int w = 1; w < warps; ++w) s = __fadd_rn(s, sums[(size_t)w * dc + c]);
    const int owner = c / share;
    cluster.map_shared_rank(inbox, owner)[rank * share + c - owner * share] = s;
  }
  // every block's stores land before any block reads its inbox; after this
  // no block touches another's shared memory, so none has to wait to exit
  cluster.sync();

  // dgain of this block's columns: the cluster's sums in rank order
  const int own = rank * share;
  for (int c = own + threadIdx.x; c < min(dc, own + share); c += blockDim.x) {
    float part[kCluster];
#pragma unroll
    for (int k = 0; k < kCluster; ++k) part[k] = inbox[k * share + c - own];
    float s = part[0];
#pragma unroll
    for (int k = 1; k < kCluster; ++k) s = __fadd_rn(s, part[k]);
    dgain[c0 + c] = s;
  }
}

template <bool kInRegisters>
cudaError_t launch(const float* x, const float* gain, const float* dy, float* dx, float* dgain,
                   int n_rows, int d, int c0, int dc, cudaStream_t stream) {
  const auto entry = rmsnorm_bwd_kernel<kInRegisters>;
  const void* kernel = reinterpret_cast<const void*>(entry);
  cudaError_t err = of::set_attribute_once(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, of::kMaxSmemBytes);
  if (err == cudaSuccess)
    err = of::set_attribute_once(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;

  const int rows_per_block = (n_rows + kCluster - 1) / kCluster;
  const int inbox = kCluster * ((dc + kCluster - 1) / kCluster);
  // the warps whose column sums fit beside the inbox
  const int fit = (of::kMaxSmemBytes / (int)sizeof(float) - inbox) / dc;
  const int warps = max(1, min(kMaxWarps, min(rows_per_block, fit)));
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(32 * warps);
  config.dynamicSmemBytes = sizeof(float) * ((size_t)warps * dc + inbox);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, entry, x, gain, dy, dx, dgain, n_rows, d, c0, dc,
                           rows_per_block);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* of_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The blocks of the cluster the kernel runs on.
int rmsnorm_bwd_cluster(void) { return kCluster; }

// x, dy, dx: f32 [n_rows, d] contiguous; gain, dgain: f32 [d].  Writes dx
// and dgain: one launch for rows of up to kMaxCols columns, else one launch
// a window of at most kMaxCols columns.  Returns the launches' status.
int rmsnorm_bwd_f32(const void* x, const void* gain, const void* dy, void* dx, void* dgain,
                    int n_rows, int d, void* stream) {
  if (n_rows < 1 || d < 1) return cudaErrorInvalidValue;
  const auto run = d % 4 == 0 && d <= 128 && of::aligned16(x, gain, dy, dx) ? launch<true>
                                                                          : launch<false>;
  // the widest window beside which the warps that keep every warp's
  // column sums within kMaxChain rows fit
  const int rows_per_block = (n_rows + kCluster - 1) / kCluster;
  const int warps = min(kMaxWarps, (rows_per_block + kMaxChain - 1) / kMaxChain);
  const int width = min(kMaxCols, (of::kMaxSmemBytes / (int)sizeof(float) - kCluster) / (warps + 1));
  const int windows = (d + width - 1) / width;
  const int dc = (d + windows - 1) / windows;
  for (int c0 = 0; c0 < d; c0 += dc) {
    const cudaError_t err = run(static_cast<const float*>(x), static_cast<const float*>(gain),
                                static_cast<const float*>(dy), static_cast<float*>(dx),
                                static_cast<float*>(dgain), n_rows, d, c0, min(dc, d - c0),
                                static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
