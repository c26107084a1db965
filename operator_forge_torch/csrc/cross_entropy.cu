// Mean next-token cross entropy over the vocab, forward and backward, on
// f32 or bf16 logits.
//
// Replaces: the tail of operator_forge/tpu/demo.py::loss_fn, lines 116-118
// (log_softmax, the NLL at the target, the mean), and its transpose under
// jax.value_and_grad in train_step (lines 121-127), which XLA fuses on the
// TPU with the logits' widening to f32 (line 109).  Per row of V logits x
// and its target t, with N rows, in f32:
//   top  = max(x)
//   lse  = top + log(sum(exp(x - top)))        log_softmax's order
//   nll  = log(sum(exp(x - top))) - (x[t] - top)
//   loss = sum(nll) / N                          a division (div.rn)
//   dx   = (exp(x - lse) - onehot(t)) * (g / N)  g / N a division
// bf16 logits are widened exactly and computed on in f32, and dx is
// rounded once, to nearest even, to the logits' type: the bits of the f32
// path on the widened logits followed by PyTorch's cast.  A target outside
// [0, V) picks no logit (x[t] - top counts as 0); it is not checked here.
//
// Bound on an H100 SXM: the logits read once and dx written once, with the
// targets and the loss.  At DemoConfig()'s bf16 [512, 256] that is
// 528,388 B, 0.16 us at 3.35 TB/s, far below a launch; at the wide step's
// bf16 [4096, 32000], 524 MB, 0.1565 ms.  Some 10 f32 operations a value
// are nothing beside either: bound by bytes.
//
// Design.  The forward is one launch.  Each row's NLL and log-sum-exp go
// to device memory (lse for the backward); then every block takes an
// integer ticket (an atomic add on a counter that releases the block's
// stores and acquires the others'), and the
// block that draws the last one sums every row's NLL in a fixed order (a
// lane of its first warp a strided run of rows, then a butterfly) and
// divides by N.  The
// sum does not depend on which block is last, so the loss repeats bit for
// bit, without float atomics; the last block sets the counter back to 0,
// so the next launch, or a CUDA graph's replay, finds it at 0.  The
// counter belongs to the device: launches on two streams of one device at
// once would share it, and must not run together.
//   Rows of up to 32 16-byte loads a lane (1024 f32 or 2048 bf16 values,
//   V a multiple of a load's values, aligned tensors) go a warp a row, 4
//   rows a block, so DemoConfig()'s 512 rows make 128 blocks: each lane
//   holds its values in registers (a bf16 row of 256 is one 16-byte load a
//   lane), and shuffle butterflies give the max and the sum.  Longer rows
//   go a block a row: the row is staged once into shared memory with
//   16-byte cp.async copies (up to 57,856 f32 or 115,712 bf16 values) and
//   the max and sum passes read it there, 16 bytes at a time, so device
//   memory is read once; past that the two passes read device memory, in
//   log_softmax's order.
// The backward is one launch over 16-byte vectors (a value at a time
// where V or the alignment does not allow it), a grid of up to 16 blocks
// an SM striding over them, each thread stepping its (row, vector) pair
// without a division.  Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 4;    // warp path: a warp a row
constexpr int kMaxLoads = 8;        // warp path: the most 16-byte loads a lane holds
constexpr int kRowThreads = 512;    // block path: threads a row
constexpr int kBwdThreads = 128;
constexpr int kBwdBlocksPerSm = 16;
constexpr int kSms = 132;
// dynamic shared memory a staged row may take, beside the kernels' static
// shared memory
constexpr int kStageBytes = of::kMaxSmemBytes - 1024;

__device__ __forceinline__ long long target_of(const void* targets, int target_bytes,
                                               long long row) {
  return target_bytes == 8 ? static_cast<const long long*>(targets)[row]
                           : static_cast<const int*>(targets)[row];
}

// The block's rows are written.  Draw a ticket; the last block's first
// warp takes the mean of every row's NLL (lane l sums rows l, l + 32, ...
// in order, then a butterfly) and sets the counter back to 0.  One warp
// finishes sooner than the block would: it needs no barrier.
__device__ __forceinline__ void finish_mean(const float* nll, float* loss, unsigned* counter,
                                            long long n_rows) {
  __shared__ bool last;
  __syncthreads();  // every row of the block is written
  if (threadIdx.x == 0) {
    // release: the block's stores, ordered before by the barrier, reach
    // every block before its ticket does; acquire: the last block sees
    // every other block's
    unsigned ticket;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(counter)
                 : "memory");
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x >= 32) return;
  float s = 0.0f;
  for (long long r = threadIdx.x; r < n_rows; r += 32) s = __fadd_rn(s, __ldcg(nll + r));
  s = of::warp_sum(s);
  if (threadIdx.x == 0) {
    *loss = __fdiv_rn(s, static_cast<float>(n_rows));
    *counter = 0u;
  }
}

__device__ __forceinline__ void write_row(float* nll, float* lse, long long row, float top,
                                          float total, float picked) {
  const float log_total = logf(total);
  nll[row] = __fsub_rn(log_total, picked);
  lse[row] = __fadd_rn(top, log_total);
}

// A warp a row, K 16-byte loads a lane: lane l holds values
// (k * 32 + l) * kVec + e.
template <typename T, int K>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
ce_fwd_warp(const T* __restrict__ x, const void* __restrict__ targets, int target_bytes,
            float* __restrict__ nll, float* __restrict__ lse, float* __restrict__ loss,
            unsigned* __restrict__ counter, long long n_rows, int n_cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row < n_rows) {
    const T* xr = x + row * n_cols;
    float v[K * kVec];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * 32 + lane) * kVec;
      if (c < n_cols) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xr + c);
        const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[k * kVec + e] = of::widen(vals[e]);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[k * kVec + e] = -INFINITY;
      }
    }
    float top = -INFINITY;
#pragma unroll
    for (int i = 0; i < K * kVec; ++i) top = fmaxf(top, v[i]);
    top = of::warp_max(top);
    const long long t = target_of(targets, target_bytes, row);
    float total = 0.0f, picked = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const int c = (k * 32 + lane) * kVec + e;
        const float shifted = __fsub_rn(v[k * kVec + e], top);
        total = __fadd_rn(total, expf(shifted));
        if (c == t && c < n_cols) picked = shifted;
      }
    }
    // one lane at most holds the target: its sum with zeros is exact
    total = of::warp_sum(total);
    picked = of::warp_sum(picked);
    if (lane == 0) write_row(nll, lse, row, top, total, picked);
  }
  finish_mean(nll, loss, counter, n_rows);
}

// f(value), widened, for each of a block's values of a row (in shared or
// device memory), a thread's share in a fixed order: 16-byte vectors
// where `vec` (V a multiple of a vector's values, the row aligned), else
// single values.
template <typename T, typename F>
__device__ __forceinline__ void for_each_value(const T* row, int n_cols, bool vec, F f) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    const uint4* vectors = reinterpret_cast<const uint4*>(row);
    for (int i = threadIdx.x; i < n_cols / kVec; i += blockDim.x) {
      const uint4 raw = vectors[i];
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kVec; ++e) f(of::widen(vals[e]));
    }
  } else {
    for (int c = threadIdx.x; c < n_cols; c += blockDim.x) f(of::widen(row[c]));
  }
}

// A block a row, staged into shared memory (kStaged) or read twice from
// device memory.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kRowThreads)
ce_fwd_block(const T* __restrict__ x, const void* __restrict__ targets, int target_bytes,
             float* __restrict__ nll, float* __restrict__ lse, float* __restrict__ loss,
             unsigned* __restrict__ counter, long long n_rows, int n_cols, bool vec) {
  extern __shared__ uint4 smem4[];
  __shared__ float red[32];
  const long long row = blockIdx.x;
  const T* src = x + row * n_cols;
  if constexpr (kStaged) {
    T* staged = reinterpret_cast<T*>(smem4);
    of::stage_row(staged, src, n_cols, vec);
    src = staged;
  }
  float top = -INFINITY;
  for_each_value(src, n_cols, vec, [&](float v) { top = fmaxf(top, v); });
  top = of::block_max(top, red);
  float total = 0.0f;
  for_each_value(src, n_cols, vec,
                 [&](float v) { total = __fadd_rn(total, expf(__fsub_rn(v, top))); });
  total = of::block_sum(total, red);
  if (threadIdx.x == 0) {
    const long long t = target_of(targets, target_bytes, row);
    const float picked = t >= 0 && t < n_cols ? __fsub_rn(of::widen(src[t]), top) : 0.0f;
    write_row(nll, lse, row, top, total, picked);
  }
  finish_mean(nll, loss, counter, n_rows);
}

// kVecs: 16-byte vectors of a row (V a multiple of a vector's values,
// aligned tensors), else single values.  Item i is (row, col) of
// per_row items a row; a thread strides by (step_rows, step_cols).
template <typename T, bool kVecs>
__global__ void __launch_bounds__(kBwdThreads)
ce_bwd(const T* __restrict__ x, const void* __restrict__ targets, int target_bytes,
       const float* __restrict__ lse, const float* __restrict__ grad, T* __restrict__ dx,
       long long n_rows, int n_cols, long long step_rows, int step_cols) {
  constexpr int kPer = kVecs ? 16 / sizeof(T) : 1;
  const int per_row = n_cols / kPer;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long row = first / per_row;
  int col = static_cast<int>(first - row * per_row);
  const float scale = __fdiv_rn(*grad, static_cast<float>(n_rows));
  for (; row < n_rows; row += step_rows) {
    const long long t = target_of(targets, target_bytes, row);
    const float l = lse[row];
    const size_t at = (size_t)row * n_cols + (size_t)col * kPer;
    float out[kPer];
    if constexpr (kVecs) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + at);
      const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < kPer; ++e) out[e] = of::widen(vals[e]);
    } else {
      out[0] = of::widen(x[at]);
    }
    alignas(16) T res[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const float p = expf(__fsub_rn(out[e], l));
      const float onehot = col * kPer + e == t ? 1.0f : 0.0f;
      res[e] = of::narrow<T>(__fmul_rn(__fsub_rn(p, onehot), scale));
    }
    if constexpr (kVecs) {
      *reinterpret_cast<uint4*>(dx + at) = *reinterpret_cast<const uint4*>(res);
    } else {
      dx[at] = res[0];
    }
    col += step_cols;
    if (col >= per_row) {
      col -= per_row;
      ++row;
    }
  }
}

template <typename T, int K>
cudaError_t launch_warp(const T* x, const void* t, int tb, float* nll, float* lse, float* loss,
                        unsigned* counter, long long n_rows, int n_cols, cudaStream_t stream) {
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  ce_fwd_warp<T, K><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(
      x, t, tb, nll, lse, loss, counter, n_rows, n_cols);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* xv, const void* t, int tb, void* nllv, void* lsev,
                       void* lossv, void* counterv, long long n_rows, int n_cols,
                       void* streamv) {
  if (n_rows < 1 || n_cols < 1 || (tb != 4 && tb != 8) || n_rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  float* nll = static_cast<float*>(nllv);
  float* lse = static_cast<float*>(lsev);
  float* loss = static_cast<float*>(lossv);
  unsigned* counter = static_cast<unsigned*>(counterv);
  const auto stream = static_cast<cudaStream_t>(streamv);
  const bool vec = n_cols % kVec == 0 && of::aligned16(x);
  const int loads = (n_cols + 32 * kVec - 1) / (32 * kVec);
  if (vec && loads <= kMaxLoads) {
    const auto run = loads == 1   ? launch_warp<T, 1>
                     : loads == 2 ? launch_warp<T, 2>
                     : loads <= 4 ? launch_warp<T, 4>
                                  : launch_warp<T, kMaxLoads>;
    return run(x, t, tb, nll, lse, loss, counter, n_rows, n_cols, stream);
  }
  const size_t bytes = ((size_t)n_cols * sizeof(T) + 15) / 16 * 16;
  if (bytes <= (size_t)kStageBytes) {
    const auto kernel = ce_fwd_block<T, true>;
    const cudaError_t err = of::set_attribute_once(
        reinterpret_cast<const void*>(kernel), cudaFuncAttributeMaxDynamicSharedMemorySize,
        kStageBytes);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)n_rows, kRowThreads, bytes, stream>>>(x, t, tb, nll, lse, loss, counter,
                                                              n_rows, n_cols, vec);
  } else {
    ce_fwd_block<T, false><<<(unsigned)n_rows, kRowThreads, 0, stream>>>(
        x, t, tb, nll, lse, loss, counter, n_rows, n_cols, vec);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* xv, const void* t, int tb, const void* lsev,
                       const void* gradv, void* dxv, long long n_rows, int n_cols,
                       void* streamv) {
  if (n_rows < 1 || n_cols < 1 || (tb != 4 && tb != 8)) return cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  const T* x = static_cast<const T*>(xv);
  T* dx = static_cast<T*>(dxv);
  const bool vec = n_cols % kVec == 0 && of::aligned16(x, dx);
  const int per_row = vec ? n_cols / kVec : n_cols;
  const long long items = n_rows * per_row;
  const long long blocks = std::min<long long>((items + kBwdThreads - 1) / kBwdThreads,
                                               (long long)kSms * kBwdBlocksPerSm);
  const long long stride = blocks * kBwdThreads;
  const long long step_rows = stride / per_row;
  const int step_cols = static_cast<int>(stride - step_rows * per_row);
  const auto stream = static_cast<cudaStream_t>(streamv);
  const float* lse = static_cast<const float*>(lsev);
  const float* grad = static_cast<const float*>(gradv);
  if (vec)
    ce_bwd<T, true><<<(unsigned)blocks, kBwdThreads, 0, stream>>>(
        x, t, tb, lse, grad, dx, n_rows, n_cols, step_rows, step_cols);
  else
    ce_bwd<T, false><<<(unsigned)blocks, kBwdThreads, 0, stream>>>(
        x, t, tb, lse, grad, dx, n_rows, n_cols, step_rows, step_cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* of_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// x: [n_rows, n_cols] contiguous logits, f32 (cross_entropy_fwd_f32) or
// bf16 (cross_entropy_fwd_bf16); targets: [n_rows] int32 or int64
// (target_bytes 4 or 8); nll, lse: f32 [n_rows], written; loss: one f32,
// written; counter: one 32-bit int, 0 before the launch and after it.  One
// launch; returns cudaGetLastError().
int cross_entropy_fwd_f32(const void* x, const void* targets, int target_bytes, void* nll,
                          void* lse, void* loss, void* counter, long long n_rows, int n_cols,
                          void* stream) {
  return launch_fwd<float>(x, targets, target_bytes, nll, lse, loss, counter, n_rows, n_cols,
                           stream);
}

int cross_entropy_fwd_bf16(const void* x, const void* targets, int target_bytes, void* nll,
                           void* lse, void* loss, void* counter, long long n_rows, int n_cols,
                           void* stream) {
  return launch_fwd<__nv_bfloat16>(x, targets, target_bytes, nll, lse, loss, counter, n_rows,
                                   n_cols, stream);
}

// x, dx: [n_rows, n_cols] contiguous, f32 (cross_entropy_bwd_f32) or bf16
// (cross_entropy_bwd_bf16); targets as above; lse: f32 [n_rows], the
// forward's; grad: one f32, the loss's gradient.  Writes dx.  One launch;
// returns cudaGetLastError().
int cross_entropy_bwd_f32(const void* x, const void* targets, int target_bytes, const void* lse,
                          const void* grad, void* dx, long long n_rows, int n_cols,
                          void* stream) {
  return launch_bwd<float>(x, targets, target_bytes, lse, grad, dx, n_rows, n_cols, stream);
}

int cross_entropy_bwd_bf16(const void* x, const void* targets, int target_bytes,
                           const void* lse, const void* grad, void* dx, long long n_rows,
                           int n_cols, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, targets, target_bytes, lse, grad, dx, n_rows, n_cols,
                                   stream);
}

}  // extern "C"
