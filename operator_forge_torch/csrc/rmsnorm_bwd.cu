// RMSNorm's backward in one launch: dx row by row and dgain, the column sum
// of dy * xhat over every row.
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
// to rtol 1e-5 and atol 1e-6 of each output's max.  A bf16 dy (the second
// entry) is widened exactly in registers: the bits of the f32 entry on dy
// widened first, at the same alignment.
//
// Bound on an H100 SXM: x read, dy read, dx written once, gain and dgain
// beside them.  At DemoConfig()'s [512, 128] in f32, 786,432 B: 0.235 us at
// 3.35 TB/s, against some 11 f32 operations an element at 67 TFLOP/s,
// 0.011 us; bound by one launch.  At the benchmark's train shapes,
// Pythia-1.4B's [8192, 2048] and GPT-2 medium's [16384, 1024] (16.8 M
// values each) with dy in bf16, 10 bytes a value, 168 MB: 0.050 ms,
// against 0.003 ms of operations; bound by bytes.
//
// One grid, one reduction across blocks, two row designs.  The grid fills
// the card: 1024 / threads blocks an SM (the launch bounds hold a thread to
// 64 registers, so that many fit), the SM count read from the device;
// fewer where the rows do not give every block a step of rows (below), so
// that a few rows (DemoConfig()'s 512) take a few blocks of one step each;
// more, in waves, where a thread would otherwise chain more than kMaxChain
// rows into its column sums, whose rounding grows with the chain.  Block b
// takes the contiguous rows [b R, (b + 1) R), R = ceil(rows / blocks).
//
// The held design, rows of d columns, d a multiple of 8 up to 8192, with
// 16-byte aligned tensors (the cells' shapes): a thread owns 8 fixed
// columns of the row, 4 from c = 4 t and 4 from d / 2 + c, so that each of
// a warp's loads and stores is contiguous; a row takes ceil(d / 256) warps,
// and a block of up to 512 threads takes several rows at a time, one a row
// group (a step of rows).  Each row is read once into registers and dx
// written once: no second pass over memory.  The next row's x and dy are
// loaded before this row's sums, so loads stay in flight across the row's
// two block barriers; the gain, staged once a block in shared memory, is
// read there each row, which keeps a thread within its 64 registers.  A
// row's two sums, sum(x^2) and sum(u * xhat), are each thread's 8 values
// in order, a warp's butterfly, then the row group's warps in warp order
// through a word a warp of shared memory.  dgain's partial lives in
// registers: a thread adds dy * xhat of its 8 columns over its rows in row
// order, and a block adds its row groups' in group order and stores the
// block's [d] partial in its row of a scratch [blocks + groups, d] from
// the wrapper.  dy's last use is the pass that forms xhat and u (and adds
// the partial), so only xhat and u live across the row's second barrier.
//
// The strided design, every other width or alignment (rows wider than
// 8192, widths not a multiple of 8, bases not 16-byte aligned): the whole
// block takes one row at a time, its threads striding the columns in three
// passes (sum(x^2), then sum(u * xhat), then dx), the later two finding the
// row in L1 or L2.  A row's sums are each thread's columns in order, a
// warp's butterfly, then the block's warps in warp order.  A column's
// dgain partial cannot stay in a register across a row of any width, so
// the thread that owns the column adds dy * xhat into the block's row of
// the scratch, in row order: a block's row is its own, so no atomics, at
// any width.  Its sums and dx round as the held design's do, term by term.
// The kernel calls this design's code rather than inlining it: inlined, it
// took registers from the held design's loop (bf16 dy: spills of 40 bytes
// instead of none, the cells' shapes about 9% slower on an H100).
//
// Then the blocks meet in groups of about sqrt(blocks): each takes an
// integer ticket of its group's counter (an atomic add that releases the
// block's stores and acquires the others'), and the group's last block sums
// its members' partials in block order and stores the group's; then it
// takes a ticket of the launch's counter, and the last group's finisher
// sums the groups' in group order and writes dgain.  Two levels keep each
// finisher's reads to about sqrt(blocks) rows of d.  Each finisher sets its
// counter back to 0, so the next launch or a graph's replay finds every
// counter at 0.  Every sum runs in a fixed order that does not depend on
// which block finishes last: a call repeats bit for bit, with no float
// atomics.  The counters belong to the device: two launches on two streams
// of one device at once would share them, and must not run together.
//
// Offsets are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxWarps = 32;
constexpr int kMaxChain = 1024;  // the most rows a thread's column sums should chain
constexpr float kEps = 1e-6f;
constexpr int kVec = 8;             // the columns a thread owns in the held design
constexpr int kBlockThreads = 512;  // a block's threads where a row takes fewer
constexpr int kMaxGroups = 64;      // the most groups of blocks, a counter each

// A thread's kVec columns of a row, 4 from c and 4 from h + c, as loaded:
// 16 bytes from each for f32, 8 for bf16.
template <typename T>
struct Cols;
template <>
struct Cols<float> {
  float4 lo, hi;
};
template <>
struct Cols<__nv_bfloat16> {
  uint2 lo, hi;
};

template <typename T>
__device__ __forceinline__ Cols<T> fetch_cols(const T* p, int c, int h) {
  using V = decltype(Cols<T>::lo);
  return {*reinterpret_cast<const V*>(p + c), *reinterpret_cast<const V*>(p + h + c)};
}

// the columns widened exactly to f32 (a bf16 pair's first value is its
// word's low half)
__device__ __forceinline__ void widen_cols(const Cols<float>& a, float (&v)[kVec]) {
  v[0] = a.lo.x, v[1] = a.lo.y, v[2] = a.lo.z, v[3] = a.lo.w;
  v[4] = a.hi.x, v[5] = a.hi.y, v[6] = a.hi.z, v[7] = a.hi.w;
}

__device__ __forceinline__ void widen_cols(const Cols<__nv_bfloat16>& a, float (&v)[kVec]) {
  v[0] = of::lo_of(a.lo.x), v[1] = of::hi_of(a.lo.x), v[2] = of::lo_of(a.lo.y);
  v[3] = of::hi_of(a.lo.y), v[4] = of::lo_of(a.hi.x), v[5] = of::hi_of(a.hi.x);
  v[6] = of::lo_of(a.hi.y), v[7] = of::hi_of(a.hi.y);
}

__device__ __forceinline__ void load_cols(const float* p, int c, int h, float (&v)[kVec]) {
  widen_cols(fetch_cols(p, c, h), v);
}

__device__ __forceinline__ void store_cols(float* p, int c, int h, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p + c) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + h + c) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void add(float4& s, const float4 v) {
  s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                  __fadd_rn(s.w, v.w));
}

__device__ __forceinline__ void add(float& s, const float v) { s = __fadd_rn(s, v); }

// A row group's sum of one value a thread: each warp's butterfly, then
// the group's `nw` warps from `w0` in warp order through `red` (a float a
// warp of the block).  Every thread of the group ends with the same bits.
__device__ __forceinline__ float group_sum(float v, float* red, int w0, int nw) {
  v = of::warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[w0];
  for (int w = 1; w < nw; ++w) s = __fadd_rn(s, red[w0 + w]);
  return s;
}

// The block's stores are made: draw a ticket of `counter`, which
// `arrivals` blocks draw in all; true in the block that draws the last.
__device__ __forceinline__ bool last_to_arrive(unsigned* counter, unsigned arrivals) {
  __shared__ bool last;
  __syncthreads();  // every store of the block comes before its ticket
  if (threadIdx.x == 0) {
    // release: the block's stores, ordered before by the barrier, reach
    // every block before its ticket does; acquire: the last block sees
    // every other block's
    unsigned ticket;
    asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(counter)
                 : "memory");
    last = ticket == arrivals - 1;
  }
  __syncthreads();
  return last;
}

// Sum `n` rows of `p`, `stride` floats apart, at the V's columns from `p`
// (4 for float4, 1 for float), in row order, 8 loads in flight at a time.
template <typename V>
__device__ __forceinline__ V sum_rows(const float* p, size_t stride, int n) {
  V s = __ldcg(reinterpret_cast<const V*>(p));
  for (int j = 1; j < n; j += 8) {
    V v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (j + k < n) v[k] = __ldcg(reinterpret_cast<const V*>(p + (j + k) * stride));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (j + k < n) add(s, v[k]);
  }
  return s;
}

// The held design: rows of d columns, d % kVec == 0, on blockDim.x /
// row_threads row groups of row_threads threads; the block's partial goes
// to its row of the scratch.
template <typename DY>
__device__ __forceinline__ void held_rows(const float* __restrict__ x,
                                          const float* __restrict__ gain,
                                          const DY* __restrict__ dy, float* __restrict__ dx,
                                          float* __restrict__ scratch, int n_rows, int d,
                                          int rows_per_block, int row_threads) {
  extern __shared__ float4 smem4[];
  float* gains = reinterpret_cast<float*>(smem4);  // [d]: the gain, read each row
  float* sums = gains + d;                         // [row groups - 1][d]
  __shared__ float red_sq[kMaxWarps], red_ux[kMaxWarps];
  const int per_block = blockDim.x / row_threads;  // row groups
  const int g = threadIdx.x / row_threads, t = threadIdx.x - g * row_threads;
  const int nw = row_threads >> 5, w0 = g * nw;
  // the thread's columns: 4 from c, 4 from h + c, so that a warp's
  // accesses are contiguous
  const int c = 4 * t, h = d / 2;
  const bool inside = c < h;
  const float fd = static_cast<float>(d);
  for (int col = 4 * threadIdx.x; col < d; col += 4 * blockDim.x)
    *reinterpret_cast<float4*>(gains + col) = *reinterpret_cast<const float4*>(gain + col);
  float part[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) part[e] = 0.0f;

  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)n_rows, r0 + rows_per_block);
  const int steps = static_cast<int>((r1 - r0 + per_block - 1) / per_block);
  Cols<float> nx{};
  Cols<DY> ndy{};
  long long r = r0 + g;
  if (inside && r < r1) nx = fetch_cols(x + r * d, c, h), ndy = fetch_cols(dy + r * d, c, h);
  for (int s = 0; s < steps; ++s, r += per_block) {
    const bool active = inside && r < r1;
    float xv[kVec], dv[kVec];
    widen_cols(nx, xv);
    widen_cols(ndy, dv);
    // the group's next row, in flight while this one is reduced
    const long long next = r + per_block;
    if (inside && next < r1)
      nx = fetch_cols(x + next * d, c, h), ndy = fetch_cols(dy + next * d, c, h);

    float sq = 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) sq = __fadd_rn(sq, __fmul_rn(xv[e], xv[e]));
    // (the first barrier also publishes the staged gain)
    const float total = group_sum(active ? sq : 0.0f, red_sq, w0, nw);
    const float norm = __fsqrt_rn(__fadd_rn(__fdiv_rn(total, fd), kEps));
    // dy's last use is here, before the second barrier: u and xhat are
    // what dx needs after it
    float uv[kVec] = {};
    if (inside) load_cols(gains, c, h, uv);
    float ux = 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      xv[e] = __fdiv_rn(xv[e], norm);   // xhat from here on
      uv[e] = __fmul_rn(dv[e], uv[e]);  // u = dy * gain from here on
      ux = __fadd_rn(ux, __fmul_rn(uv[e], xv[e]));
      if (active) part[e] = __fadd_rn(part[e], __fmul_rn(dv[e], xv[e]));
    }
    const float mean_ux = __fdiv_rn(group_sum(active ? ux : 0.0f, red_ux, w0, nw), fd);
    if (active) {
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        out[e] = __fdiv_rn(__fsub_rn(uv[e], __fmul_rn(xv[e], mean_ux)), norm);
      store_cols(dx + r * d, c, h, out);
    }
  }

  // the block's column sums, its row groups' added in group order, stored
  // in its row of the scratch
  if (g > 0 && inside) store_cols(sums + (size_t)(g - 1) * d, c, h, part);
  __syncthreads();
  if (g == 0 && inside) {
    for (int k = 1; k < per_block; ++k) {
      float v[kVec];
      load_cols(sums + (size_t)(k - 1) * d, c, h, v);
#pragma unroll
      for (int e = 0; e < kVec; ++e) part[e] = __fadd_rn(part[e], v[e]);
    }
    store_cols(scratch + (size_t)blockIdx.x * d, c, h, part);
  }
}

// The strided design: rows of any d, one at a time on the whole block; the
// block's partial adds up in its row of the scratch.
template <typename DY>
__device__ __forceinline__ void strided_rows(const float* __restrict__ x,
                                             const float* __restrict__ gain,
                                             const DY* __restrict__ dy, float* __restrict__ dx,
                                             float* __restrict__ scratch, int n_rows, int d,
                                             int rows_per_block) {
  __shared__ float red_sq[kMaxWarps], red_ux[kMaxWarps];
  const int nw = blockDim.x >> 5;
  const float fd = static_cast<float>(d);
  float* part = scratch + (size_t)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) part[c] = 0.0f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)n_rows, r0 + rows_per_block);
  for (long long r = r0; r < r1; ++r) {
    const float* xr = x + r * d;
    const DY* dyr = dy + r * d;
    float sq = 0.0f;
    for (int c = threadIdx.x; c < d; c += blockDim.x) sq = __fadd_rn(sq, __fmul_rn(xr[c], xr[c]));
    const float norm = __fsqrt_rn(__fadd_rn(__fdiv_rn(group_sum(sq, red_sq, 0, nw), fd), kEps));
    float ux = 0.0f;
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      ux = __fadd_rn(ux, __fmul_rn(__fmul_rn(of::widen(dyr[c]), gain[c]), __fdiv_rn(xr[c], norm)));
    const float mean_ux = __fdiv_rn(group_sum(ux, red_ux, 0, nw), fd);
    for (int c = threadIdx.x; c < d; c += blockDim.x) {
      const float dyc = of::widen(dyr[c]);
      const float xhat = __fdiv_rn(xr[c], norm);
      const float u = __fmul_rn(dyc, gain[c]);
      dx[r * d + c] = __fdiv_rn(__fsub_rn(u, __fmul_rn(xhat, mean_ux)), norm);
      part[c] = __fadd_rn(part[c], __fmul_rn(dyc, xhat));
    }
  }
}

// The blocks' partials, each in its row of the scratch, summed into dgain
// by the tickets (see the note), V's columns a thread at a time.
template <typename V>
__device__ __forceinline__ void sum_blocks(float* __restrict__ dgain, float* __restrict__ scratch,
                                           unsigned* counters, int d, int group) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int blocks = gridDim.x, q = blockIdx.x / group, first = q * group;
  const int groups = (blocks + group - 1) / group;
  float* totals = scratch + (size_t)blocks * d;  // [groups][d]
  // the group's last block sums its blocks' rows in block order
  if (!last_to_arrive(counters + 1 + q, min(group, blocks - first))) return;
  for (int col = kW * threadIdx.x; col < d; col += kW * blockDim.x)
    __stcg(reinterpret_cast<V*>(totals + (size_t)q * d + col),
           sum_rows<V>(scratch + (size_t)first * d + col, d, min(group, blocks - first)));
  if (threadIdx.x == 0) counters[1 + q] = 0u;
  // the last group's finisher sums the groups' rows in group order
  if (!last_to_arrive(counters, groups)) return;
  for (int col = kW * threadIdx.x; col < d; col += kW * blockDim.x)
    *reinterpret_cast<V*>(dgain + col) = sum_rows<V>(totals + col, d, groups);
  if (threadIdx.x == 0) counters[0] = 0u;
}

// The strided design's rows and sum, called rather than inlined (see the
// note: the held design keeps its registers).
template <typename DY>
__device__ __noinline__ void strided(const float* __restrict__ x, const float* __restrict__ gain,
                                     const DY* __restrict__ dy, float* __restrict__ dx,
                                     float* __restrict__ dgain, float* __restrict__ scratch,
                                     unsigned* counters, int n_rows, int d, int rows_per_block,
                                     int group) {
  strided_rows(x, gain, dy, dx, scratch, n_rows, d, rows_per_block);
  sum_blocks<float>(dgain, scratch, counters, d, group);
}

// The one kernel: DY is dy's type (f32 or bf16); `is_strided` picks the
// row design, whose partials the same tickets sum (16 bytes at a time
// where the held design's aligned rows allow).
template <typename DY>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
rmsnorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gain,
                   const DY* __restrict__ dy, float* __restrict__ dx, float* __restrict__ dgain,
                   float* __restrict__ scratch, unsigned* counters, int n_rows, int d,
                   int rows_per_block, int row_threads, int group, bool is_strided) {
  if (is_strided) {
    strided(x, gain, dy, dx, dgain, scratch, counters, n_rows, d, rows_per_block, group);
    return;
  }
  held_rows(x, gain, dy, dx, scratch, n_rows, d, rows_per_block, row_threads);
  sum_blocks<float4>(dgain, scratch, counters, d, group);
}

// The launch for a shape and alignment, on the current device.
struct Plan {
  int blocks = 0, groups = 0, group = 0, threads = 0, row_threads = 0, rows_per_block = 0;
  bool strided = false;
  size_t smem = 0;  // the held design's gain and row groups' column sums
};

cudaError_t make_plan(int n_rows, int d, bool aligned, Plan* plan) {
  if (n_rows < 1 || d < 1) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  Plan p;
  p.strided = !aligned || d % kVec != 0 || d > kVec * kMaxWarps * 32;
  // the held design's threads a row, rounded up to warps; the strided
  // design's block, one row at a time
  p.row_threads = p.strided ? std::min(kBlockThreads, 32 * ((d + 31) / 32))
                            : 32 * ((d / kVec + 31) / 32);
  const int per_block = p.strided ? 1 : std::max(1, kBlockThreads / p.row_threads);  // rows a step
  p.threads = per_block * p.row_threads;
  // 64 registers a thread: 65,536 registers an SM hold 1024 threads' worth
  const long long resident = (long long)sms * std::max(1, kMaxWarps * 32 / p.threads);
  // a step of rows for every block, at most the card's worth; more blocks,
  // in waves, where a thread would chain more than kMaxChain rows into its
  // column sums
  const long long rows = n_rows;
  const long long steps = (rows + per_block - 1) / per_block;
  const long long chained = (long long)per_block * kMaxChain;
  const long long blocks = std::max(std::min(resident, steps), (rows + chained - 1) / chained);
  p.rows_per_block = static_cast<int>((rows + blocks - 1) / blocks);
  p.blocks = static_cast<int>((rows + p.rows_per_block - 1) / p.rows_per_block);
  int group = 1;
  while (group * group < p.blocks) ++group;
  p.group = std::max(group, (p.blocks + kMaxGroups - 1) / kMaxGroups);
  p.groups = (p.blocks + p.group - 1) / p.group;
  p.smem = p.strided ? 0 : sizeof(float) * (size_t)per_block * d;
  *plan = p;
  return cudaSuccess;
}

template <typename DY>
int launch(const void* x, const void* gain, const void* dy, void* dx, void* dgain, void* scratch,
           void* counters, int n_rows, int d, void* stream) {
  Plan p;
  cudaError_t err = make_plan(n_rows, d, of::aligned16(x, gain, dy, dx, dgain), &p);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_kernel<DY><<<p.blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gain), static_cast<const DY*>(dy),
      static_cast<float*>(dx), static_cast<float*>(dgain), static_cast<float*>(scratch),
      static_cast<unsigned*>(counters), n_rows, d, p.rows_per_block, p.row_threads, p.group,
      p.strided);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* of_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The ints of the counters, 0 between launches.
int rmsnorm_bwd_counters(void) { return 1 + kMaxGroups; }

// The launch for [n_rows, d] on the current device, where `aligned` says
// whether x, gain, dy, dx and dgain all lie on 16-byte boundaries: plan[0],
// its blocks, and plan[1], their groups; its scratch is f32 [plan[0] +
// plan[1], d].
int rmsnorm_bwd_plan(int n_rows, int d, int aligned, int* plan) {
  Plan p;
  const cudaError_t err = make_plan(n_rows, d, aligned != 0, &p);
  plan[0] = p.blocks;
  plan[1] = p.groups;
  return err;
}

// x, dx: f32 [n_rows, d] contiguous; dy: f32 (or bf16 for _bf16) [n_rows,
// d]; gain, dgain: f32 [d]; scratch: f32 as rmsnorm_bwd_plan says for
// these pointers; counters: rmsnorm_bwd_counters() ints of this device's,
// 0 before the launch and after it.  One launch.
int rmsnorm_bwd_f32(const void* x, const void* gain, const void* dy, void* dx, void* dgain,
                    void* scratch, void* counters, int n_rows, int d, void* stream) {
  return launch<float>(x, gain, dy, dx, dgain, scratch, counters, n_rows, d, stream);
}

int rmsnorm_bwd_bf16(const void* x, const void* gain, const void* dy, void* dx, void* dgain,
                     void* scratch, void* counters, int n_rows, int d, void* stream) {
  return launch<__nv_bfloat16>(x, gain, dy, dx, dgain, scratch, counters, n_rows, d, stream);
}

}  // extern "C"
