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
// to rtol 1e-5 and atol 1e-6 of each output's max.  A bf16 dy (the grid
// path's second entry) is widened exactly in registers: the bits of the
// f32 entry on dy widened first.
//
// Bound on an H100 SXM: x read, dy read, dx written once, gain and dgain
// beside them.  At DemoConfig()'s [512, 128] in f32, 786,432 B: 0.235 us at
// 3.35 TB/s, against some 11 f32 operations an element at 67 TFLOP/s,
// 0.011 us; bound by one launch.  At the benchmark's train shapes,
// Pythia-1.4B's [8192, 2048] and GPT-2 medium's [16384, 1024] (16.8 M
// values each) with dy in bf16, 10 bytes a value, 168 MB: 0.050 ms,
// against 0.003 ms of operations; bound by bytes.
//
// Two paths, one algorithm with two sets of parameters; the wrapper picks
// by shape (`rmsnorm_bwd_grid_plan`) and alignment.
//
// The grid path: rows of d columns, d a multiple of 8 up to 8192, 16-byte
// aligned tensors, and at least one step of rows (below) for every block
// of a grid that fills the card: 1024 / threads blocks an SM (the launch
// bounds hold a thread to 64 registers, so that many fit), the SM count
// read from the device; more blocks, in waves, where a thread would
// otherwise chain more than kMaxChain rows into its column sums, whose
// rounding grows with the chain.  A thread owns 8 fixed columns of the
// row, 4 from c = 4 t and 4 from d / 2 + c, so that each of a warp's
// loads and stores is contiguous; a row takes ceil(d / 256) warps, and a
// block of up to 512 threads takes several rows at a time, one a row
// group.  Block b takes the contiguous rows [b R, (b + 1) R),
// R = ceil(rows / blocks).  Each row is read once into registers and dx
// written once: no second pass over memory.  The next row's x and dy are
// loaded before this row's sums, so loads stay in flight across the row's
// two block barriers; the gain, staged once a block in shared memory, is
// read there each row, which keeps a thread within its 64 registers.  A
// row's two sums, sum(x^2) and sum(u * xhat), are each thread's 8 values
// in order, a warp's butterfly, then the row group's warps in warp order
// through a word a warp of shared memory.  dgain's partial lives in
// registers: a thread adds dy * xhat of its 8 columns over its rows in row
// order, and a block adds its row groups' in group order.  Each block
// stores its [d] partial to a scratch [blocks + groups, d] from the
// wrapper, then the blocks meet in groups of about sqrt(blocks): each
// takes an integer ticket of its group's counter (an atomic add that
// releases the block's stores and acquires the others'), and the group's
// last block sums its members' partials in block order and stores the
// group's; then it takes a ticket of the launch's counter, and the last
// group's finisher sums the groups' in group order and writes dgain.  Two
// levels keep each finisher's reads to about sqrt(blocks) rows of d.  Each
// finisher sets its counter back to 0, so the next launch or a graph's
// replay finds every counter at 0.  Every sum runs in a fixed order that
// does not depend on which block finishes last: a call repeats bit for
// bit, with no float atomics.  The counters belong to the device: two
// launches on two streams of one device at once would share them, and
// must not run together.
//
// The cluster path, every other shape (DemoConfig()'s [512, 128] among
// them, too few rows for a grid): one cluster of C = 16 blocks
// (non-portable: the most Hopper takes, and faster on an H100 than the
// portable 8), one launch, no scratch in device memory and no atomics.
// Block r of the cluster takes rows [r R, (r + 1) R), R = ceil(rows / C),
// split into contiguous runs among up to 32 warps; a warp takes one row at
// a time.  A row of up to 128 columns (a multiple of 4: the model's widths)
// sits in registers, read and written 16 bytes a lane at a time, so its
// loads go out together; a wider or odd row is strided by the lanes in
// three passes, the later two finding it in L1.  A row of more than
// kMaxCols columns takes one launch a window of columns: each launch
// reduces every row whole (the norm and mean(u * xhat) need it) and writes
// dx and dgain of its window, so the column sums stay within shared memory
// at any width.  Windows also narrow until enough warps fit that none
// chains more than kMaxChain rows into its f32 column sums, whose rounding
// grows with the chain (as long as 32 warps a block suffice).
// The warp writes dx and adds dy * xhat into its own f32 column sums in
// shared memory, in row order.  Then the block adds its warps' sums in
// warp order and stores each column's total into the shared memory of the
// block that owns the column (distributed shared memory, `map_shared_rank`),
// one slot per sending block; one `cluster.sync()` publishes the stores,
// and each block sums its columns' C slots in rank order and writes dgain.
// A barrier arrival at the start, awaited before the stores, makes sure
// every block of the cluster runs before another writes into it.  Storing
// into the owner, rather than reading from every block, needs one cluster
// barrier and no remote load, whose latency would come in series.
//
// Offsets are 64-bit on both paths.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;
constexpr int kMaxWarps = 32;
constexpr int kMaxCols = 16384;  // the widest window of columns a launch takes
constexpr int kMaxChain = 1024;  // the most rows a warp's column sums should chain
constexpr float kEps = 1e-6f;
// the grid path
constexpr int kVec = 8;             // the columns a thread owns
constexpr int kBlockThreads = 512;  // a block's threads where a row takes fewer
constexpr int kMaxGroups = 64;      // the most groups of blocks, a counter each

enum Path { kClusterAny, kClusterRegisters, kGrid };

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

// ---- the cluster path ----------------------------------------------------

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
__device__ __forceinline__ void cluster_rows(const float* __restrict__ x,
                                             const float* __restrict__ gain,
                                             const float* __restrict__ dy, float* __restrict__ dx,
                                             float* __restrict__ dgain, int n_rows, int d, int c0,
                                             int dc, int rows_per_block) {
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

// ---- the grid path -------------------------------------------------------

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

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                  __fadd_rn(s.w, v.w));
}

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

// Sum `n` rows of `p`, `stride` floats apart, at 4 columns from `p`, in
// row order, 8 loads in flight at a time.
__device__ __forceinline__ float4 sum_rows(const float* p, size_t stride, int n) {
  float4 s = __ldcg(reinterpret_cast<const float4*>(p));
  for (int j = 1; j < n; j += 8) {
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (j + k < n) v[k] = __ldcg(reinterpret_cast<const float4*>(p + (j + k) * stride));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (j + k < n) add4(s, v[k]);
  }
  return s;
}

// Rows of d columns, d % kVec == 0, on blockDim.x / row_threads row groups
// of row_threads threads; blocks of `group` meet in groups (see the note).
template <typename DY>
__device__ __forceinline__ void grid_rows(const float* __restrict__ x,
                                          const float* __restrict__ gain,
                                          const DY* __restrict__ dy, float* __restrict__ dx,
                                          float* __restrict__ dgain, float* __restrict__ scratch,
                                          unsigned* counters, int n_rows, int d,
                                          int rows_per_block, int row_threads, int group) {
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
    float gv[kVec] = {};
    if (inside) load_cols(gains, c, h, gv);
    float ux = 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      xv[e] = __fdiv_rn(xv[e], norm);  // xhat from here on
      ux = __fadd_rn(ux, __fmul_rn(__fmul_rn(dv[e], gv[e]), xv[e]));
    }
    const float mean_ux = __fdiv_rn(group_sum(active ? ux : 0.0f, red_ux, w0, nw), fd);
    if (active) {
      float out[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float u = __fmul_rn(dv[e], gv[e]);
        out[e] = __fdiv_rn(__fsub_rn(u, __fmul_rn(xv[e], mean_ux)), norm);
        part[e] = __fadd_rn(part[e], __fmul_rn(dv[e], xv[e]));
      }
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

  // the group's last block sums its blocks' rows in block order
  const int blocks = gridDim.x, q = blockIdx.x / group, first = q * group;
  const int groups = (blocks + group - 1) / group;
  float* totals = scratch + (size_t)blocks * d;  // [groups][d]
  if (!last_to_arrive(counters + 1 + q, min(group, blocks - first))) return;
  for (int col = 4 * threadIdx.x; col < d; col += 4 * blockDim.x)
    __stcg(reinterpret_cast<float4*>(totals + (size_t)q * d + col),
           sum_rows(scratch + (size_t)first * d + col, d, min(group, blocks - first)));
  if (threadIdx.x == 0) counters[1 + q] = 0u;
  // the last group's finisher sums the groups' rows in group order
  if (!last_to_arrive(counters, groups)) return;
  for (int col = 4 * threadIdx.x; col < d; col += 4 * blockDim.x)
    *reinterpret_cast<float4*>(dgain + col) = sum_rows(totals + col, d, groups);
  if (threadIdx.x == 0) counters[0] = 0u;
}

// The one kernel of both paths: kPath picks, DY is dy's type (f32, or
// bf16 on the grid path).  The cluster path reads c0 and dc, the grid
// path scratch, counters, row_threads and group.
template <int kPath, typename DY>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
rmsnorm_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gain,
                   const DY* __restrict__ dy, float* __restrict__ dx, float* __restrict__ dgain,
                   float* __restrict__ scratch, unsigned* counters, int n_rows, int d,
                   int rows_per_block, int c0, int dc, int row_threads, int group) {
  if constexpr (kPath == kGrid) {
    grid_rows(x, gain, dy, dx, dgain, scratch, counters, n_rows, d, rows_per_block, row_threads,
              group);
  } else {
    static_assert(sizeof(DY) == sizeof(float), "the cluster path reads f32 dy");
    cluster_rows<kPath == kClusterRegisters>(x, gain, dy, dx, dgain, n_rows, d, c0, dc,
                                             rows_per_block);
  }
}

template <bool kInRegisters>
cudaError_t launch_cluster(const float* x, const float* gain, const float* dy, float* dx,
                           float* dgain, int n_rows, int d, int c0, int dc, cudaStream_t stream) {
  const auto entry = rmsnorm_bwd_kernel<kInRegisters ? kClusterRegisters : kClusterAny, float>;
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
  err = cudaLaunchKernelEx(&config, entry, x, gain, dy, dx, dgain, (float*)nullptr,
                           (unsigned*)nullptr, n_rows, d, rows_per_block, c0, dc, 0, 0);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The grid path's launch for a shape, on the current device: no blocks
// where the cluster path takes the shape.
struct Plan {
  int blocks = 0, groups = 0, group = 0, threads = 0, row_threads = 0, rows_per_block = 0;
  size_t smem = 0;  // the gain and the row groups' column sums
};

cudaError_t grid_plan(int n_rows, int d, Plan* plan) {
  *plan = Plan{};
  if (n_rows < 1 || d < 1 || d % kVec != 0 || d > kVec * kMaxWarps * 32) return cudaSuccess;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int row_threads = 32 * ((d / kVec + 31) / 32);
  const int per_block = std::max(1, kBlockThreads / row_threads);  // row groups a block
  const int threads = per_block * row_threads;
  // 64 registers a thread: 65,536 registers an SM hold 1024 threads' worth
  const int resident = sms * std::max(1, kMaxWarps * 32 / threads);
  // every block a step of rows at least, else the cluster path
  if (n_rows < resident * per_block) return cudaSuccess;
  // more blocks, in waves, where a thread would chain more than kMaxChain
  // rows into its column sums
  const long long chained = (long long)per_block * kMaxChain;
  const long long rows = n_rows;
  const long long blocks = std::max((long long)resident, (rows + chained - 1) / chained);
  Plan p;
  p.rows_per_block = static_cast<int>((rows + blocks - 1) / blocks);
  p.blocks = static_cast<int>((rows + p.rows_per_block - 1) / p.rows_per_block);
  int group = 1;
  while (group * group < p.blocks) ++group;
  p.group = std::max(group, (p.blocks + kMaxGroups - 1) / kMaxGroups);
  p.groups = (p.blocks + p.group - 1) / p.group;
  p.threads = threads;
  p.row_threads = row_threads;
  p.smem = sizeof(float) * (size_t)per_block * d;
  *plan = p;
  return cudaSuccess;
}

template <typename DY>
int launch_grid(const void* x, const void* gain, const void* dy, void* dx, void* dgain,
                void* scratch, void* counters, int n_rows, int d, void* stream) {
  Plan p;
  cudaError_t err = grid_plan(n_rows, d, &p);
  if (err != cudaSuccess) return err;
  if (p.blocks == 0) return cudaErrorInvalidValue;
  rmsnorm_bwd_kernel<kGrid, DY>
      <<<p.blocks, p.threads, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gain), static_cast<const DY*>(dy),
      static_cast<float*>(dx), static_cast<float*>(dgain), static_cast<float*>(scratch),
      static_cast<unsigned*>(counters), n_rows, d, p.rows_per_block, 0, 0, p.row_threads,
      p.group);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* of_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The blocks of the cluster the cluster path runs on.
int rmsnorm_bwd_cluster(void) { return kCluster; }

// The ints of the grid path's counters, 0 between launches.
int rmsnorm_bwd_grid_counters(void) { return 1 + kMaxGroups; }

// Whether the grid path takes [n_rows, d] on the current device:
// plan[0], its blocks (0 where the cluster path takes the shape), and
// plan[1], their groups; its scratch is f32 [plan[0] + plan[1], d].
// Alignment is the caller's to check.
int rmsnorm_bwd_grid_plan(int n_rows, int d, int* plan) {
  Plan p;
  const cudaError_t err = grid_plan(n_rows, d, &p);
  plan[0] = p.blocks;
  plan[1] = p.groups;
  return err;
}

// The grid path.  x, dx: f32 [n_rows, d]; dy: f32 (or bf16 for _bf16)
// [n_rows, d]; gain, dgain: f32 [d]; all 16-byte aligned; scratch: f32 as
// rmsnorm_bwd_grid_plan says; counters: rmsnorm_bwd_grid_counters() ints
// of this device's, 0 before the launch and after it.  One launch.
int rmsnorm_bwd_grid_f32(const void* x, const void* gain, const void* dy, void* dx, void* dgain,
                         void* scratch, void* counters, int n_rows, int d, void* stream) {
  return launch_grid<float>(x, gain, dy, dx, dgain, scratch, counters, n_rows, d, stream);
}

int rmsnorm_bwd_grid_bf16(const void* x, const void* gain, const void* dy, void* dx, void* dgain,
                          void* scratch, void* counters, int n_rows, int d, void* stream) {
  return launch_grid<__nv_bfloat16>(x, gain, dy, dx, dgain, scratch, counters, n_rows, d,
                                    stream);
}

// The cluster path.  x, dy, dx: f32 [n_rows, d] contiguous; gain, dgain:
// f32 [d].  Writes dx and dgain: one launch for rows of up to kMaxCols
// columns, else one launch a window of at most kMaxCols columns.  Returns
// the launches' status.
int rmsnorm_bwd_f32(const void* x, const void* gain, const void* dy, void* dx, void* dgain,
                    int n_rows, int d, void* stream) {
  if (n_rows < 1 || d < 1) return cudaErrorInvalidValue;
  const auto run = d % 4 == 0 && d <= 128 && of::aligned16(x, gain, dy, dx)
                       ? launch_cluster<true>
                       : launch_cluster<false>;
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
