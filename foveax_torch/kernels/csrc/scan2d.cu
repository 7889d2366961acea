// Summed-area table (SAT) build, whole and row-selected.
//
// K5 fvx_sat_build replaces foveax/kernels/scan2d.py:_sat_kernel (via
//    build_sat_pallas): out[c, y, x] = sum of frame[c, y', x'] over
//    y' <= y, x' <= x, mod 2^32, for a uint8 frame given by its (channel,
//    row, column) strides, so (H, W, 3) and (3, H, W) both go in as they
//    are.
// K6 fvx_sat_select_rows replaces foveax/kernels/fused_select.py:_make_kernel
//    (via sat_select_rows): for an (H, 3, W) uint8 frame and non-decreasing
//    row lists pyc, pymc of length n in [0, H), sel[0, j] = SAT row pyc[j]
//    and sel[1, j] = SAT row pymc[j], each (3, W), without writing the SAT.
//
// The TPU kernels scan rows with float32 triangular-matrix products on the
// MXU (exact below 2^24, with bf16 limb splits and an int8 variant), in
// 128-lane chunks, and carry the column totals across a sequential grid of
// 8-row blocks.  Here every sum is a uint32_t add: unsigned overflow is
// defined in C++ and is exactly the SAT's mod-2^32 wrap, so the same bits
// come out with no limbs, no lane quanta and no row-block constraint.
//
// Both kernels have the same two passes (two launches per call):
//   1. a column pass: one thread per (channel, column) walks down the rows,
//      keeping the running column sum; neighbouring threads touch
//      neighbouring columns, so loads and stores coalesce.  K5 writes every
//      running sum into the output; K6 walks two cursors over pyc and pymc
//      (as the TPU kernel walks its two SMEM cursors) and writes the running
//      sums only at the selected rows, duplicates included.
//   2. a row pass, in place: one block per (channel, row) scans the row's
//      column sums (warp shuffles, then the warp totals in shared memory),
//      carried across the block's chunks of the row.
// The SAT is the row scan of the column cumsum: the two scans commute
// mod 2^32.
//
// Bound on this card: bytes.  The bound counts the uint8 frame read once
// and the uint32 output written once (K5 at 4K: 124 MB).  The two passes
// move more: the column pass writes the output and the row pass reads and
// writes it again (K5 at 4K: 323 MB).  A one-pass design, row bands in
// shared memory with a carry across bands, is later work; this is the
// simple first version.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kColumnThreads = 64;  // 3 * W threads in all: keep blocks small
constexpr int kUnroll = 16;         // row loads in flight per thread
constexpr int kScanThreads = 512;
constexpr int kScanWarps = kScanThreads / 32;

// Running sum of one column: acc += src[r * row_stride] for r in [0, rows),
// emit(r, acc) after each row.  The loads of kUnroll rows are issued before
// their sums, so each thread keeps several loads in flight.
template <class Emit>
__device__ __forceinline__ void column_walk(const uint8_t* __restrict__ src,
                                            ptrdiff_t row_stride, int rows,
                                            Emit emit) {
  uint32_t acc = 0;
  int r = 0;
  for (; r + kUnroll <= rows; r += kUnroll) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) v[k] = src[(r + k) * row_stride];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      acc += v[k];
      emit(r + k, acc);
    }
  }
  for (; r < rows; ++r) {
    acc += src[r * row_stride];
    emit(r, acc);
  }
}

// K5 pass 1. grid: (ceil(w / kColumnThreads), 3).
__global__ void sat_columns_kernel(const uint8_t* __restrict__ frame,
                                   int c_stride, int r_stride, int x_stride,
                                   uint32_t* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int c = blockIdx.y;
  const uint8_t* src =
      frame + (ptrdiff_t)c * c_stride + (ptrdiff_t)x * x_stride;
  uint32_t* dst = out + (ptrdiff_t)c * h * w + x;
  column_walk(src, r_stride, h,
              [&](int r, uint32_t acc) { dst[(ptrdiff_t)r * w] = acc; });
}

// K6 pass 1. grid: (ceil(w / kColumnThreads), 3).  sel is (2, n, 3, w):
// sel[0] the pyc rows, sel[1] the pymc rows; n >= 1.  Each cursor keeps
// its next row in a register, so a row that selects nothing costs one
// compare.  The walk stops after the last selected row.  `<=` keeps every
// cursor moving even for a list out of contract; within the contract it
// is the `==` of the TPU kernel.
__global__ void select_columns_kernel(const uint8_t* __restrict__ frame,
                                      const int32_t* __restrict__ pyc,
                                      const int32_t* __restrict__ pymc,
                                      uint32_t* __restrict__ sel, int h,
                                      int w, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int c = blockIdx.y;
  const ptrdiff_t row = 3 * (ptrdiff_t)w;
  const uint8_t* src = frame + (ptrdiff_t)c * w + x;
  uint32_t* hi = sel + (ptrdiff_t)c * w + x;
  uint32_t* lo = hi + n * row;
  const int rows = min(max(pyc[n - 1], pymc[n - 1]) + 1, h);
  int jh = 0, jl = 0;
  int next_hi = pyc[0], next_lo = pymc[0];
  column_walk(src, row, rows, [&](int r, uint32_t acc) {
    while (next_hi <= r) {
      hi[jh * row] = acc;
      next_hi = ++jh < n ? pyc[jh] : INT_MAX;
    }
    while (next_lo <= r) {
      lo[jl * row] = acc;
      next_lo = ++jl < n ? pymc[jl] : INT_MAX;
    }
  });
}

// Pass 2 of both. grid: (number of rows,).  Inclusive scan of each row of
// `rows` (rows of w uint32), in place.
__global__ void __launch_bounds__(kScanThreads)
    row_scan_kernel(uint32_t* __restrict__ rows, int w) {
  __shared__ uint32_t warp_sum[kScanWarps];
  uint32_t* row = rows + (ptrdiff_t)blockIdx.x * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t carry = 0;
  for (int base = 0; base < w; base += kScanThreads) {
    const int x = base + threadIdx.x;
    uint32_t v = x < w ? row[x] : 0u;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t t = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += t;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      uint32_t s = lane < kScanWarps ? warp_sum[lane] : 0u;
#pragma unroll
      for (int d = 1; d < kScanWarps; d <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += t;
      }
      if (lane < kScanWarps) warp_sum[lane] = s;
    }
    __syncthreads();
    if (warp > 0) v += warp_sum[warp - 1];
    if (x < w) row[x] = v + carry;
    carry += warp_sum[kScanWarps - 1];
    __syncthreads();  // warp_sum is rewritten by the next chunk
  }
}

}  // namespace

extern "C" int fvx_sat_build(const void* frame, int c_stride, int r_stride,
                             int x_stride, void* out, int h, int w,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((w + kColumnThreads - 1) / kColumnThreads, 3);
  sat_columns_kernel<<<grid, kColumnThreads, 0, s>>>(
      (const uint8_t*)frame, c_stride, r_stride, x_stride, (uint32_t*)out, h,
      w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_scan_kernel<<<3 * h, kScanThreads, 0, s>>>((uint32_t*)out, w);
  return (int)cudaGetLastError();
}

extern "C" int fvx_sat_select_rows(const void* frame, const void* pyc,
                                   const void* pymc, void* sel, int h, int w,
                                   int n, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((w + kColumnThreads - 1) / kColumnThreads, 3);
  select_columns_kernel<<<grid, kColumnThreads, 0, s>>>(
      (const uint8_t*)frame, (const int32_t*)pyc, (const int32_t*)pymc,
      (uint32_t*)sel, h, w, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  row_scan_kernel<<<2 * n * 3, kScanThreads, 0, s>>>((uint32_t*)sel, w);
  return (int)cudaGetLastError();
}
