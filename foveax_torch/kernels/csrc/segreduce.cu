// Fused segment-reduce sampler: the gaze-centred log-rectilinear box filter,
// for a batch of N gazes over one frame.
//
// fvx_segment_reduce_xy, the fused path's sampler, replaces both TPU passes,
//    foveax/kernels/segreduce.py:251 _y_kernel and :511 _x_kernel, in one
//    launch: out[g, c, j, i] = floor(box / (dy * dx)), box the sum of
//    frame[c, (pymc, pyc], (pxmc, pxc]] of gaze g's row j and column i, 0
//    where !(valid_x[g, i] && valid_y[g, j]).  Its design note is above the
//    kernel below.
// K1 and K2 are the two passes as separate kernels, the counterparts of the
// JAX package's two public pass functions; no path of the port launches them.
//
// K1 fvx_y_segment_reduce replaces foveax/kernels/segreduce.py:_y_kernel
//    (via y_segment_reduce_batch): out[g, c, j, x] = sum of frame rows
//    (pmc[g, j], pc[g, j]] of column x, as a 16-bit row sum.
// K2 fvx_x_segment_reduce replaces foveax/kernels/segreduce.py:_x_kernel
//    (via x_segment_reduce_batch): out[g, c, j, i] = floor(box / (dy * dx))
//    with box the sum of row sums (pxmc[g, i], pxc[g, i]], 0 where
//    !(valid_x[g, i] && valid_y[g, j]).
//
// The TPU kernels reach these integers through one-hot MXU dots over
// gaze-positioned DMA windows, bf16 limbs, 128-lane quanta and a 360 wrap
// pad.  Here every tap is an indexed load: the clamp rule of the taps
// (pc in [1, dim-1], pmc in [0, pc-1]) keeps every interval inside the
// frame, so no wrap pad is read and nothing escapes a window.  Source row
// 0 and column 0 never enter a box, as in the reference.
//
// Bound on this card: bytes.  K1 reads the frame once and writes the
// (N, 3, Hr, W) uint16 row sums; K2 reads those once and writes the
// (N, 3, Hr, Wr) uint8 frame.  The row sums are uint16 (half the bytes of
// int32): the host checks 255 * max(dy) < 2^16.  The division is exact
// unsigned integer division, which is what the TPU kernel's float estimate
// plus one-step fixup computes.  This is the simple first version: one
// thread per output element, plain loads; making it fast is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// grid: (ceil(w / kThreads), hr, n * 3); plane = g * 3 + c.
__global__ void y_segment_reduce_kernel(
    const uint8_t* __restrict__ frame, const int32_t* __restrict__ pc,
    const int32_t* __restrict__ pmc, uint16_t* __restrict__ out,
    int h, int w, int hr) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= w) return;
  const int j = blockIdx.y;
  const int plane = blockIdx.z;
  const int g = plane / 3;
  const int c = plane - 3 * g;
  const int hi = pc[g * hr + j];
  const int lo = pmc[g * hr + j];
  const uint8_t* src = frame + (size_t)c * h * w + x;
  int acc = 0;
  for (int r = lo + 1; r <= hi; ++r) acc += src[(size_t)r * w];
  out[((size_t)plane * hr + j) * w + x] = (uint16_t)acc;
}

// grid: (ceil(wr / kThreads), hr, n * 3); plane = g * 3 + c.
__global__ void x_segment_reduce_kernel(
    const uint16_t* __restrict__ rows, const int32_t* __restrict__ pxc,
    const int32_t* __restrict__ pxmc, const bool* __restrict__ valid_x,
    const int32_t* __restrict__ pyc, const int32_t* __restrict__ pymc,
    const bool* __restrict__ valid_y, uint8_t* __restrict__ out,
    int hr, int w, int wr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wr) return;
  const int j = blockIdx.y;
  const int plane = blockIdx.z;
  const int g = plane / 3;
  const int xi = g * wr + i;
  const int yj = g * hr + j;
  uint8_t v = 0;
  if (valid_x[xi] && valid_y[yj]) {
    const int hi = pxc[xi];
    const int lo = pxmc[xi];
    const uint16_t* src = rows + ((size_t)plane * hr + j) * w;
    uint32_t box = 0;
    for (int x = lo + 1; x <= hi; ++x) box += src[x];
    const uint32_t rect = (uint32_t)(pyc[yj] - pymc[yj]) * (uint32_t)(hi - lo);
    v = (uint8_t)(box / rect);
  }
  out[((size_t)plane * hr + j) * wr + i] = v;
}

// fvx_segment_reduce_xy: both passes in one kernel, the row sums kept on chip.
//
// Bound on this card: bytes.  The function reads the frame (3*H*W) and the
// six tap vectors and writes the reduced frames (N*3*Hr*Wr): at 4K
// (3840x2160 -> 2144x1200, one gaze) 24.88 + 0.03 + 7.72 = 32.63 MB, 0.0097
// ms at 3.35 TB/s.  Its operations, one add per summed byte and a division
// per box, about 50 M, take 0.0008 ms at 67 TFLOP/s.  K1 + K2 also write the
// (N, 3, Hr, W) uint16 row sums and read them back: 87.9 MB at 4K.
//
// Design.  A block owns one gaze and a band of R output rows (the caller's
// R).  Its T threads split a source row into ceil(W / 16) chunks of 16
// columns, K adjacent chunks each (K = 1 up to W = 8192, then 2, 4, 8), T =
// ceil(chunks / K) rounded up to a warp, at most 512: 256 at 4K.
// - It loads the gaze's column taps once, four columns' loads in flight per
//   thread, packs each as (pxmc << 16) | dx, dx = pxc - pxmc (0 where the
//   column is invalid; a valid dx is >= 1), into shared memory, transposed
//   so that the threads of a warp read consecutive words, and reuses them
//   for every row and channel of the band.
// - For output row j and each channel in turn, every thread sums its
//   columns over source rows (pymc[j], pyc[j]] in uint32 registers, one
//   16-byte load per row and chunk where the row start is 16-byte aligned
//   (every row when W % 16 == 0 and the frame is aligned), narrower loads
//   where it is not, byte loads for the ragged tail chunk.  Four rows'
//   loads are issued before any is summed, so their latencies overlap.  A
//   row with valid_y[j] false reads nothing and writes zeros.
// - A block scan turns the row's column sums into the inclusive prefix S
//   over the W columns in shared memory (one pad word per 16 columns, see
//   slot()), so each output column is two shared reads, box = S[pxc] -
//   S[pxmc]: right for overlapping, non-monotone and seam-wrapped intervals
//   alike.  No column window is staged: across the seam one strip's
//   intervals span most of the row.
// - Each thread then writes 16 consecutive output bytes of the row with one
//   16-byte store where the row start allows it, narrower stores elsewhere.
// The uint16 row sums never exist: the sums are uint32, so the kernel needs
// no 255 * dy < 2^16 bound.  S and box are taken mod 2^32, which is exact
// while 255 * dy * dx < 2^32; the division is exact unsigned division, as
// K2's.  The taps hold pxmc in 16 bits: W <= 65,536 (the wrapper's
// shared-memory bound keeps W below 55,000).
//
// What bounds it (chip runs on an H100, PERF.md): not the bytes.  Builds
// that each dropped one phase showed the exact divisions, the row loads,
// the block scan and a per-block floor (tap fill, barriers) each taking a
// sizeable share; a block's rows and channels run one after another, two
// barriers each, so few warps per SM are ready at a time.

constexpr int kChunk = 16;  // source columns per chunk, output columns per group
constexpr int kRows = 4;    // rows whose loads are issued before any is summed
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;

// 16 bytes at p, or its first `avail` (< 16) bytes, zero-filled; the widest
// loads the address allows.
__device__ __forceinline__ uint4 load_chunk(const uint8_t* p, int avail) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (avail >= kChunk) {
    if ((a & 15) == 0) return __ldg(reinterpret_cast<const uint4*>(p));
    if ((a & 7) == 0) {
      const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
      const uint2 y = __ldg(reinterpret_cast<const uint2*>(p + 8));
      return make_uint4(x.x, x.y, y.x, y.y);
    }
    if ((a & 3) == 0) {
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
      return make_uint4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
    }
  }
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < kChunk; ++b)
    if (b < avail) v[b / 4] |= (uint32_t)__ldg(p + b) << (8 * (b % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void add_bytes(uint32_t* acc, uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[4 * q + b] += (w[q] >> (8 * b)) & 0xffu;
}

// Write 16 output bytes (the low byte of each q), or the first `avail`.
__device__ __forceinline__ void store_group(uint8_t* dst, const uint32_t* q,
                                            int avail) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = __byte_perm(__byte_perm(q[4 * k], q[4 * k + 1], 0x0040),
                       __byte_perm(q[4 * k + 2], q[4 * k + 3], 0x0040), 0x5410);
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (avail >= kChunk && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  } else if (avail >= kChunk && (a & 3) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) reinterpret_cast<uint32_t*>(dst)[k] = w[k];
  } else {
#pragma unroll
    for (int b = 0; b < kChunk; ++b)
      if (b < avail) dst[b] = (uint8_t)(w[b / 4] >> (8 * (b % 4)));
  }
}

// Where column x's prefix lives in shared memory: one pad word after every
// 16 columns, so that the lanes of a warp, whose boxes lie 16 columns apart,
// read distinct banks where dx = 1 (gcd(dx, 32)-way conflicts elsewhere).
__device__ __forceinline__ uint32_t slot(uint32_t x) { return x + (x >> 4); }

// grid: (ceil(hr / rows), n).  Dynamic shared memory (words): the warp
// totals (kMaxWarps), the prefix S (17 * chunks, see slot()), then the
// packed taps (16 * groups).
template <int K>
__global__ void __launch_bounds__(kMaxThreads) segment_reduce_xy_kernel(
    const uint8_t* __restrict__ frame, const int32_t* __restrict__ pxc,
    const int32_t* __restrict__ pxmc, const bool* __restrict__ valid_x,
    const int32_t* __restrict__ pyc, const int32_t* __restrict__ pymc,
    const bool* __restrict__ valid_y, uint8_t* __restrict__ out, int h,
    int w, int hr, int wr, int rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int chunks = (w + kChunk - 1) / kChunk;
  const int groups = (wr + kChunk - 1) / kChunk;
  uint32_t* s_warp = smem;                              // [kMaxWarps]
  uint32_t* s_prefix = smem + kMaxWarps;                // [17 * chunks]
  uint32_t* s_tap = s_prefix + (kChunk + 1) * chunks;  // [16][groups]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = blockIdx.y;
  const int j0 = blockIdx.x * rows;
  const int items = 3 * min(rows, hr - j0);  // (row, channel), channel fastest

  const int32_t* gxc = pxc + (size_t)g * wr;
  const int32_t* gxmc = pxmc + (size_t)g * wr;
  const bool* gvx = valid_x + (size_t)g * wr;
  for (int i0 = tid; i0 < groups * kChunk; i0 += 4 * nthreads) {
    int32_t hi[4], lo[4];
    bool ok[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nthreads;
      const bool in = i < wr;
      ok[u] = in ? gvx[i] : false;
      hi[u] = in ? gxc[i] : 0;
      lo[u] = in ? gxmc[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * nthreads;
      if (i < groups * kChunk)
        s_tap[(i % kChunk) * groups + i / kChunk] =
            ok[u] ? (uint32_t)lo[u] << 16 | (uint32_t)(hi[u] - lo[u]) : 0u;
    }
  }
  __syncthreads();

  const int c0 = tid * K;             // this thread's first chunk
  const int avail = w - c0 * kChunk;  // source columns from its first chunk on
  const int32_t* gyc = pyc + (size_t)g * hr + j0;
  const int32_t* gymc = pymc + (size_t)g * hr + j0;
  const bool* gvy = valid_y + (size_t)g * hr + j0;
  for (int it = 0; it < items; ++it) {
    const int k = it / 3, c = it % 3;
    const int lo = gymc[k], hi = gyc[k];
    uint8_t* dst = out + ((size_t)(g * 3 + c) * hr + j0 + k) * wr;
    if (!gvy[k]) {  // uniform across the block: no barrier is skipped
      const uint32_t zero[kChunk] = {};
      for (int gi = tid; gi < groups; gi += nthreads)
        store_group(dst + gi * kChunk, zero, wr - gi * kChunk);
      continue;
    }
    // Column sums of source rows (lo, hi] over this thread's chunks.
    uint32_t acc[K * kChunk];
#pragma unroll
    for (int b = 0; b < K * kChunk; ++b) acc[b] = 0;
    const uint8_t* src = frame + (size_t)c * h * w + c0 * kChunk;
    for (int r = lo + 1; r <= hi; r += kRows) {
      uint4 v[kRows][K];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
#pragma unroll
        for (int q = 0; q < K; ++q)
          v[u][q] = r + u <= hi && avail > q * kChunk
                        ? load_chunk(src + (size_t)(r + u) * w + q * kChunk,
                                     avail - q * kChunk)
                        : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (r + u <= hi)
#pragma unroll
          for (int q = 0; q < K; ++q) add_bytes(acc + q * kChunk, v[u][q]);
    }
    // Block scan: the inclusive prefix over the W columns into S.
#pragma unroll
    for (int b = 1; b < K * kChunk; ++b) acc[b] += acc[b - 1];
    const uint32_t total = acc[K * kChunk - 1];
    uint32_t incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint32_t x = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += x;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    uint32_t off = incl - total;
    for (int x = 0; x < warp; ++x) off += s_warp[x];
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (c0 + q < chunks)
#pragma unroll
        for (int b = 0; b < kChunk; ++b)
          s_prefix[(kChunk + 1) * (c0 + q) + b] = acc[q * kChunk + b] + off;
    __syncthreads();
    // Box means: two shared reads and one exact division per column.
    const uint32_t dy = (uint32_t)(hi - lo);
    for (int gi = tid; gi < groups; gi += nthreads) {
      uint32_t q[kChunk];
#pragma unroll
      for (int b = 0; b < kChunk; ++b) {
        const uint32_t t = s_tap[b * groups + gi];
        const uint32_t xlo = t >> 16, dx = t & 0xffffu;
        const uint32_t box = s_prefix[slot(xlo + dx)] - s_prefix[slot(xlo)];
        q[b] = dx ? box / (dy * dx) : 0u;
      }
      store_group(dst + gi * kChunk, q, wr - gi * kChunk);
    }
  }
}

}  // namespace

extern "C" int fvx_y_segment_reduce(
    const void* frame, const void* pc, const void* pmc, void* out,
    int n, int h, int w, int hr, void* stream) {
  dim3 grid((w + kThreads - 1) / kThreads, hr, n * 3);
  y_segment_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)frame, (const int32_t*)pc, (const int32_t*)pmc,
      (uint16_t*)out, h, w, hr);
  return (int)cudaGetLastError();
}

extern "C" int fvx_x_segment_reduce(
    const void* rows, const void* pxc, const void* pxmc, const void* valid_x,
    const void* pyc, const void* pymc, const void* valid_y, void* out,
    int n, int hr, int w, int wr, void* stream) {
  dim3 grid((wr + kThreads - 1) / kThreads, hr, n * 3);
  x_segment_reduce_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint16_t*)rows, (const int32_t*)pxc, (const int32_t*)pxmc,
      (const bool*)valid_x, (const int32_t*)pyc, (const int32_t*)pymc,
      (const bool*)valid_y, (uint8_t*)out, hr, w, wr);
  return (int)cudaGetLastError();
}

namespace {

template <int K>
cudaError_t launch_xy(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                      const void* frame, const void* pxc, const void* pxmc,
                      const void* valid_x, const void* pyc, const void* pymc,
                      const void* valid_y, void* out, int h, int w, int hr,
                      int wr, int rows) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        segment_reduce_xy_kernel<K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  segment_reduce_xy_kernel<K><<<grid, threads, smem, stream>>>(
      (const uint8_t*)frame, (const int32_t*)pxc, (const int32_t*)pxmc,
      (const bool*)valid_x, (const int32_t*)pyc, (const int32_t*)pymc,
      (const bool*)valid_y, (uint8_t*)out, h, w, hr, wr, rows);
  return cudaGetLastError();
}

}  // namespace

// frame (3, h, w) u8; pxc, pxmc (n, wr) int32 and valid_x (n, wr) bool;
// pyc, pymc (n, hr) int32 and valid_y (n, hr) bool, the taps obeying the
// clamp rule; out (n, 3, hr, wr) u8; rows = R, the output rows of a band.
// Dynamic shared memory: 64 + 68 * ceil(w / 16) + 64 * ceil(wr / 16) bytes,
// which the wrapper keeps within the card's 232,448.
extern "C" int fvx_segment_reduce_xy(
    const void* frame, const void* pxc, const void* pxmc, const void* valid_x,
    const void* pyc, const void* pymc, const void* valid_y, void* out, int n,
    int h, int w, int hr, int wr, int rows, void* stream) {
  if (rows < 1 || w < 1 || w > 1 << 16) return (int)cudaErrorInvalidValue;
  const int chunks = (w + kChunk - 1) / kChunk;
  int k = 1;
  while (k < 8 && chunks > k * kMaxThreads) k *= 2;
  const int threads = ((chunks + k - 1) / k + 31) / 32 * 32;
  const size_t smem = (size_t)4 * (kMaxWarps + (kChunk + 1) * chunks +
                                    kChunk * ((wr + kChunk - 1) / kChunk));
  const dim3 grid((hr + rows - 1) / rows, n);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1:
      return (int)launch_xy<1>(grid, threads, smem, s, frame, pxc, pxmc,
                               valid_x, pyc, pymc, valid_y, out, h, w, hr, wr,
                               rows);
    case 2:
      return (int)launch_xy<2>(grid, threads, smem, s, frame, pxc, pxmc,
                               valid_x, pyc, pymc, valid_y, out, h, w, hr, wr,
                               rows);
    case 4:
      return (int)launch_xy<4>(grid, threads, smem, s, frame, pxc, pxmc,
                               valid_x, pyc, pymc, valid_y, out, h, w, hr, wr,
                               rows);
    default:
      return (int)launch_xy<8>(grid, threads, smem, s, frame, pxc, pxmc,
                               valid_x, pyc, pymc, valid_y, out, h, w, hr, wr,
                               rows);
  }
}
