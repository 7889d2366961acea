// Fused unwarp, default xy order: one kernel from the reduced frame to the
// full-size frame, the column-blended intermediate kept in shared memory.
//
// fvx_unwarp_xy replaces both passes of foveax/kernels/unwarp_pl.py's
// _unwarp_fused_xy:
//   _x_kernel (unwarp_pl.py:264): xb[c, r, o] = trunc(numi * fl(1/den) +
//     (0.5 + 2^-10)), numi = (den - num) * src[c, r, lo] + num * src[c, r, hi],
//     with the per-column (lo, hi, num, den) of the x vectors;
//   _y_kernel (unwarp_pl.py:192): out[c, y, o] = trunc(numi * fl(1/den) +
//     0.01), the same blend over rows lo[y] and hi[y] of xb, with the y
//     vectors.
// The TPU kernels blend through one-hot integer-weight MXU dots over
// 128-lane slab windows and repair the columns that escape them; here every
// tap is loaded by index (lo/hi are already clamped into the reduced frame),
// so there is no window, no wrap pad and nothing to repair.  (A true
// quotient n/den with den <= 255 lies at least 1/(2 den) from a rounding
// boundary, so the repaired columns' num/den and the others'
// num * fl(1/den) round alike.)
//
// Bound on this card: bytes.  The function reads the reduced frame
// (3*hr*wr) and the eight vectors and writes the frame (3*Ho*Wo): 32.7 MB
// at 4K (3840x2160 from 2144x1200), 0.0098 ms at 3.35 TB/s.  Its
// operations, 8 per blended byte over 3*(hr + Ho)*Wo bytes (310 M at 4K),
// take 0.0046 ms at 67 TFLOP/s.  Two passes would also write the
// (3, hr, Wo) intermediate to device memory and read it back (60.3 MB).
//
// Design.  A block of 256 threads owns one channel, a band of `rows` output
// rows (the caller's R, 64 from foveax_torch/kernels/unwarp.py) and a strip
// of kStrip = 256 output columns.
// - It loads the strip's x vectors once, one column per thread, and keeps
//   them in registers with fl(1/den), computed once per column.  The band's
//   y vectors and their reciprocals go to shared memory the same way.
// - The intermediate never leaves the chip.  For the inverse map's vectors
//   (lo and hi non-decreasing, hi - lo <= 1) a band's taps span at most
//   R + 1 reduced rows (tests/test_torch_unwarp.py checks this at every
//   integer gaze); the block computes those xb rows of its strip into
//   shared memory, one column per thread, loading kChunk rows' taps before
//   blending any so that their latencies overlap.  The taps are read
//   through the read-only cache: at a seam gaze one strip's taps span most
//   of a reduced row, so no column window is staged.
// - Then each thread writes 16 consecutive output bytes of a row with one
//   16-byte store (byte stores where the row width is not a multiple of
//   16 or at the ragged right edge), each byte the y blend of two shared
//   xb rows.
// - Any other in-range vectors are processed in pieces inside the kernel:
//   where a band's taps span more than R + 1 rows, each piece stages the
//   two xb rows of each of (R + 1) / 2 output rows.
//
// The float step rounds exactly as the JAX package's: an exact integer
// numerator, an IEEE reciprocal, then a rounded multiply and a rounded add
// that the compiler may not contract into an FMA (__fmul_rn/__fadd_rn; the
// file is also built with --fmad=false), truncated toward zero.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStrip = kThreads;              // output columns per block
constexpr int kVec = 16;                      // output bytes per store
constexpr int kGroups = kStrip / kVec;        // threads per output row
constexpr int kRowLanes = kThreads / kGroups;  // output rows written at once
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;  // xb rows whose taps are loaded before blending
constexpr float kHalfUp = 0.5f + 0x1p-10f;    // x pass: round half up
constexpr float kTruncGuard = 0.01f;          // y pass: truncate

__device__ __forceinline__ uint32_t blend(uint32_t a, uint32_t b, int wlo,
                                          int whi, float rcp, float bias) {
  const int numi = wlo * (int)a + whi * (int)b;
  const float q = __fadd_rn(__fmul_rn((float)numi, rcp), bias);
  return (uint32_t)__float2int_rz(q);
}

// The y blend of four packed bytes of two xb rows (byte permutes unpack
// and pack them).
__device__ __forceinline__ uint32_t blend4(uint32_t a, uint32_t b, int wlo,
                                           int whi, float rcp) {
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = blend(__byte_perm(a, 0, 0x4440 + j), __byte_perm(b, 0, 0x4440 + j),
                 wlo, whi, rcp, kTruncGuard);
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040),
                     __byte_perm(v[2], v[3], 0x0040), 0x5410);
}

// Row blend of kVec output bytes from two shared xb rows; `valid` is the
// count of those bytes inside the row.
__device__ __forceinline__ void row_blend(const uint8_t* lo, const uint8_t* hi,
                                          int wlo, int whi, float rcp,
                                          uint8_t* dst, bool wide, int valid) {
  const uint4 a = *reinterpret_cast<const uint4*>(lo);
  const uint4 b = *reinterpret_cast<const uint4*>(hi);
  const uint4 w = make_uint4(
      blend4(a.x, b.x, wlo, whi, rcp), blend4(a.y, b.y, wlo, whi, rcp),
      blend4(a.z, b.z, wlo, whi, rcp), blend4(a.w, b.w, wlo, whi, rcp));
  if (wide) {
    *reinterpret_cast<uint4*>(dst) = w;
    return;
  }
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (j < valid) dst[j] = (uint8_t)(ws[j / 4] >> (8 * (j % 4)));
}

// grid: (ceil(wo / kStrip), ceil(ho / rows), 3).  Dynamic shared memory:
// (rows + 1) * kStrip bytes of xb, then five words per band row.
__global__ void __launch_bounds__(kThreads) unwarp_xy_kernel(
    const uint8_t* __restrict__ src, const int32_t* __restrict__ xlo,
    const int32_t* __restrict__ xhi, const int32_t* __restrict__ xnum,
    const int32_t* __restrict__ xden, const int32_t* __restrict__ ylo,
    const int32_t* __restrict__ yhi, const int32_t* __restrict__ ynum,
    const int32_t* __restrict__ yden, uint8_t* __restrict__ out, int hr,
    int wr, int ho, int wo, int rows) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_wmin[kWarps], s_wmax[kWarps];
  const int cap = rows + 1;  // xb rows staged at once
  uint8_t* xb = smem;        // [cap][kStrip]
  int32_t* s_lo = reinterpret_cast<int32_t*>(smem + cap * kStrip);
  int32_t* s_hi = s_lo + rows;
  int32_t* s_wl = s_hi + rows;
  int32_t* s_wh = s_wl + rows;
  float* s_rcp = reinterpret_cast<float*>(s_wh + rows);

  const int tid = threadIdx.x;
  const int o0 = blockIdx.x * kStrip;
  const int y0 = blockIdx.y * rows;
  const int nrows = min(rows, ho - y0);
  const uint8_t* plane = src + (size_t)blockIdx.z * hr * wr;

  // This thread's column of the strip: its taps, weights and 1/den.  (A
  // column past the edge keeps tap 0, a valid address, and is never
  // stored.)
  const int o = o0 + tid;
  const bool col_ok = o < wo;
  int x_lo = 0, x_hi = 0, x_num = 0, x_den = 1;
  if (col_ok) {
    x_lo = xlo[o];
    x_hi = xhi[o];
    x_num = xnum[o];
    x_den = xden[o];
  }
  // The band's y vectors, and the span of reduced rows they read.
  int rmin = INT_MAX, rmax = INT_MIN;
  for (int k = tid; k < nrows; k += kThreads) {
    const int lo = ylo[y0 + k], hi = yhi[y0 + k];
    const int den = yden[y0 + k], num = ynum[y0 + k];
    s_lo[k] = lo;
    s_hi[k] = hi;
    s_wl[k] = den - num;
    s_wh[k] = num;
    s_rcp[k] = __frcp_rn((float)den);
    rmin = min(rmin, min(lo, hi));
    rmax = max(rmax, max(lo, hi));
  }
  const int x_wl = x_den - x_num, x_wh = x_num;
  const float x_rcp = __frcp_rn((float)x_den);
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    rmin = min(rmin, __shfl_xor_sync(0xffffffffu, rmin, d));
    rmax = max(rmax, __shfl_xor_sync(0xffffffffu, rmax, d));
  }
  if (tid % 32 == 0) {
    s_wmin[tid / 32] = rmin;
    s_wmax[tid / 32] = rmax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    rmin = min(rmin, s_wmin[w]);
    rmax = max(rmax, s_wmax[w]);
  }

  const int r0 = rmin;
  const int g = tid % kGroups;
  const int lane = tid / kGroups;
  const int oc = o0 + g * kVec;  // first column of this thread's stores
  const bool wide = wo % kVec == 0 && oc + kVec <= wo;
  const uint8_t* xb_g = xb + g * kVec;
  uint8_t* out_g = out + (size_t)blockIdx.z * ho * wo + oc;

  if (rmax - r0 < cap) {
    // The band's xb rows r0..rmax; a chunk's slots past rmax reload row
    // rmax and store nothing.
    const uint8_t* col_lo = plane + x_lo;
    const uint8_t* col_hi = plane + x_hi;
    uint8_t* dst = xb + tid;
    for (int r = r0; r <= rmax; r += kChunk, dst += kChunk * kStrip) {
      uint32_t a[kChunk], b[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int row = min(r + j, rmax) * wr;
        a[j] = __ldg(col_lo + row);
        b[j] = __ldg(col_hi + row);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const uint32_t v = blend(a[j], b[j], x_wl, x_wh, x_rcp, kHalfUp);
        if (r + j <= rmax) dst[j * kStrip] = (uint8_t)v;
      }
    }
    __syncthreads();
    for (int k = lane; k < nrows; k += kRowLanes)
      row_blend(xb_g + (s_lo[k] - r0) * kStrip, xb_g + (s_hi[k] - r0) * kStrip,
                s_wl[k], s_wh[k], s_rcp[k], out_g + (size_t)(y0 + k) * wo,
                wide, wo - oc);
    return;
  }
  // In pieces: each stages the two xb rows of each of cap / 2 output rows.
  const int per = cap / 2;
  for (int k0 = 0; k0 < nrows; k0 += per) {
    const int kn = min(per, nrows - k0);
    if (k0) __syncthreads();  // the previous piece's xb rows are read
    for (int s = 0; s < 2 * kn; ++s) {
      const uint8_t* row =
          plane + (size_t)((s & 1) ? s_hi : s_lo)[k0 + s / 2] * wr;
      xb[s * kStrip + tid] = (uint8_t)blend(__ldg(row + x_lo),
                                            __ldg(row + x_hi), x_wl, x_wh,
                                            x_rcp, kHalfUp);
    }
    __syncthreads();
    for (int k = k0 + lane; k < k0 + kn; k += kRowLanes)
      row_blend(xb_g + 2 * (k - k0) * kStrip, xb_g + (2 * (k - k0) + 1) * kStrip,
                s_wl[k], s_wh[k], s_rcp[k], out_g + (size_t)(y0 + k) * wo,
                wide, wo - oc);
  }
}

}  // namespace

// src (3, hr, wr) u8; x vectors (wo,) and y vectors (ho,) int32 with lo/hi
// in range, 1 <= den <= 255, 0 <= num <= den; out (3, ho, wo) u8; rows = R,
// the output rows of a band.
extern "C" int fvx_unwarp_xy(
    const void* src, const void* xlo, const void* xhi, const void* xnum,
    const void* xden, const void* ylo, const void* yhi, const void* ynum,
    const void* yden, void* out, int hr, int wr, int ho, int wo, int rows,
    void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(rows + 1) * kStrip + (size_t)rows * 5 * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        unwarp_xy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((wo + kStrip - 1) / kStrip, (ho + rows - 1) / rows, 3);
  unwarp_xy_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int32_t*)xlo, (const int32_t*)xhi,
      (const int32_t*)xnum, (const int32_t*)xden, (const int32_t*)ylo,
      (const int32_t*)yhi, (const int32_t*)ynum, (const int32_t*)yden,
      (uint8_t*)out, hr, wr, ho, wo, rows);
  return (int)cudaGetLastError();
}
