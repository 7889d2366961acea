// K7, the SAT path's 4-tap sampler: the gaze-centred log-rectilinear box
// filter read from a summed-area table, for a batch of N gazes over one
// SAT.
//
// K7 fvx_sat_sample has no Pallas counterpart: foveax computes the same
//    function in plain JAX, foveax/core/sample.py:155 sample_rect_from_sat
//    (row and column gathers under one XLA program).  For a (3, Hs, Ws)
//    uint32 SAT S and gaze g's column taps pxc, pxmc, valid_x (N, Wr) and
//    row taps pyc, pymc, valid_y (N, Hr):
//      out[g, c, j, i] = floor(box / (dy * dx)),
//      box = (S[c, pyc, pxc] - S[c, pymc, pxc] - S[c, pyc, pxmc]
//             + S[c, pymc, pxmc]) mod 2^32,
//    dy = pyc - pymc, dx = pxc - pxmc (taps of row j and column i), and 0
//    where !(valid_x[g, i] && valid_y[g, j]); written as (N, 3, Hr, Wr)
//    ("chw") or (N, Hr, Wr, 3) ("hwc"), whichever the caller asks for, so
//    no permute copy follows.
//
// The plain version gathers whole SAT rows, then columns, in int64: at
// 36000x18000 -> 20000x10000 about 23 GB a gaze, so a broadcast tick of
// three gazes does not fit an 80 GB card.  Here each output value reads
// its four SAT words and holds nothing else.  The difference is taken in
// uint32_t, whose defined wrap is exactly the plain version's & 2^32 - 1
// (a true box sum is below 2^32), and the division is exact unsigned
// division.  The tap clamp rule (1 <= pc <= dim - 1, 0 <= pmc < pc on each
// axis) keeps every load inside the SAT and dy * dx >= 1; the wrapper
// checks Hs * Ws < 2^32, which keeps dy * dx inside uint32_t.
//
// Bound on this card: bytes.  At most four uint32 SAT words per output
// value, the uint8 output and the taps: at 4K (3840x2160 -> 2144x1200,
// one gaze) 131.2 MB, 0.039 ms at 3.35 TB/s.  Adjacent cells share their
// taps (column i's pxmc is column i - 1's pxc, and so for rows), so the
// words the data needs are about 3 (Hr + 1) (Wr + 1): 38.7 MB with the
// output and taps, 0.0115 ms; chip_smoke.py counts them from each run's
// taps.  The divide is the only costly operation (about 20 instructions,
// 7.7 M of them at 4K: far below the bytes).  A gather has no tile for
// wgmma and no box for TMA to fetch, so neither has a role here.
//
// Design.  This is the simple first version: one thread per output column,
// a block per 256 columns of one (gaze, output row), blockIdx.y striding
// over the N * Hr rows (a grid's y extent stops at 65,535).  A thread
// loads its column taps, the row's taps (the same word for the whole
// block), then for each channel four __ldg words and one division, and
// stores its three bytes.  All offsets are ptrdiff_t: the SAT at
// 36000x18000 holds 1.944 G words and an 8-gaze output 4.8 G bytes.
// Seam-wrapped columns give non-monotone pxc across a row: the loads stay
// right there but do not coalesce; making the gather fast is later work.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

template <bool kHwc>
__global__ void sat_sample_kernel(
    const uint32_t* __restrict__ sat, const int32_t* __restrict__ pxc,
    const int32_t* __restrict__ pxmc, const uint8_t* __restrict__ valid_x,
    const int32_t* __restrict__ pyc, const int32_t* __restrict__ pymc,
    const uint8_t* __restrict__ valid_y, uint8_t* __restrict__ out, int n,
    int hs, int ws, int hr, int wr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= wr) return;
  const ptrdiff_t plane = (ptrdiff_t)hs * ws;
  const ptrdiff_t out_plane = (ptrdiff_t)hr * wr;
  const ptrdiff_t rows = (ptrdiff_t)n * hr;
  for (ptrdiff_t gj = blockIdx.y; gj < rows; gj += gridDim.y) {
    const ptrdiff_t g = gj / hr;
    const ptrdiff_t j = gj - g * hr;
    const ptrdiff_t xi = g * wr + i;
    uint32_t v[3] = {0, 0, 0};
    if (__ldg(valid_x + xi) && __ldg(valid_y + gj)) {
      const int x1 = __ldg(pxc + xi);
      const int x0 = __ldg(pxmc + xi);
      const int y1 = __ldg(pyc + gj);
      const int y0 = __ldg(pymc + gj);
      const uint32_t rect = (uint32_t)(y1 - y0) * (uint32_t)(x1 - x0);
      const uint32_t* hi = sat + (ptrdiff_t)y1 * ws;
      const uint32_t* lo = sat + (ptrdiff_t)y0 * ws;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const ptrdiff_t o = c * plane;
        const uint32_t box = __ldg(hi + o + x1) - __ldg(lo + o + x1) -
                             __ldg(hi + o + x0) + __ldg(lo + o + x0);
        v[c] = box / rect;
      }
    }
    if (kHwc) {
      uint8_t* dst = out + (gj * wr + i) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[c] = (uint8_t)v[c];
    } else {
      uint8_t* dst = out + g * 3 * out_plane + j * wr + i;
#pragma unroll
      for (int c = 0; c < 3; ++c) dst[c * out_plane] = (uint8_t)v[c];
    }
  }
}

}  // namespace

extern "C" int fvx_sat_sample(
    const void* sat, const void* pxc, const void* pxmc, const void* valid_x,
    const void* pyc, const void* pymc, const void* valid_y, void* out, int n,
    int hs, int ws, int hr, int wr, int hwc, void* stream) {
  if (n < 1 || hs < 1 || ws < 1 || hr < 1 || wr < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long rows = (long long)n * hr;
  const dim3 grid((wr + kThreads - 1) / kThreads,
                  (unsigned)(rows < kMaxGridY ? rows : kMaxGridY));
  const cudaStream_t s = (cudaStream_t)stream;
  if (hwc) {
    sat_sample_kernel<true><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)sat, (const int32_t*)pxc, (const int32_t*)pxmc,
        (const uint8_t*)valid_x, (const int32_t*)pyc, (const int32_t*)pymc,
        (const uint8_t*)valid_y, (uint8_t*)out, n, hs, ws, hr, wr);
  } else {
    sat_sample_kernel<false><<<grid, kThreads, 0, s>>>(
        (const uint32_t*)sat, (const int32_t*)pxc, (const int32_t*)pxmc,
        (const uint8_t*)valid_x, (const int32_t*)pyc, (const int32_t*)pymc,
        (const uint8_t*)valid_y, (uint8_t*)out, n, hs, ws, hr, wr);
  }
  return (int)cudaGetLastError();
}
