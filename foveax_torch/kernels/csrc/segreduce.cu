// Fused segment-reduce sampler: the two passes of the gaze-centred
// log-rectilinear box filter, for a batch of N gazes over one frame.
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
