// Fused two-pass unwarp, default xy order: a column pass over the reduced
// frame, then a row pass to full size.
//
// K3 fvx_unwarp_x replaces foveax/kernels/unwarp_pl.py:_x_kernel (via
//    _unwarp_fused_xy): xb[c, r, o] = trunc(numi * fl(1/den) + (0.5 + 2^-10))
//    with numi = (den - num) * src[c, r, lo] + num * src[c, r, hi], the
//    per-column (lo, hi, num, den) from the inverse map's x vectors.
// K4 fvx_unwarp_y replaces foveax/kernels/unwarp_pl.py:_y_kernel (via
//    _unwarp_fused_xy): out[c, y, o] = trunc(numi * fl(1/den) + 0.01) over
//    two rows of xb, with the y vectors.
//
// The TPU kernels blend through one-hot integer-weight MXU dots over
// 128-lane slab windows of a wrap-padded frame, and repair the columns that
// escape their window afterwards (_jump_fixup, with a true divide).  Here
// each thread loads its two taps by index: lo/hi are already clamped into
// [0, reduced_dim), so there is no window, no wrap pad and nothing to
// repair.  (A true quotient n/den with den <= 255 lies at least 1/(2 den)
// from a rounding boundary, so the repaired columns' num/den and the
// others' num * fl(1/den) round alike.)
//
// The float step rounds exactly as the JAX package's: an exact integer
// numerator, an IEEE reciprocal, then a rounded multiply and a rounded add
// that the compiler may not contract into an FMA (__fmul_rn/__fadd_rn; the
// file is also built with --fmad=false).
//
// Bound on this card: bytes (K3 reads the reduced frame and writes the
// (3, hr, Wo) intermediate; K4 reads that and writes the (3, Ho, Wo)
// frame).  This is the simple first version: one thread per output pixel;
// making it fast is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t blend(int a, int b, int num, int den,
                                         float bias) {
  const int numi = (den - num) * a + num * b;
  const float q = __fadd_rn(__fmul_rn((float)numi, __frcp_rn((float)den)),
                            bias);
  return (uint8_t)__float2int_rz(q);
}

// grid: (ceil(wo / kThreads), hr, 3).
__global__ void unwarp_x_kernel(
    const uint8_t* __restrict__ src, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, const int32_t* __restrict__ num,
    const int32_t* __restrict__ den, uint8_t* __restrict__ out,
    int hr, int wr, int wo) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= wo) return;
  const size_t row = (size_t)blockIdx.z * hr + blockIdx.y;
  const uint8_t* s = src + row * wr;
  out[row * wo + o] =
      blend(s[lo[o]], s[hi[o]], num[o], den[o], 0.5f + 0x1p-10f);
}

// grid: (ceil(wo / kThreads), ho, 3).
__global__ void unwarp_y_kernel(
    const uint8_t* __restrict__ src, const int32_t* __restrict__ lo,
    const int32_t* __restrict__ hi, const int32_t* __restrict__ num,
    const int32_t* __restrict__ den, uint8_t* __restrict__ out,
    int hr, int wo, int ho) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= wo) return;
  const int y = blockIdx.y;
  const int c = blockIdx.z;
  const uint8_t* plane = src + (size_t)c * hr * wo;
  const uint8_t a = plane[(size_t)lo[y] * wo + o];
  const uint8_t b = plane[(size_t)hi[y] * wo + o];
  out[((size_t)c * ho + y) * wo + o] = blend(a, b, num[y], den[y], 0.01f);
}

}  // namespace

extern "C" int fvx_unwarp_x(
    const void* src, const void* lo, const void* hi, const void* num,
    const void* den, void* out, int hr, int wr, int wo, void* stream) {
  dim3 grid((wo + kThreads - 1) / kThreads, hr, 3);
  unwarp_x_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int32_t*)lo, (const int32_t*)hi,
      (const int32_t*)num, (const int32_t*)den, (uint8_t*)out, hr, wr, wo);
  return (int)cudaGetLastError();
}

extern "C" int fvx_unwarp_y(
    const void* src, const void* lo, const void* hi, const void* num,
    const void* den, void* out, int hr, int wo, int ho, void* stream) {
  dim3 grid((wo + kThreads - 1) / kThreads, ho, 3);
  unwarp_y_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int32_t*)lo, (const int32_t*)hi,
      (const int32_t*)num, (const int32_t*)den, (uint8_t*)out, hr, wo, ho);
  return (int)cudaGetLastError();
}
