// Summed-area table (SAT) build, whole and row-selected.
//
// K5 fvx_sat_build replaces foveax/kernels/scan2d.py:51 _sat_kernel (via
//    build_sat_pallas): out[c, y, x] = sum of frame[c, y', x'] over
//    y' <= y, x' <= x, mod 2^32, for a uint8 frame given by its (channel,
//    row, column) strides: (3, H, W) ("chw", column stride 1) and (H, W, 3)
//    ("hwc", column stride 3, channel stride 1) both go in as they are.
// K6 fvx_sat_select_rows replaces foveax/kernels/fused_select.py:46
//    _make_kernel (via sat_select_rows): for an (H, 3, W) uint8 frame and
//    non-decreasing row lists pyc, pymc of length n in [0, H), sel[0, j] =
//    SAT row pyc[j] and sel[1, j] = SAT row pymc[j], each (3, W), without
//    writing the SAT.
//
// The TPU kernels scan rows with float32 triangular-matrix products on the
// MXU (exact below 2^24, with bf16 limb splits and an int8 variant), in
// 128-lane chunks, and carry the column totals across a sequential grid of
// 8-row blocks.  Here every sum is a uint32_t add: unsigned overflow is
// defined in C++ and is exactly the SAT's mod-2^32 wrap, so the same bits
// come out with no limbs, no lane quanta and no row-block constraint.
//
// Bound on this card: bytes.  K5 reads the uint8 frame once and writes the
// uint32 SAT once: 124.4 MB at 4K (3 x 3840 x 2160), 0.0371 ms at 3.35
// TB/s; its adds (two per element) take 0.0007 ms at 67 TFLOP/s.  K6 writes
// 2 n SAT rows instead of the SAT (at 4K with n = 1200: 135.5 MB).
//
// Design.  Hopper has no sequential grid to carry the column totals down
// the frame, so the carry comes from two small launches before the scan
// (reduce, then scan, by row bands of R rows; R = the wrapper's band_rows):
//   1. band_totals_kernel: for every (channel, band but the last, 16-column
//      chunk) one thread sums the band's rows of its 16 columns (16-byte
//      loads, 8 rows in flight; in "hwc" one thread sums the three channels
//      of its 48-byte pixel windows) and writes 16 uint32 totals.  The
//      scratch is (3, nb - 1, Wp), Wp = W rounded up to 16: at 4K with
//      R = 32, 3.1 MB.
//   2. band_carry_kernel: one thread per (channel, column) turns those
//      totals into their inclusive scan down the bands, in place: entry b
//      is then the column sum of every row above band b + 1.
//   3. sat_band_kernel (K6: select_band_kernel): one block per (channel,
//      band), channel fastest so that the three blocks of a band read the
//      same bytes at about the same time (in "hwc" they share every 48-byte
//      window through L2).  Its threads own K adjacent 16-column chunks each
//      (K = 1 up to W = 8192, so a block spans the whole row, or its
//      column tile past 32,768 columns: see below) and start from
//      the band's carry: their column prefix (the column sums down to the
//      row above).  The block walks its rows in steps of S rows (S = 8 / K,
//      4 / K for "hwc"), each step's loads in registers:
//        a. every thread sums each row's bytes of its columns (__dp4a) and
//           so knows, per row, the total of its column prefixes; a warp
//           scan per row, the warp totals in shared memory (double
//           buffered: one barrier per step, not per row), and each warp's
//           scan of those give every thread its row offsets;
//        b. from the same registers, the thread adds each row into its
//           column prefix and scans it across its columns from the offset;
//           each warp stages the row in shared memory and writes it with
//           16-byte stores, 512 contiguous bytes a warp instruction.
//   K6 only: 4. dup_fill_kernel copies each row that a list repeats (see
//      there).
// Column tiles.  A scanning block spans at most 512 threads x 4 chunks x 16
// = 32,768 columns, so a wider row is cut into column tiles of kTile
// columns (a multiple of 16, so that every tile start keeps the alignment
// of its row start; the last tile ragged).  Phases 1 and 2
// are per column and cover the whole width once; phase 3 runs once per
// tile, in order on the stream.  In a tile that starts at column x0 > 0 a
// row's running offset starts from the SAT word out[c, y, x0 - 1] (K6:
// that word of the selected row), which the tile before it wrote: SAT[y,
// x] = SAT[y, x0 - 1] + the sum over x0 <= x' <= x of the column prefix at
// x', all mod 2^32.  Each tile is a programmatic dependent of the one
// before it and reads that word after griddepcontrol.wait.  One C call
// launches every tile.
// Phases 2 to 4 are programmatic dependent launches: each starts while the
// one before it runs and waits for it with griddepcontrol.wait, so launch
// gaps, K6's list searches and a scanning block's first frame loads
// overlap the phase before.  No block ever waits on another block of its
// own grid.
//
// The SAT is written once; the frame is read twice (phase 1, then phase 3,
// whose read often hits the 50 MB L2: the 4K frame is 24.9 MB), about 158
// MB moved at 4K against the bound's 124.4 MB.  Many blocks are in flight
// (3 * ceil(H / R)), not 3 * W column walkers.  K6 runs the same phases,
// limited to the bands up to its last listed row; a phase-3 block finds
// its band's entries of each list by binary search, returns at once when
// there are none, stops after its last listed row and writes each listed
// row once, so bands past max(pyc[n-1], pymc[n-1]) are never scanned.
// The band height was measured on the H100 (PERF.md §6): see BAND_ROWS in
// kernels/scan2d.py for the choice and its reason.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;  // columns a thread owns per chunk
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
// Columns of a column tile: what a scanning block of kMaxThreads threads x
// 4 chunks spans (kernels/scan2d.py::MAX_WIDTH).
constexpr int kTile = kMaxThreads * 4 * kChunk;
constexpr int kTotalsThreads = 128;
constexpr int kTotalsRows = 8;  // rows of loads phase 1 has in flight
constexpr int kCarryThreads = 256;
constexpr int kCarryRows = 16;  // band totals phase 2 has in flight

// Rows of a phase-3 step; each step's loads are in flight while the step
// before it is computed: 4 uint4 a thread in "chw", 6 in "hwc" (three per
// 16 pixels).
__host__ __device__ constexpr int step_rows(int xs, int k) {
  return (xs == 1 ? 4 : 2) / k > 0 ? (xs == 1 ? 4 : 2) / k : 1;
}

// The 16 bytes of a 16-column chunk of a plane at p, packed little-endian
// into a uint4; only the first `avail` (< 16) when fewer remain, the rest
// zero.  The widest loads the address allows.
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

// The 48-byte pixel window of a 16-column chunk of an interleaved frame,
// or its first 3 * avail bytes, zero-filled.
struct Window {
  uint32_t w[12];
};
__device__ __forceinline__ Window load_window(const uint8_t* p, int avail) {
  Window v;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (avail >= kChunk && (a & 15) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const uint4 t = __ldg(q + k);
      v.w[4 * k] = t.x, v.w[4 * k + 1] = t.y, v.w[4 * k + 2] = t.z;
      v.w[4 * k + 3] = t.w;
    }
  } else if (avail >= kChunk && (a & 3) == 0) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 12; ++k) v.w[k] = __ldg(q + k);
  } else {
    const int bytes = 3 * min(avail, kChunk);
#pragma unroll
    for (int k = 0; k < 12; ++k) v.w[k] = 0;
#pragma unroll
    for (int b = 0; b < 3 * kChunk; ++b)
      if (b < bytes) v.w[b / 4] |= (uint32_t)__ldg(p + b) << (8 * (b % 4));
  }
  return v;
}

// Channel c's 16 bytes of a window, packed.  The window shifted down by c
// bytes puts them at 0, 3, 6, ..., 45; bytes 12m, 12m+3, 12m+6, 12m+9 are
// then byte 0 and 3 of word 3m, byte 2 of word 3m+1, byte 1 of word 3m+2.
__device__ __forceinline__ uint4 pick_channel(const Window& v, int c) {
  uint32_t w[13];
#pragma unroll
  for (int k = 0; k < 12; ++k) w[k] = v.w[k];
  w[12] = 0;
#pragma unroll
  for (int k = 0; k < 12; ++k) w[k] = __funnelshift_r(w[k], w[k + 1], 8 * c);
  uint32_t o[4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
    o[m] = __byte_perm(__byte_perm(w[3 * m], w[3 * m + 1], 0x0630),
                       w[3 * m + 2], 0x5210);
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// A chunk as it is loaded (planes: the packed bytes; interleaved: the
// pixel window), and its channel's packed bytes.
template <int XS>
struct RawChunk {
  using T = uint4;
};
template <>
struct RawChunk<3> {
  using T = Window;
};
template <int XS>
__device__ __forceinline__ typename RawChunk<XS>::T load_raw(const uint8_t* p,
                                                             int avail) {
  if constexpr (XS == 3) return load_window(p, avail);
  else return load_chunk(p, avail);
}
__device__ __forceinline__ uint4 unpack(uint4 v, int) { return v; }
__device__ __forceinline__ uint4 unpack(const Window& v, int c) {
  return pick_channel(v, c);
}

// Where row r's chunk starting at column x0 of channel c begins.
template <int XS>
__device__ __forceinline__ const uint8_t* chunk_ptr(const uint8_t* frame,
                                                    int c_stride,
                                                    int r_stride, int c,
                                                    int r, int x0) {
  return frame + (XS == 1 ? (ptrdiff_t)c * c_stride : 0) +
         (ptrdiff_t)r * r_stride + (ptrdiff_t)XS * x0;
}

__device__ __forceinline__ uint32_t byte_sum(uint4 v, uint32_t acc) {
  acc = __dp4a(v.x, 0x01010101u, acc);
  acc = __dp4a(v.y, 0x01010101u, acc);
  acc = __dp4a(v.z, 0x01010101u, acc);
  return __dp4a(v.w, 0x01010101u, acc);
}

__device__ __forceinline__ void add_bytes(uint32_t* acc, uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[4 * q + b] += (w[q] >> (8 * b)) & 0xffu;
}

// Write 16 uint32 at a 16-byte aligned dst.
__device__ __forceinline__ void store16(uint32_t* dst, const uint32_t* v) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    reinterpret_cast<uint4*>(dst)[q] =
        make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// Programmatic dependent launch (Hopper): a kernel launched with
// programmatic stream serialization may start while the one before it in
// the stream still runs, once every block of that one has called
// let_next_start() (or exited); wait_for_previous() then blocks until it
// has finished and its writes are visible.  So a launch's start-up (and
// K6's list searches, and a scanning block's first frame loads, which need
// nothing of phases 1 and 2) overlaps the kernel before it.
__device__ __forceinline__ void let_next_start() {
  asm volatile("griddepcontrol.launch_dependents;");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
// Loads of what the previous grid wrote, made after wait_for_previous():
// volatile asm, so that the compiler keeps them after the wait, through L2.
__device__ __forceinline__ uint32_t load_after(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint4 load4_after(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The rows of the frame a call needs: all of them for K5 (pyc == nullptr),
// up to the last listed row for K6.
__device__ __forceinline__ int rows_needed(const int32_t* pyc,
                                           const int32_t* pymc, int n, int h) {
  if (pyc == nullptr) return h;
  return min(max(pyc[n - 1], pymc[n - 1]) + 1, h);
}

// Phase 1. grid: (ceil(chunks / kTotalsThreads), 3 * (nb - 1)), channel
// fastest in y; "hwc" (XS 3): (.., nb - 1), a thread summing all three
// channels of its pixel windows.  totals (3, nb - 1, wp): the column sums
// of each band but the last, for the bands that a later scanned band needs.
template <int XS>
__global__ void __launch_bounds__(kTotalsThreads) band_totals_kernel(
    const uint8_t* __restrict__ frame, int c_stride, int r_stride,
    const int32_t* __restrict__ pyc, const int32_t* __restrict__ pymc, int n,
    uint32_t* __restrict__ totals, int h, int w, int wp, int band_rows) {
  let_next_start();
  constexpr int C = XS == 3 ? 3 : 1;  // channels a thread sums
  constexpr int U = XS == 3 ? 4 : kTotalsRows;  // rows of loads in flight
  const int c0 = XS == 3 ? 0 : blockIdx.y % 3;
  const int b = XS == 3 ? blockIdx.y : blockIdx.y / 3;
  const int nb1 = (h + band_rows - 1) / band_rows - 1;
  const int r0 = b * band_rows;
  if (r0 + band_rows >= rows_needed(pyc, pymc, n, h)) return;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * kChunk;
  if (x0 >= w) return;
  const int avail = w - x0;
  uint32_t acc[C][kChunk];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[c][k] = 0;
  using Raw = typename RawChunk<XS>::T;
  for (int r = r0; r < r0 + band_rows; r += U) {
    Raw v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      v[u] = r + u < r0 + band_rows
                 ? load_raw<XS>(chunk_ptr<XS>(frame, c_stride, r_stride, c0,
                                              r + u, x0),
                                avail)
                 : Raw{};
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < C; ++c) add_bytes(acc[c], unpack(v[u], c0 + c));
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    store16(totals + ((ptrdiff_t)(c0 + c) * nb1 + b) * wp + x0, acc[c]);
}

// Phase 2. grid: (ceil(3 * wp / kCarryThreads),).  The inclusive scan of
// each column's band totals down the bands, in place.
__global__ void __launch_bounds__(kCarryThreads) band_carry_kernel(
    const int32_t* __restrict__ pyc, const int32_t* __restrict__ pymc, int n,
    uint32_t* totals, int h, int wp, int band_rows) {
  let_next_start();
  wait_for_previous();  // phase 1's totals
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 3 * wp) return;
  const int c = i / wp, x = i - c * wp;
  const int nb1 = (h + band_rows - 1) / band_rows - 1;
  // Bands whose totals some scanned band needs.
  const int need = min(
      nb1, (rows_needed(pyc, pymc, n, h) + band_rows - 1) / band_rows - 1);
  uint32_t* col = totals + (ptrdiff_t)c * nb1 * wp + x;
  uint32_t acc = 0;
  for (int b = 0; b < need; b += kCarryRows) {
    uint32_t v[kCarryRows];
#pragma unroll
    for (int u = 0; u < kCarryRows; ++u)
      v[u] = b + u < need ? load_after(col + (ptrdiff_t)(b + u) * wp) : 0u;
#pragma unroll
    for (int u = 0; u < kCarryRows; ++u) {
      acc += v[u];
      if (b + u < need) col[(ptrdiff_t)(b + u) * wp] = acc;
    }
  }
}

// A warp stages each SAT row's values of its 32 lanes' chunks in shared
// memory, kPad words per 16 columns (4 pad words: the lanes' 16-byte
// stores, 80 bytes apart, then fall in distinct banks), and writes them
// back as 16-byte stores of 4 consecutive columns per lane: 512 contiguous
// bytes per warp instruction, where a thread's own 16 values, 64 bytes
// apart from its neighbours', would fill half a 32-byte sector per lane.
constexpr int kPad = 20;

// Words of a scanning block's dynamic shared memory: the warp totals (two
// steps), the warps' staging buffers, and K6's two row tables.
__host__ __device__ constexpr int shared_words(int xs, int k, int threads,
                                               int band_rows) {
  return 2 * step_rows(xs, k) * kMaxWarps + threads * k * kPad +
         2 * (band_rows + 1);
}

// Write a warp's staged segment of `cols` columns to dst.
template <int K>
__device__ __forceinline__ void store_segment(uint32_t* dst,
                                              const uint32_t* buf, int lane,
                                              int cols) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
    for (int i = 0; i < 4 * K; ++i) {
      const int x = 4 * lane + 128 * i;
      const uint32_t* s = buf + (x / kChunk) * kPad + x % kChunk;
      if (x + 4 <= cols) {
        *reinterpret_cast<uint4*>(dst + x) =
            *reinterpret_cast<const uint4*>(s);
      } else {
        for (int b = 0; b < cols - x; ++b) dst[x + b] = s[b];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kChunk * K; ++i) {
      const int x = lane + 32 * i;
      if (x < cols) dst[x] = buf[(x / kChunk) * kPad + x % kChunk];
    }
  }
}

// Where K5 puts its rows: every row of the band, into the SAT.
struct SatSink {
  uint32_t* plane;  // out + c * h * w + the tile's first column
  int w;
  __device__ int count(int) const { return 1; }
  __device__ uint32_t* dst(int r, int) const {
    return plane + (ptrdiff_t)r * w;
  }
};

// Where K6 puts its rows: row r into the first sel[0, j] with pyc[j] == r
// and the first sel[1, j] with pymc[j] == r; dup_fill_kernel copies it to
// the rest of each run.  hs[u] (ls[u]) is the first j with pyc[j]
// (pymc[j]) >= r0 + u, for u in [0, R].
struct SelectSink {
  const int* hs;
  const int* ls;
  uint32_t* hi;  // sel + c * w + x0: row j at hi + j * row
  uint32_t* lo;  // sel + (n * 3 + c) * w + x0
  ptrdiff_t row;
  int r0;
  __device__ int count(int r) const {
    const int u = r - r0;
    return (hs[u + 1] > hs[u]) + (ls[u + 1] > ls[u]);
  }
  __device__ uint32_t* dst(int r, int i) const {
    const int u = r - r0;
    return i == 0 && hs[u + 1] > hs[u] ? hi + hs[u] * row : lo + ls[u] * row;
  }
};

// Phase 3 for rows [r0, r_end) of channel c over one column tile of w
// columns: see the design note.  frame, carry and the sink's rows start at
// the tile's first column; carry is the band's column prefix (nullptr for
// the first band); with `left`, each row's offset starts from the SAT word
// just left of the tile (the sink's row at column -1).  smem is the
// block's dynamic shared memory (shared_words).
template <int XS, int K, class Sink>
__device__ __forceinline__ void band_scan(
    const uint8_t* __restrict__ frame, int c_stride, int r_stride, int c,
    const uint32_t* carry, int r0, int r_end, int w, bool left,
    uint32_t* smem, const Sink& sink) {
  constexpr int S = step_rows(XS, K);
  uint32_t* s_tot = smem;  // [2][S][kMaxWarps]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  uint32_t* s_buf = smem + 2 * S * kMaxWarps + warp * 32 * K * kPad;
  const int x0 = threadIdx.x * K * kChunk;   // this thread's first column
  const int wx0 = warp * 32 * K * kChunk;    // its warp's first column
  const int wcols = min(32 * K * kChunk, w - wx0);  // the warp's columns

  // The loads of the next step are in flight while a step is computed.
  using Raw = typename RawChunk<XS>::T;
  Raw next[S][K];
  const auto fetch = [&](int r) {
#pragma unroll
    for (int u = 0; u < S; ++u)
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int xq = x0 + q * kChunk;
        next[u][q] = r + u < r_end && xq < w
                         ? load_raw<XS>(chunk_ptr<XS>(frame, c_stride,
                                                      r_stride, c, r + u, xq),
                                        w - xq)
                         : Raw{};
      }
  };
  fetch(r0);
  uint32_t col[K * kChunk];  // column prefix down to the previous row
  uint32_t total;            // its sum over this thread's columns
  for (int r = r0, step = 0; r < r_end; r += S, ++step) {
    uint4 v[S][K];
#pragma unroll
    for (int u = 0; u < S; ++u)
#pragma unroll
      for (int q = 0; q < K; ++q) v[u][q] = unpack(next[u][q], c);
    if (r + S < r_end) fetch(r + S);  // uniform
    if (step == 0) {  // the carry, once phases 1 and 2 are done
      wait_for_previous();
      total = 0;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const int xq = x0 + q * kChunk;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const uint4 t = carry != nullptr && xq < w
                              ? load4_after(carry + xq + 4 * m)
                              : make_uint4(0, 0, 0, 0);
          const uint32_t tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            col[q * kChunk + 4 * m + b] = tv[b];
            total += tv[b];
          }
        }
      }
    }
    // The left tile's last SAT word of each row that is written, loaded
    // after the wait (the previous tile wrote it), used in b.
    uint32_t lc[S];
#pragma unroll
    for (int u = 0; u < S; ++u)
      lc[u] = left && r + u < r_end && sink.count(r + u) > 0
                  ? load_after(sink.dst(r + u, 0) - 1)
                  : 0u;
    // a. Per row: this thread's total, its warp-inclusive scan, the warp
    // totals into shared memory, then the block-exclusive offset.
    uint32_t off[S];
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int q = 0; q < K; ++q) total = byte_sum(v[u][q], total);
      uint32_t incl = total;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      off[u] = incl - total;
      if (lane == 31) s_tot[((step & 1) * S + u) * kMaxWarps + warp] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < S; ++u) {
      const uint32_t wt =
          lane < nwarps ? s_tot[((step & 1) * S + u) * kMaxWarps + lane] : 0u;
      uint32_t incl = wt;
#pragma unroll
      for (int d = 1; d < kMaxWarps; d <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += t;
      }
      off[u] += __shfl_sync(0xffffffffu, incl - wt, warp);
    }
    // b. Each row into the column prefix, scanned across the columns,
    // staged per warp and written where the sink puts it.
#pragma unroll
    for (int u = 0; u < S; ++u) {
#pragma unroll
      for (int q = 0; q < K; ++q) add_bytes(col + q * kChunk, v[u][q]);
      const int n = r + u < r_end ? sink.count(r + u) : 0;  // uniform
      if (n == 0) continue;
      uint32_t run = off[u] + lc[u];
#pragma unroll
      for (int q = 0; q < K; ++q) {
        uint32_t* s = s_buf + (lane * K + q) * kPad;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t o[4];
#pragma unroll
          for (int b = 0; b < 4; ++b)
            o[b] = run += col[q * kChunk + 4 * m + b];
          *reinterpret_cast<uint4*>(s + 4 * m) =
              make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
      __syncwarp();
      if (wcols > 0)
        for (int i = 0; i < n; ++i)
          store_segment<K>(sink.dst(r + u, i) + wx0, s_buf, lane, wcols);
      __syncwarp();  // the buffer is rewritten by the next row
    }
  }
}

// K5 phase 3 over the column tile [x0, x0 + tw). grid: (3 * nb,), channel
// fastest.
template <int XS, int K>
__global__ void __launch_bounds__(kMaxThreads) sat_band_kernel(
    const uint8_t* __restrict__ frame, int c_stride, int r_stride,
    const uint32_t* totals, uint32_t* __restrict__ out, int h,
    int w, int wp, int band_rows, int x0, int tw) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = blockIdx.x % 3;
  const int b = blockIdx.x / 3;
  const int nb1 = (h + band_rows - 1) / band_rows - 1;
  const int r0 = b * band_rows;
  const uint32_t* carry =
      b > 0 ? totals + ((ptrdiff_t)c * nb1 + b - 1) * wp + x0 : nullptr;
  const SatSink sink{out + (ptrdiff_t)c * h * w + x0, w};
  band_scan<XS, K>(frame + (ptrdiff_t)XS * x0, c_stride, r_stride, c, carry,
                   r0, min(r0 + band_rows, h), tw, x0 > 0, smem, sink);
}

// K6 phase 3 over the column tile [x0, x0 + tw). grid: (3 * nb,), channel
// fastest.  sel (2, n, 3, w).
template <int K>
__global__ void __launch_bounds__(kMaxThreads) select_band_kernel(
    const uint8_t* __restrict__ frame, const int32_t* __restrict__ pyc,
    const int32_t* __restrict__ pymc, const uint32_t* totals,
    uint32_t* __restrict__ sel, int h, int w, int wp, int n, int band_rows,
    int x0, int tw) {
  let_next_start();
  extern __shared__ __align__(16) uint32_t smem[];
  const int c = blockIdx.x % 3;
  const int b = blockIdx.x / 3;
  const int nb1 = (h + band_rows - 1) / band_rows - 1;
  const int r0 = b * band_rows, r1 = min(r0 + band_rows, h);
  // The band's entries of each list, [jh, jh_end) and [jl, jl_end): four
  // lower-bound searches stepped together, so their loads overlap.
  int jh = 0, jh_end = 0, jl = 0, jl_end = 0;
  int top = 1;
  while (top <= n / 2) top <<= 1;
  for (int s = top; s > 0; s >>= 1) {
    const bool a = jh + s <= n && pyc[jh + s - 1] < r0;
    const bool a1 = jh_end + s <= n && pyc[jh_end + s - 1] < r1;
    const bool e = jl + s <= n && pymc[jl + s - 1] < r0;
    const bool e1 = jl_end + s <= n && pymc[jl_end + s - 1] < r1;
    jh += a ? s : 0, jh_end += a1 ? s : 0, jl += e ? s : 0;
    jl_end += e1 ? s : 0;
  }
  if (jh == jh_end && jl == jl_end) return;  // uniform: no listed row here
  const int last = max(jh < jh_end ? pyc[jh_end - 1] : -1,
                       jl < jl_end ? pymc[jl_end - 1] : -1);
  // The row tables: hs[u] = first j with pyc[j] >= r0 + u.  Each entry
  // that starts a run of equal rows fills the rows since the previous run.
  int* hs = reinterpret_cast<int*>(
      smem + shared_words(1, K, blockDim.x, band_rows) - 2 * (band_rows + 1));
  int* ls = hs + band_rows + 1;
  for (int u = threadIdx.x; u <= band_rows; u += blockDim.x)
    hs[u] = jh_end, ls[u] = jl_end;
  __syncthreads();
  for (int j = jh + threadIdx.x; j < jh_end; j += blockDim.x) {
    const int prev = j > jh ? pyc[j - 1] : r0 - 1;
    for (int row = prev + 1; row <= pyc[j]; ++row) hs[row - r0] = j;
  }
  for (int j = jl + threadIdx.x; j < jl_end; j += blockDim.x) {
    const int prev = j > jl ? pymc[j - 1] : r0 - 1;
    for (int row = prev + 1; row <= pymc[j]; ++row) ls[row - r0] = j;
  }
  __syncthreads();
  const SelectSink sink{hs, ls, sel + (ptrdiff_t)c * w + x0,
                        sel + ((ptrdiff_t)n * 3 + c) * w + x0,
                        3 * (ptrdiff_t)w, r0};
  const uint32_t* carry =
      b > 0 ? totals + ((ptrdiff_t)c * nb1 + b - 1) * wp + x0 : nullptr;
  band_scan<1, K>(frame + x0, w, 3 * w, c, carry, r0, last + 1, tw, x0 > 0,
                  smem, sink);
}

// K6 phase 4, after the last tile. grid: (2 * n,).  Entry j of a list (pyc
// for j < n, then pymc) whose row is that of the entry before it copies
// the first entry of its run, which phase 3 wrote: (3, w) contiguous
// words.  A run of equal rows (the clamped rows 0, 1, H-2 and H-1 of a
// gaze near the frame's edge repeat hundreds of times) so spreads over many
// blocks instead of holding back the one that scans its band.
__global__ void __launch_bounds__(kCarryThreads) dup_fill_kernel(
    const int32_t* __restrict__ pyc, const int32_t* __restrict__ pymc,
    uint32_t* sel, int w, int n) {
  let_next_start();
  const int l = blockIdx.x / n, j = blockIdx.x % n;
  const int32_t* a = l == 0 ? pyc : pymc;
  if (j == 0 || a[j] != a[j - 1]) return;  // uniform
  // The run's first entry: the number of entries below a[j].
  const int v = a[j];
  int f = 0, top = 1;
  while (top <= j / 2) top <<= 1;
  for (int s = top; s > 0; s >>= 1)
    if (f + s <= j && a[f + s - 1] < v) f += s;
  wait_for_previous();  // phase 3's rows
  const ptrdiff_t row = 3 * (ptrdiff_t)w;
  const uint32_t* src = sel + ((ptrdiff_t)l * n + f) * row;
  uint32_t* dst = sel + ((ptrdiff_t)l * n + j) * row;
  if (row % 4 == 0 && (reinterpret_cast<uintptr_t>(sel) & 15) == 0) {
    for (ptrdiff_t x = 4 * threadIdx.x; x < row; x += 4 * blockDim.x)
      *reinterpret_cast<uint4*>(dst + x) = load4_after(src + x);
  } else {
    for (ptrdiff_t x = threadIdx.x; x < row; x += blockDim.x)
      dst[x] = load_after(src + x);
  }
}

// Launch kernel on s; with `after`, as a programmatic dependent of the
// kernel before it.
template <class... Params, class... Args>
cudaError_t launch(bool after, void (*kernel)(Params...), int grid,
                   int threads, size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = after ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, ((Params)args)...);
}

// Phases 1 and 2 (none when the frame is one band).
template <int XS>
cudaError_t launch_carry(const uint8_t* frame, int c_stride, int r_stride,
                         const int32_t* pyc, const int32_t* pymc, int n,
                         uint32_t* totals, int h, int w, int wp,
                         int band_rows, cudaStream_t s) {
  const int nb1 = (h + band_rows - 1) / band_rows - 1;
  if (nb1 == 0) return cudaSuccess;
  const int chunks = wp / kChunk;
  const dim3 grid((chunks + kTotalsThreads - 1) / kTotalsThreads,
                  XS == 3 ? nb1 : 3 * nb1);
  band_totals_kernel<XS><<<grid, kTotalsThreads, 0, s>>>(
      frame, c_stride, r_stride, pyc, pymc, n, totals, h, w, wp, band_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch(true, band_carry_kernel,
                (3 * wp + kCarryThreads - 1) / kCarryThreads, kCarryThreads, 0,
                s, pyc, pymc, n, totals, h, wp, band_rows);
}

// Dynamic shared memory above 48 KB must be asked for.
template <class F>
cudaError_t allow_shared(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int XS, int K>
cudaError_t launch_sat(const uint8_t* frame, int c_stride, int r_stride,
                       uint32_t* totals, uint32_t* out, int h, int w, int wp,
                       int band_rows, int threads, cudaStream_t s) {
  cudaError_t err = launch_carry<XS>(frame, c_stride, r_stride, nullptr,
                                     nullptr, 0, totals, h, w, wp, band_rows,
                                     s);
  if (err != cudaSuccess) return err;
  const size_t smem = 4 * (size_t)shared_words(XS, K, threads, band_rows);
  err = allow_shared(sat_band_kernel<XS, K>, smem);
  if (err != cudaSuccess) return err;
  const int nb = (h + band_rows - 1) / band_rows;
  for (int x0 = 0; x0 < w && err == cudaSuccess; x0 += kTile)
    err = launch(nb > 1 || x0 > 0, sat_band_kernel<XS, K>, 3 * nb, threads,
                 smem, s, frame, c_stride, r_stride, totals, out, h, w, wp,
                 band_rows, x0, w - x0 < kTile ? w - x0 : kTile);
  return err;
}

template <int K>
cudaError_t launch_select(const uint8_t* frame, const int32_t* pyc,
                          const int32_t* pymc, uint32_t* totals, uint32_t* sel,
                          int h, int w, int wp, int n, int band_rows,
                          int threads, cudaStream_t s) {
  cudaError_t err = launch_carry<1>(frame, w, 3 * w, pyc, pymc, n, totals, h,
                                    w, wp, band_rows, s);
  if (err != cudaSuccess) return err;
  const size_t smem = 4 * (size_t)shared_words(1, K, threads, band_rows);
  err = allow_shared(select_band_kernel<K>, smem);
  if (err != cudaSuccess) return err;
  const int nb = (h + band_rows - 1) / band_rows;
  for (int x0 = 0; x0 < w && err == cudaSuccess; x0 += kTile)
    err = launch(nb > 1 || x0 > 0, select_band_kernel<K>, 3 * nb, threads,
                 smem, s, frame, pyc, pymc, totals, sel, h, w, wp, n,
                 band_rows, x0, w - x0 < kTile ? w - x0 : kTile);
  if (err != cudaSuccess) return err;
  return launch(true, dup_fill_kernel, 2 * n, kCarryThreads, 0, s, pyc, pymc,
                sel, w, n);
}

// The launch plan the wrapper passed (kernels/scan2d.py::sat_plan): K
// chunks a thread, `threads` a block covering a column tile, shared memory
// within the card's 232,448 bytes, phase 1's grid rows within 65,535.
bool plan_ok(int h, int w, int band_rows, int threads, int k) {
  return h >= 1 && w >= 1 && band_rows >= 1 && (k == 1 || k == 2 || k == 4) &&
         threads >= 32 && threads <= kMaxThreads && threads % 32 == 0 &&
         (long long)threads * k * kChunk >= (w < kTile ? w : kTile) &&
         3LL * ((h + band_rows - 1) / band_rows) <= 65535 &&
         4LL * shared_words(1, k, threads, band_rows) <= 232448;
}

}  // namespace

// frame: uint8 with strides (c_stride, r_stride, x_stride), x_stride 1
// ("chw") or 3 with c_stride 1 ("hwc"); out (3, h, w) uint32; totals
// scratch of 3 * (ceil(h / band_rows) - 1) * wp uint32, wp = w rounded up
// to 16, 16-byte aligned.  Two launches (none for one band), then one a
// column tile.
extern "C" int fvx_sat_build(const void* frame, int c_stride, int r_stride,
                             int x_stride, void* out, void* totals, int h,
                             int w, int band_rows, int threads, int k,
                             void* stream) {
  if (!plan_ok(h, w, band_rows, threads, k) ||
      !(x_stride == 1 || (x_stride == 3 && c_stride == 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)frame;
  uint32_t* t = (uint32_t*)totals;
  uint32_t* o = (uint32_t*)out;
  const int wp = (w + kChunk - 1) / kChunk * kChunk;
  cudaError_t err;
  if (x_stride == 1) {
    err = k == 1   ? launch_sat<1, 1>(f, c_stride, r_stride, t, o, h, w, wp,
                                      band_rows, threads, s)
          : k == 2 ? launch_sat<1, 2>(f, c_stride, r_stride, t, o, h, w, wp,
                                      band_rows, threads, s)
                   : launch_sat<1, 4>(f, c_stride, r_stride, t, o, h, w, wp,
                                      band_rows, threads, s);
  } else {
    err = k == 1   ? launch_sat<3, 1>(f, c_stride, r_stride, t, o, h, w, wp,
                                      band_rows, threads, s)
          : k == 2 ? launch_sat<3, 2>(f, c_stride, r_stride, t, o, h, w, wp,
                                      band_rows, threads, s)
                   : launch_sat<3, 4>(f, c_stride, r_stride, t, o, h, w, wp,
                                      band_rows, threads, s);
  }
  return (int)err;
}

// frame (h, 3, w) uint8; pyc, pymc (n,) int32, n >= 1; sel (2, n, 3, w)
// uint32; totals as for fvx_sat_build.  Two launches (none for one band),
// one a column tile, then the copy of repeated rows.
extern "C" int fvx_sat_select_rows(const void* frame, const void* pyc,
                                   const void* pymc, void* sel, void* totals,
                                   int h, int w, int n, int band_rows,
                                   int threads, int k, void* stream) {
  if (!plan_ok(h, w, band_rows, threads, k) || n < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)frame;
  const int32_t* hi = (const int32_t*)pyc;
  const int32_t* lo = (const int32_t*)pymc;
  uint32_t* t = (uint32_t*)totals;
  uint32_t* o = (uint32_t*)sel;
  const int wp = (w + kChunk - 1) / kChunk * kChunk;
  const cudaError_t err =
      k == 1   ? launch_select<1>(f, hi, lo, t, o, h, w, wp, n, band_rows,
                                  threads, s)
      : k == 2 ? launch_select<2>(f, hi, lo, t, o, h, w, wp, n, band_rows,
                                  threads, s)
               : launch_select<4>(f, hi, lo, t, o, h, w, wp, n, band_rows,
                                  threads, s);
  return (int)err;
}
