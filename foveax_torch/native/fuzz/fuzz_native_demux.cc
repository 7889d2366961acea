// ASAN fuzzer for the native fMP4 mux/demux
// (foveax_torch/native/fmp4.cc; counterpart of the JAX package's
// scripts/fuzz_native_demux.cc).
//
// The Python differential fuzz (tests/test_torch_fuzz.py) compares
// OBSERVABLE state between the Python and C++ demuxers; this fuzzer hunts
// the bugs that observable state cannot show — out-of-bounds reads,
// overflows in box-size arithmetic, leaks — by round-tripping muxed
// streams and corrupted/garbage variants through the C API under
// AddressSanitizer and UndefinedBehaviorSanitizer.
//
// Build + run: python -m foveax_torch.scripts.fuzz_native demux <seed> <iterations>
//
// Exit 0 = clean; ASAN aborts loudly on any memory error.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

extern "C" {
int fvx_init_segment_cfg(uint32_t width, uint32_t height,
                         const char* sample_format, const char* cfg_fourcc,
                         const uint8_t* cfg, int cfg_len, uint8_t* out,
                         int cap);
int fvx_fragment(uint32_t seq, uint64_t decode_time, const uint8_t* sample,
                 int sample_len, uint32_t duration, int is_sync, uint8_t* out,
                 int cap);
void* fvx_demux_new();
void fvx_demux_free(void* h);
int fvx_demux_feed(void* h, const uint8_t* chunk, int len);
int fvx_demux_next(void* h, uint8_t* out, int cap);
int fvx_demux_info(void* h, uint32_t* width, uint32_t* height,
                   uint32_t* last_seq, int* header_seen);
uint32_t fvx_demux_header_count(void* h);
int fvx_demux_codec(void* h, char* fourcc_out, char* cfg_fourcc_out,
                    uint8_t* cfg_out, int cap);
int fvx_demux_live_handles();
}

namespace {

std::mt19937_64 rng;

uint64_t ri(uint64_t lo, uint64_t hi) {  // inclusive bounds
  return lo + rng() % (hi - lo + 1);
}

std::vector<uint8_t> make_stream() {
  std::vector<uint8_t> out(1 << 20);
  std::vector<uint8_t> cfg(ri(0, 40));
  for (auto& b : cfg) b = uint8_t(rng());
  const char* fmt = ri(0, 1) ? "avc1" : "jpeg";
  int n = fvx_init_segment_cfg(uint32_t(ri(0, 4096)), uint32_t(ri(0, 4096)),
                               fmt, "avcC",
                               cfg.empty() ? nullptr : cfg.data(),
                               int(cfg.size()), out.data(), int(out.size()));
  if (n <= 0) return {};
  std::vector<uint8_t> stream(out.begin(), out.begin() + n);
  uint32_t frames = uint32_t(ri(1, 5));
  for (uint32_t i = 0; i < frames; i++) {
    std::vector<uint8_t> sample(ri(0, 600));
    for (auto& b : sample) b = uint8_t(rng());
    int m = fvx_fragment(i + 1, uint64_t(i) * 1001, sample.data(),
                         int(sample.size()), 1001, i == 0, out.data(),
                         int(out.size()));
    if (m <= 0) return {};
    stream.insert(stream.end(), out.begin(), out.begin() + m);
  }
  return stream;
}

// Feed `data` in random chunks, drain everything, touch every accessor.
void drive(const std::vector<uint8_t>& data) {
  void* h = fvx_demux_new();
  std::vector<uint8_t> buf(1 << 16);
  size_t pos = 0;
  while (pos < data.size()) {
    size_t n = size_t(ri(1, 4096));
    if (n > data.size() - pos) n = data.size() - pos;
    int queued = fvx_demux_feed(h, data.data() + pos, int(n));
    pos += n;
    if (queued < 0) break;  // corrupt box header: parser contractually stops
    for (int i = 0; i < queued; i++) {
      int r = fvx_demux_next(h, buf.data(), int(buf.size()));
      if (r == -1) break;
      if (r < -1) {
        buf.resize(size_t(-r));
        fvx_demux_next(h, buf.data(), int(buf.size()));
      }
    }
  }
  uint32_t w, hh, seq;
  int hdr;
  fvx_demux_info(h, &w, &hh, &seq, &hdr);
  fvx_demux_header_count(h);
  char fc[4], cfc[4];
  std::vector<uint8_t> cfg(4096);
  fvx_demux_codec(h, fc, cfc, cfg.data(), int(cfg.size()));
  fvx_demux_free(h);
}

}  // namespace

int main(int argc, char** argv) {
  uint64_t seed = argc > 1 ? strtoull(argv[1], nullptr, 10) : 0;
  int iters = argc > 2 ? atoi(argv[2]) : 200;
  rng.seed(seed);
  for (int it = 0; it < iters; it++) {
    std::vector<uint8_t> base = make_stream();
    if (base.empty()) continue;
    drive(base);  // valid stream
    // Byte flips (box sizes included).
    for (int c = 0; c < 8; c++) {
      std::vector<uint8_t> bad = base;
      int flips = int(ri(1, 8));
      for (int f = 0; f < flips; f++)
        bad[size_t(ri(0, bad.size() - 1))] = uint8_t(rng());
      drive(bad);
    }
    // Truncations and garbage prefix/suffix.
    for (int c = 0; c < 4; c++) {
      std::vector<uint8_t> t(base.begin(),
                             base.begin() + ri(0, base.size()));
      drive(t);
      std::vector<uint8_t> g(ri(1, 64));
      for (auto& b : g) b = uint8_t(rng());
      if (ri(0, 1)) {
        g.insert(g.end(), base.begin(), base.end());
        drive(g);
      } else {
        std::vector<uint8_t> s = base;
        s.insert(s.end(), g.begin(), g.end());
        drive(s);
      }
    }
    // Pure garbage.
    std::vector<uint8_t> junk(ri(0, 2048));
    for (auto& b : junk) b = uint8_t(rng());
    drive(junk);
  }
  if (fvx_demux_live_handles() != 0) {
    std::fprintf(stderr, "handle leak: %d live\n", fvx_demux_live_handles());
    return 1;
  }
  std::printf("fuzz_native_demux: seed=%llu iters=%d clean\n",
              (unsigned long long)seed, iters);
  return 0;
}
