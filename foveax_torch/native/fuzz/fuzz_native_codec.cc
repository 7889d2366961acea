// ASAN+UBSAN fuzzer for the native codec shim
// (foveax_torch/native/codec.cc; counterpart of the JAX package's
// scripts/fuzz_native_codec.cc): encode real frames, then push corrupted
// and garbage packets through the decoder — including the held-frame
// grow-and-take protocol with deliberately tiny output buffers — and
// hammer open/close cycling for leaks.  libavcodec itself is
// uninstrumented; the target is the shim's own buffer handling.
//
// Build + run: python -m foveax_torch.scripts.fuzz_native codec <seed> <iterations>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

extern "C" {
int fx_codec_probe(const char* codec_name, int encoder);
void* fx_enc_open(const char* codec_name, int width, int height, double fps,
                  int64_t bitrate, int crf, int gop_size, const char* preset,
                  char* err, int errcap);
int fx_enc_extradata(void* enc, uint8_t* out, int cap);
int fx_enc_encode(void* enc, const uint8_t* rgb, uint8_t* out, int cap,
                  int* is_key);
void fx_enc_close(void* enc);
void* fx_dec_open(const char* codec_name, const uint8_t* extradata, int len,
                  char* err, int errcap);
int fx_dec_decode(void* dec, const uint8_t* data, int len, uint8_t* out,
                  int cap, int* out_w, int* out_h);
int fx_dec_take(void* dec, uint8_t* out, int cap, int* out_w, int* out_h);
int fx_dec_flush(void* dec, uint8_t* out, int cap, int* out_w, int* out_h);
void fx_dec_close(void* dec);
int fx_codec_live_handles();
}

namespace {

std::mt19937_64 rng;
uint64_t ri(uint64_t lo, uint64_t hi) { return lo + rng() % (hi - lo + 1); }

// Resolve a decode return the way the Python binding does, with a buffer
// that may be deliberately undersized (exercises grow-and-take).
void resolve(void* dec, int n, int w, int h, std::vector<uint8_t>& buf) {
  if (n < 0 && w > 0 && n == -(w * h * 3)) {
    buf.resize(size_t(-n));
    int w2 = 0, h2 = 0;
    fx_dec_take(dec, buf.data(), int(buf.size()), &w2, &h2);
  }
}

}  // namespace

int main(int argc, char** argv) {
  uint64_t seed = argc > 1 ? strtoull(argv[1], nullptr, 10) : 0;
  int iters = argc > 2 ? atoi(argv[2]) : 40;
  rng.seed(seed);
  if (!fx_codec_probe("libx264", 1) || !fx_codec_probe("h264", 0)) {
    std::printf("fuzz_native_codec: h264 unavailable, skipping\n");
    return 0;
  }
  char err[256];
  for (int it = 0; it < iters; it++) {
    const int w = 16 * int(ri(2, 8)), h = 16 * int(ri(2, 6));
    void* enc = fx_enc_open("libx264", w, h, 30.0, it % 2 ? 200000 : 0, 30, 30,
                            it % 3 ? "ultrafast" : "", err, sizeof(err));
    if (!enc) continue;
    std::vector<uint8_t> extradata(4096);
    int xlen = fx_enc_extradata(enc, extradata.data(), int(extradata.size()));
    if (xlen < 0) xlen = 0;

    std::vector<std::vector<uint8_t>> packets;
    std::vector<uint8_t> rgb(size_t(w) * h * 3);
    std::vector<uint8_t> out(size_t(w) * h * 3 + 4096);
    for (int f = 0; f < 4; f++) {
      for (auto& b : rgb) b = uint8_t(rng());
      int is_key = 0;
      int n = fx_enc_encode(enc, rgb.data(), out.data(), int(out.size()),
                            &is_key);
      if (n > 0) packets.emplace_back(out.begin(), out.begin() + n);
    }
    fx_enc_close(enc);

    // Clean decode with a deliberately tiny buffer: every frame must
    // arrive via the held-frame grow-and-take path.
    void* dec = fx_dec_open("h264", xlen ? extradata.data() : nullptr, xlen,
                            err, sizeof(err));
    if (dec) {
      std::vector<uint8_t> tiny(16);
      for (auto& p : packets) {
        int ow = 0, oh = 0;
        int n = fx_dec_decode(dec, p.data(), int(p.size()), tiny.data(),
                              int(tiny.size()), &ow, &oh);
        resolve(dec, n, ow, oh, tiny);
        tiny.resize(16);  // shrink again so the next frame re-grows
      }
      int ow = 0, oh = 0;
      int n = fx_dec_flush(dec, tiny.data(), int(tiny.size()), &ow, &oh);
      resolve(dec, n, ow, oh, tiny);
      fx_dec_close(dec);
    }

    // Hostile decode: corrupted packets and garbage, fresh decoder each.
    for (int c = 0; c < 10 && !packets.empty(); c++) {
      void* d2 = fx_dec_open("h264", xlen ? extradata.data() : nullptr, xlen,
                             err, sizeof(err));
      if (!d2) continue;
      std::vector<uint8_t> big(size_t(w) * h * 3);
      std::vector<uint8_t> p = packets[c % packets.size()];
      if (c % 3 == 0) {  // pure garbage
        p.resize(ri(0, 512));
        for (auto& b : p) b = uint8_t(rng());
      } else {  // byte flips / truncation
        if (!p.empty() && ri(0, 1)) p.resize(ri(0, p.size()));
        for (int f2 = 0, e = int(ri(1, 6)); f2 < e && !p.empty(); f2++)
          p[size_t(ri(0, p.size() - 1))] = uint8_t(rng());
      }
      int ow = 0, oh = 0;
      int n = fx_dec_decode(d2, p.empty() ? nullptr : p.data(),
                            int(p.size()), big.data(), int(big.size()), &ow,
                            &oh);
      resolve(d2, n, ow, oh, big);
      fx_dec_close(d2);
    }
  }
  if (fx_codec_live_handles() != 0) {
    std::fprintf(stderr, "handle leak: %d live\n", fx_codec_live_handles());
    return 1;
  }
  std::printf("fuzz_native_codec: seed=%llu iters=%d clean\n",
              (unsigned long long)seed, iters);
  return 0;
}
