// Fragmented-MP4 (ISO-BMFF) muxer — native implementation.
//
// The reference vendors two full FFmpeg source trees (~160 MB) solely to
// drive movenc's fragmented output and poke a private NVENC field
// (reference: src/video_encoder.h:16-20, src/video_server.cc:241-280).
// foveax writes the box format directly.  This C++ library is the
// production muxer for the serving hot path; foveax_torch/io/mux.py is the
// always-available pure-Python twin.  The two must produce byte-identical
// output — enforced by tests/test_native.py.
//
// Build: `make -C foveax_torch/native` -> libfoveax_native.so (ctypes-loaded).

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kTimescale = 90000;

class BoxWriter {
 public:
  BoxWriter(uint8_t* buf, int cap) : buf_(buf), cap_(cap), pos_(0), ok_(true) {}

  int pos() const { return ok_ ? pos_ : -1; }
  bool ok() const { return ok_; }

  void u8(uint8_t v) { put(&v, 1); }
  void u16(uint16_t v) {
    uint8_t b[2] = {uint8_t(v >> 8), uint8_t(v)};
    put(b, 2);
  }
  void u32(uint32_t v) {
    uint8_t b[4] = {uint8_t(v >> 24), uint8_t(v >> 16), uint8_t(v >> 8),
                    uint8_t(v)};
    put(b, 4);
  }
  void i32(int32_t v) { u32(static_cast<uint32_t>(v)); }
  void u64(uint64_t v) {
    u32(uint32_t(v >> 32));
    u32(uint32_t(v));
  }
  void raw(const void* data, int n) { put(data, n); }
  void zeros(int n) {
    for (int i = 0; i < n; ++i) u8(0);
  }
  void fourcc(const char* f) { put(f, 4); }

  // Open a box; returns the offset of its size field for close().
  int open(const char* type) {
    int at = pos_;
    u32(0);  // size placeholder
    fourcc(type);
    return at;
  }
  // Full box: version + 24-bit flags.
  int open_full(const char* type, uint8_t version, uint32_t flags) {
    int at = open(type);
    u32((uint32_t(version) << 24) | (flags & 0xFFFFFF));
    return at;
  }
  void close(int at) {
    if (!ok_) return;
    uint32_t size = uint32_t(pos_ - at);
    buf_[at] = uint8_t(size >> 24);
    buf_[at + 1] = uint8_t(size >> 16);
    buf_[at + 2] = uint8_t(size >> 8);
    buf_[at + 3] = uint8_t(size);
  }

  void matrix_identity() {
    i32(0x10000); i32(0); i32(0);
    i32(0); i32(0x10000); i32(0);
    i32(0); i32(0); i32(0x40000000);
  }

 private:
  void put(const void* data, int n) {
    if (!ok_ || pos_ + n > cap_) {
      ok_ = false;
      return;
    }
    // n == 0 with data == nullptr is reachable (empty sample payloads);
    // memcpy's contract forbids null even for zero lengths.
    if (n > 0) std::memcpy(buf_ + pos_, data, n);
    pos_ += n;
  }
  uint8_t* buf_;
  int cap_;
  int pos_;
  bool ok_;
};

}  // namespace

extern "C" {

// ftyp + moov(mvhd, trak, mvex).  Returns bytes written, or -1 on
// insufficient capacity.  cfg_fourcc/cfg/cfg_len (nullable) append a codec
// configuration box inside the visual sample entry — e.g. avcC for avc1
// samples from the H.264 wire codec (foveax_torch/native/codec.cc).
int fvx_init_segment_cfg(uint32_t width, uint32_t height,
                         const char sample_format[4], const char* cfg_fourcc,
                         const uint8_t* cfg, int cfg_len, uint8_t* out,
                         int cap) {
  BoxWriter w(out, cap);

  int ftyp = w.open("ftyp");
  w.fourcc("isom");
  w.u32(0x200);
  w.raw("isomiso5dash", 12);
  w.close(ftyp);

  int moov = w.open("moov");

  int mvhd = w.open_full("mvhd", 0, 0);
  w.u32(0); w.u32(0);          // creation/modification time
  w.u32(kTimescale);
  w.u32(0);                    // duration unknown (fragmented)
  w.i32(0x00010000);           // rate 1.0
  w.u16(0x0100);               // volume
  w.zeros(10);                 // reserved
  w.matrix_identity();
  w.zeros(24);                 // predefined
  w.u32(2);                    // next track id
  w.close(mvhd);

  int trak = w.open("trak");

  int tkhd = w.open_full("tkhd", 0, 7);
  w.u32(0); w.u32(0);
  w.u32(1);                    // track id
  w.u32(0);                    // reserved
  w.u32(0);                    // duration
  w.zeros(8);
  w.u16(0); w.u16(0);          // layer, alternate group
  w.u16(0); w.u16(0);          // volume, reserved
  w.matrix_identity();
  w.u32(width << 16);
  w.u32(height << 16);
  w.close(tkhd);

  int mdia = w.open("mdia");

  int mdhd = w.open_full("mdhd", 0, 0);
  w.u32(0); w.u32(0);
  w.u32(kTimescale);
  w.u32(0);
  w.u16(0x55C4);               // language 'und'
  w.u16(0);
  w.close(mdhd);

  int hdlr = w.open_full("hdlr", 0, 0);
  w.u32(0);
  w.fourcc("vide");
  w.zeros(12);
  w.raw("foveax\0", 7);
  w.close(hdlr);

  int minf = w.open("minf");

  int vmhd = w.open_full("vmhd", 0, 1);
  w.u16(0); w.u16(0); w.u16(0); w.u16(0);
  w.close(vmhd);

  int dinf = w.open("dinf");
  int dref = w.open_full("dref", 0, 0);
  w.u32(1);
  int url = w.open_full("url ", 0, 1);
  w.close(url);
  w.close(dref);
  w.close(dinf);

  int stbl = w.open("stbl");

  int stsd = w.open_full("stsd", 0, 0);
  w.u32(1);
  int entry = w.open(sample_format);
  w.zeros(6);                  // reserved
  w.u16(1);                    // data reference index
  w.zeros(16);                 // predefined/reserved
  w.u16(uint16_t(width));
  w.u16(uint16_t(height));
  w.u32(0x480000);             // 72 dpi horizontal
  w.u32(0x480000);             // 72 dpi vertical
  w.u32(0);
  w.u16(1);                    // frame count
  w.zeros(32);                 // compressor name
  w.u16(24);                   // depth
  w.u16(0xFFFF);               // predefined -1
  if (cfg_fourcc != nullptr && cfg != nullptr && cfg_len > 0) {
    int cfgbox = w.open(cfg_fourcc);
    w.raw(cfg, cfg_len);
    w.close(cfgbox);
  }
  w.close(entry);
  w.close(stsd);

  int stts = w.open_full("stts", 0, 0); w.u32(0); w.close(stts);
  int stsc = w.open_full("stsc", 0, 0); w.u32(0); w.close(stsc);
  int stsz = w.open_full("stsz", 0, 0); w.u32(0); w.u32(0); w.close(stsz);
  int stco = w.open_full("stco", 0, 0); w.u32(0); w.close(stco);

  w.close(stbl);
  w.close(minf);
  w.close(mdia);
  w.close(trak);

  int mvex = w.open("mvex");
  int trex = w.open_full("trex", 0, 0);
  w.u32(1);                    // track id
  w.u32(1);                    // default sample description index
  w.u32(0);                    // default sample duration
  w.u32(0);                    // default sample size
  w.u32(0x01010000);           // default sample flags
  w.close(trex);
  w.close(mvex);

  w.close(moov);
  return w.pos();
}

// Back-compat entry point: no codec configuration box.
int fvx_init_segment(uint32_t width, uint32_t height,
                     const char sample_format[4], uint8_t* out, int cap) {
  return fvx_init_segment_cfg(width, height, sample_format, nullptr, nullptr,
                              0, out, cap);
}

// moof + mdat for one sample.  Returns bytes written, or -1.
int fvx_fragment(uint32_t seq, uint64_t decode_time, const uint8_t* sample,
                 int sample_len, uint32_t duration, int is_sync, uint8_t* out,
                 int cap) {
  BoxWriter w(out, cap);

  int moof = w.open("moof");

  int mfhd = w.open_full("mfhd", 0, 0);
  w.u32(seq);
  w.close(mfhd);

  int traf = w.open("traf");

  // default-base-is-moof (0x020000), matching the reference's movflags.
  int tfhd = w.open_full("tfhd", 0, 0x020000);
  w.u32(1);                    // track id
  w.close(tfhd);

  int tfdt = w.open_full("tfdt", 1, 0);
  w.u64(decode_time);
  w.close(tfdt);

  // trun flags: data-offset | duration | size | flags.
  int trun = w.open_full("trun", 0, 0x000001 | 0x000100 | 0x000200 | 0x000400);
  w.u32(1);                    // sample count
  int offset_at = w.pos();
  w.i32(0);                    // data offset placeholder
  w.u32(duration);
  w.u32(uint32_t(sample_len));
  w.u32(is_sync ? 0x02000000u : 0x01010000u);
  w.close(trun);

  w.close(traf);
  w.close(moof);

  if (!w.ok()) return -1;
  // Patch data offset: first sample byte relative to moof start.
  int moof_size = w.pos();
  int32_t data_offset = moof_size + 8;
  out[offset_at] = uint8_t(data_offset >> 24);
  out[offset_at + 1] = uint8_t(data_offset >> 16);
  out[offset_at + 2] = uint8_t(data_offset >> 8);
  out[offset_at + 3] = uint8_t(data_offset);

  int mdat = w.open("mdat");
  w.raw(sample, sample_len);
  w.close(mdat);
  return w.pos();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Incremental fMP4 demuxer — native twin of foveax_torch.io.mux.FragmentReader.
// Skips ftyp, parses track dimensions from moov/trak/tkhd, fragment
// sequence numbers from moof/mfhd, and queues mdat payloads.

#include <atomic>
#include <cstdlib>
#include <deque>
#include <vector>

namespace {

struct Demuxer {
  std::vector<uint8_t> buf;
  std::deque<std::vector<uint8_t>> samples;
  uint32_t width = 0;
  uint32_t height = 0;
  uint32_t last_seq = 0;
  bool header_seen = false;
  uint32_t header_count = 0;  // init segments seen (>1 = renegotiated)
  char sample_format[4] = {0, 0, 0, 0};   // stsd entry fourcc (e.g. avc1)
  char config_fourcc[4] = {0, 0, 0, 0};   // e.g. avcC — zeroes if none
  std::vector<uint8_t> codec_config;      // config box payload
};

uint32_t rd32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

bool is4(const uint8_t* p, const char* f) { return std::memcmp(p, f, 4) == 0; }

// Scan children of a container box payload [p, p+len).
template <typename Fn>
void for_boxes(const uint8_t* p, size_t len, Fn fn) {
  size_t pos = 0;
  while (pos + 8 <= len) {
    uint32_t size = rd32(p + pos);
    if (size < 8 || pos + size > len) break;
    fn(p + pos + 4, p + pos + 8, size - 8);
    pos += size;
  }
}

// Visual sample entry: 78 fixed bytes after the entry header, then
// optional codec configuration child boxes (ISO 14496-12 section 12.1.3).
constexpr size_t kVisualSampleEntryFixed = 78;

void parse_stsd(Demuxer* d, const uint8_t* body, size_t blen) {
  if (blen < 16) return;  // version/flags(4) + count(4) + one entry header
  const uint8_t* entry = body + 8;
  size_t elen = rd32(entry);
  if (elen < 8 || elen > blen - 8) return;
  std::memcpy(d->sample_format, entry + 4, 4);
  size_t pos = 8 + kVisualSampleEntryFixed;
  while (pos + 8 <= elen) {
    uint32_t csize = rd32(entry + pos);
    if (csize < 8 || pos + csize > elen) break;
    std::memcpy(d->config_fourcc, entry + pos + 4, 4);
    d->codec_config.assign(entry + pos + 8, entry + pos + csize);
    break;  // first config box only (mirrors the Python demuxer)
  }
}

void parse_moov(Demuxer* d, const uint8_t* payload, size_t len) {
  d->header_seen = true;
  d->header_count++;
  for_boxes(payload, len, [&](const uint8_t* fourcc, const uint8_t* body,
                              size_t blen) {
    if (!is4(fourcc, "trak")) return;
    for_boxes(body, blen, [&](const uint8_t* f2, const uint8_t* b2,
                              size_t l2) {
      if (is4(f2, "tkhd") && l2 >= 8) {
        // width/height are the last two u32 (16.16 fixed) of tkhd.
        d->width = rd32(b2 + l2 - 8) >> 16;
        d->height = rd32(b2 + l2 - 4) >> 16;
      } else if (is4(f2, "mdia")) {
        for_boxes(b2, l2, [&](const uint8_t* f3, const uint8_t* b3,
                              size_t l3) {
          if (!is4(f3, "minf")) return;
          for_boxes(b3, l3, [&](const uint8_t* f4, const uint8_t* b4,
                                size_t l4) {
            if (!is4(f4, "stbl")) return;
            for_boxes(b4, l4, [&](const uint8_t* f5, const uint8_t* b5,
                                  size_t l5) {
              if (is4(f5, "stsd")) parse_stsd(d, b5, l5);
            });
          });
        });
      }
    });
  });
}

void parse_moof(Demuxer* d, const uint8_t* payload, size_t len) {
  for_boxes(payload, len,
            [&](const uint8_t* fourcc, const uint8_t* body, size_t blen) {
              if (is4(fourcc, "mfhd") && blen >= 8) {
                d->last_seq = rd32(body + 4);
              }
            });
}

}  // namespace

extern "C" {

// Live demuxer handles (leak probe — the Python side asserts zero after
// session churn; see fx_codec_live_handles in codec.cc for the pattern).
// Atomic: fvx_demux_free runs from whatever thread drops the last Python
// reference (GC/executor), not only the loop thread that created it.
static std::atomic<int> g_live_demuxers{0};

void* fvx_demux_new() {
  g_live_demuxers.fetch_add(1, std::memory_order_relaxed);
  return new Demuxer();
}

void fvx_demux_free(void* h) {
  if (h != nullptr) g_live_demuxers.fetch_sub(1, std::memory_order_relaxed);
  delete static_cast<Demuxer*>(h);
}

int fvx_demux_live_handles() {
  return g_live_demuxers.load(std::memory_order_relaxed);
}

// Feed a chunk; returns the number of samples now queued, or -1 on a
// corrupt box header (stream unrecoverable over a reliable transport).
int fvx_demux_feed(void* h, const uint8_t* chunk, int len) {
  Demuxer* d = static_cast<Demuxer*>(h);
  d->buf.insert(d->buf.end(), chunk, chunk + len);
  size_t pos = 0;
  while (d->buf.size() - pos >= 8) {
    const uint8_t* p = d->buf.data() + pos;
    uint32_t size = rd32(p);
    if (size < 8) return -1;
    if (d->buf.size() - pos < size) break;
    const uint8_t* fourcc = p + 4;
    const uint8_t* payload = p + 8;
    size_t plen = size - 8;
    if (is4(fourcc, "moov")) {
      parse_moov(d, payload, plen);
    } else if (is4(fourcc, "moof")) {
      parse_moof(d, payload, plen);
    } else if (is4(fourcc, "mdat")) {
      d->samples.emplace_back(payload, payload + plen);
    }
    pos += size;
  }
  d->buf.erase(d->buf.begin(), d->buf.begin() + pos);
  return int(d->samples.size());
}

// Pop one sample into out (cap bytes).  Returns its size (0 is a valid
// EMPTY sample — a zero-payload mdat), -1 if none queued, or -(size)
// if cap was too small (sample stays queued; size >= cap+1 >= 2 keeps
// that range disjoint from the -1 sentinel for any real cap).
int fvx_demux_next(void* h, uint8_t* out, int cap) {
  Demuxer* d = static_cast<Demuxer*>(h);
  if (d->samples.empty()) return -1;
  std::vector<uint8_t>& s = d->samples.front();
  if (int(s.size()) > cap) return -int(s.size());
  // An empty vector's data() may be null; memcpy forbids null sources.
  if (!s.empty()) std::memcpy(out, s.data(), s.size());
  int n = int(s.size());
  d->samples.pop_front();
  return n;
}

int fvx_demux_info(void* h, uint32_t* width, uint32_t* height,
                   uint32_t* last_seq, int* header_seen) {
  Demuxer* d = static_cast<Demuxer*>(h);
  *width = d->width;
  *height = d->height;
  *last_seq = d->last_seq;
  *header_seen = d->header_seen ? 1 : 0;
  return 0;
}

// Init segments seen so far (>1 = the stream was renegotiated and the
// decoder must be rebuilt from the new sample entry).
uint32_t fvx_demux_header_count(void* h) {
  return static_cast<Demuxer*>(h)->header_count;
}

// Sample-entry codec info parsed from moov/stsd.  fourcc_out/cfg_fourcc_out
// get 4 bytes each (zeroes when absent).  Returns the config payload length
// (copied into cfg up to cap; -(length) if cap is too small).
int fvx_demux_codec(void* h, char* fourcc_out, char* cfg_fourcc_out,
                    uint8_t* cfg, int cap) {
  Demuxer* d = static_cast<Demuxer*>(h);
  std::memcpy(fourcc_out, d->sample_format, 4);
  std::memcpy(cfg_fourcc_out, d->config_fourcc, 4);
  int n = int(d->codec_config.size());
  if (n == 0) return 0;
  if (n > cap) return -n;
  std::memcpy(cfg, d->codec_config.data(), size_t(n));
  return n;
}

}  // extern "C"
