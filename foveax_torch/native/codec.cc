// Streaming video codec shim — native inter-frame wire codec.
//
// The reference does hardware H.264 on the wire: NVENC encode with
// low-latency tuning on the server (reference: src/video_encoder.cc:3-78,
// async_depth hack :66-77) and a streaming FFmpeg decode on the client
// (reference: src/video_decoder.cc:58-95).  Both are CUDA/desktop-GPU
// choices.  On a TPU host the idiomatic equivalent is a thin native shim
// over the system FFmpeg libraries: libx264 with zerolatency tuning for
// encode, the software h264 decoder with LOW_DELAY for decode, packets
// exchanged frame-by-frame so the asyncio server keeps its one-fragment-
// per-frame cadence (reference: src/video_server.cc:386-405).
//
// Design notes:
//   * One encoder/decoder instance per streaming session — inter-frame
//     state is per-client (each client sees different gaze-dependent
//     frames), matching the reference's per-connection VideoEncoder
//     (reference: src/video_server.h:41).
//   * H.264 packets are converted from Annex-B start codes to 4-byte
//     length-prefixed NALUs here, so the samples drop straight into the
//     fMP4 muxer's mdat as valid avc1 samples (the reference leaves this
//     to movenc; foveax owns its muxer, so it owns the framing too).
//   * Zero-latency contract: with tune=zerolatency and max_b_frames=0,
//     every send_frame produces exactly one packet — the 33 ms tick never
//     waits on encoder queueing (the property the reference patches a
//     private NVENC field to get, src/video_encoder.cc:66-77).
//
// Build: `make -C foveax_torch/native` -> libfoveax_codec.so (ctypes-loaded).
// The build is optional: when FFmpeg dev headers are absent the muxer
// library still builds and the Python layer falls back to JPEG samples.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswscale/swscale.h>
}

#include <unistd.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

namespace {

void set_err(char* errbuf, int errcap, const std::string& msg) {
  if (errbuf == nullptr || errcap <= 0) return;
  std::snprintf(errbuf, size_t(errcap), "%s", msg.c_str());
}

bool is_h26x(const char* name) {
  return std::strcmp(name, "libx264") == 0 || std::strcmp(name, "h264") == 0 ||
         std::strcmp(name, "libx265") == 0 || std::strcmp(name, "hevc") == 0;
}

// Annex-B (00 00 [00] 01 start codes) -> 4-byte big-endian length prefixes.
// Returns false if no start code is found (input passed through verbatim).
bool annexb_to_avcc(const uint8_t* in, int len, std::vector<uint8_t>* out) {
  int pos = 0;
  auto find_start = [&](int from, int* sc_len) -> int {
    for (int i = from; i + 3 <= len; ++i) {
      if (in[i] == 0 && in[i + 1] == 0) {
        if (in[i + 2] == 1) {
          *sc_len = 3;
          return i;
        }
        if (i + 4 <= len && in[i + 2] == 0 && in[i + 3] == 1) {
          *sc_len = 4;
          return i;
        }
      }
    }
    return -1;
  };
  int sc = 0;
  int first = find_start(0, &sc);
  if (first < 0) return false;
  pos = first + sc;
  while (pos < len) {
    int next_sc = 0;
    int next = find_start(pos, &next_sc);
    int nal_end = next < 0 ? len : next;
    uint32_t nal_len = uint32_t(nal_end - pos);
    out->push_back(uint8_t(nal_len >> 24));
    out->push_back(uint8_t(nal_len >> 16));
    out->push_back(uint8_t(nal_len >> 8));
    out->push_back(uint8_t(nal_len));
    out->insert(out->end(), in + pos, in + nal_end);
    if (next < 0) break;
    pos = next + next_sc;
  }
  return true;
}

// Live-handle accounting: a leak detector for the binding layer.  The
// Python side can assert this returns to zero after churn (sessions
// joining/leaving must release every native codec handle — the reference
// leaked detached encoder threads here, src/video_server.cc:213-239).
static std::atomic<int> g_live_handles{0};

struct Encoder {
  AVCodecContext* ctx = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  SwsContext* sws = nullptr;
  // Padded, av_malloc-aligned staging for the caller's packed RGB input.
  // libswscale's SIMD paths READ a few bytes past the last source row;
  // the caller's buffer (numpy memory through ctypes) carries no padding
  // guarantee, so feeding it directly is a rare layout-dependent SEGV
  // (caught by an ASAN fuzz run: a w*h*3 buffer ending exactly at an
  // unmapped page faulted at 112x96).
  uint8_t* staging = nullptr;
  int width = 0;
  int height = 0;
  int64_t next_pts = 0;
  bool length_prefix = false;  // h26x: convert Annex-B -> AVCC framing

  Encoder() { g_live_handles.fetch_add(1, std::memory_order_relaxed); }
  ~Encoder() {
    g_live_handles.fetch_sub(1, std::memory_order_relaxed);
    if (staging != nullptr) av_free(staging);
    if (sws != nullptr) sws_freeContext(sws);
    if (pkt != nullptr) av_packet_free(&pkt);
    if (frame != nullptr) av_frame_free(&frame);
    if (ctx != nullptr) avcodec_free_context(&ctx);
  }
};

struct Decoder {
  AVCodecContext* ctx = nullptr;
  AVFrame* frame = nullptr;
  AVPacket* pkt = nullptr;
  SwsContext* sws = nullptr;
  // Padded staging for the packed RGB output (same hazard as the
  // encoder's input: sws SIMD tails must not touch the caller's
  // exact-size buffer past its end).  Sized with the cached sws dims.
  uint8_t* staging = nullptr;
  int sws_w = 0, sws_h = 0;
  AVPixelFormat sws_fmt = AV_PIX_FMT_NONE;
  // A decoded frame retained after a buffer-too-small return, so the
  // caller can grow its buffer and fetch it with fx_dec_take without
  // re-sending the packet (which would corrupt inter-frame state).
  bool held = false;
  // Frames drained while re-sending an EAGAIN'd packet (a packet that
  // emitted more than two frames).  Delivered oldest-first before any
  // new receive_frame so output order is preserved.
  std::deque<AVFrame*> pending;

  Decoder() { g_live_handles.fetch_add(1, std::memory_order_relaxed); }
  ~Decoder() {
    g_live_handles.fetch_sub(1, std::memory_order_relaxed);
    for (AVFrame* f : pending) av_frame_free(&f);
    if (staging != nullptr) av_free(staging);
    if (sws != nullptr) sws_freeContext(sws);
    if (pkt != nullptr) av_packet_free(&pkt);
    if (frame != nullptr) av_frame_free(&frame);
    if (ctx != nullptr) avcodec_free_context(&ctx);
  }
};

}  // namespace

extern "C" {

// Keep libav quiet on the serving hot path (x264 prints multi-line info
// banners per encoder open; the asyncio server opens one per session).
__attribute__((constructor)) static void fx_quiet_logs() {
  av_log_set_level(AV_LOG_ERROR);
}

// 1 if the named encoder (encoder=1) / decoder (encoder=0) exists.
// Encoder+decoder handles currently alive in this process (leak probe).
int fx_codec_live_handles() {
  return g_live_handles.load(std::memory_order_relaxed);
}

int fx_codec_probe(const char* codec_name, int encoder) {
  if (encoder) return avcodec_find_encoder_by_name(codec_name) != nullptr;
  return avcodec_find_decoder_by_name(codec_name) != nullptr;
}

// Open a streaming encoder.  bitrate<=0 means quality-targeted (crf) mode;
// crf<0 means bitrate mode; gop_size<=0 uses the codec default.  The
// reference's operating point is bitrate 1e8 + cq 25 + no B-frames + zero
// encoder delay (src/video_encoder.cc:28-58); its NVENC preset knob is
// "fast" (src/video_encoder.cc:28) — foveax's software analog is the
// x264 preset ladder, `preset` (NULL/"" = veryfast).  For libvpx the
// preset maps onto cpu-used (ultrafast=8 .. medium=3); mpeg4 ignores it.
void* fx_enc_open(const char* codec_name, int width, int height, double fps,
                  int64_t bitrate, int crf, int gop_size, const char* preset,
                  char* errbuf, int errcap) {
  const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
  if (codec == nullptr) {
    set_err(errbuf, errcap, std::string("no encoder: ") + codec_name);
    return nullptr;
  }
  auto* e = new Encoder();
  e->width = width;
  e->height = height;
  e->length_prefix = is_h26x(codec_name);
  e->ctx = avcodec_alloc_context3(codec);
  AVCodecContext* c = e->ctx;
  c->width = width;
  c->height = height;
  c->time_base = av_d2q(1.0 / fps, 1 << 24);
  c->framerate = av_d2q(fps, 1 << 24);
  c->pix_fmt = AV_PIX_FMT_YUV420P;
  c->max_b_frames = 0;  // reference: src/video_encoder.cc:49
  if (gop_size > 0) c->gop_size = gop_size;
  if (bitrate > 0) c->bit_rate = bitrate;
  // Global header: SPS/PPS land in extradata (the avcC source), not in
  // every packet — required for ISO-BMFF avc1 samples.  (LOW_DELAY is a
  // decode-side flag; mpeg4 rejects it on encoders.)
  c->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;

  const char* p = (preset != nullptr && preset[0] != '\0') ? preset
                                                           : "veryfast";
  if (std::strcmp(codec_name, "libx264") == 0 ||
      std::strcmp(codec_name, "libx265") == 0) {
    if (av_opt_set(c->priv_data, "preset", p, 0) < 0) {
      set_err(errbuf, errcap, std::string("bad preset: ") + p);
      delete e;
      return nullptr;
    }
    av_opt_set(c->priv_data, "tune", "zerolatency", 0);
    if (bitrate > 0) {
      // Rate-targeted mode: x264's rate-control precedence is
      // crf > qp > ABR, so setting crf here would silently IGNORE
      // bit_rate (every target would encode at identical bytes).  ABR
      // plus a tight VBV (~2 frames) makes the target hold per-RTT —
      // required for live AIMD adaptation to actually move the wire.
      c->rc_max_rate = bitrate;
      double f = fps > 1.0 ? fps : 30.0;
      c->rc_buffer_size = (int)(2.0 * bitrate / f);
    } else if (crf >= 0) {
      av_opt_set_int(c->priv_data, "crf", crf, 0);
    }
    // Sliced threading: parallel encode within one frame, zero added
    // latency (frame threading would queue frames — the delay the
    // reference kills via its NVENC async_depth hack).  Capped at the
    // cores actually available: surplus slice threads are pure wake-up
    // overhead, and with many per-session encoders on a small host the
    // idle pools thrash the scheduler (measured 40x round-robin slowdown
    // at 32 encoders x 4 threads on one core).
    long cores = sysconf(_SC_NPROCESSORS_ONLN);
    int threads = cores < 1 ? 1 : (cores > 4 ? 4 : int(cores));
    if (threads > 1) {
      c->thread_count = threads;
      c->thread_type = FF_THREAD_SLICE;
    } else {
      c->thread_count = 1;
    }
  } else if (std::strncmp(codec_name, "libvpx", 6) == 0) {
    av_opt_set(c->priv_data, "deadline", "realtime", 0);
    // Map the x264 preset vocabulary onto vpx's cpu-used speed dial so
    // one serve flag drives both codecs (default = fastest).
    int cpu_used = 8;
    if (std::strcmp(p, "superfast") == 0) cpu_used = 7;
    else if (std::strcmp(p, "veryfast") == 0) cpu_used = 8;
    else if (std::strcmp(p, "faster") == 0) cpu_used = 5;
    else if (std::strcmp(p, "fast") == 0) cpu_used = 4;
    else if (std::strcmp(p, "medium") == 0) cpu_used = 3;
    av_opt_set_int(c->priv_data, "cpu-used", cpu_used, 0);
    av_opt_set_int(c->priv_data, "lag-in-frames", 0, 0);
    // libvpx precedence: crf + bit_rate = constrained-quality (crf-led);
    // bitrate mode must therefore omit crf to rate-target for real.
    if (bitrate <= 0 && crf >= 0)
      av_opt_set_int(c->priv_data, "crf", crf, 0);
    if (bitrate <= 0) c->bit_rate = 2'000'000;  // vpx needs a rate target
    if (bitrate > 0) {
      // libvpx only rate-TARGETS in CBR mode, which its libavcodec
      // wrapper selects when minrate == maxrate == bit_rate (plain
      // bit_rate alone is VBR guidance and overshoots ~3x on hostile
      // content).  Buffer ~0.5 s: vpx counts its rc buffer in ms and
      // stalls quality with per-frame-sized windows.
      c->rc_min_rate = bitrate;
      c->rc_max_rate = bitrate;
      c->rc_buffer_size = (int)(0.5 * bitrate);
    }
  } else if (std::strcmp(codec_name, "mpeg4") == 0) {
    if (bitrate > 0) {
      // mpeg4's rate control underflows a 2-frame buffer on hostile
      // content (its quantizer range can't always hit the per-frame
      // budget); half a second keeps targeting tight without the
      // underflow spiral.
      c->rc_max_rate = bitrate;
      c->rc_buffer_size = (int)(0.5 * bitrate);
    }
    // QSCALE (constant quantizer) disables rate control entirely — only
    // valid in quality mode.
    if (bitrate <= 0 && crf >= 0) {  // map crf onto the 1..31 qscale range
      c->flags |= AV_CODEC_FLAG_QSCALE;
      int q = crf < 1 ? 1 : (crf > 31 ? 31 : crf);
      c->global_quality = FF_QP2LAMBDA * q;
    }
  }

  int rc = avcodec_open2(c, codec, nullptr);
  if (rc < 0) {
    char buf[128];
    av_strerror(rc, buf, sizeof buf);
    set_err(errbuf, errcap, std::string("avcodec_open2: ") + buf);
    delete e;
    return nullptr;
  }
  e->frame = av_frame_alloc();
  e->frame->format = c->pix_fmt;
  e->frame->width = width;
  e->frame->height = height;
  if (av_frame_get_buffer(e->frame, 0) < 0) {
    set_err(errbuf, errcap, "av_frame_get_buffer failed");
    delete e;
    return nullptr;
  }
  e->pkt = av_packet_alloc();
  e->sws = sws_getContext(width, height, AV_PIX_FMT_RGB24, width, height,
                          AV_PIX_FMT_YUV420P, SWS_BILINEAR, nullptr, nullptr,
                          nullptr);
  if (e->sws == nullptr) {
    set_err(errbuf, errcap, "sws_getContext failed");
    delete e;
    return nullptr;
  }
  e->staging = static_cast<uint8_t*>(
      av_malloc(size_t(width) * height * 3 + AV_INPUT_BUFFER_PADDING_SIZE));
  if (e->staging == nullptr) {
    set_err(errbuf, errcap, "staging alloc failed");
    delete e;
    return nullptr;
  }
  return e;
}

// Codec configuration bytes (for h26x: Annex-B SPS/PPS; the Python layer
// assembles the avcC record).  Returns length, or -(length) if cap is too
// small, 0 if none.
int fx_enc_extradata(void* enc, uint8_t* out, int cap) {
  auto* e = static_cast<Encoder*>(enc);
  int n = e->ctx->extradata_size;
  if (n <= 0) return 0;
  if (n > cap) return -n;
  std::memcpy(out, e->ctx->extradata, size_t(n));
  return n;
}

// Encode one packed RGB24 frame (height*width*3 bytes).  Writes the
// encoded sample into out; *is_key set to 1 on keyframes.  Returns sample
// size, 0 if the encoder buffered the frame (does not happen with the
// zerolatency settings), -(needed) if cap is too small, or -1000000-errno
// style codes on hard errors.
int fx_enc_encode(void* enc, const uint8_t* rgb, uint8_t* out, int cap,
                  int* is_key) {
  auto* e = static_cast<Encoder*>(enc);
  if (av_frame_make_writable(e->frame) < 0) return -1000001;
  // Stage through the padded buffer: sws may read a SIMD tail past the
  // last row, which the caller's exact-size buffer does not guarantee.
  std::memcpy(e->staging, rgb, size_t(e->width) * e->height * 3);
  const uint8_t* src[1] = {e->staging};
  const int src_stride[1] = {e->width * 3};
  sws_scale(e->sws, src, src_stride, 0, e->height, e->frame->data,
            e->frame->linesize);
  e->frame->pts = e->next_pts++;
  int rc = avcodec_send_frame(e->ctx, e->frame);
  if (rc < 0) return -1000002;

  std::vector<uint8_t> sample;
  int key = 0;
  while (true) {
    rc = avcodec_receive_packet(e->ctx, e->pkt);
    if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) break;
    if (rc < 0) return -1000003;
    if ((e->pkt->flags & AV_PKT_FLAG_KEY) != 0) key = 1;
    if (e->length_prefix) {
      if (!annexb_to_avcc(e->pkt->data, e->pkt->size, &sample)) {
        // Already length-prefixed (shouldn't happen) — pass through.
        sample.insert(sample.end(), e->pkt->data, e->pkt->data + e->pkt->size);
      }
    } else {
      sample.insert(sample.end(), e->pkt->data, e->pkt->data + e->pkt->size);
    }
    av_packet_unref(e->pkt);
  }
  if (is_key != nullptr) *is_key = key;
  if (sample.empty()) return 0;
  if (int(sample.size()) > cap) return -int(sample.size());
  std::memcpy(out, sample.data(), sample.size());
  return int(sample.size());
}

void fx_enc_close(void* enc) { delete static_cast<Encoder*>(enc); }

// Open a streaming decoder.  extradata (may be null) is the codec config
// exactly as carried in the container (for h264: the avcC record — its
// presence switches the decoder to length-prefixed NALU input, matching
// the samples fx_enc_encode emits).
void* fx_dec_open(const char* codec_name, const uint8_t* extradata, int len,
                  char* errbuf, int errcap) {
  const AVCodec* codec = avcodec_find_decoder_by_name(codec_name);
  if (codec == nullptr) {
    set_err(errbuf, errcap, std::string("no decoder: ") + codec_name);
    return nullptr;
  }
  auto* d = new Decoder();
  d->ctx = avcodec_alloc_context3(codec);
  d->ctx->flags |= AV_CODEC_FLAG_LOW_DELAY;
  if (extradata != nullptr && len > 0) {
    d->ctx->extradata = static_cast<uint8_t*>(
        av_mallocz(size_t(len) + AV_INPUT_BUFFER_PADDING_SIZE));
    std::memcpy(d->ctx->extradata, extradata, size_t(len));
    d->ctx->extradata_size = len;
  }
  int rc = avcodec_open2(d->ctx, codec, nullptr);
  if (rc < 0) {
    char buf[128];
    av_strerror(rc, buf, sizeof buf);
    set_err(errbuf, errcap, std::string("avcodec_open2: ") + buf);
    delete d;
    return nullptr;
  }
  d->frame = av_frame_alloc();
  d->pkt = av_packet_alloc();
  return d;
}

// Convert the frame sitting in d->frame to packed RGB24.  Returns 1 and
// clears the frame, or -(needed) with the frame HELD (d->held, *out_w/h
// set) when cap is too small — the caller grows its buffer and calls
// fx_dec_take.  Hard errors (<= -1000000) leave *out_w/h at 0, which is
// how callers distinguish them from the -(needed) space (needed can
// exceed 1000000 for >= ~0.6 MP frames).
static int fx__convert(Decoder* d, uint8_t* out, int cap, int* out_w,
                       int* out_h) {
  int w = d->frame->width, h = d->frame->height;
  if (w * h * 3 > cap) {
    d->held = true;
    if (out_w != nullptr) *out_w = w;
    if (out_h != nullptr) *out_h = h;
    return -(w * h * 3);
  }
  auto fmt = static_cast<AVPixelFormat>(d->frame->format);
  if (d->sws == nullptr || d->sws_w != w || d->sws_h != h ||
      d->sws_fmt != fmt) {
    if (d->sws != nullptr) sws_freeContext(d->sws);
    d->sws = sws_getContext(w, h, fmt, w, h, AV_PIX_FMT_RGB24, SWS_BILINEAR,
                            nullptr, nullptr, nullptr);
    d->sws_w = w;
    d->sws_h = h;
    d->sws_fmt = fmt;
    if (d->staging != nullptr) av_free(d->staging);
    d->staging = static_cast<uint8_t*>(
        av_malloc(size_t(w) * h * 3 + AV_INPUT_BUFFER_PADDING_SIZE));
    if (d->sws == nullptr || d->staging == nullptr) {
      av_frame_unref(d->frame);
      d->held = false;
      return -1000005;
    }
  }
  // Stage the packed RGB through the padded buffer, then copy the exact
  // w*h*3 bytes out: sws SIMD tails must never touch the caller's
  // exact-size buffer past its end (same hazard as the encoder input).
  uint8_t* dst[1] = {d->staging};
  const int dst_stride[1] = {w * 3};
  sws_scale(d->sws, d->frame->data, d->frame->linesize, 0, h, dst, dst_stride);
  std::memcpy(out, d->staging, size_t(w) * h * 3);
  av_frame_unref(d->frame);
  d->held = false;
  if (out_w != nullptr) *out_w = w;
  if (out_h != nullptr) *out_h = h;
  return 1;
}

// Fetch a frame retained by a previous -(needed) return (see fx__convert).
// Returns like fx_dec_decode; 0 if nothing is held.
int fx_dec_take(void* dec, uint8_t* out, int cap, int* out_w, int* out_h) {
  auto* d = static_cast<Decoder*>(dec);
  if (!d->held) return 0;
  return fx__convert(d, out, cap, out_w, out_h);
}

// Feed one sample; if a frame comes out, convert to packed RGB24 into out.
// Returns 1 (frame written, *out_w/*out_h set), 0 (no frame yet), -(needed)
// with *out_w/h set and the frame held if cap is too small (grow and call
// fx_dec_take), or <=-1000000 on errors (*out_w/h left 0).
int fx_dec_decode(void* dec, const uint8_t* data, int len, uint8_t* out,
                  int cap, int* out_w, int* out_h) {
  auto* d = static_cast<Decoder*>(dec);
  if (out_w != nullptr) *out_w = 0;
  if (out_h != nullptr) *out_h = 0;
  if (d->held) return -1000008;  // caller must fx_dec_take first
  // AV_INPUT_BUFFER_PADDING_SIZE guarantee: copy into a padded buffer.
  uint8_t* padded = static_cast<uint8_t*>(
      av_mallocz(size_t(len) + AV_INPUT_BUFFER_PADDING_SIZE));
  if (padded == nullptr) return -1000001;
  std::memcpy(padded, data, size_t(len));
  av_packet_unref(d->pkt);
  if (av_packet_from_data(d->pkt, padded, len) < 0) {
    av_free(padded);
    return -1000002;
  }
  int rc = avcodec_send_packet(d->ctx, d->pkt);
  // Output queue full (a packet emitted multiple frames): drain frames
  // (queueing the extras) and re-send until the packet is accepted — it
  // is NOT consumed on EAGAIN, so dropping it would desync every later
  // P-frame.
  while (rc == AVERROR(EAGAIN)) {
    AVFrame* f = av_frame_alloc();
    if (f == nullptr) {
      av_packet_unref(d->pkt);
      return -1000001;
    }
    int rc2 = avcodec_receive_frame(d->ctx, f);
    if (rc2 < 0) {
      av_frame_free(&f);
      av_packet_unref(d->pkt);
      return -1000006;
    }
    d->pending.push_back(f);
    rc = avcodec_send_packet(d->ctx, d->pkt);
  }
  av_packet_unref(d->pkt);
  if (rc < 0) return -1000003;

  // Latest-wins: the only caller is the streaming wire decoder
  // (foveax_torch/io/wirecodec.py), whose client pairs each returned frame
  // with the metadata of the packet it just fed.  Returning a stale
  // queued frame here would shift that pairing for every later frame
  // (gaze echo newer than the pixels) until a flush — so when the
  // drain queued extras, drop all but the newest and prefer a frame
  // the codec can emit for THIS packet.  (fx_dec_flush still drains
  // the queue in order: at end of stream nothing newer is coming.)
  while (d->pending.size() > 1) {
    AVFrame* f = d->pending.front();
    d->pending.pop_front();
    av_frame_free(&f);
  }
  rc = avcodec_receive_frame(d->ctx, d->frame);
  if (rc == 0) {
    if (!d->pending.empty()) {
      AVFrame* f = d->pending.front();
      d->pending.pop_front();
      av_frame_free(&f);
    }
    return fx__convert(d, out, cap, out_w, out_h);
  }
  if (!d->pending.empty()) {
    AVFrame* f = d->pending.front();
    d->pending.pop_front();
    av_frame_unref(d->frame);
    av_frame_move_ref(d->frame, f);
    av_frame_free(&f);
    return fx__convert(d, out, cap, out_w, out_h);
  }
  if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
  if (rc < 0) return -1000004;
  return fx__convert(d, out, cap, out_w, out_h);
}

// Drain any frames still buffered in the decoder (end of stream).
// Same return convention as fx_dec_decode.
int fx_dec_flush(void* dec, uint8_t* out, int cap, int* out_w, int* out_h) {
  auto* d = static_cast<Decoder*>(dec);
  if (out_w != nullptr) *out_w = 0;
  if (out_h != nullptr) *out_h = 0;
  if (d->held) return fx__convert(d, out, cap, out_w, out_h);
  if (!d->pending.empty()) {
    AVFrame* f = d->pending.front();
    d->pending.pop_front();
    av_frame_unref(d->frame);
    av_frame_move_ref(d->frame, f);
    av_frame_free(&f);
    return fx__convert(d, out, cap, out_w, out_h);
  }
  avcodec_send_packet(d->ctx, nullptr);
  int rc = avcodec_receive_frame(d->ctx, d->frame);
  if (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) return 0;
  if (rc < 0) return -1000004;
  return fx__convert(d, out, cap, out_w, out_h);
}

void fx_dec_close(void* dec) { delete static_cast<Decoder*>(dec); }

}  // extern "C"
