// foveax browser client: inverse log-rectilinear axis math + fMP4 demux.
//
// JS port of the separable unwarp cell construction
// (foveax/core/unwarp.py::_axis_vectors, foveax/core/logrect.py delta math;
// reference: src/sat_decoder_interpolate_kernel.cl:1-151).  The per-axis
// lo/hi/ratio vectors are computed here on the CPU — O(W + H) per gaze —
// and the per-pixel 4-tap blend runs in a WebGL2 fragment shader
// (viewer.html), mirroring how the TPU path splits the same work between
// host-precomputed 1-D vectors and dense device gathers.
//
// float32 semantics: the Python device path computes the inverse log map in
// float32; JS numbers are float64, so every intermediate is squeezed
// through Math.fround.  Residual transcendental differences (<1 ulp in
// log/pow) can flip a ceil() at cell boundaries — that moves a blend
// seam by one *log cell*, which the snap guard below bounds to the same
// 1-LSB envelope the Python fast path is tested to.
"use strict";

// float32 value of exp(1.0f) - 1, as the OpenCL kernels compute it
// (reference: src/sat_decoder_sample_rect_kernel.cl:156-157).
const EM1_F32 = Math.fround(Math.fround(Math.exp(1)) - 1);
const F = Math.fround;

function lamF32(dim) {
  return F(F(dim) / EM1_F32);
}

// float64 host-side delta — the authoritative grid math
// (foveax/core/logrect.py::delta64).
function delta64(u, outDim, sourceDim) {
  const au = Math.abs(u);
  const magF =
    (sourceDim / (Math.E - 1.0)) *
    (Math.exp(Math.pow((2.0 * au) / outDim, 4)) - 1.0);
  const mag = Math.max(au, Math.trunc(magF));
  return mag * Math.sign(u);
}

// Reduced-size rule 16*ceil(dim/1.8/16)
// (reference: src/run_satlogrectilinear.cc:113-114,368-369).
function reducedDim(dim) {
  return 16 * Math.ceil(Math.trunc(dim / 1.8) / 16);
}

// Per-axis unwarp vectors: Float32Array of (lo, hi, ratio, 0) quads, one
// per output pixel, ready for RGBA32F texture upload.  `center01` is the
// gaze coordinate in [0, 1] on this axis.
function axisVectors(outDim, redDim, center01, wrap) {
  const lamOut = lamF32(outDim);
  const cp = Math.trunc(F(center01 * outDim));
  const uOff = Math.floor(redDim / 2) + 2;
  const lut = new Int32Array(2 * uOff + 1);
  for (let u = -uOff; u <= uOff; u++) lut[u + uOff] = delta64(u, redDim, outDim);

  const half = Math.floor(outDim / 2);
  const halfR = Math.floor(redDim / 2);
  const out = new Float32Array(outDim * 4);

  for (let p = 0; p < outDim; p++) {
    // 360-degree wrap relative to the gaze (reference kernel :27-33).
    let shift = 0;
    if (wrap) {
      if (p - cp > half) shift = -outDim;
      else if (p - cp < -half) shift = outDim;
    }
    const offset = shift !== 0;
    const pw = p + shift;
    const d = pw - cp;

    // Inverse log map in emulated float32 (reference kernel :43-48).
    const ad = F(Math.abs(d));
    const x = F(F(ad / lamOut) + 1);
    const r4 = F(Math.pow(F(Math.log(x)), 0.25));
    const uMag = Math.ceil(F(F(0.5 * redDim) * r4));
    const uRaw = uMag * Math.sign(d);
    const u = Math.abs(uRaw) > Math.abs(d) || uRaw === 0 ? d : uRaw;

    const dCalc = lut[u + uOff];
    // Neighbour cell toward the center; sign taken from u, not u+du
    // (reference kernel :75-89).
    const du = -Math.sign(d);
    const dMin = Math.abs(lut[u + du + uOff]) * Math.sign(u);

    const lo = cp + Math.min(dMin, dCalc);
    const hi = cp + Math.max(dMin, dCalc);
    let uLo = Math.min(u, u + du);
    let uHi = Math.max(u, u + du);

    // Edge clamping (reference kernel :105-116 — the wrap-axis conditions
    // carry "&& !x_offset", the other axis' do not).
    if (wrap) {
      if (lo < 0 && !offset) uLo = uHi;
      if (hi >= outDim && !offset) uHi = uLo;
    } else {
      if (lo < 0) uLo = uHi;
      if (hi >= outDim) uHi = uLo;
    }

    const ratio =
      hi === lo ? 0 : Math.min(1, Math.max(0, (pw - lo) / (hi - lo)));
    const iLo = Math.min(redDim - 1, Math.max(0, uLo + halfR));
    const iHi = Math.min(redDim - 1, Math.max(0, uHi + halfR));
    out[4 * p] = iLo;
    out[4 * p + 1] = iHi;
    out[4 * p + 2] = ratio;
  }
  return out;
}

// --- minimal fMP4 demux (mirror of foveax/io/mux.py::FragmentReader) -----

function be32(buf, pos) {
  return (
    ((buf[pos] << 24) | (buf[pos + 1] << 16) | (buf[pos + 2] << 8) | buf[pos + 3]) >>> 0
  );
}

function fourcc(buf, pos) {
  return String.fromCharCode(buf[pos], buf[pos + 1], buf[pos + 2], buf[pos + 3]);
}

class FragmentReader {
  constructor() {
    this.buf = new Uint8Array(0);
    this.headerSeen = false;
    // Init segments seen; >1 means the server renegotiated its encoder
    // (rate adaptation) — a WebCodecs decoder must be reconfigured from
    // the new codecConfig (the JPEG path is stateless and just works).
    this.headerCount = 0;
    // 0 = "tkhd not (yet) parsed", as the native demuxer's
    // zero-initialized struct; the getters report null until an init
    // segment arrives, matching the Python/native bindings exactly.
    this._width = 0;
    this._height = 0;
    this.lastSeq = 0;
    this.sampleFormat = null;
    this.codecConfig = null; // {fourcc, payload: Uint8Array}
  }

  get width() { return this.headerSeen ? this._width : null; }
  get height() { return this.headerSeen ? this._height : null; }

  feed(chunk) {
    const merged = new Uint8Array(this.buf.length + chunk.length);
    merged.set(this.buf, 0);
    merged.set(chunk, this.buf.length);
    this.buf = merged;
    const samples = [];
    for (;;) {
      if (this.buf.length < 8) break;
      const size = be32(this.buf, 0);
      if (size < 8) throw new Error(`corrupt fMP4 box header (size=${size})`);
      if (this.buf.length < size) break;
      const fc = fourcc(this.buf, 4);
      const payload = this.buf.subarray(8, size);
      if (fc === "moov") {
        this.headerSeen = true;
        this.headerCount += 1;
        this._parseMoov(payload);
      } else if (fc === "moof") {
        this._parseMoof(payload);
      } else if (fc === "mdat") {
        samples.push(payload.slice()); // copy out of the rolling buffer
      }
      this.buf = this.buf.slice(size);
    }
    return samples;
  }

  *_boxes(data, start, end) {
    let pos = start;
    while (pos + 8 <= end) {
      const size = be32(data, pos);
      if (size < 8 || pos + size > end) break;
      yield [fourcc(data, pos + 4), pos + 8, pos + size];
      pos += size;
    }
  }

  _parseMoof(payload) {
    for (const [fc, s, e] of this._boxes(payload, 0, payload.length)) {
      // Guard as the Python/native demuxers do: a truncated mfhd body
      // (< 8 bytes) must be skipped, not read as a garbage sequence.
      if (fc === "mfhd" && e - s >= 8) this.lastSeq = be32(payload, s + 4);
    }
  }

  // Visual sample entry: 78 fixed bytes after the entry header, then
  // optional codec configuration child boxes (ISO 14496-12 s12.1.3).
  _parseStsd(buf, start, end) {
    if (end - start < 16) return;
    const entryAt = start + 8;
    const esize = be32(buf, entryAt);
    if (esize < 8 || entryAt + esize > end) return;
    this.sampleFormat = fourcc(buf, entryAt + 4);
    const pos = entryAt + 8 + 78;
    if (pos + 8 <= entryAt + esize) {
      const csize = be32(buf, pos);
      if (csize >= 8 && pos + csize <= entryAt + esize) {
        this.codecConfig = {
          fourcc: fourcc(buf, pos + 4),
          payload: buf.slice(pos + 8, pos + csize),
        };
      }
    }
  }

  _parseMoov(payload) {
    for (const [fc, s, e] of this._boxes(payload, 0, payload.length)) {
      if (fc !== "trak") continue;
      for (const [fc2, s2, e2] of this._boxes(payload, s, e)) {
        if (fc2 === "tkhd" && e2 - s2 >= 8) {
          // Size guard as the Python/native parsers: a truncated tkhd
          // must be skipped, not read as bytes of the preceding box.
          this._width = be32(payload, e2 - 8) >>> 16;
          this._height = be32(payload, e2 - 4) >>> 16;
        } else if (fc2 === "mdia") {
          for (const [fc3, s3, e3] of this._boxes(payload, s2, e2)) {
            if (fc3 !== "minf") continue;
            for (const [fc4, s4, e4] of this._boxes(payload, s3, e3)) {
              if (fc4 !== "stbl") continue;
              for (const [fc5, s5, e5] of this._boxes(payload, s4, e4)) {
                if (fc5 === "stsd") this._parseStsd(payload, s5, e5);
              }
            }
          }
        }
      }
    }
  }
}

// --- WebGL2 unwarp shaders (shared by viewer.html and selftest.html so
// --- the self-test always exercises the shader the viewer renders with).

const UNWARP_VS = `#version 300 es
void main() {
  // Fullscreen triangle.
  vec2 p = vec2((gl_VertexID << 1) & 2, gl_VertexID & 2);
  gl_Position = vec4(p * 2.0 - 1.0, 0.0, 1.0);
}`;

// Per-pixel 4-tap bilinear blend between the two enclosing log cells per
// axis — the device unwarp's inner loop (foveax/core/unwarp.py,
// reference: src/sat_decoder_interpolate_kernel.cl:74-151).  Axis
// textures carry (lo, hi, ratio) per output column/row.
const UNWARP_FS = `#version 300 es
precision highp float;
uniform sampler2D u_frame;
uniform sampler2D u_ax;
uniform sampler2D u_ay;
uniform int u_outH;
out vec4 o;
void main() {
  int x = int(gl_FragCoord.x);
  int y = u_outH - 1 - int(gl_FragCoord.y);
  vec4 ax = texelFetch(u_ax, ivec2(x, 0), 0);
  vec4 ay = texelFetch(u_ay, ivec2(y, 0), 0);
  int xl = int(ax.x), xh = int(ax.y);
  int yl = int(ay.x), yh = int(ay.y);
  vec3 tl = texelFetch(u_frame, ivec2(xl, yl), 0).rgb;
  vec3 tr = texelFetch(u_frame, ivec2(xh, yl), 0).rgb;
  vec3 bl = texelFetch(u_frame, ivec2(xl, yh), 0).rgb;
  vec3 br = texelFetch(u_frame, ivec2(xh, yh), 0).rgb;
  vec3 top = mix(tl, tr, ax.z);
  vec3 bot = mix(bl, br, ax.z);
  o = vec4(mix(top, bot, ay.z), 1.0);
}`;

// Export for both module-less <script> use and potential JS test runners.
const exported = {
  axisVectors, delta64, reducedDim, lamF32, FragmentReader,
  UNWARP_VS, UNWARP_FS,
};
if (typeof window !== "undefined") {
  window.foveaxUnwarp = exported;
} else if (typeof module !== "undefined") {
  module.exports = exported;
}
