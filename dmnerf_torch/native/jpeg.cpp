// Baseline JPEG decoder and encoder for dmnerf_torch, equal to the bit to
// libjpeg-turbo as Pillow drives it (imageio.v2.imread / imwrite of a .jpg).
//
// Decoder: sequential Huffman frames (SOF0, SOF1 at 8 bits), 1 or 3
// components, interleaved or single-component scans, DHT/DQT/DRI anywhere
// before a scan, RSTn restart markers, any width and height. The stages are
// libjpeg-turbo's: jdhuff.c's decode_mcu, jidctint.c's jpeg_idct_islow with
// its post-IDCT range-limit table (jdmaster.c::prepare_range_limit_table),
// jdsample.c's fancy upsampling (h2v1, h1v2, h2v2; box replication when the
// chroma is at most 2 samples wide, as jinit_upsampler picks), and jdcolor.c's
// fixed-point YCbCr->RGB tables. Progressive, lossless, hierarchical and
// arithmetic-coded frames, 12-bit samples, 2- or 4-component (CMYK) files,
// Adobe APP14 files and RGB-coded files are refused.
//
// Encoder: what Pillow writes for a uint8 RGB or greyscale image with no
// options: JFIF 1.01 APP0 (density 1:1), the Annex K tables scaled for the
// quality (jcparam.c, clamped to 255), 4:2:0 for RGB, standard Huffman
// tables, no restart interval. The stages are jccolor.c's fixed-point
// RGB->YCbCr, jcsample.c's h2v2_downsample (bias 1, 2, 1, 2, ...), the edge
// replication of jcprepct.c, jfdctint.c's jpeg_fdct_islow, jcdctmgr.c's
// reciprocal quantisation and jccoefct.c's dummy blocks at the right and
// bottom of the last MCUs, then jchuff.c's encode_one_block.
//
// Exposed via the CPython C API (no pybind11 in this environment):
//   _jpeg_native.decode(bytes) -> uint8 array [H, W, 3] or [H, W]
//   _jpeg_native.encode(uint8 array [H, W, 3] or [H, W], quality) -> bytes
// Faults in the stream raise ValueError with the marker in the message.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  explicit JpegError(const std::string& m) : std::runtime_error(m) {}
};

// zigzag position -> natural (row-major) position; 16 extra entries catch a
// run that overshoots 63 in corrupt data, as libjpeg's jpeg_natural_order does
const int NATURAL[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

std::string hex_marker(int m) {
  char buf[16];
  std::snprintf(buf, sizeof buf, "0xFF%02X", m & 0xFF);
  return buf;
}

std::string marker_name(int m) {
  char buf[48];
  if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
    std::snprintf(buf, sizeof buf, "SOF%d", m - 0xC0);
  else if (m >= 0xD0 && m <= 0xD7)
    std::snprintf(buf, sizeof buf, "RST%d", m - 0xD0);
  else if (m >= 0xE0 && m <= 0xEF)
    std::snprintf(buf, sizeof buf, "APP%d", m - 0xE0);
  else {
    const char* s = "unknown";
    switch (m) {
      case 0xC4: s = "DHT"; break;
      case 0xC8: s = "JPG"; break;
      case 0xCC: s = "DAC"; break;
      case 0xD8: s = "SOI"; break;
      case 0xD9: s = "EOI"; break;
      case 0xDA: s = "SOS"; break;
      case 0xDB: s = "DQT"; break;
      case 0xDC: s = "DNL"; break;
      case 0xDD: s = "DRI"; break;
      case 0xDE: s = "DHP"; break;
      case 0xDF: s = "EXP"; break;
      case 0xFE: s = "COM"; break;
      case 0x01: s = "TEM"; break;
      default: if (m >= 0x02 && m <= 0xBF) s = "RES";
    }
    std::snprintf(buf, sizeof buf, "%s", s);
  }
  return std::string(buf) + " (marker " + hex_marker(m) + ")";
}

[[noreturn]] void fail_at(int m, const std::string& what) {
  throw JpegError(what + " at " + marker_name(m));
}

// ------------------------------------------------------------------ tables

// libjpeg-turbo jdmaster.c::prepare_range_limit_table, the post-IDCT half:
// index = descaled IDCT output & 1023
struct IdctLimit {
  uint8_t t[1024];
  IdctLimit() {
    for (int i = 0; i < 1024; i++) {
      if (i < 128) t[i] = (uint8_t)(i + 128);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = (uint8_t)(i - 896);
    }
  }
};
const IdctLimit IDCT_LIMIT;

inline uint8_t clamp255(int x) { return (uint8_t)(x < 0 ? 0 : (x > 255 ? 255 : x)); }

// jdcolor.c::build_ycc_rgb_table
struct YccRgb {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccRgb() {
    const int64_t ONE_HALF = 1LL << 15;
    auto FIX = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = (-FIX(0.71414)) * x;
      cb_g[i] = (-FIX(0.34414)) * x + ONE_HALF;
    }
  }
};
const YccRgb YCC_RGB;

// jccolor.c::rgb_ycc_start
struct RgbYcc {
  int64_t t[8 * 256];
  RgbYcc() {
    const int64_t ONE_HALF = 1LL << 15, CBCR_OFFSET = 128LL << 16;
    auto FIX = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      t[i + 0 * 256] = FIX(0.29900) * i;
      t[i + 1 * 256] = FIX(0.58700) * i;
      t[i + 2 * 256] = FIX(0.11400) * i + ONE_HALF;
      t[i + 3 * 256] = (-FIX(0.16874)) * i;
      t[i + 4 * 256] = (-FIX(0.33126)) * i;
      t[i + 5 * 256] = FIX(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;  // B->Cb = R->Cr
      t[i + 6 * 256] = (-FIX(0.41869)) * i;
      t[i + 7 * 256] = (-FIX(0.08131)) * i;
    }
  }
};
const RgbYcc RGB_YCC;

// jfdctint.c / jidctint.c constants (CONST_BITS 13)
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
              FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
              FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + (1LL << (n - 1))) >> n; }

// ------------------------------------------------------------------ IDCT

// jidctint.c::jpeg_idct_islow: coefficients (natural order) times the
// quantisation table, into an 8x8 block of samples at out with stride.
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      int dc = (int)((int)ip[0] * (int)qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1LL << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1LL << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    wp[0] = (int)descale(tmp10 + tmp3, s);
    wp[56] = (int)descale(tmp10 - tmp3, s);
    wp[8] = (int)descale(tmp11 + tmp2, s);
    wp[48] = (int)descale(tmp11 - tmp2, s);
    wp[16] = (int)descale(tmp12 + tmp1, s);
    wp[40] = (int)descale(tmp12 - tmp1, s);
    wp[24] = (int)descale(tmp13 + tmp0, s);
    wp[32] = (int)descale(tmp13 - tmp0, s);
  }
  const uint8_t* lim = IDCT_LIMIT.t;
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t dc = lim[(int)descale(wp[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1LL << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1LL << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS + PASS1_BITS + 3;
    op[0] = lim[(int)descale(tmp10 + tmp3, s) & 1023];
    op[7] = lim[(int)descale(tmp10 - tmp3, s) & 1023];
    op[1] = lim[(int)descale(tmp11 + tmp2, s) & 1023];
    op[6] = lim[(int)descale(tmp11 - tmp2, s) & 1023];
    op[2] = lim[(int)descale(tmp12 + tmp1, s) & 1023];
    op[5] = lim[(int)descale(tmp12 - tmp1, s) & 1023];
    op[3] = lim[(int)descale(tmp13 + tmp0, s) & 1023];
    op[4] = lim[(int)descale(tmp13 - tmp0, s) & 1023];
  }
}

// ------------------------------------------------------------------ decoder

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | value, 0 = longer code

  // jdhuff.c::jpeg_make_d_derived_tbl
  void derive(bool is_dc, int marker) {
    uint8_t huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      int i = bits[l];
      if (p + i > 256) fail_at(marker, "bad Huffman table");
      while (i--) huffsize[p++] = (uint8_t)l;
    }
    huffsize[p] = 0;
    int numsymbols = p;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while ((int)huffsize[p] == si) {
        huffcode[p++] = code;
        code++;
      }
      if (code >= (1u << si)) fail_at(marker, "bad Huffman table");
      code <<= 1;
      si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - (int32_t)huffcode[p];
        p += bits[l];
        maxcode[l] = (int32_t)huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    valoffset[17] = 0;
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= 9; l++) {
      for (int i = 1; i <= bits[l]; i++, p++) {
        int lookbits = (int)(huffcode[p] << (9 - l));
        for (int ctr = 1 << (9 - l); ctr > 0; ctr--) look[lookbits++] = (uint16_t)((l << 8) | vals[p]);
      }
    }
    if (is_dc)
      for (int i = 0; i < numsymbols; i++)
        if (vals[i] > 15) fail_at(marker, "bad Huffman table");
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  bool quant_latched = false;
  uint16_t quant[64] = {0};      // natural order
  int bw = 0, bh = 0;            // blocks allocated (MCU-padded)
  int cw = 0, ch = 0;            // real samples: jdiv_round_up(W * h, max_h)
  std::vector<int16_t> coef;     // bh * bw * 64, natural order
};

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  int pad = 0;                   // zero bits appended after a marker or the end
  int marker = -1;               // the marker that stopped the reader, -1 = none
  bool eof = false;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      uint32_t byte = 0;
      if (marker < 0 && !eof) {
        if (pos >= n) {
          eof = true;
        } else if (d[pos] != 0xFF) {
          byte = d[pos++];
          buf = (buf << 8) | byte;
          cnt += 8;
          continue;
        } else {
          size_t p = pos + 1;
          while (p < n && d[p] == 0xFF) p++;
          if (p >= n) {
            eof = true;
          } else if (d[p] == 0x00) {
            pos = p + 1;
            buf = (buf << 8) | 0xFF;
            cnt += 8;
            continue;
          } else {
            marker = d[p];
            pos = p - 1;         // at the 0xFF that begins the marker
          }
        }
      }
      buf <<= 8;
      cnt += 8;
      pad += 8;
    }
  }

  void check() {
    if (cnt < pad) {
      if (eof) throw JpegError("the file is truncated inside the scan data (no EOI, marker 0xFFD9)");
      fail_at(marker, "scan data ends early: corrupt entropy-coded data before the marker");
    }
  }

  inline int get_bits(int s) {
    if (cnt < s) fill();
    cnt -= s;
    check();
    return (int)((buf >> cnt) & ((1u << s) - 1));
  }

  inline int decode(const HuffTable& t) {
    if (cnt < 16) fill();
    int look = (int)((buf >> (cnt - 9)) & 511);
    int e = t.look[look];
    if (e) {
      cnt -= e >> 8;
      check();
      return e & 0xFF;
    }
    int l = 10;
    int32_t code = (int32_t)((buf >> (cnt - l)) & ((1u << l) - 1));
    while (code > t.maxcode[l]) {
      l++;
      if (l > 16) {
        if (marker >= 0) fail_at(marker, "corrupt Huffman code in the scan data before the marker");
        throw JpegError("corrupt Huffman code in the scan data");
      }
      code = (int32_t)((buf >> (cnt - l)) & ((1u << l) - 1));
    }
    cnt -= l;
    check();
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }

  void reset() {
    buf = 0;
    cnt = 0;
    pad = 0;
  }
};

inline int huff_extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : d_(data), n_(size) {}

  // returns the image as H*W*nc samples
  std::vector<uint8_t> run(int* H, int* W, int* nc) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8)
      throw JpegError("not a JPEG file: it does not begin with SOI (marker 0xFFD8)");
    pos_ = 2;
    bool done = false;
    while (!done) {
      int m = next_marker();
      switch (m) {
        case 0xC0: case 0xC1: read_sof(m); break;
        case 0xC2: case 0xC6: case 0xCA: case 0xCE: fail_at(m, "progressive JPEG is not supported");
        case 0xC3: case 0xC7: case 0xCB: case 0xCF: fail_at(m, "lossless JPEG is not supported");
        case 0xC5: fail_at(m, "hierarchical JPEG is not supported");
        case 0xC9: fail_at(m, "arithmetic-coded JPEG is not supported");
        case 0xCD: fail_at(m, "hierarchical JPEG is not supported");
        case 0xCC: fail_at(m, "arithmetic-coded JPEG is not supported");
        case 0xDE: case 0xDF: fail_at(m, "hierarchical JPEG is not supported");
        case 0xC4: read_dht(m); break;
        case 0xDB: read_dqt(m); break;
        case 0xDD: read_dri(m); break;
        case 0xDA: read_sos(m); break;
        case 0xD9:
          if (!frame_) fail_at(m, "no frame (SOF) before the end of the image");
          if (!scanned_) fail_at(m, "no scan (SOS) before the end of the image");
          done = true;
          break;
        case 0xEE: read_app14(m); break;
        case 0xDC: fail_at(m, "DNL (the height given after the scan) is not supported");
        default:
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
            skip_segment(m);
            break;
          }
          fail_at(m, "bad marker");
      }
    }
    *H = H_;
    *W = W_;
    *nc = (int)comps_.size();
    return output();
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  HuffTable dc_[4], ac_[4];
  bool qt_present_[4] = {false, false, false, false};
  uint16_t qt_[4][64];           // natural order
  int restart_interval_ = 0;
  bool frame_ = false, scanned_ = false;
  int H_ = 0, W_ = 0, max_h_ = 1, max_v_ = 1, mcux_ = 0, mcuy_ = 0;
  std::vector<Component> comps_;

  int next_marker() {
    if (pos_ >= n_) throw JpegError("the file is truncated: no EOI (marker 0xFFD9)");
    if (d_[pos_] != 0xFF) {
      char buf[96];
      std::snprintf(buf, sizeof buf, "bad marker: byte 0x%02X at offset %zu where a marker belongs",
                    d_[pos_], pos_);
      throw JpegError(buf);
    }
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) throw JpegError("the file is truncated: no EOI (marker 0xFFD9)");
    int m = d_[pos_++];
    if (m == 0x00) throw JpegError("bad marker " + hex_marker(0) + " outside the scan data");
    return m;
  }

  // the segment's payload [start, end) after its 2-byte length
  size_t segment(int m, size_t* end) {
    if (pos_ + 2 > n_) fail_at(m, "the file is truncated");
    size_t len = ((size_t)d_[pos_] << 8) | d_[pos_ + 1];
    if (len < 2) fail_at(m, "bad segment length");
    if (pos_ + len > n_) fail_at(m, "the file is truncated");
    size_t start = pos_ + 2;
    *end = pos_ + len;
    pos_ = *end;
    return start;
  }

  void skip_segment(int m) {
    size_t end;
    segment(m, &end);
  }

  void read_app14(int m) {
    size_t end, p = segment(m, &end);
    if (end - p >= 5 && std::memcmp(d_ + p, "Adobe", 5) == 0)
      fail_at(m, "Adobe APP14 files (CMYK or an Adobe colour transform) are not supported");
  }

  void read_sof(int m) {
    if (frame_) fail_at(m, "a second frame header");
    size_t end, p = segment(m, &end);
    if (end - p < 6) fail_at(m, "bad frame header");
    int precision = d_[p];
    if (precision != 8) {
      char buf[64];
      std::snprintf(buf, sizeof buf, "%d-bit samples are not supported", precision);
      fail_at(m, buf);
    }
    H_ = (d_[p + 1] << 8) | d_[p + 2];
    W_ = (d_[p + 3] << 8) | d_[p + 4];
    int nf = d_[p + 5];
    if (H_ == 0) fail_at(m, "a height of 0 (DNL) is not supported");
    if (W_ == 0) fail_at(m, "a width of 0");
    if (nf == 4) fail_at(m, "4-component (CMYK) JPEG is not supported");
    if (nf != 1 && nf != 3) fail_at(m, std::to_string(nf) + "-component JPEG is not supported");
    if (end - p != 6 + 3 * (size_t)nf) fail_at(m, "bad frame header length");
    comps_.resize(nf);
    for (int i = 0; i < nf; i++) {
      Component& c = comps_[i];
      c.id = d_[p + 6 + 3 * i];
      c.h = d_[p + 7 + 3 * i] >> 4;
      c.v = d_[p + 7 + 3 * i] & 15;
      c.tq = d_[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail_at(m, "bad sampling factors");
      if (c.tq > 3) fail_at(m, "bad quantisation table number");
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    if (nf == 3 && comps_[0].id == 'R' && comps_[1].id == 'G' && comps_[2].id == 'B')
      fail_at(m, "RGB-coded JPEG (component ids R, G, B) is not supported");
    mcux_ = (W_ + 8 * max_h_ - 1) / (8 * max_h_);
    mcuy_ = (H_ + 8 * max_v_ - 1) / (8 * max_v_);
    for (Component& c : comps_) {
      if (max_h_ % c.h || max_v_ % c.v) fail_at(m, "fractional sampling factors are not supported");
      c.cw = (int)(((int64_t)W_ * c.h + max_h_ - 1) / max_h_);
      c.ch = (int)(((int64_t)H_ * c.v + max_v_ - 1) / max_v_);
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    frame_ = true;
  }

  void read_dht(int m) {
    size_t end, p = segment(m, &end);
    while (p < end) {
      int tc = d_[p] >> 4, th = d_[p] & 15;
      if (tc > 1 || th > 3) fail_at(m, "bad Huffman table class or number");
      if (p + 17 > end) fail_at(m, "bad Huffman table length");
      HuffTable& t = tc ? ac_[th] : dc_[th];
      int count = 0;
      t.bits[0] = 0;
      for (int i = 1; i <= 16; i++) {
        t.bits[i] = d_[p + i];
        count += t.bits[i];
      }
      p += 17;
      if (count > 256 || p + count > end) fail_at(m, "bad Huffman table length");
      std::memset(t.vals, 0, sizeof t.vals);
      std::memcpy(t.vals, d_ + p, count);
      p += count;
      t.derive(tc == 0, m);
      t.present = true;
    }
  }

  void read_dqt(int m) {
    size_t end, p = segment(m, &end);
    while (p < end) {
      int pq = d_[p] >> 4, tq = d_[p] & 15;
      if (pq > 1 || tq > 3) fail_at(m, "bad quantisation table precision or number");
      p++;
      size_t need = pq ? 128 : 64;
      if (p + need > end) fail_at(m, "bad quantisation table length");
      for (int k = 0; k < 64; k++) {
        uint16_t v = pq ? (uint16_t)((d_[p + 2 * k] << 8) | d_[p + 2 * k + 1]) : d_[p + k];
        qt_[tq][NATURAL[k]] = v;
      }
      p += need;
      qt_present_[tq] = true;
    }
  }

  void read_dri(int m) {
    size_t end, p = segment(m, &end);
    if (end - p != 2) fail_at(m, "bad restart interval length");
    restart_interval_ = (d_[p] << 8) | d_[p + 1];
  }

  void read_sos(int m) {
    if (!frame_) fail_at(m, "a scan before the frame header (SOF)");
    size_t end, p = segment(m, &end);
    if (end - p < 1) fail_at(m, "bad scan header");
    int ns = d_[p];
    if (ns < 1 || ns > 4 || end - p != 4 + 2 * (size_t)ns) fail_at(m, "bad scan header");
    std::vector<Component*> sc;
    int blocks_per_mcu = 0;
    for (int i = 0; i < ns; i++) {
      int id = d_[p + 1 + 2 * i], tables = d_[p + 2 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comps_)
        if (k.id == id) c = &k;
      if (!c) fail_at(m, "a scan names a component that the frame does not have");
      for (Component* k : sc)
        if (k == c) fail_at(m, "a scan names one component twice");
      c->dc_tbl = tables >> 4;
      c->ac_tbl = tables & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) fail_at(m, "bad Huffman table number");
      if (!dc_[c->dc_tbl].present || !ac_[c->ac_tbl].present)
        fail_at(m, "a scan uses a Huffman table that no DHT defined");
      if (!c->quant_latched) {       // jdinput.c::latch_quant_tables
        if (!qt_present_[c->tq]) fail_at(m, "a scan uses a quantisation table that no DQT defined");
        std::memcpy(c->quant, qt_[c->tq], sizeof c->quant);
        c->quant_latched = true;
      }
      blocks_per_mcu += c->h * c->v;
      sc.push_back(c);
    }
    int ss = d_[p + 1 + 2 * ns], se = d_[p + 2 + 2 * ns], ahal = d_[p + 3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0) fail_at(m, "bad spectral selection for a sequential scan");
    if (ns > 1 && blocks_per_mcu > 10) fail_at(m, "more than 10 blocks in an MCU");
    decode_scan(sc);
    scanned_ = true;
  }

  // the index of the code byte of the first marker at or after p, skipping
  // entropy-coded bytes (0xFF 0x00 is a data byte, 0xFF 0xFF a fill byte)
  size_t find_marker(size_t p) const {
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 && d_[p + 1] != 0xFF)) p++;
    if (p + 1 >= n_)
      throw JpegError("the file is truncated inside the scan data (no EOI, marker 0xFFD9)");
    return p + 1;
  }

  void decode_block(BitReader& br, Component& c, int16_t* block, int* last_dc) {
    std::memset(block, 0, 64 * sizeof(int16_t));
    const HuffTable& dct = dc_[c.dc_tbl];
    const HuffTable& act = ac_[c.ac_tbl];
    int s = br.decode(dct);
    if (s) s = huff_extend(br.get_bits(s), s);
    s += *last_dc;
    *last_dc = s;
    block[0] = (int16_t)s;
    for (int k = 1; k < 64; k++) {
      s = br.decode(act);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = huff_extend(br.get_bits(s), s);
        block[NATURAL[k]] = (int16_t)s;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void decode_scan(const std::vector<Component*>& sc) {
    BitReader br(d_, n_, pos_);
    int last_dc[4] = {0, 0, 0, 0};
    const int ns = (int)sc.size();
    int mx, my;
    if (ns == 1) {                 // non-interleaved: the component's own blocks
      mx = (sc[0]->cw + 7) / 8;
      my = (sc[0]->ch + 7) / 8;
    } else {
      mx = mcux_;
      my = mcuy_;
    }
    const int64_t total = (int64_t)mx * my;
    int restarts_left = restart_interval_, next_rst = 0;
    for (int64_t mcu = 0; mcu < total; mcu++) {
      if (restart_interval_ && restarts_left == 0) {
        // jdhuff.c::process_restart: drop the rest of the byte, expect RSTn
        br.reset();
        size_t p = find_marker(br.pos);
        int m = d_[p];
        if (m != 0xD0 + next_rst)
          fail_at(m, "expected RST" + std::to_string(next_rst) + " (marker " +
                         hex_marker(0xD0 + next_rst) + "), found another marker");
        br.pos = p + 1;
        br.marker = -1;
        next_rst = (next_rst + 1) & 7;
        restarts_left = restart_interval_;
        for (int i = 0; i < 4; i++) last_dc[i] = 0;
      }
      if (ns == 1) {
        Component& c = *sc[0];
        int by = (int)(mcu / mx), bx = (int)(mcu % mx);
        decode_block(br, c, &c.coef[((size_t)by * c.bw + bx) * 64], &last_dc[0]);
      } else {
        int my_i = (int)(mcu / mx), mx_i = (int)(mcu % mx);
        for (int ci = 0; ci < ns; ci++) {
          Component& c = *sc[ci];
          for (int yy = 0; yy < c.v; yy++)
            for (int xx = 0; xx < c.h; xx++) {
              int by = my_i * c.v + yy, bx = mx_i * c.h + xx;
              decode_block(br, c, &c.coef[((size_t)by * c.bw + bx) * 64], &last_dc[ci]);
            }
        }
      }
      if (restart_interval_) restarts_left--;
    }
    // the reader stopped at the marker after the scan, or before it
    pos_ = find_marker(br.pos) - 1;
  }

  std::vector<uint8_t> plane(Component& c, int* stride) {
    int bw = (c.cw + 7) / 8, bh = (c.ch + 7) / 8;
    *stride = bw * 8;
    std::vector<uint8_t> out((size_t)bw * 8 * bh * 8);
    for (int by = 0; by < bh; by++)
      for (int bx = 0; bx < bw; bx++)
        idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64], c.quant,
                   &out[(size_t)by * 8 * *stride + bx * 8], *stride);
    return out;
  }

  // jdsample.c: the component's samples [ch, cw] (stride) to [H, W]
  std::vector<uint8_t> upsample(const Component& c, const std::vector<uint8_t>& in, int stride) {
    const int H = H_, W = W_, cw = c.cw, ch = c.ch;
    const int he = max_h_ / c.h, ve = max_v_ / c.v;
    std::vector<uint8_t> out((size_t)H * W);
    auto row = [&](int y) { return &in[(size_t)std::min(std::max(y, 0), ch - 1) * stride]; };
    std::vector<uint8_t> tmp((size_t)2 * cw + 2);
    if (he == 1 && ve == 1) {
      for (int y = 0; y < H; y++) std::memcpy(&out[(size_t)y * W], row(y), W);
    } else if (he == 2 && ve == 1 && cw > 2) {          // h2v1_fancy_upsample
      for (int y = 0; y < H; y++) {
        const uint8_t* ip = row(y);
        uint8_t* op = tmp.data();
        int invalue = ip[0];
        *op++ = (uint8_t)invalue;
        *op++ = (uint8_t)((invalue * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < cw - 1; x++) {
          invalue = ip[x] * 3;
          *op++ = (uint8_t)((invalue + ip[x - 1] + 1) >> 2);
          *op++ = (uint8_t)((invalue + ip[x + 1] + 2) >> 2);
        }
        invalue = ip[cw - 1];
        *op++ = (uint8_t)((invalue * 3 + ip[cw - 2] + 1) >> 2);
        *op++ = (uint8_t)invalue;
        std::memcpy(&out[(size_t)y * W], tmp.data(), W);
      }
    } else if (he == 1 && ve == 2) {                     // h1v2_fancy_upsample
      for (int y = 0; y < H; y++) {
        int r = y >> 1, v = y & 1;
        const uint8_t* i0 = row(r);
        const uint8_t* i1 = row(v ? r + 1 : r - 1);
        int bias = v ? 2 : 1;
        uint8_t* op = &out[(size_t)y * W];
        for (int x = 0; x < W; x++) op[x] = (uint8_t)((i0[x] * 3 + i1[x] + bias) >> 2);
      }
    } else if (he == 2 && ve == 2 && cw > 2) {          // h2v2_fancy_upsample
      for (int y = 0; y < H; y++) {
        int r = y >> 1, v = y & 1;
        const uint8_t* i0 = row(r);
        const uint8_t* i1 = row(v ? r + 1 : r - 1);
        uint8_t* op = tmp.data();
        int thiscolsum = i0[0] * 3 + i1[0];
        int nextcolsum = i0[1] * 3 + i1[1];
        *op++ = (uint8_t)((thiscolsum * 4 + 8) >> 4);
        *op++ = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
        int lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
        for (int x = 2; x < cw; x++) {
          nextcolsum = i0[x] * 3 + i1[x];
          *op++ = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
          *op++ = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
          lastcolsum = thiscolsum;
          thiscolsum = nextcolsum;
        }
        *op++ = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
        *op++ = (uint8_t)((thiscolsum * 4 + 7) >> 4);
        std::memcpy(&out[(size_t)y * W], tmp.data(), W);
      }
    } else {                                             // h2v1/h2v2/int_upsample: replicate
      for (int y = 0; y < H; y++) {
        const uint8_t* ip = &in[(size_t)(y / ve) * stride];
        uint8_t* op = &out[(size_t)y * W];
        for (int x = 0; x < W; x++) op[x] = ip[x / he];
      }
    }
    return out;
  }

  std::vector<uint8_t> output() {
    const size_t HW = (size_t)H_ * W_;
    if (comps_.size() == 1) {
      int stride;
      std::vector<uint8_t> p = plane(comps_[0], &stride);
      std::vector<uint8_t> out(HW);
      for (int y = 0; y < H_; y++) std::memcpy(&out[(size_t)y * W_], &p[(size_t)y * stride], W_);
      return out;
    }
    std::vector<uint8_t> full[3];
    for (int i = 0; i < 3; i++) {
      int stride;
      std::vector<uint8_t> p = plane(comps_[i], &stride);
      full[i] = upsample(comps_[i], p, stride);
    }
    std::vector<uint8_t> out(HW * 3);
    for (size_t i = 0; i < HW; i++) {           // jdcolor.c::ycc_rgb_convert
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i + 0] = clamp255(y + YCC_RGB.cr_r[cr]);
      out[3 * i + 1] = clamp255(y + (int)((YCC_RGB.cb_g[cb] + YCC_RGB.cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp255(y + YCC_RGB.cb_b[cb]);
    }
    return out;
  }
};

// ------------------------------------------------------------------ encoder

// Annex K tables in zigzag order, as DQT carries them (quality 50)
const uint8_t STD_LUMA_QT[64] = {
    16, 11, 12, 14, 12, 10, 16, 14, 13, 14, 18, 17, 16, 19, 24, 40, 26, 24, 22, 22, 24, 49,
    35, 37, 29, 40, 58, 51, 61, 60, 57, 51, 56, 55, 64, 72, 92, 78, 64, 68, 87, 69, 55, 56,
    80, 109, 81, 87, 95, 98, 103, 104, 103, 62, 77, 113, 121, 112, 100, 120, 92, 101, 103, 99};
const uint8_t STD_CHROMA_QT[64] = {
    17, 18, 18, 24, 21, 24, 47, 26, 26, 47, 99, 66, 56, 66, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: bits[1..16] and values
const uint8_t DC_LUMA_BITS[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t DC_CHROMA_BITS[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t AC_LUMA_BITS[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t AC_LUMA_VALS[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t AC_CHROMA_BITS[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t AC_CHROMA_VALS[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint32_t code[256];
  uint8_t size[256];

  // jchuff.c::jpeg_make_c_derived_tbl
  EncTable(const uint8_t* b, const uint8_t* v, int n) : bits(b), vals(v), nvals(n) {
    std::memset(size, 0, sizeof size);
    std::memset(code, 0, sizeof code);
    uint8_t huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < b[l - 1]; i++) huffsize[p++] = (uint8_t)l;
    huffsize[p] = 0;
    uint32_t c = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while ((int)huffsize[p] == si) huffcode[p++] = c++;
      c <<= 1;
      si++;
    }
    for (int i = 0; i < n; i++) {
      code[v[i]] = huffcode[i];
      size[v[i]] = huffsize[i];
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t code, int size) {
    buf = (buf << size) | (code & ((1u << size) - 1));
    cnt += size;
    while (cnt >= 8) {
      uint8_t byte = (uint8_t)(buf >> (cnt - 8));
      out.push_back(byte);
      if (byte == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
  void flush() {                 // jchuff.c::flush_bits: pad with 1 bits
    if (cnt) put(0x7F, 7);
    cnt = 0;
    buf = 0;
  }
};

// jfdctint.c::jpeg_fdct_islow (outputs scaled up by 8)
void fdct_islow(int* data) {
  int* p = data;
  for (int r = 0; r < 8; r++, p += 8) {
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int16_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int16_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int16_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = (int16_t)descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int16_t)descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = (int16_t)descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = (int16_t)descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = (int16_t)descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  p = data;
  for (int c = 0; c < 8; c++, p++) {
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int16_t)descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = (int16_t)descale(tmp10 - tmp11, PASS1_BITS);
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int16_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = (int16_t)descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int16_t)descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = (int16_t)descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = (int16_t)descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = (int16_t)descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// jcdctmgr.c::compute_reciprocal for divisor = quantval << 3
struct Divisor {
  uint32_t recip, corr;
  int shift;                     // total right shift of the product
  explicit Divisor(uint32_t divisor) {
    int b = 31 - __builtin_clz(divisor);  // flss(divisor) - 1
    int r = 16 + b;
    uint64_t fq = (1ULL << r) / divisor, fr = (1ULL << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2U) {
      c++;
    } else {
      fq++;
    }
    recip = (uint32_t)fq;
    corr = c;
    shift = r;
  }
  inline int16_t quantize(int x) const {
    uint32_t t = (uint32_t)(x < 0 ? -x : x);
    uint32_t q = (uint32_t)(((uint64_t)(t + corr) * recip) >> shift);
    return (int16_t)(x < 0 ? -(int)q : (int)q);
  }
};

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)v);
}

void emit_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits, const uint8_t* vals, int n) {
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, 2 + 1 + 16 + n);
  o.push_back((uint8_t)index);
  o.insert(o.end(), bits, bits + 16);
  o.insert(o.end(), vals, vals + n);
}

std::vector<uint8_t> encode(const uint8_t* img, int H, int W, int nc, int quality) {
  // jcparam.c::jpeg_quality_scaling and jpeg_add_quant_table(force_baseline)
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  uint16_t qz[2][64];            // zigzag order
  for (int k = 0; k < 64; k++) {
    const uint8_t base[2] = {STD_LUMA_QT[k], STD_CHROMA_QT[k]};
    for (int t = 0; t < 2; t++) {
      long v = ((long)base[t] * scale + 50L) / 100L;
      qz[t][k] = (uint16_t)std::min(std::max(v, 1L), 255L);
    }
  }
  std::vector<Divisor> div[2];
  for (int t = 0; t < 2; t++) {
    std::vector<uint16_t> nat(64);
    for (int k = 0; k < 64; k++) nat[NATURAL[k]] = qz[t][k];
    for (int i = 0; i < 64; i++) div[t].emplace_back((uint32_t)nat[i] << 3);
  }

  const int max_s = nc == 3 ? 2 : 1;
  const int hs[3] = {max_s, 1, 1};
  const size_t HW = (size_t)H * W;
  // full-size component planes (jccolor.c::rgb_ycc_convert, or grey as is)
  std::vector<uint8_t> full[3];
  if (nc == 1) {
    full[0].assign(img, img + HW);
  } else {
    for (int i = 0; i < 3; i++) full[i].resize(HW);
    const int64_t* t = RGB_YCC.t;
    for (size_t i = 0; i < HW; i++) {
      int r = img[3 * i], g = img[3 * i + 1], b = img[3 * i + 2];
      full[0][i] = (uint8_t)((t[r] + t[g + 256] + t[b + 512]) >> 16);
      full[1][i] = (uint8_t)((t[r + 768] + t[g + 1024] + t[b + 1280]) >> 16);
      full[2][i] = (uint8_t)((t[r + 1280] + t[g + 1536] + t[b + 1792]) >> 16);
    }
  }

  const int mcux = (W + 8 * max_s - 1) / (8 * max_s), mcuy = (H + 8 * max_s - 1) / (8 * max_s);
  const int groups = (H + max_s - 1) / max_s;   // row groups of max_s input rows
  struct Comp {
    int h, wib, hib, stride, rows;
    std::vector<int16_t> coef;   // hib * wib * 64, quantised, natural order
  };
  std::vector<Comp> comps(nc);
  for (int ci = 0; ci < nc; ci++) {
    Comp& c = comps[ci];
    c.h = hs[ci];
    int he = max_s / c.h;
    c.wib = (int)(((int64_t)W * c.h + 8 * max_s - 1) / (8 * max_s));
    c.hib = (int)(((int64_t)H * c.h + 8 * max_s - 1) / (8 * max_s));
    c.stride = c.wib * 8;
    c.rows = c.hib * 8;
    // jcprepct.c + jcsample.c: replicate the last column out to
    // wib * 8 * he and the last row over the last row group, downsample,
    // then replicate the last downsampled row down to whole blocks
    std::vector<uint8_t> p((size_t)c.rows * c.stride);
    const std::vector<uint8_t>& f = full[ci];
    const int pw = c.stride * he, ph = groups * max_s;
    std::vector<uint8_t> ext((size_t)ph * pw);   // the full-size plane, edges replicated
    for (int y = 0; y < ph; y++) {
      uint8_t* e = &ext[(size_t)y * pw];
      std::memcpy(e, &f[(size_t)std::min(y, H - 1) * W], W);
      std::memset(e + W, e[W - 1], pw - W);
    }
    int drows = groups * c.h;    // rows the downsampler produces (c.h == v here)
    for (int y = 0; y < drows && y < c.rows; y++) {
      uint8_t* op = &p[(size_t)y * c.stride];
      if (he == 1) {
        std::memcpy(op, &ext[(size_t)y * pw], c.stride);
      } else {                   // h2v2_downsample
        const uint8_t* i0 = &ext[(size_t)(2 * y) * pw];
        const uint8_t* i1 = i0 + pw;
        int bias = 1;
        for (int x = 0; x < c.stride; x++) {
          op[x] = (uint8_t)((i0[2 * x] + i0[2 * x + 1] + i1[2 * x] + i1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    for (int y = drows; y < c.rows; y++)
      std::memcpy(&p[(size_t)y * c.stride], &p[(size_t)(drows - 1) * c.stride], c.stride);
    // jcdctmgr.c::forward_DCT: level shift, islow FDCT, quantise
    c.coef.resize((size_t)c.hib * c.wib * 64);
    const std::vector<Divisor>& dv = div[ci == 0 ? 0 : 1];
    int ws[64];
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++) {
        for (int r = 0; r < 8; r++)
          for (int x = 0; x < 8; x++)
            ws[8 * r + x] = (int)p[(size_t)(by * 8 + r) * c.stride + bx * 8 + x] - 128;
        fdct_islow(ws);
        int16_t* cb = &c.coef[((size_t)by * c.wib + bx) * 64];
        for (int i = 0; i < 64; i++) cb[i] = dv[i].quantize(ws[i]);
      }
  }

  std::vector<uint8_t> o;
  o.reserve(HW / 4 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof head);
  for (int t = 0; t < (nc == 3 ? 2 : 1); t++) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back((uint8_t)t);
    for (int k = 0; k < 64; k++) o.push_back((uint8_t)qz[t][k]);
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * nc);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back((uint8_t)nc);
  for (int ci = 0; ci < nc; ci++) {
    o.push_back((uint8_t)(ci + 1));
    o.push_back((uint8_t)((hs[ci] << 4) | hs[ci]));
    o.push_back((uint8_t)(ci == 0 ? 0 : 1));
  }
  emit_dht(o, 0x00, DC_LUMA_BITS, DC_VALS, 12);
  emit_dht(o, 0x10, AC_LUMA_BITS, AC_LUMA_VALS, 162);
  if (nc == 3) {
    emit_dht(o, 0x01, DC_CHROMA_BITS, DC_VALS, 12);
    emit_dht(o, 0x11, AC_CHROMA_BITS, AC_CHROMA_VALS, 162);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * nc);
  o.push_back((uint8_t)nc);
  for (int ci = 0; ci < nc; ci++) {
    o.push_back((uint8_t)(ci + 1));
    o.push_back((uint8_t)(ci == 0 ? 0x00 : 0x11));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  static const EncTable dc_t[2] = {EncTable(DC_LUMA_BITS, DC_VALS, 12),
                                   EncTable(DC_CHROMA_BITS, DC_VALS, 12)};
  static const EncTable ac_t[2] = {EncTable(AC_LUMA_BITS, AC_LUMA_VALS, 162),
                                   EncTable(AC_CHROMA_BITS, AC_CHROMA_VALS, 162)};
  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  // jchuff.c::encode_one_block
  auto encode_block = [&](const int16_t* blk, int dc, int ci) {
    const EncTable& dct = dc_t[ci == 0 ? 0 : 1];
    const EncTable& act = ac_t[ci == 0 ? 0 : 1];
    int temp = dc - last_dc[ci], temp2 = temp;
    last_dc[ci] = dc;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    int nbits = 0;
    while (temp) {
      nbits++;
      temp >>= 1;
    }
    bw.put(dct.code[nbits], dct.size[nbits]);
    if (nbits) bw.put((uint32_t)temp2, nbits);
    int r = 0;
    for (int k = 1; k < 64; k++) {
      temp = blk ? blk[NATURAL[k]] : 0;
      if (temp == 0) {
        r++;
        continue;
      }
      while (r > 15) {
        bw.put(act.code[0xF0], act.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        temp2--;
      }
      nbits = 1;
      while ((temp >>= 1)) nbits++;
      int i = (r << 4) + nbits;
      bw.put(act.code[i], act.size[i]);
      bw.put((uint32_t)temp2, nbits);
      r = 0;
    }
    if (r > 0) bw.put(act.code[0], act.size[0]);
  };

  if (nc == 1) {                 // one component: non-interleaved, no dummy blocks
    const Comp& c = comps[0];
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++) {
        const int16_t* blk = &c.coef[((size_t)by * c.wib + bx) * 64];
        encode_block(blk, blk[0], 0);
      }
  } else {
    // jccoefct.c::compress_data: blocks past width_in_blocks / height_in_blocks
    // in the last MCUs are dummies, all AC zero, DC of the block before them
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++)
        for (int ci = 0; ci < nc; ci++) {
          const Comp& c = comps[ci];
          int prev_dc = 0;
          for (int yy = 0; yy < c.h; yy++) {
            int by = my * c.h + yy;
            for (int xx = 0; xx < c.h; xx++) {
              int bx = mx * c.h + xx;
              if (by < c.hib && bx < c.wib) {
                const int16_t* blk = &c.coef[((size_t)by * c.wib + bx) * 64];
                prev_dc = blk[0];
                encode_block(blk, blk[0], ci);
              } else {
                encode_block(nullptr, prev_dc, ci);
              }
            }
          }
        }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// ------------------------------------------------------------------ Python

PyObject* py_decode(PyObject*, PyObject* args) {
  Py_buffer view;
  if (!PyArg_ParseTuple(args, "y*", &view)) return nullptr;
  std::vector<uint8_t> pix;
  int H = 0, W = 0, nc = 0;
  std::string err;
  Py_BEGIN_ALLOW_THREADS
  try {
    Decoder dec((const uint8_t*)view.buf, (size_t)view.len);
    pix = dec.run(&H, &W, &nc);
  } catch (const JpegError& e) {
    err = e.what();
  } catch (const std::bad_alloc&) {
    err = "out of memory";
  }
  Py_END_ALLOW_THREADS
  PyBuffer_Release(&view);
  if (!err.empty()) {
    PyErr_SetString(PyExc_ValueError, err.c_str());
    return nullptr;
  }
  npy_intp dims[3] = {H, W, nc};
  PyObject* arr = PyArray_SimpleNew(nc == 1 ? 2 : 3, dims, NPY_UINT8);
  if (!arr) return nullptr;
  std::memcpy(PyArray_DATA((PyArrayObject*)arr), pix.data(), pix.size());
  return arr;
}

PyObject* py_encode(PyObject*, PyObject* args) {
  PyObject* obj;
  int quality;
  if (!PyArg_ParseTuple(args, "Oi", &obj, &quality)) return nullptr;
  PyArrayObject* arr = (PyArrayObject*)PyArray_FROMANY(obj, NPY_UINT8, 2, 3, NPY_ARRAY_C_CONTIGUOUS);
  if (!arr) return nullptr;
  int nd = PyArray_NDIM(arr);
  npy_intp* sh = PyArray_DIMS(arr);
  int nc = nd == 2 ? 1 : (int)sh[2];
  if ((nc != 1 && nc != 3) || (nd == 3 && nc == 1) || sh[0] < 1 || sh[1] < 1 || sh[0] > 65535 ||
      sh[1] > 65535) {
    Py_DECREF(arr);
    PyErr_SetString(PyExc_ValueError, "expected a uint8 array [H, W, 3] or [H, W] of 1 to 65535 rows and columns");
    return nullptr;
  }
  std::vector<uint8_t> out;
  const uint8_t* data = (const uint8_t*)PyArray_DATA(arr);
  int H = (int)sh[0], W = (int)sh[1];
  Py_BEGIN_ALLOW_THREADS
  out = encode(data, H, W, nc, quality);
  Py_END_ALLOW_THREADS
  Py_DECREF(arr);
  return PyBytes_FromStringAndSize((const char*)out.data(), (Py_ssize_t)out.size());
}

PyMethodDef methods[] = {
    {"decode", py_decode, METH_VARARGS, "decode(bytes) -> uint8 [H, W, 3] or [H, W]"},
    {"encode", py_encode, METH_VARARGS, "encode(uint8 [H, W, 3] or [H, W], quality) -> bytes"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moddef = {PyModuleDef_HEAD_INIT, "_jpeg_native", nullptr, -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__jpeg_native(void) {
  import_array();
  return PyModule_Create(&moddef);
}
