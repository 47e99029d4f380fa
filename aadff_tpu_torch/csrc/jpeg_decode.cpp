// Baseline JPEG decoder: marker parsing, Huffman decoding, the IDCT, chroma
// upsampling and YCbCr -> RGB, arithmetic for arithmetic what libjpeg(-turbo)
// does by default, so that a decode equals OpenCV's `cv2.imread` bit for bit:
//   * the "islow" integer IDCT (jidctint.c, jpeg_idct_islow: 13-bit
//     constants, 2 extra bits after the first pass, the post-IDCT range
//     limit that wraps modulo 1024);
//   * fancy upsampling (jdsample.c: h2v1_fancy_upsample for 4:2:2 and
//     h2v2_fancy_upsample for 4:2:0, the triangle filter with its 8/7 and
//     2/1 rounding biases, edge rows and columns replicated; a component
//     <= 2 samples wide, and any other integer factor but 4:4:0's, is
//     replicated as libjpeg's plain upsamplers do);
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c (16 fraction bits).
// Read: baseline and 8-bit extended sequential Huffman (SOF0/SOF1), grey or
// YCbCr (3 components), one interleaved scan, restart intervals, any size.
// Refused, with code 1: progressive, lossless, hierarchical, arithmetic,
// 12-bit, CMYK/4-component, RGB-coded (Adobe transform 0), multi-scan and
// 4:4:0 files.  Malformed data gives code 2.  The EXIF orientation tag of an APP1
// segment is reported, not applied (the caller rotates as OpenCV does).
//
// C interface, loaded with ctypes (aadff_tpu_torch/utils/_host_build.py):
//   aadff_jpeg_info(data, size, info[4] = {height, width, components,
//                   orientation}, err, err_len) -> 0 | 1 | 2
//   aadff_jpeg_decode(data, size, out [height, width, 3] RGB, out_size,
//                     err, err_len) -> 0 | 1 | 2
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Failure {
  int code;  // 1 unsupported, 2 malformed
  std::string message;
};

[[noreturn]] void unsupported(const std::string& what) { throw Failure{1, what}; }
[[noreturn]] void malformed(const std::string& what) { throw Failure{2, what}; }

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so that a corrupt run past 63 lands in a dummy slot
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  // (length << 8) | value for codes of <= kLookBits bits, 0 otherwise
  uint16_t look[1 << kLookBits] = {};

  void build(const uint8_t* counts, const uint8_t* values, int nvals) {
    std::memcpy(vals, values, nvals);
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
      valoffset[len] = k - code;
      k += counts[len - 1];
      code += counts[len - 1];
      maxcode[len] = counts[len - 1] ? code - 1 : -1;
      if (code > (1 << len)) malformed("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    code = 0;
    k = 0;
    for (int len = 1; len <= kLookBits; ++len) {
      for (int i = 0; i < counts[len - 1]; ++i, ++k, ++code) {
        int lo = code << (kLookBits - len), n = 1 << (kLookBits - len);
        for (int j = 0; j < n; ++j) look[lo + j] = (uint16_t)((len << 8) | vals[k]);
      }
      code <<= 1;
    }
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int dw = 0, dh = 0;          // downsampled width and height (samples)
  int bw = 0, bh = 0;          // blocks allocated per row and column
  std::vector<uint8_t> plane;  // bw*8 x bh*8 samples
  int pred = 0;
};

class BitReader {
 public:
  BitReader(const uint8_t* p, const uint8_t* end) : p_(p), end_(end) {}

  // the stream's next `n` (<= 16) bits, zeros past a marker or the end
  uint32_t peek(int n) {
    if (nbits_ < n) fill();
    return (uint32_t)(buf_ >> (nbits_ - n)) & ((1u << n) - 1);
  }
  void skip(int n) { nbits_ -= n; }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  // drop the rest of the byte-aligned segment before a restart marker
  void restart(int expected) {
    nbits_ = 0;
    buf_ = 0;
    hit_marker_ = false;
    while (p_ + 1 < end_ && !(p_[0] == 0xFF && p_[1] != 0x00 && p_[1] != 0xFF)) {
      // only fill bytes may stand between the data and the marker
      if (p_[0] != 0xFF) malformed("data before a restart marker");
      ++p_;
    }
    if (p_ + 1 >= end_ || p_[1] != 0xD0 + expected)
      malformed("restart marker missing or out of order");
    p_ += 2;
  }
  const uint8_t* position() const { return p_; }

 private:
  void fill() {
    while (nbits_ <= 56) {
      uint32_t byte = 0;
      if (!hit_marker_ && p_ < end_) {
        byte = *p_;
        if (byte == 0xFF) {
          uint32_t next = p_ + 1 < end_ ? p_[1] : 0;
          if (next == 0x00) {
            p_ += 2;
          } else {
            hit_marker_ = true;  // a marker: feed zeros (as libjpeg does)
            byte = 0;
          }
        } else {
          ++p_;
        }
      }
      buf_ = (buf_ << 8) | byte;
      nbits_ += 8;
    }
  }

  const uint8_t* p_;
  const uint8_t* end_;
  uint64_t buf_ = 0;
  int nbits_ = 0;
  bool hit_marker_ = false;
};

inline int decode_huffman(BitReader& br, const Huffman& h) {
  uint32_t look = h.look[br.peek(kLookBits)];
  if (look) {
    br.skip(look >> 8);
    return look & 0xFF;
  }
  uint32_t bits16 = br.peek(16);
  for (int len = kLookBits + 1; len <= 16; ++len) {
    int32_t code = (int32_t)(bits16 >> (16 - len));
    if (code <= h.maxcode[len]) {
      br.skip(len);
      return h.vals[(code + h.valoffset[len]) & 0xFF];
    }
  }
  malformed("bad Huffman code");
}

inline int extend(uint32_t v, int s) {
  return s == 0 ? 0 : ((int)v < (1 << (s - 1)) ? (int)v - (1 << s) + 1 : (int)v);
}

// ---- the islow IDCT (jidctint.c) ----------------------------------------
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit (jdmaster.c prepare_range_limit_table),
// indexed by x & 1023: [0, 127] -> x + 128, [128, 511] -> 255,
// [512, 895] -> 0, [896, 1023] -> x - 896; that is x + 128 clamped to
// [0, 255] with x read as a 10-bit signed number
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      int y = (i < 512 ? i : i - 1024) + 128;
      idct[i] = (uint8_t)(y < 0 ? 0 : (y > 255 ? 255 : y));
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int32_t* coef, const uint16_t* quant, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    const uint16_t* q = quant + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = (int64_t)in[16] * q[16];
    z3 = (int64_t)in[48] * q[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * q[0];
    z3 = (int64_t)in[32] * q[32];
    tmp0 = (z2 + z3) * (1 << kConstBits);
    tmp1 = (z2 - z3) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * q[56];
    tmp1 = (int64_t)in[40] * q[40];
    tmp2 = (int64_t)in[24] * q[24];
    tmp3 = (int64_t)in[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits - kPass1Bits;
    ws[c + 0] = (int32_t)descale(tmp10 + tmp3, s);
    ws[c + 56] = (int32_t)descale(tmp10 - tmp3, s);
    ws[c + 8] = (int32_t)descale(tmp11 + tmp2, s);
    ws[c + 48] = (int32_t)descale(tmp11 - tmp2, s);
    ws[c + 16] = (int32_t)descale(tmp12 + tmp1, s);
    ws[c + 40] = (int32_t)descale(tmp12 - tmp1, s);
    ws[c + 24] = (int32_t)descale(tmp13 + tmp0, s);
    ws[c + 32] = (int32_t)descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (w[0] + w[4]) * (1 << kConstBits);
    tmp1 = (w[0] - w[4]) * (1 << kConstBits);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = kConstBits + kPass1Bits + 3;
    o[0] = kRange.idct[(int)descale(tmp10 + tmp3, s) & 1023];
    o[7] = kRange.idct[(int)descale(tmp10 - tmp3, s) & 1023];
    o[1] = kRange.idct[(int)descale(tmp11 + tmp2, s) & 1023];
    o[6] = kRange.idct[(int)descale(tmp11 - tmp2, s) & 1023];
    o[2] = kRange.idct[(int)descale(tmp12 + tmp1, s) & 1023];
    o[5] = kRange.idct[(int)descale(tmp12 - tmp1, s) & 1023];
    o[3] = kRange.idct[(int)descale(tmp13 + tmp0, s) & 1023];
    o[4] = kRange.idct[(int)descale(tmp13 - tmp0, s) & 1023];
  }
}

// ---- the decoder ---------------------------------------------------------
struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int restart_interval = 0, orientation = 1;
  bool jfif = false, adobe = false, frame_seen = false;
  int adobe_transform = -1;
  uint16_t quant[4][64] = {};
  bool quant_present[4] = {};
  Huffman dc[4], ac[4];
  Component comp[3];
  const uint8_t* scan_data = nullptr;  // entropy-coded data of the scan
  int scan_comps[3] = {};
  int scan_ncomp = 0;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int u8() {
    if (pos >= size) malformed("truncated file");
    return data[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void parse_exif(const uint8_t* p, size_t n) {
    // "Exif\0\0", then a TIFF header and IFD0; tag 0x0112 is the orientation
    if (n < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = p + 6;
    size_t tn = n - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto rd16 = [&](size_t o) -> uint32_t {
      return le ? (uint32_t)(t[o] | (t[o + 1] << 8)) : (uint32_t)((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](size_t o) -> uint32_t {
      return le ? (uint32_t)t[o] | ((uint32_t)t[o + 1] << 8) | ((uint32_t)t[o + 2] << 16) |
                      ((uint32_t)t[o + 3] << 24)
                : ((uint32_t)t[o] << 24) | ((uint32_t)t[o + 1] << 16) |
                      ((uint32_t)t[o + 2] << 8) | (uint32_t)t[o + 3];
    };
    if (rd16(2) != 42) return;
    size_t ifd = rd32(4);
    if (ifd + 2 > tn) return;
    uint32_t count = rd16(ifd);
    for (uint32_t i = 0; i < count; ++i) {
      size_t e = ifd + 2 + 12 * (size_t)i;
      if (e + 12 > tn) return;
      if (rd16(e) == 0x0112) {
        uint32_t type = rd16(e + 2);
        uint32_t v = type == 3 ? rd16(e + 8) : (type == 4 ? rd32(e + 8) : 0);
        orientation = (v >= 1 && v <= 8) ? (int)v : 1;
        return;
      }
    }
  }

  void parse_sof(int marker, int len) {
    if (frame_seen) malformed("two frame headers");
    frame_seen = true;
    size_t end = pos + len - 2;
    int precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE)
      unsupported("progressive JPEG");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF)
      unsupported("lossless JPEG");
    if (marker == 0xC5) unsupported("hierarchical (differential) JPEG");
    if (marker >= 0xC9) unsupported("arithmetic-coded JPEG");
    if (precision != 8) unsupported(std::to_string(precision) + "-bit JPEG");
    if (ncomp == 4) unsupported("CMYK (4-component) JPEG");
    if (ncomp != 1 && ncomp != 3)
      unsupported(std::to_string(ncomp) + "-component JPEG");
    if (height == 0) unsupported("JPEG with a DNL-defined height");
    if (width == 0) malformed("zero width");
    for (int i = 0; i < ncomp; ++i) {
      comp[i].id = u8();
      int hv = u8();
      comp[i].h = hv >> 4;
      comp[i].v = hv & 15;
      comp[i].tq = u8();
      if (comp[i].h < 1 || comp[i].h > 4 || comp[i].v < 1 || comp[i].v > 4 || comp[i].tq > 3)
        malformed("bad component parameters");
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    if (pos != end) malformed("bad frame header length");
  }

  void parse_dqt(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) malformed("bad quantization table");
      for (int k = 0; k < 64; ++k)
        quant[tq][kZigzag[k]] = (uint16_t)(pq ? u16() : u8());
      quant_present[tq] = true;
    }
    if (pos != end) malformed("bad quantization table length");
  }

  void parse_dht(int len) {
    size_t end = pos + len - 2;
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) malformed("bad Huffman table class or id");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        counts[i] = (uint8_t)u8();
        total += counts[i];
      }
      if (total > 256 || pos + total > end) malformed("bad Huffman table");
      (tc ? ac[th] : dc[th]).build(counts, data + pos, total);
      pos += total;
    }
    if (pos != end) malformed("bad Huffman table length");
  }

  void parse_sos(int len) {
    if (!frame_seen) malformed("scan before the frame header");
    size_t end = pos + len - 2;
    scan_ncomp = u8();
    if (scan_ncomp != ncomp) unsupported("multi-scan JPEG");
    for (int i = 0; i < scan_ncomp; ++i) {
      int id = u8(), t = u8();
      int k = -1;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == id) k = j;
      if (k < 0) malformed("scan names an unknown component");
      comp[k].td = t >> 4;
      comp[k].ta = t & 15;
      if (comp[k].td > 3 || comp[k].ta > 3) malformed("bad table selector");
      scan_comps[i] = k;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) unsupported("progressive JPEG");
    if (pos != end) malformed("bad scan header length");
    scan_data = data + pos;
  }

  // Parse markers up to the first scan's data.
  void read_header() {
    if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) malformed("not a JPEG file");
    pos = 2;
    for (;;) {
      int b = u8();
      if (b != 0xFF) malformed("marker expected");
      int marker = u8();
      while (marker == 0xFF) marker = u8();
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      if (marker == 0xD9) malformed("no image data before the end of the file");
      int len = u16();
      if (len < 2 || pos + len - 2 > size) malformed("truncated marker segment");
      size_t next = pos + len - 2;
      if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
          marker != 0xCC) {
        parse_sof(marker, len);
      } else if (marker == 0xCC) {
        unsupported("arithmetic-coded JPEG");
      } else if (marker == 0xC4) {
        parse_dht(len);
      } else if (marker == 0xDB) {
        parse_dqt(len);
      } else if (marker == 0xDD) {
        restart_interval = u16();
      } else if (marker == 0xDA) {
        parse_sos(len);
        return;
      } else if (marker == 0xE0) {
        if (len >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0) jfif = true;
      } else if (marker == 0xE1) {
        parse_exif(data + pos, len - 2);
      } else if (marker == 0xEE) {
        if (len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
          adobe = true;
          adobe_transform = data[pos + 11];
        }
      } else if (marker == 0xDC) {
        unsupported("JPEG with a DNL marker");
      } else if (!((marker >= 0xE0 && marker <= 0xEF) || marker == 0xFE)) {
        char name[32];
        std::snprintf(name, sizeof(name), "unknown marker 0x%02X", marker);
        malformed(name);  // as libjpeg's read_markers (JERR_UNKNOWN_MARKER)
      }
      pos = next;
    }
  }

  void check_color_space() {
    if (ncomp != 3) return;
    // jdapimin.c default_decompress_parms: JFIF, then Adobe, then the ids
    bool rgb = false;
    if (jfif) rgb = false;
    else if (adobe) rgb = adobe_transform == 0;
    else rgb = comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
    if (rgb) unsupported("RGB-coded JPEG (Adobe transform 0)");
  }

  void layout() {
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (!quant_present[c.tq]) malformed("missing quantization table");
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      int mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      int mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
      c.bw = ncomp == 1 ? (c.dw + 7) / 8 : mcus_x * c.h;
      c.bh = ncomp == 1 ? (c.dh + 7) / 8 : mcus_y * c.v;
      c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
    }
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    if (!hd.present || !ha.present) malformed("missing Huffman table");
    int32_t coef[64 + 16] = {};
    int s = decode_huffman(br, hd);
    if (s > 11) malformed("bad DC coefficient");
    c.pred += extend(br.get(s), s);
    coef[0] = (int16_t)c.pred;
    for (int k = 1; k < 64; ++k) {
      int rs = decode_huffman(br, ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kZigzag[k]] = (int16_t)extend(br.get(s), s);
      } else if (r == 15) {
        k += 15;
      } else {
        break;
      }
    }
    int stride = c.bw * 8;
    idct_islow(coef, quant[c.tq], c.plane.data() + (size_t)by * 8 * stride + bx * 8, stride);
  }

  void decode_scan() {
    BitReader br(scan_data, data + size);
    for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
    int64_t n_mcus;
    int mcus_x;
    if (ncomp == 1) {
      mcus_x = comp[0].bw;
      n_mcus = (int64_t)comp[0].bw * comp[0].bh;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      n_mcus = (int64_t)mcus_x * ((height + 8 * vmax - 1) / (8 * vmax));
    }
    int next_rst = 0;
    for (int64_t m = 0; m < n_mcus; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        for (int i = 0; i < ncomp; ++i) comp[i].pred = 0;
      }
      int mx = (int)(m % mcus_x), my = (int)(m / mcus_x);
      if (ncomp == 1) {
        decode_block(br, comp[0], mx, my);
        continue;
      }
      for (int i = 0; i < ncomp; ++i) {
        Component& c = comp[scan_comps[i]];
        for (int v = 0; v < c.v; ++v)
          for (int h = 0; h < c.h; ++h) decode_block(br, c, mx * c.h + h, my * c.v + v);
      }
    }
    // what follows the scan: a second scan is refused, anything up to EOI skipped
    const uint8_t* p = br.position();
    const uint8_t* end = data + size;
    for (;;) {
      while (p < end && !(p[0] == 0xFF && p + 1 < end && p[1] != 0x00 && p[1] != 0xFF &&
                          !(p[1] >= 0xD0 && p[1] <= 0xD7)))
        ++p;
      if (p + 1 >= end) return;  // no EOI: libjpeg warns and keeps the image
      int marker = p[1];
      if (marker == 0xD9) return;
      if (marker == 0xDA) unsupported("multi-scan JPEG");
      if (marker == 0xDC) unsupported("JPEG with a DNL marker");
      if (p + 3 >= end) return;
      p += 2 + ((p[2] << 8) | p[3]);
    }
  }

  // one component plane upsampled to the full width and height; `out` is
  // height x width samples
  void upsample(const Component& c, std::vector<uint8_t>& out) const {
    out.assign((size_t)width * height, 0);
    const int stride = c.bw * 8;
    const int fh = hmax / c.h, fv = vmax / c.v;
    if (hmax % c.h || vmax % c.v) unsupported("fractional chroma sampling");
    auto in = [&](int y, int x) -> int {
      return c.plane[(size_t)y * stride + x];
    };
    if (fh == 1 && fv == 1) {
      for (int y = 0; y < height; ++y)
        std::memcpy(&out[(size_t)y * width], &c.plane[(size_t)y * stride], width);
      return;
    }
    std::vector<uint8_t> row(2 * (size_t)c.dw + 2);
    if (fh == 2 && fv == 1 && c.dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < height; ++y) {
        int x0 = in(y, 0);
        row[0] = (uint8_t)x0;
        row[1] = (uint8_t)((x0 * 3 + in(y, 1) + 2) >> 2);
        for (int x = 1; x < c.dw - 1; ++x) {
          int v3 = in(y, x) * 3;
          row[2 * x] = (uint8_t)((v3 + in(y, x - 1) + 1) >> 2);
          row[2 * x + 1] = (uint8_t)((v3 + in(y, x + 1) + 2) >> 2);
        }
        int xl = c.dw - 1, vl = in(y, xl);
        row[2 * xl] = (uint8_t)((vl * 3 + in(y, xl - 1) + 1) >> 2);
        row[2 * xl + 1] = (uint8_t)vl;
        std::memcpy(&out[(size_t)y * width], row.data(), width);
      }
      return;
    }
    if (fh == 2 && fv == 2 && c.dw > 2) {  // h2v2_fancy_upsample
      for (int y = 0; y < height; ++y) {
        int yi = y >> 1;
        // the nearer row, and the row above (even y) or below (odd y),
        // replicated at the top and bottom edges
        int yn = (y & 1) ? yi + 1 : yi - 1;
        yn = yn < 0 ? 0 : (yn > c.dh - 1 ? c.dh - 1 : yn);
        auto colsum = [&](int x) { return in(yi, x) * 3 + in(yn, x); };
        int this_s = colsum(0), next_s = colsum(1), last_s;
        row[0] = (uint8_t)((this_s * 4 + 8) >> 4);
        row[1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
        last_s = this_s;
        this_s = next_s;
        for (int x = 1; x < c.dw - 1; ++x) {
          next_s = colsum(x + 1);
          row[2 * x] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
          row[2 * x + 1] = (uint8_t)((this_s * 3 + next_s + 7) >> 4);
          last_s = this_s;
          this_s = next_s;
        }
        int xl = c.dw - 1;
        row[2 * xl] = (uint8_t)((this_s * 3 + last_s + 8) >> 4);
        row[2 * xl + 1] = (uint8_t)((this_s * 4 + 7) >> 4);
        std::memcpy(&out[(size_t)y * width], row.data(), width);
      }
      return;
    }
    if (fh == 1 && fv == 2) unsupported("4:4:0 chroma sampling");
    // libjpeg's plain upsamplers: each sample repeated fh x fv times
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < width; ++x) out[(size_t)y * width + x] = (uint8_t)in(y / fv, x / fh);
  }

  void to_rgb(uint8_t* rgb) const {
    if (ncomp == 1) {
      std::vector<uint8_t> g;
      upsample(comp[0], g);
      for (size_t i = 0; i < g.size(); ++i) rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
      return;
    }
    std::vector<uint8_t> yp, cb, cr;
    upsample(comp[0], yp);
    upsample(comp[1], cb);
    upsample(comp[2], cr);
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    constexpr int kScale = 16;
    constexpr int64_t kHalf = (int64_t)1 << (kScale - 1);
    auto fix = [](double x) { return (int64_t)(x * (1 << kScale) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < yp.size(); ++i) {
      int y = yp[i], b = cb[i], r = cr[i];
      rgb[3 * i] = clamp(y + cr_r[r]);
      rgb[3 * i + 1] = clamp(y + (int)((cb_g[b] + cr_g[r]) >> kScale));
      rgb[3 * i + 2] = clamp(y + cb_b[b]);
    }
  }
};

int report(const Failure& f, char* err, int64_t err_len) {
  if (err && err_len > 0) std::snprintf(err, (size_t)err_len, "%s", f.message.c_str());
  return f.code;
}

}  // namespace

extern "C" int aadff_jpeg_info(const uint8_t* data, int64_t size, int32_t* info, char* err,
                               int64_t err_len) {
  try {
    Decoder d(data, (size_t)size);
    d.read_header();
    d.check_color_space();
    info[0] = d.height;
    info[1] = d.width;
    info[2] = d.ncomp;
    info[3] = d.orientation;
    return 0;
  } catch (const Failure& f) {
    return report(f, err, err_len);
  } catch (const std::exception& e) {
    return report(Failure{2, e.what()}, err, err_len);
  }
}

extern "C" int aadff_jpeg_decode(const uint8_t* data, int64_t size, uint8_t* out,
                                 int64_t out_size, char* err, int64_t err_len) {
  try {
    Decoder d(data, (size_t)size);
    d.read_header();
    d.check_color_space();
    if ((int64_t)d.width * d.height * 3 != out_size) malformed("output buffer size");
    d.layout();
    d.decode_scan();
    d.to_rgb(out);
    return 0;
  } catch (const Failure& f) {
    return report(f, err, err_len);
  } catch (const std::exception& e) {
    return report(Failure{2, e.what()}, err, err_len);
  }
}
