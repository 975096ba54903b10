// Slide codecs of the port's TIFF reader: JPEG (baseline and extended
// Huffman, 8-bit), LZW (TIFF's MSB-first form), deflate (zlib), PackBits and
// none, with TIFF's horizontal predictor; Aperio's JPEG 2000 tiles (33003,
// 33005) go to the decoder in j2k.cc.
//
// The JPEG decoder mirrors libjpeg-turbo's default decode bit for bit:
// - the integer "islow" IDCT (jidctint.c) and its range-limit table;
// - fancy (triangle) upsampling for h2v1, h2v2 and h1v2 (jdsample.c), with
//   the first and last sample row repeated at the image's top and bottom
//   (jdmainct.c) and plain replication for other integral ratios;
// - fixed-point YCbCr -> RGB (jdcolor.c);
// - libjpeg's guess of a 3-component stream's colour space
//   (jdapimin.c::default_decompress_parms: JFIF, then Adobe APP14's
//   transform, then component ids 'R','G','B'), unless the caller forces
//   YCbCr (TIFF Photometric YCbCr, as libtiff does).
// Progressive, arithmetic-coded, lossless and 12-bit streams are refused
// with a code of their own. A stream that ends early or holds a bad Huffman
// code, a bad restart marker or a coefficient past the block is refused too:
// nothing is filled in.
//
// One call, tiff_decode_blocks, decodes every tile or strip a region needs:
// it reads each block with pread and decodes it on a small pool of threads
// (the GIL is released by ctypes) straight into the caller's buffer, as RGB.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -ffp-contract=off tiff_codecs.cc
//        j2k.cc -o libtiffcodecs.so -lz -lpthread (driven by
//        multimodalbrainsurvival_torch/data/codecs.py)

#include <fcntl.h>
#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "j2k.h"

namespace {

// --- error codes (data/codecs.py names them) --------------------------------
enum Code {
  OK = 0,
  E_OPEN = 1,           // cannot open the file
  E_READ = 2,           // short read of a block
  E_TRUNCATED = 3,      // the data ends before the block is complete
  E_CORRUPT = 4,        // the data is not a valid stream of its codec
  E_COMPRESSION = 5,    // a compression this reader does not decode
  E_PREDICTOR = 6,      // a predictor other than 1 or 2
  E_PHOTOMETRIC = 7,    // a photometric / samples combination not read
  E_JPEG_PROGRESSIVE = 8,
  E_JPEG_ARITHMETIC = 9,
  E_JPEG_LOSSLESS = 10,
  E_JPEG_PRECISION = 11,  // sample precision other than 8 bits
  E_JPEG_SAMPLING = 12,   // sampling factors libjpeg cannot upsample
  E_JPEG_COMPONENTS = 13, // neither 1 nor 3 components
  E_JPEG_NO_TABLE = 14,   // a quantisation or Huffman table never defined
  E_JPEG_DNL = 15,        // height given by a DNL marker
  E_LZW_OLD_STYLE = 16,   // LSB-first (pre-TIFF 6) LZW
  E_ZLIB = 17,
  E_EMPTY = 18,           // a block with no bytes
};

// --- JPEG --------------------------------------------------------------------

// natural-order index of each zigzag position
const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// libjpeg's post-IDCT range limit: x + 128 clamped, indexed by x & 1023
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; ++v)
      idct[v] = v < 128 ? uint8_t(v + 128) : v < 512 ? 255 : v < 896 ? 0 : uint8_t(v - 896);
  }
};
const RangeLimit kRange;

inline uint8_t clamp255(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];  // 0: code longer than kLookBits
  uint8_t look_val[1 << kLookBits];
  int32_t maxcode[18];  // largest code of length l, -1 if none
  int32_t valoffset[17];
  uint8_t vals[256];
};

// Build from DHT's 16 counts and values; false when the table is invalid.
bool build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals, int nvals) {
  std::memset(h.look_len, 0, sizeof(h.look_len));
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    h.valoffset[l] = k - code;
    if (counts[l - 1]) {
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
        if (l <= kLookBits) {
          const int shift = kLookBits - l;
          for (int j = 0; j < (1 << shift); ++j) {
            h.look_len[(code << shift) | j] = uint8_t(l);
            h.look_val[(code << shift) | j] = vals[k];
          }
        }
      }
      h.maxcode[l] = code - 1;
    } else {
      h.maxcode[l] = -1;
    }
    if (code > (1 << l)) return false;  // over-subscribed
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
  return true;
}

struct Tables {
  uint16_t quant[4][64];  // natural order
  bool quant_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;        // downsampled width / height (libjpeg's)
  int plane_w = 0, plane_h = 0;
  std::vector<uint8_t> plane;
  int dc_pred = 0;
  bool decoded = false;
};

// Bit reader over entropy-coded data: byte stuffing (FF 00), fill bytes
// (FF FF ...) and markers. Past a marker or the end it feeds zero bytes and
// counts them, so a scan that used them is known to have run out.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  int zeros = 0;
  bool at_marker = false;

  BitReader(const uint8_t* p_, const uint8_t* e_) : p(p_), end(e_) {}

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      if (!at_marker && p < end) {
        c = *p;
        if (c == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q < end && *q == 0x00) {
            p = q + 1;
          } else {  // a marker (or the end): leave p on its first FF
            at_marker = true;
            c = 0;
            ++zeros;
          }
        } else {
          ++p;
        }
      } else {
        ++zeros;
      }
      buf |= uint64_t(c) << (56 - bits);
      bits += 8;
    }
  }
  inline uint32_t peek(int n) { return uint32_t(buf >> (64 - n)); }
  inline void skip(int n) { buf <<= n; bits -= n; }
  // true once bits beyond the real data have been consumed
  bool overran() const { return zeros * 8 > bits; }
};

inline int decode_huffman(BitReader& br, const Huffman& h) {
  if (br.bits < 16) br.fill();
  const uint32_t look = br.peek(kLookBits);
  const int len = h.look_len[look];
  if (len) {
    br.skip(len);
    return h.look_val[look];
  }
  int l = kLookBits + 1;
  int32_t code = int32_t(br.peek(l));
  while (l <= 16 && code > h.maxcode[l]) {
    ++l;
    code = int32_t(br.peek(l));
  }
  if (l > 16) return -1;
  br.skip(l);
  return h.vals[(h.valoffset[l] + code) & 0xFF];
}

inline int receive_extend(BitReader& br, int s) {
  if (s == 0) return 0;
  if (br.bits < s) br.fill();
  int v = int(br.peek(s));
  br.skip(s);
  if (v < (1 << (s - 1))) v -= (1 << s) - 1;
  return v;
}

// jidctint.c: jpeg_idct_islow
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int64_t x, int n) {
  return int32_t((x + (int64_t(1) << (n - 1))) >> n);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int32_t* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
        in[48] == 0 && in[56] == 0) {
      const int32_t dc = (int32_t(in[0]) * qt[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[r * 8] = dc;
      continue;
    }
    int64_t z2 = int32_t(in[16]) * qt[16], z3 = int32_t(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(in[0]) * qt[0];
    z3 = int32_t(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int32_t(in[56]) * qt[56];
    tmp1 = int32_t(in[40]) * qt[40];
    tmp2 = int32_t(in[24]) * qt[24];
    tmp3 = int32_t(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    constexpr int S = CONST_BITS - PASS1_BITS;
    w[0] = descale(tmp10 + tmp3, S);
    w[56] = descale(tmp10 - tmp3, S);
    w[8] = descale(tmp11 + tmp2, S);
    w[48] = descale(tmp11 - tmp2, S);
    w[16] = descale(tmp12 + tmp1, S);
    w[40] = descale(tmp12 - tmp1, S);
    w[24] = descale(tmp13 + tmp0, S);
    w[32] = descale(tmp13 - tmp0, S);
  }
  constexpr int S2 = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; ++r) {
    const int32_t* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
        w[7] == 0) {
      const uint8_t dc = kRange.idct[descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    o[0] = kRange.idct[descale(tmp10 + tmp3, S2) & 1023];
    o[7] = kRange.idct[descale(tmp10 - tmp3, S2) & 1023];
    o[1] = kRange.idct[descale(tmp11 + tmp2, S2) & 1023];
    o[6] = kRange.idct[descale(tmp11 - tmp2, S2) & 1023];
    o[2] = kRange.idct[descale(tmp12 + tmp1, S2) & 1023];
    o[5] = kRange.idct[descale(tmp12 - tmp1, S2) & 1023];
    o[3] = kRange.idct[descale(tmp13 + tmp0, S2) & 1023];
    o[4] = kRange.idct[descale(tmp13 - tmp0, S2) & 1023];
  }
}

// jdcolor.c's tables (8-bit samples, SCALEBITS 16)
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = int32_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return int32_t(x * (1 << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

enum ColorMode { COLOR_GUESS = 0, COLOR_YCBCR = 1 };

struct Jpeg {
  Tables* tables;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  bool frame = false;
  Component comp[4];
};

inline int seg_len(const uint8_t* p, const uint8_t* end) {
  if (end - p < 2) return -1;
  return (p[0] << 8) | p[1];
}

int parse_dqt(Tables& t, const uint8_t* p, int len) {
  int i = 0;
  while (i < len) {
    const int pq = p[i] >> 4, tq = p[i] & 15;
    ++i;
    if (tq > 3 || pq > 1) return E_CORRUPT;
    const int n = pq ? 128 : 64;
    if (i + n > len) return E_CORRUPT;
    for (int k = 0; k < 64; ++k) {
      const int v = pq ? (p[i + 2 * k] << 8) | p[i + 2 * k + 1] : p[i + k];
      t.quant[tq][kZigzag[k]] = uint16_t(v);
    }
    t.quant_defined[tq] = true;
    i += n;
  }
  return OK;
}

int parse_dht(Tables& t, const uint8_t* p, int len) {
  int i = 0;
  while (i < len) {
    if (i + 17 > len) return E_CORRUPT;
    const int tc = p[i] >> 4, th = p[i] & 15;
    if (tc > 1 || th > 3) return E_CORRUPT;
    int total = 0;
    for (int k = 0; k < 16; ++k) total += p[i + 1 + k];
    if (total > 256 || i + 17 + total > len) return E_CORRUPT;
    Huffman& h = tc ? t.ac[th] : t.dc[th];
    if (!build_huffman(h, p + i + 1, p + i + 17, total)) return E_CORRUPT;
    i += 17 + total;
  }
  return OK;
}

int parse_sof(Jpeg& j, const uint8_t* p, int len) {
  if (len < 6) return E_CORRUPT;
  if (p[0] != 8) return E_JPEG_PRECISION;
  j.height = (p[1] << 8) | p[2];
  j.width = (p[3] << 8) | p[4];
  j.ncomp = p[5];
  if (j.height == 0) return E_JPEG_DNL;
  if (j.width == 0) return E_CORRUPT;
  if (j.ncomp != 1 && j.ncomp != 3) return E_JPEG_COMPONENTS;
  if (len < 6 + 3 * j.ncomp) return E_CORRUPT;
  j.hmax = j.vmax = 1;
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    k.id = p[6 + 3 * c];
    k.h = p[7 + 3 * c] >> 4;
    k.v = p[7 + 3 * c] & 15;
    k.tq = p[8 + 3 * c];
    if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3) return E_CORRUPT;
    j.hmax = std::max(j.hmax, k.h);
    j.vmax = std::max(j.vmax, k.v);
  }
  j.mcus_x = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcus_y = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int c = 0; c < j.ncomp; ++c) {
    Component& k = j.comp[c];
    if (j.hmax % k.h || j.vmax % k.v) return E_JPEG_SAMPLING;
    k.dw = int((int64_t(j.width) * k.h + j.hmax - 1) / j.hmax);
    k.dh = int((int64_t(j.height) * k.v + j.vmax - 1) / j.vmax);
    k.plane_w = j.mcus_x * k.h * 8;
    k.plane_h = j.mcus_y * k.v * 8;
    k.plane.assign(size_t(k.plane_w) * k.plane_h, 0);
    k.decoded = false;
  }
  j.frame = true;
  return OK;
}

// Skip to the next marker from p (fill bytes swallowed); returns its code
// and leaves p after it, or -1 at the end of the data. Non-marker bytes in
// between make the stream corrupt (-2).
int next_marker(const uint8_t*& p, const uint8_t* end) {
  if (p >= end) return -1;
  if (*p != 0xFF) return -2;
  while (p < end && *p == 0xFF) ++p;
  if (p >= end) return -1;
  return *p++;
}

int decode_block(BitReader& br, Component& k, const Tables& t, int bx, int by) {
  int16_t coef[64];
  std::memset(coef, 0, sizeof(coef));
  const Huffman& dc = t.dc[k.td];
  const Huffman& ac = t.ac[k.ta];
  if (br.bits < 32) br.fill();
  int s = decode_huffman(br, dc);
  if (s < 0 || s > 15) return E_CORRUPT;
  k.dc_pred += receive_extend(br, s);
  coef[0] = int16_t(k.dc_pred);
  for (int i = 1; i < 64;) {
    if (br.bits < 32) br.fill();
    const int rs = decode_huffman(br, ac);
    if (rs < 0) return E_CORRUPT;
    const int r = rs >> 4;
    s = rs & 15;
    if (s) {
      i += r;
      if (i > 63) return E_CORRUPT;
      coef[kZigzag[i]] = int16_t(receive_extend(br, s));
      ++i;
    } else {
      if (r != 15) break;
      i += 16;
    }
  }
  idct_islow(coef, t.quant[k.tq], k.plane.data() + size_t(by) * 8 * k.plane_w + bx * 8,
             k.plane_w);
  return OK;
}

// One scan (SOS's payload at p); on return p is at the marker after it.
int decode_scan(Jpeg& j, const uint8_t*& p, const uint8_t* end, int len) {
  if (!j.frame) return E_CORRUPT;
  const uint8_t* s = p;
  const int ns = s[0];
  if (ns < 1 || ns > j.ncomp || len != 4 + 2 * ns) return E_CORRUPT;
  Component* sc[4];
  for (int i = 0; i < ns; ++i) {
    const int id = s[1 + 2 * i];
    Component* k = nullptr;
    for (int c = 0; c < j.ncomp; ++c)
      if (j.comp[c].id == id) k = &j.comp[c];
    if (!k) return E_CORRUPT;
    k->td = s[2 + 2 * i] >> 4;
    k->ta = s[2 + 2 * i] & 15;
    if (k->td > 3 || k->ta > 3) return E_CORRUPT;
    if (!j.tables->dc[k->td].defined || !j.tables->ac[k->ta].defined ||
        !j.tables->quant_defined[k->tq])
      return E_JPEG_NO_TABLE;
    k->dc_pred = 0;
    sc[i] = k;
  }
  const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahl = s[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahl != 0) return E_CORRUPT;
  p += len;

  BitReader br(p, end);
  int units_x, units_y;
  if (ns == 1) {
    units_x = (sc[0]->dw + 7) / 8;
    units_y = (sc[0]->dh + 7) / 8;
  } else {
    units_x = j.mcus_x;
    units_y = j.mcus_y;
  }
  const int64_t total = int64_t(units_x) * units_y;
  int restart_num = 0;
  for (int64_t m = 0; m < total; ++m) {
    if (j.restart_interval && m > 0 && m % j.restart_interval == 0) {
      if (br.overran()) return br.p >= end ? E_TRUNCATED : E_CORRUPT;
      const uint8_t* q = br.p;
      const int marker = next_marker(q, end);
      if (marker == -1) return E_TRUNCATED;
      if (marker != 0xD0 + restart_num) return E_CORRUPT;
      restart_num = (restart_num + 1) & 7;
      br = BitReader(q, end);
      for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    }
    const int mx = int(m % units_x), my = int(m / units_x);
    int rc;
    if (ns == 1) {
      rc = decode_block(br, *sc[0], *j.tables, mx, my);
      if (rc) return rc;
    } else {
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        for (int v = 0; v < k.v; ++v)
          for (int h = 0; h < k.h; ++h) {
            rc = decode_block(br, k, *j.tables, mx * k.h + h, my * k.v + v);
            if (rc) return rc;
          }
      }
    }
  }
  if (br.overran()) return br.p >= end ? E_TRUNCATED : E_CORRUPT;
  for (int i = 0; i < ns; ++i) sc[i]->decoded = true;
  // resume marker parsing at the first marker after the entropy data
  const uint8_t* q = br.p;
  while (q < end) {
    if (q[0] == 0xFF && q + 1 < end && q[1] != 0x00 && q[1] != 0xFF &&
        !(q[1] >= 0xD0 && q[1] <= 0xD7))
      break;
    ++q;
  }
  p = q;
  return OK;
}

// Parse markers from SOI to EOI (tables_only: a JPEGTables stream).
int parse_stream(Jpeg& j, const uint8_t* data, size_t n, bool tables_only) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  if (n < 2 || p[0] != 0xFF || p[1] != 0xD8) return n == 0 ? E_EMPTY : E_CORRUPT;
  p += 2;
  // SOI resets what libjpeg's get_soi resets
  j.restart_interval = 0;
  j.saw_jfif = j.saw_adobe = false;
  for (;;) {
    const int marker = next_marker(p, end);
    if (marker == -1) return tables_only ? OK : E_TRUNCATED;
    if (marker == -2) return E_CORRUPT;
    if (marker == 0xD9) return OK;  // EOI
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    const int len = seg_len(p, end);
    if (len < 2 || p + len > end) return E_TRUNCATED;
    const uint8_t* body = p + 2;
    const int blen = len - 2;
    int rc = OK;
    switch (marker) {
      case 0xDB: rc = parse_dqt(*j.tables, body, blen); break;
      case 0xC4: rc = parse_dht(*j.tables, body, blen); break;
      case 0xDD:
        if (blen < 2) return E_CORRUPT;
        j.restart_interval = (body[0] << 8) | body[1];
        break;
      case 0xC0: case 0xC1:
        if (tables_only) return E_CORRUPT;
        rc = parse_sof(j, body, blen);
        break;
      case 0xC2: case 0xC6: return E_JPEG_PROGRESSIVE;
      case 0xC3: case 0xC7: case 0xCB: case 0xCF: return E_JPEG_LOSSLESS;
      case 0xC5: return E_JPEG_PROGRESSIVE;  // hierarchical
      case 0xC9: case 0xCA: case 0xCD: case 0xCE: case 0xCC: return E_JPEG_ARITHMETIC;
      case 0xDC: return E_JPEG_DNL;
      case 0xE0:
        if (blen >= 14 && std::memcmp(body, "JFIF\0", 5) == 0) j.saw_jfif = true;
        break;
      case 0xEE:
        if (blen >= 12 && std::memcmp(body, "Adobe", 5) == 0) {
          j.saw_adobe = true;
          j.adobe_transform = body[11];
        }
        break;
      case 0xDA: {
        if (tables_only) return E_CORRUPT;
        p += 2;
        rc = decode_scan(j, p, end, blen);
        if (rc) return rc;
        continue;
      }
      default: break;  // APPn, COM and others: skipped
    }
    if (rc) return rc;
    p += len;
  }
}

// Upsample component k into a full-resolution row-major plane (w x h).
void upsample(const Jpeg& j, const Component& k, uint8_t* out, int w, int h) {
  const int fx = j.hmax / k.h, fy = j.vmax / k.v;
  const uint8_t* in = k.plane.data();
  const int pw = k.plane_w;
  const int ow = k.dw * fx;  // rows are computed to here, then cut at w
  std::vector<uint8_t> row(size_t(ow) + 8);
  auto in_row = [&](int r) { return in + size_t(std::clamp(r, 0, k.dh - 1)) * pw; };
  const bool fancy_h2 = fx == 2 && k.dw > 2;
  for (int y = 0; y < h; ++y) {
    uint8_t* o = row.data();
    if (fx == 2 && fy == 2 && fancy_h2) {  // h2v2_fancy_upsample
      const int r = y >> 1;
      const uint8_t* in0 = in_row(r);
      const uint8_t* in1 = in_row((y & 1) ? r + 1 : r - 1);
      int thiscol = in0[0] * 3 + in1[0];
      int nextcol = in0[1] * 3 + in1[1];
      *o++ = uint8_t((thiscol * 4 + 8) >> 4);
      *o++ = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
      int lastcol = thiscol;
      thiscol = nextcol;
      for (int c = 2; c < k.dw; ++c) {
        nextcol = in0[c] * 3 + in1[c];
        *o++ = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
        *o++ = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
        lastcol = thiscol;
        thiscol = nextcol;
      }
      *o++ = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
      *o++ = uint8_t((thiscol * 4 + 7) >> 4);
    } else if (fx == 1 && fy == 2) {  // h1v2_fancy_upsample
      const int r = y >> 1;
      const uint8_t* in0 = in_row(r);
      const uint8_t* in1 = in_row((y & 1) ? r + 1 : r - 1);
      const int bias = (y & 1) ? 2 : 1;
      for (int c = 0; c < k.dw; ++c) o[c] = uint8_t((in0[c] * 3 + in1[c] + bias) >> 2);
    } else if (fx == 2 && fy == 1 && fancy_h2) {  // h2v1_fancy_upsample
      const uint8_t* in0 = in_row(y);
      int v = in0[0];
      *o++ = uint8_t(v);
      *o++ = uint8_t((v * 3 + in0[1] + 2) >> 2);
      for (int c = 1; c < k.dw - 1; ++c) {
        v = in0[c] * 3;
        *o++ = uint8_t((v + in0[c - 1] + 1) >> 2);
        *o++ = uint8_t((v + in0[c + 1] + 2) >> 2);
      }
      v = in0[k.dw - 1];
      *o++ = uint8_t((v * 3 + in0[k.dw - 2] + 1) >> 2);
      *o++ = uint8_t(v);
    } else {  // h2v1 / h2v2 at widths <= 2 and other integral ratios: replicate
      const uint8_t* in0 = in + size_t(y / fy) * pw;
      for (int c = 0; c < k.dw; ++c)
        for (int i = 0; i < fx; ++i) *o++ = in0[c];
    }
    std::memcpy(out + size_t(y) * w, row.data(), size_t(std::min(w, ow)));
  }
}

// Decode one JPEG stream (tables first, when given) into out: an RGB
// buffer of out_w x out_h, of which the stream's min(width, out_w) x
// min(height, out_h) corner is written.
int decode_jpeg(const uint8_t* tables, size_t tables_n, const uint8_t* data, size_t n,
                int mode, uint8_t* out, int out_w, int out_h) {
  Tables t;
  Jpeg j;
  j.tables = &t;
  int rc;
  if (tables && tables_n) {
    rc = parse_stream(j, tables, tables_n, true);
    if (rc) return rc;
  }
  rc = parse_stream(j, data, n, false);
  if (rc) return rc;
  if (!j.frame) return E_TRUNCATED;
  for (int c = 0; c < j.ncomp; ++c)
    if (!j.comp[c].decoded) return E_TRUNCATED;
  const int w = std::min(j.width, out_w), h = std::min(j.height, out_h);
  if (j.ncomp == 1) {
    const Component& k = j.comp[0];
    for (int y = 0; y < h; ++y) {
      const uint8_t* src = k.plane.data() + size_t(y) * k.plane_w;
      uint8_t* dst = out + size_t(y) * out_w * 3;
      for (int x = 0; x < w; ++x, dst += 3) dst[0] = dst[1] = dst[2] = src[x];
    }
    return OK;
  }
  bool ycc;
  if (mode == COLOR_YCBCR) {
    ycc = true;
  } else if (j.saw_jfif) {
    ycc = true;
  } else if (j.saw_adobe) {
    ycc = j.adobe_transform != 0;
  } else {
    ycc = !(j.comp[0].id == 82 && j.comp[1].id == 71 && j.comp[2].id == 66);
  }
  std::vector<uint8_t> planes[3];
  for (int c = 0; c < 3; ++c) {
    planes[c].resize(size_t(w) * h);
    upsample(j, j.comp[c], planes[c].data(), w, h);
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* p0 = planes[0].data() + size_t(y) * w;
    const uint8_t* p1 = planes[1].data() + size_t(y) * w;
    const uint8_t* p2 = planes[2].data() + size_t(y) * w;
    uint8_t* dst = out + size_t(y) * out_w * 3;
    if (ycc) {
      for (int x = 0; x < w; ++x, dst += 3) {
        const int yy = p0[x], cb = p1[x], cr = p2[x];
        dst[0] = clamp255(yy + kYcc.cr_r[cr]);
        dst[1] = clamp255(yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        dst[2] = clamp255(yy + kYcc.cb_b[cb]);
      }
    } else {
      for (int x = 0; x < w; ++x, dst += 3) {
        dst[0] = p0[x];
        dst[1] = p1[x];
        dst[2] = p2[x];
      }
    }
  }
  return OK;
}

// --- LZW, PackBits, deflate -----------------------------------------------

// TIFF LZW (MSB-first, the code width growing one code early). Decodes
// until out_n bytes or EOI; *produced is what it wrote.
int decode_lzw(const uint8_t* in, size_t n, uint8_t* out, size_t out_n, size_t* produced) {
  if (n >= 2 && in[0] == 0 && (in[1] & 1)) return E_LZW_OLD_STYLE;
  struct Entry {
    uint16_t prefix;
    uint16_t len;
    uint8_t ch, first;
  };
  // libtiff's table has room past 4,096 codes for encoders late to clear
  static thread_local Entry table[5120];
  for (int i = 0; i < 256; ++i) table[i] = {0, 1, uint8_t(i), uint8_t(i)};
  size_t pos = 0, bitpos = 0;
  const size_t nbits_total = n * 8;
  int nbits = 9, next = 258, old = -1;
  auto get = [&](int nb) -> int {
    if (bitpos + nb > nbits_total) return -1;
    const size_t b = bitpos >> 3;
    uint32_t v = uint32_t(in[b]) << 16;
    if (b + 1 < n) v |= uint32_t(in[b + 1]) << 8;
    if (b + 2 < n) v |= in[b + 2];
    v = (v >> (24 - int(bitpos & 7) - nb)) & ((1u << nb) - 1);
    bitpos += nb;
    return int(v);
  };
  auto emit = [&](int code) {
    const int len = table[code].len;
    size_t at = pos + len;
    int c = code;
    // write backwards, cut at out_n
    for (int i = len - 1; i >= 0; --i) {
      if (pos + i < out_n) out[pos + i] = table[c].ch;
      c = table[c].prefix;
    }
    pos = std::min(at, out_n);
  };
  while (pos < out_n) {
    int code = get(nbits);
    if (code < 0 || code == 257) break;
    if (code == 256) {
      nbits = 9;
      next = 258;
      code = get(nbits);
      if (code < 0 || code == 257) break;
      if (code > 256) return E_CORRUPT;
      if (code == 256) continue;
      emit(code);
      old = code;
      continue;
    }
    if (old < 0) {  // no clear code first: libtiff reads on
      if (code > 255) return E_CORRUPT;
      emit(code);
      old = code;
      continue;
    }
    if (next >= 5120) return E_CORRUPT;
    if (code < next) {
      emit(code);
      table[next] = {uint16_t(old), uint16_t(table[old].len + 1), table[code].first,
                     table[old].first};
    } else if (code == next) {
      table[next] = {uint16_t(old), uint16_t(table[old].len + 1), table[old].first,
                     table[old].first};
      emit(code);
    } else {
      return E_CORRUPT;
    }
    ++next;
    if (next >= (1 << nbits) - 1 && nbits < 12) ++nbits;
    old = code;
  }
  *produced = pos;
  return OK;
}

int decode_packbits(const uint8_t* in, size_t n, uint8_t* out, size_t out_n, size_t* produced) {
  size_t i = 0, pos = 0;
  while (pos < out_n && i < n) {
    const int c = int8_t(in[i++]);
    if (c >= 0) {
      const size_t cnt = size_t(c) + 1;
      if (i + cnt > n) return E_TRUNCATED;
      const size_t k = std::min(cnt, out_n - pos);
      std::memcpy(out + pos, in + i, k);
      pos += k;
      i += cnt;
    } else if (c != -128) {
      if (i >= n) return E_TRUNCATED;
      const size_t k = std::min(size_t(1 - c), out_n - pos);
      std::memset(out + pos, in[i++], k);
      pos += k;
    }
  }
  *produced = pos;
  return OK;
}

int decode_deflate(const uint8_t* in, size_t n, uint8_t* out, size_t out_n, size_t* produced) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return E_ZLIB;
  zs.next_in = const_cast<Bytef*>(in);
  zs.avail_in = uInt(n);
  zs.next_out = out;
  zs.avail_out = uInt(out_n);
  int rc;
  do {
    rc = inflate(&zs, Z_NO_FLUSH);
  } while (rc == Z_OK && zs.avail_out > 0 && zs.avail_in > 0);
  *produced = out_n - zs.avail_out;
  inflateEnd(&zs);
  if (rc == Z_DATA_ERROR || rc == Z_NEED_DICT || rc == Z_MEM_ERROR) return E_CORRUPT;
  return OK;
}

struct BlockParams {
  int block_w, block_h;
  int compression, predictor, photometric, samples;
  const uint8_t* tables;
  size_t tables_n;
};

// Decode one block's bytes into out (block_h x block_w x 3, zeroed), rows
// of it valid.
int decode_one(const BlockParams& bp, const uint8_t* data, size_t n, int rows, uint8_t* out) {
  if (n == 0) return E_EMPTY;
  if (bp.compression == 33003 || bp.compression == 33005)  // Aperio JPEG 2000
    return j2k::decode_rgb(data, n, bp.compression == 33003, out, bp.block_w, rows);
  if (bp.compression == 7) {
    if (bp.photometric != 2 && bp.photometric != 6 && bp.photometric != 1 &&
        bp.photometric != 0)
      return E_PHOTOMETRIC;
    return decode_jpeg(bp.tables, bp.tables_n, data, n,
                       bp.photometric == 6 ? COLOR_YCBCR : COLOR_GUESS, out, bp.block_w,
                       rows);
  }
  const int spp = bp.samples;
  if (!((spp == 3 && bp.photometric == 2) || (spp == 1 && bp.photometric <= 1)))
    return E_PHOTOMETRIC;
  const size_t row_bytes = size_t(bp.block_w) * spp;
  const size_t need = row_bytes * rows;
  std::vector<uint8_t> raw;
  const uint8_t* px = data;
  size_t produced = 0;
  int rc = OK;
  switch (bp.compression) {
    case 1:
      produced = std::min(n, need);
      break;
    case 5:
      raw.resize(need);
      rc = decode_lzw(data, n, raw.data(), need, &produced);
      px = raw.data();
      break;
    case 8: case 32946:
      raw.resize(need);
      rc = decode_deflate(data, n, raw.data(), need, &produced);
      px = raw.data();
      break;
    case 32773:
      raw.resize(need);
      rc = decode_packbits(data, n, raw.data(), need, &produced);
      px = raw.data();
      break;
    default:
      return E_COMPRESSION;
  }
  if (rc) return rc;
  if (produced < need) return E_TRUNCATED;
  // the predictor belongs to the LZW and deflate codecs (libtiff ignores it
  // elsewhere)
  if (!raw.empty() && bp.compression != 32773) {
    if (bp.predictor == 2) {
      for (int r = 0; r < rows; ++r) {
        uint8_t* row = raw.data() + r * row_bytes;
        for (size_t i = spp; i < row_bytes; ++i) row[i] = uint8_t(row[i] + row[i - spp]);
      }
    } else if (bp.predictor != 1) {
      return E_PREDICTOR;
    }
  }
  const size_t npx = size_t(bp.block_w) * rows;
  if (spp == 3) {
    std::memcpy(out, px, npx * 3);
  } else {
    const uint8_t inv = bp.photometric == 0 ? 0xFF : 0;
    for (size_t i = 0; i < npx; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = px[i] ^ inv;
  }
  return OK;
}

}  // namespace

extern "C" {

// Decode n blocks (tiles or strips) of one directory of the file at path:
// block i is counts[i] bytes at offsets[i] and holds rows[i] valid rows of
// block_w pixels. Each is written as RGB to out + i * block_h * block_w * 3
// (the rest of the block left as it is). codes[i] is 0 or its error code.
// Returns the number of blocks that failed, or -E_OPEN.
int tiff_decode_blocks(const char* path, const int64_t* offsets, const int64_t* counts,
                       const int32_t* rows, int n, int block_w, int block_h,
                       int compression, int predictor, int photometric, int samples,
                       const uint8_t* tables, int64_t tables_n, uint8_t* out,
                       int num_threads, int32_t* codes) {
  const int fd = open(path, O_RDONLY);
  if (fd < 0) return -E_OPEN;
  const BlockParams bp{block_w, block_h, compression, predictor, photometric, samples,
                       tables, size_t(tables_n > 0 ? tables_n : 0)};
  std::atomic<int> next(0), failed(0);
  auto work = [&]() {
    std::vector<uint8_t> buf;
    for (int i = next++; i < n; i = next++) {
      const size_t cnt = size_t(counts[i] > 0 ? counts[i] : 0);
      buf.resize(cnt);
      size_t got = 0;
      while (got < cnt) {
        const ssize_t r = pread(fd, buf.data() + got, cnt - got, off_t(offsets[i] + got));
        if (r <= 0) break;
        got += size_t(r);
      }
      int rc = got < cnt ? E_READ
                         : decode_one(bp, buf.data(), cnt, rows[i],
                                      out + size_t(i) * block_h * block_w * 3);
      codes[i] = rc;
      if (rc) ++failed;
    }
  };
  const int threads = std::max(1, std::min(num_threads, n));
  if (threads == 1) {
    work();
  } else {
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
  }
  close(fd);
  return failed.load();
}

// A JPEG stream's frame: width, height and components; 0 or an error code
// (progressive and other unread processes report theirs).
int jpeg_frame_info(const uint8_t* data, int64_t n, int* width, int* height, int* ncomp) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  if (n < 2 || p[0] != 0xFF || p[1] != 0xD8) return E_CORRUPT;
  p += 2;
  for (;;) {
    const int marker = next_marker(p, end);
    if (marker < 0) return marker == -1 ? E_TRUNCATED : E_CORRUPT;
    if (marker == 0xD9 || marker == 0xDA) return E_CORRUPT;  // no frame before
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    const int len = seg_len(p, end);
    if (len < 2 || p + len > end) return E_TRUNCATED;
    if (marker >= 0xC0 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
        marker != 0xCC) {
      if (len < 8) return E_CORRUPT;
      *height = (p[3] << 8) | p[4];
      *width = (p[5] << 8) | p[6];
      *ncomp = p[7];
      switch (marker) {
        case 0xC0: case 0xC1: return p[2] == 8 ? OK : E_JPEG_PRECISION;
        case 0xC2: case 0xC6: case 0xC5: return E_JPEG_PROGRESSIVE;
        case 0xC3: case 0xC7: case 0xCB: case 0xCF: return E_JPEG_LOSSLESS;
        default: return E_JPEG_ARITHMETIC;
      }
    }
    p += len;
  }
}

// Decode a whole JPEG stream (libjpeg's colour guess) into out (height x
// width x 3 RGB, as jpeg_frame_info gave them).
int jpeg_decode_rgb(const uint8_t* data, int64_t n, uint8_t* out, int width, int height) {
  return decode_jpeg(nullptr, 0, data, size_t(n), COLOR_GUESS, out, width, height);
}

}  // extern "C"
