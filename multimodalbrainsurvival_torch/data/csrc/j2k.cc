// JPEG 2000 Part-1 codestream decoder for the port's slide reader: the bare
// codestreams that Aperio writes as TIFF tiles under compression 33003
// (YCbCr samples, no component transform signalled) and 33005 (RGB).
//
// Written from ISO/IEC 15444-1, keeping to the reconstruction rules of
// OpenJPEG 2.5 (the decoder behind Pillow's JPEG 2000 plugin), so that a
// tile decodes to the pixels Pillow gives:
// - code-block coefficients carry one bit below the last decoded bit-plane
//   and are reconstructed at its midpoint (t1.c): halved with C's
//   truncating division for the 5/3 transform, times half the step size in
//   float32 for the 9/7;
// - the 5/3 inverse DWT in integers, horizontal then vertical at each
//   level; the 9/7 in float32 with OpenJPEG's lifting constants, its 2/K
//   scaling of the high band, its order of operations and its early return
//   on a single sample (dwt.c). Built with -ffp-contract=off and without
//   -ffast-math, so every float step rounds alike on every x86-64 machine;
// - the inverse RCT / ICT only where COD signals a component transform,
//   then the DC level shift, float values rounded with lrintf, and
//   clamping to 0..255 (tcd.c, mct.c);
// - Pillow's unpack to 8-bit RGB (one or two components replicate the
//   first, a fourth is dropped) and, for 33003, Pillow's fixed-point
//   YCbCr -> RGB (ConvertYCbCr.c: 6 fractional bits, tables built as
//   int(c * (i - 128) * 64 + 0.5)).
//
// Read: SOC, SIZ, COD, COC, QCD, QCC, COM, TLM, PLM, PLT, CRG, SOT (any
// number of tiles and tile-parts), SOD, EOC, and SOP / EPH in the packet
// stream; the five progression orders, default and user-defined precincts,
// any number of quality layers; quantisation none, scalar derived or
// scalar expounded. Refused, each with a code of its own (j2k.h): POC, RGN,
// PPM, PPT and any other marker; signed components, precisions other than
// 8 bits, subsampled components and more than 4 components; every
// code-block style bit. A codestream that ends early or does not parse is
// refused too: nothing is guessed.

#include "j2k.h"

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstring>
#include <vector>

namespace j2k {
namespace {

struct Fail {
  int code;
};
[[noreturn]] void fail(int code) { throw Fail{code}; }
inline void need(bool ok, int code = E_CORRUPT) {
  if (!ok) fail(code);
}

inline int64_t ceil_pow2(int64_t a, int n) { return -((-a) >> n); }
inline int64_t floor_pow2(int64_t a, int n) { return a >> n; }
inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }  // a >= 0

enum : uint16_t {
  SOC = 0xFF4F, SIZ = 0xFF51, COD = 0xFF52, COC = 0xFF53, TLM = 0xFF55, PLM = 0xFF57,
  PLT = 0xFF58, QCD = 0xFF5C, QCC = 0xFF5D, RGN = 0xFF5E, POC = 0xFF5F, PPM = 0xFF60,
  PPT = 0xFF61, CRG = 0xFF63, COM = 0xFF64, SOT = 0xFF90, SOP = 0xFF91, EPH = 0xFF92,
  SOD = 0xFF93, EOC = 0xFFD9,
};

inline uint16_t be16(const uint8_t* p) { return uint16_t(p[0] << 8 | p[1]); }
inline uint32_t be32(const uint8_t* p) {
  return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3];
}

// --- headers ------------------------------------------------------------------

struct Coding {  // SPcod / SPcoc: one component's coding style
  int levels = 0, cbw = 6, cbh = 6, reversible = 0;
  uint8_t ppx[33], ppy[33];
};

struct Quant {  // SQcd / SQcc
  int style = 0, guard = 0, n = 0;
  int expn[97] = {}, mant[97] = {};
};

struct Scope {  // the main header, or one tile's tile-part headers
  bool has_cod = false;
  int scod = 0, order = 0, layers = 1, mct = 0;
  Coding cod;
  bool has_coc[4] = {};
  Coding coc[4];
  bool has_qcd = false;
  Quant qcd;
  bool has_qcc[4] = {};
  Quant qcc[4];
};

struct Siz {
  int64_t x1, y1, x0, y0, tw, th, tx0, ty0;
  int ncomp, ntx, nty;
};

// SPcod / SPcoc at p (len bytes), user-defined precincts when prec.
void parse_coding(const uint8_t* p, int len, bool prec, Coding& c) {
  need(len >= 5);
  c.levels = p[0];
  need(c.levels <= 32);
  c.cbw = (p[1] & 0xF) + 2;
  c.cbh = (p[2] & 0xF) + 2;
  need(p[1] <= 8 && p[2] <= 8 && c.cbw + c.cbh <= 12);
  const int style = p[3];
  if (style & 0x01) fail(E_BYPASS);
  if (style & 0x02) fail(E_RESET);
  if (style & 0x04) fail(E_TERMALL);
  if (style & 0x08) fail(E_VCAUSAL);
  if (style & 0x10) fail(E_PTERM);
  if (style & 0x20) fail(E_SEGSYM);
  if (style & 0xC0) fail(E_STYLE_EXT);
  need(p[4] <= 1);
  c.reversible = p[4];
  if (prec) {
    need(len == 5 + c.levels + 1);
    for (int r = 0; r <= c.levels; ++r) {
      c.ppx[r] = p[5 + r] & 0xF;
      c.ppy[r] = p[5 + r] >> 4;
      need(r == 0 || (c.ppx[r] > 0 && c.ppy[r] > 0));
    }
  } else {
    need(len == 5);
    for (int r = 0; r <= c.levels; ++r) c.ppx[r] = c.ppy[r] = 15;
  }
}

void parse_quant(const uint8_t* p, int len, Quant& q) {
  need(len >= 1);
  q.style = p[0] & 0x1F;
  q.guard = p[0] >> 5;
  ++p;
  --len;
  if (q.style == 0) {
    need(len >= 1 && len <= 97);
    q.n = len;
    for (int i = 0; i < len; ++i) q.expn[i] = p[i] >> 3, q.mant[i] = 0;
  } else if (q.style == 1 || q.style == 2) {
    need(len >= 2 && len % 2 == 0 && len <= 2 * 97 && (q.style == 2 || len == 2));
    q.n = len / 2;
    for (int i = 0; i < q.n; ++i) {
      const int v = be16(p + 2 * i);
      q.expn[i] = v >> 11;
      q.mant[i] = v & 0x7FF;
    }
  } else {
    fail(E_CORRUPT);
  }
}

// A marker segment of the main or a tile-part header.
void parse_segment(uint16_t marker, const uint8_t* p, int len, const Siz& siz, Scope& s) {
  const int cbytes = siz.ncomp < 257 ? 1 : 2;
  switch (marker) {
    case COD:
      need(len >= 5);
      s.has_cod = true;
      s.scod = p[0];
      need((s.scod & ~7) == 0);
      s.order = p[1];
      need(s.order <= 4);
      s.layers = be16(p + 2);
      need(s.layers >= 1);
      if (p[4] > 1) fail(E_MCT);
      s.mct = p[4];
      parse_coding(p + 5, len - 5, s.scod & 1, s.cod);
      break;
    case COC: {
      need(len >= cbytes + 1);
      const int c = cbytes == 1 ? p[0] : be16(p);
      need(c < siz.ncomp);
      need((p[cbytes] & ~1) == 0);
      parse_coding(p + cbytes + 1, len - cbytes - 1, p[cbytes] & 1, s.coc[c]);
      s.has_coc[c] = true;
      break;
    }
    case QCD:
      parse_quant(p, len, s.qcd);
      s.has_qcd = true;
      break;
    case QCC: {
      need(len >= cbytes + 1);
      const int c = cbytes == 1 ? p[0] : be16(p);
      need(c < siz.ncomp);
      parse_quant(p + cbytes, len - cbytes, s.qcc[c]);
      s.has_qcc[c] = true;
      break;
    }
    case COM: case TLM: case PLM: case PLT: case CRG:
      break;
    case POC: fail(E_POC);
    case RGN: fail(E_RGN);
    case PPM: fail(E_PPM);
    case PPT: fail(E_PPT);
    default: fail(E_MARKER);
  }
}

Siz parse_siz(const uint8_t* p, int len) {
  need(len >= 36);
  Siz s;
  s.x1 = be32(p + 2); s.y1 = be32(p + 6);
  s.x0 = be32(p + 10); s.y0 = be32(p + 14);
  s.tw = be32(p + 18); s.th = be32(p + 22);
  s.tx0 = be32(p + 26); s.ty0 = be32(p + 30);
  s.ncomp = be16(p + 34);
  need(s.ncomp >= 1 && len == 36 + 3 * s.ncomp);
  if (s.ncomp > 4) fail(E_COMPONENTS);
  for (int c = 0; c < s.ncomp; ++c) {
    const uint8_t* q = p + 36 + 3 * c;
    if (q[0] & 0x80) fail(E_SIGNED);
    if ((q[0] & 0x7F) + 1 != 8) fail(E_PRECISION);
    need(q[1] >= 1 && q[2] >= 1);
    if (q[1] != 1 || q[2] != 1) fail(E_SUBSAMPLED);
  }
  need(s.x1 > s.x0 && s.y1 > s.y0 && s.tw > 0 && s.th > 0);
  need(s.tx0 <= s.x0 && s.ty0 <= s.y0 && s.tx0 + s.tw > s.x0 && s.ty0 + s.th > s.y0);
  // an image of at most 2^25 pixels: a slide tile is far smaller, and a
  // corrupt SIZ must not ask for gigabytes
  need(s.x1 - s.x0 <= (1 << 20) && s.y1 - s.y0 <= (1 << 20) &&
       (s.x1 - s.x0) * (s.y1 - s.y0) <= (int64_t(1) << 25));
  const int64_t ntx = ceil_div(s.x1 - s.tx0, s.tw), nty = ceil_div(s.y1 - s.ty0, s.th);
  need(ntx * nty <= 65535);
  s.ntx = int(ntx);
  s.nty = int(nty);
  return s;
}

// --- tier-2 -------------------------------------------------------------------

// Packet-header bits: MSB first, 7 bits after a 0xFF byte (opj_bio).
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    need(p < end, E_TRUNCATED);
    buf |= *p++;
  }
  int bit() {
    if (ct == 0) bytein();
    --ct;
    return int(buf >> ct) & 1;
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    while (n--) v = v << 1 | uint32_t(bit());
    return v;
  }
  void align() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
};

struct TagTree {
  std::vector<int> value, low, parent;
  void init(int w, int h) {
    int n = 0;
    std::vector<int> start;
    std::vector<std::pair<int, int>> dims;
    for (int lw = w, lh = h;;) {
      start.push_back(n);
      dims.emplace_back(lw, lh);
      n += lw * lh;
      if (lw * lh <= 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    value.assign(n, INT_MAX);
    low.assign(n, 0);
    parent.assign(n, -1);
    for (size_t l = 0; l + 1 < dims.size(); ++l) {
      const int lw = dims[l].first, pw = dims[l + 1].first;
      for (int j = 0; j < dims[l].second; ++j)
        for (int i = 0; i < lw; ++i)
          parent[start[l] + j * lw + i] = start[l + 1] + (j / 2) * pw + i / 2;
    }
  }
  // Whether the leaf's value is below threshold (opj_tgt_decode).
  bool decode(Bits& b, int leaf, int threshold) {
    int stack[40], depth = 0;
    for (int node = leaf; node >= 0; node = parent[node]) stack[depth++] = node;
    int lo = 0;
    while (depth) {
      const int node = stack[--depth];
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (b.bit()) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
    }
    return value[leaf] < threshold;
  }
};

struct Block {
  int x0, y0, x1, y1;  // band coordinates
  bool included = false;
  int numbps = 0, lblock = 3, passes = 0;
  std::vector<uint8_t> data;
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Block> blocks;
  TagTree incl, imsb;
};

struct Band {
  int orient;  // 0 LL, 1 HL, 2 LH, 3 HH (OpenJPEG's bandno)
  int64_t x0, y0, x1, y1;
  int mb;       // Mb: expn + guard bits - 1
  float step;   // the 9/7's quantisation step
  std::vector<Precinct> precincts;
  bool empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Resolution {
  int64_t x0, y0, x1, y1;
  int ppx, ppy, pw = 0, ph = 0, nbands;
  Band bands[3];
};

struct TileComp {
  int64_t x0, y0, x1, y1;
  Coding cc;
  Quant q;
  std::vector<Resolution> res;
  std::vector<int32_t> idata;  // 5/3 coefficients
  std::vector<float> fdata;    // 9/7 coefficients
};

int getnumpasses(Bits& b) {
  if (!b.bit()) return 1;
  if (!b.bit()) return 2;
  int n = int(b.bits(2));
  if (n != 3) return 3 + n;
  n = int(b.bits(5));
  if (n != 31) return 6 + n;
  return 37 + int(b.bits(7));
}

int floorlog2(int v) {
  int l = 0;
  while (v > 1) v >>= 1, ++l;
  return l;
}

void build_tilecomp(TileComp& tc, int64_t tx0, int64_t ty0, int64_t tx1, int64_t ty1) {
  tc.x0 = tx0; tc.y0 = ty0; tc.x1 = tx1; tc.y1 = ty1;
  const int nl = tc.cc.levels;
  tc.res.resize(nl + 1);
  for (int r = 0; r <= nl; ++r) {
    Resolution& R = tc.res[r];
    const int lv = nl - r;
    R.x0 = ceil_pow2(tx0, lv); R.y0 = ceil_pow2(ty0, lv);
    R.x1 = ceil_pow2(tx1, lv); R.y1 = ceil_pow2(ty1, lv);
    R.ppx = tc.cc.ppx[r];
    R.ppy = tc.cc.ppy[r];
    const int64_t px0 = floor_pow2(R.x0, R.ppx) << R.ppx;
    const int64_t py0 = floor_pow2(R.y0, R.ppy) << R.ppy;
    const int64_t px1 = ceil_pow2(R.x1, R.ppx) << R.ppx;
    const int64_t py1 = ceil_pow2(R.y1, R.ppy) << R.ppy;
    R.pw = R.x0 == R.x1 ? 0 : int((px1 - px0) >> R.ppx);
    R.ph = R.y0 == R.y1 ? 0 : int((py1 - py0) >> R.ppy);
    need(int64_t(R.pw) * R.ph <= (1 << 20));
    int64_t cbgx0, cbgy0;
    int cbgw, cbgh;
    if (r == 0) {
      cbgx0 = px0; cbgy0 = py0; cbgw = R.ppx; cbgh = R.ppy;
      R.nbands = 1;
    } else {
      cbgx0 = ceil_pow2(px0, 1); cbgy0 = ceil_pow2(py0, 1);
      cbgw = R.ppx - 1; cbgh = R.ppy - 1;
      R.nbands = 3;
    }
    const int cbw = std::min(tc.cc.cbw, cbgw), cbh = std::min(tc.cc.cbh, cbgh);
    for (int b = 0; b < R.nbands; ++b) {
      Band& B = R.bands[b];
      B.orient = r == 0 ? 0 : b + 1;
      if (r == 0) {
        B.x0 = R.x0; B.y0 = R.y0; B.x1 = R.x1; B.y1 = R.y1;
      } else {
        const int64_t xob = B.orient & 1, yob = B.orient >> 1;
        B.x0 = ceil_pow2(tx0 - (xob << lv), lv + 1);
        B.y0 = ceil_pow2(ty0 - (yob << lv), lv + 1);
        B.x1 = ceil_pow2(tx1 - (xob << lv), lv + 1);
        B.y1 = ceil_pow2(ty1 - (yob << lv), lv + 1);
      }
      // quantisation: band index 0 (LL) or 3 (r - 1) + b + 1
      const int bi = r == 0 ? 0 : 3 * (r - 1) + b + 1;
      int expn, mant;
      if (tc.q.style == 1) {  // derived from the LL band's (E-5)
        expn = bi == 0 ? tc.q.expn[0] : std::max(0, tc.q.expn[0] - (bi - 1) / 3);
        mant = tc.q.mant[0];
      } else {
        need(bi < tc.q.n);
        expn = tc.q.expn[bi];
        mant = tc.q.mant[bi];
      }
      B.mb = expn + tc.q.guard - 1;
      need(B.mb <= 30);
      // OpenJPEG's decode step (tcd.c): no band gain for the 9/7, whose
      // high band carries 2/K in the DWT instead
      B.step = float((1.0 + mant / 2048.0) * std::pow(2.0, double(8 - expn)));
      B.precincts.assign(size_t(R.pw) * R.ph, Precinct());
      for (int p = 0; p < R.pw * R.ph; ++p) {
        Precinct& P = B.precincts[p];
        const int64_t gx0 = cbgx0 + int64_t(p % R.pw) * (int64_t(1) << cbgw);
        const int64_t gy0 = cbgy0 + int64_t(p / R.pw) * (int64_t(1) << cbgh);
        const int64_t x0 = std::max(gx0, B.x0), y0 = std::max(gy0, B.y0);
        const int64_t x1 = std::min(gx0 + (int64_t(1) << cbgw), B.x1);
        const int64_t y1 = std::min(gy0 + (int64_t(1) << cbgh), B.y1);
        if (B.empty() || x0 >= x1 || y0 >= y1) continue;
        const int64_t bx0 = floor_pow2(x0, cbw) << cbw, by0 = floor_pow2(y0, cbh) << cbh;
        P.cw = int(((ceil_pow2(x1, cbw) << cbw) - bx0) >> cbw);
        P.ch = int(((ceil_pow2(y1, cbh) << cbh) - by0) >> cbh);
        P.blocks.resize(size_t(P.cw) * P.ch);
        for (int k = 0; k < P.cw * P.ch; ++k) {
          Block& K = P.blocks[k];
          const int64_t kx = bx0 + int64_t(k % P.cw) * (int64_t(1) << cbw);
          const int64_t ky = by0 + int64_t(k / P.cw) * (int64_t(1) << cbh);
          K.x0 = int(std::max(kx, x0)); K.y0 = int(std::max(ky, y0));
          K.x1 = int(std::min(kx + (int64_t(1) << cbw), x1));
          K.y1 = int(std::min(ky + (int64_t(1) << cbh), y1));
        }
        P.incl.init(P.cw, P.ch);
        P.imsb.init(P.cw, P.ch);
      }
    }
  }
}

struct Packet {
  int64_t k0, k1, k2, k3, k4;  // sort key
  int c, r, p, l;
  bool operator<(const Packet& o) const {
    if (k0 != o.k0) return k0 < o.k0;
    if (k1 != o.k1) return k1 < o.k1;
    if (k2 != o.k2) return k2 < o.k2;
    if (k3 != o.k3) return k3 < o.k3;
    return k4 < o.k4;
  }
};

// Every packet of the tile in the order of its progression (B.12): the
// position-driven orders visit a precinct at the first reference-grid
// point of the loops that lies on it (pi.c's conditions).
std::vector<Packet> packet_order(const std::vector<TileComp>& tcs, int order, int layers,
                                 int64_t tx0, int64_t ty0) {
  std::vector<Packet> out;
  for (int c = 0; c < int(tcs.size()); ++c) {
    const TileComp& tc = tcs[c];
    const int nl = tc.cc.levels;
    for (int r = 0; r <= nl; ++r) {
      const Resolution& R = tc.res[r];
      if (R.pw == 0 || R.ph == 0) continue;
      const int lv = nl - r;
      const int64_t fx = floor_pow2(R.x0, R.ppx), fy = floor_pow2(R.y0, R.ppy);
      for (int p = 0; p < R.pw * R.ph; ++p) {
        const int i = p % R.pw, j = p / R.pw;
        int64_t x = (fx + i) << (R.ppx + lv), y = (fy + j) << (R.ppy + lv);
        if (i == 0 && ((R.x0 << lv) & ((int64_t(1) << (R.ppx + lv)) - 1))) x = tx0;
        if (j == 0 && ((R.y0 << lv) & ((int64_t(1) << (R.ppy + lv)) - 1))) y = ty0;
        for (int l = 0; l < layers; ++l) {
          Packet k{0, 0, 0, 0, 0, c, r, p, l};
          switch (order) {
            case 0: k.k0 = l; k.k1 = r; k.k2 = c; k.k3 = p; break;            // LRCP
            case 1: k.k0 = r; k.k1 = l; k.k2 = c; k.k3 = p; break;            // RLCP
            case 2: k.k0 = r; k.k1 = y; k.k2 = x; k.k3 = c; k.k4 = l; break;  // RPCL
            case 3: k.k0 = y; k.k1 = x; k.k2 = c; k.k3 = r; k.k4 = l; break;  // PCRL
            default: k.k0 = c; k.k1 = y; k.k2 = x; k.k3 = r; k.k4 = l; break; // CPRL
          }
          out.push_back(k);
        }
      }
    }
  }
  std::sort(out.begin(), out.end());
  return out;
}

// One packet at p (up to end); returns the byte after it.
const uint8_t* read_packet(const Packet& pk, std::vector<TileComp>& tcs, int scod,
                           const uint8_t* p, const uint8_t* end) {
  if ((scod & 2) && end - p >= 6 && be16(p) == SOP) {
    need(be16(p + 2) == 4);
    p += 6;
  }
  Resolution& R = tcs[pk.c].res[pk.r];
  Bits bits{p, end};
  std::vector<std::pair<Block*, uint32_t>> body;
  if (bits.bit()) {
    for (int b = 0; b < R.nbands; ++b) {
      Band& B = R.bands[b];
      if (B.empty()) continue;
      Precinct& P = B.precincts[pk.p];
      for (int k = 0; k < P.cw * P.ch; ++k) {
        Block& K = P.blocks[k];
        const bool in = K.included ? bits.bit() != 0 : P.incl.decode(bits, k, pk.l + 1);
        if (!in) continue;
        if (!K.included) {
          int i = 0;
          while (!P.imsb.decode(bits, k, i)) {
            ++i;
            need(i <= 64);
          }
          K.numbps = B.mb + 1 - i;
          K.included = true;
        }
        const int passes = getnumpasses(bits);
        int inc = 0;
        while (bits.bit()) need(++inc <= 32);
        K.lblock += inc;
        need(K.lblock + floorlog2(passes) <= 32);
        const uint32_t len = bits.bits(K.lblock + floorlog2(passes));
        K.passes += passes;
        need(K.passes <= 164 * 8);
        body.emplace_back(&K, len);
      }
    }
  }
  bits.align();
  p = bits.p;
  if ((scod & 4) && end - p >= 2 && be16(p) == EPH) p += 2;
  for (auto& [K, len] : body) {
    need(uint64_t(end - p) >= len, E_TRUNCATED);
    K->data.insert(K->data.end(), p, p + len);
    p += len;
  }
  return p;
}

// --- tier-1 -------------------------------------------------------------------

struct QeEntry {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};
constexpr QeEntry QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

enum { CTX_RL = 17, CTX_UNI = 18, NCTX = 19 };

// The MQ decoder (C.3); bytes past the segment read as 0xFF, as OpenJPEG's
// sentinel makes them.
struct MQ {
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t a, c;
  int ct;
  uint8_t state[NCTX], mps[NCTX];
  uint8_t at(const uint8_t* q) const { return q < end ? *q : 0xFF; }
  void bytein() {
    if (at(bp) == 0xFF) {
      if (at(bp + 1) > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(at(bp)) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(at(bp)) << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* data, size_t n) {
    bp = data;
    end = data + n;
    c = uint32_t(at(bp)) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
    std::memset(state, 0, sizeof state);
    std::memset(mps, 0, sizeof mps);
    state[0] = 4;
    state[CTX_RL] = 3;
    state[CTX_UNI] = 46;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while ((a & 0x8000) == 0);
  }
  int decode(int cx) {
    const QeEntry& q = QE[state[cx]];
    int d;
    a -= q.qe;
    if ((c >> 16) < q.qe) {
      if (a < q.qe) {
        d = mps[cx];
        state[cx] = q.nmps;
      } else {
        d = 1 - mps[cx];
        if (q.sw) mps[cx] ^= 1;
        state[cx] = q.nlps;
      }
      a = q.qe;
      renorm();
    } else {
      c -= uint32_t(q.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < q.qe) {
          d = 1 - mps[cx];
          if (q.sw) mps[cx] ^= 1;
          state[cx] = q.nlps;
        } else {
          d = mps[cx];
          state[cx] = q.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// Per-sample flags: the significance of the 8 neighbours, the signs of the
// 4 direct ones, and the sample's own state.
enum : uint16_t {
  F_N = 1, F_S = 2, F_W = 4, F_E = 8, F_NW = 16, F_NE = 32, F_SW = 64, F_SE = 128,
  F_NNEG = 256, F_SNEG = 512, F_WNEG = 1024, F_ENEG = 2048,
  F_SIG = 4096, F_VISIT = 8192, F_REFINED = 16384, F_NEG = 32768,
};

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc_ctx[256], sc_xor[256];
  Luts() {
    for (int orient = 0; orient < 4; ++orient)
      for (int f = 0; f < 256; ++f) {
        int h = !!(f & F_W) + !!(f & F_E), v = !!(f & F_N) + !!(f & F_S);
        const int d = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
        int n;
        if (orient == 3) {
          const int hv = h + v;
          if (d == 0) n = hv == 0 ? 0 : hv == 1 ? 1 : 2;
          else if (d == 1) n = hv == 0 ? 3 : hv == 1 ? 4 : 5;
          else if (d == 2) n = hv == 0 ? 6 : 7;
          else n = 8;
        } else {
          if (orient == 1) std::swap(h, v);  // HL: vertical neighbours lead
          if (h == 0) n = v == 0 ? (d == 0 ? 0 : d == 1 ? 1 : 2) : v == 1 ? 3 : 4;
          else if (h == 1) n = v == 0 ? (d == 0 ? 5 : 6) : 7;
          else n = 8;
        }
        zc[orient][f] = uint8_t(n);
      }
    for (int i = 0; i < 256; ++i) {
      // i: significance of N, S, W, E (bits 0-3), their signs (bits 4-7)
      auto contrib = [&](int sig_bit, int neg_bit) {
        return (i & sig_bit) ? ((i & neg_bit) ? -1 : 1) : 0;
      };
      const int hc = std::clamp(contrib(4, 64) + contrib(8, 128), -1, 1);
      const int vc = std::clamp(contrib(1, 16) + contrib(2, 32), -1, 1);
      int ctx, x;
      if (hc == 0) ctx = vc == 0 ? 9 : 10, x = vc < 0;
      else ctx = vc == 0 ? 12 : hc == vc ? 13 : 11, x = hc < 0;
      sc_ctx[i] = uint8_t(ctx);
      sc_xor[i] = uint8_t(x);
    }
  }
};
const Luts LUT;

struct T1 {
  std::vector<uint16_t> flags;
  std::vector<int32_t> data;
  int w, h, fs;
  MQ mq;

  uint16_t* F(int x, int y) { return &flags[size_t(y + 1) * fs + x + 1]; }
  void set_sig(uint16_t* f, bool neg) {
    *f |= F_SIG | (neg ? F_NEG : 0);
    f[-fs] |= F_S | (neg ? F_SNEG : 0);
    f[fs] |= F_N | (neg ? F_NNEG : 0);
    f[-1] |= F_E | (neg ? F_ENEG : 0);
    f[1] |= F_W | (neg ? F_WNEG : 0);
    f[-fs - 1] |= F_SE;
    f[-fs + 1] |= F_SW;
    f[fs - 1] |= F_NE;
    f[fs + 1] |= F_NW;
  }
  int sign(uint16_t f) {
    const int i = (f & 0xF) | ((f >> 4) & 0xF0);
    return mq.decode(LUT.sc_ctx[i]) ^ LUT.sc_xor[i];
  }
  void sigpass(int bpno, int orient) {
    const int32_t oph = (1 << bpno) | ((1 << bpno) >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint16_t* f = F(x, y);
          if ((*f & (F_SIG | F_VISIT)) || !(*f & 0xFF)) continue;
          if (mq.decode(LUT.zc[orient][*f & 0xFF])) {
            const int neg = sign(*f);
            data[size_t(y) * w + x] = neg ? -oph : oph;
            set_sig(f, neg);
          }
          *f |= F_VISIT;
        }
  }
  void refpass(int bpno) {
    const int32_t half = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint16_t* f = F(x, y);
          if ((*f & (F_SIG | F_VISIT)) != F_SIG) continue;
          const int ctx = (*f & F_REFINED) ? 16 : (*f & 0xFF) ? 15 : 14;
          const int v = mq.decode(ctx);
          int32_t& d = data[size_t(y) * w + x];
          d += (v ^ (d < 0)) ? half : -half;
          *f |= F_REFINED;
        }
  }
  void clnpass(int bpno, int orient) {
    const int32_t oph = (1 << bpno) | ((1 << bpno) >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y = k;
        const int y1 = std::min(k + 4, h);
        if (k + 3 < h) {
          bool run = true;
          for (int i = 0; i < 4 && run; ++i)
            run = (*F(x, k + i) & (F_SIG | F_VISIT | 0xFF)) == 0;
          if (run) {
            if (!mq.decode(CTX_RL)) continue;
            int r = mq.decode(CTX_UNI) << 1;
            r |= mq.decode(CTX_UNI);
            y = k + r;
            uint16_t* f = F(x, y);
            const int neg = sign(*f);
            data[size_t(y) * w + x] = neg ? -oph : oph;
            set_sig(f, neg);
            ++y;
          }
        }
        for (; y < y1; ++y) {
          uint16_t* f = F(x, y);
          if (!(*f & (F_SIG | F_VISIT)) && mq.decode(LUT.zc[orient][*f & 0xFF])) {
            const int neg = sign(*f);
            data[size_t(y) * w + x] = neg ? -oph : oph;
            set_sig(f, neg);
          }
        }
        for (int yy = k; yy < y1; ++yy) *F(x, yy) &= uint16_t(~F_VISIT);
      }
  }
  // Decode a code-block's passes into data (w x h, scaled by 2).
  void decode(const Block& K, int orient) {
    w = K.x1 - K.x0;
    h = K.y1 - K.y0;
    fs = w + 2;
    flags.assign(size_t(fs) * (h + 2), 0);
    data.assign(size_t(w) * h, 0);
    need(K.numbps < 31);
    mq.init(K.data.data(), K.data.size());
    int bpno = K.numbps, type = 2;
    for (int pass = 0; pass < K.passes && bpno >= 1; ++pass) {
      if (type == 0) sigpass(bpno, orient);
      else if (type == 1) refpass(bpno);
      else clnpass(bpno, orient);
      if (++type == 3) type = 0, --bpno;
    }
  }
};

// --- inverse DWT ----------------------------------------------------------------

// One 5/3 line: a holds sn low then dn high samples at stride s; cas is the
// parity of the line's first coordinate.
void idwt53_line(int32_t* a, size_t s, int sn, int dn, int cas, std::vector<int32_t>& x) {
  const int n = sn + dn;
  if (n == 1) {
    if (cas) a[0] /= 2;
    return;
  }
  x.resize(n);
  for (int i = 0; i < sn; ++i) x[cas + 2 * i] = a[i * s];
  for (int i = 0; i < dn; ++i) x[1 - cas + 2 * i] = a[(sn + i) * s];
  auto at = [&](int i) { return x[i < 0 ? -i : i >= n ? 2 * (n - 1) - i : i]; };
  for (int i = cas; i < n; i += 2) x[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int i = 1 - cas; i < n; i += 2) x[i] += (at(i - 1) + at(i + 1)) >> 1;
  for (int i = 0; i < n; ++i) a[i * s] = x[i];
}

constexpr float K97 = 1.230174105f;
constexpr float TWO_INV_K97 = 1.625732422f;
// the standard's lifting constants (F.3.8.2), as OpenJPEG 2.5 holds them
constexpr float ALPHA = -1.586134342f, BETA = -0.052980118f, GAMMA = 0.882911075f,
                DELTA = 0.443506852f;

// opj_v8dwt_decode_step2 on one line: w[-1] += (l[0] + w[0]) * c over the
// window, the last term doubled when its right neighbour is missing.
void step2(float* l, float* w, int end, int m, float c) {
  const int imax = std::min(end, m);
  for (int i = 0; i < imax; ++i) {
    w[-1] += (l[0] + w[0]) * c;
    l = w;
    w += 2;
  }
  if (m < end) w[-1] += l[0] * (c + c);
}

void idwt97_line(float* a, size_t s, int sn, int dn, int cas, std::vector<float>& x) {
  const int n = sn + dn;
  int lo, hi;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    lo = 0, hi = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    lo = 1, hi = 0;
  }
  x.assign(n + 2, 0.f);
  float* w = x.data();
  for (int i = 0; i < sn; ++i) w[lo + 2 * i] = a[i * s];
  for (int i = 0; i < dn; ++i) w[hi + 2 * i] = a[(sn + i) * s];
  for (int i = 0; i < sn; ++i) w[lo + 2 * i] *= K97;
  for (int i = 0; i < dn; ++i) w[hi + 2 * i] *= TWO_INV_K97;
  const int ml = std::min(sn, dn - lo), mh = std::min(dn, sn - hi);
  step2(w + hi, w + lo + 1, sn, ml, -DELTA);
  step2(w + lo, w + hi + 1, dn, mh, -GAMMA);
  step2(w + hi, w + lo + 1, sn, ml, -BETA);
  step2(w + lo, w + hi + 1, dn, mh, -ALPHA);
  for (int i = 0; i < n; ++i) a[i * s] = w[i];
}

template <class T, class Line, class Tmp>
void idwt(T* d, const TileComp& tc, Line line, Tmp& tmp) {
  const size_t stride = size_t(tc.x1 - tc.x0);
  for (size_t r = 1; r < tc.res.size(); ++r) {
    const Resolution &P = tc.res[r - 1], &R = tc.res[r];
    const int rw = int(R.x1 - R.x0), rh = int(R.y1 - R.y0);
    const int snh = int(P.x1 - P.x0), snv = int(P.y1 - P.y0);
    if (rw == 0 || rh == 0) continue;
    for (int j = 0; j < rh; ++j) line(d + j * stride, 1, snh, rw - snh, int(R.x0 & 1), tmp);
    for (int i = 0; i < rw; ++i) line(d + i, stride, snv, rh - snv, int(R.y0 & 1), tmp);
  }
}

// --- Pillow's YCbCr -> RGB --------------------------------------------------------

struct YccTables {
  int16_t r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      r_cr[i] = int16_t(int(1.40200 * (i - 128) * 64 + 0.5));
      g_cb[i] = int16_t(int(-0.34414 * (i - 128) * 64 + 0.5));
      g_cr[i] = int16_t(int(-0.71414 * (i - 128) * 64 + 0.5));
      b_cb[i] = int16_t(int(1.77200 * (i - 128) * 64 + 0.5));
    }
  }
};
const YccTables YCC;

inline uint8_t clamp8(int v) { return uint8_t(v <= 0 ? 0 : v >= 255 ? 255 : v); }

// --- the codestream -----------------------------------------------------------------

struct TilePart {
  const uint8_t* data;
  size_t n;
};

struct Codestream {
  Siz siz;
  Scope main;
  std::vector<Scope> tiles;
  std::vector<std::vector<TilePart>> parts;
};

// Parse SOC, SIZ and the main header; returns the first SOT.
const uint8_t* parse_main(const uint8_t* data, size_t n, Codestream& cs) {
  const uint8_t* p = data;
  const uint8_t* end = data + n;
  need(n >= 4, E_TRUNCATED);
  need(be16(p) == SOC && be16(p + 2) == SIZ);
  p += 4;
  need(end - p >= 2, E_TRUNCATED);
  int len = be16(p);
  need(len >= 2);
  need(end - p >= len, E_TRUNCATED);
  cs.siz = parse_siz(p + 2, len - 2);
  p += len;
  for (;;) {
    need(end - p >= 4, E_TRUNCATED);
    const uint16_t marker = be16(p);
    if (marker == SOT) break;
    need((marker >> 8) == 0xFF);
    len = be16(p + 2);
    need(len >= 2);
    need(end - p - 2 >= len, E_TRUNCATED);
    parse_segment(marker, p + 4, len - 2, cs.siz, cs.main);
    p += 2 + len;
  }
  need(cs.main.has_cod && cs.main.has_qcd);
  return p;
}

void parse_tiles(const uint8_t* p, const uint8_t* end, Codestream& cs) {
  const int ntiles = cs.siz.ntx * cs.siz.nty;
  cs.tiles.assign(ntiles, Scope());
  cs.parts.assign(ntiles, {});
  for (;;) {
    need(end - p >= 2, E_TRUNCATED);
    const uint16_t marker = be16(p);
    if (marker == EOC) return;
    need(marker == SOT);
    need(end - p >= 12, E_TRUNCATED);
    need(be16(p + 2) == 10);
    const int tile = be16(p + 4);
    const uint32_t psot = be32(p + 6);
    need(tile < ntiles);
    const uint8_t* tp_end;
    if (psot == 0) {
      need(end - p >= 14 && be16(end - 2) == EOC, E_TRUNCATED);
      tp_end = end - 2;
    } else {
      need(psot >= 14);
      need(uint64_t(end - p) >= psot, E_TRUNCATED);
      tp_end = p + psot;
    }
    const uint8_t* q = p + 12;
    for (;;) {
      need(tp_end - q >= 2, E_TRUNCATED);
      const uint16_t m = be16(q);
      if (m == SOD) {
        q += 2;
        break;
      }
      need((m >> 8) == 0xFF && tp_end - q >= 4, E_TRUNCATED);
      const int len = be16(q + 2);
      need(len >= 2);
      need(tp_end - q - 2 >= len, E_TRUNCATED);
      parse_segment(m, q + 4, len - 2, cs.siz, cs.tiles[tile]);
      q += 2 + len;
    }
    cs.parts[tile].push_back({q, size_t(tp_end - q)});
    p = tp_end;
  }
}

// Decode tile t and write it into out (RGB, out_w x out_h, image origin).
void decode_tile(const Codestream& cs, int t, bool ycbcr, uint8_t* out, int out_w,
                 int out_h) {
  const Siz& siz = cs.siz;
  const Scope& ts = cs.tiles[t];
  const Scope& ms = cs.main;
  const Scope& cod = ts.has_cod ? ts : ms;
  const int p = t % siz.ntx, q = t / siz.ntx;
  const int64_t tx0 = std::max(siz.tx0 + p * siz.tw, siz.x0);
  const int64_t ty0 = std::max(siz.ty0 + q * siz.th, siz.y0);
  const int64_t tx1 = std::min(siz.tx0 + (p + 1) * siz.tw, siz.x1);
  const int64_t ty1 = std::min(siz.ty0 + (q + 1) * siz.th, siz.y1);
  const int nc = siz.ncomp;
  std::vector<TileComp> tcs(nc);
  for (int c = 0; c < nc; ++c) {
    TileComp& tc = tcs[c];
    tc.cc = ts.has_coc[c] ? ts.coc[c] : ts.has_cod ? ts.cod : ms.has_coc[c] ? ms.coc[c] : ms.cod;
    tc.q = ts.has_qcc[c] ? ts.qcc[c] : ts.has_qcd ? ts.qcd : ms.has_qcc[c] ? ms.qcc[c] : ms.qcd;
    build_tilecomp(tc, tx0, ty0, tx1, ty1);
  }
  // the tile's packets, over the concatenation of its tile-parts' bodies
  std::vector<uint8_t> body;
  for (const TilePart& tp : cs.parts[t]) body.insert(body.end(), tp.data, tp.data + tp.n);
  const uint8_t* pp = body.data();
  const uint8_t* pend = pp + body.size();
  for (const Packet& pk : packet_order(tcs, cod.order, cod.layers, tx0, ty0))
    pp = read_packet(pk, tcs, cod.scod, pp, pend);

  const int64_t w = tx1 - tx0, h = ty1 - ty0;
  T1 t1;
  std::vector<int32_t> itmp;
  std::vector<float> ftmp;
  for (TileComp& tc : tcs) {
    const bool rev = tc.cc.reversible;
    if (rev) tc.idata.assign(size_t(w * h), 0);
    else tc.fdata.assign(size_t(w * h), 0.f);
    for (size_t r = 0; r < tc.res.size(); ++r) {
      const Resolution& R = tc.res[r];
      for (int b = 0; b < R.nbands; ++b) {
        const Band& B = R.bands[b];
        int64_t ox = 0, oy = 0;
        if (B.orient & 1) ox = tc.res[r - 1].x1 - tc.res[r - 1].x0;
        if (B.orient & 2) oy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
        const float half_step = 0.5f * B.step;
        for (const Precinct& P : B.precincts)
          for (const Block& K : P.blocks) {
            if (!K.included || K.passes == 0) continue;
            t1.decode(K, B.orient);
            const int64_t x = K.x0 - B.x0 + ox, y = K.y0 - B.y0 + oy;
            for (int j = 0; j < t1.h; ++j) {
              const int32_t* src = &t1.data[size_t(j) * t1.w];
              const size_t row = size_t((y + j) * w + x);
              if (rev)
                for (int i = 0; i < t1.w; ++i) tc.idata[row + i] = src[i] / 2;
              else
                for (int i = 0; i < t1.w; ++i) tc.fdata[row + i] = float(src[i]) * half_step;
            }
          }
      }
    }
    if (rev) idwt(tc.idata.data(), tc, idwt53_line, itmp);
    else idwt(tc.fdata.data(), tc, idwt97_line, ftmp);
  }
  const size_t npx = size_t(w * h);
  if (cod.mct && nc >= 3) {
    if (tcs[0].cc.reversible) {
      int32_t *c0 = tcs[0].idata.data(), *c1 = tcs[1].idata.data(), *c2 = tcs[2].idata.data();
      need(tcs[1].cc.reversible && tcs[2].cc.reversible);
      for (size_t i = 0; i < npx; ++i) {
        const int32_t y = c0[i], u = c1[i], v = c2[i];
        const int32_t g = y - ((u + v) >> 2);
        c0[i] = v + g;
        c1[i] = g;
        c2[i] = u + g;
      }
    } else {
      need(!tcs[1].cc.reversible && !tcs[2].cc.reversible);
      float *c0 = tcs[0].fdata.data(), *c1 = tcs[1].fdata.data(), *c2 = tcs[2].fdata.data();
      // mct.c's ICT constants and order (not Pillow's 0.34414)
      for (size_t i = 0; i < npx; ++i) {
        const float y = c0[i], u = c1[i], v = c2[i];
        const float r = y + (v * 1.402f);
        const float g = y - (u * 0.34413f) - (v * 0.71414f);
        const float b = y + (u * 1.772f);
        c0[i] = r;
        c1[i] = g;
        c2[i] = b;
      }
    }
  }
  // DC level shift and clamp to 8-bit samples
  std::vector<uint8_t> planes(size_t(nc) * npx);
  for (int c = 0; c < nc; ++c) {
    uint8_t* o = &planes[size_t(c) * npx];
    if (tcs[c].cc.reversible) {
      const int32_t* d = tcs[c].idata.data();
      for (size_t i = 0; i < npx; ++i)
        o[i] = uint8_t(std::clamp<int64_t>(int64_t(d[i]) + 128, 0, 255));
    } else {
      const float* d = tcs[c].fdata.data();
      for (size_t i = 0; i < npx; ++i) {
        const float v = d[i];
        int64_t k;
        if (v > float(INT_MAX)) k = 255;
        else if (v < float(INT_MIN)) k = 0;
        else k = int64_t(lrintf(v)) + 128;
        o[i] = uint8_t(std::clamp<int64_t>(k, 0, 255));
      }
    }
  }
  // into the output, Pillow's way
  const int64_t ox = tx0 - siz.x0, oy = ty0 - siz.y0;
  const uint8_t* c0 = planes.data();
  const uint8_t* c1 = nc >= 3 ? c0 + npx : c0;
  const uint8_t* c2 = nc >= 3 ? c0 + 2 * npx : c0;
  const bool ycc = ycbcr && nc == 3;
  for (int64_t j = 0; j < h && oy + j < out_h; ++j)
    for (int64_t i = 0; i < w && ox + i < out_w; ++i) {
      const size_t s = size_t(j * w + i);
      uint8_t* o = out + (size_t(oy + j) * out_w + size_t(ox + i)) * 3;
      if (ycc) {
        const int y = c0[s], cb = c1[s], cr = c2[s];
        o[0] = clamp8(y + (YCC.r_cr[cr] >> 6));
        o[1] = clamp8(y + ((YCC.g_cb[cb] + YCC.g_cr[cr]) >> 6));
        o[2] = clamp8(y + (YCC.b_cb[cb] >> 6));
      } else {
        o[0] = c0[s];
        o[1] = c1[s];
        o[2] = c2[s];
      }
    }
}

}  // namespace

int info(const uint8_t* data, size_t n, int* width, int* height, int* ncomp) {
  try {
    Codestream cs;
    parse_main(data, n, cs);
    *width = int(cs.siz.x1 - cs.siz.x0);
    *height = int(cs.siz.y1 - cs.siz.y0);
    *ncomp = cs.siz.ncomp;
    return OK;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return E_CORRUPT;
  }
}

int decode_rgb(const uint8_t* data, size_t n, bool ycbcr, uint8_t* out, int out_w,
               int out_h) {
  try {
    Codestream cs;
    const uint8_t* p = parse_main(data, n, cs);
    parse_tiles(p, data + n, cs);
    for (int t = 0; t < cs.siz.ntx * cs.siz.nty; ++t)
      decode_tile(cs, t, ycbcr, out, out_w, out_h);
    return OK;
  } catch (const Fail& f) {
    return f.code;
  } catch (const std::bad_alloc&) {
    return E_CORRUPT;
  }
}

}  // namespace j2k

extern "C" {

// A codestream's image: width, height and components; 0 or an error code.
int j2k_info(const uint8_t* data, int64_t n, int* width, int* height, int* ncomp) {
  return j2k::info(data, size_t(n), width, height, ncomp);
}

// Decode a whole codestream into out (height x width x 3 RGB, as j2k_info
// gave them); ycbcr: the components are Y, Cb, Cr (TIFF compression 33003).
int j2k_decode(const uint8_t* data, int64_t n, int ycbcr, uint8_t* out, int width,
               int height) {
  return j2k::decode_rgb(data, size_t(n), ycbcr != 0, out, width, height);
}

}  // extern "C"
