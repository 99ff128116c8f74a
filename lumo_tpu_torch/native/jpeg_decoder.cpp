// JPEG decoder of the port's host I/O (lumo_tpu_torch/io/image.py).
//
// The JAX package reads textures through PIL, which decodes JPEG with
// libjpeg-turbo at its defaults; this decoder gives the same pixels, so it
// follows libjpeg's integer pipeline step for step:
//   - Huffman entropy decoding of sequential (SOF0, SOF1) and progressive
//     (SOF2: spectral selection and successive approximation, DC and AC,
//     first and refinement scans) 8-bit frames, with restart intervals
//     (jdhuff.c, jdphuff.c);
//   - the "islow" integer IDCT (jidctint.c: CONST_BITS 13, PASS1_BITS 2,
//     the post-IDCT range-limit table of jdmaster.c);
//   - fancy upsampling (jdsample.c: the h2v1, h1v2 and h2v2 triangle
//     filters with their rounding biases, edges replicated as jdmainct.c
//     provides its context rows);
//   - YCbCr -> RGB through the fixed-point tables of jdcolor.c
//     (SCALEBITS 16); RGB frames (Adobe transform 0, or component ids
//     'R', 'G', 'B' without a JFIF marker) are copied.
// One or three components, sampling factors 1 or 2.  Anything else (12-bit
// samples, arithmetic coding, lossless, hierarchical, CMYK/YCCK) is
// refused with a message naming it.  Corrupt data is decoded as libjpeg
// would where that is cheap (zeros past a marker, bad codes as 0).
//
// C interface (ctypes): lumo_jpeg_header gives width, height and
// components; lumo_jpeg_decode writes height x width x components bytes.
// Each returns 0, or 1 with a message in err.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zig-zag position -> natural (row-major) position, with 16 spare entries
// for corrupt run lengths (jutils.c jpeg_natural_order)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huff {
  bool defined = false;
  int max_val = 0;  // a DC table's symbols are bit counts of at most 15
  int32_t maxcode[18];
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t vals[256];
  uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer)
  uint8_t look_sym[512];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc = 0, ac = 0;          // table selectors of the current scan
  int dw = 0, dh = 0;          // samples (downsampled_width / height)
  int bw = 0, bh = 0;          // blocks that cover them
  int bw_pad = 0, bh_pad = 0;  // blocks of the MCU grid
  bool latched = false;        // quant table copied at its first scan
  int16_t qt[64];
  int pred = 0;
  std::vector<int16_t> coef;   // bh_pad * bw_pad blocks of 64, natural order
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bw_pad + bx) * 64;
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t n) : d_(data), n_(n) {}

  void header() { parse(true); }

  void decode(uint8_t* out) {
    parse(false);
    output(out);
  }

  int width = 0, height = 0, ncomp = 0;

 private:
  const uint8_t* d_;
  size_t n_;
  size_t pos_ = 0;
  bool frame_ = false, progressive_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_interval_ = 0;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huff dc_[4], ac_[4];
  std::vector<Component> comp_;
  // bit reader of the entropy-coded data
  uint64_t acc_ = 0;
  int nbits_ = 0;
  int pad_ = 0;  // zero bits appended past a marker, the low ones of acc_
  bool at_marker_ = false, insufficient_ = false;
  int eobrun_ = 0;

  uint8_t byte() {
    if (pos_ >= n_) throw Error("truncated JPEG");
    return d_[pos_++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  // The next marker code: skips anything up to an 0xFF and its fill bytes.
  int next_marker() {
    for (;;) {
      while (pos_ < n_ && d_[pos_] != 0xFF) pos_++;
      while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
      if (pos_ >= n_) return -1;
      int m = d_[pos_++];
      if (m != 0) return m;
    }
  }

  void parse(bool header_only) {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) throw Error("not a JPEG image");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m < 0 || m == 0xD9) {  // end of data or EOI
        if (!frame_) throw Error("JPEG without a frame (no SOF marker)");
        return;
      }
      if (m >= 0xD0 && m <= 0xD8) continue;  // stray RSTn, SOI
      if (m == 0x01) continue;               // TEM
      size_t start = pos_;
      int len = u16();
      if (len < 2 || start + len > n_) throw Error("truncated JPEG segment");
      size_t end = start + len;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          sof(m);
          if (header_only) return;
          break;
        case 0xC3:
          throw Error("lossless JPEG (SOF3) is not supported");
        case 0xC5: case 0xC6: case 0xC7: case 0xDE: case 0xDF:
          throw Error("hierarchical JPEG (SOF5-SOF7, DHP, EXP) is not supported");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
          throw Error("arithmetic-coded JPEG (SOF9-SOF15, DAC) is not supported");
        case 0xC4: dht(end); break;
        case 0xDB: dqt(end); break;
        case 0xDD: restart_interval_ = u16(); break;
        case 0xE0:
          if (len >= 7 && std::memcmp(d_ + pos_, "JFIF\0", 5) == 0) jfif_ = true;
          break;
        case 0xEE:
          if (len >= 14 && std::memcmp(d_ + pos_, "Adobe", 5) == 0) {
            adobe_ = true;
            adobe_transform_ = d_[pos_ + 11];
          }
          break;
        case 0xDA:
          if (!frame_) throw Error("JPEG scan before its frame");
          sos();
          continue;  // pos_ is past the scan's data
        default: break;
      }
      pos_ = end;
    }
  }

  void sof(int m) {
    if (frame_) throw Error("JPEG with more than one frame");
    int precision = byte();
    if (precision != 8)
      throw Error(std::to_string(precision) + "-bit JPEG is not supported (8-bit samples only)");
    height = u16();
    width = u16();
    ncomp = byte();
    if (width == 0 || height == 0) throw Error("JPEG with a zero width or height (DNL) is not supported");
    if (ncomp == 4) throw Error("4-component (CMYK/YCCK) JPEG is not supported");
    if (ncomp != 1 && ncomp != 3)
      throw Error("JPEG with " + std::to_string(ncomp) + " components is not supported");
    progressive_ = m == 0xC2;
    comp_.resize(ncomp);
    for (auto& c : comp_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte() & 3;
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2)
        throw Error("JPEG sampling factors " + std::to_string(c.h) + "x" + std::to_string(c.v) +
                    " are not supported (1 or 2 only)");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (auto& c : comp_) {
      c.dw = static_cast<int>((static_cast<int64_t>(width) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<int64_t>(height) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bw_pad = mcux_ * c.h;
      c.bh_pad = mcuy_ * c.v;
    }
    frame_ = true;
  }

  void dht(size_t end) {
    while (pos_ < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw Error("bad JPEG Huffman table id");
      Huff& t = tc ? ac_[th] : dc_[th];
      int bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; l++) total += bits[l] = byte();
      if (total > 256) throw Error("bad JPEG Huffman table");
      t.max_val = 0;
      for (int i = 0; i < total; i++) t.max_val = std::max<int>(t.max_val, t.vals[i] = byte());
      int code = 0, k = 0;
      for (int l = 1; l <= 16; l++) {
        t.valptr[l] = k;
        t.mincode[l] = code;
        code += bits[l];
        k += bits[l];
        // no code may be all ones (jdhuff.c jpeg_make_d_derived_tbl)
        if (code >= (1 << l)) throw Error("bad JPEG Huffman table");
        t.maxcode[l] = bits[l] ? code - 1 : -1;
        code <<= 1;
      }
      t.maxcode[17] = 0x7FFFFFFF;
      std::memset(t.look_len, 0, sizeof t.look_len);
      for (int l = 1; l <= 9; l++)
        for (int i = 0; i < bits[l]; i++) {
          int c = t.mincode[l] + i;
          for (int fill = 0; fill < (1 << (9 - l)); fill++) {
            int look = (c << (9 - l)) | fill;
            t.look_len[look] = static_cast<uint8_t>(l);
            t.look_sym[look] = t.vals[t.valptr[l] + i];
          }
        }
      t.defined = true;
    }
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3) throw Error("bad JPEG quantization table id");
      for (int k = 0; k < 64; k++)
        qt_[tq][kNatural[k]] = static_cast<uint16_t>(pq ? u16() : byte());
      qt_defined_[tq] = true;
    }
  }

  // ---- bit reader -------------------------------------------------------
  void fill() {
    while (nbits_ <= 56) {
      uint8_t b = 0;
      if (!at_marker_) {
        if (pos_ >= n_) {
          at_marker_ = true;
        } else if (d_[pos_] == 0xFF) {
          size_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) q++;  // fill bytes
          if (q < n_ && d_[q] == 0x00) {
            b = 0xFF;
            pos_ = q + 1;
          } else {
            at_marker_ = true;  // a marker: zeros from here (jdhuff.c)
          }
        } else {
          b = d_[pos_++];
        }
      }
      if (at_marker_) pad_ += 8;
      acc_ = (acc_ << 8) | b;
      nbits_ += 8;
    }
  }
  // bits read past the marker: libjpeg stops decoding the scan's MCUs
  void consumed() {
    if (nbits_ < pad_) {
      insufficient_ = true;
      pad_ = nbits_;
    }
  }
  int bits(int k) {
    if (k == 0) return 0;
    if (nbits_ < k) fill();
    nbits_ -= k;
    consumed();
    return static_cast<int>((acc_ >> nbits_) & ((1u << k) - 1));
  }
  int bit() { return bits(1); }
  int huff(const Huff& t) {
    if (nbits_ < 16) fill();
    int look = static_cast<int>((acc_ >> (nbits_ - 9)) & 511);
    int l = t.look_len[look];
    if (l) {
      nbits_ -= l;
      consumed();
      return t.look_sym[look];
    }
    int code = bit();
    l = 1;
    while (code > t.maxcode[l]) {
      code = (code << 1) | bit();
      if (++l > 16) return 0;  // a bad code decodes as 0 (JWRN_HUFF_BAD_CODE)
    }
    return t.vals[(t.valptr[l] + code - t.mincode[l]) & 255];
  }
  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + ((-1) * (1 << s)) + 1 : r;
  }

  void restart() {
    nbits_ = 0;
    pad_ = 0;
    acc_ = 0;
    at_marker_ = false;
    size_t save = pos_;
    int m = next_marker();
    if (!(m >= 0xD0 && m <= 0xD7)) pos_ = save;  // not a restart: leave it
    insufficient_ = false;
    eobrun_ = 0;
    for (auto& c : comp_) c.pred = 0;
  }

  // ---- scans -------------------------------------------------------------
  void sos() {
    int ns = byte();
    if (ns < 1 || ns > 4) throw Error("bad JPEG scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = byte(), tables = byte();
      Component* c = nullptr;
      for (auto& x : comp_)
        if (x.id == id) c = &x;
      if (!c) throw Error("JPEG scan names an unknown component");
      c->dc = tables >> 4;
      c->ac = tables & 15;
      if (c->dc > 3 || c->ac > 3) throw Error("bad JPEG Huffman table selector");
      sc.push_back(c);
    }
    int ss = byte(), se = byte(), a = byte();
    int ah = a >> 4, al = a & 15;
    for (Component* c : sc) {
      if (!c->latched) {
        if (!qt_defined_[c->tq]) throw Error("JPEG quantization table not defined");
        for (int k = 0; k < 64; k++) c->qt[k] = static_cast<int16_t>(qt_[c->tq][k]);
        c->latched = true;
      }
      if (c->coef.empty()) c->coef.assign(static_cast<size_t>(c->bw_pad) * c->bh_pad * 64, 0);
      c->pred = 0;
    }
    bool dc_scan = !progressive_ || ss == 0;
    bool ac_scan = !progressive_ || se > 0;
    if (progressive_) {
      if (ss == 0 ? se != 0 : (se < ss || se > 63 || ns != 1))
        throw Error("bad progressive JPEG scan parameters");
    }
    for (Component* c : sc) {
      if (dc_scan && !(progressive_ && ah) &&
          (!dc_[c->dc].defined || dc_[c->dc].max_val > 15))
        throw Error("JPEG DC Huffman table not defined or bad");
      if (ac_scan && !ac_[c->ac].defined) throw Error("JPEG Huffman table not defined");
    }
    acc_ = 0;
    nbits_ = pad_ = 0;
    at_marker_ = false;
    insufficient_ = false;
    eobrun_ = 0;
    int restarts_to_go = restart_interval_;
    auto unit = [&](Component* c, int bx, int by) {
      int16_t* blk = c->block(bx, by);
      if (!progressive_) sequential(c, blk);
      else if (ss == 0) ah ? dc_refine(blk, al) : dc_first(c, blk, al);
      else ah ? ac_refine(c, blk, ss, se, al) : ac_first(c, blk, ss, se, al);
    };
    auto before_mcu = [&]() {
      if (restart_interval_) {
        if (restarts_to_go == 0) {
          restart();
          restarts_to_go = restart_interval_;
        }
        restarts_to_go--;
      }
      return !insufficient_;
    };
    if (ns == 1) {  // non-interleaved: one block an MCU
      Component* c = sc[0];
      for (int by = 0; by < c->bh; by++)
        for (int bx = 0; bx < c->bw; bx++)
          if (before_mcu()) unit(c, bx, by);
    } else {
      for (int my = 0; my < mcuy_; my++)
        for (int mx = 0; mx < mcux_; mx++) {
          if (!before_mcu()) continue;
          for (Component* c : sc)
            for (int y = 0; y < c->v; y++)
              for (int x = 0; x < c->h; x++) unit(c, mx * c->h + x, my * c->v + y);
        }
    }
    // parse() goes on at the next marker after pos_
    acc_ = 0;
    nbits_ = pad_ = 0;
    at_marker_ = false;
  }

  void sequential(Component* c, int16_t* blk) {
    int s = huff(dc_[c->dc]);
    if (s) s = extend(bits(s), s);
    s += c->pred;
    c->pred = s;
    blk[0] = static_cast<int16_t>(s);
    const Huff& t = ac_[c->ac];
    for (int k = 1; k < 64; k++) {
      s = huff(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void dc_first(Component* c, int16_t* blk, int al) {
    int s = huff(dc_[c->dc]);
    if (s) s = extend(bits(s), s);
    s += c->pred;
    c->pred = s;
    blk[0] = static_cast<int16_t>(static_cast<uint32_t>(s) << al);
  }

  void dc_refine(int16_t* blk, int al) {
    if (bit()) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  void ac_first(Component* c, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      eobrun_--;
      return;
    }
    const Huff& t = ac_[c->ac];
    for (int k = ss; k <= se; k++) {
      int s = huff(t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        s = extend(bits(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(static_cast<uint32_t>(s) << al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += bits(r);
          eobrun_--;
          break;
        }
      }
    }
  }

  void ac_refine(Component* c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al;
    const int m1 = -1 * (1 << al);
    const Huff& t = ac_[c->ac];
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (bit() && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    if (eobrun_ == 0) {
      for (; k <= se; k++) {
        int s = huff(t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = bit() ? p1 : m1;  // a new coefficient's size is always 1
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += bits(r);
          break;  // the rest of the block is the EOB run's
        }
        // skip r zero coefficients, correcting the nonzero ones passed
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      eobrun_--;
    }
  }

  // ---- samples -------------------------------------------------------------
  // jidctint.c jpeg_idct_islow into plane (stride w), the range limit of
  // jdmaster.c prepare_range_limit_table: idct_limit[x & 1023]
  static void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride,
                         const uint8_t* limit) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int col = 0; col < 8; col++) {
      const int16_t* ip = in + col;
      const int16_t* qp = q + col;
      int* wp = ws + col;
      auto deq = [&](int r) { return static_cast<int64_t>(static_cast<int>(ip[8 * r]) * static_cast<int>(qp[8 * r])); };
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
          ip[48] == 0 && ip[56] == 0) {
        int dc = static_cast<int>(deq(0) * 4);
        for (int r = 0; r < 8; r++) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = deq(2), z3 = deq(6);
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = deq(0);
      z3 = deq(4);
      int64_t tmp0 = (z2 + z3) * 8192;
      int64_t tmp1 = (z2 - z3) * 8192;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = deq(7);
      tmp1 = deq(5);
      tmp2 = deq(3);
      tmp3 = deq(1);
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      auto ds = [](int64_t x) { return static_cast<int>((x + (1 << 10)) >> 11); };
      wp[0] = ds(tmp10 + tmp3);
      wp[56] = ds(tmp10 - tmp3);
      wp[8] = ds(tmp11 + tmp2);
      wp[48] = ds(tmp11 - tmp2);
      wp[16] = ds(tmp12 + tmp1);
      wp[40] = ds(tmp12 - tmp1);
      wp[24] = ds(tmp13 + tmp0);
      wp[32] = ds(tmp13 - tmp0);
    }
    for (int row = 0; row < 8; row++) {
      const int* wp = ws + 8 * row;
      uint8_t* op = out + static_cast<size_t>(row) * stride;
      if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
          wp[7] == 0) {
        uint8_t dc = limit[((static_cast<int64_t>(wp[0]) + 16) >> 5) & 1023];
        for (int i = 0; i < 8; i++) op[i] = dc;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847;
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * 8192;
      int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * 8192;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      auto ds = [&](int64_t x) { return limit[((x + (int64_t(1) << 17)) >> 18) & 1023]; };
      op[0] = ds(tmp10 + tmp3);
      op[7] = ds(tmp10 - tmp3);
      op[1] = ds(tmp11 + tmp2);
      op[6] = ds(tmp11 - tmp2);
      op[2] = ds(tmp12 + tmp1);
      op[5] = ds(tmp12 - tmp1);
      op[3] = ds(tmp13 + tmp0);
      op[4] = ds(tmp13 - tmp0);
    }
  }

  // One component's samples at full size (height x width, stride width).
  void component_plane(Component& c, const uint8_t* limit, std::vector<uint8_t>& full) {
    int pw = c.bw * 8, ph = c.bh * 8;
    std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
    if (c.coef.empty()) c.coef.assign(static_cast<size_t>(c.bw_pad) * c.bh_pad * 64, 0);
    if (!c.latched) {  // never scanned: its blocks are zero
      for (int k = 0; k < 64; k++) c.qt[k] = static_cast<int16_t>(qt_defined_[c.tq] ? qt_[c.tq][k] : 0);
    }
    for (int by = 0; by < c.bh; by++)
      for (int bx = 0; bx < c.bw; bx++)
        idct_islow(c.block(bx, by), c.qt, plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8, pw,
                   limit);
    const int dw = c.dw, dh = c.dh;
    const int hr = hmax_ / c.h, vr = vmax_ / c.v;
    // the upsampled rows cover 2 dw / 2 dh samples; keep the image's
    const int ow = dw * hr, oh = dh * vr;
    std::vector<uint8_t> up(static_cast<size_t>(ow) * oh);
    auto in = [&](int y, int x) -> int {  // rows beyond the edges replicate it
      y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
      return plane[static_cast<size_t>(y) * pw + x];
    };
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < dh; y++)
        for (int x = 0; x < dw; x++) up[static_cast<size_t>(y) * ow + x] = static_cast<uint8_t>(in(y, x));
    } else if (hr == 2 && vr == 1) {
      for (int y = 0; y < dh; y++) {
        uint8_t* o = up.data() + static_cast<size_t>(y) * ow;
        if (dw > 2) {  // h2v1_fancy_upsample
          o[0] = static_cast<uint8_t>(in(y, 0));
          o[1] = static_cast<uint8_t>((in(y, 0) * 3 + in(y, 1) + 2) >> 2);
          for (int x = 1; x < dw - 1; x++) {
            int v3 = in(y, x) * 3;
            o[2 * x] = static_cast<uint8_t>((v3 + in(y, x - 1) + 1) >> 2);
            o[2 * x + 1] = static_cast<uint8_t>((v3 + in(y, x + 1) + 2) >> 2);
          }
          o[2 * dw - 2] = static_cast<uint8_t>((in(y, dw - 1) * 3 + in(y, dw - 2) + 1) >> 2);
          o[2 * dw - 1] = static_cast<uint8_t>(in(y, dw - 1));
        } else {  // h2v1_upsample
          for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = static_cast<uint8_t>(in(y, x));
        }
      }
    } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < dh; y++)
        for (int v = 0; v < 2; v++) {
          int y1 = v == 0 ? y - 1 : y + 1, bias = v == 0 ? 1 : 2;
          uint8_t* o = up.data() + static_cast<size_t>(2 * y + v) * ow;
          for (int x = 0; x < dw; x++)
            o[x] = static_cast<uint8_t>((in(y, x) * 3 + in(y1, x) + bias) >> 2);
        }
    } else {  // hr == 2 && vr == 2
      for (int y = 0; y < dh; y++)
        for (int v = 0; v < 2; v++) {
          uint8_t* o = up.data() + static_cast<size_t>(2 * y + v) * ow;
          if (dw > 2) {  // h2v2_fancy_upsample
            int y1 = v == 0 ? y - 1 : y + 1;
            auto colsum = [&](int x) { return in(y, x) * 3 + in(y1, x); };
            int this_ = colsum(0), next = colsum(1), last;
            o[0] = static_cast<uint8_t>((this_ * 4 + 8) >> 4);
            o[1] = static_cast<uint8_t>((this_ * 3 + next + 7) >> 4);
            last = this_;
            this_ = next;
            for (int x = 1; x < dw - 1; x++) {
              next = colsum(x + 1);
              o[2 * x] = static_cast<uint8_t>((this_ * 3 + last + 8) >> 4);
              o[2 * x + 1] = static_cast<uint8_t>((this_ * 3 + next + 7) >> 4);
              last = this_;
              this_ = next;
            }
            o[2 * dw - 2] = static_cast<uint8_t>((this_ * 3 + last + 8) >> 4);
            o[2 * dw - 1] = static_cast<uint8_t>((this_ * 4 + 7) >> 4);
          } else {  // h2v2_upsample
            for (int x = 0; x < dw; x++) o[2 * x] = o[2 * x + 1] = static_cast<uint8_t>(in(y, x));
          }
        }
    }
    full.resize(static_cast<size_t>(width) * height);
    for (int y = 0; y < height; y++)
      std::memcpy(full.data() + static_cast<size_t>(y) * width, up.data() + static_cast<size_t>(y) * ow,
                  width);
  }

  void output(uint8_t* out) {
    // jdmaster.c's range-limit table, post-IDCT part: x & 1023 -> sample
    uint8_t limit[1024];
    for (int i = 0; i < 1024; i++) {  // the index as a signed 10-bit value
      int v = (i < 512 ? i : i - 1024) + 128;
      limit[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
    std::vector<std::vector<uint8_t>> planes(ncomp);
    for (int i = 0; i < ncomp; i++) component_plane(comp_[i], limit, planes[i]);
    const size_t n = static_cast<size_t>(width) * height;
    if (ncomp == 1) {
      std::memcpy(out, planes[0].data(), n);
      return;
    }
    bool rgb;
    if (jfif_) rgb = false;
    else if (adobe_) rgb = adobe_transform_ == 0;
    else rgb = comp_[0].id == 82 && comp_[1].id == 71 && comp_[2].id == 66;
    if (rgb) {
      for (size_t i = 0; i < n; i++)
        for (int c = 0; c < 3; c++) out[3 * i + c] = planes[c][i];
      return;
    }
    // jdcolor.c build_ycc_rgb_table, ycc_rgb_convert
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return static_cast<int64_t>(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    const uint8_t *Y = planes[0].data(), *Cb = planes[1].data(), *Cr = planes[2].data();
    for (size_t i = 0; i < n; i++) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_error(char* err, int64_t errlen, const char* msg) {
  if (errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg);
  }
}

}  // namespace

extern "C" int lumo_jpeg_header(const uint8_t* data, int64_t n, int32_t* info, char* err,
                                int64_t errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.header();
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}

extern "C" int lumo_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err,
                                int64_t errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.decode(out);
    return 0;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return 1;
  }
}
