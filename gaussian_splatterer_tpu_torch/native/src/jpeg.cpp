// JPEG entropy decoders for io/jpeg_arith.py and io/jpeg_lossless.py: the
// arithmetic (QM) decoder of one restart interval as libjpeg-turbo's
// jdarith.c runs it, and the Huffman-coded differences of a lossless
// (SOF3) scan as jdlhuff.c reads them.  Each is the C++ form of a Python
// twin (io/jpeg_arith.decode_segment_python,
// io/jpeg_lossless.decode_diffs_python, undifference_python) and returns
// what it returns.
#include <cstdint>
#include <cstring>

namespace {

const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171,
};

enum { kSequential, kDcFirst, kAcFirst, kDcRefine, kAcRefine };

struct CantSuspend {};

struct Qm {
  const uint8_t* data;
  int64_t pos, stop;
  int marker;
  int64_t c = 0, a = 0;
  int ct = -16;

  int byte() {
    if (pos >= stop) throw CantSuspend();
    return data[pos++];
  }

  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int d;
        if (marker) {
          d = 0;
        } else {
          d = byte();
          if (d == 0xFF) {
            do d = byte();
            while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;
            } else {
              marker = d;
              d = 0;
            }
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
    qe >>= 16;
    a -= qe;
    int64_t temp = a << ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        *st = (sv & 0x80) ^ nm;
      } else {
        *st = (sv & 0x80) ^ nl;
        sv ^= 0x80;
      }
      a = qe;
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = (sv & 0x80) ^ nl;
        sv ^= 0x80;
      } else {
        *st = (sv & 0x80) ^ nm;
      }
    }
    return sv >> 7;
  }
};

struct ArithScan {
  Qm q;
  uint8_t st_dc[16][64], st_ac[16][256];
  uint8_t fixed = 113;
  int last[4] = {0, 0, 0, 0}, ctx[4] = {0, 0, 0, 0};
  const int32_t *dc_tbl, *ac_tbl, *cond;  // cond: L[16], U[16], K[16]

  // the DC difference of scan component k, false on a bad code
  bool dc_diff(int k, int* out) {
    int t = dc_tbl[k];
    uint8_t* st = st_dc[t];
    int i = ctx[k];
    if (!q.decode(st + i)) {
      ctx[k] = 0;
      *out = 0;
      return true;
    }
    int sign = q.decode(st + i + 1);
    i += 2 + sign;
    int m = q.decode(st + i);
    if (m) {
      i = 20;
      while (q.decode(st + i)) {
        if ((m <<= 1) == 0x8000) return false;
        i += 1;
      }
    }
    if (m < (1 << cond[t]) >> 1)
      ctx[k] = 0;
    else if (m > (1 << cond[16 + t]) >> 1)
      ctx[k] = 12 + sign * 4;
    else
      ctx[k] = 4 + sign * 4;
    int v = m;
    i += 14;
    while (m >>= 1)
      if (q.decode(st + i)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }

  bool ac_value(uint8_t* st, int i, int k, int t, int* out) {
    int sign = q.decode(&fixed);
    i += 2;
    int m = q.decode(st + i);
    if (m && q.decode(st + i)) {
      m <<= 1;
      i = k <= cond[32 + t] ? 189 : 217;
      while (q.decode(st + i)) {
        if ((m <<= 1) == 0x8000) return false;
        i += 1;
      }
    }
    int v = m;
    i += 14;
    while (m >>= 1)
      if (q.decode(st + i)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }
};

inline int16_t wrap16(int64_t v) { return (int16_t)(uint16_t)(v & 0xFFFF); }

}  // namespace

extern "C" {

// One restart interval of an arithmetic-coded scan (see
// io/jpeg_arith.decode_segment_python): units (n_mcu, bpm) offsets into
// coef; slots (bpm,) the scan component of each block; returns 0 or 1
// (CANT_SUSPEND), the position after the last byte read in *end and the
// marker met in *marker_out.
int gst_jpeg_arith_segment(const uint8_t* data, int64_t pos, int64_t stop, int marker, int kind,
                           int ss, int se, int al, const int64_t* units, int64_t n_mcu,
                           int64_t bpm, const int32_t* slots, const int32_t* dc_tbl,
                           const int32_t* ac_tbl, const int32_t* cond, int16_t* coef,
                           int64_t* end, int* marker_out) {
  ArithScan s;
  s.q.data = data;
  s.q.pos = pos;
  s.q.stop = stop;
  s.q.marker = marker;
  std::memset(s.st_dc, 0, sizeof s.st_dc);
  std::memset(s.st_ac, 0, sizeof s.st_ac);
  s.dc_tbl = dc_tbl;
  s.ac_tbl = ac_tbl;
  s.cond = cond;
  int status = 0;
  try {
    for (int64_t n = 0; n < n_mcu; n++) {
      const int64_t* mcu = units + n * bpm;
      if (kind == kDcRefine) {
        for (int64_t b = 0; b < bpm; b++)
          if (s.q.decode(&s.fixed)) coef[mcu[b]] = wrap16(coef[mcu[b]] | (1 << al));
        continue;
      }
      bool bad = false;
      for (int64_t b = 0; b < bpm && !bad; b++) {
        int k = slots[b];
        int16_t* blk = coef + mcu[b];
        if (kind == kSequential || kind == kDcFirst) {
          int v;
          if (!s.dc_diff(k, &v)) {
            bad = true;
            break;
          }
          s.last[k] = (s.last[k] + v) & 0xFFFF;
          blk[0] = wrap16(kind == kDcFirst ? (int64_t)s.last[k] << al : s.last[k]);
          if (kind == kDcFirst) continue;
        }
        int t = ac_tbl[k];
        uint8_t* st = s.st_ac[t];
        if (kind == kAcRefine) {
          int kex = se;
          while (kex > 0 && !blk[kex]) kex--;
          int p1 = 1 << al;
          for (int j = ss; j <= se && !bad; j++) {
            int i = 3 * (j - 1);
            if (j > kex && s.q.decode(st + i)) break;
            for (;;) {
              int c = blk[j];
              if (c) {
                if (s.q.decode(st + i + 2)) blk[j] = wrap16(c < 0 ? c - p1 : c + p1);
                break;
              }
              if (s.q.decode(st + i + 1)) {
                blk[j] = wrap16(s.q.decode(&s.fixed) ? -p1 : p1);
                break;
              }
              i += 3;
              if (++j > se) {
                bad = true;
                break;
              }
            }
          }
          continue;
        }
        int lo = kind == kSequential ? 1 : ss, hi = kind == kSequential ? 63 : se;
        for (int j = lo; j <= hi; j++) {
          int i = 3 * (j - 1);
          if (s.q.decode(st + i)) break;
          while (!s.q.decode(st + i + 1)) {
            i += 3;
            if (++j > hi) {
              bad = true;
              break;
            }
          }
          if (bad) break;
          int v;
          if (!s.ac_value(st, i, j, t, &v)) {
            bad = true;
            break;
          }
          blk[j] = wrap16(kind == kAcFirst ? (int64_t)v * (1 << al) : v);
        }
      }
      if (bad) break;
    }
  } catch (const CantSuspend&) {
    status = 1;
  }
  *end = s.q.pos;
  *marker_out = s.q.marker;
  return status;
}

// One restart interval of a lossless scan's differences (see
// io/jpeg_lossless.decode_diffs_python): returns the first MCU row whose
// call began out of data (rows if none), or -1 where libjpeg's read-ahead
// suspends at the end of unterminated data; out is (rows, per_row, bpm),
// *flag_out the out-of-data flag at the interval's end.
int64_t gst_jpeg_lossless_diffs(const uint8_t* seg, int64_t n, int terminated, int flag,
                                int64_t rows, int64_t per_row, int64_t bpm,
                                const int32_t* tabsel, const int32_t* luts, int32_t* out,
                                int* flag_out) {
  *flag_out = flag;
  const int kMinGetBits = 57;
  auto byte_at = [&](int64_t i) -> uint32_t { return i < n ? seg[i] : 0; };
  auto peek32 = [&](int64_t p) -> uint32_t {
    int64_t i = p >> 3;
    return byte_at(i) << 24 | byte_at(i + 1) << 16 | byte_at(i + 2) << 8 | byte_at(i + 3);
  };
  int64_t limit = 8 * n, p = 0, r = 0;
  auto fill = [&](int need) -> bool {
    if (r - p < need) {
      if (limit - p < kMinGetBits) return false;
      r = (p + kMinGetBits + 7) & ~int64_t(7);
    }
    return true;
  };
  for (int64_t row = 0; row < rows; row++) {
    if (flag) {
      *flag_out = 1;
      return row;
    }
    int32_t* o = out + row * per_row * bpm;
    for (int64_t m = 0; m < per_row; m++) {
      for (int64_t b = 0; b < bpm; b++) {
        uint32_t w = peek32(p);
        int e = luts[int64_t(tabsel[b]) * 65536 + ((w >> (16 - (p & 7))) & 0xFFFF)];
        int len = e >> 8, s = e & 255;
        if (!terminated) {
          if (!fill(8)) return -1;
          if (len > 8) {
            if (!fill(9)) return -1;
            p += 9;
            for (int k = 9; k < len; k++) {
              if (!fill(1)) return -1;
              p += 1;
            }
          } else {
            p += len;
          }
          if (s && s != 16 && !fill(s)) return -1;
        } else {
          p += len;
        }
        int v = 0;
        if (s == 16) {
          v = 32768;
        } else if (s) {
          uint32_t bits = (peek32(p) >> (32 - s - (p & 7))) & ((1u << s) - 1);
          p += s;
          v = (int)bits;
          if (v < (1 << (s - 1))) v -= (1 << s) - 1;
        }
        o[m * bpm + b] = v;
      }
    }
    if (p > limit) flag = 1;
    *flag_out = flag;
  }
  return rows;
}

// A component's 16-bit values from its (rows, w) differences (see
// io/jpeg_lossless.undifference_python).
void gst_jpeg_undifference(const int32_t* diffs, const uint8_t* first, int64_t rows, int64_t w,
                           int predictor, int initial, int32_t* out) {
  for (int64_t y = 0; y < rows; y++) {
    const int32_t* d = diffs + y * w;
    int32_t* x = out + y * w;
    if (first[y] || y == 0) {
      int64_t a = initial;
      for (int64_t i = 0; i < w; i++) x[i] = a = (d[i] + a) & 0xFFFF;
      continue;
    }
    const int32_t* b = out + (y - 1) * w;
    int64_t a = (d[0] + int64_t(b[0])) & 0xFFFF;
    x[0] = (int32_t)a;
    for (int64_t i = 1; i < w; i++) {
      int64_t ra = a, rb = b[i], rc = b[i - 1], p;
      switch (predictor) {
        case 1: p = ra; break;
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      x[i] = (int32_t)(a = (d[i] + p) & 0xFFFF);
    }
  }
}

}  // extern "C"
