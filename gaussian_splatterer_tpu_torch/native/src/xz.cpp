// The xz (LZMA2) decoder of io/xz.py: the bytes liblzma writes before it
// reports an error or runs out of input, up to a strip's size.  The C++
// form of io/xz.decode_until_error_python, which returns what it returns.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Stop {};

uint32_t crc32(const uint8_t* p, int64_t n) {
  static uint32_t table[256];
  static bool ready = false;
  if (!ready) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    ready = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (int64_t i = 0; i < n; i++) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t le32(const uint8_t* p) { return p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24; }

struct Range {
  const uint8_t* data;
  int64_t n, pos;
  uint32_t range = 0xFFFFFFFFu, code = 0;

  Range(const uint8_t* d, int64_t len, int64_t at) : data(d), n(len), pos(at) {
    if (pos + 5 > n || data[pos]) throw Stop();
    code = (uint32_t)data[pos + 1] << 24 | data[pos + 2] << 16 | data[pos + 3] << 8 | data[pos + 4];
    pos += 5;
  }
  void normalize() {
    if (range < (1u << 24)) {
      if (pos >= n) throw Stop();
      range <<= 8;
      code = (code << 8) | data[pos++];
    }
  }
  int bit(uint16_t* p) {
    normalize();
    uint32_t bound = (range >> 11) * *p;
    if (code < bound) {
      range = bound;
      *p += (2048 - *p) >> 5;
      return 0;
    }
    range -= bound;
    code -= bound;
    *p -= *p >> 5;
    return 1;
  }
  uint32_t tree(uint16_t* probs, int bits) {
    uint32_t m = 1;
    for (int i = 0; i < bits; i++) m = (m << 1) | bit(probs + m);
    return m - (1u << bits);
  }
  uint32_t reverse(uint16_t* probs, int bits) {
    uint32_t m = 1, sym = 0;
    for (int i = 0; i < bits; i++) {
      int b = bit(probs + m);
      m = (m << 1) | b;
      sym |= (uint32_t)b << i;
    }
    return sym;
  }
  uint32_t direct(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; i++) {
      normalize();
      range >>= 1;
      int b = code >= range;
      if (b) code -= range;
      v = (v << 1) | b;
    }
    return v;
  }
};

struct Len {
  uint16_t choice[2], low[16 << 3], mid[16 << 3], high[256];
  void reset() {
    std::fill_n(choice, 2, 1024);
    std::fill_n(low, 16 << 3, 1024);
    std::fill_n(mid, 16 << 3, 1024);
    std::fill_n(high, 256, 1024);
  }
  uint32_t decode(Range& rc, int pos_state) {
    if (!rc.bit(choice)) return 2 + rc.tree(low + (pos_state << 3), 3);
    if (!rc.bit(choice + 1)) return 10 + rc.tree(mid + (pos_state << 3), 3);
    return 18 + rc.tree(high, 8);
  }
};

struct Lzma {
  int lc = 0, lp = 0, pb = 0;
  std::vector<uint16_t> literal;
  uint16_t is_match[12 << 4], is_rep[12], is_rep0[12], is_rep1[12], is_rep2[12],
      is_rep0_long[12 << 4], dist_slot[4 << 6], dist_special[115], align[16];
  Len match_len, rep_len;
  int state = 0;
  uint32_t reps[4] = {0, 0, 0, 0};

  void reset(int props) {
    lc = props % 9;
    lp = (props / 9) % 5;
    pb = props / 45;
    literal.assign((size_t)0x300 << (lc + lp), 1024);
    for (auto& v : is_match) v = 1024;
    for (auto* a : {is_rep, is_rep0, is_rep1, is_rep2})
      for (int i = 0; i < 12; i++) a[i] = 1024;
    for (auto& v : is_rep0_long) v = 1024;
    for (auto& v : dist_slot) v = 1024;
    for (auto& v : dist_special) v = 1024;
    for (auto& v : align) v = 1024;
    match_len.reset();
    rep_len.reset();
    state = 0;
    reps[0] = reps[1] = reps[2] = reps[3] = 0;
  }
};

int64_t vli(const uint8_t* d, int64_t& pos, int64_t end) {
  uint64_t v = 0;
  int shift = 0;
  for (;;) {
    if (pos >= end || shift > 56) throw Stop();
    uint8_t b = d[pos++];
    v |= (uint64_t)(b & 0x7F) << shift;
    shift += 7;
    if (!(b & 0x80)) {
      if (b == 0 && shift > 7) throw Stop();
      return (int64_t)v;
    }
  }
}

struct Out {
  uint8_t* buf;
  int64_t n = 0, size;
};

// one LZMA chunk: the input it used, or -1 where the strip filled first
int64_t lzma_chunk(Lzma& lz, const uint8_t* data, int64_t len, int64_t pos, int64_t unpacked,
                   int64_t dsize, int64_t start, Out& o) {
  Range rc(data, len, pos);
  int64_t end = o.n + unpacked, limit = end < o.size ? end : o.size;
  uint32_t pb_mask = (1u << lz.pb) - 1, lp_mask = (1u << lz.lp) - 1;
  uint32_t* reps = lz.reps;
  while (o.n < limit) {
    int64_t n = o.n;
    int pos_state = (int)((n - start) & pb_mask);
    int state = lz.state;
    if (!rc.bit(lz.is_match + (state << 4) + pos_state)) {
      int prev = n > start ? o.buf[n - 1] : 0;
      uint16_t* probs =
          lz.literal.data() + 0x300 * ((((n - start) & lp_mask) << lz.lc) + (prev >> (8 - lz.lc)));
      uint32_t sym = 1;
      if (state < 7) {
        while (sym < 0x100) sym = (sym << 1) | rc.bit(probs + sym);
      } else {
        uint32_t match = o.buf[n - reps[0] - 1], offset = 0x100;
        while (sym < 0x100) {
          match <<= 1;
          uint32_t mbit = match & offset;
          int b = rc.bit(probs + offset + mbit + sym);
          sym = (sym << 1) | b;
          offset &= b ? mbit : ~mbit;
        }
      }
      o.buf[o.n++] = (uint8_t)sym;
      lz.state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
      continue;
    }
    int64_t full = n - start < dsize ? n - start : dsize;
    uint32_t length;
    if (!rc.bit(lz.is_rep + state)) {
      lz.state = state < 7 ? 7 : 10;
      length = lz.match_len.decode(rc, pos_state);
      uint32_t slot = rc.tree(lz.dist_slot + ((length - 2 < 3 ? length - 2 : 3) << 6), 6);
      uint32_t dist;
      if (slot < 4) {
        dist = slot;
      } else {
        int bits = (int)(slot >> 1) - 1;
        dist = (2 | (slot & 1)) << bits;
        if (slot < 14) {
          dist += rc.reverse(lz.dist_special + dist - slot - 1, bits);
        } else {
          dist += rc.direct(bits - 4) << 4;
          dist += rc.reverse(lz.align, 4);
        }
      }
      reps[3] = reps[2];
      reps[2] = reps[1];
      reps[1] = reps[0];
      reps[0] = dist;
      if (dist == 0xFFFFFFFFu || (int64_t)dist >= full) throw Stop();
    } else {
      if (full == 0) throw Stop();
      if (!rc.bit(lz.is_rep0 + state)) {
        if (!rc.bit(lz.is_rep0_long + (state << 4) + pos_state)) {
          lz.state = state < 7 ? 9 : 11;
          o.buf[o.n] = o.buf[n - reps[0] - 1];
          o.n++;
          continue;
        }
      } else {
        uint32_t dist;
        if (!rc.bit(lz.is_rep1 + state)) {
          dist = reps[1];
        } else {
          if (!rc.bit(lz.is_rep2 + state)) {
            dist = reps[2];
          } else {
            dist = reps[3];
            reps[3] = reps[2];
          }
          reps[2] = reps[1];
        }
        reps[1] = reps[0];
        reps[0] = dist;
      }
      lz.state = state < 7 ? 8 : 11;
      length = lz.rep_len.decode(rc, pos_state);
    }
    int64_t src = n - (int64_t)reps[0] - 1;
    int64_t take = (int64_t)length < limit - n ? (int64_t)length : limit - n;
    for (int64_t i = 0; i < take; i++) o.buf[o.n++] = o.buf[src + i];
    if (take < (int64_t)length) {
      if (o.n >= o.size) return -1;
      throw Stop();
    }
  }
  if (o.n >= o.size) return -1;
  if (rc.code) throw Stop();
  return rc.pos - pos;
}

void decode(const uint8_t* data, int64_t len, Out& o, int* delta) {
  static const uint8_t magic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
  if (len < 12 || std::memcmp(data, magic, 6) != 0) throw Stop();
  if (data[6] || data[7] > 15 || crc32(data + 6, 2) != le32(data + 8)) throw Stop();
  int64_t pos = 12;
  if (pos >= len || data[pos] == 0) throw Stop();
  int64_t hsize = (int64_t)(data[pos] + 1) * 4, hend = pos + hsize;
  if (hend > len || crc32(data + pos, hsize - 4) != le32(data + hend - 4)) throw Stop();
  int flags = data[pos + 1];
  if ((flags & 0x3C) || (flags & 3) > 1) throw Stop();
  int64_t p = pos + 2;
  if (flags & 0x40) vli(data, p, hend - 4);
  if (flags & 0x80) vli(data, p, hend - 4);
  int db = 0;
  for (int k = 0; k <= (flags & 3); k++) {
    int64_t fid = vli(data, p, hend - 4), psize = vli(data, p, hend - 4);
    if (psize != 1 || p + 1 > hend - 4 || fid != (k == (flags & 3) ? 0x21 : 0x03)) throw Stop();
    if (fid == 0x03)
      *delta = data[p] + 1;
    else
      db = data[p];
    p++;
  }
  if (db > 40) throw Stop();
  for (int64_t i = p; i < hend - 4; i++)
    if (data[i]) throw Stop();
  int64_t dsize = db == 40 ? 0xFFFFFFFFll : (int64_t)(2 | (db & 1)) << (db / 2 + 11);
  dsize = (dsize + 15) & ~int64_t(15);
  if (dsize < 4096) dsize = 4096;
  pos = hend;
  bool need_dict_reset = true, need_props = true;
  Lzma lz;
  int64_t start = 0;
  while (o.n < o.size) {
    if (pos >= len) throw Stop();
    int control = data[pos++];
    if (control == 0) throw Stop();
    if (control >= 0xE0 || control == 1) {
      need_props = need_dict_reset = true;
    } else if (need_dict_reset) {
      throw Stop();
    }
    if (need_dict_reset) {
      need_dict_reset = false;
      start = o.n;
    }
    if (control >= 0x80) {
      if (pos + 4 > len) throw Stop();
      int64_t unpacked = ((int64_t)(control & 0x1F) << 16 | data[pos] << 8 | data[pos + 1]) + 1;
      int64_t packed = (data[pos + 2] << 8 | data[pos + 3]) + 1;
      pos += 4;
      if (control >= 0xC0) {
        if (pos >= len) throw Stop();
        int props = data[pos++];
        if (props > 224 || props % 9 + (props / 9) % 5 > 4) throw Stop();
        lz.reset(props);
        need_props = false;
      } else if (need_props) {
        throw Stop();
      } else if (control >= 0xA0) {
        lz.reset(lz.lc + 9 * lz.lp + 45 * lz.pb);
      }
      int64_t used = lzma_chunk(lz, data, len, pos, unpacked, dsize, start, o);
      if (used < 0) return;
      if (used != packed) throw Stop();
      pos += packed;
    } else {
      if (control > 2 || pos + 2 > len) throw Stop();
      int64_t n = (data[pos] << 8 | data[pos + 1]) + 1;
      pos += 2;
      for (int64_t i = 0; i < n; i++) {
        if (o.n >= o.size) return;
        if (pos + i >= len) throw Stop();
        o.buf[o.n++] = data[pos + i];
      }
      pos += n;
    }
  }
}

}  // namespace

extern "C" {

// io/xz.decode_until_error_python into out (size bytes): the count written.
int64_t gst_xz_until_error(const uint8_t* data, int64_t len, int64_t size, uint8_t* out) {
  Out o{out, 0, size};
  int delta = 0;
  try {
    decode(data, len, o, &delta);
  } catch (const Stop&) {
  }
  for (int64_t i = delta; delta && i < o.n; i++) out[i] = (uint8_t)(out[i] + out[i - delta]);
  return o.n;
}

}  // extern "C"
