// The Zstandard (RFC 8878) decoder of io/zstd.py: one frame as libtiff's
// ZSTDDecode reads it through libzstd 1.5.7's streaming decoder, into a
// strip of `size` bytes, or a refusal with libzstd's (or libtiff's) reason.
// The C++ form of io/zstd.decode_python, which returns what it returns; the
// module's docstring lists the rules of libzstd this follows.  It links no
// zstd library.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Fail {
  std::string reason;
  int64_t kept = 0;  // the bytes libtiff keeps: what was flushed where the input ran out
};

const char* const kCorrupt = "Data corruption detected";
const char* const kTooSmall = "Destination buffer is too small";
const char* const kSrcSize = "Src size is incorrect";
const char* const kTableLog = "tableLog requires too much memory : unsupported";

[[noreturn]] void fail(const std::string& reason) { throw Fail{reason}; }

const uint32_t kMagic = 0xFD2FB528u, kSkippable = 0x184D2A50u;
const int64_t kBlockMax = 128 << 10, kWindowLimit = (int64_t(1) << 27) + 1;
const int64_t kLitExtra = 1 << 16, kWild = 32;
const int64_t kUnknown = -1;

int highbit(uint64_t v) { return 63 - __builtin_clzll(v); }

// memmove and memset that take no pointer when there is nothing to copy
void copy_bytes(void* dst, const void* src, int64_t n) {
  if (n > 0) std::memmove(dst, src, size_t(n));
}
void set_bytes(uint8_t* dst, uint8_t v, int64_t n) {
  if (n > 0) std::memset(dst, v, size_t(n));
}

uint64_t le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = n - 1; i >= 0; i--) v = v << 8 | p[i];
  return v;
}

// ---- XXH64 ------------------------------------------------------------

const uint64_t P1 = 0x9E3779B185EBCA87ull, P2 = 0xC2B2AE3D27D4EB4Full, P3 = 0x165667B19E3779F9ull,
               P4 = 0x85EBCA77C2B2AE63ull, P5 = 0x27D4EB2F165667C5ull;

uint64_t rotl(uint64_t x, int r) { return x << r | x >> (64 - r); }
uint64_t xround(uint64_t acc, uint64_t lane) { return rotl(acc + lane * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* d, int64_t n) {
  int64_t p = 0;
  uint64_t h;
  if (n >= 32) {
    uint64_t v[4] = {P1 + P2, P2, 0, 0 - P1};
    for (; p + 32 <= n; p += 32)
      for (int i = 0; i < 4; i++) v[i] = xround(v[i], le(d + p + 8 * i, 8));
    h = rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18);
    for (uint64_t lane : v) h = (h ^ xround(0, lane)) * P1 + P4;
  } else {
    h = P5;
  }
  h += uint64_t(n);
  for (; p + 8 <= n; p += 8) h = rotl(h ^ xround(0, le(d + p, 8)), 27) * P1 + P4;
  if (p + 4 <= n) {
    h = rotl(h ^ (le(d + p, 4) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < n; p++) h = rotl(h ^ (d[p] * P5), 11) * P1;
  h = (h ^ (h >> 33)) * P2;
  h = (h ^ (h >> 29)) * P3;
  return h ^ (h >> 32);
}

// ---- bit streams --------------------------------------------------------

// A backward bit stream read from its last bit toward its first, past the
// end mark of its last byte; bits past its first read as zeros.
struct Backward {
  const uint8_t* d;
  int64_t start, total, used = 0;

  Backward(const uint8_t* data, int64_t s, int64_t end) : d(data), start(s) {
    if (end <= s) fail(kSrcSize);
    uint8_t last = data[end - 1];
    if (!last) fail(kCorrupt);
    total = 8 * (end - s - 1) + highbit(last);
  }
  // the n (<= 57) bits whose lowest is bit `lo` from the stream's first
  uint64_t at(int64_t lo, int n) const {
    if (n == 0 || lo + n <= 0) return 0;
    int shift = 0;
    if (lo < 0) {
      shift = int(-lo);
      n += int(lo);
      lo = 0;
    }
    int64_t a = start + (lo >> 3), b = start + ((lo + n + 7) >> 3);
    uint64_t v = le(d + a, int(b - a)) >> (lo & 7);
    return (v & ((uint64_t(1) << n) - 1)) << shift;
  }
  uint64_t read(int n) {
    uint64_t v = at(total - used - n, n);
    used += n;
    return v;
  }
  bool overflow() const { return used > total; }
};

// FSE_readNCount over src[start, start + size): (counts, log, bytes read).
struct NCount {
  std::vector<int> norm;
  int log;
  int64_t used;
};

NCount read_ncount(const uint8_t* src, int64_t start, int64_t size, int max_symbol) {
  if (size < 8) {
    uint8_t buf[8] = {0};
    copy_bytes(buf, src + start, size);
    NCount r = read_ncount(buf, 0, 8, max_symbol);
    if (r.used > size) fail(kCorrupt);
    return r;
  }
  const uint8_t* buf = src;
  int64_t ip = start, iend = start + size;
  int max_sv1 = max_symbol + 1;
  std::vector<int> norm(size_t(max_sv1) + 1, 0);
  uint32_t stream = uint32_t(le(buf + ip, 4));
  int nb = int(stream & 0xF) + 5;
  if (nb > 15) fail(kTableLog);
  int log = nb;
  stream >>= 4;
  int count_bits = 4;
  int remaining = (1 << nb) + 1, threshold = 1 << nb;
  nb++;
  int charnum = 0;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
      ip += count_bits >> 3;
      count_bits &= 7;
    } else {
      count_bits = int((count_bits - 8 * (iend - 4 - ip)) & 31);
      ip = iend - 4;
    }
    stream = uint32_t(le(buf + ip, 4)) >> count_bits;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~stream | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 36;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          count_bits = int((count_bits - 8 * (iend - 7 - ip)) & 31);
          ip = iend - 4;
        }
        stream = uint32_t(le(buf + ip, 4)) >> count_bits;
        repeats = __builtin_ctz(~stream | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      stream >>= 2 * repeats;
      count_bits += 2 * repeats;
      charnum += int(stream & 3);
      count_bits += 2;
      if (charnum >= max_sv1) break;
      advance();
    }
    int mx = (2 * threshold - 1) - remaining, count;
    if (int(stream & uint32_t(threshold - 1)) < mx) {
      count = int(stream & uint32_t(threshold - 1));
      count_bits += nb - 1;
    } else {
      count = int(stream & uint32_t(2 * threshold - 1));
      if (count >= threshold) count -= mx;
      count_bits += nb;
    }
    count--;
    remaining -= count >= 0 ? count : 1;
    norm[size_t(charnum++)] = count;
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nb = highbit(uint64_t(remaining)) + 1;
      threshold = 1 << (nb - 1);
    }
    if (charnum >= max_sv1) break;
    advance();
  }
  if (remaining != 1) fail(kCorrupt);
  if (charnum > max_sv1) fail("Unsupported max Symbol Value : too small");
  if (count_bits > 32) fail(kCorrupt);
  norm.resize(size_t(charnum));
  return {norm, log, ip + ((count_bits + 7) >> 3) - start};
}

struct FseCell {
  int sym, bits, base;
};

std::vector<FseCell> fse_table(const std::vector<int>& norm, int log) {
  int size = 1 << log, high = size - 1;
  std::vector<int> symbols(size_t(size), 0), nxt(norm);
  for (size_t s = 0; s < norm.size(); s++)
    if (norm[s] == -1) {
      symbols[size_t(high--)] = int(s);
      nxt[s] = 1;
    }
  int step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
  for (size_t s = 0; s < norm.size(); s++)
    for (int i = 0; i < norm[s]; i++) {
      symbols[size_t(pos)] = int(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  std::vector<FseCell> table;
  table.reserve(size_t(size));
  for (int s : symbols) {
    int state = nxt[size_t(s)]++;
    int bits = log - highbit(uint64_t(state));
    table.push_back({s, bits, (state << bits) - size});
  }
  return table;
}

// ---- sequence codes -------------------------------------------------------

const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,   5,   6,   7,   8,     9,     10,    11,
                              12, 13, 14, 15, 16,  18,  20,  22,  24,    28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,   15,   16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,   29,   30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,   67,   83,
                              99, 0x83, 0x103, 0x203, 0x403, 0x803, 0x1003, 0x2003, 0x4003,
                              0x8003, 0x10003};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t OF_BASE[32] = {
    0,         1,         1,         5,         0xD,       0x1D,      0x3D,      0x7D,
    0xFD,      0x1FD,     0x3FD,     0x7FD,     0xFFD,     0x1FFD,    0x3FFD,    0x7FFD,
    0xFFFD,    0x1FFFD,   0x3FFFD,   0x7FFFD,   0xFFFFD,   0x1FFFFD,  0x3FFFFD,  0x7FFFFD,
    0xFFFFFD,  0x1FFFFFD, 0x3FFFFFD, 0x7FFFFFD, 0xFFFFFFD, 0x1FFFFFFD, 0x3FFFFFFD, 0x7FFFFFFD};
const int LL_NORM[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                         2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};

struct Kind {
  const uint32_t* base;
  const uint8_t* bits;
  int default_log, max_code, max_log;
};

const uint8_t OF_BITS[32] = {0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,
                             11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
                             22, 23, 24, 25, 26, 27, 28, 29, 30, 31};

struct SeqCell {
  uint64_t base;
  int bits, nb, next;
};

struct SeqTable {
  std::vector<SeqCell> cells;
  int log = 0;
};

const Kind KINDS[3] = {{LL_BASE, LL_BITS, 6, 35, 9}, {OF_BASE, OF_BITS, 5, 31, 8},
                       {ML_BASE, ML_BITS, 6, 52, 9}};

SeqTable seq_table(const std::vector<int>& norm, int log, int kind) {
  SeqTable t;
  t.log = log;
  for (const FseCell& c : fse_table(norm, log))
    t.cells.push_back({KINDS[kind].base[c.sym], KINDS[kind].bits[c.sym], c.bits, c.base});
  return t;
}

const SeqTable* defaults() {
  static SeqTable tables[3];
  static bool ready = false;
  if (!ready) {
    std::vector<int> ll(LL_NORM, LL_NORM + 36), ml, of;
    ml = {1, 4, 3, 2, 2, 2, 2, 2, 2};
    ml.insert(ml.end(), 37, 1);
    ml.insert(ml.end(), 7, -1);
    of = {1, 1, 1, 1, 1, 1, 2, 2, 2};
    of.insert(of.end(), 15, 1);
    of.insert(of.end(), 5, -1);
    tables[0] = seq_table(ll, 6, 0);
    tables[1] = seq_table(of, 5, 1);
    tables[2] = seq_table(ml, 6, 2);
    ready = true;
  }
  return tables;
}

// ---- Huffman literals -----------------------------------------------------

std::vector<int> fse_weights(const uint8_t* src, int64_t start, int64_t size) {
  NCount nc = read_ncount(src, start, size, 255);
  if (nc.log > 6) fail(kTableLog);
  int64_t msv = int64_t(nc.norm.size()) - 1;
  int64_t need =
      (1 + (1 << nc.log)) + 1 + (2 * (msv + 1) + (1 << nc.log) + 8 + 3) / 4 + 128 + 1;
  if (need > 219) fail(kTableLog);
  std::vector<FseCell> table = fse_table(nc.norm, nc.log);
  Backward bits(src, start + nc.used, start + size);
  int states[2];
  states[0] = int(bits.read(nc.log));
  states[1] = int(bits.read(nc.log));
  if (bits.overflow()) fail(kCorrupt);
  std::vector<int> out;
  for (int i = 0;; i = 1 - i) {
    if (out.size() > 253) fail(kTooSmall);
    const FseCell& c = table[size_t(states[i])];
    out.push_back(c.sym);
    states[i] = c.base + int(bits.read(c.bits));
    if (bits.overflow()) {
      out.push_back(table[size_t(states[1 - i])].sym);
      return out;
    }
  }
}

// HUF_selectDecoder's timings: (table, per 256 symbols) of the one-symbol
// and the two-symbol decoder, by the quantised ratio of input to output
const uint32_t ALGO_TIME[16][4] = {
    {0, 0, 1, 1},         {0, 0, 1, 1},         {150, 216, 381, 119}, {170, 205, 514, 112},
    {177, 199, 539, 110}, {197, 194, 644, 107}, {221, 192, 735, 107}, {256, 189, 881, 106},
    {359, 188, 1167, 109}, {582, 187, 1570, 114}, {688, 187, 1712, 122}, {825, 186, 1965, 136},
    {976, 185, 2131, 150}, {1180, 186, 2070, 175}, {1377, 185, 1731, 202},
    {1412, 185, 1695, 202}};

bool two_symbol_decoder(int64_t count, int64_t csize) {
  int64_t q = csize >= count ? 15 : csize * 16 / count;
  const uint32_t* t = ALGO_TIME[q];
  uint64_t d = uint64_t(count) >> 8;
  uint64_t one = t[0] + t[1] * d, two = t[2] + t[3] * d;
  return two + (two >> 5) < one;
}

struct Pair {
  int bits, s1, s2;
  bool two;
};

struct Huffman {
  std::vector<uint16_t> table;  // code length << 8 | symbol, by the next `log` bits
  int log = 0, target = 11;
  bool two = false;
  bool valid = false;

  int nb(uint32_t v) const { return table[v] >> 8; }
  int sym(uint32_t v) const { return table[v] & 0xFF; }
  // the two-symbol decoder's entry of `target` bits
  Pair pair(uint64_t v) const {
    uint32_t a = uint32_t(v >> (target - log));
    int nb1 = nb(a), s1 = sym(a);
    uint32_t b = uint32_t(((v << nb1) >> (target - log)) & ((uint64_t(1) << log) - 1));
    if (nb1 + nb(b) <= target) return {nb1 + nb(b), s1, sym(b), true};
    return {nb1, s1, 0, false};
  }
};

// HUF_readStats and the table -> bytes read
int64_t huffman_table(const uint8_t* src, int64_t start, int64_t size, Huffman& h) {
  if (size < 1) fail(kSrcSize);
  int head = src[start];
  std::vector<int> weights;
  int64_t used;
  if (head >= 128) {
    int n = head - 127;
    used = (n + 1) / 2;
    if (used + 1 > size) fail(kSrcSize);
    if (n >= 256) fail(kCorrupt);
    for (int64_t k = 0; k < used; k++) {
      weights.push_back(src[start + 1 + k] >> 4);
      weights.push_back(src[start + 1 + k] & 15);
    }
    weights.resize(size_t(n));
  } else {
    used = head;
    if (used + 1 > size) fail(kSrcSize);
    weights = fse_weights(src, start + 1, used);
  }
  uint32_t total = 0;
  for (int w : weights) {
    if (w > 12) fail(kCorrupt);
    total += (1u << w) >> 1;
  }
  if (total == 0) fail(kCorrupt);
  int log = highbit(total) + 1;
  if (log > 12) fail(kCorrupt);
  uint32_t rest = (1u << log) - total;
  if (rest & (rest - 1)) fail(kCorrupt);
  weights.push_back(highbit(rest) + 1);
  int ones = 0;
  for (int w : weights) ones += w == 1;
  if (ones < 2 || ones & 1) fail(kCorrupt);
  h.table.assign(size_t(1) << log, 0);
  size_t at = 0;
  for (int w = 1; w <= log; w++) {
    size_t span = (size_t(1) << w) >> 1;
    for (size_t s = 0; s < weights.size(); s++)
      if (weights[s] == w) {
        std::fill_n(h.table.begin() + long(at), span, uint16_t((log + 1 - w) << 8 | int(s)));
        at += span;
      }
  }
  h.log = log;
  h.target = log <= 11 ? 11 : 12;
  h.valid = true;
  return used + 1;
}

// n symbols of one stream by libzstd's careful decoders (read to its last
// bit; the two-symbol decoder's rule for the last symbol)
void huffman_stream(const uint8_t* src, int64_t start, int64_t end, const Huffman& h, int64_t n,
                    std::vector<uint8_t>& out) {
  Backward bs(src, start, end);
  int64_t total = bs.total, used = 0;
  int64_t last = h.two && n ? n - 1 : n;
  for (int64_t i = 0; i < last; i++) {
    uint32_t v = uint32_t(bs.at(total - used - h.log, h.log));
    used += h.nb(v);
    out.push_back(uint8_t(h.sym(v)));
  }
  if (last < n) {
    if (used < total) {
      Pair p = h.pair(bs.at(total - used - h.target, h.target));
      out.push_back(uint8_t(p.s1));
      used = p.two ? std::min(used + p.bits, total) : used + p.bits;
    } else if (used == total) {
      uint64_t head = le(src + start, int(std::min<int64_t>(end - start, 8)));
      Pair p = h.pair(head >> (64 - h.target));
      out.push_back(uint8_t(p.s1));
      if (!p.two) used += p.bits;
    }
  }
  if (used != total) fail(kCorrupt);
}

enum { UNFINISHED, END_OF_BUFFER, COMPLETED, OVERFLOW };

// libzstd's BIT_DStream_t as its fast Huffman decoders hand a stream on
struct BitD {
  const uint8_t* src;
  int64_t start, ptr, limit;
  uint64_t container, consumed;

  BitD(const uint8_t* s, int64_t st, int64_t p, uint64_t c)
      : src(s), start(st), ptr(p), limit(st + 8), container(le(s + p, 8)), consumed(c) {}
  int reload() {
    if (consumed > 64) return OVERFLOW;
    if (ptr >= limit) {
      ptr -= int64_t(consumed >> 3);
      consumed &= 7;
      container = le(src + ptr, 8);
      return UNFINISHED;
    }
    if (ptr == start) return consumed < 64 ? END_OF_BUFFER : COMPLETED;
    int64_t nb = int64_t(consumed >> 3);
    int status = UNFINISHED;
    if (ptr - nb < start) {
      nb = ptr - start;
      status = END_OF_BUFFER;
    }
    ptr -= nb;
    consumed -= uint64_t(8 * nb);
    container = le(src + ptr, 8);
    return status;
  }
  uint64_t look(int n) const { return (container << (consumed & 63)) >> ((64 - n) & 63); }
};

void stream_x1(BitD& bd, const Huffman& h, uint8_t* out, int64_t p, int64_t end) {
  int shift = 11 - h.log;
  auto one = [&](int64_t at) {
    uint32_t v = uint32_t(bd.look(11) >> shift);
    bd.consumed += uint64_t(h.nb(v));
    out[at] = uint8_t(h.sym(v));
  };
  if (end - p > 3) {
    for (;;) {
      int status = bd.reload();
      if (!(status == UNFINISHED && p < end - 3)) break;
      for (int k = 0; k < 4; k++) one(p + k);
      p += 4;
    }
  } else {
    bd.reload();
  }
  for (; p < end; p++) one(p);
}

void stream_x2(BitD& bd, const Huffman& h, uint8_t* out, int64_t p, int64_t end) {
  auto two = [&](int64_t at) {
    Pair e = h.pair(bd.look(11));
    out[at] = uint8_t(e.s1);
    out[at + 1] = uint8_t(e.two ? e.s2 : 0);
    bd.consumed += uint64_t(e.bits);
    return at + 1 + e.two;
  };
  if (end - p >= 8) {
    for (;;) {
      int status = bd.reload();
      if (!(status == UNFINISHED && p < end - 9)) break;
      for (int k = 0; k < 5; k++) p = two(p);
    }
  } else {
    bd.reload();
  }
  if (end - p >= 2) {
    for (;;) {
      int status = bd.reload();
      if (!(status == UNFINISHED && p <= end - 2)) break;
      p = two(p);
    }
    while (p <= end - 2) p = two(p);
  }
  if (p < end) {
    Pair e = h.pair(bd.look(11));
    out[p] = uint8_t(e.s1);
    if (!e.two) {
      bd.consumed += uint64_t(e.bits);
    } else if (bd.consumed < 64) {
      bd.consumed = std::min<uint64_t>(bd.consumed + uint64_t(e.bits), 64);
    }
  }
}

uint64_t ctz64(uint64_t v) { return v ? uint64_t(__builtin_ctzll(v)) : 64; }

// HUF_decompress4X{1,2}_usingDTable_internal_fast; false where libzstd
// does not take it
bool fast_four(const uint8_t* src, int64_t start, int64_t size, int64_t count, const Huffman& h,
               const int64_t lens[4], std::vector<uint8_t>& lits) {
  int64_t seg = (count + 3) / 4;
  if (h.log > 11 || *std::min_element(lens, lens + 4) < 8 || 3 * seg >= count) return false;
  int64_t first[4], ends[4], ip[4], op[4], oend[4];
  uint64_t bits[4];
  first[0] = start + 6;
  for (int k = 1; k < 4; k++) first[k] = first[k - 1] + lens[k - 1];
  for (int k = 0; k < 4; k++) {
    ends[k] = k < 3 ? first[k + 1] : start + size;
    ip[k] = ends[k] - 8;
    op[k] = k * seg;
    oend[k] = k < 3 ? (k + 1) * seg : count;
    uint8_t last = src[ends[k] - 1];
    bits[k] = (le(src + ends[k] - 8, 8) | 1) << (last ? 8 - highbit(last) : 0);
  }
  std::vector<uint8_t> out(size_t(count) + 1, 0);
  int shift = 11 - h.log;
  for (;;) {
    int64_t iters;
    if (h.two) {
      iters = (ip[0] - start) / 7;
      for (int k = 0; k < 4; k++) iters = std::min(iters, (oend[k] - op[k]) / 10);
    } else {
      iters = std::min((count - op[3]) / 5, (ip[0] - start) / 7);
    }
    int64_t olimit = op[3] + 5 * iters;
    if (op[3] == olimit || ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    do {
      for (int k = 0; k < 4; k++) {
        uint64_t b = bits[k];
        int64_t o = op[k];
        for (int r = 0; r < 5; r++) {
          int nb;
          if (h.two) {
            Pair e = h.pair(b >> 53);
            out[size_t(o)] = uint8_t(e.s1);
            if (e.two) out[size_t(o + 1)] = uint8_t(e.s2);
            o += 1 + e.two;
            nb = e.bits;
          } else {
            uint32_t v = uint32_t((b >> 53) >> shift);
            out[size_t(o++)] = uint8_t(h.sym(v));
            nb = h.nb(v);
          }
          b <<= nb;
        }
        uint64_t c = ctz64(b);
        ip[k] -= int64_t(c >> 3);
        bits[k] = (le(src + ip[k], 8) | 1) << (c & 7);
        op[k] = o;
      }
    } while (op[3] < olimit);
  }
  for (int k = 0; k < 4; k++) {
    if (op[k] > oend[k] || ip[k] < first[k] - 8) fail(kCorrupt);
    BitD bd(src, start, ip[k], ctz64(bits[k]));
    if (h.two) {
      stream_x2(bd, h, out.data(), op[k], oend[k]);
    } else {
      stream_x1(bd, h, out.data(), op[k], oend[k]);
    }
  }
  lits.assign(out.begin(), out.begin() + count);
  return true;
}

void huffman_literals(const uint8_t* src, int64_t start, int64_t size, int64_t count, bool four,
                      const Huffman& h, std::vector<uint8_t>& lits) {
  lits.clear();
  if (!four) {
    huffman_stream(src, start, start + size, h, count, lits);
    return;
  }
  if (size < 10 || count < 6) fail(kCorrupt);
  int64_t lens[4];
  for (int i = 0; i < 3; i++) lens[i] = int64_t(le(src + start + 2 * i, 2));
  lens[3] = size - (lens[0] + lens[1] + lens[2] + 6);
  if (lens[3] < 0) fail(kCorrupt);
  if (fast_four(src, start, size, count, h, lens, lits)) return;
  int64_t at = start + 6;
  for (int64_t ln : lens) {
    if (ln < 1) fail(kSrcSize);
    if (!src[at + ln - 1]) fail(kCorrupt);
    at += ln;
  }
  int64_t seg = (count + 3) / 4;
  at = start + 6;
  for (int i = 0; i < 4; i++) {
    huffman_stream(src, at, at + lens[i], h, i < 3 ? seg : count - 3 * seg, lits);
    at += lens[i];
  }
}

// ---- the frame --------------------------------------------------------------

enum Where { IN_SRC, IN_EXTRA, IN_MEM, SPLIT };

struct Frame {
  const uint8_t* d;
  int64_t n, size;
  std::vector<uint8_t> out, mem, extra = std::vector<uint8_t>(size_t(kLitExtra), 0);
  uint64_t reps[3] = {1, 4, 8};
  Huffman huf;
  const SeqTable* tables[3] = {nullptr, nullptr, nullptr};
  SeqTable own[3];
  bool fse_entropy = false;
  bool checksum = false;
  int64_t fcs = kUnknown, block_max = 0, window = 0, ring = 0;
  uint64_t dict_id = 0;
  int64_t seg_start = 0, ext_lo = 0, ext_hi = 0;
  bool has_ext = false;
  // the literals: where, and [lp, lend) there
  int lit_where = IN_EXTRA;
  int64_t lit_at = 0, lp = 0, lend = 0;
  std::vector<uint8_t> scratch;

  Frame(const uint8_t* data, int64_t len, int64_t sz) : d(data), n(len), size(sz) {}

  void grow(int64_t to) {
    if (int64_t(mem.size()) < to) mem.resize(size_t(to), 0);
  }
  void put(int64_t at, const uint8_t* p, int64_t len) {
    grow(at + len);
    copy_bytes(mem.data() + at, p, len);
  }

  int64_t header() {
    if (n < 5) {
      uint8_t m[4], k[4];
      for (int i = 0; i < 4; i++) {
        m[i] = i < n ? d[i] : uint8_t(kMagic >> (8 * i));
        k[i] = i < n ? d[i] : uint8_t(kSkippable >> (8 * i));
      }
      if (le(m, 4) != kMagic && (le(k, 4) & 0xFFFFFFF0u) != kSkippable)
        fail("Unknown frame descriptor");
      fail("Not enough data");
    }
    uint32_t magic = uint32_t(le(d, 4));
    if (magic != kMagic) {
      if ((magic & 0xFFFFFFF0u) == kSkippable)
        fail("Not enough data (a skippable frame ends the loop)");
      if (magic >= 0xFD2FB525u && magic <= 0xFD2FB527u) fail("Unsupported frame (legacy format)");
      fail("Unknown frame descriptor");
    }
    int fhd = d[4];
    int single = fhd >> 5 & 1;
    checksum = fhd >> 2 & 1;
    const int did_sizes[4] = {0, 1, 2, 4}, fcs_sizes[4] = {single, 2, 4, 8};
    int did_size = did_sizes[fhd & 3], fcs_size = fcs_sizes[fhd >> 6];
    int64_t hsize = 5 + !single + did_size + fcs_size;
    if (n < hsize) {
      if (fhd & 8) fail("Unsupported frame parameter");
      fail("Not enough data");
    }
    if (fhd & 8) fail("Unsupported frame parameter");
    int64_t pos = 5;
    if (!single) {
      int wd = d[pos++];
      int wlog = (wd >> 3) + 10;
      if (wlog > 31) fail("Frame requires too much memory for decoding");
      window = int64_t(1) << wlog;
      window += (window >> 3) * (wd & 7);
    }
    dict_id = le(d + pos, did_size);
    pos += did_size;
    if (fcs_size) {
      uint64_t v = le(d + pos, fcs_size) + (fcs_size == 2 ? 256 : 0);
      // a content size past what a strip can hold never fits it: keep it large
      fcs = v > (uint64_t(1) << 62) ? int64_t(1) << 62 : int64_t(v);
      pos += fcs_size;
    }
    if (single) window = fcs;
    block_max = std::min(window, kBlockMax);
    return pos;
  }

  std::vector<uint8_t> run() {
    int64_t pos = header();
    if (fcs != kUnknown && size >= fcs && whole(pos)) return single_pass(pos);
    if (dict_id) fail("Dictionary mismatch");
    int64_t w = std::max<int64_t>(window, 1 << 10);
    if (w > kWindowLimit) fail("Frame requires too much memory for decoding");
    int64_t block = std::min(std::min(w, kBlockMax), block_max);
    int64_t r = w + 2 * block + 2 * kWild;
    ring = fcs == kUnknown ? r : std::min(fcs, r);
    return streaming(pos);
  }

  bool whole(int64_t pos) const {
    for (;;) {
      if (n - pos < 3) return false;
      uint32_t head = uint32_t(le(d + pos, 3));
      int kind = head >> 1 & 3;
      if (kind == 3) return false;
      int64_t csize = kind == 1 ? 1 : head >> 3;
      if (3 + csize > n - pos) return false;
      pos += 3 + csize;
      if (head & 1) break;
    }
    return !checksum || n - pos >= 4;
  }

  std::vector<uint8_t> single_pass(int64_t pos) {
    if (dict_id) fail("Dictionary mismatch");
    seg_start = 0;
    has_ext = false;
    int64_t op = 0;
    for (;;) {
      uint32_t head = uint32_t(le(d + pos, 3));
      int last = head & 1, kind = head >> 1 & 3;
      int64_t csize = head >> 3;
      pos += 3;
      int64_t cap = size - op;
      if (kind == 2) {
        if (csize > block_max) fail(kSrcSize);
        op += block(pos, pos + csize, op, cap, false);
      } else {
        if (csize > cap) fail(kTooSmall);
        if (kind == 0) {
          put(op, d + pos, csize);
        } else {
          grow(op + csize);
          set_bytes(mem.data() + op, d[pos], csize);
        }
        op += csize;
      }
      pos += kind == 1 ? 1 : csize;
      if (last) break;
    }
    if (op != fcs) fail(kCorrupt);
    if (checksum && (xxh64(mem.data(), op) & 0xFFFFFFFFu) != le(d + pos, 4))
      fail("Restored data doesn't match checksum");
    if (op < size) {
      out.assign(mem.begin(), mem.begin() + op);
      throw Fail{short_by(size - op), op};
    }
    return std::vector<uint8_t>(mem.begin(), mem.begin() + op);
  }

  static std::string short_by(int64_t k) {
    char buf[96];
    std::snprintf(buf, sizeof buf, "Not enough data (short %lld bytes)", (long long)k);
    return buf;
  }

  std::vector<uint8_t> result() {
    if (int64_t(out.size()) < size)
      throw Fail{short_by(size - int64_t(out.size())), int64_t(out.size())};
    out.resize(size_t(size));
    return out;
  }

  bool flush(int64_t start, int64_t got) {
    int64_t room = size - int64_t(out.size());
    int64_t k = std::min(got, room);
    out.insert(out.end(), mem.begin() + start, mem.begin() + start + k);
    return got > room;
  }

  std::vector<uint8_t> end_of_frame(int64_t pos, const std::vector<uint8_t>& hashed) {
    if (checksum) {
      if (n - pos < 4) return result();
      if ((xxh64(hashed.data(), int64_t(hashed.size())) & 0xFFFFFFFFu) != le(d + pos, 4))
        fail("Restored data doesn't match checksum");
    }
    return result();
  }

  std::vector<uint8_t> streaming(int64_t pos) {
    int64_t start = 0, prev_end = 0, decoded = 0;
    seg_start = 0;
    has_ext = false;
    std::vector<uint8_t> hashed;
    for (;;) {
      if (n - pos < 3) break;
      uint32_t head = uint32_t(le(d + pos, 3));
      int last = head & 1, kind = head >> 1 & 3;
      if (kind == 3) fail(kCorrupt);
      int64_t csize = kind == 1 ? 1 : head >> 3;
      if (csize > block_max) fail(kCorrupt);
      pos += 3;
      if (start != prev_end) {
        has_ext = true;
        ext_lo = seg_start;
        ext_hi = prev_end;
        seg_start = prev_end = start;
      }
      if (csize == 0) {
        if (last) return end_of_frame(pos, hashed);
        continue;
      }
      int64_t cap = ring - start, got;
      if (kind == 0) {
        int64_t take = std::min(csize, n - pos);
        if (take < 1) break;
        if (take > cap) fail(kTooSmall);
        put(start, d + pos, take);
        pos += take;
        got = take;
        if (take < csize) {
          flush(start, got);
          break;
        }
      } else if (n - pos < csize) {
        break;
      } else if (kind == 1) {
        got = head >> 3;
        if (got > cap) fail(kTooSmall);
        grow(start + got);
        set_bytes(mem.data() + start, d[pos], got);
        pos += 1;
      } else {
        got = block(pos, pos + csize, start, cap, true);
        pos += csize;
      }
      if (got > block_max) fail(kCorrupt);
      decoded += got;
      if (checksum) hashed.insert(hashed.end(), mem.begin() + start, mem.begin() + start + got);
      prev_end = start + got;
      if (last && fcs != kUnknown && decoded != fcs) fail(kCorrupt);
      if (got) {
        bool full = flush(start, got);
        start += got;
        if (full) break;
        bool wraps = fcs == kUnknown || ring < fcs;
        if (wraps && start + block_max > ring) start = 0;
      }
      if (last) return end_of_frame(pos, hashed);
    }
    return result();
  }

  // a compressed block into mem at dst with cap bytes of room -> its size
  int64_t block(int64_t pos, int64_t end, int64_t dst, int64_t cap, bool streaming) {
    if (end - pos > block_max) fail(kSrcSize);
    pos += literals(pos, end, dst, cap, streaming);
    int64_t nseq = 0;
    pos = seq_headers(pos, end, nseq);
    return sequences(pos, end, nseq, dst, cap);
  }

  void lit_place(int64_t dst, int64_t cap, int64_t count, bool streaming, bool split_now) {
    if (!streaming && cap > block_max + kWild + count + kWild) {
      lit_where = IN_MEM;
      lit_at = dst + block_max + kWild;
    } else if (count <= kLitExtra) {
      lit_where = IN_EXTRA;
    } else {
      int64_t e = std::min(block_max, cap);
      lit_where = SPLIT;
      lit_at = dst + e - count + (split_now ? kLitExtra - kWild : 0);
    }
  }

  void lit_store(const uint8_t* lits, int64_t count, int64_t dst, int64_t cap, bool split_now) {
    if (lit_where == IN_EXTRA) {
      copy_bytes(extra.data(), lits, count);
      lp = 0;
      lend = count;
    } else if (lit_where == IN_MEM) {
      put(lit_at, lits, count);
      lp = lit_at;
      lend = lit_at + count;
    } else {
      int64_t e = std::min(block_max, cap), at;
      if (!split_now) {
        put(dst + e - count, lits, count);
        at = dst + e - count + kLitExtra - kWild;
      } else {
        at = lit_at;
      }
      put(at, lits, count - kLitExtra);
      copy_bytes(extra.data(), lits + count - kLitExtra, kLitExtra);
      lp = at;
      lend = at + count - kLitExtra;
    }
  }

  int64_t literals(int64_t pos, int64_t end, int64_t dst, int64_t cap, bool streaming) {
    int64_t size = end - pos;
    if (size < 2) fail(kCorrupt);
    int b0 = d[pos], kind = b0 & 3, code = b0 >> 2 & 3;
    int64_t expect = std::min(block_max, cap);
    if (kind >= 2) {
      if (kind == 3 && !huf.valid) fail("Dictionary is corrupted");
      if (size < 5) fail(kCorrupt);
      uint64_t lhc = le(d + pos, 4);
      int64_t hsize, count, csize;
      if (code < 2) {
        hsize = 3;
        count = int64_t(lhc >> 4 & 0x3FF);
        csize = int64_t(lhc >> 14 & 0x3FF);
      } else if (code == 2) {
        hsize = 4;
        count = int64_t(lhc >> 4 & 0x3FFF);
        csize = int64_t(lhc >> 18);
      } else {
        hsize = 5;
        count = int64_t(lhc >> 4 & 0x3FFFF);
        csize = int64_t(lhc >> 22) + (int64_t(d[pos + 4]) << 10);
      }
      bool four = code != 0;
      if (count > block_max) fail(kCorrupt);
      if (four && count < 6)
        fail("Header of Literals' block doesn't respect format specification");
      if (csize + hsize > size) fail(kCorrupt);
      if (expect < count) fail(kTooSmall);
      lit_place(dst, cap, count, streaming, false);
      int64_t at = pos + hsize, section = hsize + csize;
      if (kind == 2) {
        Huffman h;
        int64_t used = huffman_table(d, at, csize, h);
        if (used >= csize) fail(kCorrupt);
        h.two = four && two_symbol_decoder(count, csize);
        huf = h;
        at += used;
        csize -= used;
      }
      huffman_literals(d, at, csize, count, four, huf, scratch);
      lit_store(scratch.data(), count, dst, cap, false);
      lit_src = lit_where == IN_EXTRA ? 1 : 2;
      return section;
    }
    int64_t hsize, count;
    if (code == 1) {
      if (kind == 1 && size < 3) fail(kCorrupt);
      hsize = 2;
      count = int64_t(le(d + pos, 2) >> 4);
    } else if (code == 3) {
      if (size < 3 + kind) fail(kCorrupt);
      hsize = 3;
      count = int64_t(le(d + pos, 3) >> 4);
    } else {
      hsize = 1;
      count = b0 >> 3;
    }
    if (count > block_max) fail(kCorrupt);
    if (expect < count) fail(kTooSmall);
    lit_place(dst, cap, count, streaming, true);
    if (kind == 0) {
      if (hsize + count + kWild > size) {
        if (count + hsize > size) fail(kCorrupt);
        lit_store(d + pos + hsize, count, dst, cap, true);
        lit_src = lit_where == IN_EXTRA ? 1 : 2;
      } else {
        lit_src = 0;  // read in place from the block
        lp = pos + hsize;
        lend = pos + hsize + count;
      }
      return hsize + count;
    }
    scratch.assign(size_t(count), d[pos + hsize]);
    lit_store(scratch.data(), count, dst, cap, true);
    lit_src = lit_where == IN_EXTRA ? 1 : 2;
    return hsize + 1;
  }
  int lit_src = 1;  // 0: the block, 1: the extra buffer, 2: mem (IN_MEM or SPLIT)

  int64_t seq_headers(int64_t pos, int64_t end, int64_t& nseq) {
    if (end - pos < 1) fail(kSrcSize);
    nseq = d[pos++];
    if (nseq > 0x7F) {
      if (nseq == 0xFF) {
        if (pos + 2 > end) fail(kSrcSize);
        nseq = int64_t(le(d + pos, 2)) + 0x7F00;
        pos += 2;
      } else {
        if (pos >= end) fail(kSrcSize);
        nseq = ((nseq - 0x80) << 8) + d[pos++];
      }
    }
    if (nseq == 0) {
      if (pos != end) fail(kCorrupt);
      return pos;
    }
    if (pos + 1 > end) fail(kSrcSize);
    int modes = d[pos];
    if (modes & 3) fail(kCorrupt);
    pos++;
    const int mode_of[3] = {modes >> 6, modes >> 4 & 3, modes >> 2 & 3};
    for (int kind = 0; kind < 3; kind++) {
      const Kind& k = KINDS[kind];
      int mode = mode_of[kind];
      if (mode == 0) {
        tables[kind] = &defaults()[kind];
      } else if (mode == 1) {
        if (pos >= end) fail(kCorrupt);
        int s = d[pos];
        if (s > k.max_code) fail(kCorrupt);
        own[kind].log = 0;
        own[kind].cells.assign(1, {k.base[s], k.bits[s], 0, 0});
        tables[kind] = &own[kind];
        pos++;
      } else if (mode == 2) {
        NCount nc;
        try {
          nc = read_ncount(d, pos, end - pos, k.max_code);
        } catch (const Fail&) {
          fail(kCorrupt);
        }
        if (nc.log > k.max_log) fail(kCorrupt);
        own[kind] = seq_table(nc.norm, nc.log, kind);
        tables[kind] = &own[kind];
        pos += nc.used;
      } else if (!fse_entropy) {
        fail(kCorrupt);
      }
    }
    return pos;
  }

  void match(int64_t op, uint64_t off, int64_t ml) {
    int64_t prefix = op - seg_start, ext_len = has_ext ? ext_hi - ext_lo : 0;
    int64_t src;
    if (off > uint64_t(prefix)) {
      if (off > uint64_t(prefix + ext_len)) fail(kCorrupt);
      int64_t m = ext_hi - (int64_t(off) - prefix);
      if (m + ml <= ext_hi) {
        copy_bytes(mem.data() + op, mem.data() + m, ml);
        return;
      }
      int64_t k = ext_hi - m;
      copy_bytes(mem.data() + op, mem.data() + m, k);
      op += k;
      ml -= k;
      src = seg_start;
    } else {
      src = op - int64_t(off);
    }
    if (src + ml <= op) {
      copy_bytes(mem.data() + op, mem.data() + src, ml);
    } else {
      for (int64_t i = 0; i < ml; i++) mem[size_t(op + i)] = mem[size_t(src + i)];
    }
  }

  const uint8_t* lit_base() const {
    return lit_src == 0 ? d : lit_src == 1 ? extra.data() : mem.data();
  }

  int64_t sequences(int64_t pos, int64_t end, int64_t nseq, int64_t dst, int64_t cap) {
    bool split = lit_src == 2 && lit_where == SPLIT;
    int64_t oend = dst + cap;
    if (lit_src == 2 && lit_where == IN_MEM) oend = lit_at;
    grow(oend);
    int64_t op = dst;
    int src_kind = lit_src;  // which buffer lp/lend index
    auto lits = [&]() -> const uint8_t* {
      return src_kind == 0 ? d : src_kind == 1 ? extra.data() : mem.data();
    };
    if (nseq) {
      fse_entropy = true;
      uint64_t r[3] = {reps[0], reps[1], reps[2]};
      Backward bits(d, pos, end);
      const SeqTable &llt = *tables[0], &oft = *tables[1], &mlt = *tables[2];
      int64_t ll_s = int64_t(bits.read(llt.log)), of_s = int64_t(bits.read(oft.log)),
              ml_s = int64_t(bits.read(mlt.log));
      bool in_dst_part = split;
      for (int64_t k = nseq; k > 0; k--) {
        const SeqCell &lc = llt.cells[size_t(ll_s)], &oc = oft.cells[size_t(of_s)],
                      &mc = mlt.cells[size_t(ml_s)];
        uint64_t off;
        if (oc.bits > 1) {
          off = oc.base + bits.read(oc.bits);
          r[2] = r[1];
          r[1] = r[0];
          r[0] = off;
        } else {
          int ll0 = lc.base == 0;
          if (oc.bits == 0) {
            off = r[ll0];
            r[1] = r[!ll0];
            r[0] = off;
          } else {
            uint64_t idx = oc.base + uint64_t(ll0) + bits.read(1);
            uint64_t t = idx == 3 ? r[0] - 1 : r[idx];
            if (t == 0) t = ~uint64_t(0);  // 0 is corruption
            if (idx != 1) r[2] = r[1];
            r[1] = r[0];
            r[0] = off = t;
          }
        }
        int64_t ml = int64_t(mc.base + bits.read(mc.bits));
        int64_t ll = int64_t(lc.base + bits.read(lc.bits));
        if (k > 1) {
          ll_s = lc.next + int64_t(bits.read(lc.nb));
          ml_s = mc.next + int64_t(bits.read(mc.nb));
          of_s = oc.next + int64_t(bits.read(oc.nb));
        }
        if (in_dst_part) {
          if (lp + ll > lend) {  // the literals run into the extra buffer
            int64_t left = lend - lp;
            if (left) {
              if (left > oend - op) fail(kTooSmall);
              for (int64_t i = 0; i < left; i++) mem[size_t(op + i)] = mem[size_t(lp + i)];
              ll -= left;
              op += left;
            }
            in_dst_part = false;
            src_kind = 1;
            lp = 0;
            lend = kLitExtra;
          } else {
            if (op + ll + ml > lp + ll - kWild) {  // the careful path
              if (ll + ml > oend - op) fail(kTooSmall);
              if (lp < op && op < lp + ll) fail(kTooSmall);
              for (int64_t i = 0; i < ll; i++) mem[size_t(op + i)] = mem[size_t(lp + i)];
            } else {
              copy_bytes(mem.data() + op, mem.data() + lp, ll);
            }
            lp += ll;
            op += ll;
            match(op, off, ml);
            op += ml;
            continue;
          }
        }
        if (ll + ml > oend - op) fail(kTooSmall);
        if (ll > lend - lp) fail(kCorrupt);
        copy_bytes(mem.data() + op, lits() + lp, ll);
        lp += ll;
        op += ll;
        match(op, off, ml);
        op += ml;
      }
      if (bits.used != bits.total) fail(kCorrupt);
      std::copy(r, r + 3, reps);
      if (split && in_dst_part) {
        int64_t left = lend - lp;
        if (left > oend - op) fail(kTooSmall);
        copy_bytes(mem.data() + op, mem.data() + lp, left);
        op += left;
        src_kind = 1;
        lp = 0;
        lend = kLitExtra;
      }
    } else if (split) {
      int64_t left = lend - lp;
      if (left > oend - op) fail(kTooSmall);
      copy_bytes(mem.data() + op, mem.data() + lp, left);
      op += left;
      src_kind = 1;
      lp = 0;
      lend = kLitExtra;
    }
    int64_t left = lend - lp;
    if (left > oend - op) fail(kTooSmall);
    copy_bytes(mem.data() + op, lits() + lp, left);
    op += left;
    return op - dst;
  }
};

}  // namespace

extern "C" {

// One strip or tile of `n` bytes -> `size` bytes in `out` (returns size),
// or -1 with libzstd's or libtiff's reason in `reason` and in `out` the
// `*kept` bytes libtiff keeps (io/zstd.ZstdError.kept).
int64_t gst_zstd_decode(const uint8_t* data, int64_t n, int64_t size, uint8_t* out, char* reason,
                        int64_t reason_len, int64_t* kept) {
  Frame f(data, n, size);
  *kept = 0;
  try {
    std::vector<uint8_t> got = f.run();
    copy_bytes(out, got.data(), size);
    return size;
  } catch (const Fail& e) {
    std::snprintf(reason, size_t(reason_len), "%s", e.reason.c_str());
    *kept = std::min<int64_t>(e.kept, size);
    if (*kept) copy_bytes(out, f.out.data(), *kept);
    return -1;
  } catch (const std::bad_alloc&) {
    std::snprintf(reason, size_t(reason_len), "%s", "out of memory");
    return -1;
  }
}

}  // extern "C"
