// Native byte loops of the texture decoders: PNG's row unfilter, the LZW
// decoder of GIF and TIFF, PSD's PackBits rows, SGI's and PCX's run-length
// rows, QOI's ops, TIFF's CCITT fax decoder, DDS's BC6H blocks, SUN's, MSP's
// and ICNS's run-length rows and FLI's frame chunks.  Each is the C++ twin
// of a Python loop that stays as its plain version (io/png.py's
// unfilter_python, io/lzw.py's decode_lzw_python, io/psd.py's
// packbits_rows_python, io/sgi.py's rle_rows_python, io/pcx.py's
// rle_lines_python, io/qoi.py's decode_ops_python, io/ccitt.py's
// decode_fax_python, io/dds.py's bc6h_python, io/sun.py's rle_rows_python,
// io/msp.py's rle_rows_python, io/icns.py's rle_channels_python, io/fli.py's
// frame_python) and gives the same bytes and
// the same status for every input, broken ones included.  Plain C ABI for
// ctypes; the caller owns every buffer.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// -- CCITT fax: libtiff's tif_fax3.c state machine (io/ccitt.py's _Decoder) --

enum { S_NULL, S_PASS, S_HORIZ, S_V0, S_VR, S_VL, S_EXT, S_TERMW, S_TERMB, S_MAKEUPW,
       S_MAKEUPB, S_MAKEUP, S_EOL };
struct FaxEof {};
struct FaxFail {};

struct Fax {
    const uint8_t* data;
    int64_t cp, ep;
    bool lsb_first;
    uint32_t acc = 0;
    int avail = 0;
    uint32_t* runs;
    int64_t nruns, thisrun = 0, refruns = 0, pa = 0, pb = 0;
    int32_t lastx, a0 = 0, run = 0, b1 = 0;
    int eolcnt = 0;
    const int32_t *mainT, *whiteT, *blackT;  // (state, width, param) per lookup

    uint32_t byte() {
        uint32_t b = data[cp++], r = 0;
        if (lsb_first) return b;
        for (int i = 0; i < 8; ++i) r |= ((b >> i) & 1u) << (7 - i);
        return r;
    }
    void need8(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) throw FaxEof();
                avail = n;
            } else {
                acc |= byte() << avail;
                avail += 8;
            }
        }
    }
    void need16(int n) {
        if (avail < n) {
            if (cp >= ep) {
                if (avail == 0) throw FaxEof();
                avail = n;
            } else {
                acc |= byte() << avail;
                avail += 8;
                if (avail < n) {
                    if (cp >= ep) {
                        avail = n;
                    } else {
                        acc |= byte() << avail;
                        avail += 8;
                    }
                }
            }
        }
    }
    uint32_t get(int n) const { return acc & ((1u << n) - 1); }
    void clr(int n) {
        avail -= n;
        acc >>= n;
    }
    const int32_t* lookup(const int32_t* table, int width, bool wide) {
        if (wide) need16(width); else need8(width);
        const int32_t* e = table + 3 * (acc & ((1u << width) - 1));
        clr(e[1]);
        return e;
    }
    static int32_t add(int32_t a, int64_t b) {
        return static_cast<int32_t>(static_cast<uint32_t>(static_cast<int64_t>(a) + b));
    }
    void setvalue(int64_t x) {
        if (pa >= thisrun + nruns) throw FaxFail();
        runs[pa++] = static_cast<uint32_t>(run + x);
        a0 = add(a0, x);
        run = 0;
    }
    void cleanup() {
        if (run) setvalue(0);
        if (a0 != lastx) {
            while (a0 > lastx && pa > thisrun) {
                --pa;
                a0 = add(a0, -static_cast<int64_t>(runs[pa]));
            }
            if (a0 < lastx) {
                if (a0 < 0) a0 = 0;
                if ((pa - thisrun) & 1) setvalue(0);
                setvalue(static_cast<int64_t>(lastx) - a0);
            } else if (a0 > lastx) {
                setvalue(lastx);
                setvalue(0);
            }
        }
    }
    void sync_eol() {
        if (eolcnt == 0) {
            for (;;) {
                need16(11);
                if (get(11) == 0) break;
                clr(1);
            }
        }
        for (;;) {
            need8(8);
            if (get(8)) break;
            clr(8);
        }
        while (get(1) == 0) clr(1);
        clr(1);
        eolcnt = 0;
    }
    bool colour(const int32_t* table, int width, int term) {
        for (;;) {
            const int32_t* e = lookup(table, width, true);
            int state = e[0], param = e[2];
            if (state == term) {
                setvalue(param);
                return true;
            }
            if ((state == S_MAKEUPW || state == S_MAKEUPB || state == S_MAKEUP)
                && state != (term == S_TERMW ? S_MAKEUPB : S_MAKEUPW)) {
                a0 = add(a0, param);
                run = add(run, param);
                continue;
            }
            if (state == S_EOL) eolcnt = 1;
            return false;
        }
    }
    bool expand1d() {
        try {
            for (;;) {
                if (!colour(whiteT, 12, S_TERMW) || a0 >= lastx) break;
                if (!colour(blackT, 13, S_TERMB) || a0 >= lastx) break;
                if (runs[pa - 1] == 0 && runs[pa - 2] == 0) pa -= 2;
            }
        } catch (const FaxEof&) {
            cleanup();
            return false;
        }
        cleanup();
        return true;
    }
    void check_b1() {
        if (pa != thisrun) {
            while (b1 <= a0 && b1 < lastx) {
                if (pb + 1 >= refruns + nruns) throw FaxFail();
                b1 = add(b1, static_cast<int64_t>(runs[pb]) + runs[pb + 1]);
                pb += 2;
            }
        }
    }
    void next_b() {
        if (pb >= refruns + nruns) throw FaxFail();
        b1 = add(b1, runs[pb++]);
    }
    bool expand2d() {
        try {
            bool broke = false;
            while (a0 < lastx) {
                if (pa >= thisrun + nruns) throw FaxFail();
                const int32_t* e = lookup(mainT, 7, false);
                int state = e[0], param = e[2];
                if (state == S_PASS) {
                    check_b1();
                    next_b();
                    run = add(run, static_cast<int64_t>(b1) - a0);
                    a0 = b1;
                    next_b();
                } else if (state == S_HORIZ) {
                    bool ok = ((pa - thisrun) & 1)
                        ? colour(blackT, 13, S_TERMB) && colour(whiteT, 12, S_TERMW)
                        : colour(whiteT, 12, S_TERMW) && colour(blackT, 13, S_TERMB);
                    if (!ok) {
                        eolcnt = 0;
                        broke = true;
                        break;
                    }
                    check_b1();
                } else if (state == S_V0) {
                    check_b1();
                    setvalue(static_cast<int64_t>(b1) - a0);
                    next_b();
                } else if (state == S_VR) {
                    check_b1();
                    setvalue(static_cast<int64_t>(b1) - a0 + param);
                    next_b();
                } else if (state == S_VL) {
                    check_b1();
                    if (b1 < add(a0, param)) {
                        broke = true;
                        break;
                    }
                    setvalue(static_cast<int64_t>(b1) - a0 - param);
                    if (pb == 0) throw FaxFail();
                    --pb;
                    b1 = add(b1, -static_cast<int64_t>(runs[pb]));
                } else if (state == S_EXT) {
                    runs[pa++] = static_cast<uint32_t>(static_cast<int64_t>(lastx) - a0);
                    broke = true;
                    break;
                } else if (state == S_EOL) {
                    runs[pa++] = static_cast<uint32_t>(static_cast<int64_t>(lastx) - a0);
                    need8(4);
                    clr(4);
                    eolcnt = 1;
                    broke = true;
                    break;
                } else {
                    broke = true;
                    break;
                }
            }
            if (!broke && run) {
                if (static_cast<int64_t>(run) + a0 < lastx) {
                    need8(1);
                    if (!get(1)) {
                        cleanup();
                        return true;
                    }
                    clr(1);
                }
                setvalue(0);
            }
        } catch (const FaxEof&) {
            cleanup();
            return false;
        }
        cleanup();
        return true;
    }
    void fill(uint8_t* row) {
        int64_t erun = pa;
        if ((erun - thisrun) & 1) runs[erun++] = 0;
        int64_t x = 0;
        for (int64_t k = thisrun; k < erun; k += 2) {
            for (int j = 0; j < 2; ++j) {
                int64_t r = runs[k + j];
                if (x + r > lastx || r > lastx) {
                    r = lastx - x;
                    runs[k + j] = static_cast<uint32_t>(r);
                }
                for (int64_t i = x; i < x + r; ++i) {
                    uint8_t bit = static_cast<uint8_t>(0x80 >> (i & 7));
                    if (j) row[i >> 3] |= bit; else row[i >> 3] &= static_cast<uint8_t>(~bit);
                }
                x += r;
            }
        }
    }
    void start_row() {
        a0 = run = 0;
        pa = thisrun;
    }
};

// -- BC6H (io/dds.py's bc6h_python) --

int64_t sext(int64_t v, int n) { return (v & (int64_t{1} << (n - 1))) ? v - (int64_t{1} << n) : v; }

int64_t bc6_unquantize(int64_t v, int n, bool is_signed) {
    if (!is_signed) {
        if (n >= 15) return v;
        if (v == 0) return 0;
        if (v == (int64_t{1} << n) - 1) return 0xFFFF;
        return ((v << 16) + 0x8000) >> n;
    }
    if (n >= 16) return v;
    int64_t a = v < 0 ? -v : v, u;
    if (a == 0) u = 0;
    else if (a >= (int64_t{1} << (n - 1)) - 1) u = 0x7FFF;
    else u = ((a << 15) + 0x4000) >> (n - 1);
    return v < 0 ? -u : u;
}

float half_to_float(uint32_t h) {
    int e = (h >> 10) & 31, m = h & 1023;
    float f = e == 0 ? std::ldexp(static_cast<float>(m), -24)
            : e == 31 ? (m ? NAN : INFINITY)
            : std::ldexp(static_cast<float>(1024 + m), e - 25);
    return (h & 0x8000) ? -f : f;
}


inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

}  // namespace

extern "C" {

// ``h`` filtered rows of ``stride + 1`` bytes (the filter type first) at
// ``src`` -> ``h`` raw rows of ``stride`` bytes at ``dst``.  Returns -1, or
// the first filter type that is not 0-4 (its row is left unfilled).
int gst_png_unfilter(const uint8_t* src, uint8_t* dst, int64_t h, int64_t stride,
                     int64_t bpp) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* in = src + y * (stride + 1);
        uint8_t* out = dst + y * stride;
        int ftype = in[0];
        ++in;
        switch (ftype) {
            case 0:
                for (int64_t x = 0; x < stride; ++x) out[x] = in[x];
                break;
            case 1:
                for (int64_t x = 0; x < stride; ++x)
                    out[x] = static_cast<uint8_t>(in[x] + (x >= bpp ? out[x - bpp] : 0));
                break;
            case 2:
                for (int64_t x = 0; x < stride; ++x)
                    out[x] = static_cast<uint8_t>(in[x] + (prev ? prev[x] : 0));
                break;
            case 3:
                for (int64_t x = 0; x < stride; ++x) {
                    int left = x >= bpp ? out[x - bpp] : 0, up = prev ? prev[x] : 0;
                    out[x] = static_cast<uint8_t>(in[x] + ((left + up) >> 1));
                }
                break;
            case 4:
                for (int64_t x = 0; x < stride; ++x) {
                    int left = x >= bpp ? out[x - bpp] : 0, up = prev ? prev[x] : 0;
                    int ul = (prev && x >= bpp) ? prev[x - bpp] : 0;
                    out[x] = static_cast<uint8_t>(in[x] + paeth(left, up, ul));
                }
                break;
            default:
                return ftype;
        }
        prev = out;
    }
    return -1;
}

// LZW codes at ``src`` (``n`` bytes) -> at most ``limit`` bytes at ``dst``;
// ``*out_len`` is the count written.  ``tiff`` != 0: TIFF's form (codes
// read from the high bit, 8-bit literals, the code width growing one code
// early); else GIF's (from the low bit, ``min_bits`` literal bits).  Returns
// 0 at the end code or a full ``dst``, 1 when the codes run out first, 2 at
// a code the table does not hold.
int gst_lzw_decode(const uint8_t* src, int64_t n, int min_bits, int tiff, uint8_t* dst,
                   int64_t limit, int64_t* out_len) {
    static thread_local uint16_t prefix[4096];
    static thread_local uint8_t suffix[4096], first[4096];
    static thread_local uint16_t length[4096];
    const int clear = 1 << min_bits, eoi = clear + 1;
    for (int c = 0; c < clear; ++c) {
        prefix[c] = 0;
        suffix[c] = first[c] = static_cast<uint8_t>(c);
        length[c] = 1;
    }
    int next = clear + 2, prev = -1;
    int64_t bitpos = 0, total = n * 8, out = 0;
    int status = 0;
    while (out < limit) {
        int width = 0;
        for (int v = tiff ? next + 1 : next; v; v >>= 1) ++width;
        if (width > 12) width = 12;
        if (bitpos + width > total) {
            status = 1;
            break;
        }
        int code = 0;
        for (int i = 0; i < width; ++i, ++bitpos) {
            int bit = tiff ? (src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1
                           : (src[bitpos >> 3] >> (bitpos & 7)) & 1;
            code |= tiff ? bit << (width - 1 - i) : bit << i;
        }
        if (code == clear) {
            next = clear + 2;
            prev = -1;
            continue;
        }
        if (code == eoi) break;
        int entry;
        if (prev < 0) {
            if (code > clear) {
                status = 2;
                break;
            }
            entry = code;
        } else {
            if (code > next) {
                status = 2;
                break;
            }
            if (next < 4096) {
                prefix[next] = static_cast<uint16_t>(prev);
                suffix[next] = code < next ? first[code] : first[prev];
                first[next] = first[prev];
                length[next] = static_cast<uint16_t>(length[prev] + 1);
                ++next;
            }
            entry = code;
        }
        // write the entry's bytes back to front, those past ``limit`` dropped
        int64_t len = length[entry];
        int c = entry;
        for (int64_t i = len - 1; i >= 0; --i) {
            if (out + i < limit) dst[out + i] = suffix[c];
            c = prefix[c];
        }
        out = out + len < limit ? out + len : limit;
        prev = entry;
    }
    *out_len = out;
    return status;
}

// Pillow's PackBits decoder: ``rows`` rows of ``row`` bytes from ``src``
// (``n`` bytes) into ``dst``, zeroed by the caller.  A packet that runs past
// a row's end loses the bytes past it; 128 is a no-op.  Returns the rows
// completed before the data ran out.
int64_t gst_packbits_rows(const uint8_t* src, int64_t n, int64_t row, int64_t rows,
                          uint8_t* dst) {
    int64_t x = 0, y = 0, pos = 0;
    uint8_t* line = dst;  // row y of dst is filled in place
    while (y < rows && pos < n) {
        int b = src[pos];
        int64_t take;
        if (b == 128) {
            ++pos;
            continue;
        }
        if (b > 128) {
            if (pos + 2 > n) break;
            take = 257 - b < row - x ? 257 - b : row - x;
            std::memset(line + x, src[pos + 1], static_cast<size_t>(take));
            pos += 2;
        } else {
            if (pos + b + 2 > n) break;
            take = b + 1 < row - x ? b + 1 : row - x;
            std::memcpy(line + x, src + pos + 1, static_cast<size_t>(take));
            pos += b + 2;
        }
        x += take;
        if (x >= row) {
            x = 0;
            ++y;
            line += row;
        }
    }
    return y;
}

// Pillow's SGI run-length decoder on the file past its 512-byte header
// (``src``, ``n`` bytes): ``h`` rows of ``w`` pixels of ``z`` channels of
// ``bpc`` bytes into ``dst`` (h * w * z * bpc, zeroed by the caller), rows in
// file order.  Returns 0 (OK), 1 (stopped at a row whose length's last
// packet is not a zero count; the rows from it on stay zero) or 2 (tables
// past the file's end, a row before the header's end, a packet past the
// file's end or a run past the row's width).
int gst_sgi_rle(const uint8_t* src, int64_t n, int64_t w, int64_t h, int64_t z, int64_t bpc,
                uint8_t* dst) {
    const int64_t tab = z * h, stride = w * z * bpc, last = n - 1;
    if (n < 8 * tab) return 2;
    auto be32 = [&](int64_t at) {
        return static_cast<int64_t>(src[at]) << 24 | static_cast<int64_t>(src[at + 1]) << 16 |
               static_cast<int64_t>(src[at + 2]) << 8 | static_cast<int64_t>(src[at + 3]);
    };
    uint8_t* line = static_cast<uint8_t*>(std::calloc(static_cast<size_t>(stride) + 1, 1));
    if (!line) return 2;
    int status = 0;
    for (int64_t y = 0; y < h && status == 0; ++y) {
        for (int64_t c = 0; c < z && status == 0; ++c) {
            int64_t start = be32(4 * (y + c * h)), length = be32(4 * (tab + y + c * h));
            if (start < 512) {
                status = 2;
                break;
            }
            int64_t at = start - 512, x = 0;
            // Pillow counts the length's packets in a C int: 2**31 and up count none
            for (int64_t left = length < (int64_t{1} << 31) ? length : 0; left > 0; --left) {
                if (at + bpc - 1 > last) {
                    status = 2;
                    break;
                }
                int pixel = src[at + bpc - 1];
                at += bpc;
                if (left == 1 && pixel) {
                    status = 1;
                    break;
                }
                int64_t count = pixel & 0x7F;
                if (!count) break;
                if (x + count > w) {
                    status = 2;
                    break;
                }
                uint8_t* out = line + (x * z + c) * bpc;
                if (pixel & 0x80) {
                    if (at + bpc * count > last) {
                        status = 2;
                        break;
                    }
                    for (int64_t i = 0; i < count; ++i, at += bpc, out += z * bpc)
                        std::memcpy(out, src + at, static_cast<size_t>(bpc));
                } else {
                    if (at + bpc - 1 > last) {
                        status = 2;
                        break;
                    }
                    for (int64_t i = 0; i < count; ++i, out += z * bpc)
                        std::memcpy(out, src + at, static_cast<size_t>(bpc));
                    at += bpc;
                }
                x += count;
            }
        }
        if (status == 0) std::memcpy(dst + y * stride, line, static_cast<size_t>(stride));
    }
    std::free(line);
    return status;
}

// Pillow's PCX run-length decoder: ``rows`` lines of ``line`` bytes from
// ``src`` (``n`` bytes) into ``dst``, zeroed by the caller.  Returns 0 (OK),
// 1 (the data ran out first) or 2 (a run passed a line's end; its bytes
// past the end are lost and the lines go on).
int gst_pcx_rle(const uint8_t* src, int64_t n, int64_t line, int64_t rows, uint8_t* dst) {
    int64_t x = 0, y = 0, pos = 0;
    bool overrun = false;
    uint8_t* out = dst;
    while (y < rows) {
        if (pos >= n) return 1;
        int b = src[pos];
        if ((b & 0xC0) == 0xC0) {
            if (pos + 2 > n) return 1;
            int64_t count = b & 0x3F, take = count < line - x ? count : line - x;
            overrun |= take < count;
            std::memset(out + x, src[pos + 1], static_cast<size_t>(take));
            x += take;
            pos += 2;
        } else {
            out[x++] = static_cast<uint8_t>(b);
            ++pos;
        }
        if (x >= line) {
            x = 0;
            ++y;
            out += line;
        }
    }
    return overrun ? 2 : 0;
}

// QOI's ops from ``src`` (``n`` bytes) -> ``pixels`` pixels of ``channels``
// (3 or 4) bytes at ``dst``, as Pillow's decoder reads them: a slot no
// pixel filled reads (0, 0, 0, 0), a run leaves the slots as they are, the
// pixels of a run past the last are dropped.  Returns 0, or 1 when the
// ops end before the last pixel.
int gst_qoi_decode(const uint8_t* src, int64_t n, int64_t pixels, int channels, uint8_t* dst) {
    uint8_t slots[64][4];
    std::memset(slots, 0, sizeof(slots));
    uint8_t prev[4] = {0, 0, 0, 255}, px[4];
    const int64_t need = pixels * channels;
    int64_t out = 0, pos = 0;
    while (out < need) {
        if (pos >= n) return 1;
        int b = src[pos++];
        if (b == 0xFE) {
            if (pos + 3 > n) return 1;
            std::memcpy(px, src + pos, 3);
            px[3] = prev[3];
            pos += 3;
        } else if (b == 0xFF) {
            if (pos + 4 > n) return 1;
            std::memcpy(px, src + pos, 4);
            pos += 4;
        } else if (b >> 6 == 0) {
            std::memcpy(px, slots[b], 4);
        } else if (b >> 6 == 1) {
            px[0] = static_cast<uint8_t>(prev[0] + ((b >> 4) & 3) - 2);
            px[1] = static_cast<uint8_t>(prev[1] + ((b >> 2) & 3) - 2);
            px[2] = static_cast<uint8_t>(prev[2] + (b & 3) - 2);
            px[3] = prev[3];
        } else if (b >> 6 == 2) {
            if (pos >= n) return 1;
            int dg = (b & 63) - 32, second = src[pos++];
            px[0] = static_cast<uint8_t>(prev[0] + dg + (second >> 4) - 8);
            px[1] = static_cast<uint8_t>(prev[1] + dg);
            px[2] = static_cast<uint8_t>(prev[2] + dg + (second & 15) - 8);
            px[3] = prev[3];
        } else {
            for (int64_t run = (b & 63) + 1; run > 0 && out < need; --run, out += channels)
                std::memcpy(dst + out, prev, static_cast<size_t>(channels));
            continue;
        }
        std::memcpy(slots[(px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64], px, 4);
        std::memcpy(prev, px, 4);
        std::memcpy(dst + out, px, static_cast<size_t>(channels));
        out += channels;
    }
    return 0;
}

// One CCITT strip or tile (io/ccitt.py's decode_fax_python): ``comp`` 2, 3
// or 4, ``two_d`` a two-dimensional Group 3 or Group 4, ``lsb_first`` for
// FillOrder 2; ``rows`` rows of ``rowbytes`` at ``dst`` (kept where the
// decoder does not write), the run arrays ``runs`` (2 * nruns + 4 entries,
// kept from strip to strip) and libtiff's tables (3 int32 an entry, 2^7,
// 2^12 and 2^13 entries).  Returns 1, -1 (libtiff fails the strip) or 0 (a
// Group 3 strip's data ends early); ``*end`` is the rows written.
int gst_fax_decode(const uint8_t* src, int64_t n, int comp, int two_d, int lsb_first,
                   int64_t width, int64_t rows, uint8_t* dst, int64_t rowbytes, uint32_t* runs,
                   int64_t nruns, const int32_t* mainT, const int32_t* whiteT,
                   const int32_t* blackT, int64_t* end) {
    Fax f;
    f.data = src;
    f.cp = 0;
    f.ep = n;
    f.lsb_first = lsb_first != 0;
    f.runs = runs;
    f.nruns = nruns;
    f.lastx = static_cast<int32_t>(width);
    f.mainT = mainT;
    f.whiteT = whiteT;
    f.blackT = blackT;
    *end = rows;
    f.thisrun = 0;
    f.refruns = nruns;
    if (two_d) {
        runs[f.refruns] = static_cast<uint32_t>(width);
        runs[f.refruns + 1] = 0;
    }
    try {
        for (int64_t line = 0; line < rows; ++line) {
            uint8_t* row = dst + line * rowbytes;
            f.start_row();
            if (comp != 4) {
                uint32_t one_d = 0;
                if (comp == 3) {
                    try {
                        f.sync_eol();
                        if (two_d) {
                            f.need8(1);
                            one_d = f.get(1);
                            f.clr(1);
                        }
                    } catch (const FaxEof&) {
                        f.cleanup();
                        f.fill(row);
                        return 0;
                    }
                }
                if (two_d) {
                    f.pb = f.refruns;
                    f.b1 = static_cast<int32_t>(runs[f.pb++]);
                }
                bool whole = (!two_d || one_d) ? f.expand1d() : f.expand2d();
                f.fill(row);
                if (!whole) return comp == 2 ? -1 : 0;
                if (comp == 2) f.clr(f.avail & 7);
                if (two_d) {
                    if (f.pa < f.thisrun + nruns) f.setvalue(0);
                    int64_t t = f.thisrun;
                    f.thisrun = f.refruns;
                    f.refruns = t;
                }
                continue;
            }
            f.pb = f.refruns;
            f.b1 = static_cast<int32_t>(runs[f.pb++]);
            if (!f.expand2d() || f.eolcnt) {
                try {
                    f.need16(13);
                } catch (const FaxEof&) {
                }
                f.clr(13);
                f.fill(row);
                *end = line + 1;
                return line ? 1 : -1;
            }
            f.fill(row);
            f.setvalue(0);
            int64_t t = f.thisrun;
            f.thisrun = f.refruns;
            f.refruns = t;
        }
    } catch (const FaxFail&) {
        return -1;
    }
    return 1;
}

// ``n`` BC6H blocks of 16 bytes at ``src`` -> (n, 16, 3) RGB texels at
// ``dst``, with io/dds.py's bc6h_table() (modes, layouts, partitions,
// weights), ``is_signed`` for BC6H_SF16.
void gst_bc6h_decode(const uint8_t* src, int64_t n, int is_signed, const int32_t* table,
                     uint8_t* dst) {
    const int32_t* head = table;
    const int32_t* pack = table + 32 * 8;
    const int32_t* part2 = pack + 32 * 80;
    const int32_t* anchor2 = part2 + 32;
    const int32_t* w3 = anchor2 + 32;
    const int32_t* w4 = w3 + 8;
    for (int64_t blk = 0; blk < n; ++blk) {
        const uint8_t* b = src + 16 * blk;
        uint8_t* out = dst + 48 * blk;
        std::memset(out, 0, 48);
        auto bit = [b](int p) -> int64_t { return (b[p >> 3] >> (p & 7)) & 1; };
        int mode = (b[0] & 3) < 2 ? (b[0] & 3) : (b[0] & 31);
        const int32_t* h = head + 8 * mode;
        if (!h[0]) continue;  // a reserved mode: black
        int epb = h[1], tr = h[5], two = h[6], npack = h[7];
        int delta[3] = {h[2], h[3], h[4]};
        int64_t f[13] = {0};
        int pos = mode < 2 ? 2 : 5;
        for (int i = 0; i < npack; ++i) {
            int entry = pack[80 * mode + i];
            f[entry >> 4] |= bit(pos + i) << (entry & 15);
        }
        pos += npack;
        int ne = two ? 4 : 2;
        int64_t e[4][3];
        for (int j = 0; j < ne; ++j)
            for (int c = 0; c < 3; ++c) e[j][c] = f[3 * j + c];
        if (is_signed)
            for (int c = 0; c < 3; ++c) e[0][c] = sext(e[0][c], epb);
        for (int j = 1; j < ne; ++j) {
            for (int c = 0; c < 3; ++c) {
                if (tr) {
                    int64_t v = (e[0][c] + sext(e[j][c], delta[c])) & ((int64_t{1} << epb) - 1);
                    e[j][c] = (is_signed && epb == 16) ? sext(v, epb) : v;
                } else if (is_signed) {
                    e[j][c] = sext(e[j][c], epb);
                }
            }
        }
        for (int j = 0; j < ne; ++j)
            for (int c = 0; c < 3; ++c) e[j][c] = bc6_unquantize(e[j][c], epb, is_signed != 0);
        int part = two ? static_cast<int>(f[12]) : 0, ib = two ? 3 : 4;
        const int32_t* wt = two ? w3 : w4;
        for (int t = 0; t < 16; ++t) {
            int subset = two ? (part2[part] >> t) & 1 : 0;
            bool anchor = t == 0 || (two && t == anchor2[part]);
            int width = ib - (anchor ? 1 : 0), idx = 0;
            for (int k = 0; k < width; ++k) idx |= static_cast<int>(bit(pos + k)) << k;
            pos += width;
            int64_t w = wt[idx];
            for (int c = 0; c < 3; ++c) {
                int64_t v = ((64 - w) * e[2 * subset][c] + w * e[2 * subset + 1][c]) >> 6;
                uint32_t half;
                if (is_signed) {
                    int64_t mag = ((v < 0 ? -v : v) * 31) >> 5;
                    half = static_cast<uint32_t>(v < 0 ? (0x8000 | mag) : mag) & 0xFFFF;
                } else {
                    half = static_cast<uint32_t>((v * 31) >> 6) & 0xFFFF;
                }
                float fl = half_to_float(half);
                out[3 * t + c] = fl < 0 ? 0 : fl > 1 ? 255
                                 : static_cast<uint8_t>(static_cast<int>(fl * 255.0f));
            }
        }
    }
}

// SUN's run-length rows (Pillow's SunRleDecode) from ``src`` -> ``rows``
// lines of ``line`` bytes at ``dst``: 0x80 0 is a 0x80 byte, 0x80 n v a run
// of n + 1 bytes v that goes on into the next lines, any other byte itself.
// Returns 0, or 1 when the data end before the last line.
int gst_sun_rle(const uint8_t* src, int64_t n, int64_t line, int64_t rows, uint8_t* dst) {
    const int64_t total = line * rows;
    int64_t x = 0, pos = 0;
    while (x < total) {
        if (pos >= n) return 1;
        int b = src[pos];
        if (b == 0x80) {
            if (pos + 1 >= n) return 1;
            int64_t count = src[pos + 1];
            if (count == 0) {
                dst[x++] = 0x80;
                pos += 2;
                continue;
            }
            if (pos + 2 >= n) return 1;
            ++count;
            int64_t take = count < total - x ? count : total - x;
            std::memset(dst + x, src[pos + 2], static_cast<size_t>(take));
            x += count;
            pos += 3;
        } else {
            dst[x++] = static_cast<uint8_t>(b);
            ++pos;
        }
    }
    return 0;
}

// MSP version 2 (Pillow's MspDecoder): the row map of ``rows`` 16-bit
// lengths and the rows after it in ``src`` -> the bytes the runs write, at
// most ``cap`` of them at ``dst`` (``*written`` counts them all; a row of
// length 0 writes ``blank`` bytes of 0xFF).  Returns 0, 1 when the map or a
// row ends early, 2 when a run is cut by its row's end.
int gst_msp_rle(const uint8_t* src, int64_t n, int64_t rows, int64_t blank, uint8_t* dst,
                int64_t cap, int64_t* written) {
    int64_t out = 0, pos = 2 * rows;
    int status = 0;
    auto put = [&](const uint8_t* p, int64_t count, bool run) {
        for (int64_t k = 0; k < count; ++k, ++out)
            if (out < cap) dst[out] = run ? p[0] : p[k];
    };
    const uint8_t ff = 0xFF;
    if (n < 2 * rows) {
        *written = 0;
        return 1;
    }
    for (int64_t r = 0; r < rows && !status; ++r) {
        int64_t rowlen = src[2 * r] | (src[2 * r + 1] << 8);
        if (rowlen == 0) {
            put(&ff, blank, true);
            continue;
        }
        if (pos + rowlen > n) {
            status = 1;
            break;
        }
        const uint8_t* row = src + pos;
        pos += rowlen;
        int64_t idx = 0;
        while (idx < rowlen) {
            int runtype = row[idx++];
            if (runtype == 0) {
                if (idx + 2 > rowlen) {
                    status = 2;
                    break;
                }
                put(row + idx + 1, row[idx], true);
                idx += 2;
            } else {
                int64_t take = runtype < rowlen - idx ? runtype : rowlen - idx;
                put(row + idx, take, false);
                idx += runtype;
            }
        }
    }
    *written = out;
    return status;
}

// ICNS's run-length channels (IcnsImagePlugin.read_32): three channels of
// ``pixels`` bytes from ``src`` into ``dst`` (channel-major).  Returns 0, 1
// when the data end first or a literal comes short, 2 when a run or a
// literal passes a channel's end.
int gst_icns_rle(const uint8_t* src, int64_t n, int64_t pixels, uint8_t* dst) {
    int64_t pos = 0;
    for (int band = 0; band < 3; ++band) {
        uint8_t* out = dst + band * pixels;
        int64_t x = 0, left = pixels;
        while (left > 0) {
            if (pos >= n) return 1;
            int b = src[pos++];
            int64_t count;
            if (b & 0x80) {
                count = b - 125;
                if (pos >= n) return 1;
                int64_t take = count < pixels - x ? count : pixels - x;
                if (take > 0) std::memset(out + x, src[pos], static_cast<size_t>(take));
                ++pos;
            } else {
                count = b + 1;
                int64_t got = count < n - pos ? count : n - pos;
                int64_t take = got < pixels - x ? got : pixels - x;
                if (take > 0) std::memcpy(out + x, src + pos, static_cast<size_t>(take));
                pos += got;
                if (got < count) return 1;
            }
            x += count;
            left -= count;
        }
        if (left != 0) return 2;
    }
    return 0;
}

// One call of Pillow's FliDecode on ``buf`` (``nb`` bytes) into the
// ``ysize`` x ``xsize`` 8-bit image ``img`` (row-major): the frame's chunks
// BLACK, BRUN, COPY, LC, SS2 (colour and stamp chunks skipped).  Returns
// the bytes consumed (0: the frame is not all there yet; a COPY chunk
// whose pixels pass the buffer returns the offset of its chunk), or -1 at
// the frame's end with ``*err`` 0, or -1 with ``*err`` < 0 (-1 overrun, -2
// a chunk size of 0, -3 an unknown chunk).
int64_t gst_fli_frame(const uint8_t* buf, int64_t nb, int64_t xsize, int64_t ysize,
                      uint8_t* img, int* err) {
    auto i16 = [&](int64_t o) -> int64_t { return buf[o] | (buf[o + 1] << 8); };
    auto i32 = [&](int64_t o) -> uint32_t {
        return static_cast<uint32_t>(buf[o]) | (static_cast<uint32_t>(buf[o + 1]) << 8) |
               (static_cast<uint32_t>(buf[o + 2]) << 16) | (static_cast<uint32_t>(buf[o + 3]) << 24);
    };
    *err = 0;
    if (nb < 4) return 0;
    int64_t framesize = static_cast<int32_t>(i32(0));  // a C int, as Pillow reads it
    if (nb + nb % 2 < framesize) return 0;
    if (nb < 8) { *err = -1; return -1; }
    if (i16(4) != 0xF1FA) { *err = -3; return -1; }
    int64_t chunks = i16(6), ptr = 16, left = nb - 16;
    for (int64_t c = 0; c < chunks; ++c) {
        if (left < 10) { *err = -1; return -1; }
        int64_t data = ptr + 6, end = ptr + left;
        int64_t kind = i16(ptr + 4);
        if (kind == 4 || kind == 11 || kind == 18) {
        } else if (kind == 7) {  // SS2
            int64_t lines = i16(data), l = 0, y = 0;
            data += 2;
            for (; l < lines && y < ysize; ++l, ++y) {
                uint8_t* row = img + y * xsize;
                if (data + 2 > end) { *err = -1; return -1; }
                int64_t packets = i16(data);
                data += 2;
                while (packets & 0x8000) {
                    if (packets & 0x4000) {
                        y += 65536 - packets;
                        if (y >= ysize) { *err = -1; return -1; }
                        row = img + y * xsize;
                    } else {
                        row[xsize - 1] = static_cast<uint8_t>(packets);
                    }
                    if (data + 2 > end) { *err = -1; return -1; }
                    packets = i16(data);
                    data += 2;
                }
                int64_t p = 0, x = 0;
                for (; p < packets; ++p) {
                    if (data + 2 > end) { *err = -1; return -1; }
                    x += buf[data];
                    if (buf[data + 1] >= 128) {
                        if (data + 4 > end) { *err = -1; return -1; }
                        int64_t i = 256 - buf[data + 1];
                        if (x + i + i > xsize) break;
                        for (int64_t j = 0; j < i; ++j) {
                            row[x++] = buf[data + 2];
                            row[x++] = buf[data + 3];
                        }
                        data += 4;
                    } else {
                        int64_t i = 2 * static_cast<int64_t>(buf[data + 1]);
                        if (x + i > xsize) break;
                        if (data + 2 + i > end) { *err = -1; return -1; }
                        std::memcpy(row + x, buf + data + 2, static_cast<size_t>(i));
                        data += 2 + i;
                        x += i;
                    }
                }
                if (p < packets) break;
            }
            if (l < lines) { *err = -1; return -1; }
        } else if (kind == 12) {  // LC
            int64_t y = i16(data), ymax = y + i16(data + 2);
            data += 4;
            for (; y < ymax && y < ysize; ++y) {
                uint8_t* row = img + y * xsize;
                if (data + 1 > end) { *err = -1; return -1; }
                int64_t packets = buf[data++], p = 0, x = 0, i = 0;
                for (; p < packets; ++p, x += i) {
                    if (data + 2 > end) { *err = -1; return -1; }
                    x += buf[data];
                    if (buf[data + 1] & 0x80) {
                        i = 256 - buf[data + 1];
                        if (x + i > xsize) break;
                        if (data + 3 > end) { *err = -1; return -1; }
                        std::memset(row + x, buf[data + 2], static_cast<size_t>(i));
                        data += 3;
                    } else {
                        i = buf[data + 1];
                        if (x + i > xsize) break;
                        if (data + 2 + i > end) { *err = -1; return -1; }
                        std::memcpy(row + x, buf + data + 2, static_cast<size_t>(i));
                        data += i + 2;
                    }
                }
                if (p < packets) break;
            }
            if (y < ymax) { *err = -1; return -1; }
        } else if (kind == 13) {  // BLACK
            std::memset(img, 0, static_cast<size_t>(xsize * ysize));
        } else if (kind == 15) {  // BRUN
            for (int64_t y = 0; y < ysize; ++y) {
                uint8_t* row = img + y * xsize;
                data += 1;
                int64_t x = 0, i = 0;
                for (; x < xsize; x += i) {
                    if (data + 2 > end) { *err = -1; return -1; }
                    if (buf[data] & 0x80) {
                        i = 256 - buf[data];
                        if (x + i > xsize) break;
                        if (data + i + 1 > end) { *err = -1; return -1; }
                        std::memcpy(row + x, buf + data + 1, static_cast<size_t>(i));
                        data += i + 1;
                    } else {
                        i = buf[data];
                        if (x + i > xsize) break;
                        std::memset(row + x, buf[data + 1], static_cast<size_t>(i));
                        data += 2;
                    }
                }
                if (x != xsize) { *err = -1; return -1; }
            }
        } else if (kind == 16) {  // COPY
            if (data + xsize * ysize > end) return ptr;
            std::memcpy(img, buf + data, static_cast<size_t>(xsize * ysize));
        } else {
            *err = -3;
            return -1;
        }
        int64_t advance = i32(ptr);
        if (advance == 0) { *err = -2; return -1; }
        if (advance > left) { *err = -1; return -1; }
        ptr += advance;
        left -= advance;
    }
    return -1;
}

}  // extern "C"
