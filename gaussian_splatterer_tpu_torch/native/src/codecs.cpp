// Native byte loops of the texture decoders: PNG's row unfilter, the LZW
// decoder of GIF and TIFF, PSD's PackBits rows, SGI's and PCX's run-length
// rows and QOI's ops.  Each is the C++ twin of a Python loop that stays as
// its plain version (io/png.py's unfilter_python, io/lzw.py's
// decode_lzw_python, io/psd.py's packbits_rows_python, io/sgi.py's
// rle_rows_python, io/pcx.py's rle_lines_python, io/qoi.py's
// decode_ops_python) and gives the same bytes and the same status for
// every input, broken ones included.  Plain C ABI for ctypes; the caller
// owns every buffer.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

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

}  // extern "C"
