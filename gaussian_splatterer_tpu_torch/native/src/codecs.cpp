// Native byte loops of the texture decoders: PNG's row unfilter and the
// LZW decoder of GIF and TIFF.  Each is the C++ twin of a Python loop that
// stays as its plain version (io/png.py's unfilter_python, io/lzw.py's
// decode_lzw_python) and gives the same bytes and the same status for every
// input, broken ones included.  Plain C ABI for ctypes; the caller owns
// every buffer.

#include <cstdint>
#include <cstdlib>

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

}  // extern "C"
