// JPEG 2000 codestream decoder (ISO/IEC 15444-1) for io/jpeg2000.py.
//
// It reads a codestream as OpenJPEG 2.5.4 reads it when Pillow drives it
// tile by tile (opj_read_tile_header / opj_decode_tile_data) in strict
// mode: the main header and the tile-part headers (SIZ, COD, COC, QCD,
// QCC, RGN, POC, TLM, PLM, PLT, PPM, PPT, CRG, COM, SOT, SOD, EOC), the
// packet iterator of the five progressions and POC changes, tier 2 with
// its tag trees, SOP and EPH markers, tier 1 (the MQ decoder, the raw
// passes and EBCOT's three passes under every code-block style), ROI
// max-shift, dequantisation, the inverse 5/3 in integers and the inverse
// 9/7 in float32 in OpenJPEG's order of operations, RCT and ICT, the DC
// level shift and the clamp.  The output is what opj_decode_tile_data
// hands Pillow for each tile: one int32 plane per component.
//
// Where OpenJPEG fails a stream this decoder fails it too, with a status
// and a reason; hostile sizes (tiles, components, code-blocks, layers,
// segments) become a refusal, never an unbounded allocation.  Build this
// file without floating-point contraction (-ffp-contract=off): the 9/7
// path must round after every multiply and every add, as OpenJPEG's SSE
// code does.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

typedef uint32_t u32;
typedef int32_t i32;
typedef int64_t i64;
typedef uint64_t u64;

struct Fail {
    std::string why;
};

[[noreturn]] void fail(const std::string& why) { throw Fail{why}; }

const i64 MAX_TILE_SAMPLES = i64(1) << 28;    // per tile-component
const i64 MAX_CBLKS = i64(1) << 22;           // per tile
const i64 MAX_INCLUDE = i64(1) << 27;         // packet iterator entries
const u32 MAX_SEGS = 1u << 16;                // per code-block

u32 ceildiv(u32 a, u32 b) { return u32((u64(a) + b - 1) / b); }
i32 int_ceildivpow2(i32 a, i32 b) { return i32((i64(a) + (i64(1) << b) - 1) >> b); }
i32 int64_ceildivpow2(i64 a, i32 b) { return i32((a + (i64(1) << b) - 1) >> b); }
i32 int_floordivpow2(i32 a, i32 b) { return a >> b; }
u32 uint_adds(u32 a, u32 b) { u64 s = u64(a) + b; return s > 0xFFFFFFFFu ? 0xFFFFFFFFu : u32(s); }

// ---- the stream, as opj_stream_private_t sees Pillow's file --------------

struct Stream {
    const uint8_t* d;
    u64 len, pos;
    u64 left() const { return len - pos; }
    // opj_stream_read_data: the number of bytes read (fewer at the end)
    u64 read(uint8_t* out, u64 n) {
        u64 k = n < left() ? n : left();
        if (out && k) memcpy(out, d + pos, k);
        pos += k;
        return k;
    }
    bool read2(u32* v) {
        uint8_t b[2];
        if (read(b, 2) != 2) return false;
        *v = u32(b[0]) << 8 | b[1];
        return true;
    }
};

u32 rd(const uint8_t*& p, int n) {
    u32 v = 0;
    for (int i = 0; i < n; ++i) v = v << 8 | *p++;
    return v;
}

// ---- coding parameters ------------------------------------------------------

const int MAXRLVLS = 33;
const int MAXBANDS = 3 * MAXRLVLS - 2;

struct StepSize {
    i32 expn, mant;
};

struct Tccp {
    u32 csty, numresolutions, cblkw, cblkh, cblksty, qmfbid, qntsty, numgbits, roishift;
    u32 prcw[MAXRLVLS], prch[MAXRLVLS];
    StepSize stepsizes[MAXBANDS];
    i32 dc_level_shift;
};

struct Poc {
    u32 resno0, compno0, layno1, resno1, compno1;
    i32 prg;
};

enum { LRCP = 0, RLCP = 1, RPCL = 2, PCRL = 3, CPRL = 4, PROG_UNKNOWN = -1 };

struct Tcp {
    u32 csty = 0, numlayers = 0, mct = 0;
    i32 prg = 0;
    bool cod = false, poc = false, ppt = false;
    u32 numpocs = 0;
    Poc pocs[32];
    std::vector<Tccp> tccps;
    // tile-part bookkeeping
    i32 current_part = -1;
    u32 nb_parts = 0;
    bool has_data = false;  // OpenJPEG's m_data != NULL
    std::vector<uint8_t> data;
    std::vector<std::vector<uint8_t>> ppt_markers;
    std::vector<bool> ppt_have;
    bool ppt_merged = false;
    std::vector<uint8_t> ppt_buf;
    u64 ppt_pos = 0;
};

struct Comp {
    u32 dx, dy, prec, sgnd, resno_decoded;
};

struct Image {
    u32 x0, y0, x1, y1, numcomps;
    std::vector<Comp> comps;
};

struct Cp {
    u32 tx0, ty0, tdx, tdy, tw, th;
    bool ppm = false;
    std::vector<std::vector<uint8_t>> ppm_markers;
    std::vector<bool> ppm_have;
    std::vector<uint8_t> ppm_buf;
    u64 ppm_pos = 0;
};

enum State : u32 {
    ST_NONE = 0, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8, ST_TPH = 16,
    ST_NEOC = 64, ST_DATA = 128, ST_EOC = 256,
};

enum Marker : u32 {
    M_SOC = 0xff4f, M_SOT = 0xff90, M_SOD = 0xff93, M_EOC = 0xffd9, M_SIZ = 0xff51,
    M_COD = 0xff52, M_COC = 0xff53, M_RGN = 0xff5e, M_QCD = 0xff5c, M_QCC = 0xff5d,
    M_POC = 0xff5f, M_TLM = 0xff55, M_PLM = 0xff57, M_PLT = 0xff58, M_PPM = 0xff60,
    M_PPT = 0xff61, M_SOP = 0xff91, M_EPH = 0xff92, M_CRG = 0xff63, M_COM = 0xff64,
    M_CAP = 0xff50, M_CPF = 0xff59, M_MCT = 0xff74, M_MCC = 0xff75, M_MCO = 0xff77,
    M_CBD = 0xff78,
};

// the states in which OpenJPEG's marker table takes each marker; 0 for an
// unknown one (whose entry takes MH | TPH)
u32 marker_states(u32 m, bool* known) {
    *known = true;
    switch (m) {
    case M_SOT: return ST_MH | ST_TPHSOT;
    case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC: case M_POC: case M_COM:
        return ST_MH | ST_TPH;
    case M_SIZ: return ST_MHSIZ;
    case M_TLM: case M_PLM: case M_PPM: case M_CRG: return ST_MH;
    case M_PLT: case M_PPT: return ST_TPH;
    case M_SOP: return 0;
    case M_MCT: case M_MCC: case M_MCO: return ST_MH | ST_TPH;
    case M_CBD: case M_CAP: case M_CPF: return ST_MH;
    default:
        *known = false;
        return ST_MH | ST_TPH;
    }
}

}  // namespace

namespace {

struct Decoder {
    Stream s;
    Image img;
    Cp cp;
    Tcp dflt;
    std::vector<Tcp> tcps;
    u32 state = ST_NONE;
    u32 ihdr_w = 0, ihdr_h = 0;
    u32 cur_tile = 0;
    u32 sot_length = 0;
    bool last_tile_part = false, can_decode = false;
    bool in_tph() const { return (state & ST_TPH) != 0; }
    Tcp& tcp() { return in_tph() ? tcps[cur_tile] : dflt; }

    // ---- marker segments (opj_j2k_read_*) ----

    void read_siz(const uint8_t* p, u32 size) {
        if (size < 36) fail("Error with SIZ marker size");
        u32 rem = size - 36, nb = rem / 3;
        if (nb > 16384 || rem % 3) fail("Error with SIZ marker size");
        rd(p, 2);  // Rsiz
        img.x1 = rd(p, 4); img.y1 = rd(p, 4); img.x0 = rd(p, 4); img.y0 = rd(p, 4);
        cp.tdx = rd(p, 4); cp.tdy = rd(p, 4); cp.tx0 = rd(p, 4); cp.ty0 = rd(p, 4);
        u32 csiz = rd(p, 2);
        if (csiz >= 16385) fail("Error with SIZ marker: number of component is illegal");
        img.numcomps = csiz;
        if (img.numcomps != nb) fail("Error with SIZ marker: number of component is illegal");
        if (img.x0 >= img.x1 || img.y0 >= img.y1)
            fail("Error with SIZ marker: negative or zero image size");
        if (cp.tdx == 0 || cp.tdy == 0) fail("Error with SIZ marker: invalid tile size");
        u32 tx1 = uint_adds(cp.tx0, cp.tdx), ty1 = uint_adds(cp.ty0, cp.tdy);
        if (cp.tx0 > img.x0 || cp.ty0 > img.y0 || tx1 <= img.x0 || ty1 <= img.y0)
            fail("Error with SIZ marker: illegal tile offset");
        u32 sw = img.x1 - img.x0, sh = img.y1 - img.y0;
        if (ihdr_w > 0 && ihdr_h > 0 && (ihdr_w != sw || ihdr_h != sh))
            fail("Error with SIZ marker: IHDR w/h vs. SIZ w/h");
        if (img.numcomps > 4) fail("more than 4 components (Pillow reads at most 4)");
        img.comps.resize(img.numcomps);
        for (u32 i = 0; i < img.numcomps; ++i) {
            u32 t = rd(p, 1);
            Comp& c = img.comps[i];
            c.prec = (t & 0x7f) + 1;
            c.sgnd = t >> 7;
            c.dx = rd(p, 1);
            c.dy = rd(p, 1);
            c.resno_decoded = 0;
            if (c.dx < 1 || c.dx > 255 || c.dy < 1 || c.dy > 255)
                fail("Invalid values for comp dx/dy (should be between 1 and 255)");
            if (c.prec > 31) fail("Invalid values for comp prec (OpenJpeg only supports up to 31)");
        }
        cp.tw = ceildiv(img.x1 - cp.tx0, cp.tdx);
        cp.th = ceildiv(img.y1 - cp.ty0, cp.tdy);
        if (cp.tw == 0 || cp.th == 0 || cp.tw > 65535 / cp.th) fail("Invalid number of tiles");
        dflt.tccps.assign(img.numcomps, Tccp());
        memset(dflt.tccps.data(), 0, sizeof(Tccp) * img.numcomps);
        for (u32 i = 0; i < img.numcomps; ++i)
            if (!img.comps[i].sgnd) dflt.tccps[i].dc_level_shift = 1 << (img.comps[i].prec - 1);
        state = ST_MH;
    }

    void read_spcod_spcoc(u32 compno, const uint8_t*& p, u32* size) {
        Tcp& t = tcp();
        if (compno >= img.numcomps) fail("Error reading SPCod SPCoc element");
        Tccp& c = t.tccps[compno];
        if (*size < 5) fail("Error reading SPCod SPCoc element");
        c.numresolutions = rd(p, 1) + 1;
        if (c.numresolutions > MAXRLVLS) fail("Invalid value for numresolutions");
        c.cblkw = rd(p, 1) + 2;
        c.cblkh = rd(p, 1) + 2;
        if (c.cblkw > 10 || c.cblkh > 10 || c.cblkw + c.cblkh > 12)
            fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
        c.cblksty = rd(p, 1);
        if (c.cblksty & 0x80) fail("Unsupported Mixed HT code-block style found");
        if (c.cblksty & 0x40) fail("HT (high-throughput) code-blocks are not read");
        c.qmfbid = rd(p, 1);
        if (c.qmfbid > 1) fail("Error reading SPCod SPCoc element, Invalid transformation found");
        *size -= 5;
        if (c.csty & 1) {
            if (*size < c.numresolutions) fail("Error reading SPCod SPCoc element");
            for (u32 i = 0; i < c.numresolutions; ++i) {
                u32 v = rd(p, 1);
                if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail("Invalid precinct size");
                c.prcw[i] = v & 0xf;
                c.prch[i] = v >> 4;
            }
            *size -= c.numresolutions;
        } else {
            for (u32 i = 0; i < c.numresolutions; ++i) c.prcw[i] = c.prch[i] = 15;
        }
    }

    void read_cod(const uint8_t* p, u32 size) {
        Tcp& t = tcp();
        if (t.cod) fail("COD marker already read. No more than one COD marker per tile.");
        t.cod = true;
        if (size < 5) fail("Error reading COD marker");
        t.csty = rd(p, 1);
        if (t.csty & ~7u) fail("Unknown Scod value in COD marker");
        t.prg = i32(rd(p, 1));
        if (t.prg > CPRL) t.prg = PROG_UNKNOWN;
        t.numlayers = rd(p, 2);
        if (t.numlayers < 1) fail("Invalid number of layers in COD marker");
        t.mct = rd(p, 1);
        if (t.mct > 1) fail("Invalid multiple component transformation");
        size -= 5;
        for (u32 i = 0; i < img.numcomps; ++i) t.tccps[i].csty = t.csty & 1;
        read_spcod_spcoc(0, p, &size);
        if (size != 0) fail("Error reading COD marker");
        // opj_j2k_copy_tile_component_parameters
        const Tccp& r = t.tccps[0];
        for (u32 i = 1; i < img.numcomps; ++i) {
            Tccp& c = t.tccps[i];
            c.numresolutions = r.numresolutions;
            c.cblkw = r.cblkw; c.cblkh = r.cblkh; c.cblksty = r.cblksty; c.qmfbid = r.qmfbid;
            memcpy(c.prcw, r.prcw, sizeof c.prcw);
            memcpy(c.prch, r.prch, sizeof c.prch);
        }
    }

    void read_coc(const uint8_t* p, u32 size) {
        Tcp& t = tcp();
        u32 room = img.numcomps <= 256 ? 1 : 2;
        if (size < room + 1) fail("Error reading COC marker");
        size -= room + 1;
        u32 compno = rd(p, int(room));
        if (compno >= img.numcomps) fail("Error reading COC marker (bad number of components)");
        t.tccps[compno].csty = rd(p, 1);
        read_spcod_spcoc(compno, p, &size);
        if (size != 0) fail("Error reading COC marker");
    }

    void read_sqcd_sqcc(u32 compno, const uint8_t*& p, u32* size) {
        Tcp& t = tcp();
        if (compno >= img.numcomps) fail("Error reading SQcd or SQcc element");
        Tccp& c = t.tccps[compno];
        if (*size < 1) fail("Error reading SQcd or SQcc element");
        *size -= 1;
        u32 v = rd(p, 1);
        c.qntsty = v & 0x1f;
        c.numgbits = v >> 5;
        u32 nb;
        if (c.qntsty == 1) nb = 1;
        else nb = c.qntsty == 0 ? *size : *size / 2;
        if (c.qntsty == 0) {
            for (u32 b = 0; b < nb; ++b) {
                u32 x = rd(p, 1);
                if (b < MAXBANDS) { c.stepsizes[b].expn = i32(x >> 3); c.stepsizes[b].mant = 0; }
            }
            if (*size < nb) fail("Error reading SQcd or SQcc element");
            *size -= nb;
        } else {
            if (*size < 2 * nb) fail("Error reading SQcd or SQcc element");  // checked first
            for (u32 b = 0; b < nb; ++b) {
                u32 x = rd(p, 2);
                if (b < MAXBANDS) {
                    c.stepsizes[b].expn = i32(x >> 11);
                    c.stepsizes[b].mant = i32(x & 0x7ff);
                }
            }
            *size -= 2 * nb;
        }
        if (c.qntsty == 1) {
            for (u32 b = 1; b < MAXBANDS; ++b) {
                i32 e = c.stepsizes[0].expn - i32((b - 1) / 3);
                c.stepsizes[b].expn = e > 0 ? e : 0;
                c.stepsizes[b].mant = c.stepsizes[0].mant;
            }
        }
    }

    void read_qcd(const uint8_t* p, u32 size) {
        read_sqcd_sqcc(0, p, &size);
        if (size != 0) fail("Error reading QCD marker");
        Tcp& t = tcp();
        const Tccp& r = t.tccps[0];
        for (u32 i = 1; i < img.numcomps; ++i) {
            Tccp& c = t.tccps[i];
            c.qntsty = r.qntsty;
            c.numgbits = r.numgbits;
            memcpy(c.stepsizes, r.stepsizes, sizeof c.stepsizes);
        }
    }

    void read_qcc(const uint8_t* p, u32 size) {
        u32 compno;
        if (img.numcomps <= 256) {
            if (size < 1) fail("Error reading QCC marker");
            compno = rd(p, 1);
            size -= 1;
        } else {
            if (size < 2) fail("Error reading QCC marker");
            compno = rd(p, 2);
            size -= 2;
        }
        if (compno >= img.numcomps) fail("Invalid component number in QCC");
        read_sqcd_sqcc(compno, p, &size);
        if (size != 0) fail("Error reading QCC marker");
    }

    void read_rgn(const uint8_t* p, u32 size) {
        u32 room = img.numcomps <= 256 ? 1 : 2;
        if (size != 2 + room) fail("Error reading RGN marker");
        Tcp& t = tcp();
        u32 compno = rd(p, int(room));
        rd(p, 1);  // Srgn
        if (compno >= img.numcomps) fail("bad component number in RGN");
        t.tccps[compno].roishift = rd(p, 1);
    }

    void read_poc(const uint8_t* p, u32 size) {
        u32 room = img.numcomps <= 256 ? 1 : 2;
        u32 chunk = 5 + 2 * room;
        u32 nb = size / chunk;
        if (nb == 0 || size % chunk) fail("Error reading POC marker");
        Tcp& t = tcp();
        u32 old = t.poc ? t.numpocs + 1 : 0;
        nb += old;
        if (nb >= 32) fail("Too many POCs");
        t.poc = true;
        for (u32 i = old; i < nb; ++i) {
            Poc& q = t.pocs[i];
            q.resno0 = rd(p, 1);
            q.compno0 = rd(p, int(room));
            q.layno1 = rd(p, 2);
            if (q.layno1 > t.numlayers) q.layno1 = t.numlayers;
            q.resno1 = rd(p, 1);
            q.compno1 = rd(p, int(room));
            if (q.compno1 > img.numcomps) q.compno1 = img.numcomps;
            q.prg = i32(rd(p, 1));
        }
        t.numpocs = nb - 1;
    }

    void read_tlm(const uint8_t* p, u32 size) {
        if (size < 2) fail("Error reading TLM marker");
        size -= 2;
        rd(p, 1);
        u32 st = rd(p, 1);
        u32 ST = (st >> 4) & 3, SP = (st >> 6) & 1;
        if (ST == 3) fail("opj_j2k_read_tlm(): ST = 3 is invalid");
        u32 q = (SP + 1) * 2 + ST;
        if (size % q) fail("Error reading TLM marker");
    }

    void read_plt(const uint8_t* p, u32 size) {
        if (size < 1) fail("Error reading PLT marker");
        rd(p, 1);
        size -= 1;
        u32 len = 0;
        for (u32 i = 0; i < size; ++i) {
            u32 v = rd(p, 1);
            len |= v & 0x7f;
            if (v & 0x80) len <<= 7;
            else len = 0;
        }
        if (len != 0) fail("Error reading PLT marker");
    }

    void read_ppm(const uint8_t* p, u32 size) {
        if (size < 2) fail("Error reading PPM marker");
        cp.ppm = true;
        u32 z = rd(p, 1);
        size -= 1;
        if (cp.ppm_markers.size() <= z) {
            cp.ppm_markers.resize(z + 1);
            cp.ppm_have.resize(z + 1, false);
        }
        if (cp.ppm_have[z]) fail("Zppm already read");
        cp.ppm_have[z] = true;
        cp.ppm_markers[z].assign(p, p + size);
    }

    void merge_ppm() {
        if (!cp.ppm) return;
        u32 remaining = 0;
        u64 total = 0;
        for (size_t i = 0; i < cp.ppm_markers.size(); ++i) {
            if (!cp.ppm_have[i]) continue;
            const std::vector<uint8_t>& m = cp.ppm_markers[i];
            const uint8_t* d = m.data();
            u32 n = u32(m.size());
            if (remaining >= n) {
                remaining -= n;
                total += n;
                cp.ppm_buf.insert(cp.ppm_buf.end(), d, d + n);
                n = 0;
            } else {
                cp.ppm_buf.insert(cp.ppm_buf.end(), d, d + remaining);
                total += remaining;
                d += remaining;
                n -= remaining;
                remaining = 0;
            }
            while (n > 0) {
                if (n < 4) fail("Not enough bytes to read Nppm");
                const uint8_t* q = d;
                u32 nppm = rd(q, 4);
                d += 4;
                n -= 4;
                if (total > u64(0x7fffffff) - nppm) fail("Too large value for Nppm");
                if (n >= nppm) {
                    cp.ppm_buf.insert(cp.ppm_buf.end(), d, d + nppm);
                    total += nppm;
                    n -= nppm;
                    d += nppm;
                } else {
                    cp.ppm_buf.insert(cp.ppm_buf.end(), d, d + n);
                    total += n;
                    remaining = nppm - n;
                    n = 0;
                }
            }
        }
        if (remaining != 0) fail("Corrupted PPM markers");
        cp.ppm_markers.clear();
        cp.ppm_pos = 0;
    }

    void read_ppt(const uint8_t* p, u32 size) {
        if (size < 2) fail("Error reading PPT marker");
        if (cp.ppm) fail("Error reading PPT marker: the main header has PPM markers");
        Tcp& t = tcps[cur_tile];
        t.ppt = true;
        u32 z = rd(p, 1);
        size -= 1;
        if (t.ppt_markers.size() <= z) {
            t.ppt_markers.resize(z + 1);
            t.ppt_have.resize(z + 1, false);
        }
        if (t.ppt_have[z]) fail("Zppt already read");
        t.ppt_have[z] = true;
        t.ppt_markers[z].assign(p, p + size);
    }

    void merge_ppt(Tcp& t) {
        if (t.ppt_merged) fail("opj_j2k_merge_ppt() has already been called");
        if (!t.ppt) return;
        for (size_t i = 0; i < t.ppt_markers.size(); ++i)
            if (t.ppt_have[i])
                t.ppt_buf.insert(t.ppt_buf.end(), t.ppt_markers[i].begin(), t.ppt_markers[i].end());
        t.ppt_markers.clear();
        t.ppt_have.clear();
        t.ppt_merged = true;
        t.ppt_pos = 0;
    }

    // Part 2's MCT: checked only, since a COD's transform above 1 is refused
    void read_mct(const uint8_t* p, u32 size) {
        if (size < 2) fail("Error reading MCT marker");
        if (rd(p, 2) != 0) return;  // "mct data within multiple MCT records"
        if (size <= 6) fail("Error reading MCT marker");
    }

    // Part 2's MCO: a stage list, which takes the DC level shifts away
    void read_mco(const uint8_t* p, u32 size) {
        if (size < 1) fail("Error reading MCO marker");
        u32 stages = rd(p, 1);
        if (stages > 1) return;  // "Cannot take in charge multiple transformation stages"
        if (size != stages + 1) fail("Error reading MCO marker");
        for (Tccp& c : tcp().tccps) c.dc_level_shift = 0;
    }

    // Part 2's CBD: each component's depth and sign
    void read_cbd(const uint8_t* p, u32 size) {
        if (size != img.numcomps + 2) fail("Error reading CBD marker");
        if (rd(p, 2) != img.numcomps) fail("Error reading CBD marker");
        for (u32 i = 0; i < img.numcomps; ++i) {
            u32 v = rd(p, 1);
            img.comps[i].sgnd = (v >> 7) & 1;
            img.comps[i].prec = (v & 0x7f) + 1;
            if (img.comps[i].prec > 31) fail("Error reading CBD marker");
        }
    }

    void read_sot(const uint8_t* p, u32 size) {
        if (size != 8) fail("Error reading SOT marker");
        u32 tileno = rd(p, 2), tot = rd(p, 4), part = rd(p, 1), nparts = rd(p, 1);
        cur_tile = tileno;
        if (tileno >= cp.tw * cp.th) fail("Invalid tile number");
        Tcp& t = tcps[tileno];
        if (t.current_part + 1 != i32(part)) fail("Invalid tile part index for tile number");
        t.current_part = i32(part);
        if (tot != 0 && tot < 14 && tot != 12)
            fail("Psot value is not correct regards to the JPEG2000 norm");
        if (!tot) last_tile_part = true;
        if (t.nb_parts != 0 && part >= t.nb_parts) {
            last_tile_part = true;
            fail("In SOT marker, TPSot is not valid regards to the previous number of tile-part");
        }
        if (nparts != 0) {
            if (part >= nparts) {
                last_tile_part = true;
                fail("In SOT marker, TPSot is not valid regards to TNsot");
            }
            t.nb_parts = nparts;
        }
        if (t.nb_parts && t.nb_parts == part + 1) can_decode = true;
        sot_length = last_tile_part ? 0 : tot - 12;
        state = ST_TPH;
    }

    void handle(u32 m, const uint8_t* p, u32 size) {
        switch (m) {
        case M_SIZ: read_siz(p, size); break;
        case M_COD: read_cod(p, size); break;
        case M_COC: read_coc(p, size); break;
        case M_QCD: read_qcd(p, size); break;
        case M_QCC: read_qcc(p, size); break;
        case M_RGN: read_rgn(p, size); break;
        case M_POC: read_poc(p, size); break;
        case M_TLM: read_tlm(p, size); break;
        case M_PLM: if (size < 1) fail("Error reading PLM marker"); break;
        case M_PLT: read_plt(p, size); break;
        case M_PPM: read_ppm(p, size); break;
        case M_PPT: read_ppt(p, size); break;
        case M_CRG: if (size != img.numcomps * 4) fail("Error reading CRG marker"); break;
        case M_COM: break;
        case M_SOT: read_sot(p, size); break;
        case M_MCT: read_mct(p, size); break;
        case M_MCO: read_mco(p, size); break;
        case M_CBD: read_cbd(p, size); break;
        case M_MCC: case M_CAP: case M_CPF:
            fail("a Part 2 or HTJ2K marker segment (MCC, CAP or CPF; not read)");
        default: fail("Not sure how that happened.");
        }
    }

    // opj_j2k_read_unk: scan two bytes at a time for a known marker
    u32 read_unk() {
        for (;;) {
            u32 m;
            if (!s.read2(&m)) fail("Stream too short");
            if (m >= 0xff00) {
                bool known;
                u32 st = marker_states(m, &known);
                if (!(state & st)) fail("Marker is not compliant with its position");
                if (known) return m;
            }
        }
    }

    std::vector<uint8_t> seg;

    void read_segment(u32 m, bool tph) {
        u32 size;
        if (!s.read2(&size)) fail("Stream too short");
        if (size < 2) fail(tph ? "Inconsistent marker size" : "Invalid marker size");
        if (tph && (state & ST_TPH)) sot_length -= size + 2;
        size -= 2;
        seg.resize(size + 1);
        if (s.read(seg.data(), size) != size) fail("Stream too short");
        handle(m, seg.data(), size);
    }

    void read_main_header() {
        u32 m;
        if (!s.read2(&m) || m != M_SOC) fail("Expected a SOC marker");
        state = ST_MHSIZ;
        if (!s.read2(&m)) fail("Stream too short");
        bool has_siz = false, has_cod = false, has_qcd = false;
        while (m != M_SOT) {
            if (m < 0xff00) fail("A marker ID was expected (0xff--)");
            bool known;
            u32 st = marker_states(m, &known);
            if (!known) {
                m = read_unk();
                if (m == M_SOT) break;
                st = marker_states(m, &known);
            }
            if (m == M_SIZ) has_siz = true;
            if (m == M_COD) has_cod = true;
            if (m == M_QCD) has_qcd = true;
            if (!(state & st)) fail("Marker is not compliant with its position");
            read_segment(m, false);
            if (!s.read2(&m)) fail("Stream too short");
        }
        if (!has_siz) fail("required SIZ marker not found in main header");
        if (!has_cod) fail("required COD marker not found in main header");
        if (!has_qcd) fail("required QCD marker not found in main header");
        merge_ppm();
        state = ST_TPHSOT;
        // opj_j2k_copy_default_tcp_and_create_tcd
        tcps.assign(size_t(cp.tw) * cp.th, Tcp());
        for (Tcp& t : tcps) {
            t = dflt;
            t.cod = false;
            t.ppt = false;
            t.current_part = -1;
        }
    }

    void read_sod() {
        Tcp& t = tcps[cur_tile];
        if (last_tile_part) sot_length = u32(s.left() - 2);
        else if (sot_length >= 2) sot_length -= 2;
        bool pb = false;
        if (sot_length) {
            if (u64(sot_length) > s.left())
                fail("Tile part length size inconsistent with stream length");
            t.has_data = true;
        } else {
            pb = true;
        }
        u64 got = 0;
        if (!pb) {
            size_t at = t.data.size();
            t.data.resize(at + sot_length);
            got = s.read(t.data.data() + at, sot_length);
            t.data.resize(at + got);
        }
        state = got != sot_length ? ST_NEOC : ST_TPHSOT;
    }

    // opj_j2k_read_tile_header: the next tile to decode, or false at the end
    bool read_tile_header(u32* tileno) {
        u32 m = M_SOT;
        if (state == ST_EOC) m = M_EOC;
        else if (state != ST_TPHSOT) fail("opj_read_tile_header: not at a tile-part header");
        while (!can_decode && m != M_EOC) {
            while (m != M_SOD) {
                if (s.left() == 0) {
                    state = ST_NEOC;
                    break;
                }
                u32 size;
                if (!s.read2(&size)) fail("Stream too short");
                if (size < 2) fail("Inconsistent marker size");
                if (m == 0x8080 && s.left() == 0) {
                    state = ST_NEOC;
                    break;
                }
                if (state & ST_TPH) sot_length -= size + 2;
                size -= 2;
                bool known;
                u32 st = marker_states(m, &known);
                if (!(state & st)) fail("Marker is not compliant with its position");
                seg.resize(size + 1);
                if (s.read(seg.data(), size) != size) fail("Stream too short");
                if (!known) fail("Not sure how that happened.");
                handle(m, seg.data(), size);
                if (!s.read2(&m)) fail("Stream too short");
            }
            if (s.left() == 0 && state == ST_NEOC) break;
            read_sod();
            if (!can_decode) {
                if (!s.read2(&m)) fail("Stream too short");
            }
        }
        if (m == M_EOC && state != ST_EOC) {
            cur_tile = 0;
            state = ST_EOC;
        }
        u32 nb = cp.tw * cp.th;
        if (!can_decode) {
            while (cur_tile < nb && !tcps[cur_tile].has_data) ++cur_tile;
            if (cur_tile == nb) return false;
        }
        merge_ppt(tcps[cur_tile]);
        *tileno = cur_tile;
        state |= ST_DATA;
        return true;
    }

    // the end of opj_j2k_decode_tile, after a tile is decoded
    void after_tile() {
        Tcp& t = tcps[cur_tile];
        t.data.clear();
        t.data.shrink_to_fit();
        t.has_data = false;
        can_decode = false;
        state &= ~u32(ST_DATA);
        if (s.left() == 0 && state == ST_NEOC) return;
        if (state != ST_EOC) {
            u32 m;
            if (!s.read2(&m)) fail("Stream too short");
            if (m == M_EOC) {
                cur_tile = 0;
                state = ST_EOC;
            } else if (m != M_SOT) {
                if (s.left() == 0) {
                    state = ST_NEOC;
                    return;
                }
                fail("Stream too short, expected SOT");
            }
        }
    }
};

}  // namespace

namespace {

// ---- tile structures (opj_tcd_*) ----------------------------------------------

struct TagTree {
    struct Node {
        i32 parent, value, low;
    };
    std::vector<Node> nodes;
    void create(u32 w, u32 h) {
        nodes.clear();
        if (w == 0 || h == 0) return;
        i32 nplh[40], nplv[40];
        int lv = 0;
        nplh[0] = i32(w);
        nplv[0] = i32(h);
        u32 total = 0, n;
        do {
            n = u32(nplh[lv]) * u32(nplv[lv]);
            nplh[lv + 1] = (nplh[lv] + 1) / 2;
            nplv[lv + 1] = (nplv[lv] + 1) / 2;
            total += n;
            ++lv;
        } while (n > 1);
        nodes.assign(total, Node{-1, 999, 0});
        i32 node = 0, parent = i32(w * h), parent0 = parent;
        for (int i = 0; i < lv - 1; ++i) {
            for (i32 j = 0; j < nplv[i]; ++j) {
                i32 k = nplh[i];
                while (--k >= 0) {
                    nodes[node++].parent = parent;
                    if (--k >= 0) nodes[node++].parent = parent;
                    ++parent;
                }
                if ((j & 1) || j == nplv[i] - 1) {
                    parent0 = parent;
                } else {
                    parent = parent0;
                    parent0 += nplh[i];
                }
            }
        }
        nodes[node].parent = -1;
    }
    void reset() {
        for (Node& nd : nodes) { nd.value = 999; nd.low = 0; }
    }
};

struct Bio {
    const uint8_t *start, *end, *bp;
    u32 buf = 0, ct = 0;
    Bio(const uint8_t* p, u64 len) : start(p), end(p + len), bp(p) {}
    bool bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp >= end) return false;
        buf |= *bp++;
        return true;
    }
    u32 getbit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    u32 read(u32 n) {
        u32 v = 0;
        for (i32 i = i32(n) - 1; i >= 0; i--) v |= getbit() << i;
        return v;
    }
    bool inalign() {  // false past the end after a 0xff byte, as opj_bio_inalign
        if ((buf & 0xff) == 0xff && !bytein()) return false;
        ct = 0;
        return true;
    }
    u64 numbytes() const { return u64(bp - start); }
};

u32 tgt_decode(Bio& bio, TagTree& t, u32 leaf, i32 threshold) {
    i32 stk[40];
    int sp = 0;
    i32 node = i32(leaf);
    while (t.nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = t.nodes[node].parent;
    }
    i32 low = 0;
    for (;;) {
        TagTree::Node& nd = t.nodes[node];
        if (low > nd.low) nd.low = low;
        else low = nd.low;
        while (low < threshold && low < nd.value) {
            if (bio.read(1)) nd.value = low;
            else ++low;
        }
        nd.low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t.nodes[node].value < threshold ? 1 : 0;
}

struct Seg {
    u32 len, numpasses, real_num_passes, maxpasses, numnewpasses, newlen;
};

struct Cblk {
    i32 x0, y0, x1, y1;
    u32 numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
    std::vector<Seg> segs;
    std::vector<std::pair<u64, u32>> chunks;  // (offset in the tile data, length)
};

struct Precinct {
    i32 x0, y0, x1, y1;
    u32 cw = 0, ch = 0;
    TagTree incl, imsb;
    std::vector<Cblk> cblks;
};

struct Band {
    i32 x0, y0, x1, y1;
    u32 bandno;
    float stepsize;
    i32 numbps;
    std::vector<Precinct> precs;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    i32 x0, y0, x1, y1;
    u32 pw, ph, numbands;
    Band bands[3];
};

struct TileComp {
    i32 x0, y0, x1, y1;
    u32 numres;
    std::vector<Res> res;
    std::vector<i32> data;
};

struct Tile {
    i32 x0, y0, x1, y1;
    std::vector<TileComp> comps;
};

struct TileOut {
    u32 tileno;
    i32 x0, y0, x1, y1;
    std::vector<std::vector<i32>> planes;
    std::vector<u32> w, h;
};

void init_tile(Decoder& dec, u32 tileno, Tile& tile) {
    const Cp& cp = dec.cp;
    const Image& img = dec.img;
    Tcp& tcp = dec.tcps[tileno];
    u32 p = tileno % cp.tw, q = tileno / cp.tw;
    u32 l_tx0 = cp.tx0 + p * cp.tdx, l_ty0 = cp.ty0 + q * cp.tdy;
    tile.x0 = i32(l_tx0 > img.x0 ? l_tx0 : img.x0);
    tile.y0 = i32(l_ty0 > img.y0 ? l_ty0 : img.y0);
    u32 tx1 = uint_adds(l_tx0, cp.tdx), ty1 = uint_adds(l_ty0, cp.tdy);
    tile.x1 = i32(tx1 < img.x1 ? tx1 : img.x1);
    tile.y1 = i32(ty1 < img.y1 ? ty1 : img.y1);
    if (tile.x0 < 0 || tile.x1 < 0 || tile.y0 < 0 || tile.y1 < 0)
        fail("tile coordinates above 2^31");
    i64 ncblks = 0;
    tile.comps.resize(img.numcomps);
    for (u32 compno = 0; compno < img.numcomps; ++compno) {
        const Tccp& tccp = tcp.tccps[compno];
        const Comp& ic = img.comps[compno];
        TileComp& tc = tile.comps[compno];
        if (tccp.numresolutions == 0) fail("tiles require at least one resolution");
        tc.x0 = i32(ceildiv(u32(tile.x0), ic.dx));
        tc.y0 = i32(ceildiv(u32(tile.y0), ic.dy));
        tc.x1 = i32(ceildiv(u32(tile.x1), ic.dx));
        tc.y1 = i32(ceildiv(u32(tile.y1), ic.dy));
        tc.numres = tccp.numresolutions;
        i64 samples = i64(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
        if (samples > MAX_TILE_SAMPLES) fail("tile-component above the decoder's size limit");
        tc.res.assign(tc.numres, Res());
        const StepSize* ss = tccp.stepsizes;
        for (u32 resno = 0; resno < tc.numres; ++resno) {
            Res& r = tc.res[resno];
            i32 level = i32(tc.numres - 1 - resno);
            r.x0 = int_ceildivpow2(tc.x0, level);
            r.y0 = int_ceildivpow2(tc.y0, level);
            r.x1 = int_ceildivpow2(tc.x1, level);
            r.y1 = int_ceildivpow2(tc.y1, level);
            u32 pdx = tccp.prcw[resno], pdy = tccp.prch[resno];
            i32 tlx = int_floordivpow2(r.x0, i32(pdx)) << pdx;
            i32 tly = int_floordivpow2(r.y0, i32(pdy)) << pdy;
            u64 bx = u64(u32(int_ceildivpow2(r.x1, i32(pdx)))) << pdx;
            u64 by = u64(u32(int_ceildivpow2(r.y1, i32(pdy)))) << pdy;
            if (bx > 0x7fffffff || by > 0x7fffffff) fail("Integer overflow");
            r.pw = r.x0 == r.x1 ? 0 : u32((i32(bx) - tlx) >> pdx);
            r.ph = r.y0 == r.y1 ? 0 : u32((i32(by) - tly) >> pdy);
            u64 nprec = u64(r.pw) * r.ph;
            if (nprec > (u64(1) << 24)) fail("too many precincts");
            i32 cbgx, cbgy;
            u32 cbgw, cbgh;
            if (resno == 0) {
                cbgx = tlx; cbgy = tly; cbgw = pdx; cbgh = pdy;
                r.numbands = 1;
            } else {
                cbgx = int_ceildivpow2(tlx, 1); cbgy = int_ceildivpow2(tly, 1);
                cbgw = pdx - 1; cbgh = pdy - 1;
                r.numbands = 3;
            }
            u32 cbw = tccp.cblkw < cbgw ? tccp.cblkw : cbgw;
            u32 cbh = tccp.cblkh < cbgh ? tccp.cblkh : cbgh;
            for (u32 bandno = 0; bandno < r.numbands; ++bandno, ++ss) {
                Band& b = r.bands[bandno];
                if (resno == 0) {
                    b.bandno = 0;
                    b.x0 = int_ceildivpow2(tc.x0, level);
                    b.y0 = int_ceildivpow2(tc.y0, level);
                    b.x1 = int_ceildivpow2(tc.x1, level);
                    b.y1 = int_ceildivpow2(tc.y1, level);
                } else {
                    b.bandno = bandno + 1;
                    i64 x0b = b.bandno & 1, y0b = b.bandno >> 1;
                    b.x0 = int64_ceildivpow2(tc.x0 - (x0b << level), level + 1);
                    b.y0 = int64_ceildivpow2(tc.y0 - (y0b << level), level + 1);
                    b.x1 = int64_ceildivpow2(tc.x1 - (x0b << level), level + 1);
                    b.y1 = int64_ceildivpow2(tc.y1 - (y0b << level), level + 1);
                }
                // OpenJPEG's decoder takes no band gain on the 9/7 path (its two_invK)
                i32 log2_gain = tccp.qmfbid == 0 ? 0
                                : (b.bandno == 0 ? 0 : (b.bandno == 3 ? 2 : 1));
                i32 Rb = i32(ic.prec) + log2_gain;
                b.stepsize = float((1.0 + ss->mant / 2048.0) * pow(2.0, double(Rb - ss->expn)));
                b.numbps = ss->expn + i32(tccp.numgbits) - 1;
                if (b.empty()) continue;
                b.precs.assign(nprec, Precinct());
                for (u32 precno = 0; precno < nprec; ++precno) {
                    Precinct& pr = b.precs[precno];
                    i32 sx = cbgx + i32(precno % r.pw) * (1 << cbgw);
                    i32 sy = cbgy + i32(precno / r.pw) * (1 << cbgh);
                    i32 ex = sx + (1 << cbgw), ey = sy + (1 << cbgh);
                    pr.x0 = sx > b.x0 ? sx : b.x0;
                    pr.y0 = sy > b.y0 ? sy : b.y0;
                    pr.x1 = ex < b.x1 ? ex : b.x1;
                    pr.y1 = ey < b.y1 ? ey : b.y1;
                    i32 tcx = int_floordivpow2(pr.x0, i32(cbw)) << cbw;
                    i32 tcy = int_floordivpow2(pr.y0, i32(cbh)) << cbh;
                    i32 bcx = int_ceildivpow2(pr.x1, i32(cbw)) << cbw;
                    i32 bcy = int_ceildivpow2(pr.y1, i32(cbh)) << cbh;
                    pr.cw = bcx > tcx ? u32((bcx - tcx) >> cbw) : 0;
                    pr.ch = bcy > tcy ? u32((bcy - tcy) >> cbh) : 0;
                    u64 nc = u64(pr.cw) * pr.ch;
                    ncblks += i64(nc);
                    if (ncblks > MAX_CBLKS) fail("too many code-blocks in a tile");
                    pr.cblks.resize(nc);
                    for (u32 k = 0; k < nc; ++k) {
                        Cblk& cb = pr.cblks[k];
                        i32 cx = tcx + i32(k % pr.cw) * (1 << cbw);
                        i32 cy = tcy + i32(k / pr.cw) * (1 << cbh);
                        cb.x0 = cx > pr.x0 ? cx : pr.x0;
                        cb.y0 = cy > pr.y0 ? cy : pr.y0;
                        cb.x1 = cx + (1 << cbw) < pr.x1 ? cx + (1 << cbw) : pr.x1;
                        cb.y1 = cy + (1 << cbh) < pr.y1 ? cy + (1 << cbh) : pr.y1;
                    }
                    pr.incl.create(pr.cw, pr.ch);
                    pr.imsb.create(pr.cw, pr.ch);
                }
            }
        }
    }
}

// ---- tier 2 (opj_t2_*) --------------------------------------------------------

struct Packet {
    u32 compno, resno, precno, layno;
};

u32 getnumpasses(Bio& bio) {
    u32 n;
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    if ((n = bio.read(2)) != 3) return 3 + n;
    if ((n = bio.read(5)) != 31) return 6 + n;
    return 37 + bio.read(7);
}

u32 getcommacode(Bio& bio) {
    u32 n = 0;
    while (bio.read(1)) ++n;
    return n;
}

u32 floorlog2(u32 a) {
    u32 l = 0;
    while (a > 1) { a >>= 1; ++l; }
    return l;
}

void init_seg(Cblk& cb, u32 index, u32 cblksty, bool first) {
    if (index + 1 > MAX_SEGS) fail("too many segments in a code-block");
    if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
    Seg& s = cb.segs[index];
    memset(&s, 0, sizeof s);
    if (cblksty & 4) s.maxpasses = 1;
    else if (cblksty & 1) {
        if (first) s.maxpasses = 10;
        else {
            u32 before = cb.segs[index - 1].maxpasses;
            s.maxpasses = (before == 1 || before == 10) ? 2 : 1;
        }
    } else {
        s.maxpasses = 109;
    }
}

struct T2 {
    Decoder& dec;
    Tile& tile;
    Tcp& tcp;
    const uint8_t* src;  // the tile's data
    u64 pos, max;        // the current packet and the bytes left

    // opj_t2_read_packet_header; returns whether data follows
    bool read_header(const Packet& pk, u64* nread) {
        TileComp& tc = tile.comps[pk.compno];
        Res& r = tc.res[pk.resno];
        if (pk.layno == 0) {
            for (u32 b = 0; b < r.numbands; ++b) {
                Band& band = r.bands[b];
                if (band.empty()) continue;
                if (pk.precno >= band.precs.size()) fail("Invalid precinct");
                Precinct& pr = band.precs[pk.precno];
                pr.incl.reset();
                pr.imsb.reset();
                for (Cblk& cb : pr.cblks) { cb.numsegs = 0; cb.real_num_segs = 0; }
            }
        }
        u64 cur = pos;  // l_current_data
        if (tcp.csty & 2) {  // SOP: optional, only warned about
            if (max < 6) {
            } else if (src[cur] != 0xff || src[cur + 1] != 0x91) {
            } else {
                cur += 6;
            }
        }
        const uint8_t* hstart;
        u64* hpos;
        u64 hlen;
        u64 local_pos = 0;
        std::vector<uint8_t>* hbuf = nullptr;
        if (dec.cp.ppm) {
            hbuf = &dec.cp.ppm_buf;
            hpos = &dec.cp.ppm_pos;
        } else if (tcp.ppt) {
            hbuf = &tcp.ppt_buf;
            hpos = &tcp.ppt_pos;
        } else {
            hpos = &local_pos;
        }
        if (hbuf) {
            hstart = hbuf->data() + *hpos;
            hlen = hbuf->size() - *hpos;
        } else {
            hstart = src + cur;
            hlen = pos + max - cur;
        }
        Bio bio(hstart, hlen);
        u64 hdr = 0;  // l_header_data - start
        bool present = bio.read(1);
        if (present) {
            for (u32 b = 0; b < r.numbands; ++b) {
                Band& band = r.bands[b];
                if (band.empty()) continue;
                Precinct& pr = band.precs[pk.precno];
                u32 ncb = pr.cw * pr.ch;
                for (u32 k = 0; k < ncb; ++k) {
                    Cblk& cb = pr.cblks[k];
                    u32 included;
                    if (!cb.numsegs) included = tgt_decode(bio, pr.incl, k, i32(pk.layno + 1));
                    else included = bio.read(1);
                    if (!included) {
                        cb.numnewpasses = 0;
                        continue;
                    }
                    if (!cb.numsegs) {
                        u32 i = 0;
                        while (!tgt_decode(bio, pr.imsb, k, i32(i))) ++i;
                        cb.numbps = u32(band.numbps) + 1 - i;
                        cb.numlenbits = 3;
                    }
                    cb.numnewpasses = getnumpasses(bio);
                    u32 inc = getcommacode(bio);
                    cb.numlenbits += inc;
                    u32 segno = 0;
                    u32 sty = tcp.tccps[pk.compno].cblksty;
                    if (!cb.numsegs) {
                        init_seg(cb, 0, sty, true);
                    } else {
                        segno = cb.numsegs - 1;
                        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                            ++segno;
                            init_seg(cb, segno, sty, false);
                        }
                    }
                    i32 n = i32(cb.numnewpasses);
                    do {
                        Seg& s = cb.segs[segno];
                        i32 room = i32(s.maxpasses - s.numpasses);
                        s.numnewpasses = u32(room < n ? room : n);
                        u32 bits = cb.numlenbits + floorlog2(s.numnewpasses);
                        if (bits > 32) fail("Invalid bit number in opj_t2_read_packet_header()");
                        s.newlen = bio.read(bits);
                        n -= i32(s.numnewpasses);
                        if (n > 0) {
                            ++segno;
                            init_seg(cb, segno, sty, false);
                        }
                    } while (n > 0);
                }
            }
        }
        if (!bio.inalign()) fail("a packet header ends in a 0xff byte at the end of its data");
        hdr = bio.numbytes();
        if (tcp.csty & 4) {  // EPH: OpenJPEG 2.5.4 fails a packet without it
            if (hlen - hdr < 2) fail("Not enough space for expected EPH marker");
            if (hstart[hdr] != 0xff || hstart[hdr + 1] != 0x92) fail("Expected EPH marker");
            hdr += 2;
        }
        if (hbuf) *hpos += hdr;
        else cur += hdr;
        *nread = cur - pos;
        return present;
    }

    // opj_t2_read_packet_data
    u64 read_data(const Packet& pk, u64 at, u64 maxlen) {
        TileComp& tc = tile.comps[pk.compno];
        Res& r = tc.res[pk.resno];
        u64 cur = at;
        for (u32 b = 0; b < r.numbands; ++b) {
            Band& band = r.bands[b];
            if (band.empty()) continue;
            Precinct& pr = band.precs[pk.precno];
            u32 ncb = pr.cw * pr.ch;
            for (u32 k = 0; k < ncb; ++k) {
                Cblk& cb = pr.cblks[k];
                if (!cb.numnewpasses) continue;
                u32 si;
                if (!cb.numsegs) {
                    si = 0;
                    ++cb.numsegs;
                } else {
                    si = cb.numsegs - 1;
                    if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
                        ++si;
                        ++cb.numsegs;
                    }
                }
                do {
                    if (si >= cb.segs.size()) fail("segment index past the header's segments");
                    Seg& s = cb.segs[si];
                    if (cur + s.newlen > at + maxlen)
                        fail("read: segment too long for codeblock");
                    if (cb.chunks.size() >= (1u << 20)) fail("too many chunks in a code-block");
                    cb.chunks.push_back({cur, s.newlen});
                    cur += s.newlen;
                    s.len += s.newlen;
                    s.numpasses += s.numnewpasses;
                    cb.numnewpasses -= s.numnewpasses;
                    s.real_num_passes = s.numpasses;
                    if (cb.numnewpasses > 0) {
                        ++si;
                        ++cb.numsegs;
                    }
                } while (cb.numnewpasses > 0);
                cb.real_num_segs = cb.numsegs;
            }
        }
        return cur - at;
    }

    void decode_packet(const Packet& pk) {
        u64 n = 0;
        bool data = read_header(pk, &n);
        u64 at = pos + n, left = max - n;
        if (data) n += read_data(pk, at, left);
        pos += n;
        max -= n;
    }
};

// ---- the packet iterator (opj_pi_*) -------------------------------------------

struct PiRes {
    u32 pdx, pdy, pw, ph;
};

struct PiComp {
    u32 dx, dy, numres;
    std::vector<PiRes> res;
};

template <class F>
struct Pi {
    Decoder& dec;
    u32 tx0, ty0, tx1, ty1;
    u32 step_l, step_r, step_c;
    std::vector<PiComp> comps;
    std::vector<uint8_t>& include;
    F& emit;  // emit(packet)
    Poc poc;
    u32 layno0 = 0, precno1 = 0;

    bool mark(u32 layno, u32 resno, u32 compno, u32 precno) {
        u64 index = u64(layno) * step_l + u64(resno) * step_r + u64(compno) * step_c + precno;
        if (index >= include.size()) return false;  // "Invalid access to pi->include": the end
        if (!include[index]) {
            include[index] = 1;
            emit(Packet{compno, resno, precno, layno});
        }
        return true;
    }

    bool lrcp_like(bool rlcp) {
        u32 n = u32(comps.size());
        if (poc.compno0 >= n || poc.compno1 >= n + 1) return false;
        u32 L0 = layno0, L1 = poc.layno1, R0 = poc.resno0, R1 = poc.resno1;
        if (!rlcp) {
            for (u32 l = L0; l < L1; ++l)
                for (u32 r = R0; r < R1; ++r)
                    for (u32 c = poc.compno0; c < poc.compno1; ++c) {
                        if (r >= comps[c].numres) continue;
                        const PiRes& pr = comps[c].res[r];
                        u32 np = pr.pw * pr.ph;
                        for (u32 p = 0; p < np; ++p)
                            if (!mark(l, r, c, p)) return false;
                    }
        } else {
            for (u32 r = R0; r < R1; ++r)
                for (u32 l = L0; l < L1; ++l)
                    for (u32 c = poc.compno0; c < poc.compno1; ++c) {
                        if (r >= comps[c].numres) continue;
                        const PiRes& pr = comps[c].res[r];
                        u32 np = pr.pw * pr.ph;
                        for (u32 p = 0; p < np; ++p)
                            if (!mark(l, r, c, p)) return false;
                    }
        }
        return true;
    }

    static int min_step(const PiComp& c, u32 resno, u32* dx, u32* dy) {
        const PiRes& r = c.res[resno];
        u32 lv = c.numres - 1 - resno;
        bool okx = false, oky = false;
        if (r.pdx + lv < 32 && c.dx <= 0xFFFFFFFFu / (1u << (r.pdx + lv))) {
            *dx = c.dx * (1u << (r.pdx + lv));
            okx = true;
        }
        if (r.pdy + lv < 32 && c.dy <= 0xFFFFFFFFu / (1u << (r.pdy + lv))) {
            *dy = c.dy * (1u << (r.pdy + lv));
            oky = true;
        }
        return int(okx) | int(oky) << 1;
    }

    // the body shared by RPCL, PCRL and CPRL at one (resno, y, x, compno);
    // false ends the iteration
    bool position(u32 resno, u32 y, u32 x, u32 compno) {
        const PiComp& comp = comps[compno];
        if (resno >= comp.numres) return true;
        const PiRes& res = comp.res[resno];
        u32 lv = comp.numres - 1 - resno;
        if (u32((u64(comp.dx) << lv) >> lv) != comp.dx ||
            u32((u64(comp.dy) << lv) >> lv) != comp.dy)
            return true;
        u64 ddx = u64(comp.dx) << lv, ddy = u64(comp.dy) << lv;
        u32 trx0 = u32((u64(tx0) + ddx - 1) / ddx), try0 = u32((u64(ty0) + ddy - 1) / ddy);
        u32 trx1 = u32((u64(tx1) + ddx - 1) / ddx), try1 = u32((u64(ty1) + ddy - 1) / ddy);
        u32 rpx = res.pdx + lv, rpy = res.pdy + lv;
        if (rpx >= 64 || rpy >= 64) return true;
        if (u32((u64(comp.dx) << rpx) >> rpx) != comp.dx ||
            u32((u64(comp.dy) << rpy) >> rpy) != comp.dy)
            return true;
        if (!((u64(y) % (u64(comp.dy) << rpy) == 0) ||
              (y == ty0 && ((u64(try0) << lv) % (u64(1) << rpy)))))
            return true;
        if (!((u64(x) % (u64(comp.dx) << rpx) == 0) ||
              (x == tx0 && ((u64(trx0) << lv) % (u64(1) << rpx)))))
            return true;
        if (res.pw == 0 || res.ph == 0) return true;
        if (trx0 == trx1 || try0 == try1) return true;
        u32 prci = (u32((u64(x) + ddx - 1) / ddx) >> res.pdx) - (trx0 >> res.pdx);
        u32 prcj = (u32((u64(y) + ddy - 1) / ddy) >> res.pdy) - (try0 >> res.pdy);
        u32 precno = prci + prcj * res.pw;
        if (precno >= res.pw * res.ph) fail("precinct index past the resolution's precincts");
        for (u32 l = layno0; l < poc.layno1; ++l)
            if (!mark(l, resno, compno, precno)) return false;
        return true;
    }

    bool steps(u32 c0, u32 c1, u32* dx, u32* dy) {
        *dx = *dy = 0;
        for (u32 c = c0; c < c1; ++c)
            for (u32 r = 0; r < comps[c].numres; ++r) {
                u32 a = 0, b = 0;
                int ok = min_step(comps[c], r, &a, &b);
                if (ok & 1) *dx = !*dx ? a : (a < *dx ? a : *dx);
                if (ok & 2) *dy = !*dy ? b : (b < *dy ? b : *dy);
            }
        return *dx != 0 && *dy != 0;
    }

    bool rpcl() {
        u32 n = u32(comps.size());
        if (poc.compno0 >= n || poc.compno1 >= n + 1) return false;
        u32 dx, dy;
        if (!steps(0, n, &dx, &dy)) return false;
        for (u32 r = poc.resno0; r < poc.resno1; ++r)
            for (u32 y = ty0; y < ty1; y += dy - (y % dy))
                for (u32 x = tx0; x < tx1; x += dx - (x % dx))
                    for (u32 c = poc.compno0; c < poc.compno1; ++c)
                        if (!position(r, y, x, c)) return false;
        return true;
    }

    bool pcrl() {
        u32 n = u32(comps.size());
        if (poc.compno0 >= n || poc.compno1 >= n + 1) return false;
        u32 dx, dy;
        if (!steps(0, n, &dx, &dy)) return false;
        for (u32 y = ty0; y < ty1; y += dy - (y % dy))
            for (u32 x = tx0; x < tx1; x += dx - (x % dx))
                for (u32 c = poc.compno0; c < poc.compno1; ++c) {
                    u32 r1 = poc.resno1 < comps[c].numres ? poc.resno1 : comps[c].numres;
                    for (u32 r = poc.resno0; r < r1; ++r)
                        if (!position(r, y, x, c)) return false;
                }
        return true;
    }

    bool cprl() {
        u32 n = u32(comps.size());
        if (poc.compno0 >= n || poc.compno1 >= n + 1) return false;
        for (u32 c = poc.compno0; c < poc.compno1; ++c) {
            u32 dx, dy;
            if (!steps(c, c + 1, &dx, &dy)) return false;
            for (u32 y = ty0; y < ty1; y += dy - (y % dy))
                for (u32 x = tx0; x < tx1; x += dx - (x % dx)) {
                    u32 r1 = poc.resno1 < comps[c].numres ? poc.resno1 : comps[c].numres;
                    for (u32 r = poc.resno0; r < r1; ++r)
                        if (!position(r, y, x, c)) return false;
                }
        }
        return true;
    }

    void run() {
        switch (poc.prg) {
        case LRCP: lrcp_like(false); break;
        case RLCP: lrcp_like(true); break;
        case RPCL: rpcl(); break;
        case PCRL: pcrl(); break;
        case CPRL: cprl(); break;
        default: break;
        }
    }
};

}  // namespace

namespace {

// ---- tier 1: the MQ decoder (opj_mqc_*) ----------------------------------------

struct QeState {
    u32 qe;
    uint8_t nmps, nlps, sw;
};

const QeState QE[47] = {
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

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

struct Mqc {
    // the segment's bytes followed by OpenJPEG's artificial 0xFF 0xFF
    const uint8_t* bp;
    u32 a, c, ct;
    uint8_t st[NCTX], mps[NCTX];

    void reset_states() {
        for (int i = 0; i < NCTX; ++i) { st[i] = 0; mps[i] = 0; }
        st[CTX_UNI] = 46;
        st[CTX_AGG] = 3;
        st[CTX_ZC] = 4;
    }
    void bytein() {
        if (*bp == 0xff) {
            if (bp[1] > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                bp++;
                c += u32(*bp) << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += u32(*bp) << 8;
            ct = 8;
        }
    }
    void init(const uint8_t* p, u32 len) {
        bp = p;
        c = len == 0 ? 0xffu << 16 : u32(*bp) << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    u32 decode(int cx) {
        const QeState& q = QE[st[cx]];
        u32 d;
        a -= q.qe;
        if ((c >> 16) < q.qe) {
            if (a < q.qe) {
                a = q.qe;
                d = mps[cx];
                st[cx] = q.nmps;
            } else {
                a = q.qe;
                d = !mps[cx];
                if (q.sw) mps[cx] ^= 1;
                st[cx] = q.nlps;
            }
            renorm();
        } else {
            c -= q.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < q.qe) {
                    d = !mps[cx];
                    if (q.sw) mps[cx] ^= 1;
                    st[cx] = q.nlps;
                } else {
                    d = mps[cx];
                    st[cx] = q.nmps;
                }
                renorm();
            } else {
                d = mps[cx];
            }
        }
        return d;
    }
    // the raw (bypass) decoder
    void raw_init(const uint8_t* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    u32 raw() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp;
                    bp++;
                    ct = 7;
                }
            } else {
                c = *bp;
                bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1u;
    }
};

// ---- tier 1: EBCOT (opj_t1_*) ---------------------------------------------------

enum { F_SIG = 1, F_NEG = 2, F_VISIT = 4, F_REF = 8 };

struct T1 {
    u32 w, h, stride;
    std::vector<i32> data;
    std::vector<uint8_t> f;  // (h + 2) x (w + 2), a border of zeros
    Mqc mqc;
    int orient;
    bool vsc;

    uint8_t* at(u32 x, u32 y) { return &f[(y + 1) * stride + x + 1]; }
    // neighbour significance, with the rows below a stripe hidden under VSC
    void neigh(u32 x, u32 y, int* h, int* v, int* d) {
        uint8_t* p = at(x, y);
        bool below = !(vsc && (y & 3) == 3);
        int W = p[-1] & F_SIG, E = p[1] & F_SIG, N = p[-i64(stride)] & F_SIG;
        int S = below ? (p[stride] & F_SIG) : 0;
        int NW = p[-i64(stride) - 1] & F_SIG, NE = p[-i64(stride) + 1] & F_SIG;
        int SW = below ? (p[stride - 1] & F_SIG) : 0, SE = below ? (p[stride + 1] & F_SIG) : 0;
        *h = W + E;
        *v = N + S;
        *d = NW + NE + SW + SE;
    }
    int zc_ctx(u32 x, u32 y) {
        int h, v, d, n = 0;
        neigh(x, y, &h, &v, &d);
        if (orient == 3) {
            int hv = h + v;
            if (!d) n = !hv ? 0 : (hv == 1 ? 1 : 2);
            else if (d == 1) n = !hv ? 3 : (hv == 1 ? 4 : 5);
            else if (d == 2) n = !hv ? 6 : 7;
            else n = 8;
            return CTX_ZC + n;
        }
        if (orient == 1) { int t = h; h = v; v = t; }  // HL: vertical neighbours first
        if (!h) {
            if (!v) n = !d ? 0 : (d == 1 ? 1 : 2);
            else n = v == 1 ? 3 : 4;
        } else if (h == 1) {
            n = !v ? (!d ? 5 : 6) : 7;
        } else {
            n = 8;
        }
        return CTX_ZC + n;
    }
    bool any_neigh(u32 x, u32 y) {
        int h, v, d;
        neigh(x, y, &h, &v, &d);
        return h + v + d != 0;
    }
    int contrib(const uint8_t* p) { return (*p & F_SIG) ? ((*p & F_NEG) ? -1 : 1) : 0; }
    void sc_ctx(u32 x, u32 y, int* ctx, u32* xorbit) {
        uint8_t* p = at(x, y);
        bool below = !(vsc && (y & 3) == 3);
        int H = contrib(p - 1) + contrib(p + 1);
        int V = contrib(p - stride) + (below ? contrib(p + stride) : 0);
        H = H > 1 ? 1 : (H < -1 ? -1 : H);
        V = V > 1 ? 1 : (V < -1 ? -1 : V);
        static const int CT[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};  // [H+1][V+1]
        static const int XB[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
        *ctx = CT[H + 1][V + 1];
        *xorbit = u32(XB[H + 1][V + 1]);
    }
    void set_sig(u32 x, u32 y, u32 neg, i32 oph) {
        data[y * w + x] = neg ? -oph : oph;
        *at(x, y) |= F_SIG | (neg ? F_NEG : 0);
    }
    void decode_sign_mq(u32 x, u32 y, i32 oph) {
        int ctx;
        u32 xb;
        sc_ctx(x, y, &ctx, &xb);
        u32 v = mqc.decode(ctx) ^ xb;
        set_sig(x, y, v, oph);
    }

    void sigpass(i32 bpno, bool raw) {
        i32 one = 1 << bpno, half = one >> 1, oph = one | half;
        for (u32 k = 0; k < h; k += 4)
            for (u32 x = 0; x < w; ++x)
                for (u32 y = k; y < k + 4 && y < h; ++y) {
                    uint8_t* p = at(x, y);
                    if ((*p & (F_SIG | F_VISIT)) || !any_neigh(x, y)) continue;
                    if (raw) {
                        if (mqc.raw()) {
                            u32 v = mqc.raw();
                            set_sig(x, y, v, oph);
                        }
                    } else if (mqc.decode(zc_ctx(x, y))) {
                        decode_sign_mq(x, y, oph);
                    }
                    *p |= F_VISIT;
                }
    }

    void refpass(i32 bpno, bool raw) {
        i32 one = 1 << bpno, poshalf = one >> 1;
        for (u32 k = 0; k < h; k += 4)
            for (u32 x = 0; x < w; ++x)
                for (u32 y = k; y < k + 4 && y < h; ++y) {
                    uint8_t* p = at(x, y);
                    if ((*p & (F_SIG | F_VISIT)) != F_SIG) continue;
                    u32 v;
                    if (raw) {
                        v = mqc.raw();
                    } else {
                        int ctx = (*p & F_REF) ? CTX_MAG + 2
                                               : (any_neigh(x, y) ? CTX_MAG + 1 : CTX_MAG);
                        v = mqc.decode(ctx);
                    }
                    i32& dv = data[y * w + x];
                    dv += (v ^ u32(dv < 0)) ? poshalf : -poshalf;
                    *p |= F_REF;
                }
    }

    void clnpass(i32 bpno, bool segsym) {
        i32 one = 1 << bpno, half = one >> 1, oph = one | half;
        for (u32 k = 0; k < h; k += 4)
            for (u32 x = 0; x < w; ++x) {
                u32 y = k, y1 = k + 4 < h ? k + 4 : h;
                if (k + 4 <= h) {
                    bool agg = true;
                    for (u32 j = k; j < k + 4 && agg; ++j)
                        if ((*at(x, j) & (F_SIG | F_VISIT)) || any_neigh(x, j)) agg = false;
                    if (agg) {
                        if (!mqc.decode(CTX_AGG)) {
                            for (u32 j = k; j < k + 4; ++j) *at(x, j) &= ~F_VISIT;
                            continue;
                        }
                        u32 run = mqc.decode(CTX_UNI) << 1;
                        run |= mqc.decode(CTX_UNI);
                        y = k + run;
                        decode_sign_mq(x, y, oph);
                        ++y;
                    }
                }
                for (; y < y1; ++y) {
                    uint8_t* p = at(x, y);
                    if (*p & (F_SIG | F_VISIT)) continue;
                    if (mqc.decode(zc_ctx(x, y))) decode_sign_mq(x, y, oph);
                }
                for (u32 j = k; j < y1; ++j) *at(x, j) &= ~F_VISIT;
            }
        if (segsym) {
            for (int i = 0; i < 4; ++i) mqc.decode(CTX_UNI);
        }
    }
};

// opj_t1_decode_cblk; false where OpenJPEG fails the code-block
bool decode_cblk(T1& t1, const Cblk& cb, const uint8_t* tiledata, u32 orient, u32 roishift,
                 u32 cblksty, std::vector<uint8_t>& buf) {
    t1.w = u32(cb.x1 - cb.x0);
    t1.h = u32(cb.y1 - cb.y0);
    t1.stride = t1.w + 2;
    t1.data.assign(size_t(t1.w) * t1.h, 0);
    t1.f.assign(size_t(t1.stride) * (t1.h + 2), 0);
    t1.orient = int(orient);
    t1.vsc = (cblksty & 8) != 0;
    i32 bpno_plus_one = i32(roishift + cb.numbps);
    if (bpno_plus_one >= 31) return false;
    i32 passtype = 2;
    t1.mqc.reset_states();
    if (cb.chunks.empty()) return true;
    u64 total = 0;
    for (const auto& ch : cb.chunks) total += ch.second;
    buf.resize(total + 2);
    u64 at = 0;
    for (const auto& ch : cb.chunks) {
        if (ch.second) memcpy(buf.data() + at, tiledata + ch.first, ch.second);
        at += ch.second;
    }
    u64 index = 0;
    for (u32 segno = 0; segno < cb.real_num_segs; ++segno) {
        const Seg& seg = cb.segs[segno];
        bool raw = bpno_plus_one <= i32(cb.numbps) - 4 && passtype < 2 && (cblksty & 1);
        uint8_t* p = buf.data() + index;
        if (index + seg.len > total) return false;
        uint8_t backup[2] = {p[seg.len], p[seg.len + 1]};
        p[seg.len] = 0xff;
        p[seg.len + 1] = 0xff;
        if (raw) t1.mqc.raw_init(p);
        else t1.mqc.init(p, seg.len);
        index += seg.len;
        for (u32 passno = 0; passno < seg.real_num_passes && bpno_plus_one >= 1; ++passno) {
            switch (passtype) {
            case 0: t1.sigpass(bpno_plus_one, raw); break;
            case 1: t1.refpass(bpno_plus_one, raw); break;
            case 2: t1.clnpass(bpno_plus_one, (cblksty & 0x20) != 0); break;
            }
            if ((cblksty & 2) && !raw) t1.mqc.reset_states();
            if (++passtype == 3) {
                passtype = 0;
                bpno_plus_one--;
            }
        }
        p[seg.len] = backup[0];
        p[seg.len + 1] = backup[1];
    }
    return true;
}

// ---- the inverse transforms (opj_dwt_*) -----------------------------------------

inline i32 wadd(i32 a, i32 b) { return i32(u32(a) + u32(b)); }
inline i32 wsub(i32 a, i32 b) { return i32(u32(a) - u32(b)); }

// one line of the inverse 5/3: in holds sn low then dn high coefficients
void idwt53_line(i32* in, i32 sn, i32 dn, i32 cas, std::vector<i32>& tmp) {
    i32 len = sn + dn;
    tmp.resize(size_t(len > 0 ? len : 1));
    if (cas == 0) {
        if (len <= 1) return;
        const i32* ev = in;
        const i32* od = in + sn;
        i32 s1n = ev[0], d1n = od[0], s0n = wsub(s1n, (wadd(d1n, 1)) >> 1), d1c, s0c;
        i32 i, j;
        for (i = 0, j = 1; i < len - 3; i += 2, j++) {
            d1c = d1n;
            s0c = s0n;
            s1n = ev[j];
            d1n = od[j];
            s0n = wsub(s1n, wadd(wadd(d1c, d1n), 2) >> 2);
            tmp[i] = s0c;
            tmp[i + 1] = wadd(d1c, wadd(s0c, s0n) >> 1);
        }
        tmp[i] = s0n;
        if (len & 1) {
            tmp[len - 1] = wsub(ev[(len - 1) / 2], wadd(d1n, 1) >> 1);
            tmp[len - 2] = wadd(d1n, wadd(s0n, tmp[len - 1]) >> 1);
        } else {
            tmp[len - 1] = wadd(d1n, s0n);
        }
    } else {
        if (len == 1) {
            in[0] /= 2;
            return;
        }
        if (len == 2) {
            const i32* ev = in + sn;
            const i32* od = in;
            tmp[1] = wsub(od[0], wadd(ev[0], 1) >> 1);
            tmp[0] = wadd(ev[0], tmp[1]);
        } else if (len > 2) {
            const i32* ev = in + sn;
            const i32* od = in;
            i32 s1 = ev[1], s2, dn_, dc = wsub(od[0], wadd(wadd(ev[0], s1), 2) >> 2);
            tmp[0] = wadd(ev[0], dc);
            i32 i, j;
            for (i = 1, j = 1; i < len - 2 - !(len & 1); i += 2, j++) {
                s2 = ev[j + 1];
                dn_ = wsub(od[j], wadd(wadd(s1, s2), 2) >> 2);
                tmp[i] = dc;
                tmp[i + 1] = wadd(s1, wadd(dn_, dc) >> 1);
                dc = dn_;
                s1 = s2;
            }
            tmp[i] = dc;
            if (!(len & 1)) {
                dn_ = wsub(od[len / 2 - 1], wadd(s1, 1) >> 1);
                tmp[len - 2] = wadd(s1, wadd(dn_, dc) >> 1);
                tmp[len - 1] = dn_;
            } else {
                tmp[len - 1] = wadd(s1, dc);
            }
        } else {
            return;
        }
    }
    memcpy(in, tmp.data(), size_t(len) * sizeof(i32));
}

const float DWT_ALPHA = -1.586134342f, DWT_BETA = -0.052980118f, DWT_GAMMA = 0.882911075f,
            DWT_DELTA = 0.443506852f, DWT_K = 1.230174105f, TWO_INVK = 1.625732422f;

void v_step1(float* w, u32 start, u32 end, float c) {
    for (u32 i = start; i < end; ++i) w[2 * i] = w[2 * i] * c;
}

void v_step2(float* l, float* w, u32 start, u32 end, u32 m, float c) {
    u32 imax = end < m ? end : m;
    float* fl = l;
    float* fw = w;
    if (start > 0) {
        fw += 2 * start;
        fl = fw - 2;
    }
    for (u32 i = start; i < imax; ++i) {
        fw[-1] = fw[-1] + ((fl[0] + fw[0]) * c);
        fl = fw;
        fw += 2;
    }
    if (m < end) {
        c += c;
        fw[-1] = fw[-1] + fl[0] * c;
    }
}

// opj_v8dwt_decode on one lane: wavelet holds the interleaved line
void idwt97_line(float* wv, i32 sn, i32 dn, i32 cas) {
    i32 a, b;
    if (cas == 0) {
        if (!(dn > 0 || sn > 1)) return;
        a = 0; b = 1;
    } else {
        if (!(sn > 0 || dn > 1)) return;
        a = 1; b = 0;
    }
    v_step1(wv + a, 0, u32(sn), DWT_K);
    v_step1(wv + b, 0, u32(dn), TWO_INVK);
    u32 ml = u32(sn < dn - a ? sn : dn - a), mh = u32(dn < sn - b ? dn : sn - b);
    v_step2(wv + b, wv + a + 1, 0, u32(sn), ml, -DWT_DELTA);
    v_step2(wv + a, wv + b + 1, 0, u32(dn), mh, -DWT_GAMMA);
    v_step2(wv + b, wv + a + 1, 0, u32(sn), ml, -DWT_BETA);
    v_step2(wv + a, wv + b + 1, 0, u32(dn), mh, -DWT_ALPHA);
}

void idwt97_run(float* line, i32 sn, i32 dn, i32 cas, std::vector<float>& wv) {
    // interleave: low at 2i + cas, high at 2i + 1 - cas (with one spare slot)
    i32 len = sn + dn;
    wv.assign(size_t(2 * (len + 2)), 0.0f);
    for (i32 i = 0; i < sn; ++i) wv[size_t(2 * i + cas)] = line[i];
    for (i32 i = 0; i < dn; ++i) wv[size_t(2 * i + 1 - cas)] = line[sn + i];
    idwt97_line(wv.data(), sn, dn, cas);
    for (i32 k = 0; k < len; ++k) line[k] = wv[size_t(k)];
}

// the inverse transforms of the ``numres`` lowest resolutions (OpenJPEG
// transforms up to the highest resolution a packet reached)
void idwt(TileComp& tc, u32 qmfbid, u32 numres) {
    if (numres == 1) return;
    Res* r = &tc.res[0];
    u32 rw = u32(r->x1 - r->x0), rh = u32(r->y1 - r->y0);
    u32 w = u32(tc.res[tc.numres - 1].x1 - tc.res[tc.numres - 1].x0);  // the stride
    std::vector<i32> tmp, col;
    std::vector<float> wv, fcol;
    i32* d = tc.data.data();
    float* fd = reinterpret_cast<float*>(d);
    while (--numres) {
        ++r;
        i32 hsn = i32(rw), vsn = i32(rh);
        rw = u32(r->x1 - r->x0);
        rh = u32(r->y1 - r->y0);
        i32 hdn = i32(rw) - hsn, hcas = r->x0 % 2;
        i32 vdn = i32(rh) - vsn, vcas = r->y0 % 2;
        if (qmfbid == 1) {
            for (u32 j = 0; j < rh; ++j) idwt53_line(d + size_t(j) * w, hsn, hdn, hcas, tmp);
            col.resize(rh);
            for (u32 x = 0; x < rw; ++x) {
                for (u32 j = 0; j < rh; ++j) col[j] = d[size_t(j) * w + x];
                idwt53_line(col.data(), vsn, vdn, vcas, tmp);
                for (u32 j = 0; j < rh; ++j) d[size_t(j) * w + x] = col[j];
            }
        } else {
            for (u32 j = 0; j < rh; ++j) idwt97_run(fd + size_t(j) * w, hsn, hdn, hcas, wv);
            fcol.resize(rh);
            for (u32 x = 0; x < rw; ++x) {
                for (u32 j = 0; j < rh; ++j) fcol[j] = fd[size_t(j) * w + x];
                idwt97_run(fcol.data(), vsn, vdn, vcas, wv);
                for (u32 j = 0; j < rh; ++j) fd[size_t(j) * w + x] = fcol[j];
            }
        }
    }
}

}  // namespace

namespace {

// opj_tcd_decode_tile, then opj_tcd_update_tile_data's planes
void decode_tile(Decoder& dec, u32 tileno, TileOut& out) {
    Tcp& tcp = dec.tcps[tileno];
    Image& img = dec.img;
    Tile tile;
    init_tile(dec, tileno, tile);
    for (TileComp& tc : tile.comps) {
        i64 n = i64(tc.x1 - tc.x0) * (tc.y1 - tc.y0);
        tc.data.assign(size_t(n), 0);
    }
    // ---- tier 2 ----
    u32 numcomps = img.numcomps;
    u32 max_res = 0, max_prec = 0;
    std::vector<PiComp> pcs(numcomps);
    for (u32 c = 0; c < numcomps; ++c) {
        const Tccp& tccp = tcp.tccps[c];
        PiComp& pc = pcs[c];
        pc.dx = img.comps[c].dx;
        pc.dy = img.comps[c].dy;
        pc.numres = tccp.numresolutions;
        if (pc.numres > max_res) max_res = pc.numres;
        pc.res.resize(pc.numres);
        const TileComp& tc = tile.comps[c];
        for (u32 r = 0; r < pc.numres; ++r) {
            pc.res[r].pdx = tccp.prcw[r];
            pc.res[r].pdy = tccp.prch[r];
            pc.res[r].pw = tc.res[r].pw;
            pc.res[r].ph = tc.res[r].ph;
            u32 prod = tc.res[r].pw * tc.res[r].ph;
            if (prod > max_prec) max_prec = prod;
        }
    }
    u64 step_c = max_prec, step_r = u64(numcomps) * step_c, step_l = u64(max_res) * step_r;
    u64 isize = (u64(tcp.numlayers) + 1) * step_l;
    if (step_l > 0xFFFFFFFFu / (u64(tcp.numlayers) + 1)) fail("packet iterator too large");
    if (isize > u64(MAX_INCLUDE)) fail("packet iterator above the decoder's size limit");
    std::vector<uint8_t> include(size_t(isize), 0);
    T2 t2{dec, tile, tcp, tcp.data.data(), 0, tcp.data.size()};
    std::vector<bool> first_failed(numcomps);
    u32 npocs = tcp.poc ? tcp.numpocs + 1 : 1;
    for (u32 pino = 0; pino < npocs; ++pino) {
        Poc poc;
        if (tcp.poc) {
            poc = tcp.pocs[pino];
            if (poc.layno1 > tcp.numlayers) poc.layno1 = tcp.numlayers;
        } else {
            poc = Poc{0, 0, tcp.numlayers, max_res, numcomps, tcp.prg};
        }
        if (poc.prg == PROG_UNKNOWN) fail("unknown progression order");
        std::fill(first_failed.begin(), first_failed.end(), true);
        auto emit = [&](const Packet& pk) {
            if (pk.layno < tcp.numlayers && pk.resno < tile.comps[pk.compno].numres) {
                first_failed[pk.compno] = false;
                t2.decode_packet(pk);
                Comp& ic = img.comps[pk.compno];
                if (pk.resno > ic.resno_decoded) ic.resno_decoded = pk.resno;
            }
            if (first_failed[pk.compno]) {
                Comp& ic = img.comps[pk.compno];
                if (ic.resno_decoded == 0) ic.resno_decoded = tile.comps[pk.compno].numres - 1;
            }
        };
        Pi<decltype(emit)> pi{dec, u32(tile.x0), u32(tile.y0), u32(tile.x1), u32(tile.y1),
                              u32(step_l), u32(step_r), u32(step_c), pcs, include, emit, poc};
        pi.run();
    }
    // ---- tier 1 ----
    T1 t1;
    std::vector<uint8_t> buf;
    for (u32 c = 0; c < numcomps; ++c) {
        TileComp& tc = tile.comps[c];
        const Tccp& tccp = tcp.tccps[c];
        u32 tw = u32(tc.res[tc.numres - 1].x1 - tc.res[tc.numres - 1].x0);
        for (u32 resno = 0; resno < tc.numres; ++resno) {
            Res& r = tc.res[resno];
            for (u32 bi = 0; bi < r.numbands; ++bi) {
                Band& band = r.bands[bi];
                if (band.empty()) continue;
                for (Precinct& pr : band.precs)
                    for (Cblk& cb : pr.cblks) {
                        if (!decode_cblk(t1, cb, tcp.data.data(), band.bandno, tccp.roishift,
                                         tccp.cblksty, buf))
                            fail("opj_t1_decode_cblk(): unsupported bpno_plus_one >= 31");
                        i32 x = cb.x0 - band.x0, y = cb.y0 - band.y0;
                        if (band.bandno & 1) x += tc.res[resno - 1].x1 - tc.res[resno - 1].x0;
                        if (band.bandno & 2) y += tc.res[resno - 1].y1 - tc.res[resno - 1].y0;
                        u32 cw = t1.w, ch = t1.h;
                        i32* dp = t1.data.data();
                        if (tccp.roishift) {
                            if (tccp.roishift >= 31) {
                                std::fill(t1.data.begin(), t1.data.end(), 0);
                            } else {
                                i32 thresh = 1 << tccp.roishift;
                                for (size_t i = 0; i < t1.data.size(); ++i) {
                                    i32 v = dp[i];
                                    i32 mag = v < 0 ? -v : v;
                                    if (mag >= thresh) {
                                        mag >>= tccp.roishift;
                                        dp[i] = v < 0 ? -mag : mag;
                                    }
                                }
                            }
                        }
                        i32* td = tc.data.data() + size_t(y) * tw + x;
                        if (tccp.qmfbid == 1) {
                            for (u32 j = 0; j < ch; ++j)
                                for (u32 i = 0; i < cw; ++i)
                                    td[size_t(j) * tw + i] = dp[j * cw + i] / 2;
                        } else {
                            const float step = 0.5f * band.stepsize;
                            for (u32 j = 0; j < ch; ++j)
                                for (u32 i = 0; i < cw; ++i) {
                                    float v = float(dp[j * cw + i]) * step;
                                    memcpy(&td[size_t(j) * tw + i], &v, 4);
                                }
                        }
                    }
            }
        }
    }
    // ---- the inverse wavelet transforms ----
    for (u32 c = 0; c < numcomps; ++c) {
        if (img.comps[c].resno_decoded >= tile.comps[c].numres)
            fail("a component decoded past its tile's resolutions (not read)");
        idwt(tile.comps[c], tcp.tccps[c].qmfbid, img.comps[c].resno_decoded + 1);
    }
    // ---- MCT (opj_tcd_mct_decode) ----
    if (tcp.mct != 0) {
        TileComp& t0 = tile.comps[0];
        const Res& r0 = t0.res[t0.numres - 1];
        u64 n = u64(r0.x1 - r0.x0) * u64(r0.y1 - r0.y0);
        if (numcomps >= 3) {
            if (t0.numres != tile.comps[1].numres || t0.numres != tile.comps[2].numres)
                fail("Tiles don't all have the same dimension. Skip the MCT step.");
            const Res& r1 = tile.comps[1].res[t0.numres - 1];
            const Res& r2 = tile.comps[2].res[t0.numres - 1];
            if (img.comps[0].resno_decoded != img.comps[1].resno_decoded ||
                img.comps[0].resno_decoded != img.comps[2].resno_decoded ||
                u64(r1.x1 - r1.x0) * u64(r1.y1 - r1.y0) != n ||
                u64(r2.x1 - r2.x0) * u64(r2.y1 - r2.y0) != n)
                fail("Tiles don't all have the same dimension. Skip the MCT step.");
            i32* c0 = tile.comps[0].data.data();
            i32* c1 = tile.comps[1].data.data();
            i32* c2 = tile.comps[2].data.data();
            if (tcp.tccps[0].qmfbid == 1) {
                for (u64 i = 0; i < n; ++i) {
                    i32 y = c0[i], u = c1[i], v = c2[i];
                    i32 g = wsub(y, wadd(u, v) >> 2);
                    c0[i] = wadd(v, g);
                    c1[i] = g;
                    c2[i] = wadd(u, g);
                }
            } else {
                float *f0 = reinterpret_cast<float*>(c0), *f1 = reinterpret_cast<float*>(c1),
                      *f2 = reinterpret_cast<float*>(c2);
                for (u64 i = 0; i < n; ++i) {
                    float y = f0[i], u = f1[i], v = f2[i];
                    float r = y + (v * 1.402f);
                    float g = y - (u * 0.34413f);
                    g = g - (v * 0.71414f);
                    float b = y + (u * 1.772f);
                    f0[i] = r;
                    f1[i] = g;
                    f2[i] = b;
                }
            }
        }
    }
    // ---- DC level shift and clamp (opj_tcd_dc_level_shift_decode) ----
    out.tileno = tileno;
    out.x0 = tile.x0; out.y0 = tile.y0; out.x1 = tile.x1; out.y1 = tile.y1;
    out.planes.resize(numcomps);
    out.w.resize(numcomps);
    out.h.resize(numcomps);
    for (u32 c = 0; c < numcomps; ++c) {
        TileComp& tc = tile.comps[c];
        const Comp& ic = img.comps[c];
        const Tccp& tccp = tcp.tccps[c];
        const Res& r = tc.res[ic.resno_decoded];
        u32 w = u32(r.x1 - r.x0), h = u32(r.y1 - r.y0);
        u32 stride = u32(tc.res[tc.numres - 1].x1 - tc.res[tc.numres - 1].x0);
        i32 lo, hi;
        if (ic.sgnd) {
            lo = -(1 << (ic.prec - 1));
            hi = (1 << (ic.prec - 1)) - 1;
        } else {
            lo = 0;
            hi = i32((1u << ic.prec) - 1);
        }
        // the decoded resolution's region, at the tile-component's stride
        std::vector<i32> plane(size_t(w) * h);
        for (u32 j = 0; j < h; ++j)
            for (u32 i = 0; i < w; ++i) {
                i32 x = tc.data[size_t(j) * stride + i], v;
                if (tccp.qmfbid == 1) {
                    v = wadd(x, tccp.dc_level_shift);
                    v = v < lo ? lo : (v > hi ? hi : v);
                } else {
                    float f;
                    memcpy(&f, &x, 4);
                    if (f > float(2147483647)) {
                        v = hi;
                    } else if (f < float(-2147483647 - 1)) {
                        v = lo;
                    } else {
                        i64 q = i64(lrintf(f)) + tccp.dc_level_shift;
                        v = i32(q < lo ? lo : (q > hi ? hi : q));
                    }
                }
                plane[size_t(j) * w + i] = v;
            }
        out.planes[c].swap(plane);
        out.w[c] = w;
        out.h[c] = h;
    }
}

}  // namespace

extern "C" {

// Decode the codestream at data[start:n] as Pillow's OpenJPEG reads it
// tile by tile.  ihdr_w/ihdr_h: a JP2 header's size (0 for a raw
// codestream).  info (8 + 4 * 4 int64): x0, y0, x1, y1, numcomps, the
// stream position after the last read, the number of tiles decoded, 0;
// then dx, dy, prec, sgnd of each component.  *out: a malloc'd int32
// buffer, for each decoded tile in decoding order: tileno, x0, y0, x1, y1,
// then for each component w, h and w * h samples; *out_len its length.
// Returns 0, or 1 with the reason in `reason` (OpenJPEG fails the
// stream), or 2 when out of memory.
int gst_j2k_decode(const uint8_t* data, int64_t n, int64_t start, uint32_t ihdr_w,
                   uint32_t ihdr_h, int64_t* info, int32_t** out, int64_t* out_len,
                   char* reason, int64_t reason_len) {
    *out = nullptr;
    *out_len = 0;
    std::vector<TileOut> tiles;
    Decoder dec;
    dec.s = Stream{data, u64(n), u64(start)};
    dec.ihdr_w = ihdr_w;
    dec.ihdr_h = ihdr_h;
    int status = 0;
    try {
        dec.read_main_header();
        for (int k = 0; k < 8 + 16; ++k) info[k] = 0;
        info[0] = dec.img.x0; info[1] = dec.img.y0; info[2] = dec.img.x1; info[3] = dec.img.y1;
        info[4] = dec.img.numcomps;
        for (u32 c = 0; c < dec.img.numcomps; ++c) {
            info[8 + 4 * c] = dec.img.comps[c].dx;
            info[9 + 4 * c] = dec.img.comps[c].dy;
            info[10 + 4 * c] = dec.img.comps[c].prec;
            info[11 + 4 * c] = dec.img.comps[c].sgnd;
        }
        u32 tileno;
        while (dec.read_tile_header(&tileno)) {
            if (!dec.tcps[tileno].has_data) fail("a tile without data");
            tiles.emplace_back();
            decode_tile(dec, tileno, tiles.back());
            dec.after_tile();
        }
    } catch (const Fail& f) {
        status = 1;
        snprintf(reason, size_t(reason_len), "%s", f.why.c_str());
    } catch (const std::bad_alloc&) {
        status = 2;
        snprintf(reason, size_t(reason_len), "out of memory");
    }
    if (status) return status;
    info[5] = i64(dec.s.pos);
    info[6] = i64(tiles.size());
    u64 total = 0;
    for (const TileOut& t : tiles) {
        total += 5;
        for (size_t c = 0; c < t.planes.size(); ++c) total += 2 + t.planes[c].size();
    }
    int32_t* buf = static_cast<int32_t*>(malloc(size_t(total ? total : 1) * 4));
    if (!buf) {
        snprintf(reason, size_t(reason_len), "out of memory");
        return 2;
    }
    u64 at = 0;
    for (const TileOut& t : tiles) {
        buf[at++] = i32(t.tileno);
        buf[at++] = t.x0; buf[at++] = t.y0; buf[at++] = t.x1; buf[at++] = t.y1;
        for (size_t c = 0; c < t.planes.size(); ++c) {
            buf[at++] = i32(t.w[c]);
            buf[at++] = i32(t.h[c]);
            if (!t.planes[c].empty()) memcpy(buf + at, t.planes[c].data(), t.planes[c].size() * 4);
            at += t.planes[c].size();
        }
    }
    *out = buf;
    *out_len = i64(total);
    return 0;
}

}  // extern "C"
