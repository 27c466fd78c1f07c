// Native host-side parsers for the gaussian_splatterer_tpu runtime.
//
// The reference does all of its file parsing in C++ (OBJ:
// src/rtx/RtxHost.cpp:107-186, .gobj: src/ui/UiFrame.cpp:373-450); this
// library is the equivalent native path for our framework — the Python
// implementations in io/obj.py and io/gobj.py remain as the portable
// fallback.  Exposed as a plain C ABI consumed via ctypes (no pybind11 in
// the build image).
//
// Memory contract: each load_* call returns malloc'd buffers through out
// params; the caller must free every buffer with gst_free().  Counts are
// element counts, not bytes.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Read a whole file into a string; empty on failure.
std::string slurp(const char* path) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return {};
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::string buf(static_cast<size_t>(n), '\0');
    size_t got = std::fread(buf.data(), 1, static_cast<size_t>(n), f);
    std::fclose(f);
    buf.resize(got);
    return buf;
}

struct Cursor {
    const char* p;
    const char* end;
    bool eof() const { return p >= end; }
    void skip_ws_inline() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    }
    void next_line() {
        while (p < end && *p != '\n') ++p;
        if (p < end) ++p;
    }
    bool parse_float(float* out) {
        skip_ws_inline();
        char* q = nullptr;
        float v = std::strtof(p, &q);
        if (q == p) return false;
        p = q;
        *out = v;
        return true;
    }
    bool parse_long(long* out) {
        skip_ws_inline();
        char* q = nullptr;
        long v = std::strtol(p, &q, 10);
        if (q == p) return false;
        p = q;
        *out = v;
        return true;
    }
};

float* to_heap(const std::vector<float>& v) {
    float* out = static_cast<float*>(std::malloc(v.size() * sizeof(float)));
    if (out && !v.empty()) std::memcpy(out, v.data(), v.size() * sizeof(float));
    return out;
}

int32_t* to_heap(const std::vector<int32_t>& v) {
    int32_t* out = static_cast<int32_t*>(std::malloc(v.size() * sizeof(int32_t)));
    if (out && !v.empty()) std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
    return out;
}

}  // namespace

extern "C" {

void gst_free(void* p) { std::free(p); }

// Wavefront OBJ with the reference's semantics: v / vt / f with tri+quad
// faces and v/vt[/vn] corner indices; per-triangle UVs resolved eagerly,
// (0,0) when any corner lacks a vt index.
// Outputs: vertices (V*3 f32), triangles (T*3 i32), tri_uv (T*3*2 f32).
int gst_load_obj(const char* path,
                 float** out_vertices, int64_t* out_num_vertices,
                 int32_t** out_triangles, int64_t* out_num_triangles,
                 float** out_tri_uv) {
    std::string data = slurp(path);
    if (data.empty()) return -1;
    Cursor c{data.data(), data.data() + data.size()};

    std::vector<float> verts;
    std::vector<float> uvs;
    std::vector<int32_t> tris;
    std::vector<int64_t> tri_uv_idx;  // 1-based vt index per corner, 0 = none

    while (!c.eof()) {
        c.skip_ws_inline();
        if (c.eof()) break;
        if (c.p[0] == 'v' && c.p + 1 < c.end && (c.p[1] == ' ' || c.p[1] == '\t')) {
            c.p += 1;
            float x = 0, y = 0, z = 0;
            if (!c.parse_float(&x) || !c.parse_float(&y) || !c.parse_float(&z))
                return -2;
            verts.push_back(x);
            verts.push_back(y);
            verts.push_back(z);
        } else if (c.p[0] == 'v' && c.p + 2 < c.end && c.p[1] == 't' &&
                   (c.p[2] == ' ' || c.p[2] == '\t')) {
            c.p += 2;
            float u = 0, v = 0;
            if (!c.parse_float(&u) || !c.parse_float(&v)) return -2;
            uvs.push_back(u);
            uvs.push_back(v);
        } else if (c.p[0] == 'f' && c.p + 1 < c.end &&
                   (c.p[1] == ' ' || c.p[1] == '\t')) {
            c.p += 1;
            long vi[4] = {0, 0, 0, 0};
            long ti[4] = {0, 0, 0, 0};
            int corners = 0;
            while (corners < 4) {
                c.skip_ws_inline();
                if (c.eof() || *c.p == '\n' || *c.p == '#') break;
                long v = 0;
                if (!c.parse_long(&v)) break;
                long t = 0;
                if (!c.eof() && *c.p == '/') {
                    ++c.p;
                    if (!c.eof() && *c.p != '/') c.parse_long(&t);
                    if (!c.eof() && *c.p == '/') {
                        ++c.p;
                        long n = 0;
                        c.parse_long(&n);  // normal index ignored
                    }
                }
                vi[corners] = v;
                ti[corners] = t;
                ++corners;
            }
            if (corners != 3 && corners != 4) return -3;
            // OBJ relative (negative) indices count back from the latest
            // defined vertex/uv; resolve and bounds-check here so bad
            // indices error out instead of wrapping in numpy downstream
            const long nverts = static_cast<long>(verts.size()) / 3;
            const long nuv = static_cast<long>(uvs.size()) / 2;
            for (int k = 0; k < corners; ++k) {
                if (vi[k] < 0) vi[k] = nverts + vi[k] + 1;
                if (vi[k] < 1 || vi[k] > nverts) return -3;
                if (ti[k] < 0) ti[k] = nuv + ti[k] + 1;
            }
            static const int quad_split[2][3] = {{0, 1, 2}, {0, 2, 3}};
            int ntri = corners == 4 ? 2 : 1;
            for (int k = 0; k < ntri; ++k) {
                for (int j = 0; j < 3; ++j) {
                    int ci = quad_split[k][j];
                    tris.push_back(static_cast<int32_t>(vi[ci] - 1));
                    tri_uv_idx.push_back(ti[ci]);
                }
            }
        }
        c.next_line();
    }

    int64_t t_count = static_cast<int64_t>(tris.size()) / 3;
    std::vector<float> tri_uv(static_cast<size_t>(t_count) * 6, 0.0f);
    int64_t uv_count = static_cast<int64_t>(uvs.size()) / 2;
    for (int64_t i = 0; i < t_count; ++i) {
        bool all = true;
        for (int j = 0; j < 3; ++j)
            if (tri_uv_idx[i * 3 + j] <= 0 || tri_uv_idx[i * 3 + j] > uv_count)
                all = false;
        if (!all) continue;
        for (int j = 0; j < 3; ++j) {
            int64_t u = tri_uv_idx[i * 3 + j] - 1;
            tri_uv[i * 6 + j * 2 + 0] = uvs[u * 2 + 0];
            tri_uv[i * 6 + j * 2 + 1] = uvs[u * 2 + 1];
        }
    }

    *out_vertices = to_heap(verts);
    *out_num_vertices = static_cast<int64_t>(verts.size()) / 3;
    *out_triangles = to_heap(tris);
    *out_num_triangles = t_count;
    *out_tri_uv = to_heap(tri_uv);
    return 0;
}

// .gobj splat text format (lines: v / sh / s / a / r — reference writer
// src/ui/UiFrame.cpp:333-358).  SH coefficient count inferred from the
// first sh line; inconsistent widths are an error (-3).
// Outputs: means (N*3), shs (N*shvals), scales (N*3), opacities (N),
// rotations (N*4); *out_sh_vals = 3*K.
int gst_load_gobj(const char* path,
                  float** out_means, float** out_shs, float** out_scales,
                  float** out_opacities, float** out_rotations,
                  int64_t* out_count, int64_t* out_sh_vals) {
    std::string data = slurp(path);
    if (data.empty()) return -1;
    Cursor c{data.data(), data.data() + data.size()};

    std::vector<float> means, shs, scales, opacities, rotations;
    int64_t sh_vals = -1;

    while (!c.eof()) {
        c.skip_ws_inline();
        if (c.eof()) break;
        char tag = c.p[0];
        char tag2 = (c.p + 1 < c.end) ? c.p[1] : '\0';
        if (tag == 'v' && (tag2 == ' ' || tag2 == '\t')) {
            c.p += 1;
            float x, y, z;
            if (!c.parse_float(&x) || !c.parse_float(&y) || !c.parse_float(&z))
                return -2;
            means.push_back(x);
            means.push_back(y);
            means.push_back(z);
        } else if (tag == 's' && tag2 == 'h') {
            c.p += 2;
            int64_t got = 0;
            float v;
            while (c.parse_float(&v)) {
                shs.push_back(v);
                ++got;
            }
            if (sh_vals < 0) sh_vals = got;
            else if (sh_vals != got) return -3;
        } else if (tag == 's' && (tag2 == ' ' || tag2 == '\t')) {
            c.p += 1;
            float x, y, z;
            if (!c.parse_float(&x) || !c.parse_float(&y) || !c.parse_float(&z))
                return -2;
            scales.push_back(x);
            scales.push_back(y);
            scales.push_back(z);
        } else if (tag == 'a' && (tag2 == ' ' || tag2 == '\t')) {
            c.p += 1;
            float a;
            if (!c.parse_float(&a)) return -2;
            opacities.push_back(a);
        } else if (tag == 'r' && (tag2 == ' ' || tag2 == '\t')) {
            c.p += 1;
            float w, x, y, z;
            if (!c.parse_float(&w) || !c.parse_float(&x) || !c.parse_float(&y) ||
                !c.parse_float(&z))
                return -2;
            rotations.push_back(w);
            rotations.push_back(x);
            rotations.push_back(y);
            rotations.push_back(z);
        }
        c.next_line();
    }

    int64_t n = static_cast<int64_t>(opacities.size());
    if (static_cast<int64_t>(means.size()) != n * 3 ||
        static_cast<int64_t>(scales.size()) != n * 3 ||
        static_cast<int64_t>(rotations.size()) != n * 4 ||
        (n > 0 && static_cast<int64_t>(shs.size()) != n * sh_vals))
        return -4;

    *out_means = to_heap(means);
    *out_shs = to_heap(shs);
    *out_scales = to_heap(scales);
    *out_opacities = to_heap(opacities);
    *out_rotations = to_heap(rotations);
    *out_count = n;
    *out_sh_vals = sh_vals < 0 ? 0 : sh_vals;
    return 0;
}

// Fast .gobj writer (the Python f-string writer is the slow path for
// million-splat models).
int gst_save_gobj(const char* path, const float* means, const float* shs,
                  const float* scales, const float* opacities,
                  const float* rotations, int64_t count, int64_t sh_vals) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::string buf;
    buf.reserve(1 << 20);
    char tmp[64];
    for (int64_t i = 0; i < count; ++i) {
        std::snprintf(tmp, sizeof tmp, "v %g %g %g\n", means[i * 3],
                      means[i * 3 + 1], means[i * 3 + 2]);
        buf += tmp;
        buf += "sh";
        for (int64_t k = 0; k < sh_vals; ++k) {
            std::snprintf(tmp, sizeof tmp, " %g", shs[i * sh_vals + k]);
            buf += tmp;
        }
        buf += '\n';
        std::snprintf(tmp, sizeof tmp, "s %g %g %g\n", scales[i * 3],
                      scales[i * 3 + 1], scales[i * 3 + 2]);
        buf += tmp;
        std::snprintf(tmp, sizeof tmp, "a %g\n", opacities[i]);
        buf += tmp;
        std::snprintf(tmp, sizeof tmp, "r %g %g %g %g\n", rotations[i * 4],
                      rotations[i * 4 + 1], rotations[i * 4 + 2],
                      rotations[i * 4 + 3]);
        buf += tmp;
        if (buf.size() > (1 << 20)) {
            std::fwrite(buf.data(), 1, buf.size(), f);
            buf.clear();
        }
    }
    std::fwrite(buf.data(), 1, buf.size(), f);
    std::fclose(f);
    return 0;
}

}  // extern "C"
