// Fast legacy-VTK ASCII serialization/parsing.
//
// The port's own copy of yalla_tpu/_native/vtkio_native.cpp's serializer
// (ref include/vtk.cuh): at 500k cells a frame the ASCII formatting is a
// host-side hot path, which vtkio.Vtk_output overlaps with the device's
// work on a worker thread (ref examples/branching.cu:263-281).  Uses C++17
// std::to_chars / from_chars.
//
// Plain C ABI; bound from Python via ctypes.

#include <charconv>
#include <cstdint>
#include <cstring>

namespace {

inline char* put_float(char* p, char* end, float v)
{
    auto res = std::to_chars(p, end, v);  // shortest round-trip form
    return res.ec == std::errc() ? res.ptr : nullptr;
}

inline char* put_int(char* p, char* end, long v)
{
    auto res = std::to_chars(p, end, v);
    return res.ec == std::errc() ? res.ptr : nullptr;
}

}  // namespace

extern "C" {

// n rows of `width` floats, space-separated, newline-terminated.
// Returns bytes written, or -1 if `cap` is too small.
long yt_format_rows(const float* data, long n, int width, char* out, long cap)
{
    char* p = out;
    char* end = out + cap;
    for (long i = 0; i < n; ++i) {
        for (int c = 0; c < width; ++c) {
            if (end - p < 64) return -1;
            p = put_float(p, end, data[i * width + c]);
            if (!p) return -1;
            *p++ = (c + 1 == width) ? '\n' : ' ';
        }
    }
    return p - out;
}

// One int per line.
long yt_format_ints(const int32_t* v, long n, char* out, long cap)
{
    char* p = out;
    char* end = out + cap;
    for (long i = 0; i < n; ++i) {
        if (end - p < 32) return -1;
        p = put_int(p, end, v[i]);
        if (!p) return -1;
        *p++ = '\n';
    }
    return p - out;
}

// VERTICES block: "1 i\n" per point (ref vtk.cuh:124-125).
long yt_format_vertices(long n, char* out, long cap)
{
    char* p = out;
    char* end = out + cap;
    for (long i = 0; i < n; ++i) {
        if (end - p < 32) return -1;
        *p++ = '1';
        *p++ = ' ';
        p = put_int(p, end, i);
        if (!p) return -1;
        *p++ = '\n';
    }
    return p - out;
}

// LINES block: "2 a b\n" per link (ref vtk.cuh:142-144).
long yt_format_lines(const int32_t* a, const int32_t* b, long n, char* out,
                     long cap)
{
    char* p = out;
    char* end = out + cap;
    for (long i = 0; i < n; ++i) {
        if (end - p < 48) return -1;
        *p++ = '2';
        *p++ = ' ';
        p = put_int(p, end, a[i]);
        if (!p) return -1;
        *p++ = ' ';
        p = put_int(p, end, b[i]);
        if (!p) return -1;
        *p++ = '\n';
    }
    return p - out;
}

// Parse up to `cap` whitespace-separated floats; returns the count
// parsed.
long yt_parse_floats(const char* text, long len, float* out, long cap)
{
    const char* p = text;
    const char* end = text + len;
    long k = 0;
    while (p < end && k < cap) {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' ||
                           *p == '\t')) ++p;
        if (p >= end) break;
        float v;
        auto res = std::from_chars(p, end, v);
        if (res.ec != std::errc()) break;
        out[k++] = v;
        p = res.ptr;
    }
    return k;
}

// Parse up to `cap` whitespace-separated numbers as doubles (int32
// properties must round-trip exactly); returns the count parsed.
long yt_parse_doubles(const char* text, long len, double* out, long cap)
{
    const char* p = text;
    const char* end = text + len;
    long k = 0;
    while (p < end && k < cap) {
        while (p < end && (*p == ' ' || *p == '\n' || *p == '\r' ||
                           *p == '\t')) ++p;
        if (p >= end) break;
        double v;
        auto res = std::from_chars(p, end, v);
        if (res.ec != std::errc()) break;
        out[k++] = v;
        p = res.ptr;
    }
    return k;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------------
// Point-in-closed-mesh test for mesh.py (a geometry service beside the
// serializer), the port's copy of the JAX package's yt_test_exclusion.
//
// The reference's Mesh::test_exclusion ray-triangle parity walk
// (ref include/mesh.cuh:379-419): for each point, count the intersections
// of the fixed ray direction with the facets; an even count means outside.
// O(1) memory, parallel over points where the build has OpenMP.
long yt_test_exclusion(const double* pts, long n_pts,
                       const double* verts,  // [n_f, 3, 3]
                       long n_f, const double* ray, unsigned char* out)
{
    const double dx = ray[0], dy = ray[1], dz = ray[2];
    // Per-facet invariants (normal, barycentric Gram terms, ray
    // denominator), hoisted out of the point loop.  Facets parallel to the
    // ray or degenerate (den == 0 / Gram determinant == 0) never register a
    // hit and are left out.
    struct Facet {
        double v0x, v0y, v0z;           // vertex 0
        double ux, uy, uz, vx, vy, vz;  // edge vectors
        double nx, ny, nz;              // normal (u x v)
        double inv_den;                 // 1 / (n . ray)
        double n_v0;                    // n . v0
        double uu_d, vv_d, uv_d;        // Gram terms / Gram determinant
    };
    Facet* F = new Facet[n_f];
    long n_live = 0;
    for (long f = 0; f < n_f; ++f) {
        const double* V = verts + f * 9;
        Facet c;
        c.v0x = V[0]; c.v0y = V[1]; c.v0z = V[2];
        c.ux = V[3] - V[0]; c.uy = V[4] - V[1]; c.uz = V[5] - V[2];
        c.vx = V[6] - V[0]; c.vy = V[7] - V[1]; c.vz = V[8] - V[2];
        c.nx = c.uy * c.vz - c.uz * c.vy;
        c.ny = c.uz * c.vx - c.ux * c.vz;
        c.nz = c.ux * c.vy - c.uy * c.vx;
        const double den = c.nx * dx + c.ny * dy + c.nz * dz;
        const double uu = c.ux * c.ux + c.uy * c.uy + c.uz * c.uz;
        const double vv = c.vx * c.vx + c.vy * c.vy + c.vz * c.vz;
        const double uv = c.ux * c.vx + c.uy * c.vy + c.uz * c.vz;
        const double denom = uv * uv - uu * vv;
        if (den == 0.0 || denom == 0.0) continue;
        c.inv_den = 1.0 / den;
        c.n_v0 = c.nx * V[0] + c.ny * V[1] + c.nz * V[2];
        const double inv_denom = 1.0 / denom;
        c.uu_d = uu * inv_denom;
        c.vv_d = vv * inv_denom;
        c.uv_d = uv * inv_denom;
        F[n_live++] = c;
    }
#pragma omp parallel for schedule(static)
    for (long i = 0; i < n_pts; ++i) {
        const double px = pts[i * 3], py = pts[i * 3 + 1],
                     pz = pts[i * 3 + 2];
        long hits = 0;
        for (long f = 0; f < n_live; ++f) {
            const Facet& c = F[f];
            const double r = (c.n_v0 - (c.nx * px + c.ny * py
                                        + c.nz * pz)) * c.inv_den;
            if (r < 0.0) continue;
            const double wx = px + dx * r - c.v0x;
            const double wy = py + dy * r - c.v0y;
            const double wz = pz + dz * r - c.v0z;
            const double wu = wx * c.ux + wy * c.uy + wz * c.uz;
            const double wv = wx * c.vx + wy * c.vy + wz * c.vz;
            const double s = c.uv_d * wv - c.vv_d * wu;
            const double t = c.uv_d * wu - c.uu_d * wv;
            if (s >= 0.0 && s <= 1.0 && t >= 0.0 && s + t <= 1.0) ++hits;
        }
        out[i] = (hits % 2 == 0) ? 1 : 0;  // even = outside
    }
    delete[] F;
    return n_pts;
}

}  // extern "C"
