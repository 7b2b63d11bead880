// Host-side kernels of the BOP test reader and the BOP19 evaluator: RLE
// mask decoding, mask -> index extraction, depth backprojection and the
// exact triangle z-buffer of the VSD renderer (counterpart of the JAX
// package's unopose_tpu/native/hostops.cpp). A plain C interface, loaded
// through ctypes by data/native.py, which builds it at first use (build.sh)
// and keeps a numpy version of every entry point.
//
// Build: c++ -O3 -shared -fPIC hostops.cpp -o libhostops.so  (see build.sh)

#include <cstdint>
#include <cstring>

extern "C" {

// Uncompressed COCO-style RLE -> bool mask, Fortran (column-major) order.
// counts alternate background/foreground runs. out must hold `total` bytes.
void rle_decode(const int64_t* counts, int64_t n_counts, uint8_t* out, int64_t total) {
    std::memset(out, 0, (size_t)total);
    int64_t pos = 0;
    for (int64_t i = 0; i < n_counts && pos < total; ++i) {
        int64_t run = counts[i];
        if (run < 0) run = 0;
        if (pos + run > total) run = total - pos;
        if (i & 1) std::memset(out + pos, 1, (size_t)run);
        pos += run;
    }
}

// COCO compressed (LEB128-style char) RLE -> counts. Returns count of runs
// written (<= max_counts), or -1 on malformed input.
int64_t rle_decompress_counts(const char* s, int64_t len, int64_t* counts, int64_t max_counts) {
    int64_t m = 0, i = 0;
    while (i < len && m < max_counts) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= len) return -1;
            int64_t c = (int64_t)(s[i]) - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
            if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
        }
        if (m > 2) x += counts[m - 2];
        counts[m++] = x;
    }
    return m;
}

// Flat nonzero indices (row-major) of a (h, w) uint8 mask -> idx, returns count.
int64_t mask_nonzero(const uint8_t* mask, int64_t n, int64_t* idx) {
    int64_t cnt = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (mask[i]) idx[cnt++] = i;
    }
    return cnt;
}

// Backproject selected pixels of a depth crop to camera-space points.
// depth: (h, w) float32 crop starting at (y0, x0) of the full image;
// choose: flat row-major indices into the crop; K = [fx, fy, cx, cy].
void backproject_choose(const float* depth, int64_t h, int64_t w, int64_t y0, int64_t x0,
                        const int64_t* choose, int64_t n, float fx, float fy, float cx, float cy,
                        float* out_xyz) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t idx = choose[i];
        int64_t r = idx / w, c = idx % w;
        float z = depth[idx];
        out_xyz[3 * i + 0] = ((float)(c + x0) - cx) * z / fx;
        out_xyz[3 * i + 1] = ((float)(r + y0) - cy) * z / fy;
        out_xyz[3 * i + 2] = z;
    }
}

// Tight bbox of a (h, w) uint8 mask: writes [rmin, rmax, cmin, cmax)
// (exclusive max). Returns 0 if the mask is empty, else 1.
int bbox_of_mask(const uint8_t* mask, int64_t h, int64_t w, int64_t* out) {
    int64_t rmin = h, rmax = -1, cmin = w, cmax = -1;
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t* row = mask + r * w;
        for (int64_t c = 0; c < w; ++c) {
            if (row[c]) {
                if (r < rmin) rmin = r;
                if (r > rmax) rmax = r;
                if (c < cmin) cmin = c;
                if (c > cmax) cmax = c;
            }
        }
    }
    if (rmax < 0) return 0;
    out[0] = rmin;
    out[1] = rmax + 1;
    out[2] = cmin;
    out[3] = cmax + 1;
    return 1;
}

// Exact triangle z-buffer rasterization of a camera-space mesh.
// verts: (n_verts, 3) float32 camera-space vertices; faces: (n_faces, 3)
// int32 indices; K = [fx, fy, cx, cy]; depth: (h, w) float32 output,
// 0 where nothing projects. Semantics match the numpy oracle
// eval/renderer.py:rasterize_exact: integer-coordinate pixel samples,
// inclusive barycentric inside test, perspective-correct 1/z interpolation,
// triangles touching the near plane (z <= 1e-6) skipped. The VSD error's
// depth renderer.
void rasterize_depth(const float* verts, int64_t n_verts, const int32_t* faces, int64_t n_faces,
                     float fx, float fy, float cx, float cy, int64_t h, int64_t w, float* depth) {
    const float INF = 1e30f;
    for (int64_t i = 0; i < h * w; ++i) depth[i] = INF;
    for (int64_t f = 0; f < n_faces; ++f) {
        const int64_t ia = (int64_t)faces[3 * f + 0];
        const int64_t ib = (int64_t)faces[3 * f + 1];
        const int64_t ic = (int64_t)faces[3 * f + 2];
        // a malformed/corrupt PLY may carry out-of-range indices; skip the
        // face instead of reading out of bounds
        if (ia < 0 || ib < 0 || ic < 0 || ia >= n_verts || ib >= n_verts || ic >= n_verts) continue;
        const float* a = verts + 3 * ia;
        const float* b = verts + 3 * ib;
        const float* c = verts + 3 * ic;
        double z1 = a[2], z2 = b[2], z3 = c[2];
        if (z1 <= 1e-6 || z2 <= 1e-6 || z3 <= 1e-6) continue;
        double x1 = (fx * a[0] + cx * a[2]) / z1, y1 = (fy * a[1] + cy * a[2]) / z1;
        double x2 = (fx * b[0] + cx * b[2]) / z2, y2 = (fy * b[1] + cy * b[2]) / z2;
        double x3 = (fx * c[0] + cx * c[2]) / z3, y3 = (fy * c[1] + cy * c[2]) / z3;
        double umin = x1 < x2 ? (x1 < x3 ? x1 : x3) : (x2 < x3 ? x2 : x3);
        double umax = x1 > x2 ? (x1 > x3 ? x1 : x3) : (x2 > x3 ? x2 : x3);
        double vmin = y1 < y2 ? (y1 < y3 ? y1 : y3) : (y2 < y3 ? y2 : y3);
        double vmax = y1 > y2 ? (y1 > y3 ? y1 : y3) : (y2 > y3 ? y2 : y3);
        int64_t u0 = (int64_t)umin;
        if ((double)u0 > umin) --u0;  // floor
        int64_t v0 = (int64_t)vmin;
        if ((double)v0 > vmin) --v0;
        int64_t u1 = (int64_t)umax + 1;
        int64_t v1 = (int64_t)vmax + 1;
        if (u0 < 0) u0 = 0;
        if (v0 < 0) v0 = 0;
        if (u1 > w) u1 = w;
        if (v1 > h) v1 = h;
        if (u0 >= u1 || v0 >= v1) continue;
        double det = (y2 - y3) * (x1 - x3) + (x3 - x2) * (y1 - y3);
        if (det > -1e-12 && det < 1e-12) continue;
        double inv_det = 1.0 / det;
        double zi1 = 1.0 / z1, zi2 = 1.0 / z2, zi3 = 1.0 / z3;
        for (int64_t v = v0; v < v1; ++v) {
            double gv = (double)v;
            float* row = depth + v * w;
            for (int64_t u = u0; u < u1; ++u) {
                double gu = (double)u;
                double l1 = ((y2 - y3) * (gu - x3) + (x3 - x2) * (gv - y3)) * inv_det;
                double l2 = ((y3 - y1) * (gu - x3) + (x1 - x3) * (gv - y3)) * inv_det;
                double l3 = 1.0 - l1 - l2;
                if (l1 < 0.0 || l2 < 0.0 || l3 < 0.0) continue;
                double zinv = l1 * zi1 + l2 * zi2 + l3 * zi3;
                if (zinv <= 0.0) continue;
                float z = (float)(1.0 / zinv);
                if (z < row[u]) row[u] = z;
            }
        }
    }
    for (int64_t i = 0; i < h * w; ++i) {
        if (depth[i] >= INF) depth[i] = 0.0f;
    }
}

}  // extern "C"
