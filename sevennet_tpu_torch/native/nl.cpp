// Host-side cell-list neighbor list (C++), the native counterpart of the
// reference's matscipy/ASE neighbor build (sevenn/train/dataload.py:32-88)
// and LAMMPS' C++ neighbor machinery in the deployed pair styles.
//
// Full directed list without self edges, matscipy 'ijDS' semantics: for an
// edge (dst=i, src=j, shift=S), D = pos[j] + S @ cell - pos[i].
//
// General (possibly triclinic) cells; per-axis PBC flags; non-periodic
// axes are binned over the bounding box. Two-phase API so the Python side
// can size its buffers: count() then fill().
//
// The port's copy of sevennet_tpu/native/nl.cpp. Compiled by g++ at first
// use into build/native at the root of the checkout and bound with ctypes
// (sevennet_tpu_torch/native/__init__.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Ctx {
    int64_t n;
    double cell[9];     // rows = lattice vectors
    double inv[3][3];   // inverse of cell (frac = pos @ inv)
    int pbc[3];
    double cutoff;
    std::vector<double> frac;   // wrapped fractional coords (n,3)
    std::vector<double> wrap;   // integer wraps applied (n,3)
    std::vector<double> posw;   // wrapped cartesian (n,3)
    int nb[3];                  // bins per axis
    double lo[3], span[3];      // fractional bounding box (non-pbc axes)
    std::vector<int64_t> bin_start;  // prefix offsets per bin
    std::vector<int64_t> order;      // atom ids sorted by bin
};

bool invert3(const double m[9], double out[3][3]) {
    double a = m[0], b = m[1], c = m[2];
    double d = m[3], e = m[4], f = m[5];
    double g = m[6], h = m[7], i = m[8];
    double det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g);
    if (std::fabs(det) < 1e-14) return false;
    double id = 1.0 / det;
    out[0][0] = (e * i - f * h) * id;
    out[0][1] = (c * h - b * i) * id;
    out[0][2] = (b * f - c * e) * id;
    out[1][0] = (f * g - d * i) * id;
    out[1][1] = (a * i - c * g) * id;
    out[1][2] = (c * d - a * f) * id;
    out[2][0] = (d * h - e * g) * id;
    out[2][1] = (b * g - a * h) * id;
    out[2][2] = (a * e - b * d) * id;
    return true;
}

inline int64_t bin_of(const Ctx& ctx, const double* f) {
    int ix[3];
    for (int a = 0; a < 3; ++a) {
        double t = (f[a] - ctx.lo[a]) / ctx.span[a];  // in [0,1)
        int v = (int)(t * ctx.nb[a]);
        if (v < 0) v = 0;
        if (v >= ctx.nb[a]) v = ctx.nb[a] - 1;
        ix[a] = v;
    }
    return ((int64_t)ix[0] * ctx.nb[1] + ix[1]) * ctx.nb[2] + ix[2];
}

// enumerate neighbors of atom i; cb(i, j, S0,S1,S2) for every edge i<-j
template <class CB>
void for_neighbors(const Ctx& ctx, int64_t i, CB&& cb) {
    const double* fi = &ctx.frac[3 * i];
    const double cut2 = ctx.cutoff * ctx.cutoff;
    int ix[3];
    for (int a = 0; a < 3; ++a) {
        double t = (fi[a] - ctx.lo[a]) / ctx.span[a];
        int v = (int)(t * ctx.nb[a]);
        if (v < 0) v = 0;
        if (v >= ctx.nb[a]) v = ctx.nb[a] - 1;
        ix[a] = v;
    }
    for (int dx = -1; dx <= 1; ++dx)
        for (int dy = -1; dy <= 1; ++dy)
            for (int dz = -1; dz <= 1; ++dz) {
                int cx = ix[0] + dx, cy = ix[1] + dy, cz = ix[2] + dz;
                int sx = 0, sy = 0, sz = 0;
                if (ctx.pbc[0]) {
                    if (cx < 0) { cx += ctx.nb[0]; sx = -1; }
                    else if (cx >= ctx.nb[0]) { cx -= ctx.nb[0]; sx = 1; }
                } else if (cx < 0 || cx >= ctx.nb[0]) continue;
                if (ctx.pbc[1]) {
                    if (cy < 0) { cy += ctx.nb[1]; sy = -1; }
                    else if (cy >= ctx.nb[1]) { cy -= ctx.nb[1]; sy = 1; }
                } else if (cy < 0 || cy >= ctx.nb[1]) continue;
                if (ctx.pbc[2]) {
                    if (cz < 0) { cz += ctx.nb[2]; sz = -1; }
                    else if (cz >= ctx.nb[2]) { cz -= ctx.nb[2]; sz = 1; }
                } else if (cz < 0 || cz >= ctx.nb[2]) continue;
                // neighbor bin center offset in fractional space: the
                // SOURCE image sits at frac[j] + (-sx,-sy,-sz)?? No:
                // crossing the hi face (cx >= nb) means the neighbor cell
                // is the wrapped bin whose atoms must be shifted by +1
                // lattice vector to sit next to atom i.
                int64_t b = ((int64_t)cx * ctx.nb[1] + cy) * ctx.nb[2] + cz;
                int64_t s = ctx.bin_start[b], e = ctx.bin_start[b + 1];
                for (int64_t t = s; t < e; ++t) {
                    int64_t j = ctx.order[t];
                    double df[3] = {
                        ctx.frac[3 * j + 0] + sx - fi[0],
                        ctx.frac[3 * j + 1] + sy - fi[1],
                        ctx.frac[3 * j + 2] + sz - fi[2],
                    };
                    double dxc = df[0] * ctx.cell[0] + df[1] * ctx.cell[3] + df[2] * ctx.cell[6];
                    double dyc = df[0] * ctx.cell[1] + df[1] * ctx.cell[4] + df[2] * ctx.cell[7];
                    double dzc = df[0] * ctx.cell[2] + df[1] * ctx.cell[5] + df[2] * ctx.cell[8];
                    double r2 = dxc * dxc + dyc * dyc + dzc * dzc;
                    if (r2 >= cut2) continue;
                    if (j == i && sx == 0 && sy == 0 && sz == 0) continue;
                    cb(j, sx, sy, sz);
                }
            }
}

Ctx* g_ctx = nullptr;

}  // namespace

extern "C" {

// Prepare bins; returns total edge count, or -1 on error (e.g. a
// periodic axis with height < cutoff needing >1 image, which this
// single-image stencil cannot cover).
int64_t nl_count(const double* pos, int64_t n, const double* cell,
                 const int* pbc, double cutoff) {
    delete g_ctx;
    g_ctx = new Ctx();
    Ctx& ctx = *g_ctx;
    ctx.n = n;
    std::memcpy(ctx.cell, cell, 9 * sizeof(double));
    ctx.pbc[0] = pbc[0]; ctx.pbc[1] = pbc[1]; ctx.pbc[2] = pbc[2];
    ctx.cutoff = cutoff;
    if (!invert3(ctx.cell, ctx.inv)) return -1;

    ctx.frac.resize(3 * n);
    ctx.wrap.resize(3 * n);
    for (int64_t i = 0; i < n; ++i) {
        const double* p = pos + 3 * i;
        for (int a = 0; a < 3; ++a) {
            double f = p[0] * ctx.inv[0][a] + p[1] * ctx.inv[1][a] +
                       p[2] * ctx.inv[2][a];
            double w = ctx.pbc[a] ? std::floor(f) : 0.0;
            ctx.frac[3 * i + a] = f - w;
            ctx.wrap[3 * i + a] = w;
        }
    }

    // per-axis heights (distance between opposite cell faces)
    for (int a = 0; a < 3; ++a) {
        double len = std::sqrt(ctx.inv[0][a] * ctx.inv[0][a] +
                               ctx.inv[1][a] * ctx.inv[1][a] +
                               ctx.inv[2][a] * ctx.inv[2][a]);
        double height = 1.0 / len;
        if (ctx.pbc[a]) {
            ctx.lo[a] = 0.0;
            ctx.span[a] = 1.0;
            ctx.nb[a] = (int)std::floor(height / cutoff);
            if (ctx.nb[a] < 1) return -1;  // needs >1 periodic image
            if (ctx.nb[a] > 512) ctx.nb[a] = 512;
        } else {
            double mn = 1e300, mx = -1e300;
            for (int64_t i = 0; i < n; ++i) {
                double f = ctx.frac[3 * i + a];
                if (f < mn) mn = f;
                if (f > mx) mx = f;
            }
            double spanf = (mx - mn);
            double pad = 1e-9 + spanf * 1e-12;
            ctx.lo[a] = mn - pad;
            ctx.span[a] = spanf + 2 * pad;
            if (ctx.span[a] <= 0) ctx.span[a] = 1e-9;
            int nbins = (int)std::floor(ctx.span[a] * height / cutoff);
            ctx.nb[a] = nbins < 1 ? 1 : (nbins > 512 ? 512 : nbins);
        }
    }

    int64_t nbins = (int64_t)ctx.nb[0] * ctx.nb[1] * ctx.nb[2];
    std::vector<int64_t> counts(nbins + 1, 0);
    std::vector<int64_t> bin_id(n);
    for (int64_t i = 0; i < n; ++i) {
        bin_id[i] = bin_of(ctx, &ctx.frac[3 * i]);
        counts[bin_id[i] + 1]++;
    }
    for (int64_t b = 0; b < nbins; ++b) counts[b + 1] += counts[b];
    ctx.bin_start = counts;
    ctx.order.resize(n);
    std::vector<int64_t> cursor(ctx.bin_start.begin(), ctx.bin_start.end() - 1);
    for (int64_t i = 0; i < n; ++i) ctx.order[cursor[bin_id[i]]++] = i;

    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i)
        for_neighbors(ctx, i, [&](int64_t, int, int, int) { ++total; });
    return total;
}

// Fill dst/src/shift arrays (caller sized them from nl_count). Shifts are
// corrected back to the original (unwrapped) positions:
// D = pos[j] + (S - wrap_j + wrap_i) @ cell - pos[i].
void nl_fill(int64_t* dst, int64_t* src, double* shift) {
    Ctx& ctx = *g_ctx;
    int64_t e = 0;
    for (int64_t i = 0; i < ctx.n; ++i) {
        for_neighbors(ctx, i, [&](int64_t j, int sx, int sy, int sz) {
            dst[e] = i;
            src[e] = j;
            shift[3 * e + 0] = sx - ctx.wrap[3 * j + 0] + ctx.wrap[3 * i + 0];
            shift[3 * e + 1] = sy - ctx.wrap[3 * j + 1] + ctx.wrap[3 * i + 1];
            shift[3 * e + 2] = sz - ctx.wrap[3 * j + 2] + ctx.wrap[3 * i + 2];
            ++e;
        });
    }
}

void nl_free() {
    delete g_ctx;
    g_ctx = nullptr;
}

}  // extern "C"

namespace {
std::vector<int64_t>* g_dst = nullptr;
std::vector<int64_t>* g_src = nullptr;
std::vector<double>* g_shift = nullptr;
}

// Count + fill into library-owned buffers in one pass; returns the edge
// count (or -1: unsupported system). The buffers stay alive until the
// next nl_build/nl_release; the Python side (native/__init__.py) copies
// them out and then releases them.
extern "C" int64_t nl_build(const double* pos, int64_t n, const double* cell,
                            const int* pbc, double cutoff) {
    int64_t total = nl_count(pos, n, cell, pbc, cutoff);
    if (total < 0) return total;
    delete g_dst; delete g_src; delete g_shift;
    g_dst = new std::vector<int64_t>(total);
    g_src = new std::vector<int64_t>(total);
    g_shift = new std::vector<double>(3 * total);
    Ctx& ctx = *g_ctx;
    int64_t e = 0;
    auto& dst = *g_dst; auto& src = *g_src; auto& shift = *g_shift;
    for (int64_t i = 0; i < ctx.n; ++i) {
        for_neighbors(ctx, i, [&](int64_t j, int sx, int sy, int sz) {
            dst[e] = i;
            src[e] = j;
            shift[3 * e + 0] = sx - ctx.wrap[3 * j + 0] + ctx.wrap[3 * i + 0];
            shift[3 * e + 1] = sy - ctx.wrap[3 * j + 1] + ctx.wrap[3 * i + 1];
            shift[3 * e + 2] = sz - ctx.wrap[3 * j + 2] + ctx.wrap[3 * i + 2];
            ++e;
        });
    }
    nl_free();  // bins no longer needed; edge buffers stay
    return total;
}

extern "C" int64_t* nl_dst_ptr() { return g_dst->data(); }
extern "C" int64_t* nl_src_ptr() { return g_src->data(); }
extern "C" double* nl_shift_ptr() { return g_shift->data(); }

extern "C" void nl_release() {
    delete g_dst; delete g_src; delete g_shift;
    g_dst = nullptr; g_src = nullptr; g_shift = nullptr;
}
