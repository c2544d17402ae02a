// gcm_tpu native runtime components.
//
// The framework's C++ layer (SURVEY.md §2: the reference's
// CGAL point-location and VTK writer are native; so are ours):
//
//  - walk_locate: visibility-walk point location on a simplex mesh with
//    barycentric output — the CGAL "walk from the node's cell" equivalent,
//    used to build the per-(axis, wave, direction) characteristic foot
//    tables. O(1) per query on near-lattice meshes vs the global search.
//
//  - transpose_f_order: C-order -> Fortran-order float32 transpose for the
//    VTK writers (VTK wants x-fastest); blocked for cache friendliness.
//
// Built on demand by gcm_tpu/native/__init__.py:  g++ -O3 -shared -fPIC.
// Plain C ABI, driven via ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cmath>

extern "C" {

// Visibility walk on a Delaunay triangulation.
//   points    [npts, dim]        vertex coordinates
//   cells     [ncells, dim+1]    vertex ids per simplex
//   neighbors [ncells, dim+1]    neighbor cell opposite each vertex (-1 = hull)
//   transform [ncells, dim+1, dim] scipy Delaunay transform: rows 0..dim-1 =
//             T^-1, row dim = r (barycentric b = T^-1 (x - r))
//   queries   [nq, dim]          points to locate
//   starts    [nq]               starting cell per query (e.g. a cell
//                                incident to the node the foot belongs to)
// Outputs:
//   out_cell  [nq]               containing cell id, or -1 if outside hull
//   out_bary  [nq, dim+1]        barycentric coords in out_cell (junk if -1)
void walk_locate(
    const double* points, int64_t npts,
    const int32_t* cells, const int32_t* neighbors, int64_t ncells,
    const double* transform,
    const double* queries, int64_t nq,
    const int32_t* starts,
    int dim,
    int32_t* out_cell, double* out_bary)
{
    (void)points; (void)npts; (void)cells;
    const int nv = dim + 1;
    const int64_t tstride = (int64_t)nv * dim;   // doubles per cell transform
    const double eps = 1e-12;
    const int64_t max_steps = ncells + 16;

    for (int64_t q = 0; q < nq; ++q) {
        const double* x = queries + (int64_t)q * dim;
        int32_t c = starts[q];
        if (c < 0 || c >= ncells) c = 0;
        int32_t found = -1;
        double bary[8];  // dim+1 <= 4 supported; headroom

        for (int64_t step = 0; step < max_steps; ++step) {
            const double* T = transform + (int64_t)c * tstride;
            const double* r = T + (int64_t)dim * dim;   // row `dim`
            // b_i = sum_j T[i][j] * (x[j] - r[j]),  b_last = 1 - sum
            double bsum = 0.0;
            bool degenerate = false;
            for (int i = 0; i < dim; ++i) {
                double bi = 0.0;
                for (int j = 0; j < dim; ++j)
                    bi += T[(int64_t)i * dim + j] * (x[j] - r[j]);
                if (!std::isfinite(bi)) { degenerate = true; break; }
                bary[i] = bi;
                bsum += bi;
            }
            if (degenerate) {
                // sliver with singular transform: step to any neighbor
                const int32_t* nb = neighbors + (int64_t)c * nv;
                int32_t nxt = -1;
                for (int i = 0; i < nv; ++i)
                    if (nb[i] >= 0) { nxt = nb[i]; break; }
                if (nxt < 0) break;
                c = nxt;
                continue;
            }
            bary[dim] = 1.0 - bsum;

            // most negative coordinate decides the walk direction
            int worst = -1;
            double worst_v = -eps;
            for (int i = 0; i < nv; ++i)
                if (bary[i] < worst_v) { worst_v = bary[i]; worst = i; }

            if (worst < 0) { found = c; break; }       // inside (within eps)
            int32_t nxt = neighbors[(int64_t)c * nv + worst];
            if (nxt < 0) { found = -1; break; }        // walked off the hull
            c = nxt;
        }

        out_cell[q] = found;
        double* ob = out_bary + (int64_t)q * nv;
        if (found >= 0) {
            for (int i = 0; i < nv; ++i) ob[i] = bary[i];
        } else {
            for (int i = 0; i < nv; ++i) ob[i] = 0.0;
        }
    }
}

// Blocked C-order [n0, n1, n2] float32 -> Fortran-order flat output.
void transpose_f_order(const float* src, int64_t n0, int64_t n1, int64_t n2,
                       float* dst)
{
    const int64_t B = 32;
    for (int64_t k0 = 0; k0 < n2; k0 += B)
        for (int64_t i0 = 0; i0 < n0; i0 += B) {
            int64_t kmax = k0 + B < n2 ? k0 + B : n2;
            int64_t imax = i0 + B < n0 ? i0 + B : n0;
            for (int64_t j = 0; j < n1; ++j)
                for (int64_t k = k0; k < kmax; ++k)
                    for (int64_t i = i0; i < imax; ++i)
                        dst[i + n0 * (j + n1 * k)] =
                            src[k + n2 * (j + n1 * i)];
        }
}

}  // extern "C"
