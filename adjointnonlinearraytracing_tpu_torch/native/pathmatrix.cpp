// Native path-matrix accumulation for the classical tomography baseline.
//
// C++ twin of the inner marching loop of pathmatrix/path_matrix.py
// (construct_voxel_matrix): for each ray, march the linear path between its
// cube entry and exit points in int_res substeps, accumulate arc length per
// visited voxel, and emit COO triplets whenever the voxel id changes (and at
// the last substep).  The Python/numpy version allocates O(int_res) temporary
// arrays and concatenates chunk lists; this version is a single cache-friendly
// pass per ray emitting directly into caller-provided buffers.
//
// The reference implements this layer natively too (its enoki/CUDA core);
// here the GPU owns the tracing and this host-side operator assembly is the
// natural native component.
//
// Build: g++ -O3 -shared -fPIC pathmatrix.cpp -o libpathmatrix.so (loader.py
// does this at first use, into kernels/_build/).  ABI (ctypes): see loader.py.

#include <cmath>
#include <cstdint>

namespace {

// Point on the chosen path parameterization at parameter t in [0, 1].
// Mirrors pathmatrix/path_matrix.py get_linear_path / get_hermite_path /
// get_true_path (reference path_matrix/path_matrix.py:230-255).
inline void eval_path(int32_t mode, int64_t r, double t,
                      const double* p0, const double* d0,
                      const double* p1, const double* d1,
                      int32_t dim, int64_t num_rays,
                      const double* path, const double* path_start,
                      const double* path_end, double* out) {
    if (mode == 0) {  // linear
        for (int32_t d = 0; d < dim; ++d)
            out[d] = (1.0 - t) * p0[d] + t * p1[d];
    } else if (mode == 1) {  // cubic hermite with endpoint tangents
        const double t2 = t * t, t3 = t2 * t;
        const double h00 = 2 * t3 - 3 * t2 + 1;
        const double h10 = t3 - 2 * t2 + t;
        const double h01 = -2 * t3 + 3 * t2;
        const double h11 = t3 - t2;
        for (int32_t d = 0; d < dim; ++d)
            out[d] = h00 * p0[d] + h10 * d0[d] + h01 * p1[d] + h11 * d1[d];
    } else {  // recorded trajectory: path is (steps*num_rays, dim) flattened,
              // ray r's step s lives at row s*num_rays + r
        const double idx = t * (path_end[r] - path_start[r]) + path_start[r];
        const int64_t il = (int64_t)std::floor(idx);
        const int64_t ih = (int64_t)std::ceil(idx);
        const double a = (double)ih - idx;
        const double* pl = path + (il * num_rays + r) * dim;
        const double* ph = path + (ih * num_rays + r) * dim;
        for (int32_t d = 0; d < dim; ++d)
            out[d] = a * pl[d] + (1.0 - a) * ph[d];
    }
}

}  // namespace

extern "C" {

// Generic single-pass marcher over linear / hermite / recorded paths.
// For each ray, march the path in int_res substeps accumulating arc length
// (the norm of each substep's displacement) per visited voxel; emit a COO
// triplet whenever the voxel id changes and at the last substep.  Returns
// the number of emitted triplets.  Caller sizes out_* to
// num_rays * (int_res + 1) (at most one emit per substep plus final flush).
//
// mode: 0 = linear (sdir/edir/path* unused), 1 = hermite, 2 = recorded
// path ("true"; path/path_start/path_end as in get_true_path).
int64_t accumulate_paths(
    const double* spos,       // (num_rays, dim) entry points
    const double* sdir,       // (num_rays, dim) entry tangents (hermite)
    const double* epos,       // (num_rays, dim) exit points
    const double* edir,       // (num_rays, dim) exit tangents (hermite)
    int64_t num_rays,
    int32_t dim_count,        // 2 or 3
    double box_dim,           // voxel edge length
    int32_t res,              // voxels per axis
    int32_t int_res,          // substeps per ray
    int32_t mode,
    const double* path,       // (steps*num_rays, dim) or null
    const double* path_start, // (num_rays,) fractional start step, or null
    const double* path_end,   // (num_rays,) fractional end step, or null
    double* out_data,         // path lengths
    int64_t* out_row,         // ray index
    int64_t* out_col)         // flat voxel index
{
    const double inv_box = 1.0 / box_dim;
    int64_t count = 0;
    double p_pre[3], p_cur[3];

    for (int64_t r = 0; r < num_rays; ++r) {
        const double* p0 = spos + r * dim_count;
        const double* d0 = sdir ? sdir + r * dim_count : nullptr;
        const double* p1 = epos + r * dim_count;
        const double* d1 = edir ? edir + r * dim_count : nullptr;

        auto voxel_of = [&](const double* p) -> int64_t {
            int64_t ind = 0;
            int64_t stride = 1;
            for (int32_t d = 0; d < dim_count; ++d) {
                int64_t i = (int64_t)std::floor(p[d] * inv_box);
                if (i < 0) i = 0;
                if (i > res - 1) i = res - 1;
                ind += i * stride;
                stride *= res;
            }
            return ind;
        };

        eval_path(mode, r, 0.0, p0, d0, p1, d1, dim_count, num_rays,
                  path, path_start, path_end, p_pre);
        int64_t ind_pre = voxel_of(p_pre);
        double dist = 0.0;
        for (int32_t j = 0; j < int_res; ++j) {
            const double t = (double)(j + 1) / int_res;
            eval_path(mode, r, t, p0, d0, p1, d1, dim_count, num_rays,
                      path, path_start, path_end, p_cur);
            const int64_t ind_cur = voxel_of(p_cur);
            double seg2 = 0.0;
            for (int32_t d = 0; d < dim_count; ++d) {
                const double dd = p_cur[d] - p_pre[d];
                seg2 += dd * dd;
                p_pre[d] = p_cur[d];
            }
            dist += std::sqrt(seg2);
            if (ind_cur != ind_pre || j == int_res - 1) {
                out_data[count] = dist;
                out_row[count] = r;
                out_col[count] = ind_pre;
                ++count;
                dist = 0.0;
                ind_pre = ind_cur;
            }
        }
    }
    return count;
}

// Back-compat entry point: linear paths only.
int64_t accumulate_linear_paths(
    const double* spos, const double* epos,
    int64_t num_rays, int32_t dim_count,
    double box_dim, int32_t res, int32_t int_res,
    double* out_data, int64_t* out_row, int64_t* out_col)
{
    return accumulate_paths(spos, nullptr, epos, nullptr, num_rays,
                            dim_count, box_dim, res, int_res, /*mode=*/0,
                            nullptr, nullptr, nullptr,
                            out_data, out_row, out_col);
}

}  // extern "C"
