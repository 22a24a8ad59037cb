// Fixed-radius neighbor search via spatial grid hashing, on the host.
//
// The search behind `layers/neighbor_search.py::native_neighbor_search`
// (the reference's open3d `FixedRadiusSearch`): given a point cloud
// `data` and query points `queries`, return for every query the indices of
// all data points within `radius`, in CSR layout (`neighbors_index`,
// `neighbors_row_splits`).
//
// Algorithm: bucket data points into a uniform grid with cell edge =
// radius (counting sort, O(n)); each query scans its 3^dim adjacent
// cells. Indices within a neighborhood are emitted in ascending order, as
// the numpy search (the plain version) emits them. Distances are summed in
// double and compared with the float radius squared.
//
// Build (`_native.build_host_library`, at first use):
//   g++ -O3 -std=c++17 -shared -fPIC -fopenmp neighbor_search.cpp
// API: two-pass -- call with mode=0 to fill row_splits (prefix counts),
// then mode=1 with an allocated index buffer.

#include <cmath>
#include <cstdint>
#include <vector>
#include <algorithm>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Grid {
    int dim;
    double inv_cell;
    double mins[3];
    int64_t ncells[3];
    // counting-sort layout: point ids grouped by cell
    std::vector<int64_t> cell_starts;  // ncell_total + 1
    std::vector<int64_t> point_ids;    // n_data
};

inline int64_t cell_index(const Grid& g, const int64_t* c) {
    int64_t idx = 0;
    for (int d = 0; d < g.dim; ++d) idx = idx * g.ncells[d] + c[d];
    return idx;
}

void build_grid(Grid& g, const float* data, int64_t n, int dim, float radius) {
    g.dim = dim;
    g.inv_cell = 1.0 / (double)radius;
    double maxs[3];
    for (int d = 0; d < dim; ++d) {
        g.mins[d] = 1e300;
        maxs[d] = -1e300;
    }
    for (int64_t i = 0; i < n; ++i) {
        for (int d = 0; d < dim; ++d) {
            double v = data[i * dim + d];
            if (v < g.mins[d]) g.mins[d] = v;
            if (v > maxs[d]) maxs[d] = v;
        }
    }
    int64_t total = 1;
    for (int d = 0; d < dim; ++d) {
        int64_t nc =
            (int64_t)std::floor((maxs[d] - g.mins[d]) * g.inv_cell) + 1;
        if (nc < 1) nc = 1;
        g.ncells[d] = nc;
        total *= nc;
    }
    g.cell_starts.assign((size_t)total + 1, 0);
    g.point_ids.resize((size_t)n);
    std::vector<int64_t> cell_of((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        int64_t c[3];
        for (int d = 0; d < dim; ++d) {
            c[d] = (int64_t)std::floor(
                (data[i * dim + d] - g.mins[d]) * g.inv_cell);
            if (c[d] < 0) c[d] = 0;
            if (c[d] >= g.ncells[d]) c[d] = g.ncells[d] - 1;
        }
        cell_of[(size_t)i] = cell_index(g, c);
        g.cell_starts[(size_t)cell_of[(size_t)i] + 1]++;
    }
    for (size_t i = 1; i < g.cell_starts.size(); ++i)
        g.cell_starts[i] += g.cell_starts[i - 1];
    std::vector<int64_t> cursor(g.cell_starts.begin(), g.cell_starts.end() - 1);
    for (int64_t i = 0; i < n; ++i)
        g.point_ids[(size_t)cursor[(size_t)cell_of[(size_t)i]]++] = i;
}

// Collect neighbors of one query into `out` (ascending ids).
template <typename F>
void scan_query(const Grid& g, const float* data, const float* q,
                float r2, F&& emit) {
    int64_t lo[3], hi[3];
    for (int d = 0; d < g.dim; ++d) {
        int64_t c = (int64_t)std::floor((q[d] - g.mins[d]) * g.inv_cell);
        lo[d] = std::max<int64_t>(0, c - 1);
        hi[d] = std::min<int64_t>(g.ncells[d] - 1, c + 1);
        if (c < 0) { lo[d] = 0; hi[d] = std::min<int64_t>(g.ncells[d] - 1, 0); }
        if (c >= g.ncells[d]) {
            hi[d] = g.ncells[d] - 1;
            lo[d] = std::max<int64_t>(0, g.ncells[d] - 2);
        }
    }
    int dim = g.dim;
    int64_t c[3] = {0, 0, 0};
    // iterate the up-to-3^dim cell block
    for (c[0] = lo[0]; c[0] <= hi[0]; ++c[0]) {
        for (c[1] = (dim > 1 ? lo[1] : 0); c[1] <= (dim > 1 ? hi[1] : 0);
             ++c[1]) {
            for (c[2] = (dim > 2 ? lo[2] : 0);
                 c[2] <= (dim > 2 ? hi[2] : 0); ++c[2]) {
                int64_t ci = cell_index(g, c);
                int64_t s = g.cell_starts[(size_t)ci];
                int64_t e = g.cell_starts[(size_t)ci + 1];
                for (int64_t k = s; k < e; ++k) {
                    int64_t pid = g.point_ids[(size_t)k];
                    double d2 = 0.0;
                    for (int d = 0; d < dim; ++d) {
                        double diff =
                            (double)data[pid * dim + d] - (double)q[d];
                        d2 += diff * diff;
                    }
                    if (d2 <= (double)r2) emit(pid);
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// mode 0: fill row_splits (length n_queries+1) with CSR prefix counts;
//         out_indices may be null. Returns total neighbor count.
// mode 1: row_splits must already hold the prefix counts; fills
//         out_indices (ascending per query). Returns total.
int64_t fixed_radius_search(const float* data, int64_t n_data,
                            const float* queries, int64_t n_queries,
                            int32_t dim, float radius, int32_t mode,
                            int64_t* row_splits, int64_t* out_indices) {
    if (dim < 1 || dim > 3 || n_data < 0 || n_queries < 0) return -1;
    if (n_data == 0) {
        for (int64_t i = 0; i <= n_queries; ++i) row_splits[i] = 0;
        return 0;
    }
    Grid g;
    build_grid(g, data, n_data, dim, radius);
    float r2 = radius * radius;

    if (mode == 0) {
        row_splits[0] = 0;
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
        for (int64_t i = 0; i < n_queries; ++i) {
            int64_t count = 0;
            scan_query(g, data, queries + i * dim, r2,
                       [&](int64_t) { ++count; });
            row_splits[i + 1] = count;
        }
        for (int64_t i = 0; i < n_queries; ++i)
            row_splits[i + 1] += row_splits[i];
        return row_splits[n_queries];
    }

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n_queries; ++i) {
        int64_t* dst = out_indices + row_splits[i];
        int64_t count = 0;
        scan_query(g, data, queries + i * dim, r2,
                   [&](int64_t pid) { dst[count++] = pid; });
        std::sort(dst, dst + count);
    }
    return row_splits[n_queries];
}

}  // extern "C"
