// Native topology kernels: mesh edge construction and CG DOF numbering.
//
// The reference implements its graph building in host C++ (Mesh2D.cpp
// from_vertices edge dedup/orientation, H1Space.cpp DOF dedup).  This module
// provides the same builds as flat-array C functions callable via ctypes,
// replacing the Python/NumPy loops for large meshes.  Semantics are
// bit-identical to the NumPy implementations in mesh/mesh2d.py and
// spaces/h1.py (edge ids in first-occurrence order, DOF ids in flat
// first-occurrence order), so either path can be used interchangeably.
//
// Built on first use by cuddhelmholtz_tpu_torch/native/__init__.py into
// cuddhelmholtz_tpu_torch/_build/ with the host C++ compiler ($CXX, else g++).

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace {

// side s of a quad runs from local vertex EDGE_V0[s] to EDGE_V1[s]
constexpr int EDGE_V0[4] = {0, 1, 3, 0};
constexpr int EDGE_V1[4] = {1, 2, 2, 3};

inline void side_to_volume(int i, int side, int nb, int& ix, int& iy) {
    ix = (side == 0 || side == 2) ? i : (side == 1 ? nb - 1 : 0);
    iy = (side == 1 || side == 3) ? i : (side == 2 ? nb - 1 : 0);
}

}  // namespace

extern "C" {

// Build the edge tables of a quad mesh.
//   ev: (nel, 4) element->vertex ids (CCW)
// Outputs (caller allocates for the worst case 4*nel edges):
//   edge_vertices (ne, 2), edge_elements (ne, 2; -1 if boundary),
//   edge_sides (ne, 2; -1), edge_delta (ne)
// Returns ne.
int64_t cuddh_build_edges(int64_t nel, const int32_t* ev, int64_t nv,
                          int32_t* edge_vertices, int32_t* edge_elements,
                          int32_t* edge_sides, int32_t* edge_delta) {
    std::unordered_map<int64_t, int64_t> edge_map;
    edge_map.reserve(static_cast<size_t>(4 * nel));
    int64_t ne = 0;
    for (int64_t el = 0; el < nel; ++el) {
        for (int s = 0; s < 4; ++s) {
            const int32_t c0 = ev[4 * el + EDGE_V0[s]];
            const int32_t c1 = ev[4 * el + EDGE_V1[s]];
            const int64_t lo = c0 < c1 ? c0 : c1;
            const int64_t hi = c0 < c1 ? c1 : c0;
            const int64_t key = lo + nv * hi;
            auto it = edge_map.find(key);
            if (it == edge_map.end()) {
                edge_map.emplace(key, ne);
                edge_vertices[2 * ne + 0] = c0;
                edge_vertices[2 * ne + 1] = c1;
                edge_elements[2 * ne + 0] = static_cast<int32_t>(el);
                edge_elements[2 * ne + 1] = -1;
                edge_sides[2 * ne + 0] = s;
                edge_sides[2 * ne + 1] = -1;
                edge_delta[ne] = 1;
                ++ne;
            } else {
                const int64_t e = it->second;
                edge_elements[2 * e + 1] = static_cast<int32_t>(el);
                edge_sides[2 * e + 1] = s;
                edge_delta[e] = (c0 == edge_vertices[2 * e + 0]) ? 1 : -1;
            }
        }
    }
    return ne;
}

// Continuous-Galerkin DOF numbering on tensor-product nodes (H1Space).
//   ev: (nel, 4); edge tables from cuddh_build_edges; nb: basis size
// Output: dofs (nel, nb, nb) with [el, iy, ix] -> global id.  Returns ndof.
int64_t cuddh_h1_numbering(int64_t nel, int nb, const int32_t* ev, int64_t nv,
                           int64_t ne, const int32_t* edge_vertices,
                           const int32_t* edge_elements, const int32_t* edge_sides,
                           const int32_t* edge_delta, int32_t* dofs) {
    const int64_t N = nel * nb * nb;
    std::vector<int64_t> primary(N);
    for (int64_t i = 0; i < N; ++i) primary[i] = i;

    auto vol = [nb](int64_t el, int ix, int iy) -> int64_t {
        return (el * nb + iy) * nb + ix;
    };

    // shared edge-interior DOFs: alias second element's nodes to the first's
    if (nb > 2) {
        for (int64_t e = 0; e < ne; ++e) {
            const int32_t el1 = edge_elements[2 * e + 1];
            if (el1 < 0) continue;  // boundary edge
            const int32_t el0 = edge_elements[2 * e + 0];
            const int s0 = edge_sides[2 * e + 0];
            const int s1 = edge_sides[2 * e + 1];
            const bool rev = edge_delta[e] < 0;
            for (int i = 1; i < nb - 1; ++i) {
                const int j = rev ? (nb - 1 - i) : i;
                int ix0, iy0, ix1, iy1;
                side_to_volume(i, s0, nb, ix0, iy0);
                side_to_volume(j, s1, nb, ix1, iy1);
                primary[vol(el1, ix1, iy1)] = vol(el0, ix0, iy0);
            }
        }
    }

    // shared corner DOFs: first (element, corner) incidence per mesh vertex
    // in element-major order is primary
    constexpr int CIX[4] = {0, 1, 1, 0};
    constexpr int CIY[4] = {0, 0, 1, 1};
    std::vector<int64_t> first_vol(static_cast<size_t>(nv), -1);
    for (int64_t el = 0; el < nel; ++el) {
        for (int c = 0; c < 4; ++c) {
            const int32_t v = ev[4 * el + c];
            const int64_t vl = vol(el, CIX[c] * (nb - 1), CIY[c] * (nb - 1));
            if (first_vol[v] < 0)
                first_vol[v] = vl;
            else
                primary[vl] = first_vol[v];
        }
    }

    // numbering in flat first-occurrence order
    int64_t next = 0;
    for (int64_t i = 0; i < N; ++i) {
        if (primary[i] == i) {
            dofs[i] = static_cast<int32_t>(next++);
        }
    }
    for (int64_t i = 0; i < N; ++i) {
        if (primary[i] != i) dofs[i] = dofs[primary[i]];
    }
    return next;
}

}  // extern "C"
