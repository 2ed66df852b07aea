// Marching-tetrahedra iso-surface extraction on the host, for mesh export
// (a copy of tensorf_tpu/native/marching.cpp; eval/mesh.py builds it with
// g++ into the package's build directory at first use and loads it with
// ctypes).
//
// Each grid cell is split into 6 tetrahedra; iso-crossing edges are
// interpolated exactly.  Marching tetrahedra needs no 256-case tables and
// produces a watertight triangulation of the iso-surface.
//
// C ABI:
//   mt_count(grid, nx, ny, nz, level, &n_verts, &n_tris)  -> sizes
//   mt_extract(verts, tris)                               -> fill buffers
//
// Vertices are emitted in grid-index coordinates (i, j, k); the Python
// layer applies the bbox spacing and origin.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

// The 6-tetrahedra decomposition of a unit cube (corner indices 0..7 with
// corner c = (i + (c&1), j + ((c>>1)&1), k + ((c>>2)&1))).
static const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 3, 6}, {0, 3, 2, 6},
    {0, 2, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

inline uint64_t edge_key(uint64_t a, uint64_t b) {
  if (a > b) std::swap(a, b);
  return (a << 32) | b;
}

struct MeshAccumulator {
  std::vector<double> verts;   // xyz triplets
  std::vector<int64_t> tris;   // index triplets
  std::unordered_map<uint64_t, int64_t> edge_cache;

  int64_t vertex_on_edge(uint64_t ga, uint64_t gb, const V3& pa, const V3& pb,
                         double va, double vb, double level) {
    uint64_t key = edge_key(ga, gb);
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;
    double t = (level - va) / (vb - va);
    if (t < 0) t = 0;
    if (t > 1) t = 1;
    int64_t idx = (int64_t)(verts.size() / 3);
    verts.push_back(pa.x + t * (pb.x - pa.x));
    verts.push_back(pa.y + t * (pb.y - pa.y));
    verts.push_back(pa.z + t * (pb.z - pa.z));
    edge_cache.emplace(key, idx);
    return idx;
  }
};

void march(const float* grid, int64_t nx, int64_t ny, int64_t nz, double level,
           MeshAccumulator& mb) {
  auto gid = [&](int64_t i, int64_t j, int64_t k) -> uint64_t {
    return (uint64_t)((i * ny + j) * nz + k);
  };
  auto val = [&](uint64_t g) -> double { return (double)grid[g]; };

  for (int64_t i = 0; i + 1 < nx; ++i) {
    for (int64_t j = 0; j + 1 < ny; ++j) {
      for (int64_t k = 0; k + 1 < nz; ++k) {
        uint64_t corner_g[8];
        V3 corner_p[8];
        double corner_v[8];
        bool any_above = false, any_below = false;
        for (int c = 0; c < 8; ++c) {
          int64_t ci = i + (c & 1), cj = j + ((c >> 1) & 1),
                  ck = k + ((c >> 2) & 1);
          corner_g[c] = gid(ci, cj, ck);
          corner_p[c] = {(double)ci, (double)cj, (double)ck};
          corner_v[c] = val(corner_g[c]);
          if (corner_v[c] > level) any_above = true;
          else any_below = true;
        }
        if (!any_above || !any_below) continue;  // cell not crossed

        for (const auto& tet : TETS) {
          int inside[4];
          int n_in = 0;
          for (int t = 0; t < 4; ++t) {
            inside[t] = corner_v[tet[t]] > level;
            n_in += inside[t];
          }
          if (n_in == 0 || n_in == 4) continue;

          int in_idx[4], out_idx[4];
          int ni = 0, no = 0;
          for (int t = 0; t < 4; ++t) {
            if (inside[t]) in_idx[ni++] = tet[t];
            else out_idx[no++] = tet[t];
          }

          auto vert = [&](int a, int b) {
            return mb.vertex_on_edge(corner_g[a], corner_g[b], corner_p[a],
                                     corner_p[b], corner_v[a], corner_v[b],
                                     level);
          };

          if (n_in == 1) {  // single triangle
            int64_t v0 = vert(in_idx[0], out_idx[0]);
            int64_t v1 = vert(in_idx[0], out_idx[1]);
            int64_t v2 = vert(in_idx[0], out_idx[2]);
            mb.tris.insert(mb.tris.end(), {v0, v1, v2});
          } else if (n_in == 3) {  // single triangle, flipped
            int64_t v0 = vert(in_idx[0], out_idx[0]);
            int64_t v1 = vert(in_idx[1], out_idx[0]);
            int64_t v2 = vert(in_idx[2], out_idx[0]);
            mb.tris.insert(mb.tris.end(), {v0, v2, v1});
          } else {  // n_in == 2: quad -> two triangles
            int64_t v00 = vert(in_idx[0], out_idx[0]);
            int64_t v01 = vert(in_idx[0], out_idx[1]);
            int64_t v10 = vert(in_idx[1], out_idx[0]);
            int64_t v11 = vert(in_idx[1], out_idx[1]);
            mb.tris.insert(mb.tris.end(), {v00, v10, v11});
            mb.tris.insert(mb.tris.end(), {v00, v11, v01});
          }
        }
      }
    }
  }
}

MeshAccumulator* g_last = nullptr;

}  // namespace

extern "C" {

// Runs extraction, caches the mesh, returns sizes.
int mt_count(const float* grid, int64_t nx, int64_t ny, int64_t nz,
             double level, int64_t* n_verts, int64_t* n_tris) {
  delete g_last;
  g_last = new MeshAccumulator();
  march(grid, nx, ny, nz, level, *g_last);
  *n_verts = (int64_t)(g_last->verts.size() / 3);
  *n_tris = (int64_t)(g_last->tris.size() / 3);
  return 0;
}

// Copies the cached mesh out and frees it.
int mt_extract(double* verts, int64_t* tris) {
  if (!g_last) return 1;
  std::memcpy(verts, g_last->verts.data(),
              g_last->verts.size() * sizeof(double));
  std::memcpy(tris, g_last->tris.data(),
              g_last->tris.size() * sizeof(int64_t));
  delete g_last;
  g_last = nullptr;
  return 0;
}

}  // extern "C"
