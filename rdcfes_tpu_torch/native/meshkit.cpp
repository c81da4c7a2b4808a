// meshkit: the native host-side mesh runtime of rdcfes_tpu_torch (a copy
// of rdcfes_tpu/native/meshkit.cpp's parser, sparsity builder and
// recursive coordinate bisection).
//
// The C++ reference leaves host-side mesh work to libMesh (Gmsh parsing,
// dof and sparsity construction).  Two of those operations sit on the
// start-up path of every driver run:
//
//   * Gmsh 2.x ASCII parsing (strtod streaming, no per-line Python);
//   * the node-pair block-CSR sparsity and its per-(element, i, j) slot
//     table;
//   * recursive coordinate bisection (RCB) of the elements into the
//     shards of a multi-device run (parallel/halo.py).
//
// A C ABI, called through ctypes (rdcfes_tpu_torch/native/__init__.py),
// which builds this file with the host g++ at first use.  The reference's
// Benes edge colouring (TPU routing) is not part of this copy.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Gmsh 2.x ASCII parser
// ---------------------------------------------------------------------------
// Parses the $Nodes and $Elements sections.  Returns 0 on success.
// Outputs are allocated with malloc and owned by the caller (free via
// meshkit_free).
//
// A 3D file has one volume type, TET4, HEX8, HEX20 or HEX27 (gmsh 4, 5,
// 17, 12), and boundary rows of one face type (TRI3, QUAD4, QUAD8, QUAD9:
// 2, 3, 16, 10).  A file without 3D volume elements is a 2D mesh: its
// TRI3, QUAD4, QUAD8 or QUAD9 rows are the volume elements and its EDGE2
// or EDGE3 rows (1, 8) the boundary (mesh/gmsh.py's classification).
// Anything else (several volume or boundary types, PRISM6, PYRAMID5,
// TET10, a TRI6 2D file) returns a nonzero code, and mesh/gmsh.py's NumPy
// parser reads the file or raises the reference's error.
struct GmshMesh {
  int64_t n_nodes;
  double* coords;        // [n_nodes * 3]
  int64_t n_vol;         // volume elements
  int32_t vol_type;      // gmsh code of the volume elements
  int32_t* vol_conn;     // [n_vol * k]
  int32_t* vol_phys;     // [n_vol]
  int64_t n_surf;
  int32_t surf_type;     // gmsh code of the boundary rows
  int32_t* surf_conn;    // [n_surf * kf]
  int32_t* surf_phys;    // [n_surf]
};

static int gmsh_nnodes(int t) {
  switch (t) {
    case 1: return 2; case 2: return 3; case 3: return 4;
    case 4: return 4; case 5: return 8; case 6: return 6;
    case 7: return 5; case 8: return 3; case 9: return 6;
    case 10: return 9; case 11: return 10; case 12: return 27;
    case 15: return 1; case 16: return 8; case 17: return 20;
    default: return -1;
  }
}

static bool is_volume3d(int t) {
  return t == 4 || t == 5 || t == 12 || t == 17;
}
static bool is_face(int t) {  // 3D boundary rows, 2D volume rows
  return t == 2 || t == 3 || t == 9 || t == 10 || t == 16;
}
static bool is_edge(int t) { return t == 1 || t == 8; }

void meshkit_free(void* p) { free(p); }

int meshkit_read_gmsh(const char* path, GmshMesh* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) { fclose(f); return 2; }
  fclose(f);
  buf[size] = 0;
  char* p = buf.data();

  auto seek_section = [&](const char* name) -> char* {
    char* s = strstr(p, name);
    if (!s) return nullptr;
    s = strchr(s, '\n');
    return s ? s + 1 : nullptr;
  };

  // --- nodes ---
  char* s = seek_section("$Nodes");
  if (!s) return 3;
  char* end;
  int64_t n_nodes = strtoll(s, &end, 10);
  if (end == s || n_nodes <= 0) return 3;     // truncated/garbage header
  s = end;
  out->n_nodes = n_nodes;
  out->coords = (double*)malloc(sizeof(double) * n_nodes * 3);
  std::vector<int64_t> gmsh_id(n_nodes);
  int64_t max_id = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    int64_t id = strtoll(s, &end, 10);
    if (end == s || id <= 0) { free(out->coords); out->coords = nullptr; return 3; }
    s = end;
    gmsh_id[i] = id;
    if (id > max_id) max_id = id;
    for (int d = 0; d < 3; ++d) {
      out->coords[i * 3 + d] = strtod(s, &end);
      if (end == s) { free(out->coords); out->coords = nullptr; return 3; }
      s = end;
    }
  }
  // id -> index map (gmsh files use 1-based, possibly sparse ids)
  std::vector<int32_t> id_map(max_id + 1, -1);
  for (int64_t i = 0; i < n_nodes; ++i) id_map[gmsh_id[i]] = (int32_t)i;

  // --- elements ---
  // error paths from here on free the node buffer allocated above
  auto fail = [&](int code) { free(out->coords); out->coords = nullptr; return code; };
  s = strstr(s, "$Elements");
  if (!s) return fail(4);
  s = strchr(s, '\n');
  if (!s) return fail(4);                      // truncated after header
  s += 1;
  int64_t n_elems = strtoll(s, &end, 10);
  if (end == s || n_elems < 0) return fail(4);
  s = end;
  // node-id lookup with validity checks: ids outside (0, max_id] or ids
  // never defined in $Nodes are file corruption, not silent -1 conn
  auto lookup = [&](int64_t g) -> int32_t {
    if (g <= 0 || g > max_id) return -1;
    return id_map[g];
  };

  std::vector<int32_t> vol_conn, vol_phys, surf_conn, surf_phys;
  std::vector<int32_t> edge_conn, edge_phys;
  int vol_type = -1, surf_type = -1, edge_type = -1;
  for (int64_t e = 0; e < n_elems; ++e) {
    strtoll(s, &end, 10); s = end;              // element id
    int etype = (int)strtol(s, &end, 10); s = end;
    int ntags = (int)strtol(s, &end, 10); s = end;
    int phys = 0;
    for (int t = 0; t < ntags; ++t) {
      long tag = strtol(s, &end, 10); s = end;
      if (t == 0) phys = (int)tag;
    }
    int k = gmsh_nnodes(etype);
    if (k < 0) return fail(5);
    std::vector<int32_t>* conn = nullptr;
    std::vector<int32_t>* phys_out = nullptr;
    int* type_slot = nullptr;
    if (is_volume3d(etype)) {
      conn = &vol_conn; phys_out = &vol_phys; type_slot = &vol_type;
    } else if (is_face(etype)) {
      conn = &surf_conn; phys_out = &surf_phys; type_slot = &surf_type;
    } else if (is_edge(etype)) {
      conn = &edge_conn; phys_out = &edge_phys; type_slot = &edge_type;
    } else if (etype != 15) {
      // PRISM6, PYRAMID5 (mixed meshes) and TET10 take the NumPy path;
      // bailing out (instead of skipping) never drops volume elements
      return fail(6);
    }
    if (conn == nullptr) {                      // points: skip
      for (int i = 0; i < k; ++i) { strtoll(s, &end, 10); s = end; }
      continue;
    }
    if (*type_slot == -1) *type_slot = etype;
    else if (*type_slot != etype) return fail(6);  // mixed types
    for (int i = 0; i < k; ++i) {
      int64_t g = strtoll(s, &end, 10);
      if (end == s) return fail(8);
      s = end;
      int32_t idx = lookup(g);
      if (idx < 0) return fail(8);             // unknown/out-of-range node id
      conn->push_back(idx);
    }
    phys_out->push_back(phys);
  }
  if (vol_type == -1) {
    // a 2D mesh: the face rows are its volume elements (TRI6 ones are
    // refused), the edge rows its boundary
    if (surf_type == -1 || surf_type == 9) return fail(7);
    vol_type = surf_type;
    vol_conn.swap(surf_conn);
    vol_phys.swap(surf_phys);
    surf_type = edge_type;
    surf_conn.swap(edge_conn);
    surf_phys.swap(edge_phys);
  }

  out->vol_type = vol_type;
  out->n_vol = (int64_t)vol_phys.size();
  out->vol_conn = (int32_t*)malloc(sizeof(int32_t) * vol_conn.size());
  memcpy(out->vol_conn, vol_conn.data(), sizeof(int32_t) * vol_conn.size());
  out->vol_phys = (int32_t*)malloc(sizeof(int32_t) * vol_phys.size());
  memcpy(out->vol_phys, vol_phys.data(), sizeof(int32_t) * vol_phys.size());
  out->surf_type = surf_type;
  out->n_surf = (int64_t)surf_phys.size();
  if (out->n_surf) {
    out->surf_conn = (int32_t*)malloc(sizeof(int32_t) * surf_conn.size());
    memcpy(out->surf_conn, surf_conn.data(), sizeof(int32_t) * surf_conn.size());
    out->surf_phys = (int32_t*)malloc(sizeof(int32_t) * surf_phys.size());
    memcpy(out->surf_phys, surf_phys.data(), sizeof(int32_t) * surf_phys.size());
  } else {
    out->surf_conn = nullptr;
    out->surf_phys = nullptr;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Node-pair block-CSR sparsity + slot table
// ---------------------------------------------------------------------------
// From connectivity [E, K] over n_nodes, produce the sorted unique node
// pairs (rows, cols) and the slot index of every (element, i, j).
// Returns nnz, or -1 on error.  rows/cols sized nnz (malloc'd); slots sized
// E*K*K (caller-allocated).
int64_t meshkit_build_sparsity(const int32_t* conn, int64_t E, int32_t K,
                               int64_t n_nodes, int32_t** rows_out,
                               int32_t** cols_out, int32_t* slots) {
  const int64_t n_pairs = E * K * K;
  std::vector<std::pair<int64_t, int64_t>> keyed(n_pairs);
  for (int64_t e = 0; e < E; ++e) {
    const int32_t* ce = conn + e * K;
    for (int i = 0; i < K; ++i)
      for (int j = 0; j < K; ++j) {
        int64_t idx = (e * K + i) * K + j;
        keyed[idx] = {(int64_t)ce[i] * n_nodes + ce[j], idx};
      }
  }
  std::sort(keyed.begin(), keyed.end());
  // count unique
  int64_t nnz = 0;
  int64_t prev = -1;
  for (auto& kv : keyed)
    if (kv.first != prev) { ++nnz; prev = kv.first; }
  *rows_out = (int32_t*)malloc(sizeof(int32_t) * nnz);
  *cols_out = (int32_t*)malloc(sizeof(int32_t) * nnz);
  prev = -1;
  int64_t slot = -1;
  for (auto& kv : keyed) {
    if (kv.first != prev) {
      ++slot;
      prev = kv.first;
      (*rows_out)[slot] = (int32_t)(kv.first / n_nodes);
      (*cols_out)[slot] = (int32_t)(kv.first % n_nodes);
    }
    slots[kv.second] = (int32_t)slot;
  }
  return nnz;
}

// ---------------------------------------------------------------------------
// Recursive coordinate bisection element partitioning
// ---------------------------------------------------------------------------
// centers [E, 3], n_parts must be a power of two times anything — we split
// recursively along the longest axis into equal halves until n_parts blocks
// exist.  part_out sized E.
//
// A verbatim copy of the reference's rcb: std::nth_element orders equal
// centroids (a box mesh is full of them) by the standard library's own
// rule, so only the same code gives the same partition.
static void rcb(const double* centers, std::vector<int64_t>& ids, int lo_part,
                int n_parts, int32_t* part_out) {
  if (n_parts == 1 || ids.size() <= 1) {
    for (auto e : ids) part_out[e] = lo_part;
    return;
  }
  // longest axis of the bounding box
  double mn[3] = {1e300, 1e300, 1e300}, mx[3] = {-1e300, -1e300, -1e300};
  for (auto e : ids)
    for (int d = 0; d < 3; ++d) {
      double c = centers[e * 3 + d];
      if (c < mn[d]) mn[d] = c;
      if (c > mx[d]) mx[d] = c;
    }
  int axis = 0;
  for (int d = 1; d < 3; ++d)
    if (mx[d] - mn[d] > mx[axis] - mn[axis]) axis = d;
  int left_parts = n_parts / 2;
  size_t split = ids.size() * left_parts / n_parts;
  std::nth_element(ids.begin(), ids.begin() + split, ids.end(),
                   [&](int64_t a, int64_t b) {
                     return centers[a * 3 + axis] < centers[b * 3 + axis];
                   });
  std::vector<int64_t> left(ids.begin(), ids.begin() + split);
  std::vector<int64_t> right(ids.begin() + split, ids.end());
  rcb(centers, left, lo_part, left_parts, part_out);
  rcb(centers, right, lo_part + left_parts, n_parts - left_parts, part_out);
}

void meshkit_partition_rcb(const double* centers, int64_t E, int32_t n_parts,
                           int32_t* part_out) {
  std::vector<int64_t> ids(E);
  for (int64_t e = 0; e < E; ++e) ids[e] = e;
  rcb(centers, ids, 0, n_parts, part_out);
}

}  // extern "C"
