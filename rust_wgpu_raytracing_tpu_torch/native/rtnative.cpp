// Native host-side components (C ABI, loaded via ctypes).
//
// The reference's native layer is its Rust host runtime (OBJ import via
// tobj, resource management); the compute path here is PyTorch and the
// CUDA kernels of csrc/, and these C++ routines cover the host-side hot
// paths that stay on the CPU: OBJ parsing with single-index re-indexing
// (tobj semantics, reference src/resources.rs:173-185) and LBVH
// construction (Morton codes + radix sort + Karras 2012 binary radix
// tree + refit) for large scenes where the NumPy/Python builders
// dominate scene-build time. The JAX package's native/rtnative.cpp,
// routine for routine.
//
// Build: at first use by native/__init__.py (g++ -O2 -fPIC -shared
// -std=c++17) into build/native/ at the repository root.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// OBJ parser
// ---------------------------------------------------------------------

struct ObjResult {
  // flat single-indexed soup
  float* positions;  // (n_verts, 3)
  float* uvs;        // (n_verts, 2)
  float* normals;    // (n_verts, 3)
  int32_t* faces;    // (n_faces, 3)
  int32_t* face_mat;   // (n_faces,)
  int32_t* mesh_start; // (n_meshes,) first face of each o/g group
  int64_t n_verts;
  int64_t n_faces;
  int64_t n_meshes;
  char* mtllib;     // referenced .mtl filename ("" if none)
  char* mat_names;  // newline-joined usemtl names in id order
  char* error;      // non-null on failure
};

static char* dup_str(const std::string& s) {
  char* out = (char*)malloc(s.size() + 1);
  memcpy(out, s.c_str(), s.size() + 1);
  return out;
}

// parse one index token "v/t/n" with negative-relative support
static inline void parse_corner(const char* tok, int64_t nv, int64_t nt,
                                int64_t nn, int64_t* vi, int64_t* ti,
                                int64_t* ni) {
  long v = strtol(tok, (char**)&tok, 10);
  long t = 0, n = 0;
  bool has_t = false, has_n = false;
  if (*tok == '/') {
    ++tok;
    if (*tok != '/') {
      t = strtol(tok, (char**)&tok, 10);
      has_t = true;
    }
    if (*tok == '/') {
      ++tok;
      n = strtol(tok, (char**)&tok, 10);
      has_n = true;
    }
  }
  *vi = v > 0 ? v - 1 : nv + v;
  *ti = has_t ? (t > 0 ? t - 1 : nt + t) : -1;
  *ni = has_n ? (n > 0 ? n - 1 : nn + n) : -1;
}

ObjResult* obj_parse(const char* path) {
  auto* res = (ObjResult*)calloc(1, sizeof(ObjResult));
  FILE* f = fopen(path, "rb");
  if (!f) {
    res->error = dup_str(std::string("cannot open ") + path);
    return res;
  }

  std::vector<float> vs, vts, vns;        // raw attribute pools
  std::vector<float> opos, ouv, onrm;     // deduped output pools
  std::vector<int32_t> ofaces, omat;
  std::vector<int32_t> mesh_start;
  std::string mtllib;
  // remap key: (vi<<42)|(ti<<21)|ni with 21-bit fields (+1 bias for -1)
  std::unordered_map<uint64_t, int32_t> remap;
  remap.reserve(1 << 16);
  int cur_mat = 0;
  std::unordered_map<std::string, int> mat_ids;
  std::vector<std::string> mat_order;
  int n_mats = 0;
  bool group_open = false;

  // getline: arbitrary line lengths (an 8 KB fgets buffer split giant
  // face lines mid-token and misparsed the tail as directives)
  char* line = nullptr;
  size_t line_cap = 0;
  ssize_t line_len;
  bool bail = false;  // unsupported input -> caller falls back to python
  while (!bail && (line_len = getline(&line, &line_cap, f)) != -1) {
    (void)line_len;
    char* p = line;
    while (*p == ' ' || *p == '\t') ++p;
    if (p[0] == 'v' && p[1] == ' ') {
      float x = 0, y = 0, z = 0;
      sscanf(p + 2, "%f %f %f", &x, &y, &z);
      vs.push_back(x); vs.push_back(y); vs.push_back(z);
    } else if (p[0] == 'v' && p[1] == 't') {
      float u = 0, v = 0;
      sscanf(p + 2, "%f %f", &u, &v);
      vts.push_back(u); vts.push_back(v);
    } else if (p[0] == 'v' && p[1] == 'n') {
      float x = 0, y = 0, z = 0;
      sscanf(p + 2, "%f %f %f", &x, &y, &z);
      vns.push_back(x); vns.push_back(y); vns.push_back(z);
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      if (!group_open) {
        mesh_start.push_back((int32_t)(ofaces.size() / 3));
        group_open = true;
      }
      // gather corner output indices with dedup (python parity:
      // first-appearance order)
      int32_t corner_idx[256];
      int n_corners = 0;
      char* tok = strtok(p + 1, " \t\r\n");
      while (tok) {
        if (n_corners >= 256) {
          // polygon wider than the fan buffer: bail (silently dropping
          // corners would diverge from the python parser)
          bail = true;
          break;
        }
        int64_t vi, ti, ni;
        parse_corner(tok, (int64_t)vs.size() / 3, (int64_t)vts.size() / 2,
                     (int64_t)vns.size() / 3, &vi, &ti, &ni);
        if (vi + 1 >= (1 << 21) || ti + 1 >= (1 << 21)
            || ni + 1 >= (1 << 21)) {
          // attribute index overflows the 21-bit remap key fields —
          // colliding keys would silently corrupt geometry; bail
          bail = true;
          break;
        }
        uint64_t key = (((uint64_t)(vi + 1)) << 42)
                       | (((uint64_t)(ti + 1)) << 21)
                       | ((uint64_t)(ni + 1));
        auto it = remap.find(key);
        int32_t idx;
        if (it == remap.end()) {
          idx = (int32_t)(opos.size() / 3);
          remap.emplace(key, idx);
          opos.push_back(vs[vi * 3 + 0]);
          opos.push_back(vs[vi * 3 + 1]);
          opos.push_back(vs[vi * 3 + 2]);
          if (ti >= 0) {
            ouv.push_back(vts[ti * 2 + 0]);
            ouv.push_back(vts[ti * 2 + 1]);
          } else {
            ouv.push_back(0.f); ouv.push_back(0.f);
          }
          if (ni >= 0) {
            onrm.push_back(vns[ni * 3 + 0]);
            onrm.push_back(vns[ni * 3 + 1]);
            onrm.push_back(vns[ni * 3 + 2]);
          } else {
            onrm.push_back(0.f); onrm.push_back(0.f); onrm.push_back(0.f);
          }
        } else {
          idx = it->second;
        }
        corner_idx[n_corners++] = idx;
        tok = strtok(nullptr, " \t\r\n");
      }
      for (int i = 1; i + 1 < n_corners; ++i) {  // fan triangulation
        ofaces.push_back(corner_idx[0]);
        ofaces.push_back(corner_idx[i]);
        ofaces.push_back(corner_idx[i + 1]);
        omat.push_back(cur_mat);
      }
    } else if (!strncmp(p, "usemtl", 6)) {
      char name[1024] = {0};
      sscanf(p + 6, "%1023s", name);
      auto it = mat_ids.find(name);
      if (it == mat_ids.end()) {
        cur_mat = n_mats;
        mat_ids.emplace(name, n_mats++);
        mat_order.push_back(name);
      } else {
        cur_mat = it->second;
      }
    } else if (!strncmp(p, "mtllib", 6)) {
      // rest of line, trimmed: MTL filenames may contain spaces
      char* q = p + 6;
      while (*q == ' ' || *q == '\t') ++q;
      char* e = q + strlen(q);
      while (e > q && (e[-1] == '\n' || e[-1] == '\r' || e[-1] == ' '
                       || e[-1] == '\t')) --e;
      mtllib.assign(q, (size_t)(e - q));
    } else if ((p[0] == 'o' || p[0] == 'g')
               && (p[1] == ' ' || p[1] == '\n' || p[1] == '\r')) {
      group_open = false;   // next face starts a new mesh
      remap.clear();        // python-parity: remap restarts per group
      // NOTE: the python importer also restarts the OUTPUT pools per
      // mesh; the soup layout here is the concatenation, which is what
      // Scene.build produces anyway.
    }
  }
  free(line);
  fclose(f);
  if (bail) {
    // unsupported input (giant polygon or attribute indices past the
    // 21-bit remap key): report an error so the caller's ValueError
    // path falls back to the python parser instead of silently
    // diverging
    res->error = dup_str("unsupported OBJ feature for the native "
                         "fast path; use the python parser");
    return res;
  }
  std::string names;
  for (size_t k = 0; k < mat_order.size(); ++k) {
    if (k) names += "\n";
    names += mat_order[k];
  }

  if (mesh_start.empty()) mesh_start.push_back(0);

  res->n_verts = (int64_t)(opos.size() / 3);
  res->n_faces = (int64_t)(ofaces.size() / 3);
  res->n_meshes = (int64_t)mesh_start.size();
  res->positions = (float*)malloc(opos.size() * sizeof(float));
  memcpy(res->positions, opos.data(), opos.size() * sizeof(float));
  res->uvs = (float*)malloc(ouv.size() * sizeof(float));
  memcpy(res->uvs, ouv.data(), ouv.size() * sizeof(float));
  res->normals = (float*)malloc(onrm.size() * sizeof(float));
  memcpy(res->normals, onrm.data(), onrm.size() * sizeof(float));
  res->faces = (int32_t*)malloc(ofaces.size() * sizeof(int32_t));
  memcpy(res->faces, ofaces.data(), ofaces.size() * sizeof(int32_t));
  res->face_mat = (int32_t*)malloc(omat.size() * sizeof(int32_t));
  memcpy(res->face_mat, omat.data(), omat.size() * sizeof(int32_t));
  res->mesh_start = (int32_t*)malloc(mesh_start.size() * sizeof(int32_t));
  memcpy(res->mesh_start, mesh_start.data(),
         mesh_start.size() * sizeof(int32_t));
  res->mtllib = dup_str(mtllib);
  res->mat_names = dup_str(names);
  return res;
}

void obj_free(ObjResult* r) {
  if (!r) return;
  free(r->positions); free(r->uvs); free(r->normals);
  free(r->faces); free(r->face_mat); free(r->mesh_start);
  free(r->mtllib); free(r->mat_names); free(r->error);
  free(r);
}

// ---------------------------------------------------------------------
// Morton codes + radix sort + LBVH (Karras 2012)
// ---------------------------------------------------------------------

static inline uint32_t expand_bits(uint32_t v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

void morton3d(const float* pts, int64_t n, uint32_t* out) {
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) {
      float v = pts[i * 3 + a];
      if (v < lo[a]) lo[a] = v;
      if (v > hi[a]) hi[a] = v;
    }
  float ext[3];
  for (int a = 0; a < 3; ++a) {
    ext[a] = hi[a] - lo[a];
    if (ext[a] < 1e-12f) ext[a] = 1e-12f;
  }
  for (int64_t i = 0; i < n; ++i) {
    uint32_t q[3];
    for (int a = 0; a < 3; ++a) {
      float t = (pts[i * 3 + a] - lo[a]) / ext[a] * 1023.f;
      if (t < 0) t = 0;
      if (t > 1023) t = 1023;
      q[a] = (uint32_t)t;
    }
    out[i] = (expand_bits(q[0]) << 2) | (expand_bits(q[1]) << 1)
             | expand_bits(q[2]);
  }
}

// stable LSD radix sort of (code, index) pairs by code
void radix_sort_u32(const uint32_t* codes, int64_t n, int32_t* order) {
  std::vector<int32_t> idx(n), tmp(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = (int32_t)i;
  std::vector<int64_t> count(257);
  for (int pass = 0; pass < 4; ++pass) {
    int shift = pass * 8;
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; ++i)
      ++count[((codes[idx[i]] >> shift) & 0xFF) + 1];
    for (int b = 0; b < 256; ++b) count[b + 1] += count[b];
    for (int64_t i = 0; i < n; ++i)
      tmp[count[(codes[idx[i]] >> shift) & 0xFF]++] = idx[i];
    idx.swap(tmp);
  }
  memcpy(order, idx.data(), n * sizeof(int32_t));
}

static inline int delta(const uint32_t* c, int64_t n, int64_t i, int64_t j) {
  if (j < 0 || j >= n) return -1;
  if (c[i] == c[j]) {
    uint64_t x = (uint64_t)(i ^ j);
    int lead = x == 0 ? 64 : __builtin_clzll(x);
    return 32 + lead;
  }
  return __builtin_clz(c[i] ^ c[j]);
}

// Karras binary radix tree over n sorted codes; fills left/right
// (n-1 each) and parent (2n-1; root parent = -1). Node ids: internal
// 0..n-2, leaf i = n-1+i.
void lbvh_build(const uint32_t* codes, int64_t n, int32_t* left,
                int32_t* right, int32_t* parent) {
  for (int64_t i = 0; i < 2 * n - 1; ++i) parent[i] = -1;
  if (n == 1) return;
  for (int64_t i = 0; i < n - 1; ++i) {
    int d = delta(codes, n, i, i + 1) > delta(codes, n, i, i - 1) ? 1 : -1;
    int dmin = delta(codes, n, i, i - d);
    int64_t lmax = 2;
    while (delta(codes, n, i, i + lmax * d) > dmin) lmax *= 2;
    int64_t l = 0;
    for (int64_t t = lmax / 2; t >= 1; t /= 2)
      if (delta(codes, n, i, i + (l + t) * d) > dmin) l += t;
    int64_t j = i + l * d;
    int dnode = delta(codes, n, i, j);
    int64_t s = 0;
    int64_t t = (l + 1) / 2;
    while (true) {
      if (delta(codes, n, i, i + (s + t) * d) > dnode) s += t;
      if (t == 1) break;
      t = (t + 1) / 2;
    }
    int64_t gamma = i + s * d + (d < 0 ? d : 0);
    int64_t lo = i < j ? i : j, hi = i > j ? i : j;
    int64_t lchild = (lo == gamma) ? (n - 1 + gamma) : gamma;
    int64_t rchild = (hi == gamma + 1) ? (n + gamma) : (gamma + 1);
    left[i] = (int32_t)lchild;
    right[i] = (int32_t)rchild;
    parent[lchild] = (int32_t)i;
    parent[rchild] = (int32_t)i;
  }
}

// bottom-up AABB refit: leaf AABBs in node_lo/hi[n-1 .. 2n-2]
void lbvh_refit(const int32_t* left, const int32_t* right,
                const int32_t* parent, int64_t n, float* node_lo,
                float* node_hi) {
  if (n == 1) return;
  std::vector<int32_t> visit(n - 1, 0);
  // process leaves upward; second visitor computes the parent
  for (int64_t leaf = 0; leaf < n; ++leaf) {
    int32_t node = parent[n - 1 + leaf];
    while (node >= 0) {
      if (__atomic_add_fetch(&visit[node], 1, __ATOMIC_RELAXED) < 2) break;
      int32_t l = left[node], r = right[node];
      for (int a = 0; a < 3; ++a) {
        float lo = node_lo[l * 3 + a] < node_lo[r * 3 + a]
                       ? node_lo[l * 3 + a] : node_lo[r * 3 + a];
        float hi = node_hi[l * 3 + a] > node_hi[r * 3 + a]
                       ? node_hi[l * 3 + a] : node_hi[r * 3 + a];
        node_lo[node * 3 + a] = lo;
        node_hi[node * 3 + a] = hi;
      }
      node = parent[node];
    }
  }
}

}  // extern "C"
