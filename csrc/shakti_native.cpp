// shakti_native: host-side mesh/runtime engine for the JAX framework.
//
// Native re-provision of the host-side machinery the reference gets from
// C/C++ dependencies (SURVEY §2b): the mesh partitioner (ParMETIS inside
// gmshio), boundary topology (DOLFINx), point-in-polygon (GEOS/shapely),
// gridded interpolation (scipy), plus this framework's own operator
// sparsity builders (ELL / block-ELL slot maps).  The Python layer
// (shakti_tpu.native) loads this via ctypes and falls back to numpy
// implementations when the library is absent; results are bit-identical.
//
// Build: make -C csrc   (produces libshakti_native.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- RCB order
// Spatial ordering by recursive coordinate bisection (matches
// parallel/partition.py:rcb_order: stable sort on the widest axis, split at
// floor(n/2), recurse; leaves of size <= leaf emitted in order).
static void rcb_rec(const double* xy, std::vector<int64_t>& idx,
                    int64_t lo, int64_t hi, int64_t leaf,
                    std::vector<int64_t>& scratch) {
  const int64_t n = hi - lo;
  if (n <= leaf) return;
  double minx = 1e300, maxx = -1e300, miny = 1e300, maxy = -1e300;
  for (int64_t i = lo; i < hi; ++i) {
    const double x = xy[2 * idx[i]], y = xy[2 * idx[i] + 1];
    minx = std::min(minx, x); maxx = std::max(maxx, x);
    miny = std::min(miny, y); maxy = std::max(maxy, y);
  }
  const int axis = (maxx - minx) >= (maxy - miny) ? 0 : 1;
  std::stable_sort(idx.begin() + lo, idx.begin() + hi,
                   [&](int64_t a, int64_t b) {
                     return xy[2 * a + axis] < xy[2 * b + axis];
                   });
  const int64_t mid = lo + n / 2;
  rcb_rec(xy, idx, lo, mid, leaf, scratch);
  rcb_rec(xy, idx, mid, hi, leaf, scratch);
}

void shakti_rcb_order(const double* xy, int64_t n, int64_t leaf,
                      int64_t* out_perm) {
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  std::vector<int64_t> scratch;
  rcb_rec(xy, idx, 0, n, leaf, scratch);
  std::memcpy(out_perm, idx.data(), n * sizeof(int64_t));
}

// ------------------------------------------------------------ RCB partition
// Matches parallel/partition.py:rcb_partition (proportional split sizes).
static void rcb_part_rec(const double* xy, std::vector<int64_t>& idx,
                         int64_t lo, int64_t hi, int parts, int base,
                         int32_t* out_part) {
  const int64_t n = hi - lo;
  if (parts == 1 || n == 0) {
    for (int64_t i = lo; i < hi; ++i) out_part[idx[i]] = base;
    return;
  }
  const int p_lo = parts / 2;
  const int64_t n_lo = (int64_t)std::llround((double)n * p_lo / parts);
  double minx = 1e300, maxx = -1e300, miny = 1e300, maxy = -1e300;
  for (int64_t i = lo; i < hi; ++i) {
    const double x = xy[2 * idx[i]], y = xy[2 * idx[i] + 1];
    minx = std::min(minx, x); maxx = std::max(maxx, x);
    miny = std::min(miny, y); maxy = std::max(maxy, y);
  }
  const int axis = (maxx - minx) >= (maxy - miny) ? 0 : 1;
  std::stable_sort(idx.begin() + lo, idx.begin() + hi,
                   [&](int64_t a, int64_t b) {
                     return xy[2 * a + axis] < xy[2 * b + axis];
                   });
  rcb_part_rec(xy, idx, lo, lo + n_lo, p_lo, base, out_part);
  rcb_part_rec(xy, idx, lo + n_lo, hi, parts - p_lo, base + p_lo, out_part);
}

void shakti_rcb_partition(const double* xy, int64_t n, int32_t n_parts,
                          int32_t* out_part) {
  std::vector<int64_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = i;
  rcb_part_rec(xy, idx, 0, n, n_parts, 0, out_part);
}

// -------------------------------------------------------- boundary edges
// Edges appearing in exactly one triangle; returns count, fills out_edges
// (2 ints per edge, original orientation).  Hash on the sorted pair.
int64_t shakti_boundary_edges(const int32_t* cells, int64_t c,
                              int32_t* out_edges) {
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> once;
  std::unordered_map<uint64_t, int> count;
  once.reserve(3 * c);
  count.reserve(3 * c);
  const int ei[3] = {0, 1, 2}, ej[3] = {1, 2, 0};
  for (int64_t t = 0; t < c; ++t) {
    for (int e = 0; e < 3; ++e) {
      const int32_t a = cells[3 * t + ei[e]], b = cells[3 * t + ej[e]];
      const uint64_t key = ((uint64_t)std::min(a, b) << 32) |
                           (uint32_t)std::max(a, b);
      auto it = count.find(key);
      if (it == count.end()) {
        count.emplace(key, 1);
        once.emplace(key, std::make_pair(a, b));
      } else {
        it->second++;
      }
    }
  }
  // deterministic output order: sort by key
  std::vector<uint64_t> keys;
  keys.reserve(once.size());
  for (auto& kv : count)
    if (kv.second == 1) keys.push_back(kv.first);
  std::sort(keys.begin(), keys.end());
  int64_t m = 0;
  for (uint64_t k : keys) {
    auto& pr = once[k];
    out_edges[2 * m] = pr.first;
    out_edges[2 * m + 1] = pr.second;
    ++m;
  }
  return m;
}

// ------------------------------------------------------- point in polygon
// Even-odd ray casting, NaN rows delimit rings (matches
// mesh/geometry.py:points_in_polygon).
void shakti_points_in_polygon(const double* pts, int64_t m,
                              const double* poly, int64_t k,
                              uint8_t* out) {
  std::memset(out, 0, m);
  // split rings
  std::vector<std::pair<int64_t, int64_t>> rings;  // [start, end)
  int64_t start = 0;
  for (int64_t i = 0; i <= k; ++i) {
    const bool brk = (i == k) || std::isnan(poly[2 * i]);
    if (brk) {
      if (i - start >= 3) rings.emplace_back(start, i);
      start = i + 1;
    }
  }
  for (auto& rg : rings) {
    int64_t lo = rg.first, hi = rg.second;
    // drop duplicated closing vertex
    if (poly[2 * lo] == poly[2 * (hi - 1)] &&
        poly[2 * lo + 1] == poly[2 * (hi - 1) + 1])
      --hi;
    const int64_t nv = hi - lo;
    if (nv < 3) continue;
    for (int64_t p = 0; p < m; ++p) {
      const double x = pts[2 * p], y = pts[2 * p + 1];
      int crossings = 0;
      for (int64_t v = 0; v < nv; ++v) {
        const double x1 = poly[2 * (lo + v)], y1 = poly[2 * (lo + v) + 1];
        const int64_t w = lo + (v + 1) % nv;
        const double x2 = poly[2 * w], y2 = poly[2 * w + 1];
        if ((y1 > y) != (y2 > y)) {
          const double xi = (y2 == y1) ? 1e300
                                       : (x2 - x1) * (y - y1) / (y2 - y1) + x1;
          if (x < xi) ++crossings;
        }
      }
      if (crossings & 1) out[p] = 1;
    }
  }
}

// ----------------------------------------------------------- ELL sparsity
// Build scalar-ELL structure (matches fem/ell.py:build_ell_map).  Returns K
// (>0) on success or -K_needed if max_k is too small.  cols must hold
// n*max_k int32, slot_map 9*c int32, diag_slot n int32.
int64_t shakti_ell_build(const int32_t* cells, int64_t c, int64_t n,
                         int64_t max_k, int32_t* cols, int32_t* slot_map,
                         int32_t* diag_slot) {
  // adjacency sets per row via sorted unique pairs
  std::vector<uint64_t> keys(9 * c);
  int64_t idx = 0;
  for (int64_t t = 0; t < c; ++t)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        keys[idx++] = ((uint64_t)cells[3 * t + i] * (uint64_t)n) +
                      (uint64_t)cells[3 * t + j];
  std::vector<uint64_t> uniq(keys);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());

  std::vector<int64_t> deg(n, 0);
  for (uint64_t u : uniq) deg[u / n]++;
  int64_t K = 0;
  for (int64_t r = 0; r < n; ++r) K = std::max(K, deg[r]);
  if (K > max_k) return -K;

  std::vector<int64_t> row_start(n + 1, 0);
  for (int64_t r = 0; r < n; ++r) row_start[r + 1] = row_start[r] + deg[r];

  for (int64_t r = 0; r < n; ++r)
    for (int64_t kk = 0; kk < K; ++kk) cols[r * K + kk] = (int32_t)r;  // pad=self
  std::vector<int32_t> slot_of(uniq.size());
  for (size_t u = 0; u < uniq.size(); ++u) {
    const int64_t r = uniq[u] / n, cc = uniq[u] % n;
    const int32_t s = (int32_t)(u - row_start[r]);
    slot_of[u] = s;
    cols[r * K + s] = (int32_t)cc;
  }
  for (int64_t e = 0; e < 9 * c; ++e) {
    const uint64_t key = keys[e];
    const size_t u = std::lower_bound(uniq.begin(), uniq.end(), key) -
                     uniq.begin();
    const int64_t r = key / n;
    slot_map[e] = (int32_t)(r * K + slot_of[u]);
  }
  for (int64_t r = 0; r < n; ++r) {
    const uint64_t key = (uint64_t)r * (uint64_t)n + (uint64_t)r;
    const auto it = std::lower_bound(uniq.begin(), uniq.end(), key);
    diag_slot[r] = (it != uniq.end() && *it == key)
                       ? slot_of[it - uniq.begin()] : 0;
  }
  return K;
}

// ----------------------------------------------------- block-ELL sparsity
// Matches fem/bell.py:build_block_ell.  Returns KB (>0) or -KB_needed.
// nbr must hold NB*max_kb int32, slot_map 9*c int64, diag_pos n int64.
int64_t shakti_bell_build(const int32_t* cells, int64_t c, int64_t n,
                          int64_t B, int64_t max_kb, int32_t* nbr,
                          int64_t* slot_map, int64_t* diag_pos) {
  const int64_t NB = (n + B - 1) / B;
  std::vector<uint64_t> bkeys(9 * c);
  int64_t idx = 0;
  for (int64_t t = 0; t < c; ++t)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const int64_t br = cells[3 * t + i] / B, bc = cells[3 * t + j] / B;
        bkeys[idx++] = (uint64_t)br * (uint64_t)NB + (uint64_t)bc;
      }
  std::vector<uint64_t> uniq(bkeys);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());

  std::vector<int64_t> deg(NB, 0);
  for (uint64_t u : uniq) deg[u / NB]++;
  int64_t KB = 0;
  for (int64_t r = 0; r < NB; ++r) KB = std::max(KB, deg[r]);
  if (KB > max_kb) return -KB;

  std::vector<int64_t> row_start(NB + 1, 0);
  for (int64_t r = 0; r < NB; ++r) row_start[r + 1] = row_start[r] + deg[r];
  for (int64_t r = 0; r < NB; ++r)
    for (int64_t kk = 0; kk < KB; ++kk) nbr[r * KB + kk] = (int32_t)r;
  std::vector<int32_t> kb_of(uniq.size());
  for (size_t u = 0; u < uniq.size(); ++u) {
    const int64_t r = uniq[u] / NB, cc = uniq[u] % NB;
    const int32_t s = (int32_t)(u - row_start[r]);
    kb_of[u] = s;
    nbr[r * KB + s] = (int32_t)cc;
  }
  for (int64_t e = 0; e < 9 * c; ++e) {
    const int64_t t = e / 9, rem = e % 9, i = rem / 3, j = rem % 3;
    const int64_t row = cells[3 * t + i], col = cells[3 * t + j];
    const uint64_t key = (uint64_t)(row / B) * (uint64_t)NB +
                         (uint64_t)(col / B);
    const size_t u = std::lower_bound(uniq.begin(), uniq.end(), key) -
                     uniq.begin();
    slot_map[e] = (((row / B) * KB + kb_of[u]) * B + row % B) * B + col % B;
  }
  for (int64_t r = 0; r < n; ++r) {
    const int64_t br = r / B;
    const uint64_t key = (uint64_t)br * (uint64_t)NB + (uint64_t)br;
    const auto it = std::lower_bound(uniq.begin(), uniq.end(), key);
    const int32_t kb = (it != uniq.end() && *it == key)
                           ? kb_of[it - uniq.begin()] : 0;
    diag_pos[r] = ((br * KB + kb) * B + r % B) * B + r % B;
  }
  return KB;
}

// ------------------------------------------------------ bilinear interp
// Matches data/interp.py:GridInterpolator (ascending axes, clamped).
void shakti_bilinear(const double* gx, int64_t nx, const double* gy,
                     int64_t ny, const double* f, const double* px,
                     const double* py, int64_t m, double* out) {
  for (int64_t p = 0; p < m; ++p) {
    double x = std::min(std::max(px[p], gx[0]), gx[nx - 1]);
    double y = std::min(std::max(py[p], gy[0]), gy[ny - 1]);
    int64_t i = std::upper_bound(gx, gx + nx, x) - gx - 1;
    int64_t j = std::upper_bound(gy, gy + ny, y) - gy - 1;
    i = std::min(std::max(i, (int64_t)0), nx - 2);
    j = std::min(std::max(j, (int64_t)0), ny - 2);
    const double x0 = gx[i], x1 = gx[i + 1], y0 = gy[j], y1 = gy[j + 1];
    const double tx = (x1 > x0) ? (x - x0) / (x1 - x0) : 0.0;
    const double ty = (y1 > y0) ? (y - y0) / (y1 - y0) : 0.0;
    const double f00 = f[j * nx + i], f10 = f[j * nx + i + 1];
    const double f01 = f[(j + 1) * nx + i], f11 = f[(j + 1) * nx + i + 1];
    out[p] = (1 - tx) * (1 - ty) * f00 + tx * (1 - ty) * f10 +
             (1 - tx) * ty * f01 + tx * ty * f11;
  }
}


// ----------------------------------------------------- block-CSR sparsity
// Matches fem/bcsr.py:build_bcsr.  Returns nnzb (>0) or -nnzb_needed when
// max_nnzb is too small.  brow/bcol must hold max_nnzb int32; blk_map and
// off_map 9*c int32; diag_blk/diag_off n int32.
int64_t shakti_bcsr_build(const int32_t* cells, int64_t c, int64_t n,
                          int64_t B, int64_t max_nnzb, int32_t* brow,
                          int32_t* bcol, int32_t* blk_map, int32_t* off_map,
                          int32_t* diag_blk, int32_t* diag_off) {
  const int64_t NB = (n + B - 1) / B;
  std::vector<uint64_t> bkeys(9 * c);
  int64_t idx = 0;
  for (int64_t t = 0; t < c; ++t)
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        const int64_t br = cells[3 * t + i] / B, bc = cells[3 * t + j] / B;
        bkeys[idx++] = (uint64_t)br * (uint64_t)NB + (uint64_t)bc;
      }
  std::vector<uint64_t> uniq(bkeys);
  std::sort(uniq.begin(), uniq.end());
  uniq.erase(std::unique(uniq.begin(), uniq.end()), uniq.end());
  const int64_t nnzb = (int64_t)uniq.size();
  if (nnzb > max_nnzb) return -nnzb;

  for (int64_t k = 0; k < nnzb; ++k) {
    brow[k] = (int32_t)(uniq[k] / NB);
    bcol[k] = (int32_t)(uniq[k] % NB);
  }
  for (int64_t e = 0; e < 9 * c; ++e) {
    const size_t u = std::lower_bound(uniq.begin(), uniq.end(), bkeys[e]) -
                     uniq.begin();
    blk_map[e] = (int32_t)u;
    const int64_t t = e / 9, rem = e % 9, i = rem / 3, j = rem % 3;
    const int64_t row = cells[3 * t + i], col = cells[3 * t + j];
    off_map[e] = (int32_t)((row % B) * B + col % B);
  }
  for (int64_t r = 0; r < n; ++r) {
    const uint64_t key = (uint64_t)(r / B) * (uint64_t)NB + (uint64_t)(r / B);
    auto it = std::lower_bound(uniq.begin(), uniq.end(), key);
    diag_blk[r] = (int32_t)((it != uniq.end() && *it == key)
                                ? (it - uniq.begin()) : 0);
    diag_off[r] = (int32_t)((r % B) * B + r % B);
  }
  return nnzb;
}

// ------------------------------------------------------------ source hash
// Stamped by the Makefile from sha256(shakti_native.cpp); the Python loader
// compares it against the on-disk source and falls back to numpy when a
// stale binary is detected.
const char* shakti_src_hash() {
#ifdef SHAKTI_SRC_HASH
  return SHAKTI_SRC_HASH;
#else
  return "";
#endif
}

}  // extern "C"
