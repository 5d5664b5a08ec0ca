// MSER component-tree pass — the host half of ops/mser.py.
//
// Per-pixel union-find with data-dependent merge history is the CCL/
// GrabCut-precedent shape (pointer chasing a device cannot express); this
// native pass emits only the (seed, level, area) stability triples and
// the Python side extracts pixel sets with one CCL per level. MUST stay
// bit-identical to ops/mser.py::_mser_triples_spec — tests pin it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Ident {
  int32_t birth;
  int32_t seed;
  int32_t absorber = -1;     // identity that absorbed this one
  int32_t absorb_level = -1;
  std::vector<int32_t> levels;  // area-change points
  std::vector<int32_t> areas;
};

int64_t uf_find(std::vector<int64_t>& parent, int64_t x) {
  int64_t r = x;
  while (parent[r] != r) r = parent[r];
  while (parent[x] != r) {
    int64_t nxt = parent[x];
    parent[x] = r;
    x = nxt;
  }
  return r;
}

int32_t chase(const std::vector<Ident>& idents, int32_t id, int32_t level) {
  while (idents[id].absorber >= 0 && idents[id].absorb_level <= level)
    id = idents[id].absorber;
  return id;
}

int32_t area_at(const std::vector<Ident>& idents, int32_t id, int32_t level) {
  id = chase(idents, id, level);
  const Ident& it = idents[id];
  if (level < it.birth) level = it.birth;
  // last recorded area at level <= query
  auto pos = std::upper_bound(it.levels.begin(), it.levels.end(), level);
  if (pos == it.levels.begin()) return it.areas.empty() ? 1 : it.areas[0];
  return it.areas[pos - it.levels.begin() - 1];
}

struct Cand {
  double var;
  int32_t area;
  int32_t seed;
  int32_t level;
  int32_t ident;
  bool operator<(const Cand& o) const {
    if (var != o.var) return var < o.var;
    if (area != o.area) return area > o.area;  // -area ascending
    if (seed != o.seed) return seed < o.seed;
    return level < o.level;
  }
};

}  // namespace

extern "C" {

// Emits (seed, level, area) int32 triples into out (row-major, cap rows
// available). Returns the number of MSERs found (may exceed cap — caller
// re-calls with a bigger buffer; only cap rows are written), or -1 on bad
// arguments.
long rcv_mser(const uint8_t* gray, int h, int w, int delta, int min_area,
              int max_area, double max_variation, double min_diversity,
              int32_t* out, long cap) {
  if (!gray || h <= 0 || w <= 0 || delta < 0 || !out || cap < 0) return -1;
  const int64_t n = (int64_t)h * w;

  // counting sort by (gray, flat index)
  std::vector<int64_t> bucket_start(257, 0);
  for (int64_t i = 0; i < n; ++i) bucket_start[gray[i] + 1]++;
  for (int i = 0; i < 256; ++i) bucket_start[i + 1] += bucket_start[i];
  std::vector<int64_t> order(n);
  {
    std::vector<int64_t> cur(bucket_start.begin(), bucket_start.end() - 1);
    for (int64_t i = 0; i < n; ++i) order[cur[gray[i]]++] = i;
  }

  std::vector<int64_t> parent(n, -1);
  std::vector<int32_t> root_ident(n, -1);   // valid at live roots
  std::vector<int32_t> root_area(n, 0);
  std::vector<Ident> idents;
  idents.reserve(1024);
  std::vector<int32_t> touched;
  std::vector<int32_t> last_rec;  // last recorded area per ident (0 = none)

  int64_t pos = 0;
  for (int level = 0; level < 256 && pos < n; ++level) {
    const int64_t end = bucket_start[level + 1];
    for (int64_t k = pos; k < end; ++k) {
      const int64_t p = order[k];
      parent[p] = p;
      const int32_t ident = (int32_t)idents.size();
      idents.push_back(Ident{level, (int32_t)p});
      last_rec.push_back(0);
      root_ident[p] = ident;
      root_area[p] = 1;
      touched.push_back(ident);
      const int64_t y = p / w, x = p % w;
      const int64_t nbrs[4] = {y > 0 ? p - w : -1, y + 1 < h ? p + w : -1,
                               x > 0 ? p - 1 : -1, x + 1 < w ? p + 1 : -1};
      for (int64_t q : nbrs) {
        if (q < 0 || parent[q] < 0) continue;
        int64_t ra = uf_find(parent, p), rb = uf_find(parent, q);
        if (ra == rb) continue;
        int32_t ia = root_ident[ra], ib = root_ident[rb];
        int32_t aa = root_area[ra], ab = root_area[rb];
        // larger area absorbs; tie → smaller seed (matches the Python
        // tuple compare (area, -seed))
        const bool swap =
            (ab > aa) || (ab == aa && idents[ib].seed < idents[ia].seed);
        if (swap) {
          std::swap(ra, rb);
          std::swap(ia, ib);
          std::swap(aa, ab);
        }
        parent[rb] = ra;
        root_area[ra] = aa + ab;
        root_ident[rb] = -1;
        idents[ib].absorber = ia;
        idents[ib].absorb_level = level;
        touched.push_back(ia);
      }
    }
    pos = end;
    // record area-change points for identities touched this level
    for (size_t t = 0; t < touched.size(); ++t) {
      const int32_t id = touched[t];
      Ident& it = idents[id];
      if (it.absorber >= 0 && it.absorb_level == level) continue;
      const int64_t r = uf_find(parent, it.seed);
      if (root_ident[r] != id) continue;  // absorbed transitively
      const int32_t a = root_area[r];
      if (it.areas.empty() || it.areas.back() != a) {
        // dedup within the level: the same ident may appear twice in
        // touched; the second pass sees an unchanged area and skips
        if (!it.levels.empty() && it.levels.back() == level) {
          it.areas.back() = a;
        } else {
          it.levels.push_back(level);
          it.areas.push_back(a);
        }
      }
    }
    touched.clear();
  }

  // --- stability scan ----------------------------------------------------
  std::vector<Cand> cands;
  std::vector<double> vs;
  for (int32_t id = 0; id < (int32_t)idents.size(); ++id) {
    const Ident& it = idents[id];
    if (it.levels.empty()) continue;
    vs.clear();
    for (size_t i = 0; i < it.levels.size(); ++i) {
      const int32_t lv = it.levels[i];
      const int32_t a_hi =
          area_at(idents, id, std::min(lv + delta, 255));
      const int32_t a_lo =
          area_at(idents, id, std::max(lv - delta, it.birth));
      const int32_t a = area_at(idents, id, lv);
      vs.push_back((double)(a_hi - a_lo) / (double)a);
    }
    for (size_t i = 0; i < it.levels.size(); ++i) {
      if (vs[i] > max_variation) continue;
      const int32_t a = it.areas[i];
      if (a < min_area || a > max_area) continue;
      if (i > 0 && vs[i] > vs[i - 1]) continue;
      if (i + 1 < vs.size() && vs[i] > vs[i + 1]) continue;
      cands.push_back(Cand{vs[i], a, it.seed, it.levels[i], id});
    }
  }
  std::sort(cands.begin(), cands.end());

  // --- diversity pruning ---------------------------------------------------
  struct Acc {
    int32_t ident, level, area, seed;
  };
  std::vector<Acc> accepted;
  for (const Cand& c : cands) {
    bool ok = true;
    for (const Acc& j : accepted) {
      const bool nested =
          (c.level <= j.level && chase(idents, c.ident, j.level) == j.ident) ||
          (j.level <= c.level && chase(idents, j.ident, c.level) == c.ident);
      if (nested) {
        const double rel = std::abs((double)c.area - (double)j.area) /
                           (double)std::max(c.area, j.area);
        if (rel < min_diversity) {
          ok = false;
          break;
        }
      }
    }
    if (ok) accepted.push_back(Acc{c.ident, c.level, c.area, c.seed});
  }
  std::sort(accepted.begin(), accepted.end(), [](const Acc& a, const Acc& b) {
    if (a.seed != b.seed) return a.seed < b.seed;
    return a.level < b.level;
  });
  for (long i = 0; i < (long)accepted.size() && i < cap; ++i) {
    out[3 * i] = accepted[i].seed;
    out[3 * i + 1] = accepted[i].level;
    out[3 * i + 2] = accepted[i].area;
  }
  return (long)accepted.size();
}

}  // extern "C"
