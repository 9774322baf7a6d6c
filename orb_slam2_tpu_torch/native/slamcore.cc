// Native host runtime for orb_slam2_tpu_torch: the port's own copy of
// orb_slam2_tpu/native/slamcore.cc, unchanged below this header.
//
// The reference's runtime around the compute kernels is C++ (the map
// graph, the DBoW2 inverted-file database, popcount Hamming loops —
// src/KeyFrameDatabase.cc, src/MapPoint.cc, Thirdparty/DBoW2).  The
// TPU build keeps device compute in XLA but re-implements the hot
// host-side structures natively here, exposed through a plain C ABI
// consumed via ctypes (no pybind11 in this image).
//
// Components:
//  - kfdb_*   : BoW inverted file with shared-word counting and L1
//               scoring (replaces src/KeyFrameDatabase.cc:105-396 inner
//               loops).
//  - hamming_*: 256-bit popcount distance matrix + best-descriptor
//               selection (replaces src/ORBmatcher.cc:1991-2011 and
//               MapPoint::ComputeDistinctiveDescriptors,
//               src/MapPoint.cc:386-470).
//  - covis_*  : shared-observation counting for
//               KeyFrame::UpdateConnections (src/KeyFrame.cc:396-520).
//
// Build: orb_slam2_tpu_torch/native/__init__.py (g++ -O3 -shared -fPIC)
// at first use.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------
// Hamming kernels
// ---------------------------------------------------------------------

// (na x 8) x (nb x 8) packed uint32 descriptors -> (na x nb) int32.
void hamming_matrix_u32(const uint32_t* a, int64_t na,
                        const uint32_t* b, int64_t nb, int32_t* out) {
  for (int64_t i = 0; i < na; ++i) {
    const uint32_t* ai = a + i * 8;
    for (int64_t j = 0; j < nb; ++j) {
      const uint32_t* bj = b + j * 8;
      int32_t d = 0;
      for (int k = 0; k < 8; ++k)
        d += __builtin_popcount(ai[k] ^ bj[k]);
      out[i * nb + j] = d;
    }
  }
}

// Representative descriptor: index with minimum median distance to the
// rest (MapPoint::ComputeDistinctiveDescriptors semantics).
int32_t hamming_min_median_index(const uint32_t* descs, int64_t n) {
  if (n <= 0) return -1;
  if (n == 1) return 0;
  std::vector<int32_t> row(n);
  int32_t best = 0;
  double best_med = 1e18;
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t* di = descs + i * 8;
    for (int64_t j = 0; j < n; ++j) {
      const uint32_t* dj = descs + j * 8;
      int32_t d = 0;
      for (int k = 0; k < 8; ++k)
        d += __builtin_popcount(di[k] ^ dj[k]);
      row[j] = d;
    }
    std::nth_element(row.begin(), row.begin() + n / 2, row.end());
    double med = row[n / 2];
    if (med < best_med) { best_med = med; best = (int32_t)i; }
  }
  return best;
}

// Batched medoid selection: descriptors of MANY map points concatenated
// (CSR offsets); writes the chosen index (relative to each group) per
// point.  One ctypes call replaces an O(points) Python loop.
void hamming_min_median_batch(const uint32_t* descs, const int64_t* offsets,
                              int64_t n_groups, int32_t* out_idx) {
  std::vector<int32_t> row;
  for (int64_t g = 0; g < n_groups; ++g) {
    const int64_t a = offsets[g], b = offsets[g + 1];
    const int64_t n = b - a;
    if (n <= 0) { out_idx[g] = -1; continue; }
    if (n == 1) { out_idx[g] = 0; continue; }
    row.resize(n);
    int32_t best = 0;
    double best_med = 1e18;
    for (int64_t i = 0; i < n; ++i) {
      const uint32_t* di = descs + (a + i) * 8;
      for (int64_t j = 0; j < n; ++j) {
        const uint32_t* dj = descs + (a + j) * 8;
        int32_t d = 0;
        for (int k = 0; k < 8; ++k)
          d += __builtin_popcount(di[k] ^ dj[k]);
        row[j] = d;
      }
      std::nth_element(row.begin(), row.begin() + n / 2, row.end());
      double med = row[n / 2];
      if (med < best_med) { best_med = med; best = (int32_t)i; }
    }
    out_idx[g] = best;
  }
}

// ---------------------------------------------------------------------
// BoW inverted-file keyframe database
// ---------------------------------------------------------------------

struct KfEntry {
  std::vector<int64_t> words;    // sorted unique word ids
  std::vector<float> weights;    // tf-idf weight per word (L1-normalized)
};

struct KfDatabase {
  // word -> list of (kid, weight)
  std::unordered_map<int64_t, std::vector<std::pair<int32_t, float>>> inverted;
  std::unordered_map<int32_t, KfEntry> entries;
};

void* kfdb_create() { return new KfDatabase(); }
void kfdb_destroy(void* h) { delete (KfDatabase*)h; }

void kfdb_add(void* h, int32_t kid, const int64_t* words,
              const float* weights, int64_t n) {
  auto* db = (KfDatabase*)h;
  KfEntry e;
  e.words.assign(words, words + n);
  e.weights.assign(weights, weights + n);
  for (int64_t i = 0; i < n; ++i)
    db->inverted[words[i]].emplace_back(kid, weights[i]);
  db->entries[kid] = std::move(e);
}

void kfdb_erase(void* h, int32_t kid) {
  auto* db = (KfDatabase*)h;
  auto it = db->entries.find(kid);
  if (it == db->entries.end()) return;
  for (int64_t w : it->second.words) {
    auto lit = db->inverted.find(w);
    if (lit == db->inverted.end()) continue;
    auto& lst = lit->second;
    lst.erase(std::remove_if(lst.begin(), lst.end(),
                             [kid](const std::pair<int32_t, float>& p) {
                               return p.first == kid;
                             }),
              lst.end());
  }
  db->entries.erase(it);
}

int64_t kfdb_size(void* h) { return (int64_t)((KfDatabase*)h)->entries.size(); }

// Query: accumulate shared-word counts and L1 scores
//   L1 score contribution per shared word: |a| + |b| - |a - b|
//   (DBoW2 L1Scoring; final score = 0.5 * sum).
// exclude: optional sorted kid list to skip (covisible set for loop
// detection, empty for relocalization).
// Returns the number of candidates written (capped at max_out), each as
// (kid, shared_count, l1_score).
int64_t kfdb_query(void* h, const int64_t* words, const float* weights,
                   int64_t n, const int32_t* exclude, int64_t n_exclude,
                   int64_t min_common, int32_t* out_kids,
                   int32_t* out_counts, float* out_scores,
                   int64_t max_out) {
  auto* db = (KfDatabase*)h;
  std::unordered_map<int32_t, std::pair<int32_t, float>> acc;
  acc.reserve(256);
  for (int64_t i = 0; i < n; ++i) {
    auto lit = db->inverted.find(words[i]);
    if (lit == db->inverted.end()) continue;
    const float a = weights[i];
    for (const auto& [kid, b] : lit->second) {
      auto& slot = acc[kid];
      slot.first += 1;
      float fa = a < 0 ? -a : a;
      float fb = b < 0 ? -b : b;
      float fd = a - b; if (fd < 0) fd = -fd;
      slot.second += fa + fb - fd;
    }
  }
  // collect survivors, then keep the top-max_out by shared-word count
  // (hash iteration order must not decide which candidates are dropped)
  std::vector<std::tuple<int32_t, int32_t, float>> hits;  // (count, kid, score)
  hits.reserve(acc.size());
  for (const auto& [kid, cs] : acc) {
    if (cs.first < min_common) continue;
    if (n_exclude > 0 &&
        std::binary_search(exclude, exclude + n_exclude, kid))
      continue;
    hits.emplace_back(cs.first, kid, 0.5f * cs.second);
  }
  if ((int64_t)hits.size() > max_out) {
    std::partial_sort(hits.begin(), hits.begin() + max_out, hits.end(),
                      [](const auto& x, const auto& y) {
                        return std::get<0>(x) > std::get<0>(y);
                      });
    hits.resize(max_out);
  }
  int64_t m = 0;
  for (const auto& [count, kid, score] : hits) {
    out_kids[m] = kid;
    out_counts[m] = count;
    out_scores[m] = score;
    ++m;
  }
  return m;
}

// ---------------------------------------------------------------------
// Covisibility counting
// ---------------------------------------------------------------------

// For one keyframe: given for each of its bound map points the list of
// other observing keyframes (CSR: obs_kids / obs_offsets over n_pts
// points), count shared observations per neighbor keyframe and return
// neighbors with count >= threshold (always keeping the single best).
// Returns number written.
int64_t covis_count(const int32_t* obs_kids, const int64_t* obs_offsets,
                    int64_t n_pts, int32_t self_kid, int64_t threshold,
                    int32_t* out_kids, int32_t* out_weights,
                    int64_t max_out) {
  std::unordered_map<int32_t, int32_t> counter;
  counter.reserve(128);
  for (int64_t p = 0; p < n_pts; ++p) {
    for (int64_t k = obs_offsets[p]; k < obs_offsets[p + 1]; ++k) {
      int32_t kid = obs_kids[k];
      if (kid != self_kid) counter[kid] += 1;
    }
  }
  if (counter.empty()) return 0;
  int32_t best_kid = -1, best_w = -1;
  for (const auto& [kid, w] : counter)
    if (w > best_w || (w == best_w && kid < best_kid)) {
      best_w = w; best_kid = kid;
    }
  int64_t m = 0;
  for (const auto& [kid, w] : counter) {
    if (w >= threshold && m < max_out) {
      out_kids[m] = kid; out_weights[m] = w; ++m;
    }
  }
  if (m == 0 && max_out > 0) {
    out_kids[0] = best_kid; out_weights[0] = best_w; m = 1;
  }
  return m;
}

}  // extern "C"
