// Native runtime core: fast agglomerative linkage + WAV parsing.
//
// The PyTorch port's own copy of the host library of the JAX package
// (runtime/native/sdtpu_native.cc there; the code is the same, only these
// comments differ), the counterpart of the reference's C++ runtime layer
// (reference pipeline/src/clustering/clustering.cpp:28-468 — indexed
// min-heap fast_linkage — and pipeline/src/frontend/wav.h). The card does
// all NN compute; this library accelerates the two host-side hot spots:
//
//   * centroid-linkage AHC over (N, d) embeddings: the same
//     distance-matrix + Lance-Williams fast_linkage recurrence scipy runs,
//     with directional nearest-neighbor candidates and OpenMP-parallel
//     pdist/update loops, with scipy's merge order exactly. Its time
//     against scipy's on the card's host is in PERF.md.
//   * RIFF/WAV parsing straight into float32 (8/16/32-bit PCM).
//
// C ABI only; Python binds via ctypes (runtime/native_bindings.py builds
// it with g++ at first use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// linkage
// ---------------------------------------------------------------------------

static inline double sq_dist(const double* a, const double* b, int d) {
  double s = 0.0;
  for (int k = 0; k < d; ++k) {
    const double diff = a[k] - b[k];
    s += diff * diff;
  }
  return s;
}

// Centroid-linkage over Euclidean distances, global-minimum merge order.
// X: (n, d) row-major. Z out: (n-1, 4) rows [id_a, id_b, dist, size] with
// scipy id numbering (new cluster i gets id n+i).
//
// Primary path (n <= SDTPU_DMAT_MAX): full distance matrix +
// Lance-Williams centroid updates — the same O(1)-per-lookup recurrence
// scipy's fast_linkage runs, with the O(n^2 d) pdist and the O(n) per-merge
// update loops OpenMP-parallel.
// Fallback path (very large n): centroid-recompute with lazy candidates —
// O(n) memory instead of O(n^2).

static const long long SDTPU_DMAT_MAX = 27000;  // ~5.8 GB square f64

static int linkage_centroid_dmat(const double* X, int n, int d, double* Z) {
  // FULL symmetric matrix: every lookup and every rescan is a contiguous
  // row read (the condensed layout forces stride-n column walks — the
  // dominant cache cost); only the mirror writes are scattered stores.
  std::vector<double> D((size_t)n * n, 0.0);
#pragma omp parallel for schedule(dynamic, 8)
  for (int i = 0; i < n - 1; ++i) {
    const double* xi = X + (size_t)i * d;
    double* row = &D[(size_t)i * n];
    for (int j = i + 1; j < n; ++j) {
      const double v = std::sqrt(sq_dist(xi, X + (size_t)j * d, d));
      row[j] = v;
      D[(size_t)j * n + i] = v;
    }
  }

  std::vector<double> size(n, 1.0);
  std::vector<int> scipy_id(n);
  std::vector<char> active(n, 1);
  for (int i = 0; i < n; ++i) scipy_id[i] = i;
  // DIRECTIONAL candidates (scipy fast_linkage's invariant): nbr[i] is the
  // nearest ACTIVE cluster with index > i, so every pair is tracked exactly
  // once and a rescan walks the CONTIGUOUS condensed row D[i, i+1..) —
  // column walks (stride ~n) were the previous version's cache killer.
  std::vector<int> nbr(n, -1);
  std::vector<double> nbr_d(n, std::numeric_limits<double>::infinity());

  auto recompute_nbr = [&](int i) {
    double best = std::numeric_limits<double>::infinity();
    int best_j = -1;
    const double* row = &D[(size_t)i * n];
    for (int j = i + 1; j < n; ++j) {
      if (!active[j]) continue;
      const double dist = row[j];
      if (dist < best) {
        best = dist;
        best_j = j;
      }
    }
    nbr[i] = best_j;
    nbr_d[i] = best;
  };

  using HeapItem = std::pair<double, int>;
  std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<HeapItem>> heap;
#pragma omp parallel for schedule(dynamic, 32)
  for (int i = 0; i < n - 1; ++i) recompute_nbr(i);
  for (int i = 0; i < n - 1; ++i)
    if (nbr[i] >= 0) heap.push({nbr_d[i], i});

  for (int it = 0; it < n - 1; ++it) {
    int i = -1;
    double dist = 0.0;
    for (;;) {
      if (heap.empty()) {  // defensive: rebuild every candidate
        for (int k = 0; k < n - 1; ++k)
          if (active[k]) {
            recompute_nbr(k);
            if (nbr[k] >= 0) heap.push({nbr_d[k], k});
          }
      }
      auto [hd, slot] = heap.top();
      heap.pop();
      if (!active[slot]) continue;
      if (nbr[slot] < 0 || !active[nbr[slot]] ||
          D[(size_t)slot * n + nbr[slot]] != hd) {
        recompute_nbr(slot);
        if (nbr[slot] >= 0) heap.push({nbr_d[slot], slot});
        continue;
      }
      if (!heap.empty() && heap.top().first < hd) {
        heap.push({hd, slot});
        continue;
      }
      i = slot;
      dist = hd;
      break;
    }
    const int j = nbr[i];  // i < j by the directional invariant
    int ida = scipy_id[i], idb = scipy_id[j];
    if (ida > idb) std::swap(ida, idb);
    const double ni = size[i], nj = size[j];
    Z[4 * it + 0] = ida;
    Z[4 * it + 1] = idb;
    Z[4 * it + 2] = dist;
    Z[4 * it + 3] = ni + nj;

    // merge into the LARGER index j (scipy's relabeling): pairs (k, j)
    // keep their direction for every surviving k, and dead slot i only
    // invalidates candidates that pointed AT it (caught on pop)
    size[j] = ni + nj;
    scipy_id[j] = n + it;
    active[i] = 0;

    // Lance-Williams centroid update of the pairs (k, j), plus eager
    // candidate improvements and j's own right-side nearest neighbor
    const double s = ni + nj;
    const double dij2 = dist * dist;
    double best = std::numeric_limits<double>::infinity();
    int best_k = -1;
    std::vector<HeapItem> pushes;
#pragma omp parallel
    {
      double lbest = std::numeric_limits<double>::infinity();
      int lbest_k = -1;
      std::vector<HeapItem> lpush;
      const double* row_i = &D[(size_t)i * n];
      double* row_j = &D[(size_t)j * n];
#pragma omp for nowait schedule(static)
      for (int k = 0; k < n; ++k) {
        if (!active[k] || k == j) continue;
        const double dki = row_i[k];
        const double dkj = row_j[k];
        const double dk = std::sqrt((ni * dki * dki + nj * dkj * dkj) / s -
                                    (ni * nj * dij2) / (s * s));
        row_j[k] = dk;
        D[(size_t)k * n + j] = dk;  // mirror (scattered store)
        if (k < j) {
          if (dk < nbr_d[k]) {
            nbr_d[k] = dk;
            nbr[k] = j;
            lpush.push_back({dk, k});
          }
        } else if (dk < lbest) {
          lbest = dk;
          lbest_k = k;
        }
      }
#pragma omp critical
      {
        if (lbest < best) {
          best = lbest;
          best_k = lbest_k;
        }
        pushes.insert(pushes.end(), lpush.begin(), lpush.end());
      }
    }
    for (const auto& p : pushes) heap.push(p);
    nbr[j] = best_k;
    nbr_d[j] = best;
    if (best_k >= 0) heap.push({best, j});
  }
  return 0;
}

int sdtpu_linkage_centroid(const double* X, int n, int d, double* Z) {
  if (n >= 2 && n <= SDTPU_DMAT_MAX) return linkage_centroid_dmat(X, n, d, Z);
  if (n < 2) return 0;
  std::vector<double> centroids(X, X + (size_t)n * d);
  std::vector<double> size(n, 1.0);
  std::vector<int> scipy_id(n);
  std::vector<char> active(n, 1);
  for (int i = 0; i < n; ++i) scipy_id[i] = i;

  // per-slot nearest-neighbor candidate
  std::vector<int> nbr(n, -1);
  std::vector<double> nbr_d(n, std::numeric_limits<double>::infinity());

  auto recompute_nbr = [&](int i) {
    double best = std::numeric_limits<double>::infinity();
    int best_j = -1;
    const double* ci = &centroids[(size_t)i * d];
#pragma omp parallel if ((size_t)n * d >= 1u << 21)
    {
      double lbest = std::numeric_limits<double>::infinity();
      int lbest_j = -1;
#pragma omp for nowait
      for (int j = 0; j < n; ++j) {
        if (!active[j] || j == i) continue;
        const double dist = sq_dist(ci, &centroids[(size_t)j * d], d);
        if (dist < lbest) {
          lbest = dist;
          lbest_j = j;
        }
      }
#pragma omp critical
      {
        if (lbest < best) {
          best = lbest;
          best_j = lbest_j;
        }
      }
    }
    nbr[i] = best_j;
    nbr_d[i] = best;
  };

  using HeapItem = std::pair<double, int>;  // (sq dist, slot)
  std::priority_queue<HeapItem, std::vector<HeapItem>, std::greater<HeapItem>> heap;

#pragma omp parallel for schedule(dynamic, 16)
  for (int i = 0; i < n; ++i) recompute_nbr(i);
  // note: recompute_nbr has its own omp region; nested parallelism is
  // disabled by default so the inner region runs serially per thread — fine.
  for (int i = 0; i < n; ++i) heap.push({nbr_d[i], i});

  for (int it = 0; it < n - 1; ++it) {
    int i = -1;
    // pop until a valid, up-to-date candidate surfaces
    for (;;) {
      if (heap.empty()) {  // defensive: rebuild
        for (int k = 0; k < n; ++k)
          if (active[k]) {
            recompute_nbr(k);
            heap.push({nbr_d[k], k});
          }
      }
      auto [dist, slot] = heap.top();
      heap.pop();
      if (!active[slot]) continue;
      if (nbr[slot] < 0 || !active[nbr[slot]]) {
        recompute_nbr(slot);
        heap.push({nbr_d[slot], slot});
        continue;
      }
      // revalidate: if the candidate's centroid moved since this entry was
      // pushed, the cached pair distance is stale AND the true nearest may
      // be a different cluster — recompute the full nearest neighbor
      // (scipy fast_linkage's lazy-recompute invariant)
      const double cur =
          sq_dist(&centroids[(size_t)slot * d], &centroids[(size_t)nbr[slot] * d], d);
      if (cur > dist * (1.0 + 1e-12) || cur < dist * (1.0 - 1e-12)) {
        recompute_nbr(slot);
        heap.push({nbr_d[slot], slot});
        continue;
      }
      if (!heap.empty() && heap.top().first < dist) {
        heap.push({dist, slot});
        continue;
      }
      i = slot;
      break;
    }
    const int j = nbr[i];
    const double dist = std::sqrt(nbr_d[i]);

    int ida = scipy_id[i], idb = scipy_id[j];
    if (ida > idb) std::swap(ida, idb);
    const double ni = size[i], nj = size[j];
    Z[4 * it + 0] = ida;
    Z[4 * it + 1] = idb;
    Z[4 * it + 2] = dist;
    Z[4 * it + 3] = ni + nj;

    // merge into slot i
    double* ci = &centroids[(size_t)i * d];
    const double* cj = &centroids[(size_t)j * d];
    for (int k = 0; k < d; ++k) ci[k] = (ni * ci[k] + nj * cj[k]) / (ni + nj);
    size[i] = ni + nj;
    scipy_id[i] = n + it;
    active[j] = 0;

    // the new centroid may be closer to some clusters than their cached
    // candidate; also compute the new cluster's own nearest neighbor
    double best = std::numeric_limits<double>::infinity();
    int best_j = -1;
#pragma omp parallel if ((size_t)n * d >= 1u << 21)
    {
      double lbest = std::numeric_limits<double>::infinity();
      int lbest_j = -1;
#pragma omp for nowait
      for (int k = 0; k < n; ++k) {
        if (!active[k] || k == i) continue;
        const double dk = sq_dist(ci, &centroids[(size_t)k * d], d);
        if (dk < nbr_d[k]) {
          nbr_d[k] = dk;
          nbr[k] = i;
#pragma omp critical
          heap.push({dk, k});
        }
        if (dk < lbest) {
          lbest = dk;
          lbest_j = k;
        }
      }
#pragma omp critical
      {
        if (lbest < best) {
          best = lbest;
          best_j = lbest_j;
        }
      }
    }
    nbr[i] = best_j;
    nbr_d[i] = best;
    if (best_j >= 0) heap.push({best, i});
  }
  return 0;
}

// ---------------------------------------------------------------------------
// WAV
// ---------------------------------------------------------------------------

// Parses header; returns 0 on success. Caller then calls sdtpu_read_wav_data
// with a buffer of num_channels*num_samples floats.
int sdtpu_read_wav_info(const char* path, int* num_channels, int* sample_rate,
                        int* bits_per_sample, long long* num_samples) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char id[4];
  uint32_t sz;
  if (std::fread(id, 1, 4, f) != 4 || std::memcmp(id, "RIFF", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  std::fread(&sz, 4, 1, f);
  std::fread(id, 1, 4, f);
  if (std::memcmp(id, "WAVE", 4) != 0) {
    std::fclose(f);
    return -2;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  long long data_size = -1;
  while (std::fread(id, 1, 4, f) == 4) {
    uint32_t chunk;
    if (std::fread(&chunk, 4, 1, f) != 1) break;
    if (std::memcmp(id, "fmt ", 4) == 0) {
      uint32_t tmp32;
      uint16_t tmp16;
      std::fread(&fmt, 2, 1, f);
      std::fread(&channels, 2, 1, f);
      std::fread(&rate, 4, 1, f);
      std::fread(&tmp32, 4, 1, f);
      std::fread(&tmp16, 2, 1, f);
      std::fread(&bits, 2, 1, f);
      if (chunk > 16) std::fseek(f, chunk - 16, SEEK_CUR);
    } else if (std::memcmp(id, "data", 4) == 0) {
      data_size = chunk;
      break;
    } else {
      std::fseek(f, chunk + (chunk & 1), SEEK_CUR);
    }
  }
  std::fclose(f);
  if (data_size < 0 || channels == 0 || bits == 0) return -3;
  *num_channels = channels;
  *sample_rate = (int)rate;
  *bits_per_sample = bits;
  *num_samples = data_size / (channels * bits / 8);
  return 0;
}

int sdtpu_read_wav_data(const char* path, float* out, long long capacity) {
  int channels, rate, bits;
  long long frames;
  if (sdtpu_read_wav_info(path, &channels, &rate, &bits, &frames) != 0) return -1;
  const long long total = frames * channels;
  if (total > capacity) return -4;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  // re-scan to the data chunk
  char id[4];
  uint32_t sz;
  std::fseek(f, 12, SEEK_SET);
  while (std::fread(id, 1, 4, f) == 4 && std::fread(&sz, 4, 1, f) == 1) {
    if (std::memcmp(id, "data", 4) == 0) break;
    std::fseek(f, sz + (sz & 1), SEEK_CUR);
  }
  std::vector<char> raw((size_t)total * bits / 8);
  const size_t got = std::fread(raw.data(), 1, raw.size(), f);
  std::fclose(f);
  if (got != raw.size()) return -5;
  if (bits == 16) {
    const int16_t* p = (const int16_t*)raw.data();
    for (long long i = 0; i < total; ++i) out[i] = (float)p[i];
  } else if (bits == 32) {
    const int32_t* p = (const int32_t*)raw.data();
    for (long long i = 0; i < total; ++i) out[i] = (float)p[i];
  } else if (bits == 8) {
    const uint8_t* p = (const uint8_t*)raw.data();
    for (long long i = 0; i < total; ++i) out[i] = (float)p[i] - 128.0f;
  } else {
    return -6;
  }
  return 0;
}

}  // extern "C"
