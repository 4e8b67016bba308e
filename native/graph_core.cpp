// Native sparse network scoring for the boundary sweep.
//
// Replaces the reference's growNetwork + graph-tool recomputation
// (PopPUNK/refine.py:375-474, network.py:1204-1307) with edge-list
// algorithms that never materialise an [n, n] matrix and have no
// per-offset quadratic term:
//
//   * per-offset edge/wedge/component stats: one incremental pass over
//     edges sorted by activation offset (union-find + running degrees);
//   * triangles: ONE compact-forward (degree-ordered orientation)
//     enumeration of the final graph, recording each triangle's
//     activation offset max(t_uv, t_uw, t_vw) into a histogram whose
//     cumulative sum is triangles-at-offset — O(E^1.5) total for the
//     whole sweep instead of O(offsets * n^2) dense matmuls;
//   * betweenness (score_idx 1/2): Brandes from sampled sources per
//     component, OpenMP-parallel over sources, with edges filtered by
//     activation offset and per-component result caching across offsets
//     (a component is re-scored only if the sweep touched it).
//
// The dense device sweep (poppunk_tpu/ops/device_sweep.py) stays the
// fast path for score_idx 0 up to the memory plan's cap; this file is the any-n,
// any-score host engine. Python twin: poppunk_tpu/network/incremental.py.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC -o libgraph_core.so graph_core.cpp
// Called from poppunk_tpu/network/{incremental,summary}.py via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#include <parallel/algorithm>
#endif

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  std::vector<int64_t> size;
  int64_t n_components;

  explicit UnionFind(int32_t n) : parent(n), size(n, 1), n_components(n) {
    for (int32_t i = 0; i < n; ++i) parent[i] = i;
  }

  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }

  // Returns the surviving root (or the common root if already joined).
  int32_t unite(int32_t u, int32_t v) {
    int32_t ru = find(u), rv = find(v);
    if (ru == rv) return ru;
    if (size[ru] < size[rv]) std::swap(ru, rv);
    parent[rv] = ru;
    size[ru] += size[rv];
    --n_components;
    return ru;
  }
};

struct Edge {
  int32_t u, v, t;
};

// Deduplicated edges sorted by activation offset; duplicates keep the
// earliest offset (the incremental adjacency-set semantics).
std::vector<Edge> prepare_edges(const int32_t *i_vec, const int32_t *j_vec,
                                const int32_t *t_vec, int64_t n_in,
                                int32_t n_offsets) {
  std::vector<Edge> edges;
  edges.reserve(n_in);
  for (int64_t e = 0; e < n_in; ++e) {
    int32_t u = i_vec[e], v = j_vec[e];
    if (u == v) continue;
    if (u > v) std::swap(u, v);
    int32_t t = t_vec[e];
    if (t < 0) t = 0;
    // t >= n_offsets means "never active in this sweep": DROP, matching
    // the Python twin (grow_network_scores counts idx <= off only).
    // Also the n_offsets <= 0 guard: everything drops, no hist[-1].
    if (t >= n_offsets) continue;
    edges.push_back({u, v, t});
  }
  auto by_pair = [](const Edge &a, const Edge &b) {
    if (a.u != b.u) return a.u < b.u;
    if (a.v != b.v) return a.v < b.v;
    return a.t < b.t;
  };
#ifdef _OPENMP
  __gnu_parallel::sort(edges.begin(), edges.end(), by_pair);
#else
  std::sort(edges.begin(), edges.end(), by_pair);
#endif
  std::vector<Edge> uniq;
  uniq.reserve(edges.size());
  for (const Edge &e : edges) {
    if (!uniq.empty() && uniq.back().u == e.u && uniq.back().v == e.v) continue;
    uniq.push_back(e);
  }
  auto by_t = [](const Edge &a, const Edge &b) { return a.t < b.t; };
#ifdef _OPENMP
  __gnu_parallel::stable_sort(uniq.begin(), uniq.end(), by_t);
#else
  std::stable_sort(uniq.begin(), uniq.end(), by_t);
#endif
  return uniq;
}

// CSR with per-edge activation offsets (symmetric).
struct TimedCSR {
  std::vector<int64_t> indptr;
  std::vector<int32_t> indices;
  std::vector<int32_t> times;

  TimedCSR(int32_t n, const std::vector<Edge> &edges) {
    std::vector<int64_t> deg(n + 1, 0);
    for (const Edge &e : edges) {
      ++deg[e.u + 1];
      ++deg[e.v + 1];
    }
    indptr.assign(n + 1, 0);
    for (int32_t v = 0; v < n; ++v) indptr[v + 1] = indptr[v] + deg[v + 1];
    indices.resize(indptr[n]);
    times.resize(indptr[n]);
    std::vector<int64_t> cursor(indptr.begin(), indptr.end() - 1);
    for (const Edge &e : edges) {
      indices[cursor[e.u]] = e.v;
      times[cursor[e.u]++] = e.t;
      indices[cursor[e.v]] = e.u;
      times[cursor[e.v]++] = e.t;
    }
    // adjacency sorted by activation offset: BFS/dependency loops can
    // BREAK at the first inactive edge instead of scanning whole lists
    // (the idx 1/2 sweeps re-walk the CSR per offset; early offsets
    // touch a fraction of the edges)
    std::vector<std::pair<int32_t, int32_t>> scratch;
    for (int32_t v = 0; v < n; ++v) {
      int64_t lo = indptr[v], hi = indptr[v + 1];
      scratch.clear();
      for (int64_t k = lo; k < hi; ++k)
        scratch.emplace_back(times[k], indices[k]);
      std::sort(scratch.begin(), scratch.end());
      for (int64_t k = lo; k < hi; ++k) {
        times[k] = scratch[k - lo].first;
        indices[k] = scratch[k - lo].second;
      }
    }
  }
};

// Triangle activation histogram via compact-forward enumeration: orient
// every edge from the lower-(degree, id) endpoint, sort out-lists, and
// intersect the out-lists of each edge's endpoints. Each triangle is
// found exactly once; its activation offset is the max of its three edge
// offsets. O(sum over edges of min(outdeg)) <= O(E^1.5).
std::vector<double> triangle_histogram(int32_t n, const std::vector<Edge> &edges,
                                       int32_t n_offsets) {
  std::vector<int64_t> deg(n, 0);
  for (const Edge &e : edges) {
    ++deg[e.u];
    ++deg[e.v];
  }
  auto rank_less = [&deg](int32_t a, int32_t b) {
    return deg[a] != deg[b] ? deg[a] < deg[b] : a < b;
  };
  // oriented out-adjacency (lower rank -> higher rank)
  std::vector<int64_t> outptr(n + 1, 0);
  for (const Edge &e : edges) {
    int32_t lo = rank_less(e.u, e.v) ? e.u : e.v;
    ++outptr[lo + 1];
  }
  for (int32_t v = 0; v < n; ++v) outptr[v + 1] += outptr[v];
  std::vector<int32_t> outidx(outptr[n]);
  std::vector<int32_t> outt(outptr[n]);
  {
    std::vector<int64_t> cursor(outptr.begin(), outptr.end() - 1);
    for (const Edge &e : edges) {
      int32_t lo = rank_less(e.u, e.v) ? e.u : e.v;
      int32_t hi = lo == e.u ? e.v : e.u;
      outidx[cursor[lo]] = hi;
      outt[cursor[lo]++] = e.t;
    }
  }
  // sort each out-list by neighbour id (keeping offsets aligned)
  std::vector<int64_t> perm;
  for (int32_t v = 0; v < n; ++v) {
    int64_t b = outptr[v], e = outptr[v + 1];
    if (e - b <= 1) continue;
    perm.resize(e - b);
    for (int64_t k = 0; k < e - b; ++k) perm[k] = k;
    std::sort(perm.begin(), perm.end(), [&](int64_t a, int64_t c) {
      return outidx[b + a] < outidx[b + c];
    });
    std::vector<int32_t> tmpi(e - b), tmpt(e - b);
    for (int64_t k = 0; k < e - b; ++k) {
      tmpi[k] = outidx[b + perm[k]];
      tmpt[k] = outt[b + perm[k]];
    }
    std::copy(tmpi.begin(), tmpi.end(), outidx.begin() + b);
    std::copy(tmpt.begin(), tmpt.end(), outt.begin() + b);
  }

  // OpenMP over source vertices, one histogram per thread: at 40M edges
  // with ~640-member strain cliques the enumeration walks ~1e10 merge
  // steps / 4.5e9 triangles — single-threaded it was ~150 s of the
  // measured 183 s grow_network_scores call at the 65k tier. dynamic
  // schedule: clique vertices carry most of the work.
#ifdef _OPENMP
  int n_threads = omp_get_max_threads();
#else
  int n_threads = 1;
#endif
  std::vector<std::vector<double>> hist_tls(
      n_threads, std::vector<double>(n_offsets, 0.0));
#pragma omp parallel for schedule(dynamic, 256)
  for (int32_t u = 0; u < n; ++u) {
#ifdef _OPENMP
    std::vector<double> &hist = hist_tls[omp_get_thread_num()];
#else
    std::vector<double> &hist = hist_tls[0];
#endif
    for (int64_t k = outptr[u]; k < outptr[u + 1]; ++k) {
      int32_t v = outidx[k];
      int32_t t_uv = outt[k];
      // intersect out(u) and out(v)
      int64_t a = outptr[u], ae = outptr[u + 1];
      int64_t b = outptr[v], be = outptr[v + 1];
      while (a < ae && b < be) {
        int32_t wa = outidx[a], wb = outidx[b];
        if (wa < wb) {
          ++a;
        } else if (wb < wa) {
          ++b;
        } else {
          int32_t t = std::max(t_uv, std::max(outt[a], outt[b]));
          hist[t] += 1.0;
          ++a;
          ++b;
        }
      }
    }
  }
  std::vector<double> hist(n_offsets, 0.0);
  for (int th = 0; th < n_threads; ++th)
    for (int32_t t = 0; t < n_offsets; ++t) hist[t] += hist_tls[th][t];
  return hist;
}

// Brandes betweenness from the given sources over a TimedCSR, visiting
// only edges with activation offset <= t_max. Accumulates the undirected
// double-counted dependency into bc_out. OpenMP-parallel over sources.
void brandes_sources(const TimedCSR &csr, int32_t n, int32_t t_max,
                     const int32_t *sources, int64_t n_sources,
                     double *bc_out) {
#ifdef _OPENMP
  int n_threads = omp_get_max_threads();
#else
  int n_threads = 1;
#endif
  std::vector<std::vector<double>> bc_tls(n_threads,
                                          std::vector<double>(n, 0.0));
  // per-thread scratch reused across sources; only entries touched by a
  // source's BFS (its stack) are reset afterwards, so per-source cost is
  // O(component visited), not O(n) allocation + memset
  std::vector<std::vector<int32_t>> dist_tls(n_threads,
                                             std::vector<int32_t>(n, -1));
  std::vector<std::vector<double>> sigma_tls(n_threads,
                                             std::vector<double>(n, 0.0));
  std::vector<std::vector<double>> delta_tls(n_threads,
                                             std::vector<double>(n, 0.0));
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int64_t si = 0; si < n_sources; ++si) {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    double *bc = bc_tls[tid].data();
    int32_t *dist = dist_tls[tid].data();
    double *sigma = sigma_tls[tid].data();
    double *delta = delta_tls[tid].data();
    int32_t s = sources[si];
    std::vector<int32_t> stack;
    stack.reserve(64);
    dist[s] = 0;
    sigma[s] = 1.0;
    stack.push_back(s);
    size_t head = 0;
    while (head < stack.size()) {
      int32_t v = stack[head++];
      for (int64_t k = csr.indptr[v]; k < csr.indptr[v + 1]; ++k) {
        if (csr.times[k] > t_max) break;  // adjacency sorted by t
        int32_t w = csr.indices[k];
        if (dist[w] < 0) {
          dist[w] = dist[v] + 1;
          stack.push_back(w);
        }
        if (dist[w] == dist[v] + 1) sigma[w] += sigma[v];
      }
    }
    for (size_t p = stack.size(); p-- > 1;) {
      int32_t w = stack[p];
      double coeff = (1.0 + delta[w]) / sigma[w];
      for (int64_t k = csr.indptr[w]; k < csr.indptr[w + 1]; ++k) {
        if (csr.times[k] > t_max) break;  // adjacency sorted by t
        int32_t v = csr.indices[k];
        if (dist[v] == dist[w] - 1) delta[v] += sigma[v] * coeff;
      }
      bc[w] += delta[w];
    }
    for (int32_t v : stack) {
      dist[v] = -1;
      sigma[v] = 0.0;
      delta[v] = 0.0;
    }
  }
  for (int t = 0; t < n_threads; ++t)
    for (int32_t v = 0; v < n; ++v) bc_out[v] += bc_tls[t][v];
}

}  // namespace

extern "C" {

// Full sweep scorer. Edges (i, j) with first-active offsets (any order,
// duplicates fine); emits -(score) per offset for the given score_idx
// (0: t(1-d); 1: t(1-d)(1-mean max betweenness); 2: size-weighted).
// Components larger than betweenness_sample are scored from a sampled
// source subset (mt19937 seeded with `seed`) rescaled by n/sample.
void sweep_scores_v2(const int32_t *i_vec, const int32_t *j_vec,
                     const int32_t *t_vec, int64_t n_edges_in,
                     int32_t n_vertices, int32_t n_offsets,
                     int32_t score_idx, int32_t betweenness_sample,
                     uint64_t seed, double *out_scores) {
  const int32_t n = n_vertices;
  std::vector<Edge> edges =
      prepare_edges(i_vec, j_vec, t_vec, n_edges_in, n_offsets);

  // triangles-at-offset from one pass over the final graph
  std::vector<double> tri_hist = triangle_histogram(n, edges, n_offsets);

  TimedCSR csr(n, edges);
  UnionFind uf(n);
  std::vector<int64_t> vdeg(n, 0);
  // per-component betweenness cache: root -> (offset it was computed at,
  // max normalised bc); invalidated when the sweep touches the component.
  std::vector<int32_t> dirty_at(n, -1);
  std::vector<int32_t> cached_at(n, -2);
  std::vector<double> cached_bt(n, 0.0);
  std::vector<int64_t> cached_size(n, 0);

  const double possible = 0.5 * (double)n * (double)(n - 1);
  double wedges2 = 0.0;  // sum deg*(deg-1)
  double triangles = 0.0;
  int64_t n_edges = 0;
  size_t pos = 0;
  std::mt19937_64 rng(seed);

  for (int32_t t = 0; t < n_offsets; ++t) {
    while (pos < edges.size() && edges[pos].t <= t) {
      const Edge &e = edges[pos];
      wedges2 += 2.0 * (double)(vdeg[e.u] + vdeg[e.v]);
      ++vdeg[e.u];
      ++vdeg[e.v];
      int32_t root = uf.unite(e.u, e.v);
      dirty_at[root] = t;
      ++n_edges;
      ++pos;
    }
    triangles += tri_hist[t];
    double density = n > 1 ? (double)n_edges / possible : 0.0;
    double transitivity = wedges2 > 0 ? 3.0 * triangles / (0.5 * wedges2) : 0.0;
    double base = transitivity * (1.0 - density);
    if (score_idx == 0) {
      out_scores[t] = -base;
      continue;
    }

    // component labels at this offset; bucket vertices by component in
    // one O(n) pass (compact ids over qualifying components, size > 3)
    std::vector<int32_t> root_of(n);
    for (int32_t v = 0; v < n; ++v) root_of[v] = uf.find(v);
    std::vector<int32_t> comp_roots;
    std::vector<int32_t> comp_of_root(n, -1);
    for (int32_t v = 0; v < n; ++v) {
      if (root_of[v] != v || uf.size[v] <= 3) continue;
      comp_of_root[v] = (int32_t)comp_roots.size();
      comp_roots.push_back(v);
    }
    int32_t n_comps = (int32_t)comp_roots.size();
    // contiguous vertex slices per component: comp_start[c]..+size
    std::vector<int64_t> comp_start(n_comps + 1, 0);
    for (int32_t c = 0; c < n_comps; ++c)
      comp_start[c + 1] = comp_start[c] + uf.size[comp_roots[c]];
    std::vector<int32_t> comp_verts(comp_start[n_comps]);
    std::vector<int32_t> local_of(n, -1);  // vertex -> index within slice
    {
      std::vector<int64_t> cursor(comp_start.begin(), comp_start.end() - 1);
      for (int32_t v = 0; v < n; ++v) {
        int32_t c = comp_of_root[root_of[v]];
        if (c < 0) continue;
        local_of[v] = (int32_t)(cursor[c] - comp_start[c]);
        comp_verts[cursor[c]++] = v;
      }
    }
    // dirty components: compact per-component CSR of active edges
    std::vector<int32_t> dirty;
    for (int32_t c = 0; c < n_comps; ++c) {
      int32_t root = comp_roots[c];
      if (cached_at[root] >= dirty_at[root] &&
          cached_size[root] == uf.size[root] && cached_at[root] != -2)
        continue;
      dirty.push_back(c);
    }
    // per-dirty-comp compact CSR (local indices) + source list; tasks =
    // (dirty_idx, source) pairs, OpenMP over tasks with per-thread flat
    // accumulators over the comp_verts layout
    std::vector<std::vector<int64_t>> d_indptr(dirty.size());
    std::vector<std::vector<int32_t>> d_indices(dirty.size());
    std::vector<std::vector<int32_t>> d_sources(dirty.size());
    std::vector<double> d_scale(dirty.size(), 1.0);
    std::vector<std::pair<int32_t, int32_t>> tasks;
    for (size_t di = 0; di < dirty.size(); ++di) {
      int32_t c = dirty[di];
      int64_t b0 = comp_start[c], b1 = comp_start[c + 1];
      int32_t m = (int32_t)(b1 - b0);
      auto &ip = d_indptr[di];
      auto &ix = d_indices[di];
      ip.assign(m + 1, 0);
      for (int64_t k = b0; k < b1; ++k) {
        int32_t v = comp_verts[k];
        int64_t cnt = 0;
        for (int64_t e = csr.indptr[v]; e < csr.indptr[v + 1]; ++e) {
          if (csr.times[e] > t) break;  // adjacency sorted by t
          ++cnt;
        }
        ip[k - b0 + 1] = cnt;
      }
      for (int32_t q = 0; q < m; ++q) ip[q + 1] += ip[q];
      ix.resize(ip[m]);
      {
        std::vector<int64_t> cur(ip.begin(), ip.end() - 1);
        for (int64_t k = b0; k < b1; ++k) {
          int32_t v = comp_verts[k];
          int32_t lv = (int32_t)(k - b0);
          for (int64_t e = csr.indptr[v]; e < csr.indptr[v + 1]; ++e) {
            if (csr.times[e] > t) break;  // adjacency sorted by t
            ix[cur[lv]++] = local_of[csr.indices[e]];
          }
        }
      }
      auto &src = d_sources[di];
      if (betweenness_sample > 0 && m > betweenness_sample) {
        // partial Fisher-Yates sample without replacement (local ids)
        std::vector<int32_t> pool(m);
        for (int32_t q = 0; q < m; ++q) pool[q] = q;
        for (int32_t k = 0; k < betweenness_sample; ++k) {
          std::uniform_int_distribution<int32_t> d(k, m - 1);
          std::swap(pool[k], pool[d(rng)]);
          src.push_back(pool[k]);
        }
        d_scale[di] = (double)m / (double)betweenness_sample;
      } else {
        src.resize(m);
        for (int32_t q = 0; q < m; ++q) src[q] = q;
      }
      for (int32_t s : src) tasks.push_back({(int32_t)di, s});
    }
#ifdef _OPENMP
    int n_threads = omp_get_max_threads();
#else
    int n_threads = 1;
#endif
    // dirty empty <=> tasks empty: skip the O(threads * n) accumulator
    // zeroing so fully-cached offsets stay nearly free (the scores below
    // still flow from the cache)
    std::vector<std::vector<double>> bc_tls;
    if (!tasks.empty())
      bc_tls.assign(n_threads, std::vector<double>(comp_start[n_comps], 0.0));
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
    for (int64_t ti = 0; ti < (int64_t)tasks.size(); ++ti) {
      int32_t di = tasks[ti].first;
      int32_t s = tasks[ti].second;
      int32_t c = dirty[di];
      const auto &ip = d_indptr[di];
      const auto &ix = d_indices[di];
      int32_t m = (int32_t)(ip.size() - 1);
#ifdef _OPENMP
      double *bc = bc_tls[omp_get_thread_num()].data() + comp_start[c];
#else
      double *bc = bc_tls[0].data() + comp_start[c];
#endif
      std::vector<int32_t> dist(m, -1), order;
      std::vector<double> sigma(m, 0.0), delta(m, 0.0);
      order.reserve(m);
      dist[s] = 0;
      sigma[s] = 1.0;
      order.push_back(s);
      size_t head = 0;
      while (head < order.size()) {
        int32_t v = order[head++];
        for (int64_t k = ip[v]; k < ip[v + 1]; ++k) {
          int32_t w = ix[k];
          if (dist[w] < 0) {
            dist[w] = dist[v] + 1;
            order.push_back(w);
          }
          if (dist[w] == dist[v] + 1) sigma[w] += sigma[v];
        }
      }
      for (size_t p = order.size(); p-- > 1;) {
        int32_t w = order[p];
        double coeff = (1.0 + delta[w]) / sigma[w];
        for (int64_t k = ip[w]; k < ip[w + 1]; ++k) {
          int32_t v = ix[k];
          if (dist[v] == dist[w] - 1) delta[v] += sigma[v] * coeff;
        }
        bc[w] += delta[w];
      }
    }
    // reduce thread buffers, take per-dirty-comp maxima, refresh cache
    for (size_t di = 0; di < dirty.size(); ++di) {
      int32_t c = dirty[di];
      int32_t root = comp_roots[c];
      double mx = 0.0;
      for (int64_t k = comp_start[c]; k < comp_start[c + 1]; ++k) {
        double sum = 0.0;
        for (int th = 0; th < n_threads; ++th) sum += bc_tls[th][k];
        mx = std::max(mx, sum);
      }
      int64_t csize = uf.size[root];
      double norm = (double)(csize - 1) * (double)(csize - 2) / 2.0;
      cached_bt[root] = norm > 0 ? mx * d_scale[di] / 2.0 / norm : 0.0;
      cached_at[root] = t;
      cached_size[root] = csize;
    }
    std::vector<double> maxima, comp_sizes;
    for (int32_t c = 0; c < n_comps; ++c) {
      maxima.push_back(cached_bt[comp_roots[c]]);
      comp_sizes.push_back((double)uf.size[comp_roots[c]]);
    }
    double mean_bt = 0.0, wmean_bt = 0.0;
    if (!maxima.empty()) {
      double sum = 0.0, wsum = 0.0, wtot = 0.0;
      for (size_t k = 0; k < maxima.size(); ++k) {
        sum += maxima[k];
        wsum += maxima[k] * comp_sizes[k];
        wtot += comp_sizes[k];
      }
      mean_bt = sum / (double)maxima.size();
      wmean_bt = wsum / wtot;
    }
    out_scores[t] = -(base * (1.0 - (score_idx == 1 ? mean_bt : wmean_bt)));
  }
}

// Back-compatible score-0 entry point.
void sweep_scores_native(const int32_t *i_vec, const int32_t *j_vec,
                         const int32_t *idx_vec, int64_t n_edges_in,
                         int32_t n_vertices, int32_t n_offsets,
                         double *out_scores) {
  sweep_scores_v2(i_vec, j_vec, idx_vec, n_edges_in, n_vertices, n_offsets, 0,
                  0, 0, out_scores);
}

// Connected-component labels over a raw (i, j) edge array: union-find,
// then ids assigned by first occurrence scanning vertices ascending —
// the scipy.sparse.csgraph convention, so the Python oracle pins this
// bit-equal. O(n + m) memory (no CSR/COO materialisation: at 36M edges
// the scipy route's doubled float64 COO + CSR conversion peaks ~3 GB
// host RSS; this holds 2 int32 arrays of n).
int32_t connected_components_native(const int32_t *i_vec,
                                    const int32_t *j_vec, int64_t n_edges,
                                    int32_t n_vertices,
                                    int32_t *out_labels) {
  UnionFind uf(n_vertices);
  for (int64_t e = 0; e < n_edges; ++e) uf.unite(i_vec[e], j_vec[e]);
  std::vector<int32_t> id_of(n_vertices, -1);
  int32_t next = 0;
  for (int32_t v = 0; v < n_vertices; ++v) {
    int32_t root = uf.find(v);
    if (id_of[root] < 0) id_of[root] = next++;
    out_labels[v] = id_of[root];
  }
  return next;
}

// Brandes betweenness (unnormalised, undirected double counting) over a
// CSR graph from the given sources. OpenMP-parallel over sources.
void brandes_native(const int64_t *indptr, const int32_t *indices,
                    int32_t n_vertices, const int32_t *sources,
                    int64_t n_sources, double *out_bc) {
  TimedCSR csr(0, {});
  csr.indptr.assign(indptr, indptr + n_vertices + 1);
  csr.indices.assign(indices, indices + indptr[n_vertices]);
  csr.times.assign(indptr[n_vertices], 0);
  std::memset(out_bc, 0, sizeof(double) * (size_t)n_vertices);
  brandes_sources(csr, n_vertices, 0, sources, n_sources, out_bc);
}

}  // extern "C"
