// Host-side native runtime of ceres_tpu_torch: sparse direct Cholesky.
//
// The port's copy of ceres_tpu/native/ceres_native.cpp, with the same
// arithmetic, so that a factor of the same CSC matrix gives the same bits
// in both packages. It plays the role of the reference's SuiteSparse/Eigen
// sparse backends (internal/ceres/suitesparse.{h,cc}, eigensparse.cc,
// sparse_cholesky.cc): the GPU evaluates residuals and Jacobians and forms
// the per-row Gram blocks; this library owns the host half of
// SPARSE_NORMAL_CHOLESKY, the SUBSET preconditioner and the scalable
// Covariance path: fill-reducing ordering, simplicial LDL^T factorization
// with a reusable symbolic analysis (analyze once, refactor every
// iteration), triangular solves, and the scatter-assembly of block Gram
// values into the CSC pattern (the role of inner_product_computer.cc).
//
// Algorithms implemented from the standard literature:
//  - reverse Cuthill-McKee ordering (bandwidth reduction; SLAM/grid graphs)
//  - elimination tree + row-pattern traversal (Liu'86) and up-looking
//    LDL^T row factorization (Davis, "Direct Methods for Sparse Linear
//    Systems", ch. 4) — no third-party code.
//
// Build (ceres_tpu_torch/native.py, at first use, into _build/):
//   g++ -O3 -shared -fPIC -std=c++17 -o libceres_native_<hash>.so
//       ceres_native.cpp

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Reverse Cuthill-McKee on the symmetric pattern (Ap, Ai), CSC (== CSR).
// perm[k] = old index of the k-th new row. Returns 0 on success.
int ct_rcm_order(int32_t n, const int64_t* Ap, const int32_t* Ai,
                 int32_t* perm) {
  std::vector<int32_t> degree(n), order;
  order.reserve(n);
  std::vector<char> visited(n, 0);
  for (int32_t i = 0; i < n; ++i) degree[i] = int32_t(Ap[i + 1] - Ap[i]);

  for (;;) {
    // Find the unvisited node of minimum degree as the next BFS root.
    int32_t root = -1;
    for (int32_t i = 0; i < n; ++i)
      if (!visited[i] && (root < 0 || degree[i] < degree[root])) root = i;
    if (root < 0) break;

    std::queue<int32_t> q;
    q.push(root);
    visited[root] = 1;
    std::vector<int32_t> nbrs;
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      order.push_back(u);
      nbrs.clear();
      for (int64_t p = Ap[u]; p < Ap[u + 1]; ++p) {
        int32_t v = Ai[p];
        if (v >= 0 && v < n && !visited[v]) {
          visited[v] = 1;
          nbrs.push_back(v);
        }
      }
      // Enqueue neighbors by increasing degree (Cuthill-McKee).
      for (size_t a = 1; a < nbrs.size(); ++a)
        for (size_t b = a; b > 0 && degree[nbrs[b]] < degree[nbrs[b - 1]];
             --b) {
          int32_t t = nbrs[b];
          nbrs[b] = nbrs[b - 1];
          nbrs[b - 1] = t;
        }
      for (int32_t v : nbrs) q.push(v);
    }
  }
  // Reverse.
  for (int32_t k = 0; k < n; ++k) perm[k] = order[n - 1 - k];
  return 0;
}

// ---------------------------------------------------------------------------
// Minimum-degree ordering on the quotient graph (the fill-reducing role of
// SuiteSparse CAMD / Eigen AMD in the reference, reorder_program.cc:95 +
// suitesparse.cc). Classic Amestoy/Davis/Duff scheme implemented from the
// literature: eliminate the node of (approximate) minimum external degree,
// replace it and its adjacent elements by one new element, update degrees
// lazily through a binary heap. Supervariable detection is omitted — the
// orderings are near-AMD quality at O(nnz log n)-ish cost, plenty for the
// pose-graph / grid problems the host path serves.
int ct_amd_order(int32_t n, const int64_t* Ap, const int32_t* Ai,
                 int32_t* perm) {
  // Node adjacency (nodes + elements), stored as vectors.
  std::vector<std::vector<int32_t>> nadj(n);   // adjacent uneliminated nodes
  std::vector<std::vector<int32_t>> eadj(n);   // adjacent elements (ids)
  std::vector<std::vector<int32_t>> emembers;  // element -> member nodes
  std::vector<char> dead_elem;
  std::vector<char> eliminated(n, 0);
  std::vector<int64_t> degree(n, 0);
  for (int32_t j = 0; j < n; ++j) {
    nadj[j].reserve(Ap[j + 1] - Ap[j]);
    for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
      int32_t i = Ai[p];
      if (i != j && i >= 0 && i < n) nadj[j].push_back(i);
    }
    degree[j] = int64_t(nadj[j].size());
  }

  // Binary heap of (degree, node) with lazy deletion.
  using Entry = std::pair<int64_t, int32_t>;
  std::vector<Entry> heap;
  heap.reserve(2 * size_t(n));
  auto heap_less = [](const Entry& a, const Entry& b) { return a > b; };
  for (int32_t i = 0; i < n; ++i) heap.push_back({degree[i], i});
  std::make_heap(heap.begin(), heap.end(), heap_less);

  std::vector<int32_t> mark(n, -1);
  int32_t order_pos = 0;

  while (order_pos < n) {
    // Pop the live node whose recorded degree is current.
    int32_t p = -1;
    while (!heap.empty()) {
      std::pop_heap(heap.begin(), heap.end(), heap_less);
      Entry e = heap.back();
      heap.pop_back();
      if (!eliminated[e.second] && e.first == degree[e.second]) {
        p = e.second;
        break;
      }
    }
    if (p < 0) {  // all remaining entries stale: pick any live node
      for (int32_t i = 0; i < n; ++i)
        if (!eliminated[i]) { p = i; break; }
      if (p < 0) break;
    }

    // Form the new element: union of live node-neighbors and members of
    // adjacent elements.
    std::vector<int32_t> Lp;
    const int32_t tag = p;
    mark[p] = tag;
    for (int32_t v : nadj[p]) {
      if (!eliminated[v] && mark[v] != tag) {
        mark[v] = tag;
        Lp.push_back(v);
      }
    }
    for (int32_t e : eadj[p]) {
      if (dead_elem[size_t(e)]) continue;
      for (int32_t v : emembers[size_t(e)]) {
        if (!eliminated[v] && v != p && mark[v] != tag) {
          mark[v] = tag;
          Lp.push_back(v);
        }
      }
      dead_elem[size_t(e)] = 1;  // absorbed into the new element
    }
    eliminated[p] = 1;
    perm[order_pos++] = p;

    const int32_t enew = int32_t(emembers.size());
    emembers.push_back(Lp);
    dead_elem.push_back(0);

    // Update each member: drop dead elements, add the new one, recompute
    // the approximate external degree = |live node adj \ Lp| + sum of
    // live adjacent element sizes (upper bound; duplicates uncounted).
    for (int32_t v : Lp) {
      // compact node adjacency (drop eliminated)
      auto& na = nadj[v];
      size_t w = 0;
      for (size_t r = 0; r < na.size(); ++r)
        if (!eliminated[na[r]]) na[w++] = na[r];
      na.resize(w);
      auto& ea = eadj[v];
      w = 0;
      for (size_t r = 0; r < ea.size(); ++r)
        if (!dead_elem[size_t(ea[r])]) ea[w++] = ea[r];
      ea.resize(w);
      ea.push_back(enew);
      int64_t d = int64_t(na.size());
      for (int32_t e : ea) d += int64_t(emembers[size_t(e)].size()) - 1;
      degree[v] = d;
      heap.push_back({d, v});
      std::push_heap(heap.begin(), heap.end(), heap_less);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Simplicial LDL^T with cached symbolic analysis.

struct CholHandle {
  int32_t n = 0;
  // Original full symmetric pattern (CSC) and the permutation.
  std::vector<int64_t> Ap;
  std::vector<int32_t> Ai;
  std::vector<int32_t> perm;    // perm[new] = old
  std::vector<int32_t> iperm;   // iperm[old] = new
  // Permuted UPPER-triangular pattern (CSC, column-sorted) incl. diagonal.
  std::vector<int64_t> Up;
  std::vector<int32_t> Ui;
  // Map: position in original (Ap, Ai) -> position in (Up, Ui), or -1 for
  // entries that land strictly below the permuted diagonal.
  std::vector<int64_t> value_map;
  // Symbolic factor.
  std::vector<int32_t> parent;  // etree
  std::vector<int64_t> Lp;      // column pointers of L (strictly lower)
  std::vector<int32_t> Lnz;     // fill counts per column
  // Numeric factor.
  std::vector<int32_t> Li;
  std::vector<double> Lx;
  std::vector<double> D;
  // Workspaces.
  std::vector<double> Ux;       // permuted upper values
  std::vector<double> Y;
  std::vector<int32_t> pattern, flag;
  std::vector<double> w;        // solve workspace
};

// Symbolic fill (nnz of L, strictly lower) for a candidate permutation —
// used to pick between RCM and AMD per problem.
static int64_t symbolic_fill(int32_t n, const int64_t* Ap,
                             const int32_t* Ai, const int32_t* perm) {
  std::vector<int32_t> iperm(n);
  for (int32_t k = 0; k < n; ++k) iperm[perm[k]] = k;
  // permuted upper pattern, column-major (unsorted is fine for the etree)
  std::vector<int64_t> Up(n + 1, 0);
  const int64_t nnz = Ap[n];
  for (int32_t jold = 0; jold < n; ++jold)
    for (int64_t p = Ap[jold]; p < Ap[jold + 1]; ++p) {
      int32_t inew = iperm[Ai[p]], jnew = iperm[jold];
      if (inew <= jnew) Up[jnew + 1]++;
    }
  for (int32_t j = 0; j < n; ++j) Up[j + 1] += Up[j];
  std::vector<int32_t> Ui(Up[n]);
  std::vector<int64_t> fill(n, 0);
  for (int32_t jold = 0; jold < n; ++jold)
    for (int64_t p = Ap[jold]; p < Ap[jold + 1]; ++p) {
      int32_t inew = iperm[Ai[p]], jnew = iperm[jold];
      if (inew <= jnew) Ui[Up[jnew] + fill[jnew]++] = inew;
    }
  std::vector<int32_t> parent(n, -1), ancestor(n, -1), flag(n, -1);
  for (int32_t k = 0; k < n; ++k)
    for (int64_t p = Up[k]; p < Up[k + 1]; ++p) {
      int32_t i = Ui[p];
      while (i != -1 && i < k) {
        int32_t next = ancestor[i];
        ancestor[i] = k;
        if (next == -1) parent[i] = k;
        i = next;
      }
    }
  int64_t total = 0;
  for (int32_t k = 0; k < n; ++k) {
    flag[k] = k;
    for (int64_t p = Up[k]; p < Up[k + 1]; ++p) {
      int32_t i = Ui[p];
      while (i != k && flag[i] != k) {
        total++;
        flag[i] = k;
        i = parent[i];
      }
    }
  }
  (void)nnz;
  return total;
}

// Analyze: permute the pattern, build the upper-triangular permuted
// pattern + value map, compute the etree and column counts.
// ordering: 0 = natural, 1 = RCM, 2 = AMD, 3 = auto (min symbolic fill).
void* ct_chol_create(int32_t n, const int64_t* Ap, const int32_t* Ai,
                     int32_t ordering) {
  auto* h = new CholHandle;
  h->n = n;
  h->Ap.assign(Ap, Ap + n + 1);
  h->Ai.assign(Ai, Ai + Ap[n]);
  h->perm.resize(n);
  h->iperm.resize(n);
  if (ordering == 1) {
    ct_rcm_order(n, Ap, Ai, h->perm.data());
  } else if (ordering == 2) {
    ct_amd_order(n, Ap, Ai, h->perm.data());
  } else if (ordering == 3) {
    std::vector<int32_t> rcm(n), amd(n);
    ct_rcm_order(n, Ap, Ai, rcm.data());
    ct_amd_order(n, Ap, Ai, amd.data());
    const int64_t f_rcm = symbolic_fill(n, Ap, Ai, rcm.data());
    const int64_t f_amd = symbolic_fill(n, Ap, Ai, amd.data());
    h->perm = (f_amd <= f_rcm) ? amd : rcm;
  } else {
    for (int32_t i = 0; i < n; ++i) h->perm[i] = i;
  }
  for (int32_t k = 0; k < n; ++k) h->iperm[h->perm[k]] = k;

  // Count entries of the permuted upper triangle per permuted column.
  const int64_t nnz = Ap[n];
  std::vector<int64_t> colcount(n + 1, 0);
  for (int32_t jold = 0; jold < n; ++jold) {
    for (int64_t p = Ap[jold]; p < Ap[jold + 1]; ++p) {
      int32_t inew = h->iperm[Ai[p]];
      int32_t jnew = h->iperm[jold];
      if (inew <= jnew) colcount[jnew + 1]++;
    }
  }
  h->Up.resize(n + 1);
  h->Up[0] = 0;
  for (int32_t j = 0; j < n; ++j) h->Up[j + 1] = h->Up[j] + colcount[j + 1];
  h->Ui.resize(h->Up[n]);
  h->value_map.assign(nnz, -1);
  std::vector<int64_t> fill(n, 0);
  for (int32_t jold = 0; jold < n; ++jold) {
    for (int64_t p = Ap[jold]; p < Ap[jold + 1]; ++p) {
      int32_t inew = h->iperm[Ai[p]];
      int32_t jnew = h->iperm[jold];
      if (inew <= jnew) {
        int64_t pos = h->Up[jnew] + fill[jnew]++;
        h->Ui[pos] = inew;
        h->value_map[p] = pos;
      }
    }
  }
  // Sort row indices within each column (insertion sort; columns are short),
  // keeping value_map consistent by sorting an index permutation.
  {
    std::vector<int64_t> inv(h->Up[n]);
    for (int32_t j = 0; j < n; ++j) {
      int64_t lo = h->Up[j], hi = h->Up[j + 1];
      for (int64_t a = lo + 1; a < hi; ++a) {
        int32_t vi = h->Ui[a];
        int64_t b = a;
        while (b > lo && h->Ui[b - 1] > vi) {
          h->Ui[b] = h->Ui[b - 1];
          --b;
        }
        h->Ui[b] = vi;
      }
    }
    // Rebuild value_map by lookup (binary search per entry).
    for (int32_t jold = 0; jold < n; ++jold) {
      for (int64_t p = Ap[jold]; p < Ap[jold + 1]; ++p) {
        int32_t inew = h->iperm[Ai[p]];
        int32_t jnew = h->iperm[jold];
        if (inew > jnew) continue;
        int64_t lo = h->Up[jnew], hi = h->Up[jnew + 1] - 1;
        while (lo < hi) {
          int64_t mid = (lo + hi) / 2;
          if (h->Ui[mid] < inew) lo = mid + 1;
          else hi = mid;
        }
        h->value_map[p] = lo;
      }
    }
  }

  // Elimination tree of the permuted upper pattern (Liu's algorithm with
  // path compression) + column counts of L via row-pattern traversal.
  h->parent.assign(n, -1);
  std::vector<int32_t> ancestor(n, -1);
  for (int32_t k = 0; k < n; ++k) {
    for (int64_t p = h->Up[k]; p < h->Up[k + 1]; ++p) {
      int32_t i = h->Ui[p];
      while (i != -1 && i < k) {
        int32_t next = ancestor[i];
        ancestor[i] = k;
        if (next == -1) h->parent[i] = k;
        i = next;
      }
    }
  }
  // Column counts by symbolic row traversal (ereach per row).
  h->Lnz.assign(n, 0);
  h->flag.assign(n, -1);
  for (int32_t k = 0; k < n; ++k) {
    h->flag[k] = k;
    for (int64_t p = h->Up[k]; p < h->Up[k + 1]; ++p) {
      int32_t i = h->Ui[p];
      while (i != k && h->flag[i] != k) {
        h->Lnz[i]++;
        h->flag[i] = k;
        i = h->parent[i];
      }
    }
  }
  h->Lp.resize(n + 1);
  h->Lp[0] = 0;
  for (int32_t j = 0; j < n; ++j) h->Lp[j + 1] = h->Lp[j] + h->Lnz[j];
  h->Li.resize(h->Lp[n]);
  h->Lx.resize(h->Lp[n]);
  h->D.resize(n);
  h->Ux.resize(h->Up[n]);
  h->Y.assign(n, 0.0);
  h->pattern.resize(n);
  h->w.resize(n);
  return h;
}

int64_t ct_chol_nnz(void* handle) {
  auto* h = static_cast<CholHandle*>(handle);
  return h->Lp[h->n];
}

// Diagnostics of the last successful LDL^T factor (rank policy,
// reference covariance.h:281-329 semantics): out[0] = min |D|,
// out[1] = max |D|, out[2] = count of negative D entries (inertia). For
// the SPD normal equations any negative pivot or a tiny |D|min/|D|max
// ratio signals numerical rank deficiency.
void ct_chol_diag_stats(void* handle, double* out3) {
  auto* h = static_cast<CholHandle*>(handle);
  const int32_t n = h->n;
  double dmin = 0.0, dmax = 0.0;
  int64_t nneg = 0;
  for (int32_t k = 0; k < n; ++k) {
    const double d = h->D[k];
    const double a = std::fabs(d);
    if (k == 0 || a < dmin) dmin = a;
    if (k == 0 || a > dmax) dmax = a;
    if (d < 0.0) ++nneg;
  }
  out3[0] = dmin;
  out3[1] = dmax;
  out3[2] = static_cast<double>(nneg);
}

// Numeric LDL^T refactorization. Ax: values aligned with the (Ap, Ai)
// pattern passed to create (full symmetric; lower entries ignored via the
// value map). Returns 0 on success, k+1 if D[k] ~ 0 (rank deficiency).
int32_t ct_chol_factor(void* handle, const double* Ax) {
  auto* h = static_cast<CholHandle*>(handle);
  const int32_t n = h->n;
  // Permute values into the upper pattern.
  std::memset(h->Ux.data(), 0, sizeof(double) * h->Ux.size());
  const int64_t nnz = h->Ap[n];
  for (int64_t p = 0; p < nnz; ++p)
    if (h->value_map[p] >= 0) h->Ux[h->value_map[p]] = Ax[p];

  std::fill(h->flag.begin(), h->flag.end(), -1);
  std::fill(h->Lnz.begin(), h->Lnz.end(), 0);
  double* Y = h->Y.data();
  for (int32_t k = 0; k < n; ++k) {
    // Row pattern of L(k, :) via etree reach of A(0:k, k).
    int32_t top = n;
    h->flag[k] = k;
    double dk = 0.0;
    for (int64_t p = h->Up[k]; p < h->Up[k + 1]; ++p) {
      int32_t i = h->Ui[p];
      if (i == k) {
        dk = h->Ux[p];
        continue;
      }
      Y[i] += h->Ux[p];
      int32_t len = 0;
      while (h->flag[i] != k) {
        h->pattern[len++] = i;
        h->flag[i] = k;
        i = h->parent[i];
      }
      while (len > 0) h->pattern[--top] = h->pattern[--len];
    }
    // Sparse triangular solve over the pattern (topological order).
    for (int32_t t = top; t < n; ++t) {
      int32_t j = h->pattern[t];
      double yj = Y[j];
      Y[j] = 0.0;
      const int64_t p0 = h->Lp[j], p1 = h->Lp[j] + h->Lnz[j];
      for (int64_t p = p0; p < p1; ++p) Y[h->Li[p]] -= h->Lx[p] * yj;
      const double lkj = yj / h->D[j];
      dk -= lkj * yj;
      h->Li[p1] = k;
      h->Lx[p1] = lkj;
      h->Lnz[j]++;
    }
    if (!(dk > 1e-300) && !(dk < -1e-300)) return k + 1;  // singular / NaN
    h->D[k] = dk;
  }
  return 0;
}

// Solve P^T (L D L^T) P x = b.
int32_t ct_chol_solve(void* handle, const double* b, double* x) {
  auto* h = static_cast<CholHandle*>(handle);
  const int32_t n = h->n;
  double* w = h->w.data();
  for (int32_t k = 0; k < n; ++k) w[k] = b[h->perm[k]];
  // L y = w
  for (int32_t j = 0; j < n; ++j) {
    const double yj = w[j];
    for (int64_t p = h->Lp[j]; p < h->Lp[j] + h->Lnz[j]; ++p)
      w[h->Li[p]] -= h->Lx[p] * yj;
  }
  // D z = y
  for (int32_t k = 0; k < n; ++k) w[k] /= h->D[k];
  // L^T x = z
  for (int32_t j = n - 1; j >= 0; --j) {
    double acc = w[j];
    for (int64_t p = h->Lp[j]; p < h->Lp[j] + h->Lnz[j]; ++p)
      acc -= h->Lx[p] * w[h->Li[p]];
    w[j] = acc;
  }
  for (int32_t k = 0; k < n; ++k) x[h->perm[k]] = w[k];
  return 0;
}

void ct_chol_destroy(void* handle) {
  delete static_cast<CholHandle*>(handle);
}

// ---------------------------------------------------------------------------
// Scatter-add assembly: out[idx[i]] += vals[i], idx == -1 entries skipped.
// The host half of Gram-block -> CSC assembly (inner_product_computer.cc).
void ct_scatter_add(double* out, const int64_t* idx, const double* vals,
                    int64_t nvals) {
  for (int64_t i = 0; i < nvals; ++i)
    if (idx[i] >= 0) out[idx[i]] += vals[i];
}

}  // extern "C"
