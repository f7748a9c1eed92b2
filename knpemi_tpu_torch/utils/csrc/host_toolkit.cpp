// The port's native host toolkit: graph work on the host that a Python
// loop makes slow at scale.  Bound through ctypes by utils/native.py,
// which builds this file with g++ at first use.
//
// vanek_aggregate is the sweep of native/host_toolkit.cpp in the JAX
// package; solvers/mg.py::vanek_aggregate_plain is its Python twin.

#include <cstdint>

extern "C" {

// Vanek root-node aggregation on a strength-filtered CSR graph
// (solvers/mg.py).  agg must be length n; returns the aggregate count.
int64_t vanek_aggregate(int64_t n, const int64_t* indptr,
                        const int32_t* indices, int64_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int64_t nc = 0;
  // phase 1: roots whose whole strong neighbourhood is free
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    bool free_nb = true;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      if (agg[indices[p]] != -1) { free_nb = false; break; }
    }
    if (free_nb) {
      for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p)
        agg[indices[p]] = nc;
      agg[i] = nc;
      ++nc;
    }
  }
  // phase 2: attach stragglers to a strongly connected aggregate
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    int64_t found = -2;
    for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
      int64_t a = agg[indices[p]];
      if (a >= 0) { found = a; break; }
    }
    agg[i] = found;
  }
  // phase 3: isolated leftovers become singletons
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] == -2) agg[i] = nc++;
  }
  return nc;
}

}  // extern "C"
