// Membrane-facet kernels for Hopper (sm_90a): K9 (facet gather of F
// membrane fields, 4 slots and 2 channels a thread, 16-byte loads and
// stores) and K10 (facet scatter-add of F channels).  Plain C
// interface, loaded with ctypes by knpemi_tpu_torch/ops/assembly.py.
// K2, the membrane surface mass, is the P1 operator's apply of cells.cu
// on the membrane's operator (ops/p1op.py::surface_mass).
//
// They replace the TPU kernels of knpemi_tpu/ops/pallas_assembly.py
// (_make_facet_gather_kernel, _make_facet_scatter_kernel), which gather
// through one-hot MXU products because random gathers are slow there.
// Here gathers are exact loads.  K10 is a gather too: one thread per
// membrane dof walks its row of the membrane operator's incidence list
// and sums, so no kernel here uses atomics and each gives the same bits
// on every launch.  Both are bound by the bytes they move.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// K9: G[c, e] = X[c, fd[e]] over F channels c, e = f k + j the facet
// slots (fd is the (nf, k) facet dof map, read as nf k slots).
// Replaces _make_facet_gather_kernel.  Here:
// * each thread owns 4 consecutive slots e .. e+3 of kGatherFB channels
//   (blockIdx.y picks the pair) and reads their dof ids with one 16-byte
//   load (VEC_IDX; a map whose base is not 16-byte aligned is read one id
//   at a time): the map is read ceil(F / kGatherFB) times, from L2 after
//   the first;
// * it issues its 4 kGatherFB gathers of X (a few MB, in L2) before the
//   first store;
// * it writes G[c, e .. e+3] with one 16-byte store per channel (float4,
//   or two double2) where that address is 16-byte aligned, else 4 plain
//   stores; the last thread's slots past nf k are neither read nor
//   written.  No integer division; a copy, so the output bits are the
//   input bits.
// Why pairs: one thread for all F channels leaves a small membrane (the
// flagship's 5,376 facets: 4,032 threads) too few threads to fill the
// card; with pairs its in-step time stays that of one thread per
// element, and the l = 4 box's 56,320 facets run 2.4x faster than with
// one (PERF.md, kernel table).
// Bound by bytes: X and fd read once, G written once.
constexpr int kGatherFB = 2;
constexpr int kGatherThreads = 128;

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

template <typename T, bool VEC_IDX>
__global__ void __launch_bounds__(kGatherThreads)
facet_gather_kernel(const T* __restrict__ X, const int* __restrict__ fd,
                    T* __restrict__ G, int F, int64_t slots, int n_mem) {
  const int64_t e =
      4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (e >= slots) return;
  const bool full = e + 4 <= slots;
  int d[4];
  if (VEC_IDX && full) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(fd + e));
    d[0] = q.x, d[1] = q.y, d[2] = q.z, d[3] = q.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) d[u] = e + u < slots ? __ldg(fd + e + u) : 0;
  }
  const int c0 = blockIdx.y * kGatherFB;
  T v[kGatherFB][4];
#pragma unroll
  for (int c = 0; c < kGatherFB; ++c) {
    if (c0 + c < F) {
      const T* Xc = X + static_cast<int64_t>(c0 + c) * n_mem;
#pragma unroll
      for (int u = 0; u < 4; ++u) v[c][u] = __ldg(Xc + d[u]);
    }
  }
#pragma unroll
  for (int c = 0; c < kGatherFB; ++c) {
    if (c0 + c < F) {
      T* out = G + static_cast<int64_t>(c0 + c) * slots + e;
      if (full && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        store4(out, v[c]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e + u < slots) out[u] = v[c][u];
      }
    }
  }
}

template <typename T>
int facet_gather_t(const void* X, const int* fd, void* G, int F,
                   int64_t slots, int n_mem, cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  T* Gt = static_cast<T*>(G);
  const int64_t quads = (slots + 3) / 4;
  const dim3 grid(
      static_cast<unsigned int>((quads + kGatherThreads - 1) / kGatherThreads),
      (F + kGatherFB - 1) / kGatherFB);
  if ((reinterpret_cast<uintptr_t>(fd) & 15) == 0)
    facet_gather_kernel<T, true><<<grid, kGatherThreads, 0, s>>>(Xt, fd, Gt, F, slots, n_mem);
  else
    facet_gather_kernel<T, false><<<grid, kGatherThreads, 0, s>>>(Xt, fd, Gt, F, slots, n_mem);
  return static_cast<int>(cudaGetLastError());
}

// K10: Y[c, r] = sum of V[c, f, j] over the (facet f, vertex j) slots of
// membrane dof r, for F channels c.  One thread per row r of the
// membrane's P1 operator walks its entries of the incidence list
// (ops/p1op.py: entry e of row r at inc_ptr[r / 32] + 32 e + r % 32,
// packed f << 2 | j, f ascending, padding -1 after the row's last), so a
// warp reads entry e of its 32 rows in one coalesced load; IN_FLIGHT
// entries are loaded before their values.  Each entry is decoded once to
// its slot f k + j and gathered for up to FB channels (V, a few MB, lives
// in L2), the FB sums kept in registers in the list's order, and Y[c, r]
// written once: no atomics, no zeroed output.  More than FB channels go
// through in groups, the row's entries read again from L1.  Replaces
// _make_facet_scatter_kernel.  Bound by bytes: V and the list read once,
// Y written once.
template <typename T, int FB = 8, int IN_FLIGHT = 8>
__global__ void facet_scatter_rows_kernel(const T* __restrict__ V,
                                          const int* __restrict__ inc_ptr,
                                          const int* __restrict__ inc,
                                          T* __restrict__ Y, int F, int n,
                                          int64_t slots, int k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int beg = __ldg(inc_ptr + (r >> 5)) + (r & 31);
  const int end = __ldg(inc_ptr + (r >> 5) + 1);
  for (int c0 = 0; c0 < F; c0 += FB) {
    const T* Vc = V + c0 * slots;
    T acc[FB];
#pragma unroll
    for (int c = 0; c < FB; ++c) acc[c] = T(0);
    for (int e0 = beg; e0 < end; e0 += IN_FLIGHT * 32) {
      int64_t slot[IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        const int s = e0 + u * 32;
        const int e = s < end ? __ldg(inc + s) : -1;
        slot[u] = e < 0 ? -1 : static_cast<int64_t>(e >> 2) * k + (e & 3);
      }
#pragma unroll
      for (int u = 0; u < IN_FLIGHT; ++u) {
        if (slot[u] < 0) continue;
#pragma unroll
        for (int c = 0; c < FB; ++c)
          if (c0 + c < F) acc[c] += __ldg(Vc + c * slots + slot[u]);
      }
    }
#pragma unroll
    for (int c = 0; c < FB; ++c)
      if (c0 + c < F) Y[static_cast<int64_t>(c0 + c) * n + r] = acc[c];
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  Each entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().
int knp_facet_gather(int dtype, const void* X, const int* fd, void* G,
                     int F, int nf, int k, int n_mem, void* stream) {
  const int64_t slots = static_cast<int64_t>(nf) * k;
  if (slots == 0 || F == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? facet_gather_t<float>(X, fd, G, F, slots, n_mem, s)
                    : facet_gather_t<double>(X, fd, G, F, slots, n_mem, s);
}

// K10: Y (F, n) from V (F, nf, k) and the membrane operator's incidence
// list (inc_ptr: ceil(n / 32) + 1 offsets); every element of Y written.
int knp_facet_scatter(int dtype, const void* V, const int* inc_ptr,
                      const int* inc, void* Y, int F, int n, int nf, int k,
                      void* stream) {
  if (F == 0 || n == 0) return 0;
  if (k < 2 || k > 4) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t slots = static_cast<int64_t>(nf) * k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    facet_scatter_rows_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(V), inc_ptr, inc, static_cast<float*>(Y), F,
        n, slots, k);
  else
    facet_scatter_rows_kernel<double><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const double*>(V), inc_ptr, inc, static_cast<double*>(Y),
        F, n, slots, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
