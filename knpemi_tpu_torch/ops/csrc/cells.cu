// Cell kernels for Hopper (sm_90a): the P1 operator of a subdomain
// (the K1 / K11 apply, the ion-batched K3 apply and the K1f / K11f
// fills) and K4 (ELL SpMV of the frozen dof -> cell coefficient maps).
// Plain C interface, loaded with ctypes by knpemi_tpu_torch/ops/p1op.py
// and ops/assembly.py, which hold the plain PyTorch version of each
// kernel, the input checks and the launch counters.
//
// All replace TPU kernels whose one-hot MXU factoring exists only
// because random gathers are slow on the TPU
// (knpemi_tpu/ops/pallas_assembly.py, pallas_ell.py); here every gather
// is exact.  K1 and K11 apply the subdomain's P1 operator assembled on
// its P1 graph, stored as a sliced ELL (ops/p1op.py): one thread per row
// streams the row's slots, a warp reading slot k of its 32 rows in one
// coalesced load, and writes the row once -- no atomics, so the sums
// are deterministic.  Their values are filled once per solve by K1f and
// K11f, one thread per cell adding k^2 results atomically into an array
// that L2 holds; K3 is one thread per cell with k atomic adds per ion.
// Every kernel here is bound by the bytes it moves.  Sums taken with
// atomics are order-dependent, so those results agree with the plain
// version to a few ulps of max|y|, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// The P1 operator's apply, K1 (one value stream) and K11 (two), in the
// row-sum form of ops/p1op.py (a row's diagonal slot holds the row's sum):
//   y[r] = a sum_s V1[s] t[s] + b sum_s V2[s] t[s],
//   t[s] = x[r] at the diagonal slot, x[col[s]] - x[r] at the others,
// over the slots s of row r, slot k of row r at slot_ptr[r / 32] + 32 k +
// r % 32.  The differences keep a nearly uniform x's sum exact where
// sum_s A[s] x[col[s]] would leave eps |A| |x| of noise.  One thread per
// row; IN_FLIGHT slots' columns and values are loaded before their x, so
// several loads are in flight per thread: 8 for one value stream, 4 for
// two, which keeps the kernel at 32 registers, so that the whole grid of
// a subdomain of ~300k rows is resident at once (picked by a sweep on the
// card); x (1-2 MB) is read through the read-only path and lives in L2.
// Padding slots hold value 0 at column = the row.  Replaces
// knpemi_tpu/ops/pallas_assembly.py:_make_emi_kernel (K1) and
// _make_knp_kernel (K11), whose scalars arrive here by value.  Bound by
// bytes: a column and one value per stream for every slot, x, y.
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T, bool TWO, int IN_FLIGHT = TWO ? 4 : 8>
__global__ void p1_apply_kernel(const int* __restrict__ slot_ptr,
                                const int* __restrict__ col,
                                const T* __restrict__ v1,
                                const T* __restrict__ v2,
                                const T* __restrict__ x, T* __restrict__ y,
                                int n, T a, T b) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int end = __ldg(slot_ptr + (r >> 5) + 1);
  const T xr = __ldg(x + r);
  T acc1 = T(0), acc2 = T(0);
  for (int s0 = __ldg(slot_ptr + (r >> 5)) + (r & 31); s0 < end;
       s0 += IN_FLIGHT * 32) {
    int c[IN_FLIGHT];
    T w1[IN_FLIGHT], w2[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int s = s0 + u * 32;
      const bool in = s < end;
      c[u] = in ? __ldg(col + s) : r;
      w1[u] = in ? __ldg(v1 + s) : T(0);
      w2[u] = (TWO && in) ? __ldg(v2 + s) : T(0);
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const T xv = __ldg(x + c[u]);
      const T t = c[u] == r ? xr : xv - xr;
      acc1 = fma_t(w1[u], t, acc1);
      if (TWO) acc2 = fma_t(w2[u], t, acc2);
    }
  }
  y[r] = TWO ? a * acc1 + b * acc2 : a * acc1;
}

// K3: the ion-batched KNP operator on the P1 operator, three value
// streams in the row-sum form -- the unit mass M, the unit stiffness Kst
// and the drift Dr of this solve -- and per ion b the scalars
// coef[3b .. 3b+2] = (1/dt, D_b, z_b psi D_b):
//   y_b[r] = sum_s v_b[s] t_b[s],  v_b = c0 M + c1 Kst + c2 Dr,
//   t_b[s] = x_b[r] at the diagonal slot, x_b[col[s]] - x_b[r] else.
// MASS_ONLY (the right-hand side's (1/dt) M c) reads M alone.  One
// thread per row as in p1_apply_kernel; each slot's column and values
// are read once for all B ions, the value of ion b formed in registers,
// B accumulators.  Replaces _make_knp_kernel_batch
// (knpemi_tpu/ops/pallas_assembly.py:444), whose scalars sit in SMEM;
// here they are loaded once per thread.  Bound by bytes: a column and
// three values (one) per slot, X and Y.
template <typename T, int B, bool MASS_ONLY>
__global__ void __launch_bounds__(kThreads)
p1_apply_batch_kernel(const int* __restrict__ slot_ptr,
                      const int* __restrict__ col,
                      const T* __restrict__ vm, const T* __restrict__ vk,
                      const T* __restrict__ vd, const T* __restrict__ coef,
                      const T* __restrict__ X, T* __restrict__ Y, int n) {
  constexpr int IN_FLIGHT = 4;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const int end = __ldg(slot_ptr + (r >> 5) + 1);
  T c0[B], c1[B], c2[B], xr[B], acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) {
    c0[b] = __ldg(coef + 3 * b);
    c1[b] = MASS_ONLY ? T(0) : __ldg(coef + 3 * b + 1);
    c2[b] = MASS_ONLY ? T(0) : __ldg(coef + 3 * b + 2);
    xr[b] = __ldg(X + static_cast<int64_t>(b) * n + r);
    acc[b] = T(0);
  }
  for (int s0 = __ldg(slot_ptr + (r >> 5)) + (r & 31); s0 < end;
       s0 += IN_FLIGHT * 32) {
    int c[IN_FLIGHT];
    T m[IN_FLIGHT], k[IN_FLIGHT], d[IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int s = s0 + u * 32;
      const bool in = s < end;
      c[u] = in ? __ldg(col + s) : r;
      m[u] = in ? __ldg(vm + s) : T(0);
      k[u] = (!MASS_ONLY && in) ? __ldg(vk + s) : T(0);
      d[u] = (!MASS_ONLY && in) ? __ldg(vd + s) : T(0);
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const T xv = __ldg(X + static_cast<int64_t>(b) * n + c[u]);
        const T t = c[u] == r ? xr[b] : xv - xr[b];
        const T v = MASS_ONLY ? c0[b] * m[u]
                              : fma_t(c0[b], m[u], fma_t(c1[b], k[u], c2[b] * d[u]));
        acc[b] = fma_t(v, t, acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) Y[static_cast<int64_t>(b) * n + r] = acc[b];
}

// The K*K slot positions of cell c (one byte each; one 16-byte load for
// a tetrahedron).
template <int K>
__device__ __forceinline__ void load_pos(const uint8_t* __restrict__ pos,
                                         int c, uint8_t (&p)[K * K]) {
  const uint8_t* pc = pos + static_cast<int64_t>(c) * K * K;
  if constexpr (K * K == 16) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(pc));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = (w[i >> 2] >> (8 * (i & 3))) & 0xFF;
  } else {
#pragma unroll
    for (int i = 0; i < K * K; ++i) p[i] = __ldg(pc + i);
  }
}

// K1f: vals[slot(c, i, j)] += wv_c (g_ci . g_cj) for every cell c and
// vertex pair i != j, into a zeroed vals; the diagonal slots keep the
// stiffness's row sums, an exact 0.  Bound by bytes: cells, pos, grads,
// wv read once, vals (in L2) written once.
template <typename T, int K, int D>
__global__ void emi_fill_kernel(const int* __restrict__ cells,
                                const uint8_t* __restrict__ pos,
                                const int* __restrict__ slot_ptr,
                                const T* __restrict__ grads,
                                const T* __restrict__ wv,
                                T* __restrict__ vals, int nc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  int base[K];
  T g[K][D];
  uint8_t p[K * K];
  load_pos<K>(pos, c, p);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int v = cells[static_cast<int64_t>(c) * K + i];
    base[i] = __ldg(slot_ptr + (v >> 5)) + (v & 31);
#pragma unroll
    for (int d = 0; d < D; ++d)
      g[i][d] = grads[(static_cast<int64_t>(c) * K + i) * D + d];
  }
  const T w = wv[c];
#pragma unroll
  for (int i = 0; i < K; ++i) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j == i) continue;
      T s = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) s += g[i][d] * g[j][d];
      atomicAdd(&vals[base[i] + 32 * p[i * K + j]], w * s);
    }
  }
}

// K11f: q = vol_c (w_c . g_ci) / K added into vals[slot(c, i, j)] for
// every j != i and K q into the diagonal slot (i, i) -- the row's sum --
// for every cell c and vertex i, into a zeroed vals: the P1 drift along
// the cellwise-constant w = grad(phi).  Bound by bytes: cells, pos,
// grads, vols, w read once, vals (in L2) written once.
template <typename T, int K, int D>
__global__ void drift_fill_kernel(const int* __restrict__ cells,
                                  const uint8_t* __restrict__ pos,
                                  const int* __restrict__ slot_ptr,
                                  const T* __restrict__ grads,
                                  const T* __restrict__ vols,
                                  const T* __restrict__ w,
                                  T* __restrict__ vals, int nc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  uint8_t p[K * K];
  load_pos<K>(pos, c, p);
  T wc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) wc[d] = w[static_cast<int64_t>(c) * D + d];
  const T vk = vols[c] / T(K);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int v = cells[static_cast<int64_t>(c) * K + i];
    const int base = __ldg(slot_ptr + (v >> 5)) + (v & 31);
    T wg = T(0);
#pragma unroll
    for (int d = 0; d < D; ++d)
      wg += wc[d] * grads[(static_cast<int64_t>(c) * K + i) * D + d];
    const T q = vk * wg;
#pragma unroll
    for (int j = 0; j < K; ++j)
      atomicAdd(&vals[base + 32 * p[i * K + j]], j == i ? T(K) * q : q);
  }
}

// K4: y[r] = sum_k vals[r, k] x[cols[r, k]] (padded slots carry zeros).
template <typename T>
__global__ void ell_matvec_kernel(const int* __restrict__ cols,
                                  const T* __restrict__ vals,
                                  const T* __restrict__ x,
                                  T* __restrict__ y, int R, int K) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t base = static_cast<int64_t>(r) * K;
  T acc = T(0);
  for (int k = 0; k < K; ++k) acc += vals[base + k] * x[cols[base + k]];
  y[r] = acc;
}

template <typename T>
int p1_apply_t(const int* slot_ptr, const int* col, const void* v1,
               const void* v2, const void* x, void* y, double a, double b,
               int n, cudaStream_t s) {
  const T* v1t = static_cast<const T*>(v1);
  const T* v2t = static_cast<const T*>(v2);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (v2 != nullptr)
    p1_apply_kernel<T, true><<<blocks_for(n), kThreads, 0, s>>>(
        slot_ptr, col, v1t, v2t, xt, yt, n, static_cast<T>(a),
        static_cast<T>(b));
  else
    p1_apply_kernel<T, false><<<blocks_for(n), kThreads, 0, s>>>(
        slot_ptr, col, v1t, v2t, xt, yt, n, static_cast<T>(a), T(0));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int p1_apply_batch_t(const int* slot_ptr, const int* col, const void* vm,
                     const void* vk, const void* vd, const void* coef,
                     const void* X, void* Y, int n, int nb, cudaStream_t s) {
  const T* m = static_cast<const T*>(vm);
  const T* k = static_cast<const T*>(vk);
  const T* d = static_cast<const T*>(vd);
  const T* c = static_cast<const T*>(coef);
  const T* x = static_cast<const T*>(X);
  T* y = static_cast<T*>(Y);
  const bool mass_only = vk == nullptr;
#define CALL(BB)                                                             \
  if (mass_only)                                                             \
    p1_apply_batch_kernel<T, BB, true><<<blocks_for(n), kThreads, 0, s>>>(   \
        slot_ptr, col, m, k, d, c, x, y, n);                                 \
  else                                                                       \
    p1_apply_batch_kernel<T, BB, false><<<blocks_for(n), kThreads, 0, s>>>(  \
        slot_ptr, col, m, k, d, c, x, y, n)
  switch (nb) {
    case 1: CALL(1); break;
    case 2: CALL(2); break;
    case 3: CALL(3); break;
    case 4: CALL(4); break;
    case 5: CALL(5); break;
    case 6: CALL(6); break;
    case 7: CALL(7); break;
    case 8: CALL(8); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef CALL
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int emi_fill_t(const int* cells, const uint8_t* pos, const int* slot_ptr,
               const void* grads, const void* wv, void* vals, int nc, int k,
               int dim, cudaStream_t s) {
  const T* gt = static_cast<const T*>(grads);
  const T* wt = static_cast<const T*>(wv);
  T* vt = static_cast<T*>(vals);
  if (k == 4 && dim == 3)
    emi_fill_kernel<T, 4, 3><<<blocks_for(nc), kThreads, 0, s>>>(
        cells, pos, slot_ptr, gt, wt, vt, nc);
  else if (k == 3 && dim == 2)
    emi_fill_kernel<T, 3, 2><<<blocks_for(nc), kThreads, 0, s>>>(
        cells, pos, slot_ptr, gt, wt, vt, nc);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int drift_fill_t(const int* cells, const uint8_t* pos, const int* slot_ptr,
                 const void* grads, const void* vols, const void* w,
                 void* vals, int nc, int k, int dim, cudaStream_t s) {
  const T* gt = static_cast<const T*>(grads);
  const T* vo = static_cast<const T*>(vols);
  const T* wt = static_cast<const T*>(w);
  T* vt = static_cast<T*>(vals);
  if (k == 4 && dim == 3)
    drift_fill_kernel<T, 4, 3><<<blocks_for(nc), kThreads, 0, s>>>(
        cells, pos, slot_ptr, gt, vo, wt, vt, nc);
  else if (k == 3 && dim == 2)
    drift_fill_kernel<T, 3, 2><<<blocks_for(nc), kThreads, 0, s>>>(
        cells, pos, slot_ptr, gt, vo, wt, vt, nc);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  Each entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().
// K1 / K11 apply: v2 == NULL applies one value stream; a and b arrive
// as doubles and are cast to the vector type.
int knp_p1_apply(int dtype, const int* slot_ptr, const int* col,
                 const void* v1, const void* v2, const void* x, void* y,
                 double a, double b, int n, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? p1_apply_t<float>(slot_ptr, col, v1, v2, x, y, a, b, n, s)
             : p1_apply_t<double>(slot_ptr, col, v1, v2, x, y, a, b, n, s);
}

// K3: Y (nb, n) for nb <= 8 ions; vk == vd == NULL is the mass-only
// apply.
int knp_p1_apply_batch(int dtype, const int* slot_ptr, const int* col,
                       const void* vm, const void* vk, const void* vd,
                       const void* coef, const void* X, void* Y, int n, int nb,
                       void* stream) {
  if (n == 0 || nb == 0) return 0;
  if ((vk == nullptr) != (vd == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? p1_apply_batch_t<float>(slot_ptr, col, vm, vk, vd, coef,
                                              X, Y, n, nb, s)
                    : p1_apply_batch_t<double>(slot_ptr, col, vm, vk, vd, coef,
                                               X, Y, n, nb, s);
}

// K1f into a zeroed vals.
int knp_emi_fill(int dtype, const int* cells, const uint8_t* pos,
                 const int* slot_ptr, const void* grads, const void* wv,
                 void* vals, int nc, int k, int dim, void* stream) {
  if (nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? emi_fill_t<float>(cells, pos, slot_ptr, grads, wv,
                                        vals, nc, k, dim, s)
                    : emi_fill_t<double>(cells, pos, slot_ptr, grads, wv,
                                         vals, nc, k, dim, s);
}

// K11f into a zeroed vals.
int knp_drift_fill(int dtype, const int* cells, const uint8_t* pos,
                   const int* slot_ptr, const void* grads, const void* vols,
                   const void* w, void* vals, int nc, int k, int dim,
                   void* stream) {
  if (nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? drift_fill_t<float>(cells, pos, slot_ptr, grads, vols,
                                          w, vals, nc, k, dim, s)
                    : drift_fill_t<double>(cells, pos, slot_ptr, grads, vols,
                                           w, vals, nc, k, dim, s);
}

int knp_ell_matvec(int dtype, const int* cols, const void* vals,
                   const void* x, void* y, int R, int K, void* stream) {
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    ell_matvec_kernel<float><<<blocks_for(R), kThreads, 0, s>>>(
        cols, static_cast<const float*>(vals), static_cast<const float*>(x),
        static_cast<float*>(y), R, K);
  else
    ell_matvec_kernel<double><<<blocks_for(R), kThreads, 0, s>>>(
        cols, static_cast<const double*>(vals),
        static_cast<const double*>(x), static_cast<double*>(y), R, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
