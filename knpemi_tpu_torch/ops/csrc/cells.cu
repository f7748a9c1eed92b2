// Cell-loop assembly kernels for Hopper (sm_90a): K1 (EMI weighted
// stiffness), K3 (batched KNP operator), K11 (KNP operator of one ion)
// and K4 (ELL SpMV of the frozen dof -> cell coefficient maps).  Plain C interface, loaded with ctypes
// by knpemi_tpu_torch/ops/assembly.py, which holds the plain PyTorch
// version of each kernel, the input checks and the launch counters.
//
// All four replace TPU kernels whose one-hot MXU factoring exists only
// because random gathers are slow on the TPU
// (knpemi_tpu/ops/pallas_assembly.py, pallas_ell.py).  Here every gather
// is exact: one thread per cell (or row) reads its k vertex values, does
// a few dozen flops in registers and atomically adds k results.  The
// kernels are bound by the bytes they move; sums taken with atomics are
// order-dependent, so results agree with the plain version to a few
// ulps of max|y|, not bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// K1: y[v_i] += wv_c * g_i . (sum_j g_j x_j) for every cell c.
template <typename T, int K, int D>
__global__ void emi_stiffness_kernel(const T* __restrict__ x,
                                     const int* __restrict__ cells,
                                     const T* __restrict__ grads,
                                     const T* __restrict__ wv,
                                     T* __restrict__ y, int nc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  int v[K];
  T g[K][D];
  T gx[D];
#pragma unroll
  for (int d = 0; d < D; ++d) gx[d] = T(0);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = cells[static_cast<int64_t>(c) * K + i];
    const T xi = x[v[i]];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      g[i][d] = grads[(static_cast<int64_t>(c) * K + i) * D + d];
      gx[d] += xi * g[i][d];
    }
  }
  const T w = wv[c];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    T s = T(0);
#pragma unroll
    for (int d = 0; d < D; ++d) s += gx[d] * g[i][d];
    atomicAdd(&y[v[i]], s * w);
  }
}

// K3: for every ion row b,
//   y_b[v_i] += dt_inv_b vol/(K(K+1)) (sum_j x_j + x_i)
//             + D_b vol g_i . (sum_j g_j x_j)
//             + zpsiD_b vol (sum_j x_j / K) (w_c . g_i)
// with the cell's geometry and grad(phi) read once for all B rows.
template <typename T, int K, int D>
__global__ void knp_apply_batch_kernel(const T* __restrict__ X,
                                       const int* __restrict__ cells,
                                       const T* __restrict__ grads,
                                       const T* __restrict__ vols,
                                       const T* __restrict__ w,
                                       const T* __restrict__ coef,
                                       T* __restrict__ Y, int nc, int n,
                                       int B) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  int v[K];
  T g[K][D];
  T wg[K];
  T wc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) wc[d] = w[static_cast<int64_t>(c) * D + d];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = cells[static_cast<int64_t>(c) * K + i];
    wg[i] = T(0);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      g[i][d] = grads[(static_cast<int64_t>(c) * K + i) * D + d];
      wg[i] += wc[d] * g[i][d];
    }
  }
  const T vol = vols[c];
  const T mw = vol / T(K * (K + 1));
  for (int b = 0; b < B; ++b) {
    const T* x = X + static_cast<int64_t>(b) * n;
    T* y = Y + static_cast<int64_t>(b) * n;
    const T dt_inv = coef[3 * b];
    const T Dk = coef[3 * b + 1];
    const T zpsiD = coef[3 * b + 2];
    T xe[K];
    T xsum = T(0);
    T gx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) gx[d] = T(0);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      xe[i] = x[v[i]];
      xsum += xe[i];
#pragma unroll
      for (int d = 0; d < D; ++d) gx[d] += xe[i] * g[i][d];
    }
    const T xbar = xsum / T(K);
#pragma unroll
    for (int i = 0; i < K; ++i) {
      T s = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) s += gx[d] * g[i][d];
      const T ye = dt_inv * (mw * (xsum + xe[i])) + (Dk * vol) * s +
                   (zpsiD * vol) * (xbar * wg[i]);
      atomicAdd(&y[v[i]], ye);
    }
  }
}

// K11: K3's operator for ONE ion,
//   y[v_i] += dt_inv vol/(K(K+1)) (sum_j x_j + x_i)
//           + Dk vol g_i . (sum_j g_j x_j)
//           + zpsiD vol (sum_j x_j / K) (w_c . g_i),
// with the ion's three scalars as kernel arguments (the TPU kernel keeps
// them in SMEM): the per-ion solve passes each ion's own numbers with no
// coefficient tensor to fill or read.  Replaces
// knpemi_tpu/ops/pallas_assembly.py:_make_knp_kernel.  Bound by bytes: x,
// cells, grads, vols, w read once, y written once.
template <typename T, int K, int D>
__global__ void knp_apply_kernel(const T* __restrict__ x,
                                 const int* __restrict__ cells,
                                 const T* __restrict__ grads,
                                 const T* __restrict__ vols,
                                 const T* __restrict__ w,
                                 T* __restrict__ y, int nc, T dt_inv, T Dk,
                                 T zpsiD) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  int v[K];
  T g[K][D];
  T xe[K];
  T gx[D];
  T wc[D];
  T xsum = T(0);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    gx[d] = T(0);
    wc[d] = w[static_cast<int64_t>(c) * D + d];
  }
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = cells[static_cast<int64_t>(c) * K + i];
    xe[i] = x[v[i]];
    xsum += xe[i];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      g[i][d] = grads[(static_cast<int64_t>(c) * K + i) * D + d];
      gx[d] += xe[i] * g[i][d];
    }
  }
  const T vol = vols[c];
  const T mw = vol / T(K * (K + 1));
  const T xbar = xsum / T(K);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    T s = T(0);
    T wg = T(0);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      s += gx[d] * g[i][d];
      wg += wc[d] * g[i][d];
    }
    const T ye = dt_inv * (mw * (xsum + xe[i])) + (Dk * vol) * s +
                 (zpsiD * vol) * (xbar * wg);
    atomicAdd(&y[v[i]], ye);
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
int emi_stiffness_t(const void* x, const int* cells, const void* grads,
                    const void* wv, void* y, int nc, int k, int dim,
                    cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(grads);
  const T* wt = static_cast<const T*>(wv);
  T* yt = static_cast<T*>(y);
  if (k == 4 && dim == 3)
    emi_stiffness_kernel<T, 4, 3>
        <<<blocks_for(nc), kThreads, 0, s>>>(xt, cells, gt, wt, yt, nc);
  else if (k == 3 && dim == 2)
    emi_stiffness_kernel<T, 3, 2>
        <<<blocks_for(nc), kThreads, 0, s>>>(xt, cells, gt, wt, yt, nc);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int knp_apply_batch_t(const void* X, const int* cells, const void* grads,
                      const void* vols, const void* w, const void* coef,
                      void* Y, int nc, int n, int B, int k, int dim,
                      cudaStream_t s) {
  const T* Xt = static_cast<const T*>(X);
  const T* gt = static_cast<const T*>(grads);
  const T* vt = static_cast<const T*>(vols);
  const T* wt = static_cast<const T*>(w);
  const T* ct = static_cast<const T*>(coef);
  T* Yt = static_cast<T*>(Y);
  if (k == 4 && dim == 3)
    knp_apply_batch_kernel<T, 4, 3><<<blocks_for(nc), kThreads, 0, s>>>(
        Xt, cells, gt, vt, wt, ct, Yt, nc, n, B);
  else if (k == 3 && dim == 2)
    knp_apply_batch_kernel<T, 3, 2><<<blocks_for(nc), kThreads, 0, s>>>(
        Xt, cells, gt, vt, wt, ct, Yt, nc, n, B);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int knp_apply_t(const void* x, const int* cells, const void* grads,
                const void* vols, const void* w, void* y, double dt_inv,
                double D, double zpsiD, int nc, int k, int dim,
                cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(grads);
  const T* vt = static_cast<const T*>(vols);
  const T* wt = static_cast<const T*>(w);
  T* yt = static_cast<T*>(y);
  const T a = static_cast<T>(dt_inv);
  const T b = static_cast<T>(D);
  const T c = static_cast<T>(zpsiD);
  if (k == 4 && dim == 3)
    knp_apply_kernel<T, 4, 3><<<blocks_for(nc), kThreads, 0, s>>>(
        xt, cells, gt, vt, wt, yt, nc, a, b, c);
  else if (k == 3 && dim == 2)
    knp_apply_kernel<T, 3, 2><<<blocks_for(nc), kThreads, 0, s>>>(
        xt, cells, gt, vt, wt, yt, nc, a, b, c);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  Each entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().
int knp_emi_stiffness(int dtype, const void* x, const int* cells,
                      const void* grads, const void* wv, void* y, int nc,
                      int k, int dim, void* stream) {
  if (nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? emi_stiffness_t<float>(x, cells, grads, wv, y, nc, k, dim, s)
             : emi_stiffness_t<double>(x, cells, grads, wv, y, nc, k, dim, s);
}

int knp_knp_apply_batch(int dtype, const void* X, const int* cells,
                        const void* grads, const void* vols, const void* w,
                        const void* coef, void* Y, int nc, int n, int B,
                        int k, int dim, void* stream) {
  if (nc == 0 || B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? knp_apply_batch_t<float>(X, cells, grads, vols, w,
                                               coef, Y, nc, n, B, k, dim, s)
                    : knp_apply_batch_t<double>(X, cells, grads, vols, w,
                                                coef, Y, nc, n, B, k, dim, s);
}

// The scalars arrive as doubles and are cast to the vector type.
int knp_knp_apply(int dtype, const void* x, const int* cells,
                  const void* grads, const void* vols, const void* w,
                  void* y, double dt_inv, double D, double zpsiD, int nc,
                  int k, int dim, void* stream) {
  if (nc == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? knp_apply_t<float>(x, cells, grads, vols, w, y, dt_inv,
                                         D, zpsiD, nc, k, dim, s)
                    : knp_apply_t<double>(x, cells, grads, vols, w, y, dt_inv,
                                          D, zpsiD, nc, k, dim, s);
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
