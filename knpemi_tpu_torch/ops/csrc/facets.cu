// Membrane-facet assembly kernels for Hopper (sm_90a): K2 (P1 surface
// mass in membrane numbering), K9 (facet gather of F membrane fields)
// and K10 (facet scatter-add of F channels).  Plain C interface, loaded
// with ctypes by knpemi_tpu_torch/ops/assembly.py.
//
// They replace the TPU kernels of knpemi_tpu/ops/pallas_assembly.py
// (_make_facet_mass_kernel, _make_facet_gather_kernel,
// _make_facet_scatter_kernel), which gather through one-hot MXU products
// because random gathers are slow there.  Here gathers are exact loads
// and the scatters are atomic adds; every kernel is bound by the bytes
// it moves.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

// K2: y[v_i] += wv_f (sum_j x_j + x_i), wv_f = area_f / (K(K+1)).
template <typename T, int K>
__global__ void facet_mass_kernel(const T* __restrict__ x,
                                  const int* __restrict__ fd,
                                  const T* __restrict__ wv,
                                  T* __restrict__ y, int nf) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= nf) return;
  int v[K];
  T xe[K];
  T xs = T(0);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    v[i] = fd[static_cast<int64_t>(f) * K + i];
    xe[i] = x[v[i]];
    xs += xe[i];
  }
  const T w = wv[f];
#pragma unroll
  for (int i = 0; i < K; ++i) atomicAdd(&y[v[i]], w * (xs + xe[i]));
}

// K9: G[c, f, j] = X[c, fd[f, j]] over F channels c.
template <typename T>
__global__ void facet_gather_kernel(const T* __restrict__ X,
                                    const int* __restrict__ fd,
                                    T* __restrict__ G, int64_t total,
                                    int64_t slots, int n_mem) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int64_t ch = idx / slots;
  const int64_t e = idx - ch * slots;
  G[idx] = X[ch * n_mem + fd[e]];
}

// K10: Y[c, fd[f, j]] += V[c, f, j] over F channels c.
template <typename T>
__global__ void facet_scatter_kernel(const T* __restrict__ V,
                                     const int* __restrict__ fd,
                                     T* __restrict__ Y, int64_t total,
                                     int64_t slots, int n_mem) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int64_t ch = idx / slots;
  const int64_t e = idx - ch * slots;
  atomicAdd(&Y[ch * n_mem + fd[e]], V[idx]);
}

template <typename T>
int facet_mass_t(const void* x, const int* fd, const void* wv, void* y,
                 int nf, int k, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(wv);
  T* yt = static_cast<T*>(y);
  if (k == 3)
    facet_mass_kernel<T, 3><<<blocks_for(nf), kThreads, 0, s>>>(xt, fd, wt,
                                                                 yt, nf);
  else if (k == 2)
    facet_mass_kernel<T, 2><<<blocks_for(nf), kThreads, 0, s>>>(xt, fd, wt,
                                                                 yt, nf);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  Each entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().
int knp_facet_mass(int dtype, const void* x, const int* fd, const void* wv,
                   void* y, int nf, int k, void* stream) {
  if (nf == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? facet_mass_t<float>(x, fd, wv, y, nf, k, s)
                    : facet_mass_t<double>(x, fd, wv, y, nf, k, s);
}

int knp_facet_gather(int dtype, const void* X, const int* fd, void* G,
                     int F, int nf, int k, int n_mem, void* stream) {
  const int64_t slots = static_cast<int64_t>(nf) * k;
  const int64_t total = slots * F;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    facet_gather_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(X), fd, static_cast<float*>(G), total,
        slots, n_mem);
  else
    facet_gather_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const double*>(X), fd, static_cast<double*>(G), total,
        slots, n_mem);
  return static_cast<int>(cudaGetLastError());
}

int knp_facet_scatter(int dtype, const void* V, const int* fd, void* Y,
                      int F, int nf, int k, int n_mem, void* stream) {
  const int64_t slots = static_cast<int64_t>(nf) * k;
  const int64_t total = slots * F;
  if (total == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    facet_scatter_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(V), fd, static_cast<float*>(Y), total,
        slots, n_mem);
  else
    facet_scatter_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const double*>(V), fd, static_cast<double*>(Y), total,
        slots, n_mem);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
