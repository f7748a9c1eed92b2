// Multigrid V-cycle kernels for Hopper (sm_90a): K5, K6a, K6b (sparse
// operators in ELL form, for one vector and for B vectors) and K7, K8
// (block-banded dense slabs).  Plain C interface, loaded with ctypes by
// knpemi_tpu_torch/ops/ell.py and ops/banded.py, which hold the plain
// PyTorch version of each kernel, the input checks and the launch
// counters.
//
// They replace the TPU kernels of knpemi_tpu/ops/pallas_ell.py and
// pallas_banded.py.  Those gather and scatter through one-hot matrix
// products over per-chunk windows, split float32 into bf16 passes and
// align every start to the (8, 128) tiling; here a gather is a load and
// a scatter an atomicAdd, exact in the vector's type, and no alignment
// is asked of the layout.  All five are bound by the bytes they move:
// the ELL kernels by indices + values, the banded kernels by the slab.
// Sums taken with atomics (K5, K6b) are order-dependent, so those agree
// with the plain version to a few ulps of max|y|, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // window columns staged in shared memory

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T>
__device__ __forceinline__ T upcast(T v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------
// ELL: cols, vals are (R, K) row-major; padded slots carry value 0.
// ---------------------------------------------------------------------

// K6a: Y[b, r] = sum_k vals[r, k] X[b, cols[r, k]]; one thread per row,
// its indices and values read once for all B vectors.
template <typename T, int B>
__global__ void ell_matvec_batch_kernel(const int* __restrict__ cols,
                                        const T* __restrict__ vals,
                                        const T* __restrict__ X,
                                        T* __restrict__ Y, int R, int K,
                                        int m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t base = static_cast<int64_t>(r) * K;
  T acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = T(0);
  for (int k = 0; k < K; ++k) {
    const T v = vals[base + k];
    const int c = cols[base + k];
#pragma unroll
    for (int b = 0; b < B; ++b)
      acc[b] += v * X[static_cast<int64_t>(b) * m + c];
  }
#pragma unroll
  for (int b = 0; b < B; ++b) Y[static_cast<int64_t>(b) * R + r] = acc[b];
}

// K5 (B = 1) and K6b: Y[b, cols[r, k]] += vals[r, k] Rv[b, r] into a
// zeroed Y; one thread per row holds its B values of Rv.  Padded slots
// are skipped: they all name one column.
template <typename T, int B>
__global__ void ell_rmatvec_batch_kernel(const int* __restrict__ cols,
                                         const T* __restrict__ vals,
                                         const T* __restrict__ Rv,
                                         T* __restrict__ Y, int R, int K,
                                         int m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t base = static_cast<int64_t>(r) * K;
  T rv[B];
#pragma unroll
  for (int b = 0; b < B; ++b) rv[b] = Rv[static_cast<int64_t>(b) * R + r];
  for (int k = 0; k < K; ++k) {
    const T v = vals[base + k];
    if (v == T(0)) continue;
    const int c = cols[base + k];
#pragma unroll
    for (int b = 0; b < B; ++b)
      atomicAdd(&Y[static_cast<int64_t>(b) * m + c], v * rv[b]);
  }
}

// ---------------------------------------------------------------------
// Block-banded slabs: slabT[(blk*W + w), r] = A[blk*Rb + r, w0[blk] + w].
// ---------------------------------------------------------------------

// K7 (B = 1) and K8: one CTA per row block, thread r owns row r of the
// block.  The windows X[b, w0 .. w0+W) (zero beyond m) of all B vectors
// are staged in shared memory kTile columns at a time; every slab value
// is read once, coalesced over r, upcast and used for all B vectors.
template <typename S, typename T, int B>
__global__ void banded_matvec_kernel(const S* __restrict__ slabT,
                                     const int* __restrict__ w0,
                                     const T* __restrict__ X,
                                     T* __restrict__ Y, int Rb, int W,
                                     int n, int m) {
  __shared__ T xs[B * kTile];
  const int blk = blockIdx.x;
  const int r = threadIdx.x;
  const int64_t start = w0[blk];
  const S* slab = slabT + static_cast<int64_t>(blk) * W * Rb + r;
  T acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = T(0);
  for (int t0 = 0; t0 < W; t0 += kTile) {
    const int tw = min(kTile, W - t0);
    for (int i = r; i < B * tw; i += Rb) {
      const int b = i / tw;
      const int w = i - b * tw;
      const int64_t c = start + t0 + w;
      xs[b * kTile + w] =
          (c >= 0 && c < m) ? X[static_cast<int64_t>(b) * m + c] : T(0);
    }
    __syncthreads();
#pragma unroll 8
    for (int w = 0; w < tw; ++w) {
      const T s = static_cast<T>(upcast(slab[static_cast<int64_t>(t0 + w) * Rb]));
#pragma unroll
      for (int b = 0; b < B; ++b) acc[b] += s * xs[b * kTile + w];
    }
    __syncthreads();
  }
  const int64_t row = static_cast<int64_t>(blk) * Rb + r;
  if (row < n) {
#pragma unroll
    for (int b = 0; b < B; ++b) Y[static_cast<int64_t>(b) * n + row] = acc[b];
  }
}

// Launchers: pick the instantiation for a batch of nb vectors.
#define KNP_FOR_BATCH(nb, M)    \
  switch (nb) {                 \
    case 1: M(1); break;        \
    case 2: M(2); break;        \
    case 3: M(3); break;        \
    case 4: M(4); break;        \
    case 5: M(5); break;        \
    case 6: M(6); break;        \
    case 7: M(7); break;        \
    case 8: M(8); break;        \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T>
int ell_matvec_batch_t(const int* cols, const void* vals, const void* X,
                       void* Y, int R, int K, int m, int nb, cudaStream_t s) {
#define CALL(BB)                                                          \
  ell_matvec_batch_kernel<T, BB><<<blocks_for(R), kThreads, 0, s>>>(      \
      cols, static_cast<const T*>(vals), static_cast<const T*>(X),        \
      static_cast<T*>(Y), R, K, m)
  KNP_FOR_BATCH(nb, CALL)
#undef CALL
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ell_rmatvec_batch_t(const int* cols, const void* vals, const void* Rv,
                        void* Y, int R, int K, int m, int nb, cudaStream_t s) {
#define CALL(BB)                                                          \
  ell_rmatvec_batch_kernel<T, BB><<<blocks_for(R), kThreads, 0, s>>>(     \
      cols, static_cast<const T*>(vals), static_cast<const T*>(Rv),       \
      static_cast<T*>(Y), R, K, m)
  KNP_FOR_BATCH(nb, CALL)
#undef CALL
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename T>
int banded_matvec_t(const void* slabT, const int* w0, const void* X, void* Y,
                    int NB, int Rb, int W, int n, int m, int nb,
                    cudaStream_t s) {
#define CALL(BB)                                                          \
  banded_matvec_kernel<S, T, BB><<<NB, Rb, 0, s>>>(                       \
      static_cast<const S*>(slabT), w0, static_cast<const T*>(X),         \
      static_cast<T*>(Y), Rb, W, n, m)
  KNP_FOR_BATCH(nb, CALL)
#undef CALL
  return static_cast<int>(cudaGetLastError());
}

// dtype: vector type, 0 = float32, 1 = float64.  slab: slab storage type,
// 0 = float32, 1 = float64, 2 = bfloat16 (with either vector type).
int banded_dispatch(int dtype, int slab, const void* slabT, const int* w0,
                    const void* X, void* Y, int NB, int Rb, int W, int n,
                    int m, int nb, cudaStream_t s) {
  if (NB == 0 || nb == 0) return 0;
  if (Rb <= 0 || Rb > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && slab == 0)
    return banded_matvec_t<float, float>(slabT, w0, X, Y, NB, Rb, W, n, m, nb, s);
  if (dtype == 0 && slab == 2)
    return banded_matvec_t<__nv_bfloat16, float>(slabT, w0, X, Y, NB, Rb, W, n, m, nb, s);
  if (dtype == 1 && slab == 1)
    return banded_matvec_t<double, double>(slabT, w0, X, Y, NB, Rb, W, n, m, nb, s);
  if (dtype == 1 && slab == 2)
    return banded_matvec_t<__nv_bfloat16, double>(slabT, w0, X, Y, NB, Rb, W, n, m, nb, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  Each entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

// K5: y (m,) += A^T r; y must be zeroed by the caller.
int knp_ell_rmatvec(int dtype, const int* cols, const void* vals,
                    const void* r, void* y, int R, int K, void* stream) {
  if (R == 0 || K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the output's length is not needed for one vector: pass 0 as its stride
  return dtype == 0
             ? ell_rmatvec_batch_t<float>(cols, vals, r, y, R, K, 0, 1, s)
             : ell_rmatvec_batch_t<double>(cols, vals, r, y, R, K, 0, 1, s);
}

// K6a: Y (nb, R) = X (nb, m) A^T, nb <= 8.
int knp_ell_matvec_batch(int dtype, const int* cols, const void* vals,
                         const void* X, void* Y, int R, int K, int m, int nb,
                         void* stream) {
  if (R == 0 || nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? ell_matvec_batch_t<float>(cols, vals, X, Y, R, K, m, nb, s)
             : ell_matvec_batch_t<double>(cols, vals, X, Y, R, K, m, nb, s);
}

// K6b: Y (nb, m) += Rv (nb, R) A, nb <= 8; Y must be zeroed by the caller.
int knp_ell_rmatvec_batch(int dtype, const int* cols, const void* vals,
                          const void* Rv, void* Y, int R, int K, int m,
                          int nb, void* stream) {
  if (R == 0 || K == 0 || nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? ell_rmatvec_batch_t<float>(cols, vals, Rv, Y, R, K, m, nb, s)
             : ell_rmatvec_batch_t<double>(cols, vals, Rv, Y, R, K, m, nb, s);
}

// K7: y (n,) = one window of a block-banded operator times x (m,).
int knp_banded_matvec(int dtype, int slab, const void* slabT, const int* w0,
                      const void* x, void* y, int NB, int Rb, int W, int n,
                      int m, void* stream) {
  return banded_dispatch(dtype, slab, slabT, w0, x, y, NB, Rb, W, n, m, 1,
                         static_cast<cudaStream_t>(stream));
}

// K8: Y (nb, n) = the same window times X (nb, m), nb <= 8.
int knp_banded_matvec_batch(int dtype, int slab, const void* slabT,
                            const int* w0, const void* X, void* Y, int NB,
                            int Rb, int W, int n, int m, int nb,
                            void* stream) {
  return banded_dispatch(dtype, slab, slabT, w0, X, Y, NB, Rb, W, n, m, nb,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
