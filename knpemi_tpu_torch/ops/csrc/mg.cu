// Multigrid V-cycle kernels for Hopper (sm_90a): K4 and K6a (the gather
// y = A x from the sliced form of a windowed-ELL operator, for one
// vector and for B vectors; K4 also applies the step's coefficient
// maps), K5, K6b (the restriction y = A^T r, for one vector and for B
// vectors, gathered from the CSR of A^T) and K7, K8 (block-banded
// operators, read as the packed nonzeros of their slabs).  Plain C
// interface, loaded with ctypes by knpemi_tpu_torch/ops/ell.py and
// ops/banded.py, which hold the plain PyTorch version of each kernel,
// the input checks and the launch counters.
//
// They replace the TPU kernels of knpemi_tpu/ops/pallas_ell.py and
// pallas_banded.py.  Those gather and scatter through one-hot matrix
// products over per-chunk windows, split float32 into bf16 passes and
// align every start to the (8, 128) tiling; here a gather is a load,
// exact in the vector's type, a scatter is turned into a gather from the
// transposed operator, and no alignment is asked of the layout.  All
// six are bound by the bytes they move: the ELL kernels by indices +
// values, the banded kernels by the nonzeros of the slabs.  None uses
// atomics: each output element is summed by one thread (or, in K5/K6b,
// one group of lanes) in a fixed order and stored once, so a launch
// gives the same bits every time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

inline unsigned int blocks_for(int64_t n) {
  return static_cast<unsigned int>((n + kThreads - 1) / kThreads);
}

template <typename T>
__device__ __forceinline__ T upcast(T v) { return v; }
__device__ __forceinline__ float upcast(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---------------------------------------------------------------------
// Block-banded operators, packed (ops/banded.py::pack_window).  Row
// i = blk*R + r of one window is y[i] = sum_w slab[i, w] x[w0[blk] + w];
// the packed form keeps only the slab's nonzeros, as a sliced ELL: slice
// s (rows 32s .. 32s+31) owns slots slot_ptr[s] .. slot_ptr[s+1], slot k
// of its row l at slot_ptr[s] + 32k + l, each an offset w (uint16) and a
// value (padding: value 0 at offset 0), in the row's column order.
//
// K7 (B = 1) and K8 replace _banded_mv_call (pallas_banded.py:38) and
// _banded_mv_call_batch (:89).  The TPU kernel streams the dense slab
// through its matrix unit; the slabs are a few percent nonzero, so on
// the H100 the least time is set by the nonzeros: a value and a 2-byte
// offset each, plus w0, x and y once (the padding slots come on top;
// chip_smoke.py prints them beside each bound).
// Design:
// * one warp per 32-row slice; slot k of its 32 rows is one coalesced
//   load of values and one of offsets; kUnroll slots are in flight per
//   thread: the bytes in flight, not the number of CTAs, decide how
//   close the kernel comes to the memory rate (chosen on the card
//   among 2-16 slices per CTA and 2-16 slots in flight);
// * kBandWarps slices per CTA, any R that is a multiple of 32: a CTA
//   covers a 256-row block, or part of a larger one;
// * the window x[w0 .. w0+W) of all B vectors (zero beyond m) is copied
//   into shared memory with cp.async (16 bytes where aligned) while the
//   first slots load ("staged", where B*W values fit in kStageMax
//   bytes), or each x value is read through the read-only path from L2
//   ("l2");
// * each row sums its slots in column order with fused multiply-adds,
//   as a dense-slab kernel does over the full slab row: fma(0, x, acc) =
//   acc, so both give the same bits on finite inputs.
// ---------------------------------------------------------------------

constexpr int kBandWarps = 8;             // 32-row slices per CTA
constexpr int kUnroll = 8;                // slots in flight per thread
constexpr int kStageMax = 112 << 10;      // two staged CTAs per SM

__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename S>
__device__ __forceinline__ S zero_of() { return S(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// cp.async of N bytes (4, 8 or 16) from global to shared memory; the
// bytes past src_bytes are filled with zeros.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(N), "r"(src_bytes)
               : "memory");
}

// xs[0 .. W) = x[start .. start+W), zero from m on; by the whole CTA.
template <typename T>
__device__ __forceinline__ void stage_window(T* xs, const T* x,
                                             int64_t start, int W, int m) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));
  const T* src = x + start;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && W % V == 0) {
    for (int i = threadIdx.x * V; i < W; i += blockDim.x * V) {
      const int64_t left = m - (start + i);
      const int nv = left <= 0 ? 0 : (left >= V ? V : static_cast<int>(left));
      cp_async<16>(xs + i, nv ? src + i : src, nv * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
      const bool in = start + i < m;
      cp_async<static_cast<int>(sizeof(T))>(xs + i, in ? src + i : x,
                          in ? static_cast<int>(sizeof(T)) : 0);
    }
  }
}

template <typename S, typename T, int B, bool STAGE>
__global__ void __launch_bounds__(kBandWarps * 32)
banded_packed_kernel(const int* __restrict__ slot_ptr,
                     const uint16_t* __restrict__ off,
                     const S* __restrict__ val, const int* __restrict__ w0,
                     const T* __restrict__ X, T* __restrict__ Y, int R,
                     int W, int n, int m, int ctas_per_block) {
  extern __shared__ __align__(16) unsigned char band_smem[];
  T* xs = reinterpret_cast<T*>(band_smem);
  const int blk = static_cast<int>(blockIdx.x) / ctas_per_block;
  const int lane = threadIdx.x & 31;
  // this warp's slice within the block; warps past the block's last
  // slice only help to stage the window
  const int ls =
      (static_cast<int>(blockIdx.x) - blk * ctas_per_block) * kBandWarps +
      static_cast<int>(threadIdx.x >> 5);
  const bool live = ls < R / 32;
  const int64_t start = w0[blk];
  if (STAGE) {
#pragma unroll
    for (int b = 0; b < B; ++b)
      stage_window(xs + b * W, X + static_cast<int64_t>(b) * m, start, W, m);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int64_t p = 0;
  int K = 0;
  if (live) {
    const int s = blk * (R / 32) + ls;
    p = slot_ptr[s] + lane;
    K = (slot_ptr[s + 1] - slot_ptr[s]) >> 5;
  }
  // the first kUnroll slots load while the window arrives
  S v[kUnroll];
  unsigned o[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    v[u] = u < K ? val[p + 32 * u] : zero_of<S>();
    o[u] = u < K ? off[p + 32 * u] : 0u;
  }
  if (STAGE) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  T acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = T(0);
  for (int k0 = 0; k0 < K; k0 += kUnroll) {
    S vn[kUnroll];
    unsigned on[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int k = k0 + kUnroll + u;
      vn[u] = k < K ? val[p + 32 * static_cast<int64_t>(k)] : zero_of<S>();
      on[u] = k < K ? off[p + 32 * static_cast<int64_t>(k)] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u < K) {
        const T a = static_cast<T>(upcast(v[u]));
#pragma unroll
        for (int b = 0; b < B; ++b) {
          T xv;
          if (STAGE) {
            xv = xs[b * W + o[u]];
          } else {
            const int64_t c = start + o[u];
            xv = c < m ? __ldg(X + static_cast<int64_t>(b) * m + c) : T(0);
          }
          acc[b] = fma_t(a, xv, acc[b]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = vn[u];
      o[u] = on[u];
    }
  }
  const int64_t row = static_cast<int64_t>(blk) * R + ls * 32 + lane;
  if (live && row < n) {
#pragma unroll
    for (int b = 0; b < B; ++b) Y[static_cast<int64_t>(b) * n + row] = acc[b];
  }
}

// ---------------------------------------------------------------------
// K6a: Y[b, r] = sum over the slots s of row r of val[s] X[b, col[s]],
// for B <= 8 vectors that share one windowed-ELL operator, read in its
// sliced form (ops/ell.py::sliced_ell): slice s (rows 32s .. 32s+31)
// owns slots slot_ptr[s] .. slot_ptr[s+1], slot k of its row l at
// slot_ptr[s] + 32k + l, each a global column (int32) and a value;
// padding slots hold value 0 at a valid column.
//
// Replaces _make_gather_kernel_batch (pallas_ell.py:476).  The TPU
// kernel gathers each chunk's window through one-hot products; a
// row-major ELL would read slot k of 32 rows K*4 bytes apart, padded to
// the widest row of the whole operator.  Here, as in K7/K8 and the P1
// operator's apply:
// * one warp per 32-row slice: slot k of its rows is one coalesced load
//   of columns and one of values, read once for all B vectors;
// * kEllInFlight slots' columns and values are loaded before their x,
//   so several loads are in flight per thread;
// * B accumulators per row, x through the read-only path (it lives in
//   L2), fused multiply-adds in slot order.
// Bound by bytes: a column and a value per nonzero, X and Y once.
// ---------------------------------------------------------------------
constexpr int kEllInFlight = 4;

template <typename T, int B>
__global__ void __launch_bounds__(kThreads)
sliced_matvec_batch_kernel(const int* __restrict__ slot_ptr,
                           const int* __restrict__ col,
                           const T* __restrict__ val,
                           const T* __restrict__ X, T* __restrict__ Y,
                           int R, int m) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int end = __ldg(slot_ptr + (r >> 5) + 1);
  T acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = T(0);
  for (int s0 = __ldg(slot_ptr + (r >> 5)) + (r & 31); s0 < end;
       s0 += kEllInFlight * 32) {
    int c[kEllInFlight];
    T v[kEllInFlight];
#pragma unroll
    for (int u = 0; u < kEllInFlight; ++u) {
      const int s = s0 + u * 32;
      const bool in = s < end;
      c[u] = in ? __ldg(col + s) : 0;
      v[u] = in ? __ldg(val + s) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kEllInFlight; ++u) {
#pragma unroll
      for (int b = 0; b < B; ++b) {
        acc[b] = fma_t(v[u], __ldg(X + static_cast<int64_t>(b) * m + c[u]),
                       acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < B; ++b) Y[static_cast<int64_t>(b) * R + r] = acc[b];
}

// ---------------------------------------------------------------------
// K4: y[r] = sum over the slots s of row r of val[s] x[col[s]], for one
// vector, from the same sliced form as K6a: a multigrid level operator,
// prolongator or A P product of a single-vector V-cycle, or a frozen
// dof -> cell coefficient map of the step.
//
// Replaces _make_gather_kernel (pallas_ell.py:330).  A row-major
// (R, K) form pads every row to K, the widest row rounded up to a power
// of two of at least 8 (2.26 slots a nonzero on the flagship's level-0
// P), and puts slot k of 32 rows K*4 bytes apart.  Here:
// * one warp per 32-row slice: slot k of its 32 rows is one coalesced
//   load of columns and one of values, padded only to the slice's
//   longest row;
// * kK4InFlight slots' columns and values are loaded, then their x
//   (read through the read-only path: it lives in L2), then summed;
//   eight in flight, and no x load for a slot past the slice's end
//   (chosen on the card among 4, 8 and 16 in flight, with and without
//   that guard; K6a's kernel at B = 1 is timed beside it: PERF.md);
// * one fused multiply-add per slot, in slot order; y stored once into
//   an unzeroed output.  No atomics, the same bits every launch.
// Bound by bytes: a column and a value per nonzero, x and y once.
// ---------------------------------------------------------------------
constexpr int kK4InFlight = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
sliced_matvec_kernel(const int* __restrict__ slot_ptr,
                     const int* __restrict__ col, const T* __restrict__ val,
                     const T* __restrict__ x, T* __restrict__ y, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int end = __ldg(slot_ptr + (r >> 5) + 1);
  T acc = T(0);
  for (int s0 = __ldg(slot_ptr + (r >> 5)) + (r & 31); s0 < end;
       s0 += kK4InFlight * 32) {
    int c[kK4InFlight];
    T v[kK4InFlight];
#pragma unroll
    for (int u = 0; u < kK4InFlight; ++u) {
      const int s = s0 + u * 32;
      const bool in = s < end;
      c[u] = in ? __ldg(col + s) : 0;
      v[u] = in ? __ldg(val + s) : T(0);
    }
    T xv[kK4InFlight];
#pragma unroll
    for (int u = 0; u < kK4InFlight; ++u)
      xv[u] = s0 + u * 32 < end ? __ldg(x + c[u]) : T(0);
#pragma unroll
    for (int u = 0; u < kK4InFlight; ++u) acc = fma_t(v[u], xv[u], acc);
  }
  y[r] = acc;
}

// ---------------------------------------------------------------------
// K5 (B = 1) and K6b: Y[b, r] = sum over the entries s of row r of A^T
// of val[s] X[b, col[s]], for B <= 8 vectors, from the CSR of A^T
// (ops/ell.py::transposed_csr): row r owns entries row_ptr[r] ..
// row_ptr[r+1], each a row of A (int32) and a value, in ascending order
// of that row.  For a multigrid transfer A = P, so this is the
// restriction, and P is frozen for the life of its hierarchy: the CSR
// is built once on the host, never refilled.
//
// Replaces _make_scatter_kernel (pallas_ell.py:347) and
// _make_scatter_kernel_batch (:494).  The TPU kernels scatter through
// one-hot products; a scatter on the H100 is an atomic add per nonzero
// into a zeroed Y, and the adds to one coarse dof (~30 of them on the
// flagship's prolongator) serialize in L2.  Here each output row is
// gathered instead:
// * G lanes own a row (G in {4, 8, 16, 32}, about a quarter of the mean
//   row length, chosen at upload): one thread a row would put only one
//   thread on every ~30 nonzeros, too few loads in flight to reach the
//   memory rate;
// * lane l takes entries l, l+G, l+2G, ..., kCsrInFlight of them loaded
//   before their X values, so that several loads are in flight; the
//   group's loads of columns and values are coalesced;
// * B sums a lane, X read through the read-only path (it lives in L2),
//   fused multiply-adds in the vector's type; the G partial sums are
//   reduced by __shfl_down_sync in a fixed tree, and lane 0 stores the
//   row: no atomics, no memset, the same bits from every launch.
// Bound by bytes: a column and a value per nonzero, X and Y once
// (row_ptr beside them).
//
// ADD = true is the far remainder of a block-banded operator
// (solvers/mg.py::_banded_mv): the entries its windows do not cover, as
// a CSR by row, Y += their product.  The JAX package adds them with a
// scatter; an atomic scatter on the H100 sums a row's entries in a
// varying order, and the banded step was not repeatable.  Here lane 0
// loads Y once and stores Y + the row's sum; rows without entries are
// not touched.  The order is fixed, so every launch gives the same
// bits; it is not the plain twin's (ops/ell.py::csr_add_plain, a row's
// entries in turn), which it matches to rounding.
// ---------------------------------------------------------------------
constexpr int kCsrInFlight = 4;

template <typename T, int B, int G, bool ADD>
__global__ void __launch_bounds__(kThreads)
csr_gather_batch_kernel(const int* __restrict__ row_ptr,
                        const int* __restrict__ col,
                        const T* __restrict__ val, const T* __restrict__ X,
                        T* __restrict__ Y, int R, int m) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t r = t / G;
  const int lane = static_cast<int>(t % G);
  T acc[B];
#pragma unroll
  for (int b = 0; b < B; ++b) acc[b] = T(0);
  bool live = false;  // the row has entries
  // every lane of the warp stays for the shuffles below, live row or not
  if (r < R) {
    const int begin = __ldg(row_ptr + r);
    const int end = __ldg(row_ptr + r + 1);
    live = begin < end;
    for (int s0 = begin + lane; s0 < end; s0 += kCsrInFlight * G) {
      int c[kCsrInFlight];
      T v[kCsrInFlight];
#pragma unroll
      for (int u = 0; u < kCsrInFlight; ++u) {
        const int s = s0 + u * G;
        const bool in = s < end;
        c[u] = in ? __ldg(col + s) : 0;
        v[u] = in ? __ldg(val + s) : T(0);
      }
#pragma unroll
      for (int u = 0; u < kCsrInFlight; ++u) {
        if (s0 + u * G < end) {
#pragma unroll
          for (int b = 0; b < B; ++b) {
            const T xv = __ldg(X + static_cast<int64_t>(b) * m + c[u]);
            acc[b] = fma_t(v[u], xv, acc[b]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int b = 0; b < B; ++b)
      acc[b] += __shfl_down_sync(0xffffffffu, acc[b], o, G);
  }
  if (r < R && lane == 0) {
    if (ADD) {
      if (live) {
#pragma unroll
        for (int b = 0; b < B; ++b) {
          T* y = Y + static_cast<int64_t>(b) * R + r;
          *y = *y + acc[b];
        }
      }
    } else {
#pragma unroll
      for (int b = 0; b < B; ++b) Y[static_cast<int64_t>(b) * R + r] = acc[b];
    }
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
int sliced_matvec_batch_t(const int* slot_ptr, const int* col,
                          const void* val, const void* X, void* Y, int R,
                          int m, int nb, cudaStream_t s) {
#define CALL(BB)                                                          \
  sliced_matvec_batch_kernel<T, BB><<<blocks_for(R), kThreads, 0, s>>>(   \
      slot_ptr, col, static_cast<const T*>(val), static_cast<const T*>(X), \
      static_cast<T*>(Y), R, m)
  KNP_FOR_BATCH(nb, CALL)
#undef CALL
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool ADD>
int csr_gather_launch(const int* row_ptr, const int* col, const void* val,
                      const void* X, void* Y, int R, int m, int nb,
                      cudaStream_t s) {
  const int64_t threads = static_cast<int64_t>(R) * G;
#define CALL(BB)                                                          \
  csr_gather_batch_kernel<T, BB, G, ADD><<<blocks_for(threads), kThreads, 0, s>>>( \
      row_ptr, col, static_cast<const T*>(val), static_cast<const T*>(X),  \
      static_cast<T*>(Y), R, m)
  KNP_FOR_BATCH(nb, CALL)
#undef CALL
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool ADD>
int csr_gather_t(const int* row_ptr, const int* col, const void* val,
                 const void* X, void* Y, int R, int m, int nb, int G,
                 cudaStream_t s) {
  switch (G) {
    case 4: return csr_gather_launch<T, 4, ADD>(row_ptr, col, val, X, Y, R, m, nb, s);
    case 8: return csr_gather_launch<T, 8, ADD>(row_ptr, col, val, X, Y, R, m, nb, s);
    case 16: return csr_gather_launch<T, 16, ADD>(row_ptr, col, val, X, Y, R, m, nb, s);
    case 32: return csr_gather_launch<T, 32, ADD>(row_ptr, col, val, X, Y, R, m, nb, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename T, int B, bool STAGE>
int banded_launch(const int* slot_ptr, const void* off, const void* val,
                  const int* w0, const void* X, void* Y, int NB, int R,
                  int W, int n, int m, cudaStream_t s) {
  auto kern = banded_packed_kernel<S, T, B, STAGE>;
  const size_t smem = STAGE ? static_cast<size_t>(B) * W * sizeof(T) : 0;
  if (smem > (48 << 10)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kStageMax);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int cpb = (R / 32 + kBandWarps - 1) / kBandWarps;
  kern<<<static_cast<unsigned int>(NB) * cpb, kBandWarps * 32, smem, s>>>(
      slot_ptr, static_cast<const uint16_t*>(off), static_cast<const S*>(val),
      w0, static_cast<const T*>(X), static_cast<T*>(Y), R, W, n, m, cpb);
  return static_cast<int>(cudaGetLastError());
}

// route: 0 = staged where the B windows fit in kStageMax bytes, else l2;
// 1 = staged (refused where they do not fit); 2 = l2.
template <typename S, typename T>
int banded_matvec_t(const int* slot_ptr, const void* off, const void* val,
                    const int* w0, const void* X, void* Y, int NB, int R,
                    int W, int n, int m, int nb, int route, cudaStream_t s) {
  const bool fits = static_cast<size_t>(nb) * W * sizeof(T) <= kStageMax;
  if (route == 1 && !fits) return static_cast<int>(cudaErrorInvalidValue);
  const bool stage = route == 1 || (route == 0 && fits);
#define CALL(BB)                                                         \
  return stage ? banded_launch<S, T, BB, true>(slot_ptr, off, val, w0, X, \
                                               Y, NB, R, W, n, m, s)      \
               : banded_launch<S, T, BB, false>(slot_ptr, off, val, w0, X, \
                                                Y, NB, R, W, n, m, s)
  KNP_FOR_BATCH(nb, CALL)
#undef CALL
  return 0;
}

// dtype: vector type, 0 = float32, 1 = float64.  slab: storage type of
// the values, 0 = float32, 1 = float64, 2 = bfloat16 (with either vector
// type).
int banded_dispatch(int dtype, int slab, const int* slot_ptr, const void* off,
                    const void* val, const int* w0, const void* X, void* Y,
                    int NB, int R, int W, int n, int m, int nb, int route,
                    cudaStream_t s) {
  if (NB == 0 || nb == 0 || n == 0) return 0;
  if (R <= 0 || R % 32 || R > 1024 || W <= 0 || W > (1 << 16) || m <= 0 ||
      route < 0 || route > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && slab == 0)
    return banded_matvec_t<float, float>(slot_ptr, off, val, w0, X, Y, NB, R, W, n, m, nb, route, s);
  if (dtype == 0 && slab == 2)
    return banded_matvec_t<__nv_bfloat16, float>(slot_ptr, off, val, w0, X, Y, NB, R, W, n, m, nb, route, s);
  if (dtype == 1 && slab == 1)
    return banded_matvec_t<double, double>(slot_ptr, off, val, w0, X, Y, NB, R, W, n, m, nb, route, s);
  if (dtype == 1 && slab == 2)
    return banded_matvec_t<__nv_bfloat16, double>(slot_ptr, off, val, w0, X, Y, NB, R, W, n, m, nb, route, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64.  Each entry point launches on the
// given stream, allocates nothing and returns cudaGetLastError().

// K6a: Y (nb, R) = X A^T from the sliced form, nb <= 8; X is (nb, m).
int knp_sliced_matvec_batch(int dtype, const int* slot_ptr, const int* col,
                            const void* val, const void* X, void* Y, int R,
                            int m, int nb, void* stream) {
  if (R == 0 || nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? sliced_matvec_batch_t<float>(slot_ptr, col, val, X, Y, R,
                                                   m, nb, s)
                    : sliced_matvec_batch_t<double>(slot_ptr, col, val, X, Y,
                                                    R, m, nb, s);
}

// K4: y (R,) = A x from the sliced form.
int knp_sliced_matvec(int dtype, const int* slot_ptr, const int* col,
                      const void* val, const void* x, void* y, int R,
                      void* stream) {
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    sliced_matvec_kernel<float><<<blocks_for(R), kThreads, 0, s>>>(
        slot_ptr, col, static_cast<const float*>(val),
        static_cast<const float*>(x), static_cast<float*>(y), R);
  else
    sliced_matvec_kernel<double><<<blocks_for(R), kThreads, 0, s>>>(
        slot_ptr, col, static_cast<const double*>(val),
        static_cast<const double*>(x), static_cast<double*>(y), R);
  return static_cast<int>(cudaGetLastError());
}

// K5 (nb = 1) and K6b: Y (nb, R) = X (nb, m) A from the CSR of A^T
// (R rows: A's columns; m: A's rows), nb <= 8, G lanes a row.
int knp_csr_gather_batch(int dtype, const int* row_ptr, const int* col,
                         const void* val, const void* X, void* Y, int R,
                         int m, int nb, int G, void* stream) {
  if (R == 0 || nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? csr_gather_t<float, false>(row_ptr, col, val, X, Y, R,
                                                 m, nb, G, s)
                    : csr_gather_t<double, false>(row_ptr, col, val, X, Y, R,
                                                  m, nb, G, s);
}

// The far remainder of a banded operator: Y (nb, R) += X (nb, m) F^T,
// F (R x m) as a CSR by row, nb <= 8, G lanes a row; rows of F without
// entries are not touched.
int knp_csr_gather_add_batch(int dtype, const int* row_ptr, const int* col,
                             const void* val, const void* X, void* Y, int R,
                             int m, int nb, int G, void* stream) {
  if (R == 0 || nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? csr_gather_t<float, true>(row_ptr, col, val, X, Y, R,
                                                m, nb, G, s)
                    : csr_gather_t<double, true>(row_ptr, col, val, X, Y, R,
                                                 m, nb, G, s);
}

// K7: y (n,) = one packed window of a block-banded operator times x (m,).
int knp_banded_matvec(int dtype, int slab, const int* slot_ptr,
                      const void* off, const void* val, const int* w0,
                      const void* x, void* y, int NB, int R, int W, int n,
                      int m, int route, void* stream) {
  return banded_dispatch(dtype, slab, slot_ptr, off, val, w0, x, y, NB, R, W,
                         n, m, 1, route, static_cast<cudaStream_t>(stream));
}

// K8: Y (nb, n) = the same window times X (nb, m), nb <= 8.
int knp_banded_matvec_batch(int dtype, int slab, const int* slot_ptr,
                            const void* off, const void* val, const int* w0,
                            const void* X, void* Y, int NB, int R, int W,
                            int n, int m, int nb, int route, void* stream) {
  return banded_dispatch(dtype, slab, slot_ptr, off, val, w0, X, Y, NB, R, W,
                         n, m, nb, route, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
