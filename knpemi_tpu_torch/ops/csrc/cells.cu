// Cell kernels for Hopper (sm_90a): the P1 operator of a subdomain
// (the K1 / K11 apply, the ion-batched K3 apply and the K1f / K11f
// fills).  Plain C interface, loaded with ctypes by
// knpemi_tpu_torch/ops/p1op.py, which holds the plain PyTorch version of
// each kernel, the input checks and the launch counters.
//
// All replace TPU kernels whose one-hot MXU factoring exists only
// because random gathers are slow on the TPU
// (knpemi_tpu/ops/pallas_assembly.py); here every gather
// is exact.  K1, K11 and K3 apply the subdomain's P1 operator assembled
// on its P1 graph, stored as a sliced ELL (ops/p1op.py): one thread per
// row streams the row's slots, a warp reading slot k of its 32 rows in
// one coalesced load, and writes the row once.  Their values are filled
// once per solve by K1f and K11f, also one thread per row: each walks its
// row's entries of the operator's incidence list (K1f after a pass that
// stages every cell's pair values), sums in shared memory and stores
// every slot once.  No kernel here uses atomics, so each gives
// the same bits on every launch; the plain versions sum in other orders
// or without fused multiply-adds and agree to a few ulps of max|y|.
// Every kernel here is bound by the bytes it moves.

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

// K1f / K11f: the fills of the P1 operator's per-solve values, in two
// passes each.  First one thread per cell stages what the cell adds into
// a scratch array, read and written coalesced: K1f the cell's K (K - 1) /
// 2 pair values wv_c (g_ci . g_cj), K11f its K drift values q_ci.  Then
// one thread per row walks the row's entries of the incidence list
// (ops/p1op.py::P1Operator): entry e of row r at inc[inc_ptr[r / 32] +
// 32 e + r % 32] is a (cell c, local vertex i) with cells[c, i] = r,
// packed as c << 2 | i, c ascending along the row, -1 after the row's
// last.  An entry gathers its K slot positions pos[c, i, :] and the
// cell's staged values.  A warp takes a 32-row slice: its 32 x K[s] sums
// live in shared memory slot-major (row r's slot k at 32 k + r % 32),
// each thread owning its row's column -- no bank conflicts, no atomics,
// no synchronisation.  A thread adds its entries' contributions in list
// order, then the warp stores the slice's K[s] x 32 values with coalesced
// writes, padding zeros included: every slot is written exactly once (no
// memset) and two launches give the same bits.  Shared memory: 32 x kmax
// values a warp.  Replace, with K1 / K11, the geometry the TPU kernels
// read on every apply (knpemi_tpu/ops/pallas_assembly.py:_make_emi_kernel
// and _make_knp_kernel, fed by prepare_emi_weight and prepare_knp_drift).
//
// Why two passes (measured on the H100, PERF.md): the walk is bound by
// the latency of its gathers and by what L2 holds of the gathered arrays.
// Gathering the inputs themselves per entry (a cell's 48 bytes of
// gradients for K1f; g_ci, w_c, vol_c for K11f) was slower in every
// form tried: by 2-3x with 2 and 4 entries in flight, by much less with
// 8 and 16, still slower than the two passes on the flagship's ECS.  The
// staged values (24 and 16 bytes a cell, 36 and 24 MB there) fit in L2,
// at the cost of the first kernel and its scratch.  IN_FLIGHT entries
// are gathered before they are summed; a padding entry gathers cell 0
// and adds nothing.

// pos[c, i, :], the K slot positions of vertex i's row in cell c, one
// byte each (one 4-byte load for a tetrahedron)
template <int K>
__device__ __forceinline__ uint32_t load_pos_row(const uint8_t* __restrict__ pos,
                                                 int c, int i) {
  if constexpr (K == 4) {
    return __ldg(reinterpret_cast<const unsigned int*>(pos) +
                 (static_cast<int64_t>(c) * 4 + i));
  } else {
    const uint8_t* p = pos + (static_cast<int64_t>(c) * K + i) * K;
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) w |= static_cast<uint32_t>(__ldg(p + j)) << (8 * j);
    return w;
  }
}

__device__ __forceinline__ int pos_of(uint32_t w, int j) {
  return (w >> (8 * j)) & 0xFF;
}

// N consecutive values from p in the widest loads its size allows (p is
// aligned to 16 bytes where N values fill 16-byte words, to 8 where 8)
__device__ __forceinline__ void ld16(const float* p, float* o) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
}
__device__ __forceinline__ void ld16(const double* p, double* o) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  o[0] = q.x; o[1] = q.y;
}
__device__ __forceinline__ void ld8(const float* p, float* o) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  o[0] = q.x; o[1] = q.y;
}
__device__ __forceinline__ void ld8(const double* p, double* o) { o[0] = __ldg(p); }

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, T (&o)[N]) {
  constexpr int bytes = N * static_cast<int>(sizeof(T));
  if constexpr (bytes % 16 == 0) {
    constexpr int V = 16 / sizeof(T);
#pragma unroll
    for (int u = 0; u < N / V; ++u) ld16(p + u * V, o + u * V);
  } else if constexpr (bytes % 8 == 0) {
    constexpr int V = 8 / sizeof(T);
#pragma unroll
    for (int u = 0; u < N / V; ++u) ld8(p + u * V, o + u * V);
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) o[u] = __ldg(p + u);
  }
}

// The index of the vertex pair {i, j}, i != j, of a K-vertex cell among
// its K (K - 1) / 2 pairs in the order (0, 1), (0, 2), .., (K - 2, K - 1).
__host__ __device__ constexpr int pair_index(int K, int i, int j) {
  const int a = i < j ? i : j, b = i < j ? j : i;
  return a * K - a * (a + 1) / 2 + b - a - 1;
}

// K1f, first pass: pairs[c, pair_index(i, j)] = wv_c (g_ci . g_cj).
template <typename T, int K, int D>
__global__ void __launch_bounds__(kThreads)
emi_pairs_kernel(const T* __restrict__ grads, const T* __restrict__ wv,
                 T* __restrict__ pairs, int nc) {
  constexpr int P = K * (K - 1) / 2;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  T g[K * D];
  load_vec<T, K * D>(grads + static_cast<int64_t>(c) * K * D, g);
  const T w = __ldg(wv + c);
  T* out = pairs + static_cast<int64_t>(c) * P;
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = i + 1; j < K; ++j) {
      T dot = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) dot += g[i * D + d] * g[j * D + d];
      out[pair_index(K, i, j)] = w * dot;
    }
}

// K11f, first pass: q[c, i] = vol_c (w_c . g_ci) / K, the P1 drift along
// the cellwise-constant w = grad(phi).
template <typename T, int K, int D>
__global__ void __launch_bounds__(kThreads)
drift_q_kernel(const T* __restrict__ grads, const T* __restrict__ vols,
               const T* __restrict__ w, T* __restrict__ q, int nc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  T g[K * D];
  load_vec<T, K * D>(grads + static_cast<int64_t>(c) * K * D, g);
  T wc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) wc[d] = __ldg(w + static_cast<int64_t>(c) * D + d);
  const T vk = __ldg(vols + c) / T(K);
#pragma unroll
  for (int i = 0; i < K; ++i) {
    T wg = T(0);
#pragma unroll
    for (int d = 0; d < D; ++d) wg += wc[d] * g[i * D + d];
    q[static_cast<int64_t>(c) * K + i] = vk * wg;
  }
}

// The forms of the second pass.  EMI_PAIRS (K1f): row r's slot of column
// v_j gets the pair value of (i, j) from every entry (c, i) of the row
// and vertex j != i of c; the diagonal slot keeps the stiffness's row
// sum, an exact 0.  DRIFT (K11f): q_ci into the row's slots of the K - 1
// columns v_j != r and K q_ci into its diagonal slot, the row's sum; each
// diagonal sum has one owner thread (in a cell-parallel fill the ~21
// cells of a vertex all add into it).  Bound by bytes, the function's
// own: cells, pos and the inputs read once, vals written once.
enum FillForm { EMI_PAIRS, DRIFT };

template <typename T, int K, FillForm FORM>
__global__ void __launch_bounds__(kThreads)
fill_rows_kernel(const int* __restrict__ inc_ptr, const int* __restrict__ inc,
                 const uint8_t* __restrict__ pos, const int* __restrict__ slot_ptr,
                 const T* __restrict__ staged, T* __restrict__ vals, int ns,
                 int kmax) {
  constexpr int IN_FLIGHT = FORM == DRIFT ? 16 : 8;
  constexpr int G = FORM == EMI_PAIRS ? K * (K - 1) / 2 : 1;
  extern __shared__ __align__(16) unsigned char fill_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= ns) return;
  T* acc = reinterpret_cast<T*>(fill_smem) + warp * 32 * kmax + lane;
  const int v0 = __ldg(slot_ptr + s);
  const int ks = (__ldg(slot_ptr + s + 1) - v0) >> 5;
  for (int k = 0; k < ks; ++k) acc[32 * k] = T(0);
  const int e1 = __ldg(inc_ptr + s + 1);
  for (int e0 = __ldg(inc_ptr + s) + lane; e0 < e1; e0 += IN_FLIGHT * 32) {
    int ent[IN_FLIGHT];
    uint32_t p[IN_FLIGHT];
    T v[IN_FLIGHT][G];
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      const int e = e0 + 32 * u;
      ent[u] = e < e1 ? __ldg(inc + e) : -1;
      const int c = ent[u] < 0 ? 0 : ent[u] >> 2, i = ent[u] < 0 ? 0 : ent[u] & 3;
      p[u] = load_pos_row<K>(pos, c, i);
      if constexpr (FORM == EMI_PAIRS) {
        load_vec<T, G>(staged + static_cast<int64_t>(c) * G, v[u]);
      } else {
        v[u][0] = __ldg(staged + static_cast<int64_t>(c) * K + i);
      }
    }
#pragma unroll
    for (int u = 0; u < IN_FLIGHT; ++u) {
      if (ent[u] < 0) continue;
      const int i = ent[u] & 3;
      if constexpr (FORM == DRIFT) {
#pragma unroll
        for (int j = 0; j < K; ++j)
          acc[32 * pos_of(p[u], j)] += j == i ? T(K) * v[u][0] : v[u][0];
      } else {
#pragma unroll
        for (int m = 0; m < K - 1; ++m) {  // the m-th column j != i
          T x = v[u][m];
#pragma unroll
          for (int ii = 0; ii < K; ++ii)  // the pair (i, j), i known at run time
            if (ii == i) x = v[u][pair_index(K, ii, m + (m >= ii))];
          acc[32 * pos_of(p[u], m + (m >= i))] += x;
        }
      }
    }
  }
  T* out = vals + v0 + lane;
  for (int k = 0; k < ks; ++k) out[32 * k] = acc[32 * k];
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

// A fill kernel over the n rows' ns = ceil(n / 32) slices, one warp a
// slice, in blocks of as many warps (at most kThreads / 32) as 48 KB of
// shared memory holds at 32 x kmax values a warp; a slice wider than
// that (one warp above 48 KB) gets the dynamic shared memory it needs.
template <typename T, typename... P, typename... Args>
int launch_fill(void (*kernel)(P...), int n, int kmax, cudaStream_t s,
                Args... args) {
  const int ns = (n + 31) / 32;
  const size_t per_warp = 32u * static_cast<size_t>(kmax) * sizeof(T);
  int warps = static_cast<int>((48u << 10) / per_warp);
  warps = warps < 1 ? 1 : (warps > kThreads / 32 ? kThreads / 32 : warps);
  const size_t smem = warps * per_warp;
  if (smem > (48u << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<(ns + warps - 1) / warps, warps * 32, smem, s>>>(args..., ns, kmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int emi_fill_t(const int* inc_ptr, const int* inc, const uint8_t* pos,
               const int* slot_ptr, const void* grads, const void* wv,
               void* scratch, void* vals, int n, int nc, int kmax,
               int k, int dim, cudaStream_t s) {
  const T* gt = static_cast<const T*>(grads);
  const T* wt = static_cast<const T*>(wv);
  T* st = static_cast<T*>(scratch);
  T* vt = static_cast<T*>(vals);
#define CALL(KK, DD)                                                          \
  do {                                                                        \
    emi_pairs_kernel<T, KK, DD><<<blocks_for(nc), kThreads, 0, s>>>(gt, wt,   \
                                                                    st, nc);  \
    const int err = static_cast<int>(cudaGetLastError());                     \
    if (err != 0) return err;                                                 \
    return launch_fill<T>(fill_rows_kernel<T, KK, EMI_PAIRS>, n, kmax, s,     \
                          inc_ptr, inc, pos, slot_ptr, st, vt);               \
  } while (0)
  if (k == 4 && dim == 3) CALL(4, 3);
  if (k == 3 && dim == 2) CALL(3, 2);
#undef CALL
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int drift_fill_t(const int* inc_ptr, const int* inc, const uint8_t* pos,
                 const int* slot_ptr, const void* grads, const void* vols,
                 const void* w, void* scratch, void* vals, int n, int nc, int kmax,
                 int k, int dim, cudaStream_t s) {
  const T* gt = static_cast<const T*>(grads);
  const T* vo = static_cast<const T*>(vols);
  const T* wt = static_cast<const T*>(w);
  T* st = static_cast<T*>(scratch);
  T* vt = static_cast<T*>(vals);
#define CALL(KK, DD)                                                          \
  do {                                                                        \
    drift_q_kernel<T, KK, DD><<<blocks_for(nc), kThreads, 0, s>>>(gt, vo, wt, \
                                                                  st, nc);    \
    const int err = static_cast<int>(cudaGetLastError());                     \
    if (err != 0) return err;                                                 \
    return launch_fill<T>(fill_rows_kernel<T, KK, DRIFT>, n, kmax, s,         \
                          inc_ptr, inc, pos, slot_ptr, st, vt);               \
  } while (0)
  if (k == 4 && dim == 3) CALL(4, 3);
  if (k == 3 && dim == 2) CALL(3, 2);
#undef CALL
  return static_cast<int>(cudaErrorInvalidValue);
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

// K1f into vals (slots,), every slot written, through scratch (nc K (K -
// 1) / 2 values, the cells' pair values); n rows, nc cells, kmax the
// widest slice's slots a row (1 .. 256).
int knp_emi_fill(int dtype, const int* inc_ptr, const int* inc,
                 const uint8_t* pos, const int* slot_ptr, const void* grads,
                 const void* wv, void* scratch, void* vals, int n, int nc,
                 int kmax, int k, int dim, void* stream) {
  if (n == 0) return 0;
  if (scratch == nullptr || kmax < 1 || kmax > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? emi_fill_t<float>(inc_ptr, inc, pos, slot_ptr, grads, wv,
                                        scratch, vals, n, nc, kmax, k, dim, s)
                    : emi_fill_t<double>(inc_ptr, inc, pos, slot_ptr, grads, wv,
                                         scratch, vals, n, nc, kmax, k, dim, s);
}

// K11f into vals (slots,), every slot written, through scratch (nc K
// values, the cells' drift values).
int knp_drift_fill(int dtype, const int* inc_ptr, const int* inc,
                   const uint8_t* pos, const int* slot_ptr, const void* grads,
                   const void* vols, const void* w, void* scratch, void* vals, int n,
                   int nc, int kmax, int k, int dim, void* stream) {
  if (n == 0) return 0;
  if (scratch == nullptr || kmax < 1 || kmax > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? drift_fill_t<float>(inc_ptr, inc, pos, slot_ptr, grads, vols,
                                          w, scratch, vals, n, nc, kmax, k, dim, s)
                    : drift_fill_t<double>(inc_ptr, inc, pos, slot_ptr, grads, vols,
                                           w, scratch, vals, n, nc, kmax, k, dim, s);
}

}  // extern "C"
