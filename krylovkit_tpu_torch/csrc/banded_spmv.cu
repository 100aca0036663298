// Banded (offset-decomposed) sparse matrix-vector product on the flat index:
//   y[i] = sum_p diags[p][i] * x[i + offsets[p]],   x read as 0 outside [0, n).
//
// Replaces the TPU kernel krylovkit_tpu/ops/pallas_spmv.py:_spmv_kernel
// (launched by _spmv_pallas), the apply of BandedOperator.
//
// Bound on an H100: memory.  One apply reads the nd diagonal planes and x once
// and writes y: (nd + 2) * n * itemsize bytes.  For the banded 2-D Poisson
// matrix (nd = 5, n = 2^20, float32) that is 29.4 MB, 8.8 us at 3.35 TB/s; its
// 2 * nd * n = 10.5 MFLOP take 0.16 us at the 67 TFLOP/s float32 rate.
//
// Design.  The TPU kernel DMAs a window of x rows into VMEM and lane-rolls it
// once per offset, a device of the TPU's (8, 128) tiles.  Here the vector is
// flat and each thread owns kVec consecutive outputs (16 bytes: 4 floats or
// 2 doubles):
//   * each diagonal plane is read, and y written, as one 16-byte access per
//     thread, neighbouring threads on neighbouring addresses;
//   * x[i + d] is read from global memory with plain loads.  For every offset
//     the threads of a warp read one contiguous span, and the spans of the nd
//     offsets overlap, so L1 and L2 absorb the reuse and x crosses HBM about
//     once per apply;
//   * a read outside [0, n) gives zero, the Dirichlet truncation of the plain
//     version (_spmv_xla in the JAX package);
//   * each output sums its terms in offset order in the working type (float
//     or double) with FMAs.
// The offsets ride in a by-value kernel argument, up to 128 (the most that
// banded_from_coo accepts), so any offset in (-n, n) works: nothing limits
// the band to a window.  A grid-stride loop covers any n.
//
// Batched (kk_banded_spmv_batched): the same product for the rows of a stack
// X (rows, n), the counterpart of the TPU kernel under jax.vmap, whose
// pallas_call gains a grid axis over the problems.  The planes are one set
// shared by every row (plane stride 0: one operator, many right-hand sides)
// or one set per row, picked by a by-value list of plane-set indices (a
// sequence of operators with equal offsets).
//   * Bound: memory.  Shared planes: (nd + 2 * rows) * n * itemsize bytes;
//     per-row planes: rows * (nd + 2) * n * itemsize.  At nd = 5, 8 rows,
//     n = 2^20, float32: 88.1 MB, 26.3 us at 3.35 TB/s, against 8 one-row
//     launches' 235 MB.
//   * A thread owns kVec outputs of each of the Chunk rows of its grid-y
//     slice.  With shared planes Chunk = 4: each 16-byte plane slice is
//     loaded once and applied to 4 rows whose accumulators stay in
//     registers, so the planes cross HBM about once.  With per-row planes
//     there is nothing to share and Chunk = 1.  Chunks of 8 and 16 rows, and
//     16-byte loads of the x windows, cost registers and occupancy and were
//     slower on an H100 (float32, five offsets, n = 2^20, 8 rows).
//   * Each row sums its terms in offset order with the FMAs of the one-row
//     kernel, from the same zero, so each row is bit-identical to a
//     kk_banded_spmv launch on it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOffsets = 128;
constexpr long long kMaxBlocks = 1 << 16;
constexpr int kSharedChunk = 4;  // rows a thread carries with shared planes
constexpr int kMaxRows = 64;     // rows one batched launch takes

struct Offsets {
  int count;
  int d[kMaxOffsets];
};

struct Rows {
  int count;
  int plane[kMaxRows];  // the plane set of each row (unread when shared)
};

__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_spmv_kernel(const T* __restrict__ x, const T* __restrict__ diags,
                   T* __restrict__ y, long long n, long long ld, Offsets offs) {
  constexpr int kVec = 16 / sizeof(T);
  const long long nvec = (n + kVec - 1) / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    const long long i0 = v * kVec;
    T acc[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) acc[t] = T(0);
    for (int p = 0; p < offs.count; ++p) {
      // ld >= n and ld % kVec == 0: the whole 16 bytes lie inside the plane
      T dv[kVec];
      load16(diags + p * ld + i0, dv);
      const long long j0 = i0 + offs.d[p];
#pragma unroll
      for (int t = 0; t < kVec; ++t) {
        const long long j = j0 + t;
        const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
        acc[t] = madd(dv[t], xv, acc[t]);
      }
    }
    if (i0 + kVec <= n) {
      store16(y + i0, acc);
    } else {
      for (int t = 0; t < kVec && i0 + t < n; ++t) y[i0 + t] = acc[t];
    }
  }
}

template <typename T>
cudaError_t launch(const T* x, const T* diags, T* y, long long n, long long ld,
                   const Offsets& offs, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long nvec = (n + kVec - 1) / kVec;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  banded_spmv_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(x, diags, y, n, ld, offs);
  return cudaGetLastError();
}

template <typename T, int Chunk>
__global__ void __launch_bounds__(kThreads)
banded_spmv_batched_kernel(const T* __restrict__ X, const T* __restrict__ diags,
                           T* __restrict__ Y, long long n, long long ldx,
                           long long ldy, long long ld, long long ldp,
                           Offsets offs, Rows rows) {
  constexpr int kVec = 16 / sizeof(T);
  const int r0 = blockIdx.y * Chunk;
  const int nc = min(Chunk, rows.count - r0);
  const long long nvec = (n + kVec - 1) / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    const long long i0 = v * kVec;
    T acc[Chunk][kVec];
#pragma unroll
    for (int c = 0; c < Chunk; ++c) {
#pragma unroll
      for (int t = 0; t < kVec; ++t) acc[c][t] = T(0);
    }
    for (int p = 0; p < offs.count; ++p) {
      T dv[kVec];
      if (ldp == 0) load16(diags + p * ld + i0, dv);
      const long long j0 = i0 + offs.d[p];
#pragma unroll
      for (int c = 0; c < Chunk; ++c) {
        if (c < nc) {
          if (ldp != 0) load16(diags + rows.plane[r0 + c] * ldp + p * ld + i0, dv);
          const T* x = X + (r0 + c) * ldx;
#pragma unroll
          for (int t = 0; t < kVec; ++t) {
            const long long j = j0 + t;
            const T xv = (j >= 0 && j < n) ? __ldg(x + j) : T(0);
            acc[c][t] = madd(dv[t], xv, acc[c][t]);
          }
        }
      }
    }
#pragma unroll
    for (int c = 0; c < Chunk; ++c) {
      if (c < nc) {
        T* y = Y + (r0 + c) * ldy;
        if (i0 + kVec <= n) {
          store16(y + i0, acc[c]);
        } else {
          for (int t = 0; t < kVec && i0 + t < n; ++t) y[i0 + t] = acc[c][t];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_batched(const T* X, const T* diags, T* Y, long long n,
                           long long ldx, long long ldy, long long ld,
                           long long ldp, const Offsets& offs, const Rows& rows,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long nvec = (n + kVec - 1) / kVec;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (ldp == 0) {
    const dim3 grid((unsigned)blocks, (unsigned)((rows.count + kSharedChunk - 1) / kSharedChunk));
    banded_spmv_batched_kernel<T, kSharedChunk><<<grid, kThreads, 0, stream>>>(
        X, diags, Y, n, ldx, ldy, ld, ldp, offs, rows);
  } else {
    const dim3 grid((unsigned)blocks, (unsigned)rows.count);
    banded_spmv_batched_kernel<T, 1><<<grid, kThreads, 0, stream>>>(X, diags, Y, n, ldx, ldy,
                                                                     ld, ldp, offs, rows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n,), y (n,): device, 16-byte aligned.  diags: (noffsets, ld) on the
// device, 16-byte aligned, ld >= n, ld a multiple of 16 / itemsize; plane p
// holds diags[p][i] = A[i, i + offsets[p]].  offsets: host array of noffsets
// ints.  is_double selects double (else float) for all three arrays.
// Returns cudaGetLastError() after the launch.
int kk_banded_spmv(const void* x, const void* diags, void* y, long long n,
                   long long ld, int noffsets, const int* offsets, int is_double,
                   void* stream) {
  const int vec = is_double ? 2 : 4;
  if (n < 1 || ld < n || ld % vec != 0 || noffsets < 0 || noffsets > kMaxOffsets)
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  offs.count = noffsets;
  for (int p = 0; p < noffsets; ++p) offs.d[p] = offsets[p];
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return (int)launch<double>((const double*)x, (const double*)diags, (double*)y,
                               n, ld, offs, s);
  return (int)launch<float>((const float*)x, (const float*)diags, (float*)y, n,
                            ld, offs, s);
}

// X (nrows, ldx): row r's n entries at X + r * ldx, any alignment; Y (nrows,
// ldy): device, 16-byte aligned, ldy >= n a multiple of 16 / itemsize.
// diags: plane set s holds its noffsets planes (ld entries each, as in
// kk_banded_spmv) at diags + s * ldp; ldp = 0 shares one set among all rows,
// else ldp is a multiple of 16 / itemsize and row r reads set planes[r]
// (host array of nrows ints).  1 <= nrows <= 64.  Returns
// cudaGetLastError() after the launch.
int kk_banded_spmv_batched(const void* X, const void* diags, void* Y, long long n,
                           long long ldx, long long ldy, long long ld, long long ldp,
                           int nrows, const int* planes, int noffsets,
                           const int* offsets, int is_double, void* stream) {
  const int vec = is_double ? 2 : 4;
  if (n < 1 || ld < n || ld % vec != 0 || ldx < n || ldy < n || ldy % vec != 0 ||
      ldp < 0 || ldp % vec != 0 || nrows < 1 || nrows > kMaxRows || noffsets < 0 ||
      noffsets > kMaxOffsets || (ldp != 0 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  Offsets offs;
  offs.count = noffsets;
  for (int p = 0; p < noffsets; ++p) offs.d[p] = offsets[p];
  Rows rows;
  rows.count = nrows;
  for (int r = 0; r < nrows; ++r) rows.plane[r] = ldp != 0 ? planes[r] : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return (int)launch_batched<double>((const double*)X, (const double*)diags,
                                       (double*)Y, n, ldx, ldy, ld, ldp, offs, rows, s);
  return (int)launch_batched<float>((const float*)X, (const float*)diags, (float*)Y, n,
                                    ldx, ldy, ld, ldp, offs, rows, s);
}

const char* kk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
