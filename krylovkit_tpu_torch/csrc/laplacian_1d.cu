// 1-D Dirichlet Laplacian on the flat index:
//   y[i] = 2 x[i] - x[i-1] - x[i+1],   x read as 0 outside [0, n).
//
// Replaces the TPU kernel krylovkit_tpu/ops/pallas_stencil.py:_kernel
// (launched by laplacian_1d_pallas).
//
// Bound on an H100: memory.  One apply reads x once and writes y:
// 2 * n * itemsize bytes, 16.8 MB and 5.0 us at 3.35 TB/s for n = 2^21
// float32; its 3 flops per entry take 0.09 us at 67 TFLOP/s.
//
// Design.  The TPU kernel DMAs a row tile plus one halo row on each side into
// VMEM and builds the neighbours with lane and row rolls.  Here each thread
// owns kVec consecutive entries (16 bytes: 4 floats or 2 doubles): one
// 16-byte load of its own entries and one 16-byte store of the result, plus
// two scalar loads of the entries just outside its span, which the
// neighbouring threads load as part of their own spans, so they come from
// L1/L2 and x crosses HBM once.  The arithmetic is (2 x[i] - x[i-1]) - x[i+1]
// in the working type, the order of the plain version, so the two agree to
// the bit.
//
// Batched (kk_laplacian_1d_batched): the same map on each row of a stack X
// (rows, n) in one launch, the counterpart of the TPU kernel under jax.vmap
// (its pallas_call gains a grid axis over the problems).  Grid y walks the
// rows; a thread's span, and the neighbours it reads, lie in its own row, so
// no row reads another's entries, and every row runs the one-row body:
// bit-identical to a kk_laplacian_1d launch on it.  Bound: memory, 2 * rows *
// n * itemsize bytes (134 MB, 40.1 us at 8 rows of 2^21 float32): the gain
// over one launch a row is launches, not bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 16;

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

template <typename T>
__device__ __forceinline__ void laplacian_row(const T* __restrict__ x, T* __restrict__ y,
                                              long long n) {
  constexpr int kVec = 16 / sizeof(T);
  const long long nvec = (n + kVec - 1) / kVec;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    const long long i0 = v * kVec;
    const bool full = i0 + kVec <= n;
    T c[kVec];
    if (full) {
      load16(x + i0, c);
    } else {
#pragma unroll
      for (int t = 0; t < kVec; ++t) c[t] = (i0 + t < n) ? __ldg(x + i0 + t) : T(0);
    }
    const T left = (i0 > 0) ? __ldg(x + i0 - 1) : T(0);
    const T right = (i0 + kVec < n) ? __ldg(x + i0 + kVec) : T(0);
    T out[kVec];
#pragma unroll
    for (int t = 0; t < kVec; ++t) {
      const T xm = (t == 0) ? left : c[t - 1];
      const T xp = (t == kVec - 1) ? right : c[t + 1];
      out[t] = (T(2) * c[t] - xm) - xp;
    }
    if (full) {
      store16(y + i0, out);
    } else {
      for (int t = 0; t < kVec && i0 + t < n; ++t) y[i0 + t] = out[t];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
laplacian_1d_kernel(const T* __restrict__ x, T* __restrict__ y, long long n) {
  laplacian_row(x, y, n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
laplacian_1d_batched_kernel(const T* __restrict__ X, T* __restrict__ Y, long long n,
                            long long ldx, long long ldy) {
  laplacian_row(X + blockIdx.y * ldx, Y + blockIdx.y * ldy, n);
}

template <typename T>
cudaError_t launch_batched(const T* X, T* Y, long long n, long long ldx, long long ldy,
                           int rows, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long nvec = (n + kVec - 1) / kVec;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const dim3 grid((unsigned)blocks, (unsigned)rows);
  laplacian_1d_batched_kernel<T><<<grid, kThreads, 0, stream>>>(X, Y, n, ldx, ldy);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* x, T* y, long long n, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long nvec = (n + kVec - 1) / kVec;
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  laplacian_1d_kernel<T><<<(int)blocks, kThreads, 0, stream>>>(x, y, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (n,), y (n,): device, 16-byte aligned; is_double selects double (else
// float).  Returns cudaGetLastError() after the launch.
int kk_laplacian_1d(const void* x, void* y, long long n, int is_double,
                    void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double) return (int)launch<double>((const double*)x, (double*)y, n, s);
  return (int)launch<float>((const float*)x, (float*)y, n, s);
}

// X (rows, ldx), Y (rows, ldy): device, 16-byte aligned, ldx and ldy >= n
// and multiples of 16 / itemsize; row r maps X + r * ldx to Y + r * ldy.
// 1 <= rows <= 65535.  Returns cudaGetLastError() after the launch.
int kk_laplacian_1d_batched(const void* X, void* Y, long long n, long long ldx,
                            long long ldy, int rows, int is_double, void* stream) {
  const int vec = is_double ? 2 : 4;
  if (n < 1 || ldx < n || ldy < n || ldx % vec != 0 || ldy % vec != 0 || rows < 1 ||
      rows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return (int)launch_batched<double>((const double*)X, (double*)Y, n, ldx, ldy, rows, s);
  return (int)launch_batched<float>((const float*)X, (float*)Y, n, ldx, ldy, rows, s);
}

const char* kk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
