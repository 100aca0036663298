// In-place partial basis rotation: V[:m_out] <- (U^T V)[:m_out], rows >= m_out
// untouched.
//
// Replaces the TPU kernel krylovkit_tpu/ops/basis.py:_pallas_transform_inplace
// (the thick-restart rotation and the Ritz-vector extraction of the Lanczos
// eigsolve).
//
// Bound on an H100: memory.  Each call reads kmax basis rows and writes m_out
// rows of n floats, (kmax + m_out) * n * 4 bytes; at kmax = 31, m_out = 20,
// n = 2^21 that is 428 MB, 128 us at 3.35 TB/s.  The arithmetic,
// 2 * kmax * m_out * n = 2.6 GFLOP, is 39 us at the 67 TFLOP/s float32 rate.
//
// Design: one thread owns one column e of the flattened (kmax, n) basis.  It
// loads all kmax values V[j, e] into registers (a KREG-wide array, KREG a
// template bound), then writes out[i, e] = sum_j U[j, i] V[j, e] for
// i < m_out.  Every column is read completely before any of it is written and
// no column depends on another, so the rotation is safe in place without a
// second buffer; rows >= m_out are never written and stay bit-identical (the
// gated identity restarts of the Lanczos driver read them).  U[:, :m_out]
// sits in shared memory, transposed so that a thread reads one contiguous
// row per output.  Loads and stores are coalesced across a warp.  The sums
// are float32 FMAs in a fixed order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <int KREG>
__global__ void __launch_bounds__(kThreads)
transform_kernel(float* V, const float* __restrict__ Ut, int kmax,
                 long long ncols, int m_out) {
  extern __shared__ float sU[];  // (m_out, kmax): row i holds U[:, i]
  for (int t = threadIdx.x; t < m_out * kmax; t += blockDim.x) sU[t] = Ut[t];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < ncols; e += stride) {
    float v[KREG];
#pragma unroll
    for (int j = 0; j < KREG; ++j) v[j] = (j < kmax) ? V[j * ncols + e] : 0.f;
    for (int i = 0; i < m_out; ++i) {
      const float* u = sU + i * kmax;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < KREG; ++j)
        if (j < kmax) acc = fmaf(u[j], v[j], acc);
      V[i * ncols + e] = acc;
    }
  }
}

template <int KREG>
cudaError_t launch(float* V, const float* Ut, int kmax, long long ncols,
                   int m_out, cudaStream_t stream) {
  size_t smem = sizeof(float) * (size_t)m_out * kmax;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        transform_kernel<KREG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long want = (ncols + kThreads - 1) / kThreads;
  long long cap = (long long)sms * 16;
  int blocks = (int)(want < cap ? want : cap);
  transform_kernel<KREG><<<blocks, kThreads, smem, stream>>>(V, Ut, kmax, ncols,
                                                             m_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// V: (kmax, ncols) float32 on the device, rotated in place.
// Ut: (m_out, kmax) float32 on the device, Ut[i, j] = U[j, i].
// Returns cudaGetLastError() after the launch.
int kk_transform_partial(float* V, const float* Ut, int kmax, long long ncols,
                         int m_out, void* stream) {
  if (kmax < 1 || kmax > 128 || m_out < 1 || m_out > kmax || ncols < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kmax <= 16) return (int)launch<16>(V, Ut, kmax, ncols, m_out, s);
  if (kmax <= 32) return (int)launch<32>(V, Ut, kmax, ncols, m_out, s);
  if (kmax <= 64) return (int)launch<64>(V, Ut, kmax, ncols, m_out, s);
  return (int)launch<128>(V, Ut, kmax, ncols, m_out, s);
}

const char* kk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
