// In-place partial basis rotation: V[:m_out] <- (U^T V)[:m_out], rows >= m_out
// untouched.
//
// Replaces the TPU kernel krylovkit_tpu/ops/basis.py:_pallas_transform_inplace
// (the thick-restart rotation and the Ritz-vector extraction of the Lanczos
// and Arnoldi eigensolvers).
//
// Bound on an H100: memory.  Each call reads kmax basis rows and writes m_out
// rows of n values, (kmax + m_out) * n * 4 bytes in float32; at kmax = 31,
// m_out = 20, n = 2^21 that is 428 MB, 128 us at 3.35 TB/s.  The arithmetic,
// 2 * kmax * m_out * n = 2.6 GFLOP, is 39 us at the 67 TFLOP/s float32 rate.
// What keeps a simple kernel from the memory bound is neither: an FMA that
// reads its U entry with a 4-byte shared-memory load of its own makes the
// kernel wait on shared-memory issue (about one load per SM and clock), and
// a thread that loads, then computes, then stores overlaps nothing by
// itself, so the SM needs many independent warps in different phases.
//
// Design.  A thread owns COLS consecutive columns of the flattened (kmax, n)
// basis and keeps all kmax values of each in registers (a KREG x COLS array,
// KREG a template bound on kmax).  It then writes, for every i < m_out,
//   out[i, e] = sum_j U[j, i] V[j, e]
// as one float32 FMA chain per column, in ascending j, starting from 0.
//   * U[:, i] lies in shared memory as a row of KREG floats, zero beyond
//     kmax, so it is read 16 bytes at a time: one shared-memory load per
//     4 * COLS FMAs.
//   * The block reads U[:, :m_out] straight from the caller's matrix through
//     its two strides (any view) while the basis loads are in flight: the
//     transpose and the padding cost no launch of their own.
//   * Few registers, many warps: a thread moves one 4-byte word per row
//     (1 float32 column, 2 bfloat16 columns) and takes ~64 registers at
//     kmax <= 32, so 8 blocks of 4 warps share an SM and the loads of some
//     hide the FMAs and stores of others.  Measured on the card, this beats
//     4 columns a thread (16-byte loads, 152 registers, 3 blocks an SM) by
//     3% at n = 2^21 and 9% at n = 2^20; a warp's load is still one
//     contiguous 128-byte run.
//   * One block per 128 * COLS columns, no grid-stride loop: the hardware
//     hands out blocks as SMs come free, so the last wave is short.
//   * In place: a thread reads all kmax values of its columns before it writes
//     any, and no column depends on another; rows >= m_out are never
//     addressed and stay bit-identical (the gated identity restarts of the
//     eigensolvers read them).  An identity U gives back V to the bit.
// The rungs, float32 (bfloat16): columns a thread, by kmax:
//   kmax <= 16: KREG 16, 2 (4) columns    kmax <= 64:  KREG 64, 1 (2) columns
//   kmax <= 32: KREG 32, 1 (2) columns    kmax <= 128: KREG 128, 1 (1) column
// A bfloat16 basis is widened to float32 in registers, accumulated in float32
// and rounded once at the store.  Nothing uses tensor cores.
//
// Batched rotation (kk_transform_partial_batched; the TPU kernel under
// jax.vmap): P bases (P, kmax, ncols), each with its own U, one launch over a
// (column blocks, problems) grid; every block runs the one-problem code on
// its problem, so each problem is rotated bit for bit as a one-problem launch
// rotates it.  Bound: P times the one-problem bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<const unsigned*>(&p);
}

// COLS consecutive values of type T at p, as floats, with one load or store.
template <typename T, int COLS>
struct Cols;

template <>
struct Cols<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[2]) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <>
struct Cols<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[1]) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

template <>
struct Cols<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[4]) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    v[0] = bf16_lo(t.x); v[1] = bf16_hi(t.x); v[2] = bf16_lo(t.y); v[3] = bf16_hi(t.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
};

template <>
struct Cols<__nv_bfloat16, 2> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[2]) {
    const unsigned t = *reinterpret_cast<const unsigned*>(p);
    v[0] = bf16_lo(t); v[1] = bf16_hi(t);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
    *reinterpret_cast<unsigned*>(p) = pack_bf16(v[0], v[1]);
  }
};

template <>
struct Cols<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[1]) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// The problems of a batched launch: blockIdx.y = i rotates problem p[i].
constexpr int kMaxProblems = 64;
struct Problems {
  int p[kMaxProblems];
};

// One block's columns of one rotation.
template <typename T, int KREG, int COLS>
__device__ __forceinline__ void transform_body(T* V, const float* __restrict__ U,
                                               long long u_rs, long long u_cs,
                                               int kmax, long long ncols, int m_out) {
  extern __shared__ __align__(16) float sU[];  // (m_out, KREG): row i = U[:, i], 0 beyond kmax
  const long long e = ((long long)blockIdx.x * kThreads + threadIdx.x) * COLS;
  const bool live = e < ncols;
  float v[KREG][COLS];
#pragma unroll
  for (int j = 0; j < KREG; ++j) {
    if (live && j < kmax) {
      Cols<T, COLS>::load(V + j * ncols + e, v[j]);
    } else {
#pragma unroll
      for (int c = 0; c < COLS; ++c) v[j][c] = 0.f;
    }
  }
  for (int t = threadIdx.x; t < m_out * KREG; t += kThreads) {
    const int i = t / KREG, j = t % KREG;
    sU[t] = j < kmax ? U[j * u_rs + i * u_cs] : 0.f;
  }
  __syncthreads();
  if (!live) return;
  for (int i = 0; i < m_out; ++i) {
    const float4* u4 = reinterpret_cast<const float4*>(sU + i * KREG);
    float acc[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
#pragma unroll
    for (int q = 0; q < KREG / 4; ++q) {
      if (4 * q < kmax) {
        const float4 u = u4[q];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = fmaf(u.x, v[4 * q][c], acc[c]);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = fmaf(u.y, v[4 * q + 1][c], acc[c]);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = fmaf(u.z, v[4 * q + 2][c], acc[c]);
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = fmaf(u.w, v[4 * q + 3][c], acc[c]);
      }
    }
    Cols<T, COLS>::store(V + i * ncols + e, acc);
  }
}

// MINB: blocks an SM must hold (bounds the registers a thread may take).
template <typename T, int KREG, int COLS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
transform_kernel(T* V, const float* __restrict__ U, long long u_rs,
                 long long u_cs, int kmax, long long ncols, int m_out) {
  transform_body<T, KREG, COLS>(V, U, u_rs, u_cs, kmax, ncols, m_out);
}

// The batched rotation: blockIdx.y picks problem p of V (P, kmax, ncols) and
// of U, whose problem stride is u_ps.
template <typename T, int KREG, int COLS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
transform_batched_kernel(T* V, const float* __restrict__ U, long long u_ps,
                         long long u_rs, long long u_cs, int kmax, long long ncols,
                         int m_out, Problems probs) {
  const int p = probs.p[blockIdx.y];
  transform_body<T, KREG, COLS>(V + (long long)p * kmax * ncols, U + p * u_ps, u_rs,
                                u_cs, kmax, ncols, m_out);
}

// nprob == 0: the one-problem kernel; else the batched one over nprob problems.
template <typename T, int KREG, int COLS, int MINB>
cudaError_t launch(T* V, const float* U, long long u_ps, long long u_rs,
                   long long u_cs, int kmax, long long ncols, int m_out,
                   int nprob, const Problems& probs, cudaStream_t stream) {
  if (ncols % COLS != 0) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)m_out * KREG;
  if (smem > 48 * 1024) {
    cudaError_t err = nprob
        ? cudaFuncSetAttribute(transform_batched_kernel<T, KREG, COLS, MINB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)
        : cudaFuncSetAttribute(transform_kernel<T, KREG, COLS, MINB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long per_block = (long long)kThreads * COLS;
  const long long blocks = (ncols + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (nprob)
    transform_batched_kernel<T, KREG, COLS, MINB>
        <<<dim3((unsigned)blocks, nprob), kThreads, smem, stream>>>(
            V, U, u_ps, u_rs, u_cs, kmax, ncols, m_out, probs);
  else
    transform_kernel<T, KREG, COLS, MINB><<<(unsigned)blocks, kThreads, smem, stream>>>(
        V, U, u_rs, u_cs, kmax, ncols, m_out);
  return cudaGetLastError();
}

// The ladder: (KREG, COLS, MINB) by kmax.  A thread moves 4 bytes per row
// where that keeps it near 64 registers, so 8 blocks of 4 warps share an SM.
template <typename T>
cudaError_t dispatch(T* V, const float* U, long long u_ps, long long u_rs,
                     long long u_cs, int kmax, long long ncols, int m_out,
                     int nprob, const Problems& pr, cudaStream_t s) {
  constexpr bool kHalf = sizeof(T) == 2;  // bfloat16: twice the columns per word
  if (kmax <= 16)
    return launch<T, 16, kHalf ? 4 : 2, kHalf ? 5 : 8>(V, U, u_ps, u_rs, u_cs, kmax, ncols,
                                                       m_out, nprob, pr, s);
  if (kmax <= 32)
    return launch<T, 32, kHalf ? 2 : 1, kHalf ? 6 : 8>(V, U, u_ps, u_rs, u_cs, kmax, ncols,
                                                       m_out, nprob, pr, s);
  if (kmax <= 64)
    return launch<T, 64, kHalf ? 2 : 1, kHalf ? 3 : 4>(V, U, u_ps, u_rs, u_cs, kmax, ncols,
                                                       m_out, nprob, pr, s);
  return launch<T, 128, 1, 3>(V, U, u_ps, u_rs, u_cs, kmax, ncols, m_out, nprob, pr, s);
}

}  // namespace

extern "C" {

// The rung that serves kmax: registers per column (= the padded length of a
// row of U in shared memory) and columns per thread.
void kk_transform_rung(int kmax, int bf16, int* kreg, int* cols) {
  const int w = bf16 ? 2 : 1;
  if (kmax <= 16) { *kreg = 16; *cols = 2 * w; }
  else if (kmax <= 32) { *kreg = 32; *cols = w; }
  else if (kmax <= 64) { *kreg = 64; *cols = w; }
  else { *kreg = 128; *cols = 1; }
}

// V: (kmax, ncols) on the device, float32 (bf16 == 0) or bfloat16 (bf16 == 1),
// rotated in place; its rows start on 16-byte boundaries (ncols % 4 == 0).
// U: float32 on the device, U[j, i] at U[j * u_rs + i * u_cs]; only its first
// m_out columns are read.  Returns cudaGetLastError() after the launch.
int kk_transform_partial(void* V, const float* U, long long u_rs, long long u_cs,
                         int kmax, long long ncols, int m_out, int bf16,
                         void* stream) {
  if (kmax < 1 || kmax > 128 || m_out < 1 || m_out > kmax || ncols < 1 ||
      ncols % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const Problems none = {};
  if (bf16)
    return (int)dispatch((__nv_bfloat16*)V, U, 0, u_rs, u_cs, kmax, ncols, m_out, 0, none, s);
  return (int)dispatch((float*)V, U, 0, u_rs, u_cs, kmax, ncols, m_out, 0, none, s);
}

// The batched rotation: V (P, kmax, ncols) on the device; problem p[i] (a
// HOST array of nprob <= kMaxProblems entries) is rotated by U + p[i] * u_ps
// as kk_transform_partial rotates one basis.  The bases of the problems not
// named are not touched.
int kk_transform_partial_batched(void* V, const float* U, long long u_ps,
                                 long long u_rs, long long u_cs, int kmax,
                                 long long ncols, int m_out, int bf16, int nprob,
                                 const int* p, void* stream) {
  if (kmax < 1 || kmax > 128 || m_out < 1 || m_out > kmax || ncols < 1 ||
      ncols % 4 != 0 || nprob < 1 || nprob > kMaxProblems)
    return (int)cudaErrorInvalidValue;
  Problems probs;
  for (int i = 0; i < nprob; ++i) {
    if (p[i] < 0) return (int)cudaErrorInvalidValue;
    probs.p[i] = p[i];
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return (int)dispatch((__nv_bfloat16*)V, U, u_ps, u_rs, u_cs, kmax, ncols, m_out, nprob,
                         probs, s);
  return (int)dispatch((float*)V, U, u_ps, u_rs, u_cs, kmax, ncols, m_out, nprob, probs, s);
}

const char* kk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
