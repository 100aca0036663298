// Basis projections with the live length k read on the device:
//   project:    c[j] = <V[j], w> for j < k, 0 for k <= j < kmax
//   unproject:  y    = sum_{j<k} c[j] V[j]
// on a basis V (kmax, n) float32, n = R * 128.  Rows j >= k are never read.
//
// Replaces the TPU kernels krylovkit_tpu/ops/pallas_basis.py:_project_kernel
// (launched by project_pallas) and :_unproject_kernel (unproject_pallas): the
// two halves of a classical Gram-Schmidt sweep of the unfused solvers.
//
// Bound on an H100: memory.  project must read k rows and w, (k + 1) * n * 4
// bytes; unproject reads k rows and writes y (c is kmax floats), also
// (k + 1) * n * 4.  At n = 2^20 one row is 4.19 MB, 1.25 us at 3.35 TB/s, so
// k = 30 is ~39 us; the 2 flops per element read take ~1 us at the 67 TFLOP/s
// float32 rate.  A (31, 2^20) basis is 130 MB and does not fit the 50 MB L2.
//
// Design.  Both are streaming passes over columns; the TPU kernel's chunked
// double-buffered DMA, clamped last chunk and lane-replicated coefficients
// have no counterpart here.
//   * k comes through a device pointer (a 1-element int32 tensor), or by value
//     when the pointer is null; it is clamped to [0, kmax].  The grid covers
//     the columns and never depends on k, each block loops j < k: a launch is
//     the same whatever k is.
//   * a thread owns kVec chunks of 16 bytes of the row (float4 loads, a warp
//     on 512 contiguous bytes per chunk), 2048 columns per block.
//   * project keeps its chunks of w in registers, walks j = 0 .. k-1, reduces
//     each j over the warp with __shfl_down_sync and parks the warp sums in
//     shared memory, so the j loop has no block barrier.  After the loop the
//     warps are added in a fixed order into partials[block, j], and a second
//     kernel adds the blocks of each j in a fixed order (no float atomics:
//     two runs agree to the bit) and writes 0 for j >= k.
//   * unproject holds c[:k] in shared memory and accumulates j = 0 .. k-1 in
//     ascending order with float32 FMAs.
//
// Batched launches (kk_project_batched, kk_unproject_batched; the TPU kernels
// under jax.vmap, whose batching rule adds a grid axis and gives each problem
// its own k).  blockIdx.y picks a problem of a table passed by value: its
// basis pointer, its w or c pointer and its k.  Inside a problem the launch
// runs the one-problem body (same blocks, same per-block partials in a slab
// of its own, same reduce order), so each row is bit-identical to a
// one-problem launch.  A problem with k = 0 reads nothing of its basis.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 2;                    // float4 chunks per thread
constexpr int kChunks = kThreads * kVec;   // float4 chunks per block
constexpr int kMaxK = 128;                 // widest basis (rows)

__device__ __forceinline__ int live_rows(const int* kptr, int kval, int kmax) {
  const int k = kptr ? *kptr : kval;
  return k < 0 ? 0 : (k > kmax ? kmax : k);
}

__device__ __forceinline__ float warp_sum_down(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // the sum is in lane 0
}

// One block of project: the partial sums of its columns for j < k, written
// as partials[block, j].  The one-problem and the batched kernels both run
// this body, so a problem of a batched launch gets the one-problem bits.
__device__ __forceinline__ void project_block(const float4* __restrict__ V,
                                              const float4* __restrict__ w,
                                              float* __restrict__ partials, int k,
                                              int kmax, long long n4,
                                              float (*sRed)[kMaxK]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long idx[kVec];
  float4 wv[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    idx[v] = (long long)blockIdx.x * kChunks + v * kThreads + threadIdx.x;
    wv[v] = idx[v] < n4 ? w[idx[v]] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float4* row = V + (long long)j * n4;
    float acc = 0.f;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (idx[v] < n4) {
        const float4 a = row[idx[v]];
        acc = fmaf(a.x, wv[v].x, acc);
        acc = fmaf(a.y, wv[v].y, acc);
        acc = fmaf(a.z, wv[v].z, acc);
        acc = fmaf(a.w, wv[v].w, acc);
      }
    }
    acc = warp_sum_down(acc);
    if (lane == 0) sRed[warp][j] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += sRed[q][j];
    partials[(long long)blockIdx.x * kmax + j] = s;
  }
}

// c[j] = sum over blocks of partials[b, j] in a fixed order; 0 for j >= k.
// Block j of the reduce kernels (blockIdx.x = j).
__device__ __forceinline__ void reduce_column(const float* __restrict__ partials,
                                              float* __restrict__ c, int k,
                                              int kmax, int nblocks, float* s) {
  const int j = blockIdx.x;
  if (j >= k) {  // the whole block leaves: partials[:, j] was never written
    if (threadIdx.x == 0) c[j] = 0.f;
    return;
  }
  float acc = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    acc += partials[(long long)b * kmax + j];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) c[j] = s[0];
}

// One block of unproject: y[cols] = sum_{j<k} c[j] V[j][cols], ascending j.
__device__ __forceinline__ void unproject_block(const float4* __restrict__ V,
                                                const float* __restrict__ c,
                                                float4* __restrict__ y, int k,
                                                long long n4, float* sC) {
  for (int t = threadIdx.x; t < k; t += kThreads) sC[t] = c[t];
  __syncthreads();
  long long idx[kVec];
  float4 acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    idx[v] = (long long)blockIdx.x * kChunks + v * kThreads + threadIdx.x;
    acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float4* row = V + (long long)j * n4;
    const float cj = sC[j];
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (idx[v] < n4) {
        const float4 a = row[idx[v]];
        acc[v].x = fmaf(cj, a.x, acc[v].x);
        acc[v].y = fmaf(cj, a.y, acc[v].y);
        acc[v].z = fmaf(cj, a.z, acc[v].z);
        acc[v].w = fmaf(cj, a.w, acc[v].w);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    if (idx[v] < n4) y[idx[v]] = acc[v];
}

__global__ void __launch_bounds__(kThreads)
project_kernel(const float4* __restrict__ V, const float4* __restrict__ w,
               float* __restrict__ partials, const int* __restrict__ kptr,
               int kval, int kmax, long long n4) {
  __shared__ float sRed[kWarps][kMaxK];
  project_block(V, w, partials, live_rows(kptr, kval, kmax), kmax, n4, sRed);
}

__global__ void __launch_bounds__(256)
project_reduce(const float* __restrict__ partials, float* __restrict__ c,
               const int* __restrict__ kptr, int kval, int kmax, int nblocks) {
  __shared__ float s[256];
  reduce_column(partials, c, live_rows(kptr, kval, kmax), kmax, nblocks, s);
}

__global__ void __launch_bounds__(kThreads)
unproject_kernel(const float4* __restrict__ V, const float* __restrict__ c,
                 float4* __restrict__ y, const int* __restrict__ kptr, int kval,
                 int kmax, long long n4) {
  __shared__ float sC[kMaxK];
  unproject_block(V, c, y, live_rows(kptr, kval, kmax), n4, sC);
}

// The problems of a batched launch, passed by value: blockIdx.y = i runs
// problem i on its own basis V[i] (a table of pointers, so the bases need
// not be one stacked tensor), its own operand x[i] (w for project, c for
// unproject) and its own live length k[i].  64 pointers of each kind and 64
// ints are 1280 bytes, well inside the 4 KB of kernel parameters.
constexpr int kMaxProblems = 64;
struct Problems {
  const float* V[kMaxProblems];
  const float* x[kMaxProblems];
  int k[kMaxProblems];
};

// Problem i writes its partials slab partials + i * nblocks * kmax.
__global__ void __launch_bounds__(kThreads)
project_batched_kernel(const Problems prob, float* __restrict__ partials,
                       int kmax, long long n4, int nblocks) {
  __shared__ float sRed[kWarps][kMaxK];
  const int i = blockIdx.y;
  project_block((const float4*)prob.V[i], (const float4*)prob.x[i],
                partials + (long long)i * nblocks * kmax, prob.k[i], kmax, n4, sRed);
}

// Problem i's coefficients are row i of c (nprob, kmax).
__global__ void __launch_bounds__(256)
project_reduce_batched(const Problems prob, const float* __restrict__ partials,
                       float* __restrict__ c, int kmax, int nblocks) {
  __shared__ float s[256];
  const int i = blockIdx.y;
  reduce_column(partials + (long long)i * nblocks * kmax, c + (long long)i * kmax,
                prob.k[i], kmax, nblocks, s);
}

// Problem i's y is row i of y (nprob, n).
__global__ void __launch_bounds__(kThreads)
unproject_batched_kernel(const Problems prob, float4* __restrict__ y, long long n4) {
  __shared__ float sC[kMaxK];
  const int i = blockIdx.y;
  unproject_block((const float4*)prob.V[i], prob.x[i], y + (long long)i * n4,
                  prob.k[i], n4, sC);
}

bool bad_shape(int kval, int kmax, long long ncols) {
  return kmax < 1 || kmax > kMaxK || kval < 0 || kval > kmax || ncols < 4 ||
         ncols % 4 != 0;
}

}  // namespace

extern "C" {

// Number of blocks (rows of the partials scratch) for ncols columns.
int kk_project_blocks(long long ncols) {
  return (int)((ncols / 4 + kChunks - 1) / kChunks);
}

// V (kmax, ncols) and w (ncols) float32, 16-byte aligned, ncols % 4 == 0;
// partials (kk_project_blocks(ncols), kmax) scratch; c (kmax) out.  The live
// length is *kptr (device int32) when kptr is not null, else kval.
// Returns cudaGetLastError() after the launches.
int kk_project(const float* V, const float* w, float* partials, float* c,
               const int* kptr, int kval, int kmax, long long ncols,
               void* stream) {
  if (bad_shape(kval, kmax, ncols)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblocks = kk_project_blocks(ncols);
  project_kernel<<<nblocks, kThreads, 0, s>>>(
      (const float4*)V, (const float4*)w, partials, kptr, kval, kmax, ncols / 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  project_reduce<<<kmax, 256, 0, s>>>(partials, c, kptr, kval, kmax, nblocks);
  return (int)cudaGetLastError();
}

// V (kmax, ncols), c (kmax, zero beyond the live length), y (ncols) out; same
// layout rules and live-length convention as kk_project.
int kk_unproject(const float* V, const float* c, float* y, const int* kptr,
                 int kval, int kmax, long long ncols, void* stream) {
  if (bad_shape(kval, kmax, ncols)) return (int)cudaErrorInvalidValue;
  const int nblocks = kk_project_blocks(ncols);
  unproject_kernel<<<nblocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)V, c, (float4*)y, kptr, kval, kmax, ncols / 4);
  return (int)cudaGetLastError();
}

// Fills the by-value table of a batched launch; false if a k is outside
// [0, kmax] or a count is out of range.
static bool fill_problems(Problems* prob, const void* const* V, const void* const* x,
                          const int* ks, int nprob, int kmax) {
  if (nprob < 1 || nprob > kMaxProblems) return false;
  for (int i = 0; i < nprob; ++i) {
    if (ks[i] < 0 || ks[i] > kmax) return false;
    prob->V[i] = (const float*)V[i];
    prob->x[i] = (const float*)x[i];
    prob->k[i] = ks[i];
  }
  return true;
}

// Batched project: nprob <= 64 problems, HOST arrays V[i] (kmax, ncols), w[i]
// (ncols) device pointers and ks[i] live lengths; partials
// (nprob, kk_project_blocks(ncols), kmax) scratch; c (nprob, kmax) out.  Row i
// of c is what kk_project gives for (V[i], w[i], ks[i]), bit for bit.
int kk_project_batched(const void* const* V, const void* const* w, const int* ks,
                       int nprob, float* partials, float* c, int kmax,
                       long long ncols, void* stream) {
  Problems prob;
  if (bad_shape(0, kmax, ncols) || !fill_problems(&prob, V, w, ks, nprob, kmax))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblocks = kk_project_blocks(ncols);
  project_batched_kernel<<<dim3(nblocks, nprob), kThreads, 0, s>>>(
      prob, partials, kmax, ncols / 4, nblocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  project_reduce_batched<<<dim3(kmax, nprob), 256, 0, s>>>(prob, partials, c, kmax,
                                                             nblocks);
  return (int)cudaGetLastError();
}

// Batched unproject: HOST arrays V[i] (kmax, ncols), c[i] (kmax, zero beyond
// ks[i]) device pointers and ks[i]; y (nprob, ncols) out.  Row i of y is what
// kk_unproject gives for (V[i], c[i], ks[i]), bit for bit.
int kk_unproject_batched(const void* const* V, const void* const* c, const int* ks,
                         int nprob, float* y, int kmax, long long ncols,
                         void* stream) {
  Problems prob;
  if (bad_shape(0, kmax, ncols) || !fill_problems(&prob, V, c, ks, nprob, kmax))
    return (int)cudaErrorInvalidValue;
  const int nblocks = kk_project_blocks(ncols);
  unproject_batched_kernel<<<dim3(nblocks, nprob), kThreads, 0, (cudaStream_t)stream>>>(
      prob, (float4*)y, ncols / 4);
  return (int)cudaGetLastError();
}

const char* kk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
