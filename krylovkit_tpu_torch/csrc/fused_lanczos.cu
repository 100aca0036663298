// One fused Krylov expansion step for a constant-coefficient stencil operator.
//
// Replaces the TPU kernel krylovkit_tpu/ops/pallas_fused_lanczos.py:_fused_kernel
// (launched by fused_step).  With basis V (kmax, R, 128), y = A R_k, subtract
// coefficients g[:B] and scale gamma = g[kmax], one step
//   1. forms   w' = gamma * y - sum_{j<B} g_j V[j]
//   2. writes  w' in place as basis row kp1 (kp1 >= B: that row is never read)
//   3. applies y' = A w' with the stencil: flat chains, or 2-D grids with a
//      per-lane grid-column mask for dx taps; zero outside [0, n)
//   4. reduces <V_j, y'> (j < B), with_drift: <V_j, w'>, then <w', y'>, |w'|^2
// into raw = [r(B) | d(B) | rp | q] (without drift: [r(B) | rp | q]).
//
// Bound on an H100: memory.  The step must read B basis rows and y and write
// row kp1 and y': (B + 3) * n * 4 bytes, 285 MB at B = 31, n = 2^21, which is
// 85 us at 3.35 TB/s; its ~(6B + 2 taps + 4) flops per element take 6 us at
// the 67 TFLOP/s float32 rate.
//
// Design.  The TPU walks row tiles in order and carries the reductions across
// grid steps; CUDA blocks run in no order, so:
//   * each block walks a contiguous run of kRunRows = 64 layout rows (256
//     blocks at R = 16384, all resident at once), two rows per step, one
//     thread per (row, lane).  A ring of 2h + 2 rows of w' in shared memory
//     takes the place of the TPU's (T + 2h)-row window: a step computes w'
//     for the two rows h ahead (reading V[:B] and y from global memory once,
//     writing row kp1), then y' for its own two rows from the ring;
//   * halo rows of w' (h above and below the run) are recomputed from global
//     V and y: no halo caches, a 2h/64 overhead that neighbouring blocks
//     mostly serve from L2;
//   * the reductions need V[:B] of a row again after its y' is known, h rows
//     after the row was first read; that re-read hits L1/L2, so the basis
//     crosses HBM once per step.  Each thread keeps its slot sums in
//     registers over the whole run (KACC-wide arrays, a template bound on B);
//   * at the end of the run each block sums its threads (warp shuffles, then
//     its warps in a fixed order) into one partial per slot, and a second
//     kernel sums the partials of each slot in a fixed order, so the result
//     does not vary from run to run (no float atomics).
// Rows outside [0, R) are zero in the ring, which is the Dirichlet
// truncation.  All arithmetic is float32 FMAs; nothing uses tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 2 * kLanes;  // two rows per step
constexpr int kWarps = kThreads / 32;
constexpr int kRunRows = 64;
constexpr int kMaxTaps = 16;
constexpr int kMaxSlots = 128;
constexpr int kMaxHalo = 32;

struct Taps {
  int n;
  float coef[kMaxTaps];
  int d[kMaxTaps];   // flat offset qrow * 128 + r on the (R, 128) layout
  int dx[kMaxTaps];  // grid-column offset for the lane mask (grid specs)
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int ring_slot(int row, int nr) {
  const int s = row % nr;
  return s < 0 ? s + nr : s;
}

// KACC: register bound on B; DRIFT: also reduce <V_j, w'>.
template <int KACC, bool DRIFT>
__global__ void __launch_bounds__(kThreads, KACC <= 32 ? 2 : 1)
fused_step_kernel(float* V, const float* __restrict__ y,
                  float* __restrict__ ynext, const float* __restrict__ g,
                  float* __restrict__ partials, int kmax, int R, int B, int kp1,
                  int h, int gc, int mrow, Taps taps) {
  extern __shared__ float smem[];
  const int nr = 2 * h + 2;
  float* sRing = smem;                 // (nr, 128): w' of rows i-h .. i+1+h
  float* sG = sRing + nr * kLanes;     // g[:B], gamma at [B]
  float* sRed = sG + kMaxSlots;        // (kWarps, nslots) warp sums
  const long long N = (long long)R * kLanes;
  const int lane = threadIdx.x % kLanes, half = threadIdx.x / kLanes;
  const int r0 = blockIdx.x * kRunRows;
  const int r1 = min(r0 + kRunRows, R);
  const int nslots = DRIFT ? 2 * B + 2 : B + 2;

  for (int t = threadIdx.x; t < B; t += kThreads) sG[t] = g[t];
  if (threadIdx.x == 0) sG[B] = g[kmax];
  __syncthreads();

  // w' of one element; rows of this run also go to V[kp1]
  auto w_at = [&](int row) -> float {
    if (row < 0 || row >= R) return 0.f;
    const long long e = (long long)row * kLanes + lane;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < KACC; ++j)
      if (j < B) acc = fmaf(sG[j], V[j * N + e], acc);
    const float w = sG[B] * y[e] - acc;
    if (row >= r0 && row < r1) V[kp1 * N + e] = w;
    return w;
  };

  for (int p = 0; p < 2 * h; p += 2) {  // rows r0-h .. r0+h-1
    const int row = r0 - h + p + half;
    sRing[ring_slot(row, nr) * kLanes + lane] = w_at(row);
  }

  float acc_r[KACC], acc_d[KACC];
#pragma unroll
  for (int j = 0; j < KACC; ++j) acc_r[j] = acc_d[j] = 0.f;
  float rp = 0.f, qq = 0.f;

  for (int i = r0; i < r1; i += 2) {
    const int ahead = i + h + half;
    sRing[ring_slot(ahead, nr) * kLanes + lane] = w_at(ahead);
    __syncthreads();
    const int row = i + half;
    if (row < r1) {
      const int ix = gc ? (row % mrow) * kLanes + lane : 0;
      float yv = 0.f;
      for (int p = 0; p < taps.n; ++p) {
        const int t = lane + taps.d[p];
        const int dq = t >= 0 ? t / kLanes : -((kLanes - 1 - t) / kLanes);
        float v = sRing[ring_slot(row + dq, nr) * kLanes + (t - dq * kLanes)];
        const int dx = taps.dx[p];
        if (gc && dx && (ix + dx < 0 || ix + dx >= gc)) v = 0.f;
        yv = fmaf(taps.coef[p], v, yv);
      }
      const long long e = (long long)row * kLanes + lane;
      ynext[e] = yv;
      const float wv = sRing[ring_slot(row, nr) * kLanes + lane];
#pragma unroll
      for (int j = 0; j < KACC; ++j) {
        if (j < B) {
          const float v = V[j * N + e];
          acc_r[j] = fmaf(v, yv, acc_r[j]);
          if (DRIFT) acc_d[j] = fmaf(v, wv, acc_d[j]);
        }
      }
      rp = fmaf(wv, yv, rp);
      qq = fmaf(wv, wv, qq);
    }
    __syncthreads();
  }

  const int warp = threadIdx.x / 32, lane32 = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < KACC; ++j) {
    if (j < B) {
      const float sr = warp_sum(acc_r[j]);
      if (lane32 == 0) sRed[warp * nslots + j] = sr;
      if (DRIFT) {
        const float sd = warp_sum(acc_d[j]);
        if (lane32 == 0) sRed[warp * nslots + B + j] = sd;
      }
    }
  }
  rp = warp_sum(rp);
  qq = warp_sum(qq);
  if (lane32 == 0) {
    sRed[warp * nslots + nslots - 2] = rp;
    sRed[warp * nslots + nslots - 1] = qq;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < nslots; s += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += sRed[w * nslots + s];
    partials[(long long)blockIdx.x * nslots + s] = acc;
  }
}

// raw[s] = sum over blocks of partials[b, s], in a fixed order
__global__ void __launch_bounds__(256)
reduce_partials(const float* __restrict__ partials, float* __restrict__ raw,
                int nblocks, int nslots) {
  __shared__ float s[256];
  const int slot = blockIdx.x;
  float acc = 0.f;
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    acc += partials[(long long)b * nslots + slot];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) s[threadIdx.x] += s[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) raw[slot] = s[0];
}

template <int KACC, bool DRIFT>
void launch_step(int nblocks, size_t smem, cudaStream_t s, float* V,
                 const float* y, float* ynext, const float* g, float* partials,
                 int kmax, int R, int B, int kp1, int h, int gc, int mrow,
                 const Taps& taps) {
  fused_step_kernel<KACC, DRIFT><<<nblocks, kThreads, smem, s>>>(
      V, y, ynext, g, partials, kmax, R, B, kp1, h, gc, mrow, taps);
}

}  // namespace

extern "C" {

// Number of blocks (and rows of the partials scratch) for R layout rows.
int kk_fused_step_blocks(int R) { return (R + kRunRows - 1) / kRunRows; }

// V (kmax, R, 128) float32, row kp1 written in place; y, ynext (R, 128);
// g (kmax + 1); partials (kk_fused_step_blocks(R), nslots) scratch;
// raw (nslots) out.  coef/d/dx are HOST arrays of ntaps entries.
// Returns cudaGetLastError() after the launches.
int kk_fused_step(float* V, const float* y, float* ynext, const float* g,
                  float* partials, float* raw, int kmax, int R, int B, int kp1,
                  int with_drift, int h, int gc, int mrow, int ntaps,
                  const float* coef, const int* d, const int* dx,
                  void* stream) {
  const int nslots = with_drift ? 2 * B + 2 : B + 2;
  if (ntaps < 1 || ntaps > kMaxTaps || h < 1 || h > kMaxHalo || B < 1 ||
      kp1 < B || kp1 >= kmax || nslots > kMaxSlots || R < 1 ||
      (gc && mrow < 1))
    return (int)cudaErrorInvalidValue;
  Taps taps;
  taps.n = ntaps;
  for (int p = 0; p < ntaps; ++p) {
    taps.coef[p] = coef[p];
    taps.d[p] = d[p];
    taps.dx[p] = dx[p];
  }
  const int nblocks = kk_fused_step_blocks(R);
  const size_t smem =
      sizeof(float) * ((size_t)(2 * h + 2) * kLanes + kMaxSlots +
                       (size_t)kWarps * kMaxSlots);
  cudaStream_t s = (cudaStream_t)stream;
  if (with_drift) {
    if (B <= 32)
      launch_step<32, true>(nblocks, smem, s, V, y, ynext, g, partials, kmax, R, B, kp1, h, gc, mrow, taps);
    else
      launch_step<64, true>(nblocks, smem, s, V, y, ynext, g, partials, kmax, R, B, kp1, h, gc, mrow, taps);
  } else {
    if (B <= 32)
      launch_step<32, false>(nblocks, smem, s, V, y, ynext, g, partials, kmax, R, B, kp1, h, gc, mrow, taps);
    else if (B <= 64)
      launch_step<64, false>(nblocks, smem, s, V, y, ynext, g, partials, kmax, R, B, kp1, h, gc, mrow, taps);
    else
      launch_step<128, false>(nblocks, smem, s, V, y, ynext, g, partials, kmax, R, B, kp1, h, gc, mrow, taps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials<<<nslots, 256, 0, s>>>(partials, raw, nblocks, nslots);
  return (int)cudaGetLastError();
}

const char* kk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
