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
// into raw = [r(B) | d(B) | rp | q] (without drift: [r(B) | rp | q]).  With no
// live row (B = 0) a staged row is y alone, w' = gamma * y and raw = [rp | q].
//
// Bound on an H100: memory.  The step must read B basis rows and y and write
// row kp1 and y': (B + 3) * n * 4 bytes, 285 MB at B = 31, n = 2^21, which is
// 85 us at 3.35 TB/s; its ~(6B + 2 taps + 4) flops per element take 6 us at
// the 67 TFLOP/s float32 rate.  What a simple kernel loses is latency: a
// block that loads, waits at a barrier, computes and only then loads again
// has nothing in flight most of the time, and short runs per block multiply
// the halo work and leave SMs idle at small R.
//
// Design (the host plans the sizes: ops/fused_lanczos.py:plan_step).
//   * Persistent grid: one or two blocks of 256 threads per SM, each walking
//     one contiguous run of `run` layout rows [r0, r1) plus h halo rows on
//     either side, so every SM is busy at any R and the halo work is 2h rows
//     per run.
//   * A ring of staged rows in shared memory, filled with cp.async (16 bytes
//     a thread, one commit group per tile of T rows, P tiles in flight): a
//     staged row is y and V[0..B) of one layout row, (B + 1) * 512 bytes.
//     Rows outside [0, R) are taken from the external halos when the
//     caller gives them (a shard of a vector split over ranks: Vext
//     (kmax, 2, h, 128) holds the h rows above and below the shard of every
//     basis row, yext (2, h, 128) those of y; the caller exchanges them
//     with the neighbouring ranks, zero at the ends of the chain); their w'
//     is then the same linear combination.  Without them (null pointers)
//     such rows are never fetched and their w' is zero, which is the
//     Dirichlet truncation.
//   * Both passes read the staged row.  Pass A forms w' of tile k from it,
//     writes it to V[kp1] (rows of the run only) and into a ring of T + 2h
//     rows of w'.  Pass B, h rows behind, forms y' from the w' ring and the
//     reductions from the staged V: the ring of staged rows holds
//     (P + 1) * T + h rows, so a row stays until its y' is known and the
//     basis crosses HBM once by construction.  Where (h + 1) staged rows do
//     not fit shared memory (wide B with a deep halo) the plan sets `reread`:
//     a row is released after pass A and pass B reads V[:B] again from
//     global memory (L2).
//   * A thread owns LPT = T / 2 consecutive lanes of one row of the tile
//     (4, 2 or 1; at T = 1 half of the threads only copy), and keeps its slot
//     sums in registers over the whole run (KACC-wide arrays, a template
//     bound on B).  Two barriers per tile.  Ring rows advance by T with a
//     compare and a subtract: an integer division per copy made the loop
//     three times slower.
//   * The time of a tile is the latency of its two passes, not its bytes
//     (measured: deeper prefetch changes nothing, taller tiles and a second
//     block on the SM do).  So the plan takes the tallest tile that fits
//     and, up to B = 22 at h = 1, two blocks of 4-row tiles per SM; the
//     32-slot kernels are held to 128 registers for that.
//   * One launch: each block sums its threads (warp shuffles, then its warps
//     in a fixed order) into one partial per slot, publishes it, and adds one
//     to an integer counter; the block that arrives last sums the partials
//     of each slot over the blocks in a fixed order and resets the counter.
//     No float atomics: two runs agree to the bit.  The counter belongs to
//     one stream at a time.
// Halo rows of w' are recomputed by the neighbouring blocks from the same
// inputs with the same instructions, so they agree to the bit.  All
// arithmetic is float32 FMAs; nothing uses tensor cores.
//
// Batched step (kk_fused_step_batched; the TPU kernel under jax.vmap, which
// pallas_call's batching rule turns into a leading grid axis): P problems,
// each with its own basis, y, g, live rows B and new row kp1, in one launch
// over a (nblocks, problems) grid.  Every block runs the one-problem code on
// its problem.  Each problem has its own slab of partials and its own
// arrival counter, so its last block sums its partials in the one-problem
// order; KACC and the shared memory come from the plan of the largest B, and
// a problem with a smaller B masks its rows as the loops already do.  Where
// every problem has the plan's B, a problem's results are those of a
// one-problem launch, bit for bit.  Bound: P times the one-problem bytes.
// On a vector split over ranks each problem passes its own external halos,
// Vext (P, kmax, 2, h, 128) and yext (P, 2, h, 128): block (x, i) hands
// problem p[i]'s slices to the one-problem body, which stages its rows
// beyond the shard from them as a one-problem launch with halos does.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 16;
constexpr int kMaxSlots = 128;
constexpr int kMaxHalo = 32;
constexpr int kMaxInFlight = 8;  // cp.async.wait_group 0..7
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may take

struct Taps {
  int n;
  float coef[kMaxTaps];
  int d[kMaxTaps];   // flat offset qrow * 128 + r on the (R, 128) layout
  int dx[kMaxTaps];  // grid-column offset for the lane mask (grid specs)
};

// What the host planned: tile rows, tiles in flight, rows of the staged ring
// and of the w' ring, whether pass B re-reads V from global memory, rows per
// block.
struct Plan {
  int T, P, NSR, NR, reread, run;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most `pending` of this thread's commit groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
  }
}

// N consecutive floats with one load or store (N = 1, 2, 4).
template <int N>
__device__ __forceinline__ void ld(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void st(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The problems of a batched launch: blockIdx.y = i runs problem p[i] with its
// own live rows B[i] and new row kp1[i].
constexpr int kMaxProblems = 64;
struct Problems {
  int p[kMaxProblems], B[kMaxProblems], kp1[kMaxProblems];
};

// One block's share of one step: the whole of the one-problem kernel, and of
// each problem of the batched one.  KACC: register bound on B; DRIFT: also
// reduce <V_j, w'>; LPT: lanes a thread owns (the tile has 2 * LPT rows, or 1
// row where plan.T == 1).  The last block writes raw[0, nslots) and zeros up
// to rawPad.
template <int KACC, bool DRIFT, int LPT>
__device__ __forceinline__ void fused_step_body(
    float* V, const float* __restrict__ y, float* __restrict__ ynext,
    const float* __restrict__ g, float* partials, float* __restrict__ raw,
    int* counter, const float* __restrict__ Vext,
    const float* __restrict__ yext, int kmax, int R, int B, int kp1, int h,
    int gc, int mrow, const Plan& plan, const Taps& taps, int rawPad) {
  extern __shared__ __align__(16) float smem[];
  const int T = plan.T, P = plan.P, NSR = plan.NSR, NR = plan.NR;
  const int rowf = (B + 1) * kLanes;           // floats of a staged row: y, V[0..B)
  float* sStage = smem;                        // (NSR, B + 1, 128)
  float* sRing = sStage + (size_t)NSR * rowf;  // (NR, 128): w' of the rows in reach
  float* sG = sRing + NR * kLanes;             // g[:B], gamma at [127]
  float* sRed = sG + kMaxSlots;                // (kWarps, kMaxSlots) warp sums
  int* sLast = reinterpret_cast<int*>(sRed + kWarps * kMaxSlots);  // 16 bytes
  const long long N = (long long)R * kLanes;
  const int tid = threadIdx.x, warp = tid / 32, lane32 = tid % 32;
  const int r0 = blockIdx.x * plan.run;
  const int r1 = min(r0 + plan.run, R);
  const int s0 = r0 - h, s1 = r1 + h;  // rows whose w' this block forms
  const int ntiles = (s1 - s0 + T - 1) / T;
  const int nslots = DRIFT ? 2 * B + 2 : B + 2;
  const bool ext = Vext != nullptr;  // rows outside [0, R) come from the halos
  const long long extRow = 2LL * h * kLanes;  // floats of one basis row's halos

  // g[:B], zeros up to [126] (pass A reads g four at a time), gamma at [127]
  for (int t = tid; t < kMaxSlots; t += kThreads)
    sG[t] = t < B ? g[t] : (t == kMaxSlots - 1 ? g[kmax] : 0.f);

  constexpr int TPR = kLanes / LPT;  // threads per row
  const int ti = tid / TPR;          // this thread's row of the tile
  const int lane0 = (tid % TPR) * LPT;
  const bool active = ti < T;

  // The T rows from `base` on, whose first has ring row `slot0`: warp w
  // copies the 512-byte runs j = w, w + 8, ... (y, then V[j - 1]) of each;
  // a row outside [0, R) from the external halos (side 0 above, 1 below).
  auto load_tile = [&](int base, int slot0) {
    for (int i = 0; i < T; ++i) {
      const int row = base + i;
      if (row >= s1) continue;
      const bool inside = row >= 0 && row < R;
      if (!inside && !ext) continue;
      int slot = slot0 + i;
      if (slot >= NSR) slot -= NSR;
      float* dst = sStage + (size_t)slot * rowf + lane32 * 4;
      if (inside) {
        const long long off = (long long)row * kLanes + lane32 * 4;
        for (int j = warp; j <= B; j += kWarps)
          cp_async16(dst + j * kLanes, (j == 0 ? y : V + (long long)(j - 1) * N) + off);
      } else {
        const long long off =
            (long long)(row < 0 ? row + h : h + row - R) * kLanes + lane32 * 4;
        for (int j = warp; j <= B; j += kWarps)
          cp_async16(dst + j * kLanes, (j == 0 ? yext : Vext + (long long)(j - 1) * extRow) + off);
      }
    }
  };

  // Rows and ring rows advance by T a tile; no division inside the loop.
  auto advance = [](int& x, int step, int size) {
    x += step;
    if (x >= size) x -= size;
  };
  auto modulo = [](int x, int size) {
    x %= size;
    return x < 0 ? x + size : x;
  };
  for (int k = 0; k < P; ++k) {
    load_tile(s0 + k * T, k * T);
    cp_async_commit();
  }
  int ldRow = s0 + P * T, ldSlot = P * T;            // next tile to copy
  int aRow = s0 + ti, aSlot = ti, aRing = ti;         // pass A: tile k
  int bRow = s0 - h + ti;                             // pass B: h rows behind
  int bSlot = modulo(ti - h, NSR), bRing = modulo(ti - h, NR);
  int bMod = gc ? modulo(bRow, mrow) : 0;             // bRow % mrow
  const int stepMod = gc ? T % mrow : 0;

  float acc_r[KACC], acc_d[DRIFT ? KACC : 1];
#pragma unroll
  for (int j = 0; j < KACC; ++j) acc_r[j] = 0.f;
#pragma unroll
  for (int j = 0; j < (DRIFT ? KACC : 1); ++j) acc_d[j] = 0.f;
  float rp = 0.f, qq = 0.f;

  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait(P - 1);  // this thread's copies of tile k have landed
    __syncthreads();       // ... and everyone's; pass B of tile k - 1 is over
    load_tile(ldRow, ldSlot);  // into the rows that pass B of tile k - 1 released
    cp_async_commit();
    ldRow += T;
    advance(ldSlot, T, NSR);

    // pass A: w' of tile k
    if (active) {
      const int row = aRow;
      float w[LPT];
#pragma unroll
      for (int l = 0; l < LPT; ++l) w[l] = 0.f;
      if (row < s1 && (ext || (row >= 0 && row < R))) {
        const float* sv = sStage + (size_t)aSlot * rowf + lane0;
        float acc[LPT];
#pragma unroll
        for (int l = 0; l < LPT; ++l) acc[l] = 0.f;
#pragma unroll 2
        for (int j = 0; j < B; j += 4) {
          const float4 g4 = *reinterpret_cast<const float4*>(sG + j);
          const float gq[4] = {g4.x, g4.y, g4.z, g4.w};
          float v[4][LPT];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (j + q < B) {
              ld<LPT>(sv + (j + q + 1) * kLanes, v[q]);
            } else {
#pragma unroll
              for (int l = 0; l < LPT; ++l) v[q][l] = 0.f;
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int l = 0; l < LPT; ++l) acc[l] = fmaf(gq[q], v[q][l], acc[l]);
        }
        float yv[LPT];
        ld<LPT>(sv, yv);
        const float gamma = sG[kMaxSlots - 1];
#pragma unroll
        for (int l = 0; l < LPT; ++l) w[l] = gamma * yv[l] - acc[l];
        if (row >= r0 && row < r1)
          st<LPT>(V + (long long)kp1 * N + (long long)row * kLanes + lane0, w);
      }
      if (row < s1) st<LPT>(sRing + aRing * kLanes + lane0, w);
    }
    aRow += T;
    advance(aSlot, T, NSR);
    advance(aRing, T, NR);
    __syncthreads();

    // pass B: y' and the reductions of the T rows that lie h behind tile k
    if (active) {
      const int row = bRow;
      if (row >= r0 && row < r1) {
        const int rb = bRing;
        const int ix0 = bMod * kLanes + lane0;
        float yv[LPT];
#pragma unroll
        for (int l = 0; l < LPT; ++l) yv[l] = 0.f;
        for (int p = 0; p < taps.n; ++p) {
          const int d = taps.d[p], dx = taps.dx[p];
          const float c = taps.coef[p];
#pragma unroll
          for (int l = 0; l < LPT; ++l) {
            const int t = lane0 + l + d;
            const int dq = t >= 0 ? t / kLanes : -((kLanes - 1 - t) / kLanes);
            int slot = rb + dq;
            if (slot < 0) slot += NR;
            else if (slot >= NR) slot -= NR;
            float v = sRing[slot * kLanes + (t - dq * kLanes)];
            if (gc && dx) {
              const int ix = ix0 + l + dx;
              if (ix < 0 || ix >= gc) v = 0.f;
            }
            yv[l] = fmaf(c, v, yv[l]);
          }
        }
        st<LPT>(ynext + (long long)row * kLanes + lane0, yv);
        float wv[LPT];
        ld<LPT>(sRing + rb * kLanes + lane0, wv);
        // slot sums over V[j] of this row, read from `vb` with row stride `vs`
        auto reduce = [&](const float* vb, long long vs) {
#pragma unroll
          for (int j0 = 0; j0 < KACC; j0 += 8) {
            if (j0 < B) {
#pragma unroll
              for (int j = j0; j < j0 + 8; ++j) {
                if (j < B) {
                  float v[LPT];
                  ld<LPT>(vb + j * vs, v);
#pragma unroll
                  for (int l = 0; l < LPT; ++l) {
                    acc_r[j] = fmaf(v[l], yv[l], acc_r[j]);
                    if constexpr (DRIFT) acc_d[j] = fmaf(v[l], wv[l], acc_d[j]);
                  }
                }
              }
            }
          }
        };
        if (plan.reread)
          reduce(V + (long long)row * kLanes + lane0, N);
        else
          reduce(sStage + (size_t)bSlot * rowf + kLanes + lane0, kLanes);
#pragma unroll
        for (int l = 0; l < LPT; ++l) {
          rp = fmaf(wv[l], yv[l], rp);
          qq = fmaf(wv[l], wv[l], qq);
        }
      }
    }
    bRow += T;
    advance(bSlot, T, NSR);
    advance(bRing, T, NR);
    advance(bMod, stepMod, mrow);
  }
  cp_async_wait(0);

  // this block's partial of each slot: threads by shuffles, warps in order
#pragma unroll
  for (int j = 0; j < KACC; ++j) {
    if (j < B) {
      const float sr = warp_sum(acc_r[j]);
      if (lane32 == 0) sRed[warp * kMaxSlots + j] = sr;
      if constexpr (DRIFT) {
        const float sd = warp_sum(acc_d[j]);
        if (lane32 == 0) sRed[warp * kMaxSlots + B + j] = sd;
      }
    }
  }
  rp = warp_sum(rp);
  qq = warp_sum(qq);
  if (lane32 == 0) {
    sRed[warp * kMaxSlots + nslots - 2] = rp;
    sRed[warp * kMaxSlots + nslots - 1] = qq;
  }
  __syncthreads();
  for (int s = tid; s < nslots; s += kThreads) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += sRed[w * kMaxSlots + s];
    partials[(long long)blockIdx.x * nslots + s] = acc;
  }

  // the block that arrives last sums the partials of every block
  __threadfence();
  __syncthreads();
  if (tid == 0) *sLast = atomicAdd(counter, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!*sLast) return;
  __threadfence();
  int pad = 4;  // nslots rounded up to a power of two, <= 128
  while (pad < nslots) pad <<= 1;
  const int C = kThreads / pad;  // chunks of blocks, summed side by side
  const int s = tid % pad, c = tid / pad;
  const int nb = (int)gridDim.x, per = (nb + C - 1) / C;
  float acc = 0.f;
  if (s < nslots) {
    const int b1 = min(nb, (c + 1) * per);
#pragma unroll 8
    for (int b = c * per; b < b1; ++b) acc += __ldcg(partials + (long long)b * nslots + s);
  }
  sRed[c * pad + s] = acc;
  __syncthreads();
  if (tid < nslots) {
    float t = 0.f;
    for (int cc = 0; cc < C; ++cc) t += sRed[cc * pad + tid];
    raw[tid] = t;
  } else if (tid < rawPad) {
    raw[tid] = 0.f;
  }
  if (tid == 0) *counter = 0;
}

template <int KACC, bool DRIFT, int LPT>
__global__ void __launch_bounds__(kThreads, KACC <= 32 ? 2 : 1)
fused_step_kernel(float* V, const float* __restrict__ y,
                  float* __restrict__ ynext, const float* __restrict__ g,
                  float* partials, float* __restrict__ raw, int* counter,
                  const float* __restrict__ Vext, const float* __restrict__ yext,
                  int kmax, int R, int B, int kp1, int h, int gc, int mrow,
                  Plan plan, Taps taps) {
  fused_step_body<KACC, DRIFT, LPT>(V, y, ynext, g, partials, raw, counter,
                                    Vext, yext, kmax, R, B, kp1, h, gc, mrow,
                                    plan, taps, 0);
}

// The batched step: blockIdx.y picks problem p of V (P, kmax, R, 128), y and
// ynext (P, R, 128), g (P, kmax + 1) and raw (P, rawPad); each problem has
// its own slab of partials (nblocks, rawPad) and its own arrival counter.
template <int KACC, bool DRIFT, int LPT>
__global__ void __launch_bounds__(kThreads, KACC <= 32 ? 2 : 1)
fused_step_batched_kernel(float* V, const float* __restrict__ y,
                          float* __restrict__ ynext, const float* __restrict__ g,
                          float* partials, float* __restrict__ raw, int* counters,
                          const float* __restrict__ Vext, const float* __restrict__ yext,
                          int kmax, int R, int h, int gc, int mrow, int rawPad,
                          Plan plan, Taps taps, Problems probs) {
  const int i = blockIdx.y, p = probs.p[i];
  const long long N = (long long)R * kLanes;
  const long long extRow = 2LL * h * kLanes;  // floats of one basis row's halos
  fused_step_body<KACC, DRIFT, LPT>(
      V + (long long)p * kmax * N, y + (long long)p * N, ynext + (long long)p * N,
      g + (long long)p * (kmax + 1), partials + (long long)i * gridDim.x * rawPad,
      raw + (long long)p * rawPad, counters + i,
      Vext ? Vext + (long long)p * kmax * extRow : nullptr,
      yext ? yext + (long long)p * extRow : nullptr, kmax, R,
      probs.B[i], probs.kp1[i], h, gc, mrow, plan, taps, rawPad);
}

// Allow a kernel the full shared memory, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&raised)[64]) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && raised[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  if (err == cudaSuccess && dev >= 0 && dev < 64) raised[dev] = true;
  return err;
}

template <int KACC, bool DRIFT, int LPT>
cudaError_t launch_step(int nblocks, size_t smem, cudaStream_t s, float* V,
                        const float* y, float* ynext, const float* g,
                        float* partials, float* raw, int* counter,
                        const float* Vext, const float* yext, int kmax,
                        int R, int B, int kp1, int h, int gc, int mrow,
                        const Plan& plan, const Taps& taps) {
  // per instantiation and device: allow the full shared memory, once
  static bool raised[64] = {};
  cudaError_t err = allow_smem(fused_step_kernel<KACC, DRIFT, LPT>, raised);
  if (err != cudaSuccess) return err;
  fused_step_kernel<KACC, DRIFT, LPT><<<nblocks, kThreads, smem, s>>>(
      V, y, ynext, g, partials, raw, counter, Vext, yext, kmax, R, B, kp1, h,
      gc, mrow, plan, taps);
  return cudaGetLastError();
}

template <int KACC, bool DRIFT, int LPT>
cudaError_t launch_batched(int nblocks, int nprob, size_t smem, cudaStream_t s,
                           float* V, const float* y, float* ynext, const float* g,
                           float* partials, float* raw, int* counters,
                           const float* Vext, const float* yext, int kmax,
                           int R, int h, int gc, int mrow, int rawPad,
                           const Plan& plan, const Taps& taps, const Problems& probs) {
  static bool raised[64] = {};
  cudaError_t err = allow_smem(fused_step_batched_kernel<KACC, DRIFT, LPT>, raised);
  if (err != cudaSuccess) return err;
  fused_step_batched_kernel<KACC, DRIFT, LPT><<<dim3(nblocks, nprob), kThreads, smem, s>>>(
      V, y, ynext, g, partials, raw, counters, Vext, yext, kmax, R, h, gc, mrow, rawPad,
      plan, taps, probs);
  return cudaGetLastError();
}

// The host's plan, checked against what the kernel needs at B live rows.
bool plan_ok(int T, int P, int NSR, int NR, int reread, int run, int nblocks,
             int smem_bytes, int R, int B, int h) {
  const int lpt = T == 8 ? 4 : T == 4 ? 2 : 1;
  const long long need =
      4LL * ((long long)NSR * (B + 1) * kLanes + (long long)NR * kLanes +
             kMaxSlots + kWarps * kMaxSlots + 4);
  return (T == 1 || T == 2 || T == 4 || T == 8) && P >= 1 && P <= kMaxInFlight &&
         NR >= T + 2 * h && NSR >= (P + 1) * T + (reread ? 0 : h) && run >= 1 &&
         nblocks >= 1 && (long long)nblocks * run >= R &&
         (long long)(nblocks - 1) * run < R && smem_bytes >= need &&
         smem_bytes <= kSmemLimit && !(lpt > 1 && B > 32);
}

bool taps_from_host(int ntaps, const float* coef, const int* d, const int* dx, Taps& taps) {
  if (ntaps < 1 || ntaps > kMaxTaps) return false;
  taps.n = ntaps;
  for (int p = 0; p < ntaps; ++p) {
    taps.coef[p] = coef[p];
    taps.d[p] = d[p];
    taps.dx[p] = dx[p];
  }
  return true;
}

}  // namespace

extern "C" {

// V (kmax, R, 128) float32, row kp1 written in place; y, ynext (R, 128);
// g (kmax + 1); partials (nblocks, nslots) scratch; raw (nslots) out; counter
// one int32 that is 0 before the first launch (the kernel leaves it 0).
// Vext (kmax, 2, h, 128) and yext (2, h, 128): the rows above (side 0) and
// below (side 1) the shard of each basis row and of y, 16-byte aligned; both
// null for an unsplit vector (zero beyond [0, R)), or both given.
// coef/d/dx are HOST arrays of ntaps entries.  T, P, NSR, NR, reread, run,
// nblocks and smem_bytes are the host's plan (ops/fused_lanczos.py:plan_step),
// checked here.  Returns cudaGetLastError() after the launch.
int kk_fused_step(float* V, const float* y, float* ynext, const float* g,
                  float* partials, float* raw, int* counter, const float* Vext,
                  const float* yext, int kmax, int R,
                  int B, int kp1, int with_drift, int h, int gc, int mrow,
                  int ntaps, const float* coef, const int* d, const int* dx,
                  int T, int P, int NSR, int NR, int reread, int run,
                  int nblocks, int smem_bytes, void* stream) {
  const int nslots = with_drift ? 2 * B + 2 : B + 2;
  if (ntaps < 1 || ntaps > kMaxTaps || h < 1 || h > kMaxHalo || B < 0 ||
      kp1 < B || kp1 >= kmax || nslots > kMaxSlots || R < 1 ||
      (gc && mrow < 1) || ((Vext == nullptr) != (yext == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int lpt = T == 8 ? 4 : T == 4 ? 2 : 1;
  Taps taps;
  if (!plan_ok(T, P, NSR, NR, reread, run, nblocks, smem_bytes, R, B, h) ||
      !taps_from_host(ntaps, coef, d, dx, taps))
    return (int)cudaErrorInvalidValue;
  const Plan plan = {T, P, NSR, NR, reread, run};
  cudaStream_t s = (cudaStream_t)stream;
#define KK_STEP(KACC, DRIFT, LPT)                                              \
  return (int)launch_step<KACC, DRIFT, LPT>(nblocks, (size_t)smem_bytes, s, V, \
                                            y, ynext, g, partials, raw,        \
                                            counter, Vext, yext, kmax, R, B,   \
                                            kp1, h, gc, mrow, plan, taps)
  if (with_drift) {
    if (B <= 32) {
      if (lpt == 4) KK_STEP(32, true, 4);
      if (lpt == 2) KK_STEP(32, true, 2);
      KK_STEP(32, true, 1);
    }
    KK_STEP(64, true, 1);
  }
  if (B <= 32) {
    if (lpt == 4) KK_STEP(32, false, 4);
    if (lpt == 2) KK_STEP(32, false, 2);
    KK_STEP(32, false, 1);
  }
  if (B <= 64) KK_STEP(64, false, 1);
  KK_STEP(128, false, 1);
#undef KK_STEP
}

// The batched step: V (P, kmax, R, 128), y and ynext (P, R, 128), g
// (P, kmax + 1), raw (P, rawPad) out, all float32 on the device; nprob <=
// kMaxProblems problems, HOST arrays p (which problem), B and kp1, each with
// kp1 >= B and the slots of B within rawPad <= 128; partials (nprob, nblocks,
// rawPad) scratch; counters nprob int32, 0 before the launch and left 0.
// Vext (P, kmax, 2, h, 128) and yext (P, 2, h, 128): each problem's external
// halos as kk_fused_step takes them, 16-byte aligned; both null, or both
// given.  The plan is the host's for Bmax >= every B (it sets KACC and the
// shared memory).  Rows and entries of the problems not named are not
// touched.
int kk_fused_step_batched(float* V, const float* y, float* ynext, const float* g,
                          float* partials, float* raw, int* counters,
                          const float* Vext, const float* yext, int kmax,
                          int R, int nprob, const int* p, const int* B,
                          const int* kp1, int Bmax, int rawPad, int with_drift,
                          int h, int gc, int mrow, int ntaps, const float* coef,
                          const int* d, const int* dx, int T, int P, int NSR,
                          int NR, int reread, int run, int nblocks,
                          int smem_bytes, void* stream) {
  if (nprob < 1 || nprob > kMaxProblems || h < 1 || h > kMaxHalo || Bmax < 0 ||
      rawPad > kMaxSlots || R < 1 || (gc && mrow < 1) ||
      ((Vext == nullptr) != (yext == nullptr)))
    return (int)cudaErrorInvalidValue;
  Problems probs;
  for (int i = 0; i < nprob; ++i) {
    const int nslots = with_drift ? 2 * B[i] + 2 : B[i] + 2;
    if (p[i] < 0 || B[i] < 0 || B[i] > Bmax || kp1[i] < B[i] || kp1[i] >= kmax ||
        nslots > rawPad)
      return (int)cudaErrorInvalidValue;
    probs.p[i] = p[i];
    probs.B[i] = B[i];
    probs.kp1[i] = kp1[i];
  }
  const int lpt = T == 8 ? 4 : T == 4 ? 2 : 1;
  Taps taps;
  if (!plan_ok(T, P, NSR, NR, reread, run, nblocks, smem_bytes, R, Bmax, h) ||
      !taps_from_host(ntaps, coef, d, dx, taps))
    return (int)cudaErrorInvalidValue;
  const Plan plan = {T, P, NSR, NR, reread, run};
  cudaStream_t s = (cudaStream_t)stream;
#define KK_BATCHED(KACC, DRIFT, LPT)                                             \
  return (int)launch_batched<KACC, DRIFT, LPT>(nblocks, nprob, (size_t)smem_bytes, \
                                               s, V, y, ynext, g, partials, raw,   \
                                               counters, Vext, yext, kmax, R, h,   \
                                               gc, mrow, rawPad, plan, taps, probs)
  if (with_drift) {
    if (Bmax <= 32) {
      if (lpt == 4) KK_BATCHED(32, true, 4);
      if (lpt == 2) KK_BATCHED(32, true, 2);
      KK_BATCHED(32, true, 1);
    }
    KK_BATCHED(64, true, 1);
  }
  if (Bmax <= 32) {
    if (lpt == 4) KK_BATCHED(32, false, 4);
    if (lpt == 2) KK_BATCHED(32, false, 2);
    KK_BATCHED(32, false, 1);
  }
  if (Bmax <= 64) KK_BATCHED(64, false, 1);
  KK_BATCHED(128, false, 1);
#undef KK_BATCHED
}

const char* kk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
