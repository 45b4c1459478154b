// The centroid-linkage merge loop as a cooperative grid: the design that
// csrc/linkage.cu's thread-block cluster replaced, kept as it was for
// comparison. Only scripts/linkage_ablation.py builds it; it computes what
// csrc/linkage.cu computes, bit for bit, and takes the same arguments plus
// the per-slot state scratch (linkage_state_words() int32 words a row).
//
// Its note as it stood:
//
// Centroid-linkage merge loop of the device AHC, the whole loop in one launch.
//
// Replaces the merge loop _linkage_labels of the JAX package
// (pyannote_audio_speaker_diarization_cpp_tpu/clustering/device.py), a
// jax.lax.while_loop that XLA runs on the TPU; the JAX package wrote no Pallas
// kernel for it. In eager PyTorch each of its up to T - 1 dependent merges
// would be about a dozen launches and a host read of the exit flag.
//
// What it computes, exactly as the loop does: T slots start as the T train
// rows (L2-normalised, tvalid marks the real ones) with the distance matrix
// D0 (inf off the valid pairs and on the diagonal). Each step takes the first
// row i0 whose minimum is least, the first column j0 of that minimum in row
// i0, and merges slots i = min(i0, j0) and j = max(i0, j0) if the distance
// dmin <= thr (else the loop ends: no later merge could be accepted). The
// merged centroid is (n_i c_i + n_j c_j) / max(n_i + n_j, 1) in slot i, slot j
// dies, and row and column i of D become the direct distances from the new
// centroid to the live slots. A merge whose subtree maximum max(dmin, maxd_i,
// maxd_j) <= thr is accepted: every leaf now in slot i gets rep = T + step.
// rep is each leaf's topmost accepted merge bin, in [0, 2T). For diagnostics
// the kernel also writes the steps run and each step's merge log: (i, j) of
// its merge ((-1, -1) for the refused last step and past the end) and its
// dmin (inf past the end). rep alone can hide a wrong merge order (a flat
// cluster keeps only its topmost bin); the log cannot.
//
// Bound on the H100: the dependent chain of steps, not bytes or operations.
// A step needs the new centroid's distance to every live slot (T x d reads,
// 2 T d flops), a row of D and the row minima: at T = 384, d = 192 about 0.3
// MB, 0.1 ms of memory traffic for the main path's ~330 steps, while every
// step waits on the one before it.
//
// Design: a cooperative grid of one 256-thread block an SM runs every step,
// the early exit taken on the card (no host sync a step). A step is four
// phases, three grid barriers apart:
//   1. every block alike (the same data in the same reduction order gives
//      every block the same answer): the first least row minimum (i0, dmin),
//      the first column of it in row i0 (j0), the merged centroid into its
//      own shared memory;
//   2. a warp a live slot across the grid: its distance to the new centroid;
//   3. a thread a slot across the grid: rows and columns i and j of D, and
//      each row minimum kept incrementally, min(old, new D[k][i]), or flagged
//      for a rescan if it sat at column i or j (min is exact, so this equals
//      recomputing every row); block 0 alone: the merged slot's state, its
//      row minimum, the leaves' slots and rep, the merge log;
//   4. a warp a flagged row across the grid: the row scanned again.
// The alternative, one 1024-thread block with block barriers
// (scripts/linkage_block.cu), reads every live centroid through one SM: its
// distance phase is 60-80 % of a step. scripts/linkage_ablation.py times
// both: on an H100 80GB HBM3 at 700 W, on clustered inputs, the grid takes
// 9.9 us a step at T = 384 and 11.2 at T = 1024, the block 10.9 and 29.3; on
// the one-speaker embeddings of random weights the block is ahead at T =
// 384 (8.6 against 9.8 us). The three grid barriers cost 3.4 us of a step.
//
// D (T x T floats, at most 9.4 MB), the centroids (T x d) and the per-slot
// state (row minima and a column holding each, sizes, subtree maxima, live
// and rescan flags, each leaf's slot and rep, the new row of D) live in
// global scratch that the caller allocates, resident in the 50 MB L2. State
// another block writes is read with __ldcg (from L2, never a stale L1 line).
// Arithmetic that a plain version must repeat bit for bit is rounded
// explicitly (no contraction into fused multiply-adds): the centroid update,
// and each distance as 32 lane sums of d/32 squares added pairwise by a
// butterfly (every lane ends with the same sum) and a correctly rounded root.
// Argmin ties keep the lowest index, as jnp.argmin does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1536;
constexpr int kMaxDim = 1024;
constexpr int kMaxDevices = 64;
constexpr int kStateWords = 9;  // per slot, in the caller's state scratch
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

struct Partials {  // one block reduction's per-warp (value, index) pairs
  float v[kWarps];
  int k[kWarps];
};

__device__ __forceinline__ void keep_min(float& v, int& k, float v2, int k2) {
  if (v2 < v || (v2 == v && k2 < k)) {
    v = v2;
    k = k2;
  }
}

__device__ __forceinline__ void warp_argmin(float& v, int& k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(kFull, v, off);
    const int k2 = __shfl_xor_sync(kFull, k, off);
    keep_min(v, k, v2, k2);
  }
}

// Every thread's (v, k) -> the block's least v, lowest k among ties, in every
// thread. p must not be written again before a later barrier.
__device__ __forceinline__ void block_argmin(float& v, int& k, Partials& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmin(v, k);
  if (lane == 0) {
    p.v[warp] = v;
    p.k[warp] = k;
  }
  __syncthreads();
  v = lane < kWarps ? p.v[lane] : CUDART_INF_F;
  k = lane < kWarps ? p.k[lane] : kNone;
  warp_argmin(v, k);
}

// (least value, its first column) of one row of D, by one warp
__device__ __forceinline__ void row_argmin(const float* drow, int T, float& v, int& k) {
  v = CUDART_INF_F;
  k = kNone;
  for (int c = threadIdx.x & 31; c < T; c += 32) {
    const float x = __ldcg(drow + c);
    if (x < v) {
      v = x;
      k = c;
    }
  }
  warp_argmin(v, k);
}

__global__ void __launch_bounds__(kThreads)
linkage_kernel(const float* __restrict__ D0, const float* __restrict__ embt,
               const uint8_t* __restrict__ tvalid, float* D, float* cent, int* state,
               int* __restrict__ rep_out, int* __restrict__ steps_out,
               int* __restrict__ merges_out, float* __restrict__ dists_out, int T, int d,
               float thr) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float newc[];
  __shared__ Partials pa, pb, pc;

  float* rowmins = reinterpret_cast<float*>(state);
  int* rowarg = state + T;
  float* size = reinterpret_cast<float*>(state + 2 * T);
  float* maxd = reinterpret_cast<float*>(state + 3 * T);
  float* row = reinterpret_cast<float*>(state + 4 * T);
  int* alive = state + 5 * T;
  int* flag = state + 6 * T;
  int* leaf = state + 7 * T;  // block 0's alone
  int* rep = state + 8 * T;   // block 0's alone

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gtid = blockIdx.x * kThreads + tid, gthreads = gridDim.x * kThreads;
  const int gwarp = blockIdx.x * kWarps + warp, gwarps = gridDim.x * kWarps;
  const bool lead = blockIdx.x == 0;
  const float inf = CUDART_INF_F;

  for (int k = gtid; k < T; k += gthreads) {
    const bool live = tvalid[k] != 0;
    size[k] = live ? 1.0f : 0.0f;
    alive[k] = live;
    maxd[k] = 0.0f;
    flag[k] = 0;
    leaf[k] = k;
    rep[k] = k;
  }
  for (int e = gtid; e < T * d; e += gthreads) cent[e] = embt[e];
  for (int s = gtid; s < T - 1; s += gthreads) {
    merges_out[2 * s] = merges_out[2 * s + 1] = -1;
    dists_out[s] = inf;
  }
  // D = D0, and each row's minimum, a warp a row
  for (int r = gwarp; r < T; r += gwarps) {
    const float* src = D0 + (size_t)r * T;
    float* dst = D + (size_t)r * T;
    float v = inf;
    int k = kNone;
    for (int c = lane; c < T; c += 32) {
      const float x = src[c];
      dst[c] = x;
      if (x < v) {
        v = x;
        k = c;
      }
    }
    warp_argmin(v, k);
    if (lane == 0) {
      rowmins[r] = v;
      rowarg[r] = k;
    }
  }
  grid.sync();

  int step = 0;
  while (step < T - 1) {
    // 1: the first row whose minimum is least, the first column of that
    // minimum, the merged centroid; every block alike
    float dmin = inf;
    int i0 = kNone;
    for (int c = tid; c < T; c += kThreads) keep_min(dmin, i0, __ldcg(rowmins + c), c);
    block_argmin(dmin, i0, pa);
    if (lead && tid == 0) dists_out[step] = dmin;
    ++step;
    if (!(dmin <= thr)) break;  // the same in every block

    float dj = inf;
    int j0 = kNone;
    const float* drow = D + (size_t)i0 * T;
    for (int c = tid; c < T; c += kThreads) keep_min(dj, j0, __ldcg(drow + c), c);
    block_argmin(dj, j0, pb);
    const int i = min(i0, j0), j = max(i0, j0);

    const float ni = __ldcg(size + i), nj = __ldcg(size + j);
    const float nsum = __fadd_rn(ni, nj);
    const float den = fmaxf(nsum, 1.0f);
    const float newmax = fmaxf(dmin, fmaxf(__ldcg(maxd + i), __ldcg(maxd + j)));
    for (int e = tid; e < d; e += kThreads) {
      newc[e] = __fdiv_rn(__fadd_rn(__fmul_rn(ni, __ldcg(cent + (size_t)i * d + e)),
                                    __fmul_rn(nj, __ldcg(cent + (size_t)j * d + e))),
                          den);
    }
    __syncthreads();

    // 2: distances from the new centroid to every live slot, a warp a slot
    for (int k = gwarp; k < T; k += gwarps) {
      float dist = inf;
      if (k != i && k != j && __ldcg(alive + k)) {
        const float* ck = cent + (size_t)k * d;
        float acc = 0.0f;
        for (int e0 = 0; e0 < d; e0 += 32) {  // lane l adds elements l, l + 32, ...
          const int e = e0 + lane;
          const float t = e < d ? __fsub_rn(__ldcg(ck + e), newc[e]) : 0.0f;
          acc = __fadd_rn(acc, __fmul_rn(t, t));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
        dist = __fsqrt_rn(acc);
      }
      if (lane == 0) row[k] = dist;
    }
    grid.sync();

    // 3: rows and columns i and j of D; every other row's minimum
    for (int k = gtid; k < T; k += gthreads) {
      const float r = __ldcg(row + k);
      D[(size_t)i * T + k] = r;
      D[(size_t)k * T + i] = r;
      D[(size_t)j * T + k] = inf;
      D[(size_t)k * T + j] = inf;
      if (k == i || k == j) continue;
      const float m = __ldcg(rowmins + k);
      const int a = __ldcg(rowarg + k);
      if (m != inf && (a == i || a == j)) {
        flag[k] = 1;
      } else if (r < m) {
        rowmins[k] = r;
        rowarg[k] = i;
      }
    }
    if (lead) {
      float v = inf;
      int kk = kNone;
      for (int k = tid; k < T; k += kThreads) keep_min(v, kk, __ldcg(row + k), k);
      block_argmin(v, kk, pc);
      const bool accepted = newmax <= thr;
      for (int l = tid; l < T; l += kThreads) {
        int slot = leaf[l];
        if (slot == j) slot = i;
        leaf[l] = slot;
        if (accepted && slot == i) rep[l] = T + step - 1;
      }
      for (int e = tid; e < d; e += kThreads) cent[(size_t)i * d + e] = newc[e];
      if (tid == 0) {
        rowmins[i] = v;
        rowarg[i] = kk;
        rowmins[j] = inf;
        size[i] = nsum;
        size[j] = 0.0f;
        maxd[i] = newmax;
        alive[j] = 0;
        merges_out[2 * (step - 1)] = i;
        merges_out[2 * (step - 1) + 1] = j;
      }
    }
    grid.sync();

    // 4: rows whose minimum sat at column i or j, scanned again, a warp a row
    for (int k = gwarp; k < T; k += gwarps) {
      if (!__ldcg(flag + k)) continue;
      float v;
      int c;
      row_argmin(D + (size_t)k * T, T, v, c);
      if (lane == 0) {
        rowmins[k] = v;
        rowarg[k] = c;
        flag[k] = 0;
      }
    }
    grid.sync();
  }
  if (lead) {
    for (int l = tid; l < T; l += kThreads) rep_out[l] = rep[l];
    if (tid == 0) *steps_out = step;
  }
}

// Blocks of the grid on the current device: one an SM, checked once to fit.
cudaError_t grid_blocks(int* blocks) {
  static int cached[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, linkage_kernel, kThreads,
                                                          (size_t)kMaxDim * sizeof(float));
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cached[dev] = sms;
  }
  *blocks = cached[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" int linkage_state_words() { return kStateWords; }

extern "C" const char* linkage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// D0 (T, T) f32, embt (T, d) f32, tvalid (T,) uint8 0/1; scratch D (T, T) and
// cent (T, d) f32, state (9 T) int32; out rep (T,) int32, steps (1,) int32,
// merges (T - 1, 2) int32 and dists (T - 1,) f32.
extern "C" int linkage_launch(const void* D0, const void* embt, const void* tvalid, void* D,
                              void* cent, void* state, void* rep, void* steps, void* merges,
                              void* dists, int T, int d, float thr, void* stream) {
  if (T < 1 || T > kMaxRows || d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err = grid_blocks(&blocks);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&D0, &embt, &tvalid, &D, &cent, &state, &rep,
                  &steps, &merges, &dists, &T, &d, &thr};
  err = cudaLaunchCooperativeKernel((void*)linkage_kernel, blocks, kThreads, args,
                                    (size_t)d * sizeof(float), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
