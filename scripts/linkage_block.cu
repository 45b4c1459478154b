// The centroid-linkage merge loop in one 1024-thread block: the design that
// csrc/linkage.cu's cooperative grid was measured against. It computes what
// csrc/linkage.cu computes (see there), bit for bit; scripts/linkage_ablation.py
// builds it and holds it to the plain version like the kernel.
//
// In this design one SM does every step, so its share of the L2's bandwidth
// bounds the distance phase, 60-80 % of a step; four slots a warp at once
// instead of one did not help.
//
// Design: one persistent block of 1024 threads runs every step, with block
// barriers between the phases of a step and the early exit taken on the card
// (no host sync a step). D (T x T floats, at most 9.4 MB) and the centroids
// (T x d) live in global scratch, resident in the 50 MB L2; the per-slot
// state (row minima and a column holding each, sizes, subtree maxima, live
// flags, each leaf's slot and rep, the new row of D, the rows to rescan)
// lives in shared memory. Row minima are kept incrementally: after a merge,
// row k's minimum is min(old, new D[k][i]), rescanned in full only if it sat
// at column i or j; min is exact, so this equals recomputing every row.
// Arithmetic that a plain version must repeat bit for bit is rounded
// explicitly (no contraction into fused multiply-adds): the centroid update,
// and each distance as 32 lane sums of d/32 squares added pairwise by a
// butterfly (every lane ends with the same sum) and a correctly rounded root.
// Argmin ties keep the lowest index, as jnp.argmin does.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 1536;
constexpr int kMaxDim = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7fffffff;

struct Partials {  // one block reduction's per-warp (value, index) pairs
  float v[kWarps];
  int k[kWarps];
};

struct Small {
  Partials a, b, c;
  int nrescan;
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
// thread. One barrier: each warp reduces the 32 partials itself. p must not
// be written again before a later barrier.
__device__ __forceinline__ void block_argmin(float& v, int& k, Partials& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmin(v, k);
  if (lane == 0) {
    p.v[warp] = v;
    p.k[warp] = k;
  }
  __syncthreads();
  v = p.v[lane];
  k = p.k[lane];
  warp_argmin(v, k);
}

// (least value, its first column) of one row of D, by one warp. D is written
// by this kernel, so it is read through the coherent path (no __restrict__).
__device__ __forceinline__ void row_argmin(const float* drow, int T, float& v, int& k) {
  v = CUDART_INF_F;
  k = kNone;
  for (int c = threadIdx.x & 31; c < T; c += 32) {
    const float x = drow[c];
    if (x < v) {
      v = x;
      k = c;
    }
  }
  warp_argmin(v, k);
}

__global__ void __launch_bounds__(kThreads, 1)
linkage_block_kernel(const float* __restrict__ D0, const float* __restrict__ embt,
               const uint8_t* __restrict__ tvalid, float* D, float* cent,
               int* __restrict__ rep_out, int* __restrict__ steps_out,
               int* __restrict__ merges_out, float* __restrict__ dists_out, int T, int d,
               float thr) {
  extern __shared__ float4 smem_raw[];
  float* rowmins = reinterpret_cast<float*>(smem_raw);
  int* rowarg = reinterpret_cast<int*>(rowmins + T);
  float* size = reinterpret_cast<float*>(rowarg + T);
  float* maxd = size + T;
  int* leaf = reinterpret_cast<int*>(maxd + T);
  int* rep = leaf + T;
  float* row = reinterpret_cast<float*>(rep + T);
  int* rescan = reinterpret_cast<int*>(row + T);
  float* newc = reinterpret_cast<float*>(rescan + T);
  Small& s = *reinterpret_cast<Small*>(newc + d);
  uint8_t* alive = reinterpret_cast<uint8_t*>(&s + 1);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inf = CUDART_INF_F;

  for (int k = tid; k < T; k += kThreads) {
    const bool live = tvalid[k] != 0;
    size[k] = live ? 1.0f : 0.0f;
    alive[k] = live;
    maxd[k] = 0.0f;
    leaf[k] = k;
    rep[k] = k;
  }
  for (int e = tid; e < T * d; e += kThreads) cent[e] = embt[e];
  for (int s = tid; s < T - 1; s += kThreads) {
    merges_out[2 * s] = merges_out[2 * s + 1] = -1;
    dists_out[s] = inf;
  }
  // D = D0, and each row's minimum, a warp a row
  for (int r = warp; r < T; r += kWarps) {
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
  __syncthreads();

  int step = 0;
  while (step < T - 1) {
    // A: the first row whose minimum is least
    float dmin = inf;
    int i0 = kNone;
    for (int c = tid; c < T; c += kThreads) keep_min(dmin, i0, rowmins[c], c);
    block_argmin(dmin, i0, s.a);
    if (tid == 0) dists_out[step] = dmin;
    ++step;
    if (!(dmin <= thr)) break;  // the same in every thread

    // B: the first column of that minimum
    float dj = inf;
    int j0 = kNone;
    const float* drow = D + (size_t)i0 * T;
    for (int c = tid; c < T; c += kThreads) keep_min(dj, j0, drow[c], c);
    block_argmin(dj, j0, s.b);
    const int i = min(i0, j0), j = max(i0, j0);
    if (tid == 0) {
      merges_out[2 * (step - 1)] = i;
      merges_out[2 * (step - 1) + 1] = j;
    }

    // C: the merged centroid into slot i; leaves of slot j move to slot i
    const float ni = size[i], nj = size[j];
    const float nsum = __fadd_rn(ni, nj);
    const float den = fmaxf(nsum, 1.0f);
    const float newmax = fmaxf(dmin, fmaxf(maxd[i], maxd[j]));
    const bool accepted = newmax <= thr;
    for (int e = tid; e < d; e += kThreads) {
      const float v = __fdiv_rn(
          __fadd_rn(__fmul_rn(ni, cent[(size_t)i * d + e]), __fmul_rn(nj, cent[(size_t)j * d + e])),
          den);
      newc[e] = v;
      cent[(size_t)i * d + e] = v;
    }
    for (int l = tid; l < T; l += kThreads) {
      int slot = leaf[l];
      if (slot == j) slot = i;
      leaf[l] = slot;
      if (accepted && slot == i) rep[l] = T + step - 1;
    }
    if (tid == 0) s.nrescan = 0;
    __syncthreads();

    // E: distances from the new centroid to every live slot, a warp a slot
    float rv = inf;
    int rk = kNone;
    for (int k = warp; k < T; k += kWarps) {
      float dist = inf;
      if (k != i && k != j && alive[k]) {
        const float* ck = cent + (size_t)k * d;
        float acc = 0.0f;
        for (int e0 = 0; e0 < d; e0 += 32) {  // lane l adds elements l, l + 32, ...
          const int e = e0 + lane;
          const float t = e < d ? __fsub_rn(ck[e], newc[e]) : 0.0f;
          acc = __fadd_rn(acc, __fmul_rn(t, t));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
        dist = __fsqrt_rn(acc);
      }
      if (lane == 0) row[k] = dist;
      if (dist < rv) {  // k rises: the first least is kept
        rv = dist;
        rk = k;
      }
    }
    if (lane == 0) {
      s.c.v[warp] = rv;
      s.c.k[warp] = rk;
    }
    __syncthreads();

    // F: rows and columns i and j of D; every other row's minimum
    if (warp == 0) {
      float v = s.c.v[lane];
      int k = s.c.k[lane];
      warp_argmin(v, k);
      if (lane == 0) {
        rowmins[i] = v;
        rowarg[i] = k;
        rowmins[j] = inf;
        size[i] = nsum;
        size[j] = 0.0f;
        maxd[i] = newmax;
        alive[j] = 0;
      }
    }
    for (int k = tid; k < T; k += kThreads) {
      const float r = row[k];
      D[(size_t)i * T + k] = r;
      D[(size_t)k * T + i] = r;
      D[(size_t)j * T + k] = inf;
      D[(size_t)k * T + j] = inf;
      if (k == i || k == j) continue;
      const float m = rowmins[k];
      if (m != inf && (rowarg[k] == i || rowarg[k] == j)) {
        rescan[atomicAdd(&s.nrescan, 1)] = k;
      } else if (r < m) {
        rowmins[k] = r;
        rowarg[k] = i;
      }
    }
    __syncthreads();

    // G: rows whose minimum sat at column i or j, scanned again, a warp a row
    const int n = s.nrescan;
    for (int q = warp; q < n; q += kWarps) {
      const int k = rescan[q];
      float v;
      int c;
      row_argmin(D + (size_t)k * T, T, v, c);
      if (lane == 0) {
        rowmins[k] = v;
        rowarg[k] = c;
      }
    }
    __syncthreads();
  }
  for (int l = tid; l < T; l += kThreads) rep_out[l] = rep[l];
  if (tid == 0) *steps_out = step;
}

size_t shared_bytes(int T, int d) {
  return (size_t)8 * T * 4 + (size_t)d * 4 + sizeof(Small) + (size_t)T;
}

}  // namespace

extern "C" const char* linkage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// csrc/linkage.cu's arguments; the state scratch goes unused (the per-slot
// state lives in shared memory)
extern "C" int linkage_launch(const void* D0, const void* embt, const void* tvalid, void* D,
                              void* cent, void* state, void* rep, void* steps, void* merges,
                              void* dists, int T, int d, float thr, void* stream) {
  if (T < 1 || T > kMaxRows || d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(T, d);
  cudaError_t err = cudaFuncSetAttribute(
      linkage_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  linkage_block_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)D0, (const float*)embt, (const uint8_t*)tvalid, (float*)D, (float*)cent,
      (int*)rep, (int*)steps, (int*)merges, (float*)dists, T, d, thr);
  return (int)cudaGetLastError();
}
