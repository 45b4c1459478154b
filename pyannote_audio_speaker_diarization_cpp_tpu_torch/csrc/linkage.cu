// Centroid-linkage merge loop of the device AHC, the whole loop in one launch
// of one thread-block cluster.
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
// A step reads about T d + 2 T floats (at T = 384, d = 192 about 0.3 MB: 0.1
// ms of memory traffic for the main path's ~330 steps), but each step waits
// on the one before it, so a step costs its chain of latencies: one exchange
// between the blocks, one DSMEM round trip for the merged pair's centroids,
// two block barriers, one warp's distances and rescans.
//
// Layout: one cluster of kCluster blocks (one an SM) runs every step. Slot k
// is owned by block k mod kCluster (strided, so merges thin every block's
// live slots alike; T < kCluster leaves some blocks none). The owner keeps in
// its shared memory the slot's centroid, its row of D (stride T rounded up to
// whole float4s, padded with inf), the row's minimum and the first column
// holding it, the live flag, and leaf k's slot and rep. Sizes and subtree
// maxima, two floats a slot, every block keeps for every slot, updated alike
// each step. Where the centroids do not fit a block (above about 200 KB: d =
// 1024 at T = 1536) or the rows of D do not (above T = 384 at kCluster = 16),
// they live in global scratch that only the owner touches, read through L2
// (__ldcg); row i then lands in a shared buffer and its owner copies it out.
// One kernel, kCentShared and kDShared template parameters.
//
// A step:
//   A. warp 0 of every block alike: the least of the blocks' candidates
//      (each its least row minimum, lowest row on ties, with that row's first
//      column, as one 64-bit key) and of row i' of the last merge (its
//      minimum is the least of the blocks' partial minima of that row): (dmin,
//      i0), and j0 is the winner's first column, with no scan of row i0.
//   B. every thread: c_i and c_j from their owners over DSMEM (float4s), or
//      slot i' from this block's copy of the last merged centroid (its owner
//      stores it now, after every block read the old one), and the new
//      centroid. Then a warp two owned live slots at a time: distances to it
//      (lane l adds the squares of elements l, l + 32, ..., then a butterfly,
//      a correctly rounded root), D[k][i] and D[k][j], the row minimum kept
//      incrementally (the new D[k][i] wins if less, or equal at a lower
//      column) or rescanned if its column was i or j (min is exact, so this
//      equals recomputing every row).
//   C. the exchange: the block's candidate and its partial minimum of row i
//      to every block, and every owned slot's D[i][k] (inf for the dead, i and
//      j) to owner(i), each by st.async counted on the receiver's mbarrier,
//      which expects C candidates and, at owner(i), T entries. A block goes on
//      when all of them have landed; nobody waits for a barrier of everyone.
// scripts/linkage_ablation.py measures the cluster size, the block size, the
// rows of D in shared or global memory, the exchange against a cluster
// barrier (barrier.cluster), this kernel against the cooperative grid it
// replaced (scripts/linkage_grid.cu, three grid barriers a step) and one
// block (scripts/linkage_block.cu), the barriers and the exchange alone, and
// with kProfile each block's SM clocks a phase.
//
// Hazards, and what guards each:
//   - deadlock: every block must leave the loop in the same step. Each reads
//     the same candidates and reduces them alike, so the exit !(dmin <= thr)
//     is the same everywhere, and no block expects bytes for a step it exits.
//   - a buffer or mbarrier phase overwritten while in use: the candidates,
//     row i's landing buffer and the mbarrier of exchange u are those of u %
//     2; a block sends for u + 2 only after it received all of u + 1, which
//     every block sent only after it finished with u. Row i is written only
//     in its merge's step, and nobody reads it then (j0 comes from the
//     candidates; row i is never rescanned in its own merge).
//   - a centroid read while its owner rewrites it: the owner stores a merged
//     centroid one step late, when every block has received its exchange,
//     which each block sent after its reads; all read the new one from their
//     own copy meanwhile.
//   - a block exiting early: no block exits while another may read its shared
//     memory; the kernel ends with a cluster barrier.
//   - memory order: st.async's complete_tx releases at cluster scope, and
//     each block acquires at cluster scope when its mbarrier phase completes
//     (the sends follow a block barrier, so they release the whole block's
//     writes, the stored centroid among them). Global rows are read through
//     L2, never a stale L1 line.
//   - ragged T: a block owns slots rank, rank + kCluster, ... < T, possibly
//     none; its candidate is then (inf, none) and loses every tie.
// Arithmetic that a plain version must repeat bit for bit is rounded
// explicitly (no contraction into fused multiply-adds); the division by a
// whole number of rows is a correctly rounded quotient computed without a
// slow path. Argmin ties keep the lowest index, as jnp.argmin does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <cstdio>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;  // chosen by scripts/linkage_ablation.py
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr bool kTxSync = true;  // else barrier.cluster.arrive / wait and plain DSMEM stores
constexpr bool kProfile = false;  // print each block's clocks a phase (the ablation's)
constexpr int kMaxRows = 1536;
constexpr int kMaxDim = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 0x7ff;  // no row or column (T <= kMaxRows < kNone)
static_assert((kCluster & (kCluster - 1)) == 0 && kCluster <= 16,
              "the cluster size is a power of two, at most 16 (Hopper's largest)");

// A (value, row, column) candidate as one 64-bit key whose unsigned order is
// the argmin order: |value| (the bits of a float >= 0 order as it does, and
// -0 ties with +0 as a float compare does), then the lowest row, then the
// lowest column; the sign bit rides in bit 0, so the value comes back exactly.
__device__ __forceinline__ unsigned long long key(float v, int row, int col) {
  const unsigned b = __float_as_uint(v);
  return (unsigned long long)(b & 0x7fffffffu) << 32 | (unsigned)row << 21 |
         (unsigned)col << 10 | b >> 31;
}
__device__ __forceinline__ float key_value(unsigned long long k) {
  return __uint_as_float((unsigned)(k >> 32) | (unsigned)(k & 1) << 31);
}
__device__ __forceinline__ int key_row(unsigned long long k) { return (int)(k >> 21) & kNone; }
__device__ __forceinline__ int key_col(unsigned long long k) { return (int)(k >> 10) & kNone; }
__device__ __forceinline__ unsigned long long kmin(unsigned long long a, unsigned long long b) {
  return b < a ? b : a;
}

// a block's candidate: its least row minimum (value, row, first column) and
// its partial minimum of the new row i (value, column, -)
struct Cand {
  unsigned long long best, part;
};

// the least of n <= N candidates, both keys, in one thread: a tree over
// registers (every lane of a warp reads the same entries: broadcasts)
template <int N>
__device__ __forceinline__ Cand least_of(const Cand* c, int n) {
  Cand x[N];
#pragma unroll
  for (int b = 0; b < N; ++b) {
    x[b] = b < n ? c[b] : Cand{~0ull, ~0ull};
  }
#pragma unroll
  for (int w = 1; w < N; w <<= 1) {
#pragma unroll
    for (int b = 0; b + w < N; b += 2 * w) {
      x[b].best = kmin(x[b].best, x[b + w].best);
      x[b].part = kmin(x[b].part, x[b + w].part);
    }
  }
  return x[0];
}

// word offsets into the dynamic shared memory of a block
struct Layout {
  int cand, part, step, bars, newc, rowmin, rowarg, size, maxd, alive, leaf, rep, rnew, stage,
      cent, drows, words;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// the row stride of D: T rounded up to whole float4s
__host__ __device__ inline int row_stride(int T) { return round4(T); }

__host__ __device__ inline Layout layout(int T, int d, int C, bool cent_shared, bool d_shared) {
  const int nloc = (T + C - 1) / C;
  Layout L;
  int w = 0;
  L.cand = w;  // [2][C] Cand: the blocks' candidates, by step parity
  w += 2 * C * 4;
  L.part = w;  // [kWarps] Cand: the warps' candidates
  w += kWarps * 4;
  L.step = w;  // Cand: this step's least candidate, with row i' folded in
  w += 4;
  L.bars = w;  // [2] mbarriers, by step parity
  w += 4;
  L.newc = w;  // the merged centroid of the last step
  w += round4(d);
  L.rowmin = w;
  w += round4(nloc);
  L.rowarg = w;
  w += round4(nloc);
  L.size = w;  // [T]: every slot's size and subtree maximum, kept by every block
  w += round4(T);
  L.maxd = w;
  w += round4(T);
  L.alive = w;
  w += round4(nloc);
  L.leaf = w;
  w += round4(nloc);
  L.rep = w;
  w += round4(nloc);
  L.rnew = w;  // the owned slots' distances to this step's merged centroid
  w += round4(nloc);
  L.stage = w;  // [2][T]: row i as it arrives, when the rows of D are global
  w += d_shared ? 0 : 2 * round4(T);
  L.cent = w;
  w += cent_shared ? nloc * round4(d) : 0;
  L.drows = w;
  w += d_shared ? nloc * row_stride(T) : 0;
  L.words = w;
  return L;
}

template <bool kShared>
__device__ __forceinline__ float load(const float* p) {
  return kShared ? *p : __ldcg(p);
}

template <bool kShared>
__device__ __forceinline__ float4 load4(const float4* p) {
  return kShared ? *p : __ldcg(p);
}

template <bool kShared>
__device__ __forceinline__ void store(float* p, float x) {
  if (kShared)
    *p = x;
  else
    __stcg(p, x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// This block's shared address p as seen from the cluster, in block `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// x into block `rank`'s copy of this block's shared p: with kTxSync an
// st.async whose bytes count on that block's mbarrier `bar` (complete_tx,
// release at cluster scope), else a plain DSMEM store
__device__ __forceinline__ void put(float* p, int rank, float x, const uint64_t* bar,
                                    cg::cluster_group& cluster) {
  if (kTxSync)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(
            cluster_addr(p, rank)),
        "r"(__float_as_uint(x)), "r"(cluster_addr(bar, rank))
        : "memory");
  else
    *cluster.map_shared_rank(p, rank) = x;
}

__device__ __forceinline__ void put(Cand* p, int rank, const Cand& x, const uint64_t* bar,
                                    cg::cluster_group& cluster) {
  if (kTxSync)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], {%1, %2}, [%3];\n" ::"r"(
            cluster_addr(p, rank)),
        "l"(x.best), "l"(x.part), "r"(cluster_addr(bar, rank))
        : "memory");
  else
    *cluster.map_shared_rank(p, rank) = x;
}

// The step's exchange u = 0, 1, ... (u = s + 1 is what step s sends: the
// candidates, and row i). kTxSync: each block's mbarrier u % 2 expects the
// bytes it will receive (this thread's arrival), and completes when they
// have all landed; two mbarriers by parity, as the buffers, since a block
// sends for u + 2 only after it received everything of u + 1, which every
// block sent only after it received u. Else: barrier.cluster, every thread.
__device__ __forceinline__ void expect_bytes(uint64_t* bars, int u, uint32_t bytes) {
  if (kTxSync)
    asm volatile(
        "{\n"
        ".reg .b64 state;\n"
        "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
        "}\n" ::"r"(smem_addr(bars + (u & 1))),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void sync_arrive() {
  if (!kTxSync) asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void sync_wait(uint64_t* bars, int u) {
  if (kTxSync) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n"
        "}\n" ::"r"(smem_addr(bars + (u & 1))),
        "r"((u >> 1) & 1)
        : "memory");
  } else {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

// (least value, its first column) of one row of D (stride row_stride(T),
// padded with inf), by one warp: float4 loads, four at a time in flight
template <bool kDShared>
__device__ __forceinline__ void row_argmin(const float* drow, int T, float& v, int& k) {
  const float4* r4 = reinterpret_cast<const float4*>(drow);
  const int n4 = row_stride(T) / 4;
  const int lane = threadIdx.x & 31;
  v = CUDART_INF_F;
  k = kNone;
#pragma unroll 4
  for (int c4 = lane; c4 < n4; c4 += 32) {
    const float4 x = load4<kDShared>(r4 + c4);
    const int c = 4 * c4;
    if (x.x < v) { v = x.x; k = c; }
    if (x.y < v) { v = x.y; k = c + 1; }
    if (x.z < v) { v = x.z; k = c + 2; }
    if (x.w < v) { v = x.w; k = c + 3; }
  }
  // across lanes: the least |value| (its bits order as it does), then the
  // first column holding it, by two warp reductions; its value (and sign)
  // from the lane that read that column
  const unsigned bits = __float_as_uint(v) & 0x7fffffffu;
  const unsigned least = __reduce_min_sync(kFull, bits);
  k = (int)__reduce_min_sync(kFull, bits == least ? (unsigned)k : (unsigned)kNone);
  v = __shfl_sync(kFull, v, (k >> 2) & 31);
  if (k == kNone) v = CUDART_INF_F;
}

template <bool kCentShared, bool kDShared>
__global__ void __launch_bounds__(kThreads, 1)
linkage_kernel(const float* __restrict__ D0, const float* __restrict__ embt,
               const uint8_t* __restrict__ tvalid, float* Dg, float* centg,
               int* __restrict__ rep_out, int* __restrict__ steps_out,
               int* __restrict__ merges_out, float* __restrict__ dists_out, int T, int d,
               float thr) {
  constexpr int C = kCluster;  // the launch's cluster size: owner(k) = k % C, a shift
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) int smem[];
  const int rank = (int)cluster.block_rank();
  const int nloc = (T - rank + C - 1) / C;  // owned slots rank, rank + C, ...
  const int ld = row_stride(T), ldc = round4(d);
  const Layout L = layout(T, d, C, kCentShared, kDShared);
  Cand* cand = reinterpret_cast<Cand*>(smem + L.cand);
  Cand* part = reinterpret_cast<Cand*>(smem + L.part);
  Cand* least = reinterpret_cast<Cand*>(smem + L.step);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  float* newc = reinterpret_cast<float*>(smem + L.newc);
  float* rowmin = reinterpret_cast<float*>(smem + L.rowmin);
  int* rowarg = smem + L.rowarg;
  float* size = reinterpret_cast<float*>(smem + L.size);
  float* maxd = reinterpret_cast<float*>(smem + L.maxd);
  int* alive = smem + L.alive;
  int* leaf = smem + L.leaf;
  int* rep = smem + L.rep;
  float* rnew = reinterpret_cast<float*>(smem + L.rnew);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* cent = reinterpret_cast<float*>(smem + L.cent);
  float* drows = reinterpret_cast<float*>(smem + L.drows);

  // owned slot q's centroid and row of D; any slot's, in its owner
  auto own_cent = [&](int q) {
    return kCentShared ? cent + (size_t)q * ldc : centg + (size_t)(q * C + rank) * d;
  };
  auto own_row = [&](int q) {
    return kDShared ? drows + (size_t)q * ld : Dg + (size_t)(q * C + rank) * ld;
  };
  auto slot_cent = [&](int k) -> const float* {
    return kCentShared ? cluster.map_shared_rank(cent, k % C) + (size_t)(k / C) * ldc
                       : centg + (size_t)k * d;
  };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float inf = CUDART_INF_F;

  if (kTxSync && tid == 0) {  // one arrival a phase: this block's expect_tx
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bars)), "r"(1) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bars + 1)), "r"(1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = tid; k < T; k += kThreads) {
    size[k] = tvalid[k] != 0 ? 1.0f : 0.0f;
    maxd[k] = 0.0f;
  }
  for (int q = tid; q < nloc; q += kThreads) {
    const int k = q * C + rank;
    alive[q] = tvalid[k] != 0;
    leaf[q] = k;
    rep[q] = k;
  }
  for (int e = tid; e < nloc * d; e += kThreads) {
    const int q = e / d, c = e - q * d;
    store<kCentShared>(own_cent(q) + c, embt[(size_t)(q * C + rank) * d + c]);
  }
  if (!kDShared) {  // the padding of row i's landing buffers
    for (int c = T + tid; c < round4(T); c += kThreads) stage[c] = stage[round4(T) + c] = inf;
  }
  for (int t = rank * kThreads + tid; t < T - 1; t += C * kThreads) {
    merges_out[2 * t] = merges_out[2 * t + 1] = -1;
    dists_out[t] = inf;
  }
  cluster.sync();  // every block's mbarriers are set up before any data lands
  // the owned rows of D (padded with inf) and each one's minimum, a warp a row
  unsigned long long best = key(inf, kNone, kNone);
  for (int q = warp; q < nloc; q += kWarps) {
    const int k = q * C + rank;
    const float* src = D0 + (size_t)k * T;
    float* dst = own_row(q);
    float v = inf;
    int a = kNone;
    for (int c = lane; c < ld; c += 32) {
      const float x = c < T ? src[c] : inf;
      store<kDShared>(dst + c, x);
      if (x < v) {
        v = x;
        a = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, v, off);
      const int a2 = __shfl_xor_sync(kFull, a, off);
      if (v2 < v || (v2 == v && a2 < a)) {
        v = v2;
        a = a2;
      }
    }
    if (lane == 0) {
      rowmin[q] = v;
      rowarg[q] = a;
    }
    if (alive[q]) best = kmin(best, key(v, k, a));
  }

  // kProfile: thread 0's SM clocks, summed over the steps, of each phase in
  // step order: A in warp 0, A's block barrier, the decode, the centroids'
  // DSMEM loads, the new centroid, its block barrier, this warp's slots, the
  // wait for the block's slowest warp, the candidate's send, row i's sends
  // and arrival, the leaves and the wait for the exchange
  long long prof[11] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  long long tlast = 0;
  bool on = false;
  auto mark = [&](int n) {
    if (kProfile && on && tid == 0) {
      const long long now = clock64();
      prof[n] += now - tlast;
      tlast = now;
    }
  };
  // the block's candidate into slot `rank` of every block's buffer u % 2
  auto send_candidate = [&](unsigned long long b, unsigned long long p, int u) {
    if (lane == 0) part[warp] = Cand{b, p};
    __syncthreads();
    mark(7);
    if (warp == 0) {
      const Cand c = least_of<kWarps>(part, kWarps);
      if (lane < C) put(cand + (u & 1) * C + rank, lane, c, bars + (u & 1), cluster);
    }
    mark(8);
  };
  if (tid == 0) expect_bytes(bars, 0, C * sizeof(Cand));
  send_candidate(best, key(inf, kNone, kNone), 0);
  sync_arrive();
  sync_wait(bars, 0);

  int iprev = -1;  // slot of the last merge
  int s = 0;
  if (kProfile) {
    on = true;
    tlast = clock64();
  }
  while (s < T - 1) {
    mark(10);
    const int step = s++;
    // A (warp 0): the least candidate, row i' of the last merge folded in
    if (warp == 0) {
      Cand c = least_of<C>(cand + (step & 1) * C, C);
      if (iprev >= 0) c.best = kmin(c.best, key(key_value(c.part), iprev, key_row(c.part)));
      if (lane == 0) *least = c;
      mark(0);
    }
    __syncthreads();
    mark(1);
    const Cand c = *least;
    const float dmin = key_value(c.best);
    if (rank == 0 && tid == 0) dists_out[step] = dmin;
    if (!(dmin <= thr)) break;  // the same in every block
    const int i0 = key_row(c.best), j0 = key_col(c.best);
    const int i = min(i0, j0), j = max(i0, j0);
    const bool own_i = i % C == rank;
    // what this step's exchange brings: every block's candidate, and to
    // owner(i) every entry of row i (single-thread tasks go to different
    // warps, so they run side by side)
    if (tid == 32) expect_bytes(bars, s, C * sizeof(Cand) + (own_i ? 4 * T : 0));
    const float ni = size[i], nj = size[j];
    const float nsum = __fadd_rn(ni, nj);
    const float newmax = fmaxf(dmin, fmaxf(maxd[i], maxd[j]));

    mark(2);
    const bool own_prev = iprev >= 0 && iprev % C == rank;
    if (tid == 64 && own_prev) {  // the last merge's row: its minimum
      rowmin[iprev / C] = key_value(c.part);
      rowarg[iprev / C] = key_row(c.part);
    }
    if (tid == 96 && j % C == rank) alive[j / C] = 0;
    if (!kDShared && own_prev) {  // row i' as it arrived, into its global row
      const float* src = stage + (step & 1) * round4(T);
      float* dst = own_row(iprev / C);
      for (int c4 = tid; c4 < ld / 4; c4 += kThreads)
        __stcg(reinterpret_cast<float4*>(dst) + c4, reinterpret_cast<const float4*>(src)[c4]);
    }
    // the new centroid, every block alike (c_i and c_j from their owners over
    // DSMEM, slot i' from this block's copy), after its owner stored the last
    {
      const float* ci = slot_cent(i);
      const float* cj = slot_cent(j);
      // x / den correctly rounded, as a true division: den is a whole
      // number of rows, rden its correctly rounded reciprocal, q = x rden is
      // within an ulp, x - den q is exact (an FMA), and one correction
      // rounds to the nearest (Markstein); no slow path a step
      const float den = fmaxf(nsum, 1.0f), rden = __frcp_rn(den);
      float* prev = own_prev ? own_cent(iprev / C) : nullptr;
      auto merged = [&](float a, float b) {
        const float x = __fadd_rn(__fmul_rn(ni, a), __fmul_rn(nj, b));
        const float q = __fmul_rn(x, rden);
        return x == 0.0f ? x : __fmaf_rn(__fmaf_rn(-den, q, x), rden, q);
      };
      if (kCentShared) {  // rows padded to whole float4s: a quarter of the DSMEM requests
        for (int e = 4 * tid; e < d; e += 4 * kThreads) {
          const float4 p = *reinterpret_cast<const float4*>(newc + e);
          const float4 a = i == iprev ? p : *reinterpret_cast<const float4*>(ci + e);
          const float4 b = j == iprev ? p : *reinterpret_cast<const float4*>(cj + e);
          if (kProfile) asm volatile("" ::"f"(a.x), "f"(b.x));
          mark(3);
          if (own_prev) *reinterpret_cast<float4*>(prev + e) = p;
          *reinterpret_cast<float4*>(newc + e) =
              make_float4(merged(a.x, b.x), merged(a.y, b.y), merged(a.z, b.z), merged(a.w, b.w));
        }
      } else {
        for (int e = tid; e < d; e += kThreads) {
          const float p = newc[e];
          const float a = i == iprev ? p : load<kCentShared>(ci + e);
          const float b = j == iprev ? p : load<kCentShared>(cj + e);
          if (own_prev) store<kCentShared>(prev + e, p);
          newc[e] = merged(a, b);
        }
      }
    }
    mark(4);
    __syncthreads();
    mark(5);

    // B: a warp two owned live slots k but i at a time: their distances to
    // the new centroid (lane l adds the squares of elements l, l + 32, ...,
    // then a butterfly), D[k][i], D[k][j], the row minimum
    best = key(inf, kNone, kNone);
    unsigned long long rbest = key(inf, kNone, kNone);
    auto finish = [&](int q, float r, float v, int a) {  // v, a: the row's minimum so far
      const int k = q * C + rank;
      float* row = own_row(q);
      if (lane == 0) {
        store<kDShared>(row + i, r);
        store<kDShared>(row + j, inf);
        rnew[q] = r;
      }
      if (v != inf && (a == i || a == j)) {
        __syncwarp();
        row_argmin<kDShared>(row, T, v, a);
      } else if (r < v || (r == v && i < a)) {
        v = r;
        a = i;
      }
      __syncwarp();  // every lane has read rowmin[q]
      if (lane == 0) {
        rowmin[q] = v;
        rowarg[q] = a;
      }
      best = kmin(best, key(v, k, a));
      rbest = kmin(rbest, key(r, k, kNone));
    };
    for (int q0 = warp; q0 < nloc; q0 += 2 * kWarps) {
      const int q1 = q0 + kWarps;
      const bool use0 = q0 * C + rank != i && alive[q0];
      const bool use1 = q1 < nloc && q1 * C + rank != i && alive[q1];
      if (!use0 && !use1) continue;
      const int q1r = use1 ? q1 : q0;  // a slot to read when q1 is not used
      const float v0 = rowmin[q0], v1 = rowmin[q1r];
      const int a0 = rowarg[q0], a1 = rowarg[q1r];
      const float* c0 = own_cent(q0);
      const float* c1 = own_cent(q1r);
      float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll 2
      for (int e0 = 0; e0 < d; e0 += 32) {
        const int e = e0 + lane;
        const float ne = e < d ? newc[e] : 0.0f;
        const float t0 = e < d ? __fsub_rn(load<kCentShared>(c0 + e), ne) : 0.0f;
        const float t1 = e < d ? __fsub_rn(load<kCentShared>(c1 + e), ne) : 0.0f;
        acc0 = __fadd_rn(acc0, __fmul_rn(t0, t0));
        acc1 = __fadd_rn(acc1, __fmul_rn(t1, t1));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc0 = __fadd_rn(acc0, __shfl_xor_sync(kFull, acc0, off));
        acc1 = __fadd_rn(acc1, __shfl_xor_sync(kFull, acc1, off));
      }
      const float r0 = __fsqrt_rn(acc0), r1 = __fsqrt_rn(acc1);
      if (use0) finish(q0, r0, v0, a0);
      if (use1) finish(q1, r1, v1, a1);
    }
    mark(6);
    send_candidate(best, rbest, s);
    // row i into owner(i): each owned slot's distance, inf for the dead, i, j
    {
      float* rowi = kDShared ? drows + (size_t)(i / C) * ld : stage + (s & 1) * round4(T);
      for (int q = tid - 32; q < nloc; q += kThreads - 32) {
        if (q < 0) continue;
        const int k = q * C + rank;
        put(rowi + k, i % C, alive[q] && k != i ? rnew[q] : inf, bars + (s & 1), cluster);
      }
    }
    sync_arrive();
    mark(9);
    const bool accepted = newmax <= thr;
    for (int q = tid; q < nloc; q += kThreads) {
      int slot = leaf[q];
      if (slot == j) leaf[q] = slot = i;
      if (accepted && slot == i) rep[q] = T + step;
    }
    if (rank == 0 && tid == 0) {
      merges_out[2 * step] = i;
      merges_out[2 * step + 1] = j;
    }
    if (tid == 0) {  // every block's copy of the sizes and subtree maxima
      size[i] = nsum;
      size[j] = 0.0f;
      maxd[i] = newmax;
    }
    iprev = i;
    sync_wait(bars, s);
  }
  for (int q = tid; q < nloc; q += kThreads) rep_out[q * C + rank] = rep[q];
  if (rank == 0 && tid == 0) *steps_out = s;
  if (kProfile && tid == 0)
    printf("linkage_profile rank %d steps %d clocks %lld %lld %lld %lld %lld %lld %lld %lld "
           "%lld %lld %lld\n",
           rank, s, prof[0], prof[1], prof[2], prof[3], prof[4], prof[5], prof[6], prof[7],
           prof[8], prof[9], prof[10]);
  cluster.sync();  // no block leaves while another may read its shared memory
}

struct Plan {
  bool cent_shared, d_shared;
  int smem;
};

// The layout of a launch: centroids, then the rows of D, in shared memory
// wherever they fit in a block's opt-in shared memory.
cudaError_t plan(int T, int d, Plan* p) {
  static int budget[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (budget[dev] == 0) {
    err = cudaDeviceGetAttribute(&budget[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  const int bytes = budget[dev];
  p->cent_shared = layout(T, d, kCluster, true, false).words * 4 <= bytes;
  p->d_shared = p->cent_shared && layout(T, d, kCluster, true, true).words * 4 <= bytes;
  p->smem = layout(T, d, kCluster, p->cent_shared, p->d_shared).words * 4;
  return cudaSuccess;
}

cudaLaunchConfig_t config(int smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per device and layout: allow the cluster size and the whole opt-in
// shared memory, and check that one such cluster fits on the card.
template <bool kCentShared, bool kDShared>
cudaError_t prepare() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (done[dev]) return cudaSuccess;
  int bytes = 0;
  err = cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  auto kernel = linkage_kernel<kCentShared, kDShared>;
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(bytes, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidClusterSize;
  done[dev] = true;
  return cudaSuccess;
}

template <bool kCentShared, bool kDShared>
cudaError_t launch(const Plan& p, const float* D0, const float* embt, const uint8_t* tvalid,
                   float* D, float* cent, int* rep, int* steps, int* merges, float* dists,
                   int T, int d, float thr, cudaStream_t stream) {
  cudaError_t err = prepare<kCentShared, kDShared>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(p.smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, linkage_kernel<kCentShared, kDShared>, D0, embt, tvalid, D,
                           cent, rep, steps, merges, dists, T, d, thr);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// the row stride of D in its global scratch: T rounded up to whole float4s
extern "C" int linkage_row_stride(int T) { return row_stride(T); }

extern "C" const char* linkage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The launch's layout for T rows of d values on the current device: cluster
// size, dynamic shared memory a block, and whether the centroids and the rows
// of D live in shared memory (else the caller passes global scratch for them).
extern "C" int linkage_plan(int T, int d, int* cluster, int* smem_bytes, int* cent_shared,
                            int* d_shared) {
  if (T < 1 || T > kMaxRows || d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan(T, d, &p);
  if (err != cudaSuccess) return (int)err;
  *cluster = kCluster;
  *smem_bytes = p.smem;
  *cent_shared = p.cent_shared;
  *d_shared = p.d_shared;
  return 0;
}

// D0 (T, T) f32, embt (T, d) f32, tvalid (T,) uint8 0/1; scratch D (T,
// linkage_row_stride(T)) f32 unless the rows of D fit in shared memory, cent
// (T, d) f32 unless the centroids do (linkage_plan says which; else either
// may be null); out rep
// (T,) int32, steps (1,) int32, merges (T - 1, 2) int32, dists (T - 1,) f32.
extern "C" int linkage_launch(const void* D0, const void* embt, const void* tvalid, void* D,
                              void* cent, void* rep, void* steps, void* merges, void* dists,
                              int T, int d, float thr, void* stream) {
  if (T < 1 || T > kMaxRows || d < 1 || d > kMaxDim) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = plan(T, d, &p);
  if (err != cudaSuccess) return (int)err;
  if ((!p.d_shared && D == nullptr) || (!p.cent_shared && cent == nullptr))
    return (int)cudaErrorInvalidValue;
  auto args = [&](auto fn) {
    return fn(p, (const float*)D0, (const float*)embt, (const uint8_t*)tvalid, (float*)D,
              (float*)cent, (int*)rep, (int*)steps, (int*)merges, (float*)dists, T, d, thr,
              (cudaStream_t)stream);
  };
  if (p.d_shared)
    err = args(launch<true, true>);
  else if (p.cent_shared)
    err = args(launch<true, false>);
  else
    err = args(launch<false, false>);
  return (int)err;
}
