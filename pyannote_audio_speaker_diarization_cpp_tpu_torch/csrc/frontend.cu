// Log-mel spectrogram: centered STFT -> power -> mel projection -> dB, fused,
// with the DFT product on the tensor cores in 3xTF32.
//
// Replaces the TPU kernel log_mel_spectrogram / _kernel
// (pyannote_audio_speaker_diarization_cpp_tpu/ops/frontend_pallas.py).
// The top_db clamp and the sentence mean-norm stay outside, as torch ops, as
// they did outside the TPU kernel (they need per-row statistics).
//
// What it computes, per row and frame f: the window's samples
// xp[f*hop .. f*hop + win) of the zero-padded (n_fft/2 each side) signal,
// times the windowed real-DFT basis (win x 2*nf: [cos*w | -sin*w]), gives
// re/im; power = re^2 + im^2; fb = power . mel (nf x n_mels);
// out = mult * log10(max(fb, amin)) - db_off.
//
// Bound on the H100: operations. The TPU kernel ran its products at HIGHEST
// precision, so they must stay float32-accurate. Each float32 product runs
// as three TF32 products (3xTF32): v = big + small with big = cvt.rna.tf32(v)
// and small = cvt.rna.tf32(v - big), and a.b ~ a_small.b_big + a_big.b_small
// + a_big.b_big (one TF32 product alone is off by ~0.5 dB). The tensor
// cores truncate as they accumulate, so the products of each k16 (two k
// steps of 8) go into a fresh accumulator that is then added to the running
// sum in float32 (rounded); one accumulator over all 150 products of an
// element was ~10x less accurate than float32 on normal(0, 1) noise. At the
// main path's x (32, 80000) the product is 3 x 2 x 32 x 501 x 400 x 402 =
// 15.5 GFLOP, 0.031 ms at the 495 TFLOP/s TF32 peak; the mel projection over
// each band's own bins (387 nonzeros of 201 x 80) and the bytes (16 MB,
// 0.005 ms) are small beside it.
//
// Design: one block per (row, 128 frames), two warpgroups of 64 frames, one
// block an SM (128 blocks for a 32-row batch: one wave).
// - The product runs on wgmma (m64nNk8, TF32): A, the frames, from
//   registers, split there into big and small; B, the basis, from shared
//   memory. mma.sync m16n8k8 TF32 reached about half the wgmma rate here.
// - Frames without a bank conflict: the block stages x as hop-rows of `hop`
//   samples (16-byte cp.async, the left pad and the right edge zero-filled)
//   at a pitch of hop + 4 words, so the 8 rows an ldmatrix phase reads start
//   on distinct bank quads. Frame f is rows f, f + 1, f + 2 (the last one cut
//   at win), so the product is a sum of three shifted products over those
//   rows, as in the TPU kernel. ldmatrix.x4 on 32-bit words gives a warp's
//   16 x 8 TF32 A fragment of a k step.
// - The basis is split once on the host (ops/frontend_cuda.py basis_tiles)
//   into big and small halves, laid out per pass and k step as wgmma reads
//   B from shared memory (K-major 8 x 16-byte core matrices, no swizzle), so
//   each k16 is one contiguous chunk: two 14 KB stages of 16-byte cp.async,
//   shared by both warpgroups. Its columns are 208 bins (201 padded), pair
//   p's 8 real columns beside the 8 imaginary columns of the same bins, so
//   the thread that holds re(f, q) also holds im(f, q) and the power forms
//   in registers.
// - Four passes over 7, 7, 6, 6 pairs (N = 112 or 96 columns). A pass's
//   columns are two wgmma groups (4 + 3 or 3 + 3 pairs), so the tensor cores
//   multiply one group while the threads add the other's k16 into the
//   running sums.
// - Only the power tile (128 frames x 208 bins) goes to shared memory. The
//   mel projection then sums each band's own bins (a table of first bin,
//   count and weights, at most kBandWidth bins, copied where x was) in
//   ascending order with FMAs, and takes the log by the special function
//   unit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFrames = 128;                      // STFT frames per block
constexpr int kThreads = 256;                     // two warpgroups
constexpr int kBins = 208;                        // bins, padded: 26 pairs of 8 bins
constexpr int kPairs = kBins / 8;
constexpr int kMaxPassPairs = 7;                  // passes of 7, 7, 6, 6 pairs
constexpr int kStageFloats = 2 * 2 * 16 * kMaxPassPairs * 8;  // a k16 of basis: 14,336 bytes
constexpr int kPowerPitch = kBins + 8;            // 216 words: conflict-free float2 stores
constexpr int kBandWidth = 16;                    // bins a band may span
constexpr int kBandPitch = kBandWidth + 1;        // words a band's weights take in shared memory
static_assert(7 + 7 + 6 + 6 == kPairs, "the passes cover the bins");

__host__ __device__ __forceinline__ int x_pitch(int hop) {
  return hop % 8 == 0 ? hop + 4 : hop;  // an odd multiple of 4 words
}

__host__ __device__ __forceinline__ int staged_rows(int hop, int ksteps) {
  return kFrames + (8 * ksteps - 1) / hop;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x (4 words) matrices: lanes 8m..8m+7 address the rows of matrix m;
// lane l gets word l % 4 of row l / 4 of each
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// v rounded to TF32 (nearest, ties away), low 13 mantissa bits zero
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// shared memory written by this thread (generic proxy) becomes visible to
// wgmma's reads (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// all but the last committed group done
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// wgmma's descriptor of an N x 8 TF32 B operand in shared memory, K-major, no
// swizzle: 8 x 16-byte core matrices, 128 bytes apart along K (the leading
// offset) and 256 bytes apart along N (the stride offset)
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// d (64 x 64, f32) (+)= a (64 x 8, tf32, registers) . b (8 x 64, tf32, shared
// memory at desc); d is read unless scale_d is 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// d (64 x 48, f32) (+)= a (64 x 8, tf32, registers) . b (8 x 48, tf32, shared
// memory at desc); d is read unless scale_d is 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[24], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23}, "
      "{%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d)
      : "memory");
}

// This lane's k = j hop + kk moves on by one k step (8)
__device__ __forceinline__ void next_step(int& j, int& kk, int hop) {
  kk += 8;
  while (kk >= hop) {
    kk -= hop;
    ++j;
  }
}

// Start copying `floats` contiguous floats of basis into shared memory.
// Pin registers: the compiler keeps reads of r after this point and its
// writes before it (wgmma writes its accumulators behind the compiler's back)
template <int K>
__device__ __forceinline__ void fence_regs(float (&r)[K]) {
#pragma unroll
  for (int e = 0; e < K; ++e) asm volatile("" : "+f"(r[e])::"memory");
}

__device__ __forceinline__ void copy_basis(float* dst, const float* src, int floats, int tid) {
  for (int i = 4 * tid; i < floats; i += 4 * kThreads) cp_async16(dst + i, src + i);
  cp_async_commit();
}

// Load and split the A fragments of the next k16 (two k steps): ldmatrix.x4
// of the lane's row at its k, then big and small halves.
__device__ __forceinline__ void load_a(uint32_t (&a_big)[2][4], uint32_t (&a_small)[2][4],
                                       const float* xrow, int pitch, int hop, int& j, int& kk) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t a[4];
    ldmatrix_x4(a, xrow + j * pitch + kk);
    next_step(j, kk, hop);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = __uint_as_float(a[e]);
      a_big[h][e] = to_tf32(v);
      a_small[h][e] = to_tf32(v - __uint_as_float(a_big[h][e]));
    }
  }
}

// Start one k16's wgmma for the columns from `col` (a multiple of 16) into d:
// per k step the two small terms, then the big one, into d from zero.
template <int K>
__device__ __forceinline__ void issue_k16(float (&d)[K], const uint32_t (&a_big)[2][4],
                                          const uint32_t (&a_small)[2][4], const float* stage,
                                          int n_total, int col) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* big = stage + 2 * h * n_total * 8 + col * 8;  // column groups 256 bytes apart
    const float* small = big + n_total * 8;
    wgmma_tf32(d, a_small[h], b_desc(big), h);  // a_small . b_big
    wgmma_tf32(d, a_big[h], b_desc(small), 1);  // a_big . b_small
    wgmma_tf32(d, a_big[h], b_desc(big), 1);    // a_big . b_big
  }
  wgmma_commit();
}

template <int K, int KA>
__device__ __forceinline__ void add_to(float (&acc)[K], float (&d)[KA], int at) {
  fence_regs(d);
#pragma unroll
  for (int e = 0; e < KA; ++e) acc[at + e] += d[e];
}

// One pass over PA + PB pairs from pair0 (N = 16 (PA + PB) basis columns;
// tiles: this pass's basis, one chunk of 2 x 2 x N x 8 floats per k16), for
// the warp's frames 16 warp .. + 15: the spectrum of those bins in
// registers, then their power into the power tile.
//
// Each k16's products go into fresh accumulators, then are added to the
// running sums in float32. The columns are two wgmma groups, dA (PA pairs)
// and dB (PB pairs): B(it) runs while A(it) is added, and B(it) is added,
// with the next k16's A fragments already loaded, just before the barrier
// of k16 it + 1. The basis ring has two stages; before a stage is refilled
// every thread has waited for the wgmma that read it.
template <int PA, int PB>
__device__ __forceinline__ void dft_pass(const float* xs, int pitch, int hop, int ksteps,
                                         const float* __restrict__ tiles, int pair0, float* ring,
                                         int tid, float* ps) {
  constexpr int NP = PA + PB;
  constexpr int N = 16 * NP;
  constexpr int kChunk = 2 * 2 * N * 8;  // a k16: 2 k steps x (big, small) x N x 8
  const int lane = tid & 31, warp = tid >> 5;
  float acc[8 * NP], d_a[8 * PA], d_b[8 * PB];
#pragma unroll
  for (int e = 0; e < 8 * NP; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 8 * PA; ++e) d_a[e] = 0.0f;
#pragma unroll
  for (int e = 0; e < 8 * PB; ++e) d_b[e] = 0.0f;

  // ldmatrix.x4 rows: frame 16 warp + lane % 16, k-group 4 (lane / 16) of
  // the step; its matrices (frames 0-7 | 8-15) x (k 0-3 | 4-7) are a0..a3.
  // This lane's k = 8 s + 4 (lane / 16) lies in hop-row j at column kk.
  const float* xrow = xs + (16 * warp + (lane & 15)) * pitch;
  int j = 0, kk = 4 * (lane >> 4);
  const int k16s = ksteps / 2;
  __syncthreads();  // the previous pass no longer reads the ring
  copy_basis(ring, tiles, kChunk, tid);
  for (int it = 0; it < k16s; ++it) {
    const float* stage = ring + (it & 1) * kStageFloats;
    uint32_t a_big[2][4], a_small[2][4];
    load_a(a_big, a_small, xrow, pitch, hop, j, kk);
    cp_async_wait_all();
    fence_proxy_async();
    wgmma_wait_all();  // B(it - 1) is done
    add_to(acc, d_b, 8 * PA);
    __syncthreads();   // k16 it landed; no wgmma reads the other stage
    // (ptxas adds a warpgroup.arrive before B for the copy's control flow,
    // C7519; copying before A or after B measured slower on an H100)
    wgmma_fence();
    issue_k16(d_a, a_big, a_small, stage, N, 0);
    if (it + 1 < k16s)
      copy_basis(ring + ((it + 1) & 1) * kStageFloats, tiles + (size_t)(it + 1) * kChunk,
                 kChunk, tid);
    issue_k16(d_b, a_big, a_small, stage, N, 16 * PA);
    wgmma_wait_one();  // A(it) is done
    add_to(acc, d_a, 0);
  }
  wgmma_wait_all();
  add_to(acc, d_b, 8 * PA);

  // thread (g, t4) holds, per pair q, re at acc[8q .. 8q + 3] and im at
  // acc[8q + 4 .. 8q + 7]: frames g, g + 8 at bins 2 t4, 2 t4 + 1
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    float* dst = ps + (16 * warp + g) * kPowerPitch + 8 * (pair0 + q) + 2 * t4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float r0 = acc[8 * q + 2 * h], r1 = acc[8 * q + 2 * h + 1];
      const float i0 = acc[8 * q + 4 + 2 * h], i1 = acc[8 * q + 4 + 2 * h + 1];
      *reinterpret_cast<float2*>(dst + 8 * h * kPowerPitch) =
          make_float2(r0 * r0 + i0 * i0, r1 * r1 + i1 * i1);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
log_mel_kernel(const float* __restrict__ x, const float* __restrict__ tiles,
               const int* __restrict__ band_bins, const float* __restrict__ band_w,
               float* __restrict__ out, int n, int frames, int hop, int ksteps, int pad,
               int n_mels, int vec, float amin, float mult, float db_off, float db_floor) {
  extern __shared__ __align__(128) float smem[];
  const int pitch = x_pitch(hop);
  const int rows = staged_rows(hop, ksteps);
  float* ring = smem;                          // 2 x kStageFloats: basis k16s
  float* xs = ring + 2 * kStageFloats;         // rows x pitch: hop-rows of the padded signal
  float* ps = xs + rows * pitch;               // kFrames x kPowerPitch: power
  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const float* xr = x + (size_t)row * n;
  // sample of hop-row r, column c: base + r hop + c (zero outside [0, n))
  const long long base = (long long)f0 * hop - pad;

  if (vec) {  // n, hop and pad multiples of 4, x 16-byte aligned: a chunk is all in or all out
    const int chunks = hop / 4;
    for (int i = tid; i < rows * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = 4 * (i - r * chunks);
      const long long s = base + (long long)r * hop + c;
      float* dst = xs + r * pitch + c;
      if (s >= 0 && s < n)
        cp_async16(dst, xr + s);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < rows * hop; i += kThreads) {
      const int r = i / hop;
      const int c = i - r * hop;
      const long long s = base + (long long)r * hop + c;
      xs[r * pitch + c] = (s >= 0 && s < n) ? __ldg(xr + s) : 0.0f;
    }
  }

  // x lands before the first pass's barrier: each k16 reads its A fragments
  // before its own barrier
  cp_async_wait_all();

  // the DFT product and the power, in passes of 7, 7, 6, 6 pairs
  const size_t per_pair = (size_t)ksteps * 16 * 16;  // basis floats of one pair
  dft_pass<4, 3>(xs, pitch, hop, ksteps, tiles, 0, ring, tid, ps);
  dft_pass<4, 3>(xs, pitch, hop, ksteps, tiles + 7 * per_pair, 7, ring, tid, ps);
  dft_pass<3, 3>(xs, pitch, hop, ksteps, tiles + 14 * per_pair, 14, ring, tid, ps);
  dft_pass<3, 3>(xs, pitch, hop, ksteps, tiles + 20 * per_pair, 20, ring, tid, ps);
  __syncthreads();  // x is no longer read: its space takes the band table

  int* bins_s = reinterpret_cast<int*>(xs);  // n_mels x (first bin, count)
  float* w_s = xs + 2 * n_mels;              // n_mels x kBandPitch weights
  for (int i = tid; i < 2 * n_mels; i += kThreads) bins_s[i] = __ldg(band_bins + i);
  for (int i = tid; i < n_mels * kBandWidth; i += kThreads)
    w_s[(i / kBandWidth) * kBandPitch + i % kBandWidth] = __ldg(band_w + i);
  __syncthreads();

  // mel over each band's own bins, ascending, then dB: mult log10(fb) as
  // (mult log10 2) log2(fb) by the special function unit (2^-22 relative in
  // log2, below 3e-5 dB); fb at or below amin gives the floor exactly
  const float db_per_log2 = mult * 0.30102999566398120f;
  const int nvalid = min(kFrames, frames - f0);
  int f = tid / n_mels, m = tid % n_mels;
  for (int idx = tid; idx < nvalid * n_mels; idx += kThreads) {
    const float* pw = ps + f * kPowerPitch + bins_s[2 * m];
    const float* w = w_s + m * kBandPitch;
    const int count = bins_s[2 * m + 1];
    float fb = 0.0f;
#pragma unroll
    for (int q = 0; q < kBandWidth; ++q)
      if (q < count) fb = fmaf(pw[q], w[q], fb);
    out[((size_t)row * frames + f0 + f) * n_mels + m] =
        fb > amin ? db_per_log2 * __log2f(fb) - db_off : db_floor;
    f += kThreads / n_mels;  // idx + kThreads
    m += kThreads % n_mels;
    if (m >= n_mels) {
      m -= n_mels;
      ++f;
    }
  }
}

size_t smem_bytes(int hop, int ksteps, int n_mels) {
  const size_t x_words = (size_t)staged_rows(hop, ksteps) * x_pitch(hop);
  const size_t table_words = (size_t)n_mels * (2 + kBandPitch);
  return sizeof(float) * (2 * (size_t)kStageFloats +
                          (x_words > table_words ? x_words : table_words) +
                          (size_t)kFrames * kPowerPitch);
}

cudaError_t prepare(int hop, int ksteps, int n_mels, size_t* smem) {
  if (hop < 4 || hop % 4 != 0 || ksteps < 2 || ksteps % 2 != 0 || n_mels < 1)
    return cudaErrorInvalidValue;
  *smem = smem_bytes(hop, ksteps, n_mels);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (*smem > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" const char* frontend_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (B, n) f32; tiles (8 ksteps x 416 x 2,) f32 with ksteps even, the basis
// (8 ksteps rows, zero past win) split and laid out by ops/frontend_cuda.py
// basis_tiles; band_bins (n_mels, 2) i32 and band_w (n_mels, 16) f32 from
// band_table; db_floor = mult log10(amin) - db_off -> out (B, frames, n_mels)
// f32. hop a multiple of 4.
extern "C" int log_mel_launch(const void* x, const void* tiles, const void* band_bins,
                              const void* band_w, void* out, int batch, int n, int frames,
                              int hop, int ksteps, int pad, int n_mels, float amin, float mult,
                              float db_off, float db_floor, void* stream) {
  size_t smem;
  const cudaError_t err = prepare(hop, ksteps, n_mels, &smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = n % 4 == 0 && pad % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 grid((frames + kFrames - 1) / kFrames, batch);
  log_mel_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)tiles, (const int*)band_bins, (const float*)band_w,
      (float*)out, n, frames, hop, ksteps, pad, n_mels, vec, amin, mult, db_off, db_floor);
  return (int)cudaGetLastError();
}

// How many blocks of the kernel fit one SM at this geometry.
extern "C" int log_mel_blocks_per_sm(int hop, int ksteps, int n_mels, int* blocks) {
  size_t smem;
  const cudaError_t err = prepare(hop, ksteps, n_mels, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, log_mel_kernel, kThreads,
                                                             smem);
}
