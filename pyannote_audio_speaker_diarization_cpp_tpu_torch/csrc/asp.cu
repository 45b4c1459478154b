// ECAPA attentive-statistics pooling tail, fused, with an online softmax.
//
// Replaces the TPU kernel asp_pool_pallas / _asp_kernel
// (pyannote_audio_speaker_diarization_cpp_tpu/ops/asp_pallas.py).
//
// What it computes, per row b and channel c:
//   s[t]  = sum_a W[c, a] * a_tanh[b, a, t] + bias[c]      (the 1x1 A -> C conv)
//   p[t]  = softmax of s over the frames with mask[b, t] > 0
//   mean  = sum_t p[t] x[b, c, t];   sq = sum_t p[t] x[b, c, t]^2
//   std   = sqrt(max(max(sq - mean^2, 0), eps))
// in float32, with mean and std stored in x's type (float32 or bfloat16).
// The (B, C, T) scores never reach device memory.
//
// Bound on the H100: bytes. Only the valid frames of x and a_tanh need to be
// read (at most 32 x 3072 x 501 x 2 bytes, 98.5 MB, in bf16 on the main path);
// the A -> C score product over those frames (at most 12.6 GFLOP) takes
// less than that on the bf16 tensor cores.
//
// Two kernels, picked by x's type:
//
// bfloat16 x (the main path): asp_bf16_kernel, the score product on the
// tensor cores. One block per (row, 128 channels), 8 warps, warp w owning
// channels 16w..16w+15 (the FlashAttention-2 layout). The block's W tile
// (128 x A, K padded with zeros to a multiple of 16) is copied into shared
// memory once and stays there for the whole walk over T. Per tile of 64
// frames each warp computes S (16 x 64) = W (16 x K) . a_tanh (K x 64) with
// mma.sync.m16n8k16 (bf16 in, float32 accumulate): W by ldmatrix, a_tanh
// (frame-contiguous) by ldmatrix.trans. Thread (g = lane / 4, q = lane % 4)
// then holds the scores of channels g and g + 8 at frames 8j + 2q + {0, 1},
// j = 0..7, so a channel's softmax state lives in one quad: its running max
// and sums fold with two __shfl_xor_sync. The softmax runs in base 2
// (exp2 on scores pre-scaled by log2 e).
//
// Staging: tiles come through a 2-stage ring of asynchronous copies
// (cp.async), tile t + 1 in flight while tile t is computed, with one block
// barrier a tile. Alignment decides how. At T = 501 a bf16 row of x starts
// at 1002 (b C + c) bytes, so only one row in eight is 16-byte aligned and
// every other row is not even 4-byte aligned: neither TMA (global strides in
// multiples of 16 bytes) nor 16-byte cp.async can take x as the caller lays
// it out, and copying x to an aligned layout would move as many bytes as
// the kernel. So x is copied in 4-byte words from the aligned word holding
// a row's first frame of the tile (a 33rd word when that frame is the
// word's upper half), and the one-element shift is undone with a funnel
// shift when x is read. a_tanh is the model's own tanh output, which it
// writes into rows padded to a multiple of 8 frames (ops/asp_cuda.py
// attention_tanh), so its tiles go by 16-byte copies straight to where
// ldmatrix reads them; the wrapper copies any other a_tanh into that layout.
//
// Stop: the block reads its row's mask once, into bits in shared memory,
// with the row's last valid frame; it walks T only up to there (the frames
// after it have p = 0). Frames inside the walk still pass the mask test, so
// masks with holes work. Any C works (the channel edge is masked); A up to
// kMaxAttention, so that W and the ring fit two blocks on an SM.
//
// float32 x (precision="highest", the parity runs): asp_kernel<float>, one
// block per (row, 128 channels), one thread per channel. The block walks T
// in tiles of kTile frames: it stages a_tanh[b, :, tile] (A x kTile) and
// x[b, c-block, tile] in shared memory with coalesced loads (the x tile
// padded by one column so each thread's row reads are conflict-free),
// computes its channel's kTile scores with float32 FMAs (W read transposed,
// (A, C), so a warp's weight loads coalesce), and folds the tile into a
// running max, denominator, sum p*x and sum p*x^2, so x is read exactly
// once. Its products stay float32-exact, off the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 128;  // channels per block == threads per block
constexpr int kTile = 32;       // frames per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(kChannels)
asp_kernel(const T* __restrict__ x, const T* __restrict__ a,
           const T* __restrict__ wt, const float* __restrict__ bias,
           const float* __restrict__ mask, T* __restrict__ mean_out,
           T* __restrict__ std_out, int C, int A, int Tn, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                   // A x kTile
  float* x_s = smem + A * kTile;       // kChannels x (kTile + 1)
  __shared__ float m_s[kTile];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kChannels;
  const int tid = threadIdx.x;
  const int c = c0 + tid;
  const bool active = c < C;
  const float bias_c = active ? bias[c] : 0.0f;

  float run_max = -INFINITY, den = 0.0f, s1 = 0.0f, s2 = 0.0f;
  for (int t0 = 0; t0 < Tn; t0 += kTile) {
    const int tn = min(kTile, Tn - t0);
    for (int idx = tid; idx < A * kTile; idx += kChannels) {
      const int aa = idx / kTile;
      const int tt = idx - aa * kTile;
      a_s[idx] = tt < tn ? to_f32(a[((size_t)b * A + aa) * Tn + t0 + tt]) : 0.0f;
    }
    for (int idx = tid; idx < kChannels * kTile; idx += kChannels) {
      const int cc = idx / kTile;
      const int tt = idx - cc * kTile;
      const int ch = c0 + cc;
      x_s[cc * (kTile + 1) + tt] =
          (tt < tn && ch < C) ? to_f32(x[((size_t)b * C + ch) * Tn + t0 + tt]) : 0.0f;
    }
    if (tid < kTile) m_s[tid] = tid < tn ? mask[(size_t)b * Tn + t0 + tid] : 0.0f;
    __syncthreads();

    float s[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) s[tt] = bias_c;
    if (active) {
      for (int aa = 0; aa < A; ++aa) {
        const float w = to_f32(wt[(size_t)aa * C + c]);
        const float4* ar = reinterpret_cast<const float4*>(a_s + aa * kTile);
#pragma unroll
        for (int q = 0; q < kTile / 4; ++q) {
          const float4 v = ar[q];
          s[4 * q + 0] = fmaf(w, v.x, s[4 * q + 0]);
          s[4 * q + 1] = fmaf(w, v.y, s[4 * q + 1]);
          s[4 * q + 2] = fmaf(w, v.z, s[4 * q + 2]);
          s[4 * q + 3] = fmaf(w, v.w, s[4 * q + 3]);
        }
      }
    }

    float tmax = -INFINITY;
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt)
      if (m_s[tt] > 0.0f) tmax = fmaxf(tmax, s[tt]);
    if (tmax > -INFINITY) {  // the tile holds valid frames (same for every thread)
      const float new_max = fmaxf(run_max, tmax);
      const float scale = expf(run_max - new_max);  // 0 on the first valid tile
      den *= scale;
      s1 *= scale;
      s2 *= scale;
      const float* xr = x_s + tid * (kTile + 1);
#pragma unroll
      for (int tt = 0; tt < kTile; ++tt) {
        if (m_s[tt] > 0.0f) {
          const float p = expf(s[tt] - new_max);
          const float xv = xr[tt];
          den += p;
          s1 = fmaf(p, xv, s1);
          s2 = fmaf(p * xv, xv, s2);
        }
      }
      run_max = new_max;
    }
    __syncthreads();
  }

  if (active) {
    const float mean = s1 / den;
    const float sq = s2 / den;
    const float var = fmaxf(sq - mean * mean, 0.0f);
    mean_out[(size_t)b * C + c] = from_f32<T>(mean);
    std_out[(size_t)b * C + c] = from_f32<T>(sqrtf(fmaxf(var, eps)));
  }
}

// ---------------------------------------------------------------------------
// bfloat16 x: the tensor-core kernel.

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads16 = 32 * kWarps;      // threads per block
constexpr int kBlockChannels = 16 * kWarps;  // channels per block: 16 a warp
constexpr int kFrames = 64;                  // frames per tile
constexpr int kRowWords = (kFrames + 8) / 2; // shared row of a tile: 144 bytes,
                                             // so ldmatrix and the x reads are
                                             // free of bank conflicts
constexpr int kRowsPerWarp = kBlockChannels / kWarps;  // x rows a warp copies: its own
constexpr int kStages = 2;                   // tiles in shared memory: one
                                             // read, one in flight
constexpr int kMaxAttention = 256;           // largest A whose tiles fit
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ __forceinline__ int padded_k(int A) { return (A + 15) / 16 * 16; }
__host__ __device__ __forceinline__ int w_row_words(int Kp) { return (Kp + 8) / 2; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint32_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes, or 16 zero bytes without reading src when !ok
__device__ __forceinline__ void cp_async16(uint32_t* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, or 4 zero bytes without reading src when !ok
__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^v (0 at -inf), one MUFU instruction
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float load_f32_or_bf16(const void* p, int is_bf16, size_t i) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                 : static_cast<const float*>(p)[i];
}

// Rows of Tn bf16 frames, read as 4-byte words: `base` is the aligned word
// holding the first row's frame 0 and `offset` (0 or 1) that frame's half in
// it, so frame t of row r is half-word offset + r Tn + t counted from base.
// A 64-frame segment starting at half-word h is then words h / 2 .. h / 2 + 31
// shifted down by h % 2 halves, and a 33rd word when h is odd.
struct Rows {
  const uint32_t* base;
  int offset;
};

__device__ __forceinline__ Rows rows_from(const __nv_bfloat16* first) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(first);
  return {reinterpret_cast<const uint32_t*>(p & ~uintptr_t(3)), int((p >> 1) & 1)};
}

// Start the asynchronous copy of the tile [t0, t0 + 64) into a ring stage.
//
// x: each warp copies its own 16 rows (nx of them exist) as they lie: row j
// gets the 32 words from the one holding frame t0 on, and a 33rd when frame
// t0 is a word's upper half; the shift is undone when x is read. Words
// wholly at or past t_lim are zero-filled without being read.
//
// a_tanh: rows of lda frames, 16-byte aligned, so each row's 64 frames are
// 8 16-byte chunks copied where the tensor cores read them; rows past A and
// chunks past Tn are zero-filled.
__device__ __forceinline__ void copy_tile(uint32_t* stage, Rows xr, const __nv_bfloat16* ab,
                                          int lda, int nx, int A, int Kp, int Tn, int r0,
                                          int tid, int t0, int t_lim) {
  const int lane = tid & 31;
  const int hx = xr.offset + r0 * Tn + t0;
  const int t = t0 + 2 * lane;  // word `lane` holds frames t - shift, t - shift + 1
  const bool even = t - (hx & 1) < t_lim, odd = t - ((hx + Tn) & 1) < t_lim;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int h = hx + j * Tn;  // rows r and r + 1 start Tn halves apart
    const bool ok = j < nx && (j & 1 ? odd : even);
    cp_async4(stage + (r0 + j) * kRowWords + lane, xr.base + (ok ? (h >> 1) + lane : 0), ok);
  }
  if (lane < kRowsPerWarp) {
    const int h = hx + lane * Tn;
    const bool ok = lane < nx && (h & 1) && t0 + kFrames - 1 < t_lim;
    cp_async4(stage + (r0 + lane) * kRowWords + 32, xr.base + (ok ? (h >> 1) + 32 : 0), ok);
  }
  uint32_t* a_s = stage + kBlockChannels * kRowWords;
  for (int i = tid; i < Kp * (kFrames / 8); i += kThreads16) {
    const int r = i / (kFrames / 8);
    const int f = t0 + 8 * (i % (kFrames / 8));
    const bool ok = r < A && f < Tn;
    cp_async16(a_s + r * kRowWords + (f - t0) / 2, ab + (ok ? (size_t)r * lda + f : 0), ok);
  }
}

__global__ void __launch_bounds__(kThreads16, 2)
asp_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ a,
                int lda, const __nv_bfloat16* __restrict__ w, const void* __restrict__ bias,
                int bias_bf16, const void* __restrict__ mask, int mask_bf16,
                __nv_bfloat16* __restrict__ mean_out, __nv_bfloat16* __restrict__ std_out,
                int C, int A, int Tn, float eps) {
  extern __shared__ __align__(16) uint32_t smem16[];
  __shared__ int last_s[kWarps];
  const int Kp = padded_k(A);
  const int w_words = w_row_words(Kp);
  const int stage_words = (kBlockChannels + Kp) * kRowWords;
  uint32_t* w_s = smem16;                           // kBlockChannels x (Kp + 8) bf16
  uint32_t* ring = w_s + kBlockChannels * w_words;  // kStages x (x rows, a_tanh rows)
  unsigned* valid_s = ring + kStages * stage_words;  // bit t: mask[b, t] > 0

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kBlockChannels;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int q = lane & 3;   // accumulator columns 2q, 2q + 1 of each 8-frame tile
  const int r0 = kRowsPerWarp * warp;
  const void* mask_row = mask_bf16
      ? static_cast<const void*>(static_cast<const __nv_bfloat16*>(mask) + (size_t)b * Tn)
      : static_cast<const void*>(static_cast<const float*>(mask) + (size_t)b * Tn);
  const Rows xr = rows_from(x + ((size_t)b * C + c0) * Tn);
  const __nv_bfloat16* ab = a + (size_t)b * A * lda;
  const int nx = C - c0 - r0;  // x rows of this warp that exist

  // the row's valid frames as bits, and the walk's end: one past the last
  int last = -1;
  for (int t0 = 0; t0 < Tn; t0 += kThreads16) {
    const int t = t0 + tid;
    const bool v = t < Tn && load_f32_or_bf16(mask_row, mask_bf16, t) > 0.0f;
    const unsigned bits = __ballot_sync(kFull, v);
    if (lane == 0) valid_s[(t0 + 32 * warp) / 32] = bits;
    if (v) last = t;
  }
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) last_s[warp] = last;
  __syncthreads();
  int t_end = last_s[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) t_end = max(t_end, last_s[i]);
  t_end += 1;

  float run_max[2] = {-INFINITY, -INFINITY};
  float den[2] = {0.0f, 0.0f}, s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
  if (t_end > 0) {
    // W's tile, once: 16-byte asynchronous copies when its rows allow, else
    // 2-byte loads. Rows past C and columns in [A, Kp) are zero. Its copies
    // join tile 0's group.
    const int nw = min(kBlockChannels, C - c0);
    if ((A & 7) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
      const int chunks = Kp / 8;  // 16-byte chunks a row
      for (int i = tid; i < kBlockChannels * chunks; i += kThreads16) {
        const int r = i / chunks;
        const int k8 = i - r * chunks;
        const bool ok = r < nw && 8 * k8 < A;
        cp_async16(w_s + r * w_words + 4 * k8, w + (ok ? (size_t)(c0 + r) * A + 8 * k8 : 0), ok);
      }
    } else {
      unsigned short* w_h = reinterpret_cast<unsigned short*>(w_s);
      const unsigned short* wg = reinterpret_cast<const unsigned short*>(w);
      for (int i = tid; i < kBlockChannels * Kp; i += kThreads16) {
        const int r = i / Kp;
        const int k = i - r * Kp;
        w_h[r * 2 * w_words + k] = r < nw && k < A ? __ldg(wg + (size_t)(c0 + r) * A + k)
                                                   : (unsigned short)0;
      }
    }
    copy_tile(ring, xr, ab, lda, nx, A, Kp, Tn, r0, tid, 0, t_end);
    cp_async_commit();
  }
  float bias_l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + r0 + g + 8 * h;
    bias_l2[h] = c < C ? load_f32_or_bf16(bias, bias_bf16, c) * kLog2e : 0.0f;
  }

  const uint32_t* w_warp = w_s + r0 * w_words;
  // ldmatrix.x4: lanes 8m..8m+7 address the rows of 8 x 8 matrix m
  const int ld_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int ld_col = (lane >> 4) * 4;  // words: 8 bf16
  uint32_t* stage = ring;
  for (int t0 = 0; t0 < t_end; t0 += kFrames) {
    cp_async_wait_all();  // this thread's copies of tile t0 (and W) landed
    __syncthreads();      // everyone's, and the other stage is no longer read
    uint32_t* next = stage == ring ? ring + stage_words : ring;
    if (t0 + kFrames < t_end) {
      copy_tile(next, xr, ab, lda, nx, A, Kp, Tn, r0, tid, t0 + kFrames, t_end);
      cp_async_commit();
    }
    const uint32_t* x_s = stage;
    const uint32_t* a_s = stage + kBlockChannels * kRowWords;
    stage = next;
    const unsigned long long valid =
        (static_cast<unsigned long long>(valid_s[t0 / 32 + 1]) << 32) | valid_s[t0 / 32];
    if (valid == 0ull) continue;  // the same for the whole block

    float acc[kFrames / 8][4];
#pragma unroll
    for (int n = 0; n < kFrames / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
    for (int k0 = 0; k0 < Kp; k0 += 16) {
      uint32_t af[4];
      ldmatrix_x4(af, w_warp + ld_row * w_words + k0 / 2 + ld_col);
#pragma unroll
      for (int np = 0; np < kFrames / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, a_s + (k0 + ld_row) * kRowWords + 8 * np + ld_col);
        mma_bf16(acc[2 * np], af, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // scores in base 2, -inf on invalid frames; the tile's max per channel
    const unsigned long long vq = valid >> (2 * q);  // bit 8n + e: frame 8n + 2q + e
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kFrames / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool ok = (vq >> (8 * n + (e & 1))) & 1ull;
        acc[n][e] = ok ? fmaf(acc[n][e], kLog2e, bias_l2[h]) : -INFINITY;
        tmax[h] = fmaxf(tmax[h], acc[n][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(kFull, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(kFull, tmax[h], 2));
      const float new_max = fmaxf(run_max[h], tmax[h]);
      const float scale = ex2(run_max[h] - new_max);  // 0 on the first valid tile
      den[h] *= scale;
      s1[h] *= scale;
      s2[h] *= scale;
      run_max[h] = new_max;
    }
    // x rows g and g + 8 of the warp, as copied: shifted by their first
    // frame's half
    const int hx = xr.offset + (r0 + g) * Tn + t0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* xrow = x_s + (r0 + g + 8 * h) * kRowWords + q;
      const int shift = 16 * ((hx + 8 * h * Tn) & 1);
#pragma unroll
      for (int n = 0; n < kFrames / 8; ++n) {
        const uint32_t xw = __funnelshift_r(xrow[4 * n], xrow[4 * n + 1], shift);
        const float x0 = __uint_as_float(xw << 16);
        const float x1 = __uint_as_float(xw & 0xffff0000u);
        const float p0 = ex2(acc[n][2 * h] - run_max[h]);
        const float p1 = ex2(acc[n][2 * h + 1] - run_max[h]);
        den[h] += p0 + p1;
        s1[h] = fmaf(p1, x1, fmaf(p0, x0, s1[h]));
        s2[h] = fmaf(p1 * x1, x1, fmaf(p0 * x0, x0, s2[h]));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      den[h] += __shfl_xor_sync(kFull, den[h], m);
      s1[h] += __shfl_xor_sync(kFull, s1[h], m);
      s2[h] += __shfl_xor_sync(kFull, s2[h], m);
    }
    const int c = c0 + r0 + g + 8 * h;
    if (q == 0 && c < C) {
      const float mean = s1[h] / den[h];
      const float sq = s2[h] / den[h];
      const float var = fmaxf(sq - mean * mean, 0.0f);
      mean_out[(size_t)b * C + c] = __float2bfloat16(mean);
      std_out[(size_t)b * C + c] = __float2bfloat16(sqrtf(fmaxf(var, eps)));
    }
  }
}

size_t bf16_smem_bytes(int A, int Tn) {
  const int Kp = padded_k(A);
  const size_t valid_words = (size_t)(Tn + kThreads16 - 1) / kThreads16 * kWarps;
  return sizeof(uint32_t) * ((size_t)kBlockChannels * w_row_words(Kp) +
                             (size_t)kStages * (kBlockChannels + Kp) * kRowWords + valid_words);
}

cudaError_t bf16_prepare(int A, int Tn, size_t* smem) {
  *smem = bf16_smem_bytes(A, Tn);
  return cudaFuncSetAttribute(asp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" const char* asp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int asp_max_attention() { return kMaxAttention; }

// x (B, C, T), a_tanh (B, A, T), wt (A, C) float32; bias (C,), mask (B, T)
// float32 -> mean, std (B, C) float32.
extern "C" int asp_pool_f32_launch(const void* x, const void* a, const void* wt,
                                   const void* bias, const void* mask, void* mean,
                                   void* std_out, int batch, int C, int A, int Tn,
                                   float eps, void* stream) {
  const size_t smem = (size_t)(A * kTile + kChannels * (kTile + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        asp_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((C + kChannels - 1) / kChannels, batch);
  asp_kernel<float><<<grid, kChannels, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)wt, (const float*)bias,
      (const float*)mask, (float*)mean, (float*)std_out, C, A, Tn, eps);
  return (int)cudaGetLastError();
}

// x (B, C, T) bfloat16, any 2-byte alignment; a_tanh (B, A, T) bfloat16 in
// rows of lda >= T frames (batch stride A lda), 16-byte aligned; w (C, A)
// bfloat16; bias (C,) and mask (B, T) bfloat16 where *_bf16, else float32;
// A at most asp_max_attention() -> mean, std (B, C) bfloat16.
extern "C" int asp_pool_bf16_launch(const void* x, const void* a, int lda, const void* w,
                                    const void* bias, int bias_bf16, const void* mask,
                                    int mask_bf16, void* mean, void* std_out, int batch,
                                    int C, int A, int Tn, float eps, void* stream) {
  if (A < 1 || A > kMaxAttention || lda < Tn || lda % 8 != 0 ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  size_t smem;
  const cudaError_t err = bf16_prepare(A, Tn, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kBlockChannels - 1) / kBlockChannels, batch);
  asp_bf16_kernel<<<grid, kThreads16, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)a, lda, (const __nv_bfloat16*)w, bias,
      bias_bf16, mask, mask_bf16, (__nv_bfloat16*)mean, (__nv_bfloat16*)std_out, C, A, Tn,
      eps);
  return (int)cudaGetLastError();
}

// How many blocks of the bf16 kernel fit one SM at attention width A and T
// frames.
extern "C" int asp_bf16_blocks_per_sm(int A, int Tn, int* blocks) {
  size_t smem;
  cudaError_t err = bf16_prepare(A, Tn, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, asp_bf16_kernel,
                                                             kThreads16, smem);
}
