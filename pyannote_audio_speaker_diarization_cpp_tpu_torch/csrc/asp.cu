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
// Two kernels, picked by x's type. Both take one block per (row, 128
// channels), 8 warps; thread (g = lane / 4, q = lane % 4) of warp w holds the
// scores of channels 16w + g and 16w + g + 8 at frames 8j + 2q + {0, 1} of
// each 64-frame tile, so a channel's softmax state lives in one quad: its
// running max and sums fold with two __shfl_xor_sync. The softmax runs in
// base 2 (exp2 on scores pre-scaled by log2 e). The block reads its row's
// mask once, into bits in shared memory, with the row's last valid frame; it
// walks T only up to there (the frames after it have p = 0). Frames inside
// the walk still pass the mask test, so masks with holes work. Any C works
// (the channel edge is masked).
//
// bfloat16 x (the main path): asp_bf16_kernel. Bound on the H100: bytes.
// Only the valid frames of x and a_tanh need to be read (at most 32 x 3072 x
// 501 x 2 bytes, 98.5 MB, on the main path); the A -> C score product over
// those frames (at most 12.6 GFLOP) takes less than that on the bf16 tensor
// cores. The block's W tile (128 x A, K padded with zeros to a multiple of
// 16) is copied into shared memory once and stays there for the whole walk
// over T. Per tile of 64 frames each warp computes S (16 x 64) = W (16 x K) .
// a_tanh (K x 64) with mma.sync.m16n8k16 (bf16 in, float32 accumulate): W by
// ldmatrix, a_tanh (frame-contiguous) by ldmatrix.trans.
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
// A up to kMaxAttention, so that W and the ring fit two blocks on an SM.
//
// float32 x (compute_dtype="float32", precision="highest"): asp_f32_kernel.
// Bound on the H100: operations. The TPU kernel ran its score product at
// HIGHEST precision, so it must stay float32-accurate: it runs on the tensor
// cores in 3xTF32, as the log-mel kernel's DFT does (csrc/frontend.cu):
// v = big + small with big = v truncated to TF32 and small = v - big (the
// tensor cores read its top 19 bits), and w.a ~ w_small.a_big +
// w_big.a_small + w_big.a_big, the small terms first, within 2^-21 |w| |a|
// of the float32 product; the tensor cores truncate as they accumulate, so
// each k16's six products go into a fresh accumulator that is added to the
// running sum in float32. One TF32 product alone moves the softmax's
// weights by ~3e-4 and misses the float32 tolerance
// (tests/test_torch_asp_tf32.py). At the kernel phase's batch (32 rows,
// 9251 valid frames) the product is 3 x 2 x 3072 x 128 x 9251 = 21.8 TF32
// GFLOP, 0.044 ms at the 495 TFLOP/s peak; the bytes (x and a_tanh over the
// valid frames, 120.8 MB) take 0.036 ms.
//
// Design: the product runs on wgmma (m64n64k8, TF32), one warpgroup per 64
// channels: W, the A operand, from registers; a_tanh, the B operand, from
// shared memory by descriptor. The accumulator layout of m64nNk8 is the
// mma.sync layout above, so the softmax is the bf16 kernel's. Two k16s are
// in flight at a time (two fresh accumulators in turn).
// - TF32 wgmma reads B only K-major (a frame's k contiguous), and the model
//   writes a_tanh frame-contiguous. So a_tanh is not copied as it lies: each
//   thread holds its share of the next tile in registers (frame 8w + lane %
//   8, rows 16 i + 4 j + lane / 8: a warp reads four 32-byte row segments
//   an instruction). While the tensor cores run the current tile's k16 i,
//   it splits its k16-i values, stores both halves transposed into the next
//   stage's 8 x 4 core matrices (a warp's 32 stores hit 32 banks), and loads
//   k16 i of the tile after that.
// - K is padded to 128 with zeros (A above 128 is refused), so the k16 loop
//   is static. W (128 x 128) is copied into shared memory once per block by
//   16-byte asynchronous copies (4-byte where A or W's start do not allow),
//   rows of 16-byte chunks swizzled so that the fragment loads hit 32 banks,
//   split into its halves as it is loaded (split once, it would take twice
//   the room). Its copies and tile 0's loads are in flight while the mask is
//   read.
// - x goes from global memory straight into the registers that hold its
//   scores (channel rows g, g + 8 at frames 8j + 2q + {0, 1}), loaded at the
//   start of a tile and read after its product: a float32 row of x starts at
//   2004 (b C + c) bytes, 4-byte aligned, so 4-byte loads.
// - Shared memory: W 64 KB + 2 stages x (big, small) x 128 x 64 floats =
//   128 KB + the mask bits: 192 KB, one block an SM (8 warps). One block
//   barrier a tile.
// - Measured against the others (scripts/asp_cuda_ablation.py, PERF.md):
//   one k16 at a time; the next tile's a_tanh loaded after the product; x
//   loaded among the k16 steps; x staged by asynchronous copies; the
//   previous tile's softmax among the k16 steps; and a producer warpgroup
//   feeding two consumer warpgroups (scripts/asp_f32_specialized.cu). Each
//   was slower: with one block an SM, the eight warps' own loads, splits and
//   softmax are what the product waits on.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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


// Every thread of the block: the row's valid frames as bits in valid_s (bit
// t: mask_row[t] > 0) and the walk's end, one past the last valid frame (0
// if none).
__device__ __forceinline__ int walk_end(const void* mask_row, int mask_bf16, int Tn,
                                        unsigned* valid_s, int* last_s) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
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
  return t_end + 1;
}

// words of valid_s for Tn frames
__host__ __device__ __forceinline__ int valid_words(int Tn) {
  return (Tn + kThreads16 - 1) / kThreads16 * kWarps;
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

  const int t_end = walk_end(mask_row, mask_bf16, Tn, valid_s, last_s);

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
  return sizeof(uint32_t) * ((size_t)kBlockChannels * w_row_words(Kp) +
                             (size_t)kStages * (kBlockChannels + Kp) * kRowWords +
                             (size_t)valid_words(Tn));
}

cudaError_t bf16_prepare(int A, int Tn, size_t* smem) {
  *smem = bf16_smem_bytes(A, Tn);
  return cudaFuncSetAttribute(asp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

// ---------------------------------------------------------------------------
// float32 x: the score product on wgmma in 3xTF32.

constexpr int kMaxAttention32 = 128;             // largest A: W and B's two stages fit an SM
constexpr int kK16 = kMaxAttention32 / 16;       // k16 steps of the product: K padded to 128
constexpr int kHalf = kFrames * 8;               // floats of one half of a B k step (64 x 8)
constexpr int kStage32 = 2 * kK16 * 2 * kHalf;   // floats of a B stage

// The big TF32 half of v: v with its low 13 mantissa bits cleared. The small
// half is v - big, exact, of which the tensor cores read the top 19 bits as
// they read any TF32 operand: two instructions a value (rounding either half
// to nearest, by cvt.rna.tf32.f32 or by integer instructions, measured
// slower and no more accurate here)
__device__ __forceinline__ float tf32_big(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
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

// wgmma's descriptor of a 64 x 8 TF32 B operand in shared memory, K-major, no
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

// Pin registers: the compiler keeps reads of r after this point (wgmma
// writes its accumulators behind the compiler's back)
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(r[e])::"memory");
}

// k16 i of this thread's share of an a_tanh tile: frame f of rows k = 16 i +
// 4 j + k_ld (zero past A and from f_end on)
__device__ __forceinline__ void load_a_k16(float (&v)[4], const float* arow, int lda, int A,
                                           int k_ld, int f, int f_end, int i) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 16 * i + 4 * j + k_ld;
    v[j] = f < f_end && k < A ? __ldg(arow + (size_t)k * lda + f) : 0.0f;
  }
}

// Split the share's k16 i into TF32 halves and store them where wgmma reads
// B: per k step a big half then a small half of kHalf floats, each 8 frame
// groups 256 bytes apart, k 4..7 128 bytes after k 0..3, a frame's 4 k in 16
// bytes. `at`: this thread's frame and k within that (64 w + 4 (lane % 8) +
// lane / 8).
__device__ __forceinline__ void store_b(float* stage, const float (&v)[4], int i, int at) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float* big = stage + (2 * i + (j >> 1)) * 2 * kHalf + 32 * (j & 1) + at;
    const float hi = tf32_big(v[j]);
    big[0] = hi;
    big[kHalf] = v[j] - hi;
  }
}

// Word of W's element (row r, k) in shared memory: rows of 128 floats, the
// 16-byte chunk k / 4 of row r at chunk (k / 4) ^ (r % 8), so that a warp's
// fragment loads (rows g, k q) hit 32 banks
__host__ __device__ __forceinline__ int w_word(int r, int k) {
  return r * kMaxAttention32 + 4 * ((k >> 2) ^ (r & 7)) + (k & 3);
}

// The thread's W fragments of k16 i (rows r and r + 8 of the warp's 16, k
// 16 i + 8 h + q and + 4), split
__device__ __forceinline__ void load_w(uint32_t (&big)[2][4], uint32_t (&small)[2][4],
                                       const float* w_s, int r, int q, int i) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float v = w_s[w_word(r + 8 * (e & 1), 16 * i + 8 * h + 4 * (e >> 1) + q)];
      const float hi = tf32_big(v);
      big[h][e] = __float_as_uint(hi);
      small[h][e] = __float_as_uint(v - hi);
    }
}

__global__ void __launch_bounds__(kThreads16, 1)
asp_f32_kernel(const float* __restrict__ x, const float* __restrict__ a, int lda,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ mask, float* __restrict__ mean_out,
               float* __restrict__ std_out, int C, int A, int Tn, float eps) {
  extern __shared__ __align__(128) float smem32[];
  __shared__ int last_s[kWarps];
  float* w_s = smem32;                                  // 128 x 128 (w_word)
  float* b_s = w_s + kBlockChannels * kMaxAttention32;  // 2 stages of B: k steps x (big, small)
  unsigned* valid_s = reinterpret_cast<unsigned*>(b_s + 2 * kStage32);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kBlockChannels;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int q = lane & 3;   // accumulator columns 2q, 2q + 1 of each 8-frame group
  const float* arow = a + (size_t)b * A * lda;
  const int f_ld = 8 * warp + (lane & 7);  // this thread's frame of an a_tanh tile
  const int k_ld = lane >> 3;
  const int at = 64 * warp + 4 * (lane & 7) + k_ld;

  // W's tile and tile 0's share of a_tanh, in flight while the mask is read
  {
    // W's tile by asynchronous copies, all in flight at once: 16 bytes a
    // copy where A and W's start allow, else 4; rows past C and k past A
    // zero
    const int nw = min(kBlockChannels, C - c0);
    uint32_t* w_words = reinterpret_cast<uint32_t*>(w_s);
    if ((A & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
#pragma unroll 4
      for (int i = tid; i < kBlockChannels * kMaxAttention32 / 4; i += kThreads16) {
        const int r = i / (kMaxAttention32 / 4);
        const int k = 4 * (i % (kMaxAttention32 / 4));
        const bool ok = r < nw && k < A;
        cp_async16(w_words + w_word(r, k), w + (ok ? (size_t)(c0 + r) * A + k : 0), ok);
      }
    } else {
      const uint32_t* w_src = reinterpret_cast<const uint32_t*>(w);
      for (int i = tid; i < kBlockChannels * kMaxAttention32; i += kThreads16) {
        const int r = i / kMaxAttention32;
        const int k = i % kMaxAttention32;
        const bool ok = r < nw && k < A;
        cp_async4(w_words + w_word(r, k), w_src + (ok ? (size_t)(c0 + r) * A + k : 0), ok);
      }
    }
    cp_async_commit();
  }
  float av[kK16][4];
#pragma unroll
  for (int i = 0; i < kK16; ++i) load_a_k16(av[i], arow, lda, A, k_ld, f_ld, Tn, i);
  const int t_end = walk_end(mask + (size_t)b * Tn, 0, Tn, valid_s, last_s);

  float bias_l2[2];
  const float* xr[2];  // this thread's rows of x (null past C)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 16 * warp + g + 8 * h;
    bias_l2[h] = c < C ? bias[c] * kLog2e : 0.0f;
    xr[h] = c < C ? x + ((size_t)b * C + c) * Tn : nullptr;
  }

  // tile 0 into B's first stage; tile 1's share into the registers
#pragma unroll
  for (int i = 0; i < kK16; ++i) {
    store_b(b_s, av[i], i, at);
    load_a_k16(av[i], arow, lda, A, k_ld, kFrames + f_ld, t_end, i);
  }
  fence_proxy_async();
  cp_async_wait_all();
  __syncthreads();

  float run_max[2] = {-INFINITY, -INFINITY};
  float den[2] = {0.0f, 0.0f}, s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
  float acc[32], dd[2][32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dd[0][e] = dd[1][e] = 0.0f;
  int s = 0;
  for (int t0 = 0; t0 < t_end; t0 += kFrames, s ^= 1) {
    const float* stage = b_s + s * kStage32;
    float* next = b_s + (s ^ 1) * kStage32;
    // x of the tile, read after the product: rows g, g + 8 at 8n + 2q + e
    float xv[2][16];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int f = t0 + 8 * (i >> 1) + 2 * q + (i & 1);
        xv[h][i] = xr[h] != nullptr && f < t_end ? __ldg(xr[h] + f) : 0.0f;
      }
    // S (64 x 64 per warpgroup) = W . a_tanh, 3xTF32: each k16 into a fresh
    // accumulator (two, in turn), added to acc once the next k16 is issued
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
#pragma unroll
    for (int i = 0; i < kK16; ++i) {
      uint32_t w_big[2][4], w_small[2][4];
      load_w(w_big, w_small, w_s, 16 * warp + g, q, i);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* big = stage + (2 * i + h) * 2 * kHalf;
        wgmma_tf32(dd[i & 1], w_small[h], b_desc(big), h);         // w_small . a_big
        wgmma_tf32(dd[i & 1], w_big[h], b_desc(big + kHalf), 1);   // w_big . a_small
        wgmma_tf32(dd[i & 1], w_big[h], b_desc(big), 1);           // w_big . a_big
      }
      wgmma_commit();
      // while the tensor cores run: the next tile's B, then the share of the
      // one after it
      store_b(next, av[i], i, at);
      load_a_k16(av[i], arow, lda, A, k_ld, t0 + 2 * kFrames + f_ld, t_end, i);
      if (i > 0) {  // k16 i - 1 is done: add it
        wgmma_wait_one();
        fence_regs(dd[(i - 1) & 1]);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] += dd[(i - 1) & 1][e];
      }
      if (i + 1 == kK16) {
        wgmma_wait_all();
        fence_regs(dd[i & 1]);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[e] += dd[i & 1][e];
      }
    }
    fence_proxy_async();  // the next stage, for the wgmma after the barrier

    const unsigned long long valid =
        (static_cast<unsigned long long>(valid_s[t0 / 32 + 1]) << 32) | valid_s[t0 / 32];
    if (valid != 0ull) {  // the same for the whole block
      // scores in base 2, -inf on invalid frames; the tile's max per channel
      const unsigned long long vq = valid >> (2 * q);  // bit 8n + e: frame 8n + 2q + e
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < kFrames / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const bool ok = (vq >> (8 * n + (e & 1))) & 1ull;
          float& sc = acc[4 * n + e];
          sc = ok ? fmaf(sc, kLog2e, bias_l2[h]) : -INFINITY;
          tmax[h] = fmaxf(tmax[h], sc);
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
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < kFrames / 8; ++n) {
          const float x0 = xv[h][2 * n], x1 = xv[h][2 * n + 1];
          const float p0 = ex2(acc[4 * n + 2 * h] - run_max[h]);
          const float p1 = ex2(acc[4 * n + 2 * h + 1] - run_max[h]);
          den[h] += p0 + p1;
          s1[h] = fmaf(p1, x1, fmaf(p0, x0, s1[h]));
          s2[h] = fmaf(p1 * x1, x1, fmaf(p0 * x0, x0, s2[h]));
        }
    }
    __syncthreads();  // the next stage is stored; no wgmma reads this one
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      den[h] += __shfl_xor_sync(kFull, den[h], m);
      s1[h] += __shfl_xor_sync(kFull, s1[h], m);
      s2[h] += __shfl_xor_sync(kFull, s2[h], m);
    }
    const int c = c0 + 16 * warp + g + 8 * h;
    if (q == 0 && c < C) {
      const float mean = s1[h] / den[h];
      const float sq = s2[h] / den[h];
      const float var = fmaxf(sq - mean * mean, 0.0f);
      mean_out[(size_t)b * C + c] = mean;
      std_out[(size_t)b * C + c] = sqrtf(fmaxf(var, eps));
    }
  }
}

size_t f32_smem_bytes(int Tn) {
  return sizeof(float) * ((size_t)kBlockChannels * kMaxAttention32 + 2 * kStage32 +
                          (size_t)valid_words(Tn));
}

cudaError_t f32_prepare(int Tn, size_t* smem) {
  *smem = f32_smem_bytes(Tn);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (*smem > (size_t)limit) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(asp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" const char* asp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" int asp_max_attention() { return kMaxAttention; }

extern "C" int asp_max_attention_f32() { return kMaxAttention32; }

// x (B, C, T) float32, contiguous; a_tanh (B, A, T) float32 in rows of
// lda >= T frames (batch stride A lda); w (C, A) float32, contiguous; bias
// (C,) and mask (B, T) float32; A at most asp_max_attention_f32() -> mean,
// std (B, C) float32.
extern "C" int asp_pool_f32_launch(const void* x, const void* a, int lda, const void* w,
                                   const void* bias, const void* mask, void* mean,
                                   void* std_out, int batch, int C, int A, int Tn,
                                   float eps, void* stream) {
  if (A < 1 || A > kMaxAttention32 || lda < Tn) return (int)cudaErrorInvalidValue;
  size_t smem;
  const cudaError_t err = f32_prepare(Tn, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((C + kBlockChannels - 1) / kBlockChannels, batch);
  asp_f32_kernel<<<grid, kThreads16, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, lda, (const float*)w, (const float*)bias,
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

// How many blocks of the float32 kernel fit one SM at T frames (any A).
extern "C" int asp_f32_blocks_per_sm(int Tn, int* blocks) {
  size_t smem;
  cudaError_t err = f32_prepare(Tn, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, asp_f32_kernel,
                                                             kThreads16, smem);
}
