// The float32 ASP kernel in the warp-specialized form that was measured and
// not kept, for scripts/asp_cuda_ablation.py (variant f32_specialized).
// Nothing in the package loads it. csrc/asp.cu's asp_f32_kernel computes the
// same with all 8 warps loading, splitting and multiplying; here one
// producer warpgroup loads a_tanh, splits it into B's stages and copies x
// into shared memory by 4-byte asynchronous copies, and two consumer
// warpgroups run only the product and the softmax, handing stages over by
// named barriers. On an H100 the producer bound it: its 4-byte asynchronous
// copies of x took longer than the product (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads16 = 32 * kWarps;      // threads per block
constexpr int kBlockChannels = 16 * kWarps;  // channels per block: 16 a warp
constexpr int kFrames = 64;                  // frames per tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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


// Every thread of a block of kT threads: the row's valid frames as bits in
// valid_s (bit t: mask_row[t] > 0) and the walk's end, one past the last
// valid frame (0 if none). last_s: kT / 32 ints.
template <int kT>
__device__ __forceinline__ int walk_end(const void* mask_row, int mask_bf16, int Tn,
                                        unsigned* valid_s, int* last_s) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  int last = -1;
  for (int t0 = 0; t0 < Tn; t0 += kT) {
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
  for (int i = 1; i < kT / 32; ++i) t_end = max(t_end, last_s[i]);
  return t_end + 1;
}

// words of valid_s for Tn frames, in a block of kT threads
template <int kT>
__host__ __device__ __forceinline__ int valid_words(int Tn) {
  return (Tn + kT - 1) / kT * (kT / 32);
}

constexpr int kMaxAttention32 = 128;             // largest A: W and B's two stages fit an SM
constexpr int kK16 = kMaxAttention32 / 16;       // k16 steps of the product: K padded to 128
constexpr int kHalf = kFrames * 8;               // floats of one half of a B k step (64 x 8)
constexpr int kStage32 = 2 * kK16 * 2 * kHalf;   // floats of a B stage

// v rounded to TF32 (nearest, ties away), low 13 mantissa bits zero: what
// cvt.rna.tf32.f32 gives for finite v, in two integer instructions (the cvt
// compiles to a longer sequence that also handles NaN)
__device__ __forceinline__ float to_tf32(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xffffe000u);
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

// Named barriers of the float32 kernel (0 is __syncthreads): the producer
// warpgroup arrives and the consumers wait on kBarFull + stage when a B stage
// holds its tile, and on kBarXFull when x holds the tile's rows; the
// consumers arrive and the producer waits on kBarEmpty + stage when no
// wgmma reads that stage any more, and on kBarXEmpty when the softmax no
// longer reads x.
constexpr int kThreads32 = 384;  // two consumer warpgroups, one producer warpgroup
constexpr int kBarFull = 1, kBarEmpty = 3, kBarXFull = 5, kBarXEmpty = 6;

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kThreads32) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(kThreads32) : "memory");
}

// Word of x's element (row r of the block's 128, frame f of the tile) in x_s:
// rows of 64 floats, frame f of row r at (f + 8 (r % 4)) % 64, so that the
// softmax's 8-byte reads (rows g, frames 2q) hit 32 banks
__device__ __forceinline__ int x_word(int r, int f) {
  return r * kFrames + ((f + 8 * (r & 3)) & (kFrames - 1));
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
      const float hi = to_tf32(v);
      big[h][e] = __float_as_uint(hi);
      small[h][e] = __float_as_uint(to_tf32(v - hi));
    }
}

// The producer's share of an a_tanh tile, half `part` of it: frames 8 (2 pw
// + m) + lane % 8 for m = 0, 1, rows k = 4 c + lane / 8 for c = 16 part ..
// 16 part + 15 (zero past A and from t_end on; pw: the producer warp)
__device__ __forceinline__ void load_a_part(float (&v)[2][16], const float* arow, int lda, int A,
                                            int t0, int t_end, int pw, int lane, int part) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int f = t0 + 8 * (2 * pw + m) + (lane & 7);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int k = 4 * (16 * part + c) + (lane >> 3);
      v[m][c] = f < t_end && k < A ? __ldg(arow + (size_t)k * lda + f) : 0.0f;
    }
  }
}

// Split the values of load_a_part into TF32 halves and store them where
// wgmma reads B: per k step of 8 a big half then a small half of kHalf
// floats, each 8 frame groups 256 bytes apart, k 4..7 128 bytes after k
// 0..3, a frame's 4 k in 16 bytes (a warp's 32 stores hit 32 banks)
__device__ __forceinline__ void store_a_part(float* stage, const float (&v)[2][16], int pw,
                                             int lane, int part) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int kc = 16 * part + c;  // k / 4
      float* big = stage + (kc >> 1) * 2 * kHalf + 64 * (2 * pw + m) + 32 * (kc & 1) +
                   4 * (lane & 7) + (lane >> 3);
      const float hi = to_tf32(v[m][c]);
      big[0] = hi;
      big[kHalf] = to_tf32(v[m][c] - hi);
    }
}

// The producer: a_tanh's tile at t0 into a B stage, split
__device__ __forceinline__ void fill_b(float* stage, const float* arow, int lda, int A, int t0,
                                       int t_end, int pw, int lane) {
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    float v[2][16];
    load_a_part(v, arow, lda, A, t0, t_end, pw, lane, part);
    store_a_part(stage, v, pw, lane, part);
  }
  fence_proxy_async();  // for the consumers' wgmma, after the barrier
}

// The producer: x's 128 rows of the tile at t0 into x_s by 4-byte
// asynchronous copies, a row's 64 frames in two warp-wide copies, warp pw
// copying rows 32 pw .. 32 pw + 31 (zeros past the nx rows that exist and
// from t_end on; `x` any valid address)
__device__ __forceinline__ void copy_x(uint32_t* x_words, const float* x_rows, const float* x,
                                       int nx, int Tn, int t0, int t_end, int pw, int lane) {
#pragma unroll 4
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = 32 * pw + j;
      const int f = lane + 32 * u;
      const bool ok = r < nx && t0 + f < t_end;
      cp_async4(x_words + x_word(r, f),
                reinterpret_cast<const uint32_t*>(ok ? x_rows + (size_t)r * Tn + t0 + f : x), ok);
    }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads32, 1)
asp_f32_kernel(const float* __restrict__ x, const float* __restrict__ a, int lda,
               const float* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ mask, float* __restrict__ mean_out,
               float* __restrict__ std_out, int C, int A, int Tn, float eps) {
  extern __shared__ __align__(128) float smem32[];
  __shared__ int last_s[kThreads32 / 32];
  float* w_s = smem32;                                  // 128 x 128 (w_word)
  float* b_s = w_s + kBlockChannels * kMaxAttention32;  // 2 stages of B: k steps x (big, small)
  float* x_s = b_s + 2 * kStage32;                      // 128 rows x 64 frames (x_word)
  unsigned* valid_s = reinterpret_cast<unsigned*>(x_s + kBlockChannels * kFrames);

  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kBlockChannels;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // W's tile by asynchronous copies from every thread, in flight while the
  // mask is read: 16 bytes a copy where A and W's start allow, else 4; rows
  // past C and k past A zero
  {
    const int nw = min(kBlockChannels, C - c0);
    uint32_t* w_words = reinterpret_cast<uint32_t*>(w_s);
    if ((A & 3) == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
      for (int i = tid; i < kBlockChannels * kMaxAttention32 / 4; i += kThreads32) {
        const int r = i / (kMaxAttention32 / 4);
        const int k = 4 * (i % (kMaxAttention32 / 4));
        const bool ok = r < nw && k < A;
        cp_async16(w_words + w_word(r, k), w + (ok ? (size_t)(c0 + r) * A + k : 0), ok);
      }
    } else {
      const uint32_t* w_src = reinterpret_cast<const uint32_t*>(w);
      for (int i = tid; i < kBlockChannels * kMaxAttention32; i += kThreads32) {
        const int r = i / kMaxAttention32;
        const int k = i % kMaxAttention32;
        const bool ok = r < nw && k < A;
        cp_async4(w_words + w_word(r, k), w_src + (ok ? (size_t)(c0 + r) * A + k : 0), ok);
      }
    }
    cp_async_commit();
  }
  const int t_end = walk_end<kThreads32>(mask + (size_t)b * Tn, 0, Tn, valid_s, last_s);
  const int tiles = (t_end + kFrames - 1) / kFrames;
  cp_async_wait_all();
  __syncthreads();  // W landed

  if (warp >= 2 * 4) {
    // the producer warpgroup: a_tanh's tiles split into B's stages, x's rows
    // into x_s, one tile ahead of the consumers
    const int pw = warp - 8;
    const float* arow = a + (size_t)b * A * lda;
    const float* x_rows = x + ((size_t)b * C + c0) * Tn;
    uint32_t* x_words = reinterpret_cast<uint32_t*>(x_s);
    if (tiles > 0) {
      fill_b(b_s, arow, lda, A, 0, t_end, pw, lane);
      bar_arrive(kBarFull);
    }
    for (int t = 0; t < tiles; ++t) {
      const int t0 = t * kFrames;
      bar_sync(kBarXEmpty);  // the softmax of tile t - 1 is done with x_s
      copy_x(x_words, x_rows, x, C - c0, Tn, t0, t_end, pw, lane);
      if (t + 1 < tiles) {
        const int s = (t + 1) & 1;
        bar_sync(kBarEmpty + s);  // no wgmma reads the stage of tile t - 1
        fill_b(b_s + s * kStage32, arow, lda, A, t0 + kFrames, t_end, pw, lane);
        bar_arrive(kBarFull + s);
      }
      cp_async_wait_all();
      bar_arrive(kBarXFull);
    }
    return;
  }

  // the consumer warpgroups: warp w owns channels 16 w .. 16 w + 15
  const int g = lane >> 2;  // accumulator rows g and g + 8
  const int q = lane & 3;   // accumulator columns 2q, 2q + 1 of each 8-frame group
  float bias_l2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = c0 + 16 * warp + g + 8 * h;
    bias_l2[h] = c < C ? bias[c] * kLog2e : 0.0f;
  }
  if (tiles > 0) bar_arrive(kBarXEmpty);
  if (tiles > 1) bar_arrive(kBarEmpty + 1);

  float run_max[2] = {-INFINITY, -INFINITY};
  float den[2] = {0.0f, 0.0f}, s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
  float acc[32], dd[2][32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dd[0][e] = dd[1][e] = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    const int t0 = t * kFrames;
    const float* stage = b_s + (t & 1) * kStage32;
    bar_sync(kBarFull + (t & 1));
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
    if (t + 2 < tiles) bar_arrive(kBarEmpty + (t & 1));

    bar_sync(kBarXFull);
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
          const float2 xp = *reinterpret_cast<const float2*>(
              x_s + x_word(16 * warp + g + 8 * h, 8 * n + 2 * q));
          const float p0 = ex2(acc[4 * n + 2 * h] - run_max[h]);
          const float p1 = ex2(acc[4 * n + 2 * h + 1] - run_max[h]);
          den[h] += p0 + p1;
          s1[h] = fmaf(p1, xp.y, fmaf(p0, xp.x, s1[h]));
          s2[h] = fmaf(p1 * xp.y, xp.y, fmaf(p0 * xp.x, xp.x, s2[h]));
        }
    }
    if (t + 1 < tiles) bar_arrive(kBarXEmpty);
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
  return sizeof(float) * ((size_t)kBlockChannels * (kMaxAttention32 + kFrames) + 2 * kStage32 +
                          (size_t)valid_words<kThreads32>(Tn));
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
  asp_f32_kernel<<<grid, kThreads32, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, lda, (const float*)w, (const float*)bias,
      (const float*)mask, (float*)mean, (float*)std_out, C, A, Tn, eps);
  return (int)cudaGetLastError();
}

// How many blocks of the float32 kernel fit one SM at T frames (any A).
extern "C" int asp_f32_blocks_per_sm(int Tn, int* blocks) {
  size_t smem;
  cudaError_t err = f32_prepare(Tn, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, asp_f32_kernel,
                                                             kThreads32, smem);
}
