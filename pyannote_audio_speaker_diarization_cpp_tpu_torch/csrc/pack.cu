// Masked left-pack of speech samples, one (chunk, local speaker) row at a time.
//
// Replaces the TPU kernel pack_frames_pallas / _pack_kernel
// (pyannote_audio_speaker_diarization_cpp_tpu/ops/pack_pallas.py).
//
// What it computes: sample j of an n-sample window belongs to frame
// floor(j * F / n), so frame f owns the samples [ceil(f n / F), ceil((f+1) n / F)).
// The samples of the kept frames move, in time order, to the front of the
// output row; the rest of the row is zero. lens[row] is the packed length.
//
// Bound on the H100: bytes. Each output row is written once (4 * n bytes)
// and only its kept samples are read (4 * lens bytes), with no arithmetic to
// speak of, so the floor is that traffic over the memory rate: at most
// 20.5 MB for a 32 x 80000 batch, less as fewer frames are kept.
//
// Design. The grid is (output tiles of kTile samples, rows), one wave on the
// card: a 32 x 80000 batch is 640 blocks of 256 threads, at most 5 on an SM
// of the 8 that fit. That size was measured (scripts/pack_ablation.py): 2 or
// 8 quads a thread, and 128 or 512 threads a block, were each slower at the
// main path's shapes. Each block first builds its row's SEGMENT table in
// shared memory: the maximal runs of consecutive kept frames, each one
// contiguous copy (adjacent kept frames are adjacent in the source and in the
// packed row, as in the TPU kernel). All threads load the keep flags at once,
// up to kMaxPer consecutive frames each, and compute their frames' starts in
// 32-bit integers (the wrapper rejects F * n >= 2^31, so f * n + F - 1 fits
// in 32 unsigned bits); one block-wide scan (a shuffle scan in each warp,
// then the warp totals through shared memory) counts the segments and kept
// samples before each thread's frames, and each thread writes the segments
// that start in its frames: packed start and source-minus-packed offset.
// Segment s covers the packed samples [dst[s], dst[s + 1]), dst[nseg] = lens.
// Rebuilding the table in every block costs one L2 read of F bytes and a
// scan: a thread-block cluster sharing one table would keep the same
// dependent chain (flags, scan, table) in front of every block's copy and add
// a cluster barrier (scripts/pack_ablation.py times the table alone).
//
// The copy then writes the tile in aligned 16-byte quads, kSteps a thread,
// consecutive threads on consecutive quads. A quad finds its segment by a
// binary search over the table (from the thread's previous segment). A quad
// wholly inside one segment reads its four source samples, which start at an
// arbitrary offset modulo 4, by four 4-byte loads (a warp's loads cover one
// contiguous span, so they coalesce); all of a thread's loads are issued
// before its first store. Two aligned float4 loads and a select on the
// offset, the TPU kernel's aligned-window-and-rotate, measured slower: the
// select's instructions cost more than the loads they save (the ablation).
// A quad that straddles a segment's end (at most one per segment) gathers
// element by element; a quad past lens stores zeros and reads nothing, so a
// tile wholly past lens only writes zeros. Rows whose output starts are not
// 16-byte aligned (n % 4 != 0) take the same kernel with one sample a step.
// Integer math only: bit-exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFrames = 1024;                  // widest keep mask the table holds
constexpr int kMaxPer = kMaxFrames / kThreads;    // frames a thread scans
constexpr int kMaxSegments = (kMaxFrames + 1) / 2;
constexpr int kQuadsPerThread = 4;
constexpr int kTile = kThreads * kQuadsPerThread * 4;  // output samples a block

struct Table {
  int dst[kMaxSegments + 1];   // packed start of each segment; dst[nseg] = lens
  int delta[kMaxSegments];     // its source start minus its packed start
  int warp_segments[kWarps];
  int warp_kept[kWarps];
};

__device__ __forceinline__ int frame_start(unsigned f, unsigned n, unsigned F) {
  return (int)((f * n + F - 1) / F);  // ceil(f * n / F), in 32 bits
}

// The row's segment table in t; returns (segments, kept samples) to every
// thread. Ends with the barrier that publishes the table.
__device__ __forceinline__ int2 build_table(const uint8_t* __restrict__ krow, int n,
                                            int F, Table& t) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (F + kThreads - 1) / kThreads;
  const int f0 = min(tid * per, F);
  const int f1 = min(f0 + per, F);
  bool kept_flag[kMaxPer];
  int start[kMaxPer + 1];
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) kept_flag[i] = f0 + i < f1 && krow[f0 + i] != 0;
  const bool before = f0 > 0 && f0 < F && krow[f0 - 1] != 0;
#pragma unroll
  for (int i = 0; i <= kMaxPer; ++i) start[i] = i <= per ? frame_start(min(f0 + i, f1), n, F) : 0;

  int segments = 0, kept = 0;
  bool prev = before;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    if (kept_flag[i]) {
      kept += start[i + 1] - start[i];
      segments += !prev;
    }
    prev = kept_flag[i];
  }
  int seg_incl = segments, kept_incl = kept;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, seg_incl, d);
    const int b = __shfl_up_sync(0xffffffffu, kept_incl, d);
    if (lane >= d) {
      seg_incl += a;
      kept_incl += b;
    }
  }
  if (lane == 31) {
    t.warp_segments[warp] = seg_incl;
    t.warp_kept[warp] = kept_incl;
  }
  __syncthreads();
  int s = seg_incl - segments, pos = kept_incl - kept, nseg = 0, len = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int ws = t.warp_segments[w], wk = t.warp_kept[w];
    if (w < warp) {
      s += ws;
      pos += wk;
    }
    nseg += ws;
    len += wk;
  }
  prev = before;
#pragma unroll
  for (int i = 0; i < kMaxPer; ++i) {
    if (kept_flag[i]) {
      if (!prev) {
        t.dst[s] = pos;
        t.delta[s] = start[i] - pos;
        ++s;
      }
      pos += start[i + 1] - start[i];
    }
    prev = kept_flag[i];
  }
  if (tid == 0) t.dst[nseg] = len;
  __syncthreads();
  return make_int2(nseg, len);
}

// largest s' in [s, nseg) with dst[s'] <= j (j < lens)
__device__ __forceinline__ int find_segment(const Table& t, int s, int nseg, int j) {
  int hi = nseg - 1;
  while (s < hi) {
    const int mid = (s + hi + 1) >> 1;
    if (t.dst[mid] <= j) s = mid; else hi = mid - 1;
  }
  return s;
}

// sample j of the packed row (j < lens), s its segment or an earlier one
__device__ __forceinline__ float packed_sample(const float* __restrict__ wrow, const Table& t,
                                               int& s, int j) {
  while (t.dst[s + 1] <= j) ++s;
  return __ldg(wrow + j + t.delta[s]);
}

template <bool kVec>
__device__ __forceinline__ void copy_tile(const float* __restrict__ wrow, float* __restrict__ orow,
                                          int n, int nseg, int len, const Table& t) {
  constexpr int kUnit = kVec ? 4 : 1;
  constexpr int kSteps = kTile / (kThreads * kUnit);
  const int j0 = blockIdx.x * kTile;
  const int j1 = min(j0 + kTile, n);
  int s = 0;
  if constexpr (!kVec) {
    float v[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int j = j0 + k * kThreads + threadIdx.x;
      v[k] = 0.0f;
      if (j < j1 && j < len) {
        s = find_segment(t, s, nseg, j);
        v[k] = __ldg(wrow + j + t.delta[s]);
      }
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int j = j0 + k * kThreads + threadIdx.x;
      if (j < j1) orow[j] = v[k];
    }
  } else {
    // a quad wholly inside one segment: four 4-byte loads from its source,
    // at any offset modulo 4, then one aligned 16-byte store
    float4 v[kSteps];
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int j = j0 + 4 * (k * kThreads + threadIdx.x);
      v[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < j1 && j < len) {
        s = find_segment(t, s, nseg, j);
        if (j + 4 <= t.dst[s + 1]) {
          const float* src = wrow + j + t.delta[s];
          v[k] = make_float4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
        } else {  // the quad crosses the segment's end (and maybe lens)
          float e[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) e[i] = j + i < len ? packed_sample(wrow, t, s, j + i) : 0.0f;
          v[k] = make_float4(e[0], e[1], e[2], e[3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kSteps; ++k) {
      const int j = j0 + 4 * (k * kThreads + threadIdx.x);
      if (j < j1) *reinterpret_cast<float4*>(orow + j) = v[k];
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ wav, const uint8_t* __restrict__ keep,
            float* __restrict__ out, int* __restrict__ lens, int n, int F) {
  __shared__ Table tab;
  const int row = blockIdx.y;
  const int2 table = build_table(keep + (size_t)row * F, n, F, tab);
  if (blockIdx.x == 0 && threadIdx.x == 0) lens[row] = table.y;
  copy_tile<kVec>(wav + (size_t)row * n, out + (size_t)row * n, n, table.x, table.y, tab);
}

}  // namespace

extern "C" int pack_max_frames() { return kMaxFrames; }

extern "C" const char* pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// wav (B, n) float32, keep (B, F) uint8 0/1 -> out (B, n) float32, lens (B,) int32.
// vec: n % 4 == 0, so that every output row starts on 16 bytes.
extern "C" int pack_frames_launch(const void* wav, const void* keep, void* out,
                                  void* lens, int batch, int n, int F, int vec,
                                  void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, batch);
  const auto kernel = vec ? pack_kernel<true> : pack_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)wav, (const uint8_t*)keep, (float*)out, (int*)lens, n, F);
  return (int)cudaGetLastError();
}
