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
// Design: the TPU kernel moved 128-lane-aligned windows with a lane rotate,
// because Mosaic only slices VMEM at aligned offsets. Nothing like that is
// needed here. The grid is (output tiles, rows) so that a 32-row batch still
// fills the card. Every block rebuilds its row's frame table in shared memory
// (one warp scans the F keep flags: per-lane partial sums, then a shuffle
// scan), then each thread finds the kept frame of its output sample by a
// binary search over the table and copies one float. Consecutive threads
// write consecutive outputs and read consecutive inputs within a frame run,
// so loads and stores coalesce. Integer math only: bit-exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;        // output samples per block
constexpr int kMaxFrames = 1024;   // widest keep mask the shared tables hold

__device__ __forceinline__ int frame_start(int f, int n, int F) {
  return (int)(((long long)f * n + F - 1) / F);  // ceil(f * n / F)
}

__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* __restrict__ wav, const uint8_t* __restrict__ keep,
            float* __restrict__ out, int* __restrict__ lens, int n, int F) {
  __shared__ int kstart[kMaxFrames];  // packed start of the k-th kept frame
  __shared__ int koff[kMaxFrames];    // its source start minus packed start
  __shared__ int s_nkept;
  __shared__ int s_len;
  const int row = blockIdx.y;
  const uint8_t* krow = keep + (size_t)row * F;

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (F + 31) / 32;
    const int f0 = min(lane * per, F);
    const int f1 = min(f0 + per, F);
    int len_sum = 0, cnt = 0;
    for (int f = f0; f < f1; ++f) {
      if (krow[f]) {
        len_sum += frame_start(f + 1, n, F) - frame_start(f, n, F);
        ++cnt;
      }
    }
    int len_incl = len_sum, cnt_incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int a = __shfl_up_sync(0xffffffffu, len_incl, d);
      const int b = __shfl_up_sync(0xffffffffu, cnt_incl, d);
      if (lane >= d) {
        len_incl += a;
        cnt_incl += b;
      }
    }
    int pos = len_incl - len_sum;
    int k = cnt_incl - cnt;
    for (int f = f0; f < f1; ++f) {
      if (krow[f]) {
        const int st = frame_start(f, n, F);
        kstart[k] = pos;
        koff[k] = st - pos;
        pos += frame_start(f + 1, n, F) - st;
        ++k;
      }
    }
    if (lane == 31) {
      s_nkept = cnt_incl;
      s_len = len_incl;
    }
  }
  __syncthreads();

  const int nkept = s_nkept;
  const int len = s_len;
  if (blockIdx.x == 0 && threadIdx.x == 0) lens[row] = len;
  const float* wrow = wav + (size_t)row * n;
  float* orow = out + (size_t)row * n;
  const int j0 = blockIdx.x * kTile;
  const int j1 = min(j0 + kTile, n);
  for (int j = j0 + threadIdx.x; j < j1; j += kThreads) {
    float v = 0.0f;
    if (j < len) {
      int lo = 0, hi = nkept - 1;  // largest k with kstart[k] <= j
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (kstart[mid] <= j) lo = mid; else hi = mid - 1;
      }
      v = wrow[j + koff[lo]];
    }
    orow[j] = v;
  }
}

}  // namespace

extern "C" int pack_max_frames() { return kMaxFrames; }

extern "C" const char* pack_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// wav (B, n) float32, keep (B, F) uint8 0/1 -> out (B, n) float32, lens (B,) int32.
extern "C" int pack_frames_launch(const void* wav, const void* keep, void* out,
                                  void* lens, int batch, int n, int F,
                                  void* stream) {
  const dim3 grid((n + kTile - 1) / kTile, batch);
  pack_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)wav, (const uint8_t*)keep, (float*)out, (int*)lens, n, F);
  return (int)cudaGetLastError();
}
