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
// the A -> C score product over those frames (at most 12.6 GFLOP) would take
// less than half as long on the bf16 tensor cores. This version reads every
// frame: skipping the tiles past a row's length did not pay (the full-length
// rows set the grid's time, and the extra registers cost occupancy).
//
// Design: one block per (row, kChannels channels), one thread per channel.
// The block walks T in tiles of kTile frames: it stages a_tanh[b, :, tile]
// (A x kTile) and x[b, c-block, tile] in shared memory with coalesced loads
// (the x tile padded by one column so each thread's row reads are
// conflict-free), computes its channel's kTile scores with float32 FMAs
// (W read transposed, (A, C), so a warp's weight loads coalesce), and folds
// the tile into a running max, denominator, sum p*x and sum p*x^2 (the
// online softmax), so x is read exactly once. Any C works: the channel edge
// is masked. The score product runs on the FMA units, not the tensor cores,
// so this first version sits well above the byte bound; a later version
// moves it to wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChannels = 128;  // channels per block == threads per block
constexpr int kTile = 32;       // frames per tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T>
int launch(const void* x, const void* a, const void* wt, const void* bias,
           const void* mask, void* mean, void* std_out, int batch, int C, int A,
           int Tn, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)(A * kTile + kChannels * (kTile + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        asp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((C + kChannels - 1) / kChannels, batch);
  asp_kernel<T><<<grid, kChannels, smem, stream>>>(
      (const T*)x, (const T*)a, (const T*)wt, (const float*)bias,
      (const float*)mask, (T*)mean, (T*)std_out, C, A, Tn, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* asp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (B, C, T), a_tanh (B, A, T), wt (A, C), all of one type (is_bf16: bfloat16,
// else float32); bias (C,) f32, mask (B, T) f32 -> mean, std (B, C) in x's type.
extern "C" int asp_pool_launch(int is_bf16, const void* x, const void* a,
                               const void* wt, const void* bias,
                               const void* mask, void* mean, void* std_out,
                               int batch, int C, int A, int Tn, float eps,
                               void* stream) {
  if (is_bf16)
    return launch<__nv_bfloat16>(x, a, wt, bias, mask, mean, std_out, batch, C,
                                 A, Tn, eps, (cudaStream_t)stream);
  return launch<float>(x, a, wt, bias, mask, mean, std_out, batch, C, A, Tn,
                       eps, (cudaStream_t)stream);
}
