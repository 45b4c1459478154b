// The float32 ASP kernel of the port's first slice, kept as the ablation's
// baseline (scripts/asp_cuda_ablation.py builds and times it beside
// csrc/asp.cu's asp_f32_kernel, and chip_smoke.py's float32_requests phase
// times it on a request's own ASP inputs). Nothing in the package loads it.
//
// One block per (row, 128 channels), one thread per channel. The block walks
// T in tiles of kTile frames: it stages a_tanh[b, :, tile] (A x kTile) and
// x[b, c-block, tile] in shared memory with coalesced loads (the x tile
// padded by one column so each thread's row reads are conflict-free),
// computes its channel's kTile scores with float32 FMAs (W read transposed,
// (A, C), so a warp's weight loads coalesce), and folds the tile into a
// running max, denominator, sum p*x and sum p*x^2, so x is read exactly
// once. Its products stay float32-exact, off the tensor cores.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChannels = 128;  // channels per block == threads per block
constexpr int kTile = 32;       // frames per tile

__global__ void __launch_bounds__(kChannels)
asp_fma_kernel(const float* __restrict__ x, const float* __restrict__ a,
               const float* __restrict__ wt, const float* __restrict__ bias,
               const float* __restrict__ mask, float* __restrict__ mean_out,
               float* __restrict__ std_out, int C, int A, int Tn, float eps) {
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
      a_s[idx] = tt < tn ? a[((size_t)b * A + aa) * Tn + t0 + tt] : 0.0f;
    }
    for (int idx = tid; idx < kChannels * kTile; idx += kChannels) {
      const int cc = idx / kTile;
      const int tt = idx - cc * kTile;
      const int ch = c0 + cc;
      x_s[cc * (kTile + 1) + tt] =
          (tt < tn && ch < C) ? x[((size_t)b * C + ch) * Tn + t0 + tt] : 0.0f;
    }
    if (tid < kTile) m_s[tid] = tid < tn ? mask[(size_t)b * Tn + t0 + tid] : 0.0f;
    __syncthreads();

    float s[kTile];
#pragma unroll
    for (int tt = 0; tt < kTile; ++tt) s[tt] = bias_c;
    if (active) {
      for (int aa = 0; aa < A; ++aa) {
        const float w = wt[(size_t)aa * C + c];
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
    mean_out[(size_t)b * C + c] = mean;
    std_out[(size_t)b * C + c] = sqrtf(fmaxf(var, eps));
  }
}

}  // namespace

// x (B, C, T), a_tanh (B, A, T) contiguous, wt (A, C) float32; bias (C,),
// mask (B, T) float32 -> mean, std (B, C) float32.
extern "C" int asp_fma_launch(const void* x, const void* a, const void* wt, const void* bias,
                              const void* mask, void* mean, void* std_out, int batch, int C,
                              int A, int Tn, float eps, void* stream) {
  const size_t smem = (size_t)(A * kTile + kChannels * (kTile + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        asp_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((C + kChannels - 1) / kChannels, batch);
  asp_fma_kernel<<<grid, kChannels, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)a, (const float*)wt, (const float*)bias,
      (const float*)mask, (float*)mean, (float*)std_out, C, A, Tn, eps);
  return (int)cudaGetLastError();
}
