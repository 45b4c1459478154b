// Log-mel spectrogram: centered STFT -> power -> mel projection -> dB, fused.
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
// Bound on the H100: operations. 32 x 501 frames x (400 x 402 + 201 x 80)
// multiply-adds is ~5.7 GFLOP per 32-row batch, in full float32 (the TPU
// kernel ran its products at HIGHEST precision, so neither TF32 nor bf16 is
// allowed here); the bytes (32 x 80000 x 4 in, 32 x 501 x 80 x 4 out) are
// small. The float32 rate outside the tensor cores sets the floor.
//
// Design: one block per (row, tile of kFrames frames). The block stages the
// tile's samples in shared memory once; each thread owns one DFT column and
// keeps kFrames accumulators in registers, reading the basis column through
// L1/L2 (643 KB, shared by every block) and the samples as 16-byte
// broadcast loads. The spectrum is reduced to power in shared memory and
// projected onto the mel bands there, so neither the spectrum nor the power
// ever reaches device memory. Simple FMA loops: a later version may split
// each float32 product into three TF32 products on the tensor cores
// (the 3xTF32 trick), which keeps float32 accuracy at a higher rate.

#include <cuda_runtime.h>

namespace {

constexpr int kFrames = 16;  // STFT frames per block

__global__ void log_mel_kernel(const float* __restrict__ x,
                               const float* __restrict__ basis,
                               const float* __restrict__ mel,
                               float* __restrict__ out, int n, int frames,
                               int hop, int win, int pad, int nf, int n_mels,
                               int seg_alloc, float amin, float mult,
                               float db_off) {
  extern __shared__ __align__(16) float smem[];
  const int seg_len = (kFrames - 1) * hop + win;
  float* seg = smem;               // seg_alloc floats: the tile's samples
  float* spec = smem + seg_alloc;  // kFrames x (2 nf): spectrum, then power
  const int ncol = 2 * nf;
  const int row = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const float* xr = x + (size_t)row * n;

  for (int s = threadIdx.x; s < seg_len; s += blockDim.x) {
    const int t = f0 * hop + s - pad;
    seg[s] = (t >= 0 && t < n) ? xr[t] : 0.0f;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < ncol) {
    float acc[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) acc[f] = 0.0f;
    for (int i = 0; i < win; i += 4) {
      const float b0 = __ldg(basis + (size_t)(i + 0) * ncol + k);
      const float b1 = __ldg(basis + (size_t)(i + 1) * ncol + k);
      const float b2 = __ldg(basis + (size_t)(i + 2) * ncol + k);
      const float b3 = __ldg(basis + (size_t)(i + 3) * ncol + k);
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float4 s = *reinterpret_cast<const float4*>(seg + f * hop + i);
        acc[f] = fmaf(s.x, b0, acc[f]);
        acc[f] = fmaf(s.y, b1, acc[f]);
        acc[f] = fmaf(s.z, b2, acc[f]);
        acc[f] = fmaf(s.w, b3, acc[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f) spec[f * ncol + k] = acc[f];
  }
  __syncthreads();

  // power in place of the real part: each (f, q) is read and written by one
  // thread, and the imaginary slots are only read
  for (int idx = threadIdx.x; idx < kFrames * nf; idx += blockDim.x) {
    const int f = idx / nf;
    const int q = idx - f * nf;
    const float re = spec[f * ncol + q];
    const float im = spec[f * ncol + nf + q];
    spec[f * ncol + q] = re * re + im * im;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < kFrames * n_mels; idx += blockDim.x) {
    const int f = idx / n_mels;
    const int m = idx - f * n_mels;
    if (f0 + f >= frames) continue;
    const float* pw = spec + f * ncol;
    float fb = 0.0f;
    for (int q = 0; q < nf; ++q) fb = fmaf(pw[q], __ldg(mel + (size_t)q * n_mels + m), fb);
    out[((size_t)row * frames + f0 + f) * n_mels + m] =
        mult * log10f(fmaxf(fb, amin)) - db_off;
  }
}

}  // namespace

extern "C" const char* frontend_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x (B, n) f32, basis (win, 2 nf) f32, mel (nf, n_mels) f32 -> out (B, frames, n_mels) f32.
// hop and win must be multiples of 4 (16-byte sample loads).
extern "C" int log_mel_launch(const void* x, const void* basis, const void* mel,
                              void* out, int batch, int n, int frames, int hop,
                              int win, int pad, int nf, int n_mels, float amin,
                              float mult, float db_off, int threads,
                              void* stream) {
  const int seg_alloc = (((kFrames - 1) * hop + win) + 3) / 4 * 4;
  const size_t smem = (size_t)(seg_alloc + kFrames * 2 * nf) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((frames + kFrames - 1) / kFrames, batch);
  log_mel_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)basis, (const float*)mel, (float*)out, n,
      frames, hop, win, pad, nf, n_mels, seg_alloc, amin, mult, db_off);
  return (int)cudaGetLastError();
}
