// Fused waveform -> log-(mel-)spectrogram kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel preset_gen_vae_tpu/ops/pallas_mel.py:_pallas_logmel
// (body at :82-103). Same function: zero center padding by n_fft/2, frames of
// n_fft samples every hop samples, a windowed real DFT as two products with
// the (n_fft, n_bins) cos / -sin matrices (Hann window and 1/max|rFFT(w)|
// folded in), magnitude, the mel product with the (n_bins, n_mels)
// filterbank (skipped when no filterbank is given: linear bins), then
// 20*log10(max(., floor)). Output (B, n_out, T) f32, written directly.
//
// Precision: EXACT multiplies and accumulates in IEEE f32 FFMA (TF32 would
// not hold 0.05 dB near the -120 dB floor). FAST rounds every product input
// (samples, DFT matrices, magnitudes, filterbank) to bf16 and accumulates in
// f32, the semantics of the Pallas kernel's bf16 mode; it still runs on the
// f32 units.
//
// Bound: the function itself is bound by its bytes. One 4 s waveform
// (88,576 samples, 347 frames) moves 0.71 MB (samples in, 257 x 347 dB
// out), 0.21 us at 3.35 TB/s, while its least work, a real FFT, the
// magnitude and the mel product over the filterbank's ~1,000 nonzeros, is
// about 10 MFLOP, 0.15 us at 67 TFLOP/s in f32. This design instead does
// the DFT as dense products, as the Pallas kernel does: 2*347*1024*513*2 +
// 2*347*513*257 = 0.82 GFLOP per waveform, about 80x the FFT-level work,
// and on that work EXACT is compute-bound on f32 FFMA (about 1,200 FLOP per
// byte, far above the card's f32 ridge of 20 FLOP per byte). An FFT-based
// kernel is the way to the function's bound.
//
// Design against its own work: one block computes TT=32 frames of one
// waveform. The overlapping frames are read straight from one shared-memory
// copy of the waveform span they cover (padding by index masks; no framed
// tensor and no shifted copies exist). The DFT runs as a register-tiled
// SGEMM: each thread keeps 2 frames x 8 bins of re and im (32 accumulators),
// 128 bins per pass, with 16-row stages of the DFT matrices staged through
// shared memory and read as float4. The magnitude tile of all n_bins bins
// stays in shared memory; the mel product, the floor and the log run as the
// epilogue, so only the waveform is read and only the result is written.
// The Nyquist bin (bins beyond the last whole 128-bin pass) is a small
// split-and-reduce pass. Not yet used: tensor cores (3xTF32 on wgmma would
// keep f32 accuracy), TMA, double buffering.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TT = 32;       // frames per block
constexpr int KB = 128;      // DFT bins per register-tiled pass
constexpr int NK = 16;       // DFT matrix rows per shared-memory stage
constexpr int THREADS = 256;
constexpr int PARTS = THREADS / TT;  // n-splits of the leftover-bin pass

__device__ __forceinline__ float to_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool FAST>
__device__ __forceinline__ float rnd(float v) {
  return FAST ? to_bf16(v) : v;
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS)
logmel_kernel(const float* __restrict__ x, int S,
              const float* __restrict__ cos_m, const float* __restrict__ sin_m,
              const float* __restrict__ fb, int n_mels,
              float* __restrict__ out, int n_fft, int hop, int T,
              float floor_amp) {
  extern __shared__ __align__(16) float smem[];
  const int n_bins = n_fft / 2 + 1;
  const int span = (TT - 1) * hop + n_fft;
  float* wav = smem;                 // [span]
  float* mag = wav + span;           // [n_bins][TT]
  float* ctile = mag + n_bins * TT;  // [NK][KB]
  float* stile = ctile + NK * KB;    // [NK][KB]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int tid = threadIdx.x;

  // ---- 1. the waveform span of this block's frames, zero center padding
  const long long first = (long long)t0 * hop - n_fft / 2;
  const float* xb = x + (long long)b * S;
  for (int i = tid; i < span; i += THREADS) {
    const long long s = first + i;
    wav[i] = rnd<FAST>((s >= 0 && s < S) ? xb[s] : 0.f);
  }

  // ---- 2. windowed DFT, 128 bins per pass, 2 frames x 8 bins per thread
  const int tx = tid % 16;  // bins 4tx..4tx+3 and 64+4tx..64+4tx+3
  const int ty = tid / 16;  // frames ty and ty+16
  const int k_full = ((n_bins - 1) / KB) * KB;
  for (int kb = 0; kb < k_full; kb += KB) {
    float re[2][8], im[2][8];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 8; ++j) re[f][j] = im[f][j] = 0.f;

    for (int n0 = 0; n0 < n_fft; n0 += NK) {
      __syncthreads();  // the previous stage is consumed; wav is loaded
      for (int i = tid; i < NK * KB; i += THREADS) {
        const int r = i / KB, c = i % KB;
        const long long g = (long long)(n0 + r) * n_bins + kb + c;
        ctile[i] = rnd<FAST>(cos_m[g]);
        stile[i] = rnd<FAST>(sin_m[g]);
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < NK; ++r) {
        const float a[2] = {wav[ty * hop + n0 + r], wav[(ty + 16) * hop + n0 + r]};
        const float4 c0 = *reinterpret_cast<const float4*>(&ctile[r * KB + 4 * tx]);
        const float4 c1 = *reinterpret_cast<const float4*>(&ctile[r * KB + 64 + 4 * tx]);
        const float4 s0 = *reinterpret_cast<const float4*>(&stile[r * KB + 4 * tx]);
        const float4 s1 = *reinterpret_cast<const float4*>(&stile[r * KB + 64 + 4 * tx]);
        const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
        const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            re[f][j] = fmaf(a[f], c[j], re[f][j]);
            im[f][j] = fmaf(a[f], s[j], im[f][j]);
          }
      }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = kb + (j < 4 ? 4 * tx + j : 64 + 4 * tx + (j - 4));
        const float m = sqrtf(re[f][j] * re[f][j] + im[f][j] * im[f][j]);
        mag[k * TT + ty + 16 * f] = rnd<FAST>(m);
      }
  }

  // ---- 2b. leftover bins (the Nyquist bin for n_fft % 256 == 0): each
  // thread sums a slice of n for one frame, then a fixed-order reduction
  float* part_re = ctile;           // [PARTS][TT]
  float* part_im = ctile + PARTS * TT;
  for (int k = k_full; k < n_bins; ++k) {
    __syncthreads();
    const int t = tid % TT, p = tid / TT;
    const int n_lo = p * n_fft / PARTS, n_hi = (p + 1) * n_fft / PARTS;
    float r = 0.f, i = 0.f;
    for (int n = n_lo; n < n_hi; ++n) {
      const float a = wav[t * hop + n];
      r = fmaf(a, rnd<FAST>(cos_m[(long long)n * n_bins + k]), r);
      i = fmaf(a, rnd<FAST>(sin_m[(long long)n * n_bins + k]), i);
    }
    part_re[p * TT + t] = r;
    part_im[p * TT + t] = i;
    __syncthreads();
    if (tid < TT) {
      float rs = 0.f, is = 0.f;
      for (int q = 0; q < PARTS; ++q) {
        rs += part_re[q * TT + tid];
        is += part_im[q * TT + tid];
      }
      mag[k * TT + tid] = rnd<FAST>(sqrtf(rs * rs + is * is));
    }
  }
  __syncthreads();

  // ---- 3. epilogue: mel product, floor, log; out is (B, n_out, T)
  if (fb != nullptr) {
    for (int item = tid; item < n_mels * (TT / 8); item += THREADS) {
      const int m = item % n_mels, tg = item / n_mels;  // m fastest: coalesced fb
      float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int k = 0; k < n_bins; ++k) {
        const float w = rnd<FAST>(fb[(long long)k * n_mels + m]);
        const float4 g0 = *reinterpret_cast<const float4*>(&mag[k * TT + tg * 8]);
        const float4 g1 = *reinterpret_cast<const float4*>(&mag[k * TT + tg * 8 + 4]);
        acc[0] = fmaf(g0.x, w, acc[0]);
        acc[1] = fmaf(g0.y, w, acc[1]);
        acc[2] = fmaf(g0.z, w, acc[2]);
        acc[3] = fmaf(g0.w, w, acc[3]);
        acc[4] = fmaf(g1.x, w, acc[4]);
        acc[5] = fmaf(g1.y, w, acc[5]);
        acc[6] = fmaf(g1.z, w, acc[6]);
        acc[7] = fmaf(g1.w, w, acc[7]);
      }
      float* o = out + ((long long)b * n_mels + m) * T;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + tg * 8 + j;
        if (t < T) o[t] = 20.f * log10f(fmaxf(acc[j], floor_amp));
      }
    }
  } else {
    for (int i = tid; i < n_bins * TT; i += THREADS) {
      const int k = i / TT, t = t0 + i % TT;
      if (t < T) out[((long long)b * n_bins + k) * T + t] = 20.f * log10f(fmaxf(mag[i], floor_amp));
    }
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
size_t logmel_smem_bytes(int n_fft, int hop) {
  const int n_bins = n_fft / 2 + 1;
  return sizeof(float) * ((size_t)(TT - 1) * hop + n_fft + (size_t)n_bins * TT + 2 * NK * KB);
}

// x: (B, S) f32; cos_m, sin_m: (n_fft, n_fft/2+1) f32; fb: (n_fft/2+1,
// n_mels) f32 or null for linear bins; out: (B, n_mels or n_fft/2+1, T) f32
// with T = 1 + S / hop. All contiguous, on the current device. Returns the
// cudaError_t of the launch (0 on success); launches on `stream`, does not
// synchronize.
int logmel_launch(const float* x, int B, int S, const float* cos_m,
                  const float* sin_m, const float* fb, int n_mels, float* out,
                  int n_fft, int hop, int T, float floor_amp, int fast,
                  void* stream) {
  if (B <= 0 || S <= 0 || hop <= 0 || hop % 4 != 0 || n_fft < 256 ||
      n_fft % 256 != 0 || T != 1 + S / hop || (fb != nullptr && n_mels <= 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = logmel_smem_bytes(n_fft, hop);
  const void* kern = fast ? (const void*)logmel_kernel<true> : (const void*)logmel_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TT - 1) / TT, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast)
    logmel_kernel<true><<<grid, THREADS, smem, s>>>(x, S, cos_m, sin_m, fb, n_mels, out, n_fft, hop, T, floor_amp);
  else
    logmel_kernel<false><<<grid, THREADS, smem, s>>>(x, S, cos_m, sin_m, fb, n_mels, out, n_fft, hop, T, floor_amp);
  return (int)cudaGetLastError();
}

}  // extern "C"
