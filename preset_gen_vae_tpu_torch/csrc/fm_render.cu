// F1 and F2: the DX7 FM render of preset_gen_vae_tpu_torch/synth/fm_torch.py
// on Hopper (sm_90a), built with nvcc at first use and bound with ctypes.
//
// No TPU kernel stands behind either: the JAX package leaves these scans to
// XLA (preset_gen_vae_tpu/synth/fm_jax.py). F1 is the control-rate scan
// (fm_jax.py:299-339) with the per-tick phase starts (:389-394); F2 is the
// per-sample 'exact' scan (:489-516) with the amplitude interpolation
// (:370-379), the per-sample phases (:395-397) and the fade, volume and
// clip (:400-413).
//
// What bounds them: F2's sample n+1 needs the feedback loop's output at
// samples n and n-1. Only that loop (the operators from the feedback
// destination down to its source, one to three; none at feedback 0) is
// serial in the work; the other operators depend on no earlier sample.
// This design runs all six operators of an item's samples one after
// another in one thread, one thread per item, so with fewer than a few
// thousand items the card is far from full and the time is one thread's:
// samples x the latency of six dependent sines. With many items the bound
// is the f32 arithmetic (~200 operations per item and sample). It keeps
// everything of an item in registers (the feedback history, the previous
// tick's amplitudes, the algorithm's bitmasks from constant memory), reads
// F1's (T, B, 6) arrays so that a warp's 32 items touch 768 contiguous
// bytes a tick, and writes four samples at a time as one 16-byte store.
//
// Numerics follow the plain version op for op: the build passes
// -fmad=false (no multiply-add contraction) and no --use_fast_math, so
// sinf, expf and exp2f are the accurate library functions and every
// product and sum rounds where the torch ops round.

#include <cuda_runtime.h>
#include <stdint.h>

#define N_OPS 6
#define BLOCK 32
#define THREADS 32  // one warp per block, so that few items still spread over many SMs

// the packed control row, fm_torch.CTL_FIELDS (the CPU tests hold the two equal)
#define CTL_OP_GAIN_DB 0
#define CTL_TARGETS 6
#define CTL_SLEWS 30
#define CTL_EG0 54
#define CTL_PEG_TARGETS 60
#define CTL_PEG_SLEWS 64
#define CTL_PEG0 68
#define CTL_LFO_HZ 69
#define CTL_LFO_PHASE0 70
#define CTL_LFO_DELAY_S 71
#define CTL_PMD 72
#define CTL_AMD 73
#define CTL_PMS 74
#define CTL_AMS_DB 75
#define CTL_ON 81
#define CTL_LFO_WAVE 87
#define CTL_FREQS 88
#define CTL_WIDTH 94

#define TWO_PI_F 6.2831855f       // float32(2 pi)
#define MOD_SCALE_F 0.63661975f   // float32(4 / (2 pi))
#define SH_SEED 0x12345678u

// per algorithm: the modulator bitmask of each operator, the carrier
// bitmask, the feedback source and destination (fm_torch.algorithm_rows)
__constant__ int c_alg[32][9];
static int h_alg[32][9];

__device__ __forceinline__ float pick4(const float* v, int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

// one EG control tick (fm_jax.py:238-249)
__device__ __forceinline__ void eg_tick(float& cur, int& stage, const float* targets,
                                        const float* slews, bool off) {
  if (off) stage = 3;
  const float target = pick4(targets, stage);
  const float slew = pick4(slews, stage);
  const float dlt = target - cur;
  const float step = dlt > 0.f ? 4.f * slew + 0.05f * dlt : slew;
  const bool reached = fabsf(dlt) <= step;
  const float sgn = dlt > 0.f ? 1.f : (dlt < 0.f ? -1.f : 0.f);
  cur = reached ? target : cur + sgn * step;
  if (reached && stage < 2) stage += 1;
}

// the LFO wave (fm_jax.py:222-230); anything but 0-4 is the S&H value
__device__ __forceinline__ float lfo_wave_value(int wave, float phase, float sh) {
  switch (wave) {
    case 0: return 4.f * (phase < 0.5f ? phase : 1.f - phase) - 1.f;
    case 1: return 1.f - 2.f * phase;
    case 2: return 2.f * phase - 1.f;
    case 3: return phase < 0.5f ? 1.f : -1.f;
    case 4: return sinf(TWO_PI_F * phase);
    default: return sh;
  }
}

// F1: one thread per item walks the T ticks: LFO (S&H LCG in uint32), the
// pitch EG and the six operator EGs, the AM term and amplitude floor, and
// the wrapped phase start of each operator. Writes amps, starts and incs as
// (T, B, 6) and pitch_fact as (T, B).
__global__ void __launch_bounds__(THREADS)
fm_control_kernel(const float* __restrict__ ctl, int B, int T, int note_off, float fs,
                  float tick_s, float ln10_over_20, float* __restrict__ amps,
                  float* __restrict__ pitch_fact, float* __restrict__ starts,
                  float* __restrict__ incs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* c = ctl + (size_t)b * CTL_WIDTH;
  float targets[N_OPS][4], slews[N_OPS][4], gain[N_OPS], ams[N_OPS], freq[N_OPS];
  float eg[N_OPS], phase[N_OPS];
  int stage[N_OPS];
  bool on[N_OPS];
#pragma unroll
  for (int i = 0; i < N_OPS; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      targets[i][k] = c[CTL_TARGETS + 4 * i + k];
      slews[i][k] = c[CTL_SLEWS + 4 * i + k];
    }
    gain[i] = c[CTL_OP_GAIN_DB + i];
    ams[i] = c[CTL_AMS_DB + i];
    freq[i] = c[CTL_FREQS + i];
    on[i] = c[CTL_ON + i] > 0.f;
    eg[i] = c[CTL_EG0 + i];
    stage[i] = 0;
    phase[i] = 0.f;
  }
  float peg_targets[4], peg_slews[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    peg_targets[k] = c[CTL_PEG_TARGETS + k];
    peg_slews[k] = c[CTL_PEG_SLEWS + k];
  }
  float peg = c[CTL_PEG0];
  int peg_stage = 0;
  const float lfo_hz = c[CTL_LFO_HZ], lfo_delay_s = c[CTL_LFO_DELAY_S];
  const float pmd = c[CTL_PMD], amd = c[CTL_AMD], pms = c[CTL_PMS];
  const int wave = (int)c[CTL_LFO_WAVE];
  float lfo_phase = c[CTL_LFO_PHASE0];
  uint32_t rng = SH_SEED;
  float sh = 0.f;

  for (int t = 0; t < T; ++t) {
    const int start = t * BLOCK;
    const bool off = start >= note_off;
    const float t_s = (float)start / fs;
    const float ramp = lfo_delay_s > 0.f ? fminf(t_s / fmaxf(lfo_delay_s, 1e-9f), 1.f) : 1.f;
    lfo_phase = lfo_phase + lfo_hz * tick_s;
    if (lfo_phase >= 1.f) {
      lfo_phase = lfo_phase - floorf(lfo_phase);
      rng = rng * 1664525u + 1013904223u;
      sh = (float)(rng >> 8) / 8388608.f - 1.f;
    }
    const float lfo = lfo_wave_value(wave, lfo_phase, sh) * ramp;

    eg_tick(peg, peg_stage, peg_targets, peg_slews, off);
    const float pf = exp2f((peg * 0.08f + lfo * pmd * pms) / 12.f);
    pitch_fact[(size_t)t * B + b] = pf;

    const float am_lfo = -0.5f * (1.f + lfo) * amd;
    const size_t row = ((size_t)t * B + b) * N_OPS;
#pragma unroll
    for (int i = 0; i < N_OPS; ++i) {
      eg_tick(eg[i], stage[i], targets[i], slews[i], off);
      const float tot = fminf(eg[i] + gain[i] + am_lfo * ams[i], 0.f);
      float amp = on[i] ? expf(tot * ln10_over_20) : 0.f;
      amp = amp < 1e-6f ? 0.f : amp;
      const float inc = freq[i] * pf / fs;
      amps[row + i] = amp;
      starts[row + i] = phase[i];
      incs[row + i] = inc;
      const float nxt = phase[i] + inc * (float)BLOCK;
      phase[i] = nxt - floorf(nxt);
    }
  }
}

// F2: one thread per item walks the N = 32 T samples with the two-sample
// feedback history in registers; operators run from high to low over the
// algorithm's modulator bitmasks; the carrier sum is normalised, scaled by
// the master volume, clipped and faded, and written as (B, N).
__global__ void __launch_bounds__(THREADS)
fm_exact_kernel(const float* __restrict__ amps, const float* __restrict__ starts,
                const float* __restrict__ incs, const int* __restrict__ alg,
                const float* __restrict__ fb_amt, const float* __restrict__ n_carriers,
                const float* __restrict__ master_volume, const float* __restrict__ scale,
                int B, int T, float* __restrict__ out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int a = alg[b];
  int mods[N_OPS];
#pragma unroll
  for (int i = 0; i < N_OPS; ++i) mods[i] = c_alg[a][i];
  const int carriers = c_alg[a][6], fb_src = c_alg[a][7], fb_dst = c_alg[a][8];
  const float fba = fb_amt[b], nc = n_carriers[b], mv = master_volume[b];
  const size_t N = (size_t)T * BLOCK;
  float4* row_out = reinterpret_cast<float4*>(out + (size_t)b * N);

  float prev[N_OPS];
#pragma unroll
  for (int i = 0; i < N_OPS; ++i) prev[i] = 0.f;
  float fb1 = 0.f, fb2 = 0.f;

  for (int t = 0; t < T; ++t) {
    const size_t row = ((size_t)t * B + b) * N_OPS;
    float cur[N_OPS], st[N_OPS], in[N_OPS], dif[N_OPS];
#pragma unroll
    for (int i = 0; i < N_OPS; ++i) {
      cur[i] = amps[row + i];
      st[i] = starts[row + i];
      in[i] = incs[row + i];
      dif[i] = cur[i] - prev[i];
    }
    for (int q = 0; q < BLOCK / 4; ++q) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float s = (float)(4 * q + k + 1);
        const float w = s / (float)BLOCK;
        const float fb_term = 0.5f * (fb1 + fb2) * fba;
        float y[N_OPS];
#pragma unroll
        for (int i = N_OPS - 1; i >= 0; --i) {
          float mod = 0.f;
#pragma unroll
          for (int m = i + 1; m < N_OPS; ++m)
            if ((mods[i] >> m) & 1) mod = mod + y[m];
          if (fb_dst == i) mod = mod + fb_term;
          const float amp = prev[i] + dif[i] * w;
          const float ph = st[i] + in[i] * s;
          y[i] = sinf(TWO_PI_F * (ph + mod * MOD_SCALE_F)) * amp;
        }
        float sample = 0.f, fb_new = 0.f;
#pragma unroll
        for (int i = 0; i < N_OPS; ++i) {
          if ((carriers >> i) & 1) sample = sample + y[i];
          if (fb_src == i) fb_new = y[i];
        }
        fb2 = fb1;
        fb1 = fb_new;
        const float o = fminf(fmaxf(sample / nc * mv, -1.f), 1.f);
        v[k] = o * scale[(size_t)t * BLOCK + 4 * q + k];
      }
      row_out[(size_t)t * (BLOCK / 4) + q] = make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int i = 0; i < N_OPS; ++i) prev[i] = cur[i];
  }
}

extern "C" {

int fm_ctl_width() { return CTL_WIDTH; }

// keeps the (32, 9) algorithm table on the host; each F2 launch copies it
// into constant memory on its stream, so every device gets it
int fm_set_algorithms(const int* table) {
  for (int a = 0; a < 32; ++a)
    for (int k = 0; k < 9; ++k) h_alg[a][k] = table[9 * a + k];
  return 0;
}

int fm_control_launch(const float* ctl, int B, int T, int note_off, float fs, float tick_s,
                      float ln10_over_20, float* amps, float* pitch_fact, float* starts,
                      float* incs, cudaStream_t stream) {
  const int grid = (B + THREADS - 1) / THREADS;
  fm_control_kernel<<<grid, THREADS, 0, stream>>>(ctl, B, T, note_off, fs, tick_s,
                                                   ln10_over_20, amps, pitch_fact, starts, incs);
  return (int)cudaGetLastError();
}

int fm_exact_launch(const float* amps, const float* starts, const float* incs, const int* alg,
                    const float* fb_amt, const float* n_carriers, const float* master_volume,
                    const float* scale, int B, int T, float* out, cudaStream_t stream) {
  cudaError_t err = cudaMemcpyToSymbolAsync(c_alg, h_alg, sizeof(h_alg), 0,
                                            cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + THREADS - 1) / THREADS;
  fm_exact_kernel<<<grid, THREADS, 0, stream>>>(amps, starts, incs, alg, fb_amt, n_carriers,
                                                 master_volume, scale, B, T, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
