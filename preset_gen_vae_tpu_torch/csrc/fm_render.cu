// F1, F1b, F2 and F2b: the DX7 FM render of
// preset_gen_vae_tpu_torch/synth/fm_torch.py on Hopper (sm_90a) and its
// backward, built with nvcc at first use and bound with ctypes.
//
// No TPU kernel stands behind any: the JAX package leaves these scans to
// XLA (preset_gen_vae_tpu/synth/fm_jax.py), and their gradient to XLA's
// autodiff of lax.scan. F1 is the control-rate scan
// (fm_jax.py:299-339) with the per-tick phase starts (:389-394); F2 is the
// per-sample 'exact' scan (:489-516) with the amplitude interpolation
// (:370-379), the per-sample phases (:395-397) and the fade, volume and
// clip (:400-413).
//
// What bounds them. F1 carries, from one tick to the next, only short
// chains per item: the EG states, the LFO phase and its LCG, the six
// wrapped phases. Everything else of a tick is independent per operator,
// so F1 puts the operators of an item on lanes (8 lanes an item, 4 items
// a warp): each lane steps the LFO and the pitch EG itself, with the same
// arithmetic, and then its own operator's EG, amplitude, increment and
// phase; lane 6 writes the pitch factor. No lane waits on another.
//
// F2's sample n+1 needs the feedback loop's output at samples n and n-1.
// In every algorithm that loop is one modulation chain from the feedback
// destination down to its source (1-3 operators), nothing outside the
// loop modulates it, and only the source's output leaves it (the Python
// loader asserts this of the table). So only the loop is serial in the
// work, and F2 is two kernels that share the output buffer:
//  - fm_fb_loop: one thread per item with feedback runs only the loop's
//    operators, sample after sample, the two-sample history in registers,
//    and writes the source's output of every sample into out[b, :]. The
//    wrapper groups the items by loop length, each group from a warp
//    boundary, so that a warp's items take the same time; items without
//    feedback exit at once. Bound by its dependent chain: one to three
//    accurate sines a sample;
//  - fm_exact_ff: one thread per sample (a block is 8 ticks of one item,
//    their amplitudes, starts and increments staged in shared memory)
//    computes every operator off the loop (all six at feedback 0, where
//    the feedback term is +0), reads the loop's output from out where it
//    feeds them, and overwrites that element with the finished sample.
//    Bound by f32 arithmetic, the accurate sines first.
// Both take a range of ticks, so that the wrapper runs them as a pipeline
// over segments of ticks: the loop's segments on a high-priority stream,
// carrying the history from one to the next through a (B, 2) buffer, and
// each feed-forward segment on the caller's stream once its loop segment
// is done, overlapping the next one.
//
// F1b, F1's backward (fm_control_bwd): the adjoint of the control scan,
// the cotangents of F1's four outputs -> the gradient of the packed row.
// The scan's carried state (EG levels and stages, the LFO, the pitch EG)
// cannot be run backwards, so F1b keeps F1's 8 lanes per item and walks
// the ticks twice: forward with F1's exact operations, recording on a tape
// in device memory each tick's pre-tick EG level and stage (lanes 0-5) and
// pitch-EG level and stage (lane 6), and the LFO's phase and S&H value
// after its step (lane 7), one float2 a lane and tick; then in reverse,
// re-deriving each tick's branch decisions and values from the tape and
// carrying the adjoints: each operator's EG level and phase start on its
// lane, the item's LFO phase and pitch-EG level on every lane alike. The
// pitch factor's and the LFO value's adjoints gather contributions from
// all operators, summed over the 8 lanes each tick by warp shuffle. Like
// F1 it is bound by its serial chain, the two walks, and not by its bytes:
// the cotangents and the tape are read once.
//
// F2b, F2's backward (fm_exact_bwd), is three kernels; see the note above
// fm_exact_bwd_ff_kernel.
//
// Numerics follow the plain version op for op: the build passes
// -fmad=false (no multiply-add contraction) and no --use_fast_math, so
// sinf, expf and exp2f are the accurate library functions and every
// product and sum rounds where the torch ops round. Both phases keep the
// one-thread design's order of operations, so they produce its floats.

#include <cuda_runtime.h>
#include <stdint.h>

#define N_OPS 6
#define BLOCK 32
#define F1_LANES 8        // lanes per item in F1 and F1b: 6 operators, pitch factor, LFO (F1b)
#define F1_THREADS 32     // one warp (4 items) per block, so that few items spread over many SMs
#define LOOP_THREADS 32
#define FF_TICKS 8        // ticks of one item per feed-forward block
#define FF_THREADS (FF_TICKS * BLOCK)

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

// the columns of one algorithm row, fm_torch.ALG_COLUMNS (held equal by the CPU tests)
#define ALG_MODS 0
#define ALG_CARRIERS 6
#define ALG_FB_SRC 7
#define ALG_FB_DST 8
#define ALG_LOOP_LEN 9
#define ALG_LOOP_OPS 10
#define ALG_LOOP_MASK 13
#define ALG_WIDTH 14

#define TWO_PI_F 6.2831855f       // float32(2 pi)
#define MOD_SCALE_F 0.63661975f   // float32(4 / (2 pi))
#define SH_SEED 0x12345678u

// per algorithm: the modulator bitmask of each operator, the carrier
// bitmask, the feedback source and destination, and the feedback loop's
// length, operators (destination first) and bitmask (fm_torch.algorithm_rows)
__constant__ int c_alg[32][ALG_WIDTH];
static int h_alg[32][ALG_WIDTH];

__device__ __forceinline__ float pick4(const float* v, int i) {
  return i == 0 ? v[0] : (i == 1 ? v[1] : (i == 2 ? v[2] : v[3]));
}

__device__ __forceinline__ void add4(float* v, int i, float x) {
  if (i == 0) v[0] += x;
  else if (i == 1) v[1] += x;
  else if (i == 2) v[2] += x;
  else v[3] += x;
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

// the adjoint of eg_tick: ``g``, the post-tick level's adjoint -> the
// pre-tick level's; the target's and slew's of the stage the tick used go
// into g_targets and g_slews. No gradient reaches the stage, the
// ``reached`` test or the sign.
__device__ __forceinline__ float eg_tick_bwd(float cur, int stage, const float* targets,
                                             const float* slews, bool off, float g,
                                             float* g_targets, float* g_slews) {
  if (off) stage = 3;
  const float target = pick4(targets, stage);
  const float slew = pick4(slews, stage);
  const float dlt = target - cur;
  const float step = dlt > 0.f ? 4.f * slew + 0.05f * dlt : slew;
  if (fabsf(dlt) <= step) {
    add4(g_targets, stage, g);
    return 0.f;
  }
  const float g_step = g * (dlt > 0.f ? 1.f : (dlt < 0.f ? -1.f : 0.f));
  if (!(dlt > 0.f)) {
    add4(g_slews, stage, g_step);
    return g;
  }
  add4(g_slews, stage, g_step * 4.f);
  const float g_dlt = g_step * 0.05f;
  add4(g_targets, stage, g_dlt);
  return g - g_dlt;
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

// g times the LFO wave's derivative by its phase: none through the
// square's or the S&H's steps
__device__ __forceinline__ float lfo_wave_bwd(int wave, float phase, float g) {
  switch (wave) {
    case 0: return phase < 0.5f ? g * 4.f : -(g * 4.f);
    case 1: return g * -2.f;
    case 2: return g * 2.f;
    case 4: return g * cosf(TWO_PI_F * phase) * TWO_PI_F;
    default: return 0.f;
  }
}

// the LFO delay ramp, min(t_s / max(delay, 1e-9), 1) for delay > 0, else 1
__device__ __forceinline__ float lfo_ramp(float t_s, float delay) {
  return delay > 0.f ? fminf(t_s / fmaxf(delay, 1e-9f), 1.f) : 1.f;
}

// g times the ramp's derivative by the delay; min and max split their
// gradient in halves at a tie, as jnp.minimum and jnp.maximum do
__device__ __forceinline__ float lfo_ramp_bwd(float t_s, float delay, float g) {
  if (!(delay > 0.f)) return 0.f;
  const float m = fmaxf(delay, 1e-9f);
  const float r = t_s / m;
  const float g_r = r < 1.f ? g : (r == 1.f ? 0.5f * g : 0.f);
  const float inv = 1.f / m;
  const float g_m = -(g_r * t_s) * (inv * inv);
  return delay > 1e-9f ? g_m : (delay == 1e-9f ? 0.5f * g_m : 0.f);
}

// F1: 8 lanes per item walk the T ticks. Every lane steps the LFO (S&H LCG
// in uint32) and the pitch EG; lane i < 6 then steps operator i's EG, the
// AM term and amplitude floor, the increment and the wrapped phase start,
// and writes them into the (T, B, 6) arrays (a warp's 4 items write 96
// contiguous bytes a tick); lane 6 writes pitch_fact (T, B).
__global__ void __launch_bounds__(F1_THREADS)
fm_control_kernel(const float* __restrict__ ctl, int B, int T, int note_off, float fs,
                  float tick_s, float ln10_over_20, float* __restrict__ amps,
                  float* __restrict__ pitch_fact, float* __restrict__ starts,
                  float* __restrict__ incs) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = g / F1_LANES, op = g % F1_LANES;
  if (b >= B || op > N_OPS) return;
  const float* c = ctl + (size_t)b * CTL_WIDTH;
  const bool is_op = op < N_OPS;
  const int k_op = is_op ? op : 0;  // lane 6 reads operator 0's row and never uses it
  float targets[4], slews[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    targets[k] = c[CTL_TARGETS + 4 * k_op + k];
    slews[k] = c[CTL_SLEWS + 4 * k_op + k];
  }
  const float gain = c[CTL_OP_GAIN_DB + k_op], ams = c[CTL_AMS_DB + k_op];
  const float freq = c[CTL_FREQS + k_op];
  const bool on = c[CTL_ON + k_op] > 0.f;
  float eg = c[CTL_EG0 + k_op], phase = 0.f;
  int stage = 0;
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
    const float ramp = lfo_ramp(t_s, lfo_delay_s);
    lfo_phase = lfo_phase + lfo_hz * tick_s;
    if (lfo_phase >= 1.f) {
      lfo_phase = lfo_phase - floorf(lfo_phase);
      rng = rng * 1664525u + 1013904223u;
      sh = (float)(rng >> 8) / 8388608.f - 1.f;
    }
    const float lfo = lfo_wave_value(wave, lfo_phase, sh) * ramp;

    eg_tick(peg, peg_stage, peg_targets, peg_slews, off);
    const float pf = exp2f((peg * 0.08f + lfo * pmd * pms) / 12.f);
    if (!is_op) {
      pitch_fact[(size_t)t * B + b] = pf;
      continue;
    }
    const float am_lfo = -0.5f * (1.f + lfo) * amd;
    const size_t at = ((size_t)t * B + b) * N_OPS + op;
    eg_tick(eg, stage, targets, slews, off);
    const float tot = fminf(eg + gain + am_lfo * ams, 0.f);
    float amp = on ? expf(tot * ln10_over_20) : 0.f;
    amp = amp < 1e-6f ? 0.f : amp;
    const float inc = freq * pf / fs;
    amps[at] = amp;
    starts[at] = phase;
    incs[at] = inc;
    const float nxt = phase + inc * (float)BLOCK;
    phase = nxt - floorf(nxt);
  }
}

// the sum of v over the 8 lanes of an item; every lane gets the same float
// (each xor step adds the same two values on both lanes)
__device__ __forceinline__ float lanes_sum(float v) {
  v = v + __shfl_xor_sync(0xffffffffu, v, 4, F1_LANES);
  v = v + __shfl_xor_sync(0xffffffffu, v, 2, F1_LANES);
  return v + __shfl_xor_sync(0xffffffffu, v, 1, F1_LANES);
}

// F1b: the adjoint of F1 (fm_torch.control_pass_vjp). F1's lanes: lane i
// < 6 is operator i, lane 6 the pitch factor, lane 7 keeps the LFO on the
// tape. Every lane of every item in the block runs both walks, padding
// items too (their memory accesses are skipped), so that the shuffles
// see full warps. Writes every column of the item's gradient row.
__global__ void __launch_bounds__(F1_THREADS)
fm_control_bwd_kernel(const float* __restrict__ ctl, int B, int T, int note_off, float fs,
                      float tick_s, float ln10_over_20, const float* __restrict__ g_amps,
                      const float* __restrict__ g_pitch_fact, const float* __restrict__ g_starts,
                      const float* __restrict__ g_incs, float2* __restrict__ tape,
                      float* __restrict__ gctl) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = g % F1_LANES;
  const bool valid = g / F1_LANES < B;
  const int b = valid ? g / F1_LANES : B - 1;
  const float* c = ctl + (size_t)b * CTL_WIDTH;
  const bool is_op = lane < N_OPS;
  const int k_op = is_op ? lane : 0;  // lanes 6 and 7 read operator 0's row and never use it
  float targets[4], slews[4], peg_targets[4], peg_slews[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    targets[k] = c[CTL_TARGETS + 4 * k_op + k];
    slews[k] = c[CTL_SLEWS + 4 * k_op + k];
    peg_targets[k] = c[CTL_PEG_TARGETS + k];
    peg_slews[k] = c[CTL_PEG_SLEWS + k];
  }
  const float gain = c[CTL_OP_GAIN_DB + k_op], ams = c[CTL_AMS_DB + k_op];
  const float freq = c[CTL_FREQS + k_op];
  const bool on = c[CTL_ON + k_op] > 0.f;
  const float lfo_hz = c[CTL_LFO_HZ], lfo_delay_s = c[CTL_LFO_DELAY_S];
  const float pmd = c[CTL_PMD], amd = c[CTL_AMD], pms = c[CTL_PMS];
  const int wave = (int)c[CTL_LFO_WAVE];

  // ---- forward: F1's state walk, the tape written
  {
    float eg = c[CTL_EG0 + k_op], peg = c[CTL_PEG0], lfo_phase = c[CTL_LFO_PHASE0], sh = 0.f;
    int stage = 0, peg_stage = 0;
    uint32_t rng = SH_SEED;
    for (int t = 0; t < T; ++t) {
      const bool off = t * BLOCK >= note_off;
      lfo_phase = lfo_phase + lfo_hz * tick_s;
      if (lfo_phase >= 1.f) {
        lfo_phase = lfo_phase - floorf(lfo_phase);
        rng = rng * 1664525u + 1013904223u;
        sh = (float)(rng >> 8) / 8388608.f - 1.f;
      }
      const float2 rec = is_op ? make_float2(eg, (float)stage)
                               : (lane == N_OPS ? make_float2(peg, (float)peg_stage)
                                                : make_float2(lfo_phase, sh));
      if (valid) tape[((size_t)t * B + b) * F1_LANES + lane] = rec;
      eg_tick(peg, peg_stage, peg_targets, peg_slews, off);
      eg_tick(eg, stage, targets, slews, off);
    }
  }

  // ---- reverse: the adjoints of the post-tick EG level (a_eg), pitch-EG
  // level (a_peg) and LFO phase (a_lfo), and the sum of the later phase
  // starts' cotangents (a_start); the row's gradient in registers
  float a_eg = 0.f, a_peg = 0.f, a_lfo = 0.f, a_start = 0.f;
  float g_targets[4] = {0.f, 0.f, 0.f, 0.f}, g_slews[4] = {0.f, 0.f, 0.f, 0.f};
  float g_peg_targets[4] = {0.f, 0.f, 0.f, 0.f}, g_peg_slews[4] = {0.f, 0.f, 0.f, 0.f};
  float g_gain = 0.f, g_ams = 0.f, g_freq = 0.f, g_amd = 0.f;
  float g_hz = 0.f, g_delay = 0.f, g_pmd = 0.f, g_pms = 0.f;
  // this lane's tape entry and cotangents of tick t, loaded a tick ahead
  auto load = [&](int t, float2& rec, float& ga, float& gs, float& gi) {
    rec = make_float2(0.f, 0.f);
    ga = gs = gi = 0.f;
    if (!valid || t < 0) return;
    rec = tape[((size_t)t * B + b) * F1_LANES + lane];
    if (is_op) {
      const size_t at = ((size_t)t * B + b) * N_OPS + lane;
      ga = g_amps[at];
      gs = g_starts[at];
      gi = g_incs[at];
    } else if (lane == N_OPS) {
      ga = g_pitch_fact[(size_t)t * B + b];
    }
  };
  float2 rec;
  float ga, gs, gi;
  load(T - 1, rec, ga, gs, gi);
  for (int t = T - 1; t >= 0; --t) {
    float2 rec_n;
    float ga_n, gs_n, gi_n;
    load(t - 1, rec_n, ga_n, gs_n, gi_n);
    const int start = t * BLOCK;
    const bool off = start >= note_off;
    const float t_s = (float)start / fs;
    const float ramp = lfo_ramp(t_s, lfo_delay_s);
    const float peg_pre = __shfl_sync(0xffffffffu, rec.x, N_OPS, F1_LANES);
    const int peg_stage = (int)__shfl_sync(0xffffffffu, rec.y, N_OPS, F1_LANES);
    const float lfo_phase = __shfl_sync(0xffffffffu, rec.x, N_OPS + 1, F1_LANES);
    const float sh = __shfl_sync(0xffffffffu, rec.y, N_OPS + 1, F1_LANES);
    // tick t's values, as F1 computes them
    const float lfo_raw = lfo_wave_value(wave, lfo_phase, sh);
    const float lfo = lfo_raw * ramp;
    float peg = peg_pre;
    int peg_st = peg_stage;
    eg_tick(peg, peg_st, peg_targets, peg_slews, off);
    const float pf = exp2f((peg * 0.08f + lfo * pmd * pms) / 12.f);
    // this lane's parts of the pitch factor's and the LFO value's adjoints
    float c_pf = 0.f, c_lfo = 0.f;
    if (is_op) {
      const float eg_pre = rec.x;
      const int stage = (int)rec.y;
      float eg = eg_pre;
      int st = stage;
      eg_tick(eg, st, targets, slews, off);
      const float am_lfo = -0.5f * (1.f + lfo) * amd;
      const float tot = eg + gain + am_lfo * ams;
      float amp = on ? expf(fminf(tot, 0.f) * ln10_over_20) : 0.f;
      amp = amp < 1e-6f ? 0.f : amp;
      // amp = exp(min(tot, 0) ln10/20), floored: no gradient below the floor
      const float g_tot0 = amp > 0.f ? ga * amp * ln10_over_20 : 0.f;
      const float g_tot = tot < 0.f ? g_tot0 : (tot == 0.f ? 0.5f * g_tot0 : 0.f);
      a_eg = a_eg + g_tot;
      g_gain = g_gain + g_tot;
      g_ams = g_ams + g_tot * am_lfo;
      const float g_am_lfo = g_tot * ams;
      g_amd = g_amd + g_am_lfo * (-0.5f * (1.f + lfo));
      c_lfo = g_am_lfo * amd * -0.5f;
      // start[t+1] = frac(start[t] + 32 inc[t]): inc[t] collects 32x the
      // later starts' cotangents
      const float g_inc = gi + a_start * (float)BLOCK;
      a_start = a_start + gs;
      const float g_fp = g_inc / fs;
      g_freq = g_freq + g_fp * pf;
      c_pf = g_fp * freq;
      a_eg = eg_tick_bwd(eg_pre, stage, targets, slews, off, a_eg, g_targets, g_slews);
    } else if (lane == N_OPS) {
      c_pf = ga;
    }
    c_pf = lanes_sum(c_pf);
    c_lfo = lanes_sum(c_lfo);
    // the item's shared chain, the same floats on every lane
    const float g_semis = c_pf * pf * 0.6931472f / 12.f;
    a_peg = a_peg + g_semis * 0.08f;
    g_pms = g_pms + g_semis * (lfo * pmd);
    const float g_lfo_pmd = g_semis * pms;
    g_pmd = g_pmd + g_lfo_pmd * lfo;
    const float g_lfo = c_lfo + g_lfo_pmd * pmd;
    g_delay = g_delay + lfo_ramp_bwd(t_s, lfo_delay_s, g_lfo * lfo_raw);
    // the wrap (phase - floor(phase)) passes the phase's adjoint on whole
    a_lfo = a_lfo + lfo_wave_bwd(wave, lfo_phase, g_lfo * ramp);
    g_hz = g_hz + a_lfo * tick_s;
    a_peg = eg_tick_bwd(peg_pre, peg_stage, peg_targets, peg_slews, off, a_peg, g_peg_targets,
                        g_peg_slews);
    rec = rec_n;
    ga = ga_n;
    gs = gs_n;
    gi = gi_n;
  }
  g_amd = lanes_sum(g_amd);
  if (!valid) return;
  float* gc = gctl + (size_t)b * CTL_WIDTH;
  if (is_op) {
    gc[CTL_OP_GAIN_DB + lane] = g_gain;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gc[CTL_TARGETS + 4 * lane + k] = g_targets[k];
      gc[CTL_SLEWS + 4 * lane + k] = g_slews[k];
    }
    gc[CTL_EG0 + lane] = a_eg;
    gc[CTL_AMS_DB + lane] = g_ams;
    gc[CTL_ON + lane] = 0.f;  // a switch: no gradient
    gc[CTL_FREQS + lane] = g_freq;
  } else if (lane == N_OPS) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gc[CTL_PEG_TARGETS + k] = g_peg_targets[k];
      gc[CTL_PEG_SLEWS + k] = g_peg_slews[k];
    }
    gc[CTL_PEG0] = a_peg;
    gc[CTL_LFO_HZ] = g_hz;
    gc[CTL_LFO_PHASE0] = a_lfo;
    gc[CTL_LFO_DELAY_S] = g_delay;
    gc[CTL_PMD] = g_pmd;
    gc[CTL_AMD] = g_amd;
    gc[CTL_PMS] = g_pms;
    gc[CTL_LFO_WAVE] = 0.f;  // a switch: no gradient
  }
}

// F2, loop phase: the L operators of the feedback loop (ops[0] the
// destination, ops[L-1] the source) of one item over ticks t0 .. t1-1.
// The destination's modulation is 0 + the feedback term, each later
// operator's 0 + the previous one's output, exactly as the one-thread
// design summed them; the source's output goes to row[n]. The two-sample
// history enters and leaves through fb (zero at t0 = 0), and the previous
// tick's amplitudes are read back (zero before tick 0), so that segments
// run one after another give the floats of one run over all ticks.
template <int L>
__device__ __forceinline__ void run_loop(const float* __restrict__ amps,
                                         const float* __restrict__ starts,
                                         const float* __restrict__ incs, const int* ops, int b,
                                         int B, int t0, int t1, float fba, float2* fb,
                                         float* __restrict__ row) {
  float4* row4 = reinterpret_cast<float4*>(row);
  float prev[L], cur[L], st[L], in[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    prev[j] = t0 > 0 ? amps[((size_t)(t0 - 1) * B + b) * N_OPS + ops[j]] : 0.f;
    const size_t at = ((size_t)t0 * B + b) * N_OPS + ops[j];
    cur[j] = amps[at];
    st[j] = starts[at];
    in[j] = incs[at];
  }
  float fb1 = 0.f, fb2 = 0.f;
  if (t0 > 0) {
    fb1 = fb->x;
    fb2 = fb->y;
  }
  for (int t = t0; t < t1; ++t) {
    // next tick's loads are issued before this tick's 32 samples
    float ncur[L], nst[L], nin[L];
    const int tn = t + 1 < t1 ? t + 1 : t;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const size_t at = ((size_t)tn * B + b) * N_OPS + ops[j];
      ncur[j] = amps[at];
      nst[j] = starts[at];
      nin[j] = incs[at];
    }
    float dif[L];
#pragma unroll
    for (int j = 0; j < L; ++j) dif[j] = cur[j] - prev[j];
    for (int q = 0; q < BLOCK / 4; ++q) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float s = (float)(4 * q + k + 1);
        const float w = s / (float)BLOCK;
        const float fb_term = 0.5f * (fb1 + fb2) * fba;
        float y = 0.f;
#pragma unroll
        for (int j = 0; j < L; ++j) {
          float mod = 0.f;
          mod = mod + (j == 0 ? fb_term : y);
          const float amp = prev[j] + dif[j] * w;
          const float ph = st[j] + in[j] * s;
          y = sinf(TWO_PI_F * (ph + mod * MOD_SCALE_F)) * amp;
        }
        fb2 = fb1;
        fb1 = y;
        v[k] = y;
      }
      row4[(size_t)t * (BLOCK / 4) + q] = make_float4(v[0], v[1], v[2], v[3]);
    }
#pragma unroll
    for (int j = 0; j < L; ++j) {
      prev[j] = cur[j];
      cur[j] = ncur[j];
      st[j] = nst[j];
      in[j] = nin[j];
    }
  }
  *fb = make_float2(fb1, fb2);
}

// F2, loop phase: thread i takes item slots[i]. The wrapper groups the
// items by loop length, each group starting at a warp boundary, so that
// every warp runs one length; -1 slots (the padding) and items without
// feedback exit at once.
__global__ void __launch_bounds__(LOOP_THREADS)
fm_fb_loop_kernel(const float* __restrict__ amps, const float* __restrict__ starts,
                  const float* __restrict__ incs, const int* __restrict__ alg,
                  const float* __restrict__ fb_amt, const int* __restrict__ slots, int n_slots,
                  int B, int T, int t0, int t1, float2* __restrict__ fb,
                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_slots) return;
  const int b = slots[i];
  if (b < 0) return;
  const float fba = fb_amt[b];
  if (fba == 0.f) return;
  const int a = alg[b];
  const int len = c_alg[a][ALG_LOOP_LEN];
  const int ops[3] = {c_alg[a][ALG_LOOP_OPS], c_alg[a][ALG_LOOP_OPS + 1],
                      c_alg[a][ALG_LOOP_OPS + 2]};
  float* row = out + (size_t)b * T * BLOCK;
  if (len == 1) run_loop<1>(amps, starts, incs, ops, b, B, t0, t1, fba, fb + b, row);
  else if (len == 2) run_loop<2>(amps, starts, incs, ops, b, B, t0, t1, fba, fb + b, row);
  else run_loop<3>(amps, starts, incs, ops, b, B, t0, t1, fba, fb + b, row);
}

// F2, feed-forward phase: block (b, j) takes ticks t_begin + 8j .. +7 of
// item b (below t_end), one sample a thread. Operators run from high to
// low over the algorithm's modulator bitmasks; on an item with feedback
// the loop's operators are not computed and the source's output is read
// from out, or, TAPED, from the tape (B, T*32) that the loop phase wrote
// for F2b. The carrier sum is normalised, scaled by the master volume,
// clipped and faded, and written over the same element of out. Two
// instantiations, so that the untaped one keeps a single pointer to out.
template <bool TAPED>
__global__ void __launch_bounds__(FF_THREADS)
fm_exact_ff_kernel(const float* __restrict__ amps, const float* __restrict__ starts,
                   const float* __restrict__ incs, const int* __restrict__ alg,
                   const float* __restrict__ fb_amt, const float* __restrict__ n_carriers,
                   const float* __restrict__ master_volume, const float* __restrict__ scale,
                   int B, int T, int t_begin, int t_end, int n_tblk,
                   const float* __restrict__ tape, float* __restrict__ out) {
  const int b = blockIdx.x / n_tblk;
  const int t0 = t_begin + (blockIdx.x % n_tblk) * FF_TICKS;
  // s_amp[k] is tick t0 + k - 1's amplitudes (zero before tick 0)
  __shared__ float s_amp[FF_TICKS + 1][N_OPS], s_st[FF_TICKS][N_OPS], s_in[FF_TICKS][N_OPS];
  const int tid = threadIdx.x;
  if (tid < (FF_TICKS + 1) * N_OPS) {
    const int t = t0 + tid / N_OPS - 1;
    s_amp[tid / N_OPS][tid % N_OPS] =
        (t >= 0 && t < t_end) ? amps[((size_t)t * B + b) * N_OPS + tid % N_OPS] : 0.f;
  } else if (tid < (2 * FF_TICKS + 1) * N_OPS) {
    const int e = tid - (FF_TICKS + 1) * N_OPS, t = t0 + e / N_OPS;
    s_st[e / N_OPS][e % N_OPS] = t < t_end ? starts[((size_t)t * B + b) * N_OPS + e % N_OPS] : 0.f;
  } else if (tid < (3 * FF_TICKS + 1) * N_OPS) {
    const int e = tid - (2 * FF_TICKS + 1) * N_OPS, t = t0 + e / N_OPS;
    s_in[e / N_OPS][e % N_OPS] = t < t_end ? incs[((size_t)t * B + b) * N_OPS + e % N_OPS] : 0.f;
  }
  __syncthreads();
  const int k = tid / BLOCK;
  if (t0 + k >= t_end) return;
  const int a = alg[b];
  int mods[N_OPS];
#pragma unroll
  for (int i = 0; i < N_OPS; ++i) mods[i] = c_alg[a][ALG_MODS + i];
  const int carriers = c_alg[a][ALG_CARRIERS], fb_src = c_alg[a][ALG_FB_SRC];
  const int fb_dst = c_alg[a][ALG_FB_DST];
  const int loop = fb_amt[b] != 0.f ? c_alg[a][ALG_LOOP_MASK] : 0;
  const size_t n = (size_t)(t0 + k) * BLOCK + tid % BLOCK;
  float* at = out + (size_t)b * T * BLOCK + n;
  const float s = (float)(tid % BLOCK + 1);
  const float w = s / (float)BLOCK;

  float y[N_OPS];
#pragma unroll
  for (int i = N_OPS - 1; i >= 0; --i) {
    if ((loop >> i) & 1) {
      // only the source's output leaves the loop; the others feed no one here
      y[i] = i == fb_src ? (TAPED ? tape[(size_t)b * T * BLOCK + n] : *at) : 0.f;
      continue;
    }
    float mod = 0.f;
#pragma unroll
    for (int m = i + 1; m < N_OPS; ++m)
      if ((mods[i] >> m) & 1) mod = mod + y[m];
    if (fb_dst == i) mod = mod + 0.f;  // feedback 0: the term is +0
    const float prev = s_amp[k][i];
    const float dif = s_amp[k + 1][i] - prev;
    const float amp = prev + dif * w;
    const float ph = s_st[k][i] + s_in[k][i] * s;
    y[i] = sinf(TWO_PI_F * (ph + mod * MOD_SCALE_F)) * amp;
  }
  float sample = 0.f;
#pragma unroll
  for (int i = 0; i < N_OPS; ++i)
    if ((carriers >> i) & 1) sample = sample + y[i];
  const float o = fminf(fmaxf(sample / n_carriers[b] * master_volume[b], -1.f), 1.f);
  *at = o * scale[n];
}

// F2b, F2's backward (fm_exact_bwd): the cotangent of the waveform ->
// those of F1's amplitudes, phase starts and increments, the feedback
// gain and the master volume (fm_torch.exact_pass_vjp). The forward under
// autograd keeps the loop source's output y_src on a tape (B, T*32). The
// destination sees only fb[n] = 0.5 fba (y_src[n-1] + y_src[n-2]) and
// only y_src leaves the loop, so with the tape the loop's adjoint is a
// LINEAR recurrence backward in time:
//   a[n] = e[n] + k[n+1] a[n+1] + k[n+2] a[n+2],
// e[n] the cotangent that reaches y_src[n] from outside the loop, k[m] =
// 0.5 fba prod_j (amp_j cos(arg_j) 2 pi MOD_SCALE) over the loop's
// operators at sample m. Three launches on the caller's stream:
//  - fm_exact_bwd_ff (a): a block per item walks its ticks 8 at a time,
//    one sample a thread; recomputes the operators off the loop (the
//    source read from the tape), backpropagates through the fade, the
//    clip (half the gradient at a tie, as jnp.clip), the volume, the
//    carrier sum and the off-loop operators from low to high, and writes
//    e and k, and the off-loop operators' per-tick sums;
//  - fm_exact_bwd_rec (b): one thread per item with feedback runs the
//    recurrence, two multiplies and two adds a sample, a overwriting e,
//    its loads kept REC_STAGES ticks ahead by cp.async;
//  - fm_exact_bwd_loop (c): as (a), on the items with feedback: the loop's
//    1-3 operators recomputed at each sample and their cotangents from
//    a[n], and the feedback gain's.
// Per-tick sums: g_starts[t] = sum_s g_ph, g_incs[t] = sum_s s g_ph; a
// sample's amplitude cotangent goes w_s to amps[t] and 1 - w_s to
// amps[t-1], so a tick's amps cotangent is its own share plus the next
// tick's. Each sample leaves its four parts per operator in shared memory
// and one thread per (tick, operator, sum) adds a tick's 32 in order; the
// block owns its item's ticks, carries the seam from one step to the next,
// and reduces the per-item sums itself: no atomics, and every output
// element written once. Bound: (a) and (c) by their f32
// operations and sines (the forward recomputed, ~3x its work), (b) by
// its chain, 88,576 dependent multiply-adds an item at 4 s.
#define BWD_TICKS 8
#define BWD_THREADS (BWD_TICKS * BLOCK)
#define BWD_SCRATCH 2  // (B, T*32) f32 rows F2b allocates: e (then a), k
#define BWD_SUMS 4     // per tick and operator: sum g_ph, sum s g_ph, sum w g_amp, sum (1-w) g_amp
#define REC_THREADS 32
#define REC_STAGES 5   // ticks of e and k in flight per thread of the recurrence

struct BwdShared {
  float amp[BWD_TICKS + 1][N_OPS], st[BWD_TICKS][N_OPS], in[BWD_TICKS][N_OPS];
  // each sample's parts of the per-tick sums, row k * 24 + 4 i + c for tick k,
  // operator i and sum c (padded: a reducing thread's 32 reads hit 32 banks)
  float part[BWD_TICKS * N_OPS * BWD_SUMS][BLOCK + 1];
  float tick[BWD_SUMS][BWD_TICKS][N_OPS];  // the sums
  float red[BWD_TICKS][2];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// stages ticks t0 .. t0+7 of item b as fm_exact_ff does: amp[k] is tick
// t0 + k - 1's amplitudes (zero before tick 0 and past T)
__device__ __forceinline__ void bwd_stage(BwdShared& s, const float* __restrict__ amps,
                                          const float* __restrict__ starts,
                                          const float* __restrict__ incs, int B, int T, int b,
                                          int t0, int tid) {
  if (tid < (BWD_TICKS + 1) * N_OPS) {
    const int t = t0 + tid / N_OPS - 1;
    s.amp[tid / N_OPS][tid % N_OPS] =
        (t >= 0 && t < T) ? amps[((size_t)t * B + b) * N_OPS + tid % N_OPS] : 0.f;
  } else if (tid < (2 * BWD_TICKS + 1) * N_OPS) {
    const int e = tid - (BWD_TICKS + 1) * N_OPS, t = t0 + e / N_OPS;
    s.st[e / N_OPS][e % N_OPS] = t < T ? starts[((size_t)t * B + b) * N_OPS + e % N_OPS] : 0.f;
  } else if (tid < (3 * BWD_TICKS + 1) * N_OPS) {
    const int e = tid - (2 * BWD_TICKS + 1) * N_OPS, t = t0 + e / N_OPS;
    s.in[e / N_OPS][e % N_OPS] = t < T ? incs[((size_t)t * B + b) * N_OPS + e % N_OPS] : 0.f;
  }
}

// a sample's parts of the per-tick sums of operator i's cotangents
__device__ __forceinline__ void sample_parts(BwdShared& s, int k, int lane, int i, float g_ph,
                                             float g_amp, float sv, float w) {
  float* row = &s.part[(k * N_OPS + i) * BWD_SUMS][lane];
  row[0] = g_ph;
  row[BLOCK + 1] = g_ph * sv;
  row[2 * (BLOCK + 1)] = g_amp * w;
  row[3 * (BLOCK + 1)] = g_amp - g_amp * w;
}

// threads 0-191 each sum one row of parts over its tick's 32 samples, in
// order, for the operators in own
__device__ __forceinline__ void tick_sums(BwdShared& s, int own, int tid) {
  if (tid < BWD_TICKS * N_OPS * BWD_SUMS) {
    const int k = tid / (N_OPS * BWD_SUMS), i = tid % (N_OPS * BWD_SUMS) / BWD_SUMS;
    if ((own >> i) & 1) {
      float r = 0.f;
#pragma unroll 8
      for (int j = 0; j < BLOCK; ++j) r = r + s.part[tid][j];
      s.tick[tid % BWD_SUMS][k][i] = r;
    }
  }
}

// writes the step's ticks of the operators in own: threads 0-47 a (tick,
// operator) each; tick t's amps cotangent is cur[t] + prv[t+1], so the
// step's last tick waits for the next step's first in carry (threads
// 48-53, one per operator)
__device__ __forceinline__ void write_ticks(const BwdShared& s, int own, int B, int T, int b,
                                            int t0, int tid, float& carry,
                                            float* __restrict__ g_amps,
                                            float* __restrict__ g_starts,
                                            float* __restrict__ g_incs) {
  if (tid < BWD_TICKS * N_OPS) {
    const int k = tid / N_OPS, i = tid % N_OPS, t = t0 + k;
    if (((own >> i) & 1) && t < T) {
      const size_t at = ((size_t)t * B + b) * N_OPS + i;
      g_starts[at] = s.tick[0][k][i];
      g_incs[at] = s.tick[1][k][i];
      if (k < BWD_TICKS - 1)
        g_amps[at] = t + 1 < T ? s.tick[2][k][i] + s.tick[3][k + 1][i] : s.tick[2][k][i];
    }
  } else if (tid < (BWD_TICKS + 1) * N_OPS) {
    const int i = tid - BWD_TICKS * N_OPS, t = t0 + BWD_TICKS - 1;
    if ((own >> i) & 1) {
      if (t0 > 0) g_amps[((size_t)(t0 - 1) * B + b) * N_OPS + i] = carry + s.tick[3][0][i];
      if (t + 1 < T) carry = s.tick[2][BWD_TICKS - 1][i];
      else if (t < T) g_amps[((size_t)t * B + b) * N_OPS + i] = s.tick[2][BWD_TICKS - 1][i];
    }
  }
}

// the block's sum of v (one value per thread), for thread 0; slot 0 or 1 of red
__device__ __forceinline__ float block_sum(BwdShared& s, float v, int slot, int tid) {
  v = warp_sum(v);
  if (tid % BLOCK == 0) s.red[tid / BLOCK][slot] = v;
  __syncthreads();
  float r = 0.f;
  if (tid == 0)
    for (int k = 0; k < BWD_TICKS; ++k) r = r + s.red[k][slot];
  return r;
}

// F2b (a): one block per item. Writes the off-loop operators' columns of
// g_amps, g_starts and g_incs, g_mv, and for an item with feedback e[n]
// and k[n]; for an item without feedback (every operator off the loop)
// also its g_fb: the destination's modulation cotangent times the source's
// half sum of its two previous outputs, the term that meets a zero gain.
__global__ void __launch_bounds__(BWD_THREADS)
fm_exact_bwd_ff_kernel(const float* __restrict__ amps, const float* __restrict__ starts,
                       const float* __restrict__ incs, const int* __restrict__ alg,
                       const float* __restrict__ fb_amt, const float* __restrict__ n_carriers,
                       const float* __restrict__ master_volume, const float* __restrict__ scale,
                       const float* __restrict__ tape, const float* __restrict__ g_out, int B,
                       int T, float* __restrict__ e, float* __restrict__ k_out,
                       float* __restrict__ g_amps, float* __restrict__ g_starts,
                       float* __restrict__ g_incs, float* __restrict__ g_fb,
                       float* __restrict__ g_mv) {
  __shared__ BwdShared s;
  __shared__ float s_y[BWD_THREADS + 2];  // y_src of the step, after the last two of the previous
  const int b = blockIdx.x, tid = threadIdx.x, k = tid / BLOCK, lane = tid % BLOCK;
  const int a = alg[b];
  int mods[N_OPS];
#pragma unroll
  for (int i = 0; i < N_OPS; ++i) mods[i] = c_alg[a][ALG_MODS + i];
  const int carriers = c_alg[a][ALG_CARRIERS], fb_src = c_alg[a][ALG_FB_SRC];
  const int fb_dst = c_alg[a][ALG_FB_DST], len = c_alg[a][ALG_LOOP_LEN];
  const int ops[3] = {c_alg[a][ALG_LOOP_OPS], c_alg[a][ALG_LOOP_OPS + 1],
                      c_alg[a][ALG_LOOP_OPS + 2]};
  const float fba = fb_amt[b], nc = n_carriers[b], mv = master_volume[b];
  const bool on = fba != 0.f;
  const int loop = on ? c_alg[a][ALG_LOOP_MASK] : 0;
  const float sv = (float)(lane + 1), w = sv / (float)BLOCK;
  const size_t row = (size_t)b * T * BLOCK;
  float carry = 0.f, acc_mv = 0.f, acc_fb = 0.f;
  if (tid < 2) s_y[tid] = 0.f;
  for (int t0 = 0; t0 < T; t0 += BWD_TICKS) {
    __syncthreads();  // the previous step is done with s
    bwd_stage(s, amps, starts, incs, B, T, b, t0, tid);
    __syncthreads();
    const bool valid = t0 + k < T;
    const size_t n = (size_t)(t0 + k) * BLOCK + lane;
    // ---- forward, as fm_exact_ff
    float y[N_OPS], sn[N_OPS], cs[N_OPS], am[N_OPS], y_src = 0.f;
#pragma unroll
    for (int i = N_OPS - 1; i >= 0; --i) {
      sn[i] = cs[i] = am[i] = 0.f;
      if ((loop >> i) & 1) {
        y[i] = (i == fb_src && valid) ? tape[row + n] : 0.f;
      } else {
        float mod = 0.f;
#pragma unroll
        for (int m = i + 1; m < N_OPS; ++m)
          if ((mods[i] >> m) & 1) mod = mod + y[m];
        const float prev = s.amp[k][i];
        am[i] = prev + (s.amp[k + 1][i] - prev) * w;
        const float ph = s.st[k][i] + s.in[k][i] * sv;
        sincosf(TWO_PI_F * (ph + mod * MOD_SCALE_F), &sn[i], &cs[i]);
        y[i] = sn[i] * am[i];
      }
      if (i == fb_src) y_src = y[i];
    }
    float sample = 0.f;
#pragma unroll
    for (int i = 0; i < N_OPS; ++i)
      if ((carriers >> i) & 1) sample = sample + y[i];
    // ---- backward: fade, clip, volume, carrier sum
    const float q = sample / nc, o = q * mv;
    const float m1 = fmaxf(o, -1.f);
    const float g_fade = valid ? g_out[row + n] * scale[n] : 0.f;
    const float g_o = g_fade * (m1 < 1.f ? 1.f : (m1 == 1.f ? 0.5f : 0.f)) *
                      (o > -1.f ? 1.f : (o == -1.f ? 0.5f : 0.f));
    acc_mv = acc_mv + g_o * q;
    const float g_sample = g_o * mv / nc;
    float gy[N_OPS];
#pragma unroll
    for (int i = 0; i < N_OPS; ++i) gy[i] = ((carriers >> i) & 1) ? g_sample : 0.f;
    // ---- the off-loop operators, low to high
    float e_n = 0.f, g_dst = 0.f;
#pragma unroll
    for (int i = 0; i < N_OPS; ++i) {
      if (on && i == fb_src) e_n = gy[i];  // complete: only lower operators take y_src
      if ((loop >> i) & 1) continue;  // block-uniform
      const float g_amp = gy[i] * sn[i];
      const float g_u = gy[i] * am[i] * cs[i] * TWO_PI_F;
      const float g_mod = g_u * MOD_SCALE_F;
#pragma unroll
      for (int m = i + 1; m < N_OPS; ++m)
        if ((mods[i] >> m) & 1) gy[m] = gy[m] + g_mod;
      if (i == fb_dst) g_dst = g_mod;
      sample_parts(s, k, lane, i, g_u, g_amp, sv, w);
    }
    s_y[tid + 2] = y_src;
    __syncthreads();  // the tick sums and s_y are written
    const float half = 0.5f * (s_y[tid + 1] + s_y[tid]);
    __syncwarp();
    if (tid < 2) s_y[tid] = s_y[BWD_THREADS + tid];  // the next step's previous two
    if (!on) {
      acc_fb = acc_fb + g_dst * half;
    } else if (valid) {
      // k[n]: the loop from its input at n, as fm_fb_loop runs it
      float ly = half * fba, d = 1.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        if (j < len) {
          const int op = ops[j];
          const float prev = s.amp[k][op];
          const float amp = prev + (s.amp[k + 1][op] - prev) * w;
          const float ph = s.st[k][op] + s.in[k][op] * sv;
          float sj, cj;
          sincosf(TWO_PI_F * (ph + ly * MOD_SCALE_F), &sj, &cj);
          ly = sj * amp;
          d = d * (amp * cj * TWO_PI_F * MOD_SCALE_F);
        }
      }
      e[row + n] = e_n;
      k_out[row + n] = d * fba * 0.5f;
    }
    tick_sums(s, ~loop & 63, tid);
    __syncthreads();
    write_ticks(s, ~loop & 63, B, T, b, t0, tid, carry, g_amps, g_starts, g_incs);
  }
  __syncthreads();
  const float r_mv = block_sum(s, acc_mv, 0, tid);
  const float r_fb = block_sum(s, acc_fb, 1, tid);
  if (tid == 0) {
    g_mv[b] = r_mv;
    if (!on) g_fb[b] = r_fb;
  }
}

// 16 bytes from global to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem));
}

// F2b (b): thread i takes item i if it has feedback and walks its N
// samples backward, a overwriting e in place; k[n+1], k[n+2], a[n+1] and
// a[n+2] in registers. The chain is two dependent operations a sample, so
// the loads must run far ahead of it: each thread keeps REC_STAGES ticks
// of its row's e and k in flight (cp.async into its own column of shared
// memory, one commit group a tick) and waits only for the oldest.
__global__ void __launch_bounds__(REC_THREADS)
fm_exact_bwd_rec_kernel(const float* __restrict__ fb_amt, const float* __restrict__ k_in,
                        float* ea, int B, int T) {
  __shared__ float4 s_buf[REC_STAGES][2][BLOCK / 4][REC_THREADS];
  const int lane = threadIdx.x, b = blockIdx.x * blockDim.x + lane;
  if (b >= B || fb_amt[b] == 0.f) return;  // no barrier below: each thread reads its own column
  float4* a4 = reinterpret_cast<float4*>(ea + (size_t)b * T * BLOCK);
  const float4* k4 = reinterpret_cast<const float4*>(k_in + (size_t)b * T * BLOCK);
  // tick t's stage is (T - 1 - t) % REC_STAGES; a group is committed for every
  // step, empty past tick 0, so that waiting on all but the newest
  // REC_STAGES - 1 groups always means the oldest tick has landed
  auto fetch = [&](int t) {
    if (t >= 0) {
      const int st = (T - 1 - t) % REC_STAGES;
#pragma unroll
      for (int q = 0; q < BLOCK / 4; ++q) {
        copy16_async(&s_buf[st][0][q][lane], a4 + (size_t)t * (BLOCK / 4) + q);
        copy16_async(&s_buf[st][1][q][lane], k4 + (size_t)t * (BLOCK / 4) + q);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  for (int i = 0; i < REC_STAGES - 1; ++i) fetch(T - 1 - i);
  float a1 = 0.f, a2 = 0.f, k1 = 0.f, k2 = 0.f;  // a[n+1], a[n+2], k[n+1], k[n+2]
  for (int t = T - 1; t >= 0; --t) {
    fetch(t - (REC_STAGES - 1));
    asm volatile("cp.async.wait_group %0;\n" ::"n"(REC_STAGES - 1));
    const int st = (T - 1 - t) % REC_STAGES;
#pragma unroll
    for (int q = BLOCK / 4 - 1; q >= 0; --q) {
      const float4 ev = s_buf[st][0][q][lane], kv = s_buf[st][1][q][lane];
      float4 r;
      r.w = (ev.w + k2 * a2) + k1 * a1;
      a2 = a1; a1 = r.w; k2 = k1; k1 = kv.w;
      r.z = (ev.z + k2 * a2) + k1 * a1;
      a2 = a1; a1 = r.z; k2 = k1; k1 = kv.z;
      r.y = (ev.y + k2 * a2) + k1 * a1;
      a2 = a1; a1 = r.y; k2 = k1; k1 = kv.y;
      r.x = (ev.x + k2 * a2) + k1 * a1;
      a2 = a1; a1 = r.x; k2 = k1; k1 = kv.x;
      a4[(size_t)t * (BLOCK / 4) + q] = r;
    }
  }
}

// F2b (c): one block per item with feedback (the others exit). From a[n],
// the loop's operators at n, source back to destination: their columns of
// g_amps, g_starts and g_incs, and the feedback gain's cotangent, the
// destination's modulation cotangent times 0.5 (y_src[n-1] + y_src[n-2]).
__global__ void __launch_bounds__(BWD_THREADS)
fm_exact_bwd_loop_kernel(const float* __restrict__ amps, const float* __restrict__ starts,
                         const float* __restrict__ incs, const int* __restrict__ alg,
                         const float* __restrict__ fb_amt, const float* __restrict__ tape,
                         const float* __restrict__ a_in, int B, int T,
                         float* __restrict__ g_amps, float* __restrict__ g_starts,
                         float* __restrict__ g_incs, float* __restrict__ g_fb) {
  __shared__ BwdShared s;
  const int b = blockIdx.x, tid = threadIdx.x, k = tid / BLOCK, lane = tid % BLOCK;
  const float fba = fb_amt[b];
  if (fba == 0.f) return;  // the whole block
  const int a = alg[b];
  const int len = c_alg[a][ALG_LOOP_LEN], loop = c_alg[a][ALG_LOOP_MASK];
  const int ops[3] = {c_alg[a][ALG_LOOP_OPS], c_alg[a][ALG_LOOP_OPS + 1],
                      c_alg[a][ALG_LOOP_OPS + 2]};
  const float sv = (float)(lane + 1), w = sv / (float)BLOCK;
  const size_t row = (size_t)b * T * BLOCK;
  float carry = 0.f, acc_fb = 0.f;
  for (int t0 = 0; t0 < T; t0 += BWD_TICKS) {
    __syncthreads();
    bwd_stage(s, amps, starts, incs, B, T, b, t0, tid);
    __syncthreads();
    const bool valid = t0 + k < T;
    const size_t n = (size_t)(t0 + k) * BLOCK + lane;
    const float y1 = valid && n >= 1 ? tape[row + n - 1] : 0.f;
    const float y2 = valid && n >= 2 ? tape[row + n - 2] : 0.f;
    const float half = 0.5f * (y1 + y2);
    float ly = half * fba, lsn[3], lcs[3], lam[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      lsn[j] = lcs[j] = lam[j] = 0.f;
      if (j < len) {
        const int op = ops[j];
        const float prev = s.amp[k][op];
        lam[j] = prev + (s.amp[k + 1][op] - prev) * w;
        const float ph = s.st[k][op] + s.in[k][op] * sv;
        sincosf(TWO_PI_F * (ph + ly * MOD_SCALE_F), &lsn[j], &lcs[j]);
        ly = lsn[j] * lam[j];
      }
    }
    float g = valid ? a_in[row + n] : 0.f;
#pragma unroll
    for (int j = 2; j >= 0; --j) {
      if (j < len) {  // block-uniform
        const float g_amp = g * lsn[j];
        const float g_u = g * lam[j] * lcs[j] * TWO_PI_F;
        g = g_u * MOD_SCALE_F;
        sample_parts(s, k, lane, ops[j], g_u, g_amp, sv, w);
      }
    }
    acc_fb = acc_fb + g * half;
    __syncthreads();
    tick_sums(s, loop, tid);
    __syncthreads();
    write_ticks(s, loop, B, T, b, t0, tid, carry, g_amps, g_starts, g_incs);
  }
  __syncthreads();
  const float r_fb = block_sum(s, acc_fb, 1, tid);
  if (tid == 0) g_fb[b] = r_fb;
}

static cudaError_t upload_algorithms(cudaStream_t stream) {
  return cudaMemcpyToSymbolAsync(c_alg, h_alg, sizeof(h_alg), 0, cudaMemcpyHostToDevice, stream);
}

extern "C" {

int fm_ctl_width() { return CTL_WIDTH; }
int fm_alg_width() { return ALG_WIDTH; }

// keeps the (32, ALG_WIDTH) algorithm table on the host; each F2 launch
// copies it into constant memory on its stream, so every device gets it
int fm_set_algorithms(const int* table) {
  for (int a = 0; a < 32; ++a)
    for (int k = 0; k < ALG_WIDTH; ++k) h_alg[a][k] = table[ALG_WIDTH * a + k];
  return 0;
}

int fm_control_launch(const float* ctl, int B, int T, int note_off, float fs, float tick_s,
                      float ln10_over_20, float* amps, float* pitch_fact, float* starts,
                      float* incs, cudaStream_t stream) {
  const long threads = (long)B * F1_LANES;
  const int grid = (int)((threads + F1_THREADS - 1) / F1_THREADS);
  fm_control_kernel<<<grid, F1_THREADS, 0, stream>>>(ctl, B, T, note_off, fs, tick_s,
                                                     ln10_over_20, amps, pitch_fact, starts,
                                                     incs);
  return (int)cudaGetLastError();
}

int fm_control_bwd_launch(const float* ctl, int B, int T, int note_off, float fs, float tick_s,
                          float ln10_over_20, const float* g_amps, const float* g_pitch_fact,
                          const float* g_starts, const float* g_incs, float* tape, float* gctl,
                          cudaStream_t stream) {
  const long threads = (long)B * F1_LANES;
  const int grid = (int)((threads + F1_THREADS - 1) / F1_THREADS);
  fm_control_bwd_kernel<<<grid, F1_THREADS, 0, stream>>>(
      ctl, B, T, note_off, fs, tick_s, ln10_over_20, g_amps, g_pitch_fact, g_starts, g_incs,
      reinterpret_cast<float2*>(tape), gctl);
  return (int)cudaGetLastError();
}

int fm_fb_loop_launch(const float* amps, const float* starts, const float* incs, const int* alg,
                      const float* fb_amt, const int* slots, int n_slots, int B, int T, int t0,
                      int t1, float* fb, float* out, cudaStream_t stream) {
  cudaError_t err = upload_algorithms(stream);
  if (err != cudaSuccess) return (int)err;
  const int grid = (n_slots + LOOP_THREADS - 1) / LOOP_THREADS;
  fm_fb_loop_kernel<<<grid, LOOP_THREADS, 0, stream>>>(amps, starts, incs, alg, fb_amt, slots,
                                                       n_slots, B, T, t0, t1,
                                                       reinterpret_cast<float2*>(fb), out);
  return (int)cudaGetLastError();
}

// tape: the loop source's output, or NULL where it is in out
int fm_exact_ff_launch(const float* amps, const float* starts, const float* incs, const int* alg,
                       const float* fb_amt, const float* n_carriers, const float* master_volume,
                       const float* scale, int B, int T, int t_begin, int t_end, const float* tape,
                       float* out, cudaStream_t stream) {
  cudaError_t err = upload_algorithms(stream);
  if (err != cudaSuccess) return (int)err;
  const int n_tblk = (t_end - t_begin + FF_TICKS - 1) / FF_TICKS;
  const long grid = (long)B * n_tblk;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidConfiguration;
  if (tape)
    fm_exact_ff_kernel<true><<<(unsigned)grid, FF_THREADS, 0, stream>>>(
        amps, starts, incs, alg, fb_amt, n_carriers, master_volume, scale, B, T, t_begin, t_end,
        n_tblk, tape, out);
  else
    fm_exact_ff_kernel<false><<<(unsigned)grid, FF_THREADS, 0, stream>>>(
        amps, starts, incs, alg, fb_amt, n_carriers, master_volume, scale, B, T, t_begin, t_end,
        n_tblk, nullptr, out);
  return (int)cudaGetLastError();
}

int fm_exact_bwd_ff_launch(const float* amps, const float* starts, const float* incs,
                           const int* alg, const float* fb_amt, const float* n_carriers,
                           const float* master_volume, const float* scale, const float* tape,
                           const float* g_out, int B, int T, float* e, float* k, float* g_amps,
                           float* g_starts, float* g_incs, float* g_fb, float* g_mv,
                           cudaStream_t stream) {
  cudaError_t err = upload_algorithms(stream);
  if (err != cudaSuccess) return (int)err;
  fm_exact_bwd_ff_kernel<<<B, BWD_THREADS, 0, stream>>>(
      amps, starts, incs, alg, fb_amt, n_carriers, master_volume, scale, tape, g_out, B, T, e, k,
      g_amps, g_starts, g_incs, g_fb, g_mv);
  return (int)cudaGetLastError();
}

int fm_exact_bwd_rec_launch(const float* fb_amt, const float* k, float* ea, int B, int T,
                            cudaStream_t stream) {
  const int grid = (B + REC_THREADS - 1) / REC_THREADS;
  fm_exact_bwd_rec_kernel<<<grid, REC_THREADS, 0, stream>>>(fb_amt, k, ea, B, T);
  return (int)cudaGetLastError();
}

int fm_exact_bwd_loop_launch(const float* amps, const float* starts, const float* incs,
                             const int* alg, const float* fb_amt, const float* tape,
                             const float* a, int B, int T, float* g_amps, float* g_starts,
                             float* g_incs, float* g_fb, cudaStream_t stream) {
  cudaError_t err = upload_algorithms(stream);
  if (err != cudaSuccess) return (int)err;
  fm_exact_bwd_loop_kernel<<<B, BWD_THREADS, 0, stream>>>(
      amps, starts, incs, alg, fb_amt, tape, a, B, T, g_amps, g_starts, g_incs, g_fb);
  return (int)cudaGetLastError();
}

}  // extern "C"
