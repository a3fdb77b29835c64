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
// cannot be run backwards, so F1 under a gradient records it on a tape in
// device memory (each tick's pre-tick EG level and stage, pitch-EG level
// and stage, and the LFO's phase and S&H value after its step, one float2
// a lane and tick). F1b re-derives each tick's branch decisions and values
// from the tape with F1's own operations, on F1's 8 lanes per item, and
// carries the adjoints in reverse; since they are affine in their values
// where a span of ticks begins, the ticks are cut into chunks walked in
// parallel and combined per item; see the note above
// fm_control_bwd_starts_kernel.
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
// contiguous bytes a tick); lane 6 writes pitch_fact (T, B). TAPED (F1
// under a gradient, for F1b) also writes the tape (T, B, 8) float2: lane i
// < 6 its pre-tick EG level and stage, lane 6 the pre-tick pitch-EG level
// and stage and the LFO's phase and S&H value after its step (entries 6
// and 7, one 16-byte store): 64 bytes a tick and item, the state F1b
// re-derives each tick from. The arithmetic is the same in both.
template <bool TAPED>
__global__ void __launch_bounds__(F1_THREADS)
fm_control_kernel(const float* __restrict__ ctl, int B, int T, int note_off, float fs,
                  float tick_s, float ln10_over_20, float* __restrict__ amps,
                  float* __restrict__ pitch_fact, float* __restrict__ starts,
                  float* __restrict__ incs, float2* __restrict__ tape) {
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
    if (TAPED) {
      float2* rec = tape + ((size_t)t * B + b) * F1_LANES;
      if (is_op) rec[op] = make_float2(eg, (float)stage);
      else reinterpret_cast<float4*>(rec)[3] = make_float4(peg, (float)peg_stage, lfo_phase, sh);
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

// F1b, F1's backward (fm_torch.control_pass_vjp), three launches over F1's
// tape. The reverse walk's adjoints are affine in their values where the
// walk enters a span of ticks: a_start (a phase start's adjoint) is a
// suffix sum; a_eg and a_peg (the post-tick EG and pitch-EG levels') pass
// eg_tick_bwd's multiplier (0, 1 or 1 - 0.05) each tick, plus injections;
// a_lfo (the LFO phase's) is a suffix sum; and every gradient accumulator
// adds a term linear in the running adjoints. F1b's outputs are per-item
// totals, so the ticks split into chunks that run in parallel:
//  - fm_control_bwd_starts: thread (chunk, item, operator) sums the chunk's
//    g_starts, latest tick first (a_start entering each chunk is the sum of
//    the later chunks');
//  - fm_control_bwd_chunks: F1's 8 lanes per (item, chunk) walk the
//    chunk's ticks in reverse from zero incoming a_eg, a_peg and a_lfo and
//    the true a_start, re-deriving each tick's branch decisions and values
//    from the tape with F1's own operations; a lane keeps its accumulators
//    (the zero-start run), the product of its multipliers, and the
//    accumulators' sensitivities to the incoming a_eg (operator lanes) or
//    a_peg (every lane), which eg_tick_bwd run on the running product
//    gives; the pitch factor's and the LFO value's adjoints gather every
//    operator's part by warp shuffle each tick;
//  - fm_control_bwd_combine: the 8 lanes of an item walk the chunks from
//    the last, carrying the incoming adjoints, and write the gradient row.
// One chunk is the serial walk. Bound: the chunks' walks, ~540 operations a
// tick and item on 8 lanes with transcendental functions on the dependent
// path, over many more warps than items; the bytes are the cotangents and
// the tape, read once.
#define F1B_SUM 24  // floats of a lane's chunk summary (F1B_SUM / 4 float4 stores)

__global__ void fm_control_bwd_starts_kernel(const float* __restrict__ g_starts, int B, int T,
                                             int n_chunk, int chunk_ticks,
                                             float* __restrict__ sums) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long row = (long)B * N_OPS;
  if (i >= n_chunk * row) return;
  const int c = (int)(i / row);
  const int tb = c * chunk_ticks, te = min(T, tb + chunk_ticks);
  float s = 0.f;
  for (int t = te - 1; t >= tb; --t) s = s + g_starts[(size_t)t * row + i % row];
  sums[i] = s;
}

// lane layout of a chunk summary (operator lanes / lane 6): 0-3 the target
// (pitch-EG target) gradients of the zero-start run, 4-7 the slews', 8-11
// and 12-15 their sensitivities to the incoming a_eg (a_peg); 16 g_gain
// (g_hz), 17 g_ams (the g_hz sensitivity to the incoming a_lfo), 18 g_freq
// (g_delay), 19 g_amd (g_pmd), 20 a_eg (a_peg) leaving the chunk from a
// zero start, 21 the product of the multipliers; lane 6: 22 a_lfo leaving
// the chunk from a zero start, 23 g_pms
__global__ void __launch_bounds__(F1_THREADS)
fm_control_bwd_chunks_kernel(const float* __restrict__ ctl, int B, int T, int note_off,
                             float fs, float tick_s, float ln10_over_20,
                             const float* __restrict__ g_amps,
                             const float* __restrict__ g_pitch_fact,
                             const float* __restrict__ g_starts, const float* __restrict__ g_incs,
                             const float2* __restrict__ tape,
                             const float* __restrict__ start_sums, int n_chunk, int chunk_ticks,
                             float* __restrict__ summ) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = g % F1_LANES, ic = g / F1_LANES;  // ic = chunk * B + item
  const bool valid = ic < n_chunk * B;
  const int c = valid ? ic / B : 0, b = valid ? ic % B : B - 1;
  const int tb = c * chunk_ticks, te = min(T, tb + chunk_ticks);
  const float* cr = ctl + (size_t)b * CTL_WIDTH;
  const bool is_op = lane < N_OPS;
  const int k_op = is_op ? lane : 0;  // lanes 6 and 7 read operator 0's row and never use it
  float targets[4], slews[4], peg_targets[4], peg_slews[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    targets[k] = cr[CTL_TARGETS + 4 * k_op + k];
    slews[k] = cr[CTL_SLEWS + 4 * k_op + k];
    peg_targets[k] = cr[CTL_PEG_TARGETS + k];
    peg_slews[k] = cr[CTL_PEG_SLEWS + k];
  }
  const float gain = cr[CTL_OP_GAIN_DB + k_op], ams = cr[CTL_AMS_DB + k_op];
  const float freq = cr[CTL_FREQS + k_op];
  const bool on = cr[CTL_ON + k_op] > 0.f;
  const float lfo_delay_s = cr[CTL_LFO_DELAY_S];
  const float pmd = cr[CTL_PMD], amd = cr[CTL_AMD], pms = cr[CTL_PMS];
  const int wave = (int)cr[CTL_LFO_WAVE];

  // a_start entering the chunk: the later chunks' sums, the last first
  float a_start = 0.f;
  if (valid && is_op)
    for (int cc = n_chunk - 1; cc > c; --cc)
      a_start = a_start + start_sums[((size_t)cc * B + b) * N_OPS + lane];
  // the adjoints of the post-tick EG level (a_eg), pitch-EG level (a_peg)
  // and LFO phase (a_lfo) from a zero start, the products of the EG and
  // pitch-EG multipliers (pm, pmp), and the sums
  float a_eg = 0.f, a_peg = 0.f, a_lfo = 0.f, pm = 1.f, pmp = 1.f, s_hz = 0.f;
  float g_targets[4] = {0.f, 0.f, 0.f, 0.f}, g_slews[4] = {0.f, 0.f, 0.f, 0.f};
  float s_targets[4] = {0.f, 0.f, 0.f, 0.f}, s_slews[4] = {0.f, 0.f, 0.f, 0.f};
  float g_peg_targets[4] = {0.f, 0.f, 0.f, 0.f}, g_peg_slews[4] = {0.f, 0.f, 0.f, 0.f};
  float sp_targets[4] = {0.f, 0.f, 0.f, 0.f}, sp_slews[4] = {0.f, 0.f, 0.f, 0.f};
  float g_gain = 0.f, g_ams = 0.f, g_freq = 0.f, g_amd = 0.f;
  float g_hz = 0.f, g_delay = 0.f, g_pmd = 0.f, g_pms = 0.f;
  // this lane's tape entry and cotangents of tick t, loaded a tick ahead
  auto load = [&](int t, float2& rec, float& ga, float& gs, float& gi) {
    rec = make_float2(0.f, 0.f);
    ga = gs = gi = 0.f;
    if (!valid || t < tb) return;
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
  load(te - 1, rec, ga, gs, gi);
  // every lane of the warp takes chunk_ticks steps, so that the shuffles
  // see full warps; a step before the chunk (the last chunk is shorter)
  // changes nothing
  for (int j = 0; j < chunk_ticks; ++j) {
    const int t = te - 1 - j;
    const bool act = valid && t >= tb;
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
    if (act && is_op) {
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
      pm = eg_tick_bwd(eg_pre, stage, targets, slews, off, pm, s_targets, s_slews);
    } else if (act && lane == N_OPS) {
      c_pf = ga;
    }
    c_pf = lanes_sum(c_pf);
    c_lfo = lanes_sum(c_lfo);
    if (act) {
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
      s_hz = s_hz + tick_s;
      a_peg = eg_tick_bwd(peg_pre, peg_stage, peg_targets, peg_slews, off, a_peg, g_peg_targets,
                          g_peg_slews);
      pmp = eg_tick_bwd(peg_pre, peg_stage, peg_targets, peg_slews, off, pmp, sp_targets,
                        sp_slews);
    }
    rec = rec_n;
    ga = ga_n;
    gs = gs_n;
    gi = gi_n;
  }
  if (!valid || lane > N_OPS) return;
  float v[F1B_SUM];
  const bool op_lane = is_op;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = op_lane ? g_targets[k] : g_peg_targets[k];
    v[4 + k] = op_lane ? g_slews[k] : g_peg_slews[k];
    v[8 + k] = op_lane ? s_targets[k] : sp_targets[k];
    v[12 + k] = op_lane ? s_slews[k] : sp_slews[k];
  }
  v[16] = op_lane ? g_gain : g_hz;
  v[17] = op_lane ? g_ams : s_hz;
  v[18] = op_lane ? g_freq : g_delay;
  v[19] = op_lane ? g_amd : g_pmd;
  v[20] = op_lane ? a_eg : a_peg;
  v[21] = op_lane ? pm : pmp;
  v[22] = op_lane ? 0.f : a_lfo;
  v[23] = op_lane ? 0.f : g_pms;
  float4* out = reinterpret_cast<float4*>(summ + ((size_t)ic * F1_LANES + lane) * F1B_SUM);
#pragma unroll
  for (int q = 0; q < F1B_SUM / 4; ++q)
    out[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// F1b (3): the 8 lanes of an item walk its chunks from the last, the
// incoming adjoints (operator lane: a_eg; lane 6: a_peg and a_lfo) starting
// at 0; each chunk adds its zero-start sums plus its sensitivities times the
// incoming adjoints, and passes them on through its products. Writes every
// column of the item's gradient row.
__global__ void __launch_bounds__(F1_THREADS)
fm_control_bwd_combine_kernel(int B, int n_chunk, const float* __restrict__ summ,
                              float* __restrict__ gctl) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = g % F1_LANES;
  const bool valid = g / F1_LANES < B;
  const int b = valid ? g / F1_LANES : B - 1;
  const bool use = valid && lane <= N_OPS;
  const bool is_op = lane < N_OPS;
  float tot[F1B_SUM];
#pragma unroll
  for (int k = 0; k < F1B_SUM; ++k) tot[k] = 0.f;
  float a = 0.f, a_lfo = 0.f;  // a_eg (operator lanes) or a_peg (lane 6), and a_lfo
  auto at = [&](int c) {
    return reinterpret_cast<const float4*>(summ + (((size_t)c * B + b) * F1_LANES + lane) *
                                                      F1B_SUM);
  };
  float4 nxt[F1B_SUM / 4];
#pragma unroll
  for (int q = 0; q < F1B_SUM / 4; ++q)
    nxt[q] = use ? at(n_chunk - 1)[q] : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = n_chunk - 1; c >= 0; --c) {
    float v[F1B_SUM];
#pragma unroll
    for (int q = 0; q < F1B_SUM / 4; ++q) {
      v[4 * q] = nxt[q].x;
      v[4 * q + 1] = nxt[q].y;
      v[4 * q + 2] = nxt[q].z;
      v[4 * q + 3] = nxt[q].w;
    }
    if (use && c > 0) {  // the next chunk's summary, loaded a chunk ahead
#pragma unroll
      for (int q = 0; q < F1B_SUM / 4; ++q) nxt[q] = at(c - 1)[q];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) tot[k] = tot[k] + (v[k] + v[8 + k] * a);
    if (is_op) {
#pragma unroll
      for (int k = 16; k < 20; ++k) tot[k] = tot[k] + v[k];
    } else {
      tot[16] = tot[16] + (v[16] + v[17] * a_lfo);
      tot[18] = tot[18] + v[18];
      tot[19] = tot[19] + v[19];
      tot[23] = tot[23] + v[23];
      a_lfo = a_lfo + v[22];
    }
    a = v[21] * a + v[20];
  }
  const float g_amd = lanes_sum(use && is_op ? tot[19] : 0.f);
  if (!use) return;
  float* gc = gctl + (size_t)b * CTL_WIDTH;
  if (is_op) {
    gc[CTL_OP_GAIN_DB + lane] = tot[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gc[CTL_TARGETS + 4 * lane + k] = tot[k];
      gc[CTL_SLEWS + 4 * lane + k] = tot[4 + k];
    }
    gc[CTL_EG0 + lane] = a;
    gc[CTL_AMS_DB + lane] = tot[17];
    gc[CTL_ON + lane] = 0.f;  // a switch: no gradient
    gc[CTL_FREQS + lane] = tot[18];
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gc[CTL_PEG_TARGETS + k] = tot[k];
      gc[CTL_PEG_SLEWS + k] = tot[4 + k];
    }
    gc[CTL_PEG0] = a;
    gc[CTL_LFO_HZ] = tot[16];
    gc[CTL_LFO_PHASE0] = a_lfo;
    gc[CTL_LFO_DELAY_S] = tot[18];
    gc[CTL_PMD] = tot[19];
    gc[CTL_AMD] = g_amd;
    gc[CTL_PMS] = tot[23];
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
// operators at sample m. In the state T[n] = (k[n] a[n], k[n+1] a[n+1])
// (zero past the end) a sample is the affine step
//   a[n] = (e[n] + T[n+1].y) + T[n+1].x,  T[n] = (k[n] a[n], T[n+1].x),
// which needs e and k of its own sample only, so a tick's 32 samples make
// one affine map T[32 t] = A_t T[32 t + 32] + b_t, and the recurrence is a
// scan over ticks. An item's ticks are cut into splits of whole 8-tick
// steps, a block per (item, split) in two of three launches on the
// caller's stream:
//  - fm_exact_bwd_ff (a): walks its ticks 8 at a time, one sample a
//    thread; recomputes the operators off the loop (the source read from
//    the tape), backpropagates through the fade, the clip (half the
//    gradient at a tie, as jnp.clip), the volume, the carrier sum and the
//    off-loop operators from low to high, and writes e and those
//    operators' per-tick sums. On an item with feedback it also computes
//    k, and 8 lanes walk the step's 8 ticks from the tick's end to make
//    each tick's map (A_t, b_t); at the end the block composes the
//    split's tick maps into the split's map as a tree (a thread's run of
//    ticks in time order, then pairs), the product's entries renormalised
//    by a power of two at each composition (a loud loop's product leaves
//    float32's range where the recurrence's values do not);
//  - fm_exact_bwd_loop (b), on the items with feedback: the split's
//    incoming state from the later splits' maps, then its steps from the
//    last: the loop's 1-3 operators and k recomputed at each sample, each
//    tick's incoming state chained through the tick maps, 8 lanes walking
//    the 8 ticks to give a[n], and from a[n] the loop operators'
//    cotangents and the feedback gain's;
//  - fm_exact_bwd_seams (c): a warp per item adds the splits' partial sums
//    of the gain's and the volume's cotangents, and the amplitude
//    cotangents that the ticks before the splits take from the splits'
//    first ticks.
// Per-tick sums: g_starts[t] = sum_s g_ph, g_incs[t] = sum_s s g_ph; a
// sample's amplitude cotangent goes w_s to amps[t] and 1 - w_s to
// amps[t-1], so a tick's amps cotangent is its own share plus the next
// tick's. Each sample leaves its four parts per operator in shared memory
// and one thread per (tick, operator, sum) adds a tick's 32 in order; a
// block carries the share across its steps, and leaves the share of its
// split's first tick in a seam: no atomics. Bound: (a) and (b) by their
// f32 operations and sines (the forward recomputed), with the splits
// giving enough blocks at any batch; the recurrence's serial parts are
// 32-sample walks on 8 lanes per step and a chain over the splits.
#define BWD_TICKS 8
#define BWD_THREADS (BWD_TICKS * BLOCK)
#define BWD_SUMS 4       // per tick and operator: sum g_ph, sum s g_ph, sum w g_amp, sum (1-w) g_amp
#define MAP_WARP 6       // the warp whose lanes 0-7 walk the step's ticks
#define MAX_SPLITS 256   // splits of an item's ticks (fm_torch.exact_bwd_splits)

struct BwdShared {
  float amp[BWD_TICKS + 1][N_OPS], st[BWD_TICKS][N_OPS], in[BWD_TICKS][N_OPS];
  // each sample's parts of the per-tick sums, row k * 24 + 4 i + c for tick k,
  // operator i and sum c (padded: a reducing thread's 32 reads hit 32 banks)
  float part[BWD_TICKS * N_OPS * BWD_SUMS][BLOCK + 1];
  float tick[BWD_SUMS][BWD_TICKS][N_OPS];  // the sums
  float red[BWD_TICKS][2];
  // e[n] (then a[n]) and k[n] of the step's samples, a tick a row (padded:
  // the 8 walking lanes read 8 banks)
  float ea[BWD_TICKS][BLOCK + 1], kk[BWD_TICKS][BLOCK + 1];
  float4 map_a[BWD_TICKS];  // the step's tick maps: A_t (row-major) and b_t
  float2 map_b[BWD_TICKS], tin[BWD_TICKS];  // and the state entering each tick
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// [tb, te): split s's ticks; splits are whole 8-tick steps but the last
__device__ __forceinline__ void split_ticks(int s, int n_split, int T, int& tb, int& te) {
  const int steps = (T + BWD_TICKS - 1) / BWD_TICKS;
  const int per = (steps + n_split - 1) / n_split;
  tb = min(T, s * per * BWD_TICKS);
  te = min(T, (s + 1) * per * BWD_TICKS);
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

// the loop's operators at the sample of tick k and lane sv - 1, from its
// input half * fba, as fm_fb_loop runs them: their sines, cosines and
// amplitudes, and the loop's derivative by its input, d (k[n] = 0.5 fba d)
__device__ __forceinline__ float loop_forward(const BwdShared& s, int k, float sv, float w,
                                              const int* ops, int len, float half, float fba,
                                              float* lsn, float* lcs, float* lam) {
  float ly = half * fba, d = 1.f;
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
      d = d * (lam[j] * lcs[j] * TWO_PI_F * MOD_SCALE_F);
    }
  }
  return d;
}

// one operator's output and its sine's parts at sample sv - 1 of staged tick
// k (fm_exact_ff's arithmetic); mod is its modulation
__device__ __forceinline__ float op_forward(const BwdShared& s, int k, int i, float sv, float w,
                                            float mod, float& sn, float& cs, float& am) {
  const float prev = s.amp[k][i];
  am = prev + (s.amp[k + 1][i] - prev) * w;
  const float ph = s.st[k][i] + s.in[k][i] * sv;
  sincosf(TWO_PI_F * (ph + mod * MOD_SCALE_F), &sn, &cs);
  return sn * am;
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

// writes the step's ticks t0 .. t0+7 (below te) of the operators in own:
// threads 0-47 a (tick, operator) each: g_starts, g_incs, and g_amps of
// the ticks whose next tick is in the step or past the split (own share +
// the next tick's, or the own share alone at the split's end: the next
// split's share is its seam). Threads 48-53, one per operator, the step's
// edges: REVERSE false (steps in time order): tick t0 - 1 takes the carry
// (the previous step's last own share) + tick t0's share, tick t0 + 7
// leaves its own share in carry; REVERSE true (steps from the last): tick
// t0 + 7 takes its own share + the carry (the next step's first tick's
// share), tick t0 leaves its share in carry. At the split's first tick the
// share goes to the seam.
template <bool REVERSE>
__device__ __forceinline__ void write_ticks(const BwdShared& s, int own, int B, int tb, int te,
                                            int b, int t0, int tid, float& carry,
                                            float* __restrict__ g_amps,
                                            float* __restrict__ g_starts,
                                            float* __restrict__ g_incs, float* __restrict__ seam) {
  if (tid < BWD_TICKS * N_OPS) {
    const int k = tid / N_OPS, i = tid % N_OPS, t = t0 + k;
    if (((own >> i) & 1) && t < te) {
      const size_t at = ((size_t)t * B + b) * N_OPS + i;
      g_starts[at] = s.tick[0][k][i];
      g_incs[at] = s.tick[1][k][i];
      if (k < BWD_TICKS - 1)
        g_amps[at] = t + 1 < te ? s.tick[2][k][i] + s.tick[3][k + 1][i] : s.tick[2][k][i];
    }
  } else if (tid < (BWD_TICKS + 1) * N_OPS) {
    const int i = tid - BWD_TICKS * N_OPS, t = t0 + BWD_TICKS - 1;
    if ((own >> i) & 1) {
      if (REVERSE) {
        if (t < te)
          g_amps[((size_t)t * B + b) * N_OPS + i] =
              t + 1 < te ? s.tick[2][BWD_TICKS - 1][i] + carry : s.tick[2][BWD_TICKS - 1][i];
        if (t0 > tb) carry = s.tick[3][0][i];
        else seam[i] = s.tick[3][0][i];
      } else {
        if (t0 > tb) g_amps[((size_t)(t0 - 1) * B + b) * N_OPS + i] = carry + s.tick[3][0][i];
        else seam[i] = s.tick[3][0][i];
        if (t + 1 < te) carry = s.tick[2][BWD_TICKS - 1][i];
        else if (t < te) g_amps[((size_t)t * B + b) * N_OPS + i] = s.tick[2][BWD_TICKS - 1][i];
      }
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

// ldexpf of a 2x2 matrix's four entries
__device__ __forceinline__ float4 scale4(float4 m, int e) {
  return make_float4(ldexpf(m.x, e), ldexpf(m.y, e), ldexpf(m.z, e), ldexpf(m.w, e));
}

// an affine map of the recurrence's state over a span of ticks, x at the
// span's end -> 2^ex p x + q at its start (p row-major)
struct SpanMap {
  float4 p;
  float2 q;
  int ex;
};

__device__ __forceinline__ SpanMap identity_map() {
  return {make_float4(1.f, 0.f, 0.f, 1.f), make_float2(0.f, 0.f), 0};
}

// the span of u followed by the later span of v: 2^eu pu (2^ev pv x + qv)
// + qu; the product's entries renormalised to [0.5, 1) by a power of two
__device__ __forceinline__ SpanMap compose(const SpanMap& u, const SpanMap& v) {
  SpanMap r;
  r.q = make_float2(ldexpf(u.p.x * v.q.x + u.p.y * v.q.y, u.ex) + u.q.x,
                    ldexpf(u.p.z * v.q.x + u.p.w * v.q.y, u.ex) + u.q.y);
  r.p = make_float4(u.p.x * v.p.x + u.p.y * v.p.z, u.p.x * v.p.y + u.p.y * v.p.w,
                    u.p.z * v.p.x + u.p.w * v.p.z, u.p.z * v.p.y + u.p.w * v.p.w);
  r.ex = u.ex + v.ex;
  const float big = fmaxf(fmaxf(fabsf(r.p.x), fabsf(r.p.y)), fmaxf(fabsf(r.p.z), fabsf(r.p.w)));
  if (big > 0.f && isfinite(big)) {
    int e2;
    frexpf(big, &e2);
    r.p = scale4(r.p, -e2);
    r.ex += e2;
  }
  return r;
}

// F2b (a): block (item, split). Writes the off-loop operators' columns of
// g_amps, g_starts and g_incs, the split's partial g_mv, and for an item
// with feedback e[n], its tick maps and the split's map; for an item
// without feedback (every operator off the loop) the split's partial g_fb:
// the destination's modulation cotangent times the source's half sum of
// its two previous outputs, the term that meets a zero gain. Four blocks
// an SM (the register cap): the kernel is bound by its instruction
// throughput.
__global__ void __launch_bounds__(BWD_THREADS, 4)
fm_exact_bwd_ff_kernel(const float* __restrict__ amps, const float* __restrict__ starts,
                       const float* __restrict__ incs, const int* __restrict__ alg,
                       const float* __restrict__ fb_amt, const float* __restrict__ n_carriers,
                       const float* __restrict__ master_volume, const float* __restrict__ scale,
                       const float* __restrict__ tape, const float* __restrict__ g_out, int B,
                       int T, int n_split, float* __restrict__ e_out,
                       float4* __restrict__ tick_a, float2* __restrict__ tick_b,
                       float4* __restrict__ split_a, float4* __restrict__ split_b,
                       float* __restrict__ g_amps, float* __restrict__ g_starts,
                       float* __restrict__ g_incs, float* __restrict__ seam,
                       float* __restrict__ part_mv, float* __restrict__ part_fb) {
  __shared__ BwdShared s;
  __shared__ float s_y[BWD_THREADS + 2];  // y_src of the step, after the last two of the previous
  const int b = blockIdx.x / n_split, sp = blockIdx.x % n_split;
  const int tid = threadIdx.x, k = tid / BLOCK, lane = tid % BLOCK;
  int tb, te;
  split_ticks(sp, n_split, T, tb, te);
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
  // y_src of the two samples before the split: the tape's on an item with
  // feedback, else the forward of the tick before, staged as a step
  if (tb > 0 && !on) {
    bwd_stage(s, amps, starts, incs, B, T, b, tb - BWD_TICKS, tid);
    __syncthreads();
    if (tid >= BWD_THREADS - 2) {
      float y[N_OPS], sn, cs, am;
#pragma unroll
      for (int i = N_OPS - 1; i >= 0; --i) {
        float mod = 0.f;
#pragma unroll
        for (int m = i + 1; m < N_OPS; ++m)
          if ((mods[i] >> m) & 1) mod = mod + y[m];
        y[i] = op_forward(s, BWD_TICKS - 1, i, sv, w, mod, sn, cs, am);
      }
      s_y[tid - (BWD_THREADS - 2)] = y[fb_src];
    }
  } else if (tid < 2) {
    const int n = tb * BLOCK - 2 + tid;
    s_y[tid] = tb > 0 ? tape[row + n] : 0.f;
  }
  for (int t0 = tb; t0 < te; t0 += BWD_TICKS) {
    __syncthreads();  // the previous step is done with s
    bwd_stage(s, amps, starts, incs, B, T, b, t0, tid);
    __syncthreads();
    const bool valid = t0 + k < te;
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
        y[i] = op_forward(s, k, i, sv, w, mod, sn[i], cs[i], am[i]);
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
    __syncthreads();  // the parts and s_y are written
    const float half = 0.5f * (s_y[tid + 1] + s_y[tid]);
    __syncwarp();
    if (tid < 2) s_y[tid] = s_y[BWD_THREADS + tid];  // the next step's previous two
    if (!on) {
      acc_fb = acc_fb + g_dst * half;
    } else {
      float lsn[3], lcs[3], lam[3];
      const float d = loop_forward(s, k, sv, w, ops, len, half, fba, lsn, lcs, lam);
      s.kk[k][lane] = valid ? d * fba * 0.5f : 0.f;
      s.ea[k][lane] = valid ? e_n : 0.f;
      if (valid) e_out[row + n] = e_n;
    }
    tick_sums(s, ~loop & 63, tid);
    __syncthreads();  // the tick sums, e and k are in s
    write_ticks<false>(s, ~loop & 63, B, tb, te, b, t0, tid, carry, g_amps, g_starts, g_incs,
                       seam + ((size_t)sp * B + b) * N_OPS);
    if (on && k == MAP_WARP && lane < BWD_TICKS && t0 + lane < te) {
      // lane j < 8: tick t0 + j's map, its 32 samples walked from the end
      float4 p = make_float4(1.f, 0.f, 0.f, 1.f);
      float2 q2 = make_float2(0.f, 0.f);
      for (int i = BLOCK - 1; i >= 0; --i) {
        const float kv = s.kk[lane][i];
        const float h0 = p.z + p.x, h1 = p.w + p.y;
        p = make_float4(kv * h0, kv * h1, p.x, p.y);
        const float r = (s.ea[lane][i] + q2.y) + q2.x;
        q2 = make_float2(kv * r, q2.x);
      }
      const size_t at = (size_t)(t0 + lane) * B + b;
      tick_a[at] = p;
      tick_b[at] = q2;
    }
  }
  __syncthreads();
  const float r_mv = block_sum(s, acc_mv, 0, tid);
  const float r_fb = block_sum(s, acc_fb, 1, tid);
  const size_t at = (size_t)sp * B + b;
  if (tid == 0) {
    part_mv[at] = r_mv;
    if (!on) part_fb[at] = r_fb;
  }
  if (!on) return;  // the whole block
  // the split's map: thread i composes its run of the split's ticks in
  // time order, then the runs compose in pairs (this block wrote the tick
  // maps, and the barriers make them visible to every thread of it)
  static_assert(sizeof(BwdShared) >= BWD_THREADS * sizeof(SpanMap), "the tree's slots");
  SpanMap* tree = reinterpret_cast<SpanMap*>(&s);
  const int per = (te - tb + BWD_THREADS - 1) / BWD_THREADS;
  SpanMap m = identity_map();
  for (int t = tb + tid * per; t < min(te, tb + (tid + 1) * per); ++t) {
    const SpanMap tick = {tick_a[(size_t)t * B + b], tick_b[(size_t)t * B + b], 0};
    m = compose(m, tick);
  }
  __syncthreads();  // every thread is done with s
  tree[tid] = m;
  for (int w = 1; w < BWD_THREADS; w *= 2) {
    __syncthreads();
    if (tid % (2 * w) == 0) tree[tid] = compose(tree[tid], tree[tid + w]);
  }
  if (tid == 0) {
    split_a[at] = tree[0].p;
    split_b[at] = make_float4(tree[0].q.x, tree[0].q.y, (float)tree[0].ex, 0.f);
  }
}

// F2b (b): block (item with feedback, split); the others exit. The split's
// incoming state from the later splits' maps; then its steps from the last:
// each tick's incoming state through the tick maps, a[n] by 8 lanes walking
// the step's ticks, and from a[n] the loop's operators at n, source back to
// destination: their columns of g_amps, g_starts and g_incs, and the split's
// partial feedback-gain cotangent, the destination's modulation cotangent
// times 0.5 (y_src[n-1] + y_src[n-2]).
__global__ void __launch_bounds__(BWD_THREADS)
fm_exact_bwd_loop_kernel(const float* __restrict__ amps, const float* __restrict__ starts,
                         const float* __restrict__ incs, const int* __restrict__ alg,
                         const float* __restrict__ fb_amt, const float* __restrict__ tape,
                         const float* __restrict__ e_in, const float4* __restrict__ tick_a,
                         const float2* __restrict__ tick_b, const float4* __restrict__ split_a,
                         const float4* __restrict__ split_b, int B, int T, int n_split,
                         float* __restrict__ g_amps, float* __restrict__ g_starts,
                         float* __restrict__ g_incs, float* __restrict__ seam,
                         float* __restrict__ part_fb) {
  __shared__ BwdShared s;
  __shared__ float4 s_split[2][MAX_SPLITS];
  __shared__ float2 s_state;
  const int b = blockIdx.x / n_split, sp = blockIdx.x % n_split;
  const int tid = threadIdx.x, k = tid / BLOCK, lane = tid % BLOCK;
  const float fba = fb_amt[b];
  if (fba == 0.f) return;  // the whole block
  int tb, te;
  split_ticks(sp, n_split, T, tb, te);
  const int a = alg[b];
  const int len = c_alg[a][ALG_LOOP_LEN], loop = c_alg[a][ALG_LOOP_MASK];
  const int ops[3] = {c_alg[a][ALG_LOOP_OPS], c_alg[a][ALG_LOOP_OPS + 1],
                      c_alg[a][ALG_LOOP_OPS + 2]};
  const float sv = (float)(lane + 1), w = sv / (float)BLOCK;
  const size_t row = (size_t)b * T * BLOCK;
  // the state entering the split: zero past the end, through the later
  // splits' maps from the last
  for (int j = sp + 1 + tid; j < n_split; j += BWD_THREADS) {
    s_split[0][j] = split_a[(size_t)j * B + b];
    s_split[1][j] = split_b[(size_t)j * B + b];
  }
  __syncthreads();
  if (tid == 0) {
    float2 x = make_float2(0.f, 0.f);
    for (int j = n_split - 1; j > sp; --j) {
      const float4 m = s_split[0][j], c = s_split[1][j];
      const int e2 = (int)c.z;
      x = make_float2(ldexpf(m.x * x.x + m.y * x.y, e2) + c.x,
                      ldexpf(m.z * x.x + m.w * x.y, e2) + c.y);
    }
    s_state = x;
  }
  float carry = 0.f, acc_fb = 0.f;
  for (int t0 = tb + (te - 1 - tb) / BWD_TICKS * BWD_TICKS; t0 >= tb; t0 -= BWD_TICKS) {
    __syncthreads();
    bwd_stage(s, amps, starts, incs, B, T, b, t0, tid);
    if (tid < BWD_TICKS && t0 + tid < te) {
      s.map_a[tid] = tick_a[(size_t)(t0 + tid) * B + b];
      s.map_b[tid] = tick_b[(size_t)(t0 + tid) * B + b];
    }
    __syncthreads();
    const bool valid = t0 + k < te;
    const size_t n = (size_t)(t0 + k) * BLOCK + lane;
    const float y1 = valid && n >= 1 ? tape[row + n - 1] : 0.f;
    const float y2 = valid && n >= 2 ? tape[row + n - 2] : 0.f;
    const float half = 0.5f * (y1 + y2);
    float lsn[3], lcs[3], lam[3];
    const float d = loop_forward(s, k, sv, w, ops, len, half, fba, lsn, lcs, lam);
    s.kk[k][lane] = valid ? d * fba * 0.5f : 0.f;
    s.ea[k][lane] = valid ? e_in[row + n] : 0.f;
    __syncthreads();  // e and k are in s
    if (k == MAP_WARP) {
      if (lane == 0) {
        // the state entering each tick of the step, from the step's end
        float2 x = s_state;
        for (int j = BWD_TICKS - 1; j >= 0; --j) {
          if (t0 + j >= te) continue;
          s.tin[j] = x;
          const float4 m = s.map_a[j];
          const float2 c = s.map_b[j];
          x = make_float2((m.x * x.x + m.y * x.y) + c.x, (m.z * x.x + m.w * x.y) + c.y);
        }
        s_state = x;
      }
      __syncwarp();
      if (lane < BWD_TICKS && t0 + lane < te) {
        // a[n] over the tick, from its incoming state, over e in place
        float2 x = s.tin[lane];
        for (int i = BLOCK - 1; i >= 0; --i) {
          const float r = (s.ea[lane][i] + x.y) + x.x;
          s.ea[lane][i] = r;
          x = make_float2(s.kk[lane][i] * r, x.x);
        }
      }
    }
    __syncthreads();  // a is in s
    float g = valid ? s.ea[k][lane] : 0.f;
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
    write_ticks<true>(s, loop, B, tb, te, b, t0, tid, carry, g_amps, g_starts, g_incs,
                      seam + ((size_t)sp * B + b) * N_OPS);
  }
  __syncthreads();
  const float r_fb = block_sum(s, acc_fb, 1, tid);
  if (tid == 0) part_fb[(size_t)sp * B + b] = r_fb;
}

// F2b (c): a warp per item: g_mv and g_fb, the sums of the splits'
// partials; the seams, each split's first tick's share of the tick before
// it, added into g_amps
__global__ void __launch_bounds__(BLOCK)
fm_exact_bwd_seams_kernel(int B, int T, int n_split, const float* __restrict__ seam,
                          const float* __restrict__ part_mv, const float* __restrict__ part_fb,
                          float* __restrict__ g_amps, float* __restrict__ g_fb,
                          float* __restrict__ g_mv) {
  const int b = blockIdx.x, lane = threadIdx.x;
  float mv = 0.f, fb = 0.f;
  for (int j = lane; j < n_split; j += BLOCK) {
    mv = mv + part_mv[(size_t)j * B + b];
    fb = fb + part_fb[(size_t)j * B + b];
  }
  mv = warp_sum(mv);
  fb = warp_sum(fb);
  if (lane == 0) {
    g_mv[b] = mv;
    g_fb[b] = fb;
  }
  for (int j = lane; j < (n_split - 1) * N_OPS; j += BLOCK) {
    const int sp = 1 + j / N_OPS, i = j % N_OPS;
    int tb, te;
    split_ticks(sp, n_split, T, tb, te);
    g_amps[((size_t)(tb - 1) * B + b) * N_OPS + i] += seam[((size_t)sp * B + b) * N_OPS + i];
  }
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

// tape: F1b's (T, B, 8) float2 state tape, or NULL (no gradient: nothing taped)
int fm_control_launch(const float* ctl, int B, int T, int note_off, float fs, float tick_s,
                      float ln10_over_20, float* amps, float* pitch_fact, float* starts,
                      float* incs, float* tape, cudaStream_t stream) {
  const long threads = (long)B * F1_LANES;
  const int grid = (int)((threads + F1_THREADS - 1) / F1_THREADS);
  if (tape)
    fm_control_kernel<true><<<grid, F1_THREADS, 0, stream>>>(
        ctl, B, T, note_off, fs, tick_s, ln10_over_20, amps, pitch_fact, starts, incs,
        reinterpret_cast<float2*>(tape));
  else
    fm_control_kernel<false><<<grid, F1_THREADS, 0, stream>>>(
        ctl, B, T, note_off, fs, tick_s, ln10_over_20, amps, pitch_fact, starts, incs, nullptr);
  return (int)cudaGetLastError();
}

int fm_control_bwd_starts_launch(const float* g_starts, int B, int T, int n_chunk,
                                 int chunk_ticks, float* sums, cudaStream_t stream) {
  const long threads = (long)n_chunk * B * N_OPS;
  const long grid = (threads + 255) / 256;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidConfiguration;
  fm_control_bwd_starts_kernel<<<(unsigned)grid, 256, 0, stream>>>(g_starts, B, T, n_chunk,
                                                                     chunk_ticks, sums);
  return (int)cudaGetLastError();
}

int fm_control_bwd_chunks_launch(const float* ctl, int B, int T, int note_off, float fs,
                                 float tick_s, float ln10_over_20, const float* g_amps,
                                 const float* g_pitch_fact, const float* g_starts,
                                 const float* g_incs, const float* tape, const float* sums,
                                 int n_chunk, int chunk_ticks, float* summ, cudaStream_t stream) {
  const long threads = (long)n_chunk * B * F1_LANES;
  const long grid = (threads + F1_THREADS - 1) / F1_THREADS;
  if (grid > 0x7fffffffL) return (int)cudaErrorInvalidConfiguration;
  fm_control_bwd_chunks_kernel<<<(unsigned)grid, F1_THREADS, 0, stream>>>(
      ctl, B, T, note_off, fs, tick_s, ln10_over_20, g_amps, g_pitch_fact, g_starts, g_incs,
      reinterpret_cast<const float2*>(tape), sums, n_chunk, chunk_ticks, summ);
  return (int)cudaGetLastError();
}

int fm_control_bwd_combine_launch(int B, int n_chunk, const float* summ, float* gctl,
                                  cudaStream_t stream) {
  const long threads = (long)B * F1_LANES;
  const int grid = (int)((threads + F1_THREADS - 1) / F1_THREADS);
  fm_control_bwd_combine_kernel<<<grid, F1_THREADS, 0, stream>>>(B, n_chunk, summ, gctl);
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
                           const float* g_out, int B, int T, int n_split, float* e,
                           float* tick_a, float* tick_b, float* split_a, float* split_b,
                           float* g_amps, float* g_starts, float* g_incs, float* seam,
                           float* part_mv, float* part_fb, cudaStream_t stream) {
  cudaError_t err = upload_algorithms(stream);
  if (err != cudaSuccess) return (int)err;
  const long grid = (long)B * n_split;
  if (n_split < 1 || n_split > MAX_SPLITS || grid > 0x7fffffffL)
    return (int)cudaErrorInvalidConfiguration;
  fm_exact_bwd_ff_kernel<<<(unsigned)grid, BWD_THREADS, 0, stream>>>(
      amps, starts, incs, alg, fb_amt, n_carriers, master_volume, scale, tape, g_out, B, T,
      n_split, e, reinterpret_cast<float4*>(tick_a), reinterpret_cast<float2*>(tick_b),
      reinterpret_cast<float4*>(split_a), reinterpret_cast<float4*>(split_b), g_amps, g_starts,
      g_incs, seam, part_mv, part_fb);
  return (int)cudaGetLastError();
}

int fm_exact_bwd_loop_launch(const float* amps, const float* starts, const float* incs,
                             const int* alg, const float* fb_amt, const float* tape,
                             const float* e, const float* tick_a, const float* tick_b,
                             const float* split_a, const float* split_b, int B, int T,
                             int n_split, float* g_amps, float* g_starts, float* g_incs,
                             float* seam, float* part_fb, cudaStream_t stream) {
  cudaError_t err = upload_algorithms(stream);
  if (err != cudaSuccess) return (int)err;
  const long grid = (long)B * n_split;
  if (n_split < 1 || n_split > MAX_SPLITS || grid > 0x7fffffffL)
    return (int)cudaErrorInvalidConfiguration;
  fm_exact_bwd_loop_kernel<<<(unsigned)grid, BWD_THREADS, 0, stream>>>(
      amps, starts, incs, alg, fb_amt, tape, e, reinterpret_cast<const float4*>(tick_a),
      reinterpret_cast<const float2*>(tick_b), reinterpret_cast<const float4*>(split_a),
      reinterpret_cast<const float4*>(split_b), B, T, n_split, g_amps, g_starts, g_incs, seam,
      part_fb);
  return (int)cudaGetLastError();
}

int fm_exact_bwd_seams_launch(int B, int T, int n_split, const float* seam, const float* part_mv,
                              const float* part_fb, float* g_amps, float* g_fb, float* g_mv,
                              cudaStream_t stream) {
  fm_exact_bwd_seams_kernel<<<B, BLOCK, 0, stream>>>(B, T, n_split, seam, part_mv, part_fb,
                                                     g_amps, g_fb, g_mv);
  return (int)cudaGetLastError();
}

}  // extern "C"
