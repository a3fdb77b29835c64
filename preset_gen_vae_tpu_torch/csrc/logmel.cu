// Fused waveform -> log-(mel-)spectrogram kernel for Hopper (sm_90a), by a
// real FFT in shared memory.
//
// Replaces the TPU kernel preset_gen_vae_tpu/ops/pallas_mel.py:_pallas_logmel
// (body at :82-103). Same function: zero center padding by n_fft/2, frames of
// n_fft = 1024 samples every hop samples, the symmetric Hann window with the
// 1/max|rFFT(w)| norm, the magnitude of the 513 rDFT bins, the product with
// the (513, n_mels) filterbank (or linear bins), then 20*log10(max(., floor)).
// Output (B, n_out, T) f32, written directly.
//
// Bound. The function is bound by its bytes: for (64, 88576) -> (64, 257,
// 347) it reads 22.7 MB of samples and the filterbank's 1,016 nonzeros with
// each filter's start and offset (6 KB), and writes 22.8 MB of dB: 45.51 MB
// in all, 0.0136 ms at 3.35 TB/s. Its least work, a real FFT per frame
// (2.5 n log2 n), the magnitudes and the mel sums over those nonzeros, is
// 0.648 GFLOP, 0.0097 ms at the f32 peak: under the bytes. So the design
// reads each sample once from device memory, keeps every intermediate on
// chip, and overlaps the next tile's copy with this tile's FFTs:
// - A block owns TT = 16 consecutive frames of one waveform (a tile) and
//   holds the waveform span they cover, 15*hop + 1024 samples, in shared
//   memory; the overlapping frames are read from it in place. Interior tiles
//   arrive by one 1-D TMA bulk copy (cp.async.bulk, completing on an
//   mbarrier); the first and last tile of a waveform, which overlap the
//   center padding, load with masked plain loads and zero fill.
// - The grid is persistent (as many blocks as fit, two per SM) and walks the
//   (waveform, tile) pairs; the span is double-buffered, so the copy of the
//   next tile is in flight while this one's FFTs run.
// - Each frame is one real FFT: the windowed samples are packed as
//   z[n] = xw[2n] + i xw[2n+1], a 512-point complex FFT runs as three
//   radix-8 Stockham passes (64 threads per frame, 8 points each in
//   registers, one shared-memory exchange between passes; each pass's
//   twiddles are powers of one table entry), and the split
//       X[k] = (Z[k] + Z*[512-k])/2 - i/2 e^(-2 pi i k/1024) (Z[k] - Z*[512-k])
//   gives the 513 bins, with Z[512] = Z[0]; one thread computes X[k] and
//   X[512-k] from the same pair. Four frames are in flight per block, each
//   synchronising its own two warps with a named barrier.
// - The tile's magnitudes stay in shared memory, (513, TT). Each mel filter
//   is one contiguous run of bins, so a mel value is a sum over its run (1 to
//   14 bins), not over all 513; a thread sums one filter for 8 frames at
//   once, with the runs and weights in shared memory. The dB tile replaces
//   the magnitudes and is written as rows of 16 consecutive frames (64 B).
// - No tensor cores: the FFT's work is under the bytes bound already, and
//   TF32 or bf16 products would lose ~16 dB near the floor.
// What holds it back on the card (PERF.md, section 5): no single part;
// taking out any one of the table loads, the FFT arithmetic, the split, the
// mel sums, log10f or the output stores saves 3-11%. At 128 registers a
// thread (f64 points) two blocks, 16 warps, fit on an SM, and each warp
// waits on shared-memory round trips (16 bytes a point in f64) and barriers.
//
// Precision. EXACT runs the FFT in IEEE f64 (samples widened from f32,
// window and twiddles made on the host in f64 and kept so), then the squared
// magnitude is rounded to f32; sqrtf, the mel sums (f32 FMA) and log10f
// follow. An f32 FFT is not enough near the -120 dB floor: on rendered DX7
// notes, whose quiet bins sit next to loud harmonics, its rounding error
// against a float64 rFFT is several times that of the dense-DFT plain
// version, whether its twiddles are powers of one entry or read per point
// from an f32 table, while the f64 FFT's is 1e-5 dB
// (tests/test_torch_port_mel.py:test_exact_mode_needs_an_f64_fft). FAST keeps
// the Pallas bf16 mode's contract, bf16 operands and f32 accumulation: it
// rounds to bf16 the loaded samples, the magnitudes and the mel weights, and
// runs the FFT in f32 with f32 tables (an FFT has no DFT matrix to round).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_FFT = 1024;            // samples per frame
constexpr int NZ = N_FFT / 2;          // points of the packed complex FFT
constexpr int N_BINS = NZ + 1;         // rDFT bins
constexpr int TT = 16;                 // frames per tile
constexpr int GT = NZ / 8;             // threads per frame: 8 points each
constexpr int GROUPS = 4;              // frames in flight per block
constexpr int THREADS = GROUPS * GT;   // 256
constexpr int STAGE_LD = TT + 1;       // row stride of the staged tile
constexpr int MEL_ROUNDS = 3;          // mel items per thread: n_mels <= 384

template <bool FAST> struct Real;
template <> struct Real<false> { using r = double; using c = double2; };
template <> struct Real<true> { using r = float; using c = float2; };

template <bool FAST>
__device__ __forceinline__ float rnd(float v) {
  return FAST ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <class C> __device__ __forceinline__ C cx(decltype(C::x) re, decltype(C::x) im) {
  C c;
  c.x = re;
  c.y = im;
  return c;
}
template <class C> __device__ __forceinline__ C cadd(C a, C b) { return cx<C>(a.x + b.x, a.y + b.y); }
template <class C> __device__ __forceinline__ C csub(C a, C b) { return cx<C>(a.x - b.x, a.y - b.y); }
template <class C> __device__ __forceinline__ C cmul(C a, C b) {
  return cx<C>(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
template <class C> __device__ __forceinline__ C mul_minus_i(C a) { return cx<C>(a.y, -a.x); }

// v[r] *= t^r for r = 1..7: the pass's twiddles from one table entry, by
// products in the working precision (1e-15 relative in f64), so that each
// thread loads one coalesced twiddle per pass instead of seven scattered ones.
template <class C> __device__ __forceinline__ void twiddle(C* v, C t) {
  C p = t;
#pragma unroll
  for (int r = 1; r < 8; ++r) {
    v[r] = cmul(v[r], p);
    if (r < 7) p = cmul(p, t);
  }
}

template <class C> __device__ __forceinline__ void bfly(C& a, C& b) {
  const C t = a;
  a = cadd(t, b);
  b = csub(t, b);
}

// In-register 8-point DFT, natural order in and out: three radix-2 stages.
template <class C>
__device__ __forceinline__ void fft8(C* v) {
  using R = decltype(C::x);
  const R h = R(0.70710678118654752440);
#pragma unroll
  for (int a = 0; a < 4; ++a) bfly(v[a], v[a + 4]);
  v[5] = cx<C>((v[5].x + v[5].y) * h, (v[5].y - v[5].x) * h);    // * e^(-i pi/4)
  v[6] = mul_minus_i(v[6]);                                        // * e^(-i pi/2)
  v[7] = cx<C>((v[7].y - v[7].x) * h, -(v[7].x + v[7].y) * h);   // * e^(-3i pi/4)
  bfly(v[0], v[2]);
  bfly(v[1], v[3]);
  bfly(v[4], v[6]);
  bfly(v[5], v[7]);
  v[3] = mul_minus_i(v[3]);
  v[7] = mul_minus_i(v[7]);
  bfly(v[0], v[1]);
  bfly(v[2], v[3]);
  bfly(v[4], v[5]);
  bfly(v[6], v[7]);
  C t = v[1];  // bit-reversed -> natural order
  v[1] = v[4];
  v[4] = t;
  t = v[3];
  v[3] = v[6];
  v[6] = t;
}

// Exchange 1 (written 8j + r, read j + 64r) swizzles the low three bits of
// the slot with the next three, so that neither side has bank conflicts; the
// later exchanges are conflict-free as they are.
__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 3) & 7); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// 1-D TMA copy of `bytes` (a multiple of 16, both addresses 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// Barrier of one frame's two warps (ids 1..GROUPS; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(GT) : "memory");
}

// n_mels > 0: the mel runs (starts, offsets, n_weights weights) follow the tile.
size_t smem_bytes(int hop, int n_mels, int n_weights, bool fast) {
  const size_t span = (size_t)(TT - 1) * hop + N_FFT;
  const size_t cbytes = fast ? sizeof(float2) : sizeof(double2);
  const size_t runs = n_mels > 0 ? (size_t)(2 * n_mels + 1 + n_weights) * 4 : 0;
  return 16 + GROUPS * NZ * cbytes + 2 * span * sizeof(float) +
         (size_t)N_BINS * STAGE_LD * sizeof(float) + runs;
}

template <bool FAST>
__global__ void __launch_bounds__(THREADS, 2)
logmel_kernel(const float* __restrict__ x, int B, int S, int hop, int T,
              const typename Real<FAST>::c* __restrict__ win,   // [NZ] (w[2n], w[2n+1]) / norm
              const typename Real<FAST>::c* __restrict__ tw,    // [NZ] e^(-2 pi i m / NZ)
              const typename Real<FAST>::c* __restrict__ post,  // [N_BINS] e^(-2 pi i k / N_FFT)
              const int* __restrict__ mel_start, const int* __restrict__ mel_off,
              const float* __restrict__ mel_w, int n_mels, int n_weights,
              float* __restrict__ out, float floor_amp) {
  using R = typename Real<FAST>::r;
  using C = typename Real<FAST>::c;
  extern __shared__ __align__(16) unsigned char smem[];
  const int span = (TT - 1) * hop + N_FFT;
  const int n_out = n_mels > 0 ? n_mels : N_BINS;
  const uint32_t bar0 = smem_u32(smem);                     // two mbarriers
  C* zbuf = reinterpret_cast<C*>(smem + 16);                 // [GROUPS][NZ]
  float* wav = reinterpret_cast<float*>(zbuf + GROUPS * NZ);  // [2][span]
  // [N_BINS][STAGE_LD]: the tile's magnitudes (mel) or dB (linear) by bin,
  // then its dB by output row
  float* tile = wav + 2 * span;
  int* m_start = reinterpret_cast<int*>(tile + N_BINS * STAGE_LD);  // [n_mels]
  int* m_off = m_start + n_mels;                                    // [n_mels + 1]
  float* m_w = reinterpret_cast<float*>(m_off + n_mels + 1);        // [n_weights]

  const int tid = threadIdx.x, group = tid / GT, j = tid % GT;
  const int n_tiles = (T + TT - 1) / TT;
  const int total = B * n_tiles;
  auto first_of = [&](int g) { return (long long)(g % n_tiles) * TT * hop - N_FFT / 2; };
  auto by_tma = [&](long long first) { return first >= 0 && first + span <= S; };
  auto prefetch = [&](int g, int buf) {  // thread 0 only
    const float* src = x + (long long)(g / n_tiles) * S + first_of(g);
    bulk_copy(smem_u32(wav + buf * span), src, span * sizeof(float), bar0 + 8 * buf);
  };

  if (n_mels > 0) {
    for (int i = tid; i < n_mels; i += THREADS) m_start[i] = mel_start[i];
    for (int i = tid; i <= n_mels; i += THREADS) m_off[i] = mel_off[i];
    for (int i = tid; i < n_weights; i += THREADS) m_w[i] = rnd<FAST>(mel_w[i]);
  }
  if (tid == 0) {
    mbar_init(bar0);
    mbar_init(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int g0 = blockIdx.x, step = gridDim.x;
  if (tid == 0 && g0 < total && by_tma(first_of(g0))) prefetch(g0, 0);

  uint32_t phase = 0;  // bit b: the parity of mbarrier b's next completion
  int it = 0;
  for (int g = g0; g < total; g += step, ++it) {
    const int buf = it & 1, b = g / n_tiles, t0 = (g % n_tiles) * TT;
    const long long first = first_of(g);
    float* w = wav + buf * span;
    const bool tma = by_tma(first);
    if (!tma) {  // a tile that overlaps the center padding
      const float* xb = x + (long long)b * S;
      for (int i = tid; i < span; i += THREADS) {
        const long long s = first + i;
        w[i] = (s >= 0 && s < S) ? xb[s] : 0.f;
      }
      // order these generic writes before a later TMA copy into this buffer
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    }
    const int gn = g + step;
    if (tid == 0 && gn < total && by_tma(first_of(gn))) prefetch(gn, buf ^ 1);
    if (tma) {
      mbar_wait(bar0 + 8 * buf, (phase >> buf) & 1u);
      phase ^= 1u << buf;
    }
    __syncthreads();

    C* z = zbuf + group * NZ;
    for (int f = group; f < TT && t0 + f < T; f += GROUPS) {
      C v[8];
      // pass 1 (Ns = 1): point n = j + 64r is (xw[2n], xw[2n+1]) of this frame
      const float* fw = w + f * hop;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int n = j + GT * r;
        const float2 s = *reinterpret_cast<const float2*>(fw + 2 * n);
        const C wn = win[n];
        v[r] = cx<C>(R(rnd<FAST>(s.x)) * wn.x, R(rnd<FAST>(s.y)) * wn.y);
      }
      fft8(v);
#pragma unroll
      for (int r = 0; r < 8; ++r) z[swz(8 * j + r)] = v[r];
      group_sync(group);
      // pass 2 (Ns = 8): twiddles W_64^(r k), k = j % 8
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = z[swz(j + GT * r)];
      group_sync(group);
      const int k2 = j & 7;
      twiddle(v, tw[8 * k2]);
      fft8(v);
#pragma unroll
      for (int r = 0; r < 8; ++r) z[(j >> 3) * 64 + k2 + 8 * r] = v[r];
      group_sync(group);
      // pass 3 (Ns = 64): twiddles W_512^(r j); Z in natural order
#pragma unroll
      for (int r = 0; r < 8; ++r) v[r] = z[j + GT * r];
      group_sync(group);
      twiddle(v, tw[j]);
      fft8(v);
#pragma unroll
      for (int r = 0; r < 8; ++r) z[j + GT * r] = v[r];
      group_sync(group);
      // split: bins k and 512 - k from one pair, k = j + 64q <= 256. With
      // e = (Z[k] + Z*[512-k])/2, wd = W^k (Z[k] - Z*[512-k])/2 and
      // W^(512-k) = -conj(W^k): X[k] = e - i wd, X[512-k] = conj(e) - i conj(wd).
#pragma unroll
      for (int q = 0; q < 5; ++q) {
        const int k = j + GT * q;
        if (k <= NZ / 2) {
          const C a = z[k], m = z[(NZ - k) & (NZ - 1)];
          const C e = cx<C>(R(0.5) * (a.x + m.x), R(0.5) * (a.y - m.y));
          const C wd = cmul(post[k], cx<C>(R(0.5) * (a.x - m.x), R(0.5) * (a.y + m.y)));
          const R lo_re = e.x + wd.y, lo_im = e.y - wd.x;
          const R hi_re = e.x - wd.y, hi_im = e.y + wd.x;
          const float lo = rnd<FAST>(sqrtf(float(lo_re * lo_re + lo_im * lo_im)));
          const float hi = rnd<FAST>(sqrtf(float(hi_re * hi_re + hi_im * hi_im)));
          if (n_mels > 0) {
            tile[k * STAGE_LD + f] = lo;
            tile[(NZ - k) * STAGE_LD + f] = hi;
          } else {
            tile[k * STAGE_LD + f] = 20.f * log10f(fmaxf(lo, floor_amp));
            tile[(NZ - k) * STAGE_LD + f] = 20.f * log10f(fmaxf(hi, floor_amp));
          }
        }
      }
      group_sync(group);  // z is read; the group's next frame may overwrite it
    }
    __syncthreads();
    if (n_mels > 0) {
      // mel sums over each filter's run for 8 frames at a time: item i is
      // mel n_mels - 1 - i / 2 (longest runs first, so that a thread's last,
      // partial round is short) and frames 8 (i % 2) .. + 7
      float db[MEL_ROUNDS][8];
#pragma unroll
      for (int s = 0; s < MEL_ROUNDS; ++s) {
        const int i = tid + s * THREADS;
        if (i < 2 * n_mels) {
          const int m = n_mels - 1 - i / 2, c0 = 8 * (i % 2);
          const int o0 = m_off[m], o1 = m_off[m + 1];
          const float* row = tile + (m_start[m] - o0) * STAGE_LD + c0;
          float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          for (int o = o0; o < o1; ++o) {
            const float wt = m_w[o];
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[c] = fmaf(row[o * STAGE_LD + c], wt, acc[c]);
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) db[s][c] = 20.f * log10f(fmaxf(acc[c], floor_amp));
        }
      }
      __syncthreads();  // the magnitudes are read: the dB rows replace them
#pragma unroll
      for (int s = 0; s < MEL_ROUNDS; ++s) {
        const int i = tid + s * THREADS;
        if (i < 2 * n_mels) {
          const int m = n_mels - 1 - i / 2, c0 = 8 * (i % 2);
#pragma unroll
          for (int c = 0; c < 8; ++c) tile[m * STAGE_LD + c0 + c] = db[s][c];
        }
      }
      __syncthreads();
    }
    // the dB tile, rows of TT consecutive frames; a partial last tile is masked
    float* ob = out + (long long)b * n_out * T + t0;
    for (int i = tid; i < n_out * TT; i += THREADS) {
      const int m = i / TT, c = i % TT;
      if (t0 + c < T) ob[(long long)m * T + c] = tile[m * STAGE_LD + c];
    }
  }
}

template <bool FAST>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(&logmel_kernel<FAST>);
}

}  // namespace

extern "C" {

// Blocks of the kernel that fit on one SM of the current device (0 if none
// does or on error). It first lifts the kernel's dynamic shared-memory limit
// to the device's opt-in maximum, so that every launch configuration of this
// instance may run on the device afterwards.
int logmel_blocks_per_sm(int hop, int n_mels, int n_weights, int fast) {
  const void* kern = fast ? kernel_ptr<true>() : kernel_ptr<false>();
  const size_t smem = smem_bytes(hop, n_mels, n_weights, fast != 0);
  int dev = 0, optin = 0, blocks = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, THREADS, smem) != cudaSuccess)
    return 0;
  return blocks;
}

// x: (B, S) f32, 16-byte aligned, S % 4 == 0; frames of 1024 samples every
// hop samples (hop % 4 == 0), T = 1 + S / hop. win, tw, post: the host
// tables (f64 for exact, f32 for fast): (w[2n], w[2n+1]) / norm for n < 512,
// e^(-2 pi i m / 512) for m < 512, e^(-2 pi i k / 1024) for k <= 512, as
// (re, im) pairs. mel_start (n_mels), mel_off (n_mels + 1), mel_w
// (n_weights = mel_off[n_mels]): filter m weighs bins mel_start[m] + i by
// mel_w[mel_off[m] + i], i < mel_off[m+1] - mel_off[m]; n_mels = 0 (null
// pointers) for linear bins. out: (B, n_mels or 513, T) f32. All contiguous
// on the current device. grid_cap: the persistent grid's most blocks,
// logmel_blocks_per_sm times the SMs, called on this device before. Returns
// the cudaError_t of the launch (0 on success); launches on `stream`, does
// not synchronize.
int logmel_launch(const float* x, int B, int S, int hop, int T, const void* win, const void* tw,
                  const void* post, const int* mel_start, const int* mel_off, const float* mel_w,
                  int n_mels, int n_weights, float* out, float floor_amp, int fast, int grid_cap,
                  void* stream) {
  const bool mel = n_mels > 0;
  if (B <= 0 || S <= 0 || S % 4 != 0 || hop <= 0 || hop % 4 != 0 || T != 1 + S / hop ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || !win || !tw || !post || !out || n_mels < 0 ||
      mel != (mel_start && mel_off && mel_w) || (mel && n_weights <= 0) ||
      2 * n_mels > MEL_ROUNDS * THREADS || grid_cap <= 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)B * ((T + TT - 1) / TT);
  const int grid = (int)(tiles < grid_cap ? tiles : grid_cap);
  const size_t smem = smem_bytes(hop, n_mels, n_weights, fast != 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fast)
    logmel_kernel<true><<<grid, THREADS, smem, s>>>(
        x, B, S, hop, T, static_cast<const float2*>(win), static_cast<const float2*>(tw),
        static_cast<const float2*>(post), mel_start, mel_off, mel_w, n_mels, n_weights, out, floor_amp);
  else
    logmel_kernel<false><<<grid, THREADS, smem, s>>>(
        x, B, S, hop, T, static_cast<const double2*>(win), static_cast<const double2*>(tw),
        static_cast<const double2*>(post), mel_start, mel_off, mel_w, n_mels, n_weights, out, floor_amp);
  return (int)cudaGetLastError();
}

}  // extern "C"
