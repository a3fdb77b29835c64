"""Smoke run of the PyTorch/CUDA port on one GPU.

Builds every hand-written kernel of the port from the sources in this
checkout, holds each against its plain PyTorch version on the card, then
drives the port's main path once through its user entry point
(``preset_gen_vae_tpu_torch.training.loop.train_config``): the flagship
FlVAE2 at full width (257x347 log-mels, dim_z 610, batch 160) trained for
one epoch on a seeded synthetic 1,024-preset corpus, with a validation pass.

Run from the repository root with one GPU:

    python3 chip_smoke.py

It prints the card's name and power limit, one line per phase, the
kernels' JSON line, and as its last line
``{"ok": true, "device": {...}}``. Any failed phase ends the run with a
non-zero exit code; without a GPU it fails before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

SAMPLES = 88576  # 4 s at 22.05 kHz rounded up to the engine's 512-sample block


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def logmel_work(proc, B: int, S: int):
    """(bytes, flops) that the log-mel function itself must move and compute,
    whatever algorithm computes it: the waveforms and the mel filterbank read
    once, the output written once; per frame a real-input FFT
    (2.5 n log2 n flops, half a complex FFT's 5 n log2 n), the magnitude
    (3 flops per bin) and the mel product over the filterbank's nonzeros
    (a multiply-add each). The log is not counted. This is the bound; the
    O(n_fft^2) windowed-DFT products that K1 does instead are
    ``dft_gemm_flops``, the design's own work."""
    from preset_gen_vae_tpu_torch.ops.spectrogram import num_frames

    n_fft, hop = proc.n_fft, proc.hop
    n_bins = n_fft // 2 + 1
    T = num_frames(S, n_fft, hop)
    n_out = proc.n_out
    fb_elems = n_bins * n_out if proc.use_mel else 0
    nbytes = 4 * (B * S + fb_elems + B * n_out * T)
    per_frame = 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins
    if proc.use_mel:
        per_frame += 2 * int((proc.mel_fb != 0).sum())
    return nbytes, B * T * per_frame


def dft_gemm_flops(proc, B: int, S: int) -> int:
    """Flops (two per multiply-add) of K1's own design: the windowed DFT as two dense
    products against the (n_fft, n_bins) cos / sin matrices, then the dense
    mel product."""
    from preset_gen_vae_tpu_torch.ops.spectrogram import num_frames

    n_bins = proc.n_fft // 2 + 1
    T = num_frames(S, proc.n_fft, proc.hop)
    return 2 * B * T * (2 * proc.n_fft * n_bins + (n_bins * proc.n_out if proc.use_mel else 0))


def library_logmel(proc):
    """One PyTorch call chain for the same function (torch.stft, magnitude,
    mel product, log floor): the yardstick, never used by the port."""
    window = torch.hann_window(proc.n_fft, periodic=False, device="cuda")
    fb = proc.mel_fb

    def run(x):
        spec = torch.stft(x, proc.n_fft, proc.hop, window=window, center=True,
                          pad_mode="constant", return_complex=True).abs()
        spec = spec / proc.norm_factor
        if fb is not None:
            spec = torch.einsum("bft,fm->bmt", spec, fb)
        return 20.0 * torch.log10(torch.clamp(spec, min=proc.floor_amp))

    return run


def phase_kernels():
    """K1 against its plain version at the corpus pass's shapes."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's matmuls in full f32
    rng = np.random.default_rng(0)
    cases = [("mel257", 257, (CORPUS_CHUNK, SAMPLES)), ("linear", -1, (8, SAMPLES)),
             ("partial_tile", 257, (4, 22016))]
    t0 = time.time()
    sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=257), device="cuda")
    sp._logmel_library()  # builds csrc/logmel.cu with nvcc
    print(f"[build] logmel kernel built in {time.time() - t0:.1f} s", flush=True)
    entry = None
    for name, n_mels, shape in cases:
        x = torch.from_numpy(
            (rng.standard_normal(shape) * 0.1).astype(np.float32)).cuda()
        exact = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=n_mels), device="cuda")
        fast = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=n_mels), device="cuda",
                                       precision="fast")
        ref = exact.plain(x)
        got = exact(x)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if got.shape != ref.shape or not torch.isfinite(got).all() or err > 0.05:
            raise AssertionError(f"K1 exact {name}: shape {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)}, max |err| {err} dB > 0.05")
        got_fast = fast(x)
        loud = ref > -60.0
        err_fast = float((got_fast - ref).abs()[loud].max())
        if err_fast > 1.0:
            raise AssertionError(f"K1 fast {name}: max |err| {err_fast} dB > 1 above -60 dB")
        print(f"[K1 {name}] shape {tuple(got.shape)} exact max|err| {err:.3e} dB, "
              f"fast max|err| above -60 dB {err_fast:.3e} dB", flush=True)
        if name == "mel257":
            ms = cuda_ms(lambda: exact(x))
            fast_ms = cuda_ms(lambda: fast(x))
            plain_ms = cuda_ms(lambda: exact.plain(x))
            lib = library_logmel(exact)
            lib_err = float((lib(x) - ref).abs().max())
            library_ms = cuda_ms(lambda: lib(x))
            nbytes, flops = logmel_work(exact, *shape)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops)
            dft_flops = dft_gemm_flops(exact, *shape)
            print(f"[K1 timing] B={shape[0]} exact {ms:.4f} ms, fast {fast_ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms "
                  f"(library vs plain max|err| {lib_err:.3e} dB), bound {bound_ms:.4f} ms "
                  f"(bytes {nbytes / 1e6:.2f} MB = {t_bytes:.4f} ms, FFT-level work "
                  f"{flops / 1e9:.3f} GFLOP = {t_ops:.4f} ms); the kernel's own DFT-GEMM work "
                  f"{dft_flops / 1e9:.2f} GFLOP at {dft_flops / ms / 1e9:.1f} TFLOP/s", flush=True)
            entry = {
                "name": "logmel", "route": "cuda",
                "source": "preset_gen_vae_tpu_torch/csrc/logmel.cu",
                "replaces": "preset_gen_vae_tpu/ops/pallas_mel.py:57",
                "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": library_ms,
            }
    return entry


def phase_main_path():
    """The flagship train path through the port's entry point."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp
    from preset_gen_vae_tpu_torch.training.loop import train_config

    model_c = cfg.ModelConfig()
    train_c = cfg.TrainConfig(n_epochs=1, minibatch_size=160, verbosity=1)
    for k in sp.LAUNCHES:
        sp.LAUNCHES[k] = 0
    torch.cuda.reset_peak_memory_stats()
    summary = train_config(model_c, train_c, dataset_kwargs={"n_synthetic_presets": 1024},
                           device="cuda")
    launches = dict(sp.LAUNCHES)
    if launches["logmel"] < 1:
        raise AssertionError(f"K1 was not launched on the main path: {launches}")
    bad = {k: v for k, v in summary.items()
           if isinstance(v, float) and not np.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite metrics: {bad}")
    if summary["dim_z"] != 610 or summary["input_size"] != [160, 1, 257, 347]:
        raise AssertionError(f"not the flagship shapes: {summary}")
    print(f"[main path] {json.dumps(summary, sort_keys=True)}", flush=True)
    print(f"[main path] corpus pass {summary['corpus_seconds']:.3f} s for "
          f"{summary['corpus_presets']} presets (host render "
          f"{summary['corpus_render_seconds']:.3f} s); {summary['train_steps']} train steps, "
          f"steady step {summary['step_ms']:.2f} ms = "
          f"{summary['spectrograms_per_s']:.0f} spectrograms/s", flush=True)
    print(f"[main path] peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K1 launches {launches}",
          flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    k1 = phase_kernels()
    k1["launches"] = phase_main_path()["logmel"]
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
