"""Smoke run of the PyTorch/CUDA port on one GPU.

Builds every hand-written kernel of the port from the sources in this
checkout (K1, ``csrc/logmel.cu``; F1, F1b, F2 and F2b, ``csrc/fm_render.cu``,
built at once, each by its own nvcc), holds each against its plain PyTorch
version on the card (K1 on noise and on rendered DX7 notes, there also
against a float64 rFFT witness; F1, F2 and F2's two phases, the
feedback loop and the feed-forward operators, on 32 mixed presets and 12
with loops of 1-3 operators over two seeds, short renders, again at the
corpus pass's shape of 1,024 presets at 4 s, and F2 against the C++
engine at 4 s), times each beside its bound, its plain version and, where
there is one, a library call, times the FM kernels' serial chains (F2 on
32 items of each loop length, its loop phase alone, F1 on 8 items), holds
F1b, F1's backward (three kernels over the tape that F1 writes under a
gradient), against its plain version (``control_pass_vjp``) on the short
renders' presets, at the sound-match demo's shape and at the corpus
pass's, and times it there beside F1 with and without its tape, holds
F2b, F2's backward (three kernels), against its plain version
(``exact_pass_vjp``) on the same F1 outputs and seeded cotangents at
those three shapes (at the corpus pass's shape against F2's plain phases
composed) and times it beside F2, each of the two backwards' kernels by
CUDA events, and their serial chains (F1b on 8 items, F2b on one), with
the earlier designs' times beside, then
drives the port's main path through its user entry
points with the flagship FlVAE2 at full width (257x347 log-mels, dim_z 610,
batch 160) on a seeded synthetic 1,024-preset corpus, in three paths, each
with its own corpus pass: ``training.loop.train_config`` trains 2 epochs
with the plateau scheduler and checkpoints; a second call resumes from the
checkpoint for a third epoch; ``evaluation.evaluate.evaluate_model_from_dir``
scores the 164 validation items (inference, the on-device re-render through
F1 and F2, similarity metrics on the card) and writes the artifacts. Then
the saved runs' other configurations (``saved/FlVAE2/<run>/config.json``),
each through the same two entry points at full width: the repo's best run,
3 stacked notes (``r5stack3_v2_20480``, train and eval), the 6-note
un-stacked run with MIDI in z0 (``r5multi6_v2_12288``, train and eval),
both on their saved on-device corpus render (F1, F2 and K1, ``'jax'`` /
``'device'``) and the ``structured2`` corpus they trained on,
FlowParamsLoss (``r2flowloss_train``), the MLP head (``r2mlp400``, train,
eval, and eval again with the C++ re-render) and BasicVAE with a MAF head,
the last three on the C++ corpus render. Each of these paths caches its
corpus under a data root of its own, so that its corpus pass is cold. Then
the real-data path at the flagship's width: 33 DX7 cartridges imported into
one SQLite database (1,056 voices), trained 2 epochs (the cold corpus pass
writes the disk cache), resumed for a third on the same cache (a warm
reload: no kernel launch, the same corpus bit for bit), evaluated twice on
the C++ re-render (the first writes the ground-truth audio cache, the
second reads it and scores bit-equal) and interpolated between two
presets; then the stack3 configuration's on-device corpus render on the
``'disk'`` policy, cold and warm, held against its ``'device'`` pass; last
the sound-match demo (``scripts/sound_match_demo.py``), its gradient
through F1 and F1b held against the plain render's, its 400 Adam steps
through the render on the card (F1 and F1b each step; at least a 10x
loss reduction), its first 10 losses against the plain render's and a
profile of its step; and the demo's objective through the ``'exact'``
render (F1, F2, F2b and F1b each step): its gradient against the plain
render's, 400 steps whose losses fall, and a profile. Last, three paths of
the epoch loop's observability and multi-process data path, each with the
card's name and power limit: ``profile`` trains the flagship one epoch on
1,536 presets (6 steps) with the step profiler on and reads its trace of
the first 5 steps (the kernel launches in each, the 5 kernels with the most
device time, the device-busy share); ``multiproc1`` trains the train
path's configuration again under an NCCL process group of one with
``force_multihost_data`` and holds its validation losses to the train
path's (2e-3 relative); ``multiproc2`` spawns two processes on the card
(gloo), each taking one flagship train step on 80 of 160 seeded rows, and
holds the loss, every averaged gradient and every BatchNorm running
statistic to one process's step on the 160 rows (1e-4 of each tensor's
largest entry, in float64; float32's differences printed: the step is
ill-conditioned there); ``remat`` takes the flagship's step at batch 160
with ``TrainConfig.remat`` and without, holds them to each other in
float64 at the same bar (the generator's state equal), and prints each
one's steady step and peak device memory in bf16. Last, the ``cli`` paths
drive the port's command-line entry points as a user runs them:
``python -m preset_gen_vae_tpu_torch.scripts.evaluate`` in a subprocess
over the train path's run (its summary held to the in-process eval's
within 1e-5, 164 items), ``scripts.train_queue``'s ``main`` on a one-entry
queue and the loop CLI's ``main`` (``training/loop.py``), each 1 epoch on
512 presets with ``--no-tensorboard``, and ``scripts.clean_logs`` in a
subprocess on the queue's run (only that run erased). Each path prints
its wall time, launches of every kernel and peak memory, the training
paths also their model build time, steady step, corpus and render
seconds. Runs and caches live in a
temporary directory that is removed at the end.

Run from the repository root with one GPU:

    python3 chip_smoke.py

It prints the card's name and power limit, one line per phase, the
kernels' JSON line, a compact summary of every path and kernel, and as
its last line ``{"ok": true, "device": {...}}``; every printed line also
goes to ``build/chip_smoke/output.txt`` and the kernels', summary's and
last lines to ``build/chip_smoke/results.jsonl`` (``--out DIR`` moves
both). Any failed phase ends the run with a non-zero exit code; without
a GPU it fails before printing any result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA data sheet):
# device memory 3.35 TB/s, float32 outside the tensor cores 67 TFLOP/s,
# float64 outside the tensor cores 34 TFLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12

SAMPLES = 88576  # 4 s at 22.05 kHz rounded up to the engine's 512-sample block
# K1 is timed over this many distinct (64, SAMPLES) inputs in turn: 91 MB,
# more than the 50 MB L2, so no call reads an input still warm in L2
TIMING_INPUTS = 4
SLEEP_CYCLES = 20_000_000  # ~10 ms of device sleep while the host enqueues a timed run


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, inputs, reps: int = 20) -> float:
    """Mean device time of ``fn(x)`` over ``reps`` calls that take the
    ``inputs`` in turn, after one warm-up call on each. The stream sleeps
    while the host enqueues the calls, so host overhead does not count."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(reps):
        fn(inputs[i % len(inputs)])
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def logmel_work(proc, B: int, S: int):
    """(bytes, flops) that the log-mel function itself must move and compute,
    whatever algorithm computes it: the waveforms and the mel filterbank's
    nonzeros, with each filter's first bin and offset, read once, the output
    written once; per frame a real-input FFT (2.5 n log2 n flops, half a
    complex FFT's 5 n log2 n), the magnitude (3 flops per bin) and the mel
    product over the filterbank's nonzeros (a multiply-add each). The log is
    not counted. This is the bound."""
    from preset_gen_vae_tpu_torch.ops.spectrogram import num_frames

    n_fft, hop = proc.n_fft, proc.hop
    n_bins = n_fft // 2 + 1
    T = num_frames(S, n_fft, hop)
    n_out = proc.n_out
    nnz = int((proc.mel_fb != 0).sum()) if proc.use_mel else 0
    fb_elems = nnz + 2 * n_out + 1 if proc.use_mel else 0
    nbytes = 4 * (B * S + fb_elems + B * n_out * T)
    per_frame = 2.5 * n_fft * math.log2(n_fft) + 3 * n_bins + 2 * nnz
    return nbytes, B * T * per_frame


def fft_design_flops(proc, B: int, S: int) -> int:
    """Flops of K1's own arithmetic (csrc/logmel.cu), per frame: the window
    product; three radix-8 passes of 64 eight-point DFTs (48 adds and two
    products by e^(-i pi/4) of 4 flops each), with 7 complex twiddle
    products (6 flops) in the last two passes; the split (20 flops per bin:
    halves, the twiddle product, the combination, |X|^2 and its root); the
    mel sums over the runs (a multiply-add per nonzero). Exact mode does the
    window, the passes and the split in f64."""
    from preset_gen_vae_tpu_torch.ops.spectrogram import num_frames

    n_bins = proc.n_fft // 2 + 1
    per_frame = proc.n_fft + 3 * 64 * 56 + 2 * 64 * 7 * 6 + 20 * n_bins
    if proc.use_mel:
        per_frame += 2 * int(proc.mel_w.numel())
    return B * num_frames(S, proc.n_fft, proc.hop) * per_frame


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


def f64_witness(proc, wav: np.ndarray) -> np.ndarray:
    """numpy's float64 rFFT through the same window, mel and log floor, on
    the host: (B, n_out, T)."""
    from preset_gen_vae_tpu_torch.ops.spectrogram import hann_window

    pad = proc.n_fft // 2
    xp = np.pad(wav.astype(np.float64), ((0, 0), (pad, pad)))
    T = 1 + wav.shape[1] // proc.hop
    frames = xp[:, np.arange(T)[:, None] * proc.hop + np.arange(proc.n_fft)]
    mag = np.abs(np.fft.rfft(frames * hann_window(proc.n_fft), axis=-1)) / proc.norm_factor
    if proc.use_mel:
        mag = mag @ proc.mel_fb.cpu().numpy().astype(np.float64)
    return 20.0 * np.log10(np.maximum(mag, proc.floor_amp)).transpose(0, 2, 1)


def rendered_notes(n: int) -> np.ndarray:
    """The main path's real K1 inputs: ``n`` DX7 renders of the port's
    structured corpus (seed 0) at note (60, 85)."""
    from preset_gen_vae_tpu_torch.synth import database as db
    from preset_gen_vae_tpu_torch.synth.render import DexedRenderer

    presets, _, _ = db.generate_structured_corpus(n, seed=0)
    return DexedRenderer().render_batch(presets, [60] * n, [85] * n)


def ptxas_report(name: str, command, source) -> str:
    """ptxas' register, spill and shared-memory lines of a built library."""
    from preset_gen_vae_tpu_torch import _native

    so = _native.build_shared_library(name, command, [source])
    return "\n".join(ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
                     if "registers" in ln or "spill" in ln or "Compiling entry" in ln)


def build_report(sp) -> str:
    """ptxas' lines for K1, and the blocks that fit on one SM for each
    launch configuration of the main path."""
    lib = sp._logmel_library()
    occ = {f"{name} blocks/SM": lib.logmel_blocks_per_sm(256, n_mels, n_weights, fast)
           for name, n_mels, n_weights, fast in (("exact mel", 257, 1016, 0),
                                                 ("exact linear", 0, 0, 0),
                                                 ("fast mel", 257, 1016, 1))}
    report = ptxas_report("logmel", sp.logmel_build_command(), sp.LOGMEL_SOURCE)
    return f"{report}\n{occ}"


def phase_kernels():
    """K1 against its plain version at the corpus pass's shapes, on noise
    and on rendered notes; K1, plain and the library call timed."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's matmuls in full f32
    rng = np.random.default_rng(0)
    print(f"[build] logmel\n{build_report(sp)}", flush=True)

    def noise(shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    cases = [("mel257", 257, noise((CORPUS_CHUNK, SAMPLES))), ("linear", -1, noise((8, SAMPLES))),
             ("partial_tile", 257, noise((4, 22016))),
             ("rendered", 257, rendered_notes(CORPUS_CHUNK))]
    entry = None
    for name, n_mels, wav in cases:
        x = torch.from_numpy(wav).cuda()
        exact = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=n_mels), device="cuda")
        fast = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=n_mels), device="cuda",
                                       precision="fast")
        ref = exact.plain(x)
        got = exact(x)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"K1 exact {name}: shape {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)}, finite {bool(torch.isfinite(got).all())}")
        # rendered notes reach the -120 dB floor, where plain's own f32
        # rounding is the larger error: gate above -100 dB there
        gated = ref > -100.0 if name == "rendered" else torch.ones_like(ref, dtype=torch.bool)
        err_all = float((got - ref).abs().max())
        err = float((got - ref).abs()[gated].max())
        if err > 0.05:
            raise AssertionError(f"K1 exact {name}: max |err| {err} dB > 0.05")
        got_fast = fast(x)
        loud = ref > -60.0
        err_fast = float((got_fast - ref).abs()[loud].max())
        if err_fast > 1.0:
            raise AssertionError(f"K1 fast {name}: max |err| {err_fast} dB > 1 above -60 dB")
        print(f"[K1 {name}] shape {tuple(got.shape)} exact max|err| {err:.3e} dB"
              f"{' above -100 dB' if name == 'rendered' else ''} ({err_all:.3e} dB over all "
              f"bins), fast max|err| above -60 dB {err_fast:.3e} dB", flush=True)
        if name == "rendered":
            n_w = 4
            at_floor = float((ref <= exact.config.min_dB + 0.01).float().mean())
            witness = f64_witness(exact, wav[:n_w])
            k_err = float(np.abs(got[:n_w].cpu().numpy() - witness).max())
            p_err = float(np.abs(ref[:n_w].cpu().numpy() - witness).max())
            limit = max(2.0 * p_err, 0.01)
            print(f"[K1 rendered witness] {n_w} waveforms against a float64 rFFT, all bins "
                  f"({at_floor:.1%} of plain's bins at the floor): kernel max|err| "
                  f"{k_err:.3e} dB, plain max|err| {p_err:.3e} dB, limit {limit:.3e} dB",
                  flush=True)
            if k_err > limit:
                raise AssertionError(f"K1 exact against the f64 witness: {k_err} dB > {limit}")
        if name == "mel257":
            xs = [x] + [torch.from_numpy(noise(wav.shape)).cuda()
                        for _ in range(TIMING_INPUTS - 1)]
            ms = cuda_ms(exact, xs)
            fast_ms = cuda_ms(fast, xs)
            plain_ms = cuda_ms(exact.plain, xs, reps=8)
            lib = library_logmel(exact)
            lib_err = float((lib(x) - ref).abs().max())
            library_ms = cuda_ms(lib, xs)
            nbytes, flops = logmel_work(exact, *wav.shape)
            t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
            bound_ms = max(t_bytes, t_ops)
            design = fft_design_flops(exact, *wav.shape)
            print(f"[K1 timing] B={wav.shape[0]}, {TIMING_INPUTS} inputs in turn: exact "
                  f"{ms:.4f} ms, fast {fast_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                  f"{library_ms:.4f} ms (library vs plain max|err| {lib_err:.3e} dB), bound "
                  f"{bound_ms:.4f} ms (bytes {nbytes / 1e6:.2f} MB = {t_bytes:.4f} ms, FFT-level "
                  f"work {flops / 1e9:.3f} GFLOP = {t_ops:.4f} ms); exact at "
                  f"{nbytes / ms / 1e9:.2f} TB/s, {bound_ms / ms:.1%} of the bound; the "
                  f"kernel's own work {design / 1e9:.3f} GFLOP (f64 in exact: "
                  f"{design / F64_FLOP_PER_S * 1e3:.4f} ms at the f64 peak)", flush=True)
            entry = {
                "name": "logmel", "route": "cuda",
                "source": "preset_gen_vae_tpu_torch/csrc/logmel.cu",
                "replaces": "preset_gen_vae_tpu/ops/pallas_mel.py:57",
                "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": library_ms,
            }
    return entry


def build_kernels():
    """Builds K1 and F1/F2 at once, one nvcc each, started together."""
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for build in [pool.submit(fn) for fn in (sp._logmel_library, ft._fm_library)]:
            build.result()  # re-raises a failed build
    print(f"[build] logmel.cu and fm_render.cu built in parallel in {time.time() - t0:.1f} s",
          flush=True)


FM_SHORT = 4096  # samples of the F1/F2 checks against the plain loops


def mixed_fm_presets(seed: int, n: int = 16) -> np.ndarray:
    """``n`` structured2 presets (the saved runs' generator), algorithms
    16 * seed + 1 .. 16 * seed + 16, feedback 0 and 7 in turn, LFO fast
    and deep, every other one S&H (wave 5) and the rest waves 0-4, key
    sync on and off: two seeds cover the 32 algorithms."""
    from preset_gen_vae_tpu_torch.synth import database as db

    p, _, _ = db.generate_structured_corpus_v2(n, seed=seed)
    i = np.arange(n)
    p[:, 4] = (16 * seed + i % 16) / 31.0
    p[:, 5] = np.where(i % 3 == 0, 0.0, np.where(i % 3 == 1, 1.0, p[:, 5]))
    p[:, 7] = 0.9 + 0.1 * (i % 2)
    p[:, 8] = np.where(i % 4 == 0, 0.3, 0.0)
    p[:, 9], p[:, 10], p[:, 14] = 0.8, 0.5, 1.0
    p[:, 11] = (i // 2) % 2
    p[:, 12] = np.where(i % 2 == 0, 1.0, (i % 5) / 5.0)
    return p.astype(np.float32)


def fm_notes(n: int):
    pitch = np.resize(np.array([60, 48, 72, 40, 55, 67, 84, 60], np.int32), n)
    vel = np.resize(np.array([85, 100, 64, 127, 42, 85, 110, 1], np.int32), n)
    return pitch, vel


F1_BARS = {"amps": 1e-5, "pitch_fact": 1e-5, "incs": 1e-6, "starts": 1e-4, "start_step": 1e-6}


def f1_errors(got, want) -> dict:
    """Max |F1 - control_pass| of each output, phase starts on the circle
    (0.99999 and 0.0 lie 1e-5 apart), and ``start_step``: how far F1's
    starts are from the plain recurrence on F1's own increments (each
    tick's start is the previous one plus 32 increments, wrapped; the
    first is 0), which the same f32 operations must give exactly. Over a
    whole note the starts of the two also differ by the sum of the
    increments' last-bit differences, which ``starts`` includes."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    def circ(a, b):
        d = (a - b).abs()
        return torch.minimum(d, 1.0 - d)

    starts, incs = got[2], got[3]
    nxt = starts[:-1] + incs[:-1] * ft.BLOCK
    errs = {k: float((g - w).abs().max()) for k, g, w in zip(
        ("amps", "pitch_fact", "incs"), (got[0], got[1], got[3]), (want[0], want[1], want[3]))}
    errs["starts"] = float(circ(starts, want[2]).max())
    errs["start_step"] = max(float(starts[0].abs().max()),
                             float(circ(starts[1:], nxt - torch.floor(nxt)).max()))
    return errs


def fm_exact_work(B: int, n_samples: int):
    """(bytes, flops) that the exact render itself must move and compute,
    whatever computes it: each item's packed control row (94 f32) read
    once and its waveform written once; per item and sample the six
    operators (phase and amplitude step, 4; the modulation sum over the
    algorithm's edges and the feedback term, ~3; the scaled sine argument,
    3; the sine, ~20; the amplitude product, 1) and the feedback history,
    carrier sum, normalisation, clip and fade (~12): 6 x 31 + 12 = 198 f32
    operations. The control pass adds ~200 a tick, 1/32 of the samples,
    and is F1's work."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    return 4 * B * (ft.CTL_WIDTH + n_samples), B * n_samples * (6 * 31 + 12)


def fm_loop_work(lengths, n_ticks: int):
    """(bytes, flops) of F2's loop phase on this run's items: on each item
    with feedback, its L loop operators' amplitudes, starts and increments
    read once (3 L f32 a tick) and the source's output written once (f32 a
    sample); per sample L operators (31 operations each) and the feedback
    term (3)."""
    n = 32 * n_ticks
    ls = [x for x in lengths.tolist() if x]
    return 4 * sum(3 * x * n_ticks + n for x in ls), sum(n * (31 * x + 3) for x in ls)


def fm_ff_work(lengths, n_ticks: int):
    """(bytes, flops) of F2's feed-forward phase on this run's items: F1's
    three (T, B, 6) arrays, the loop's output on the items with feedback
    and the fade table read once, the waveforms written once; per sample
    the operators off the loop (31 operations each) and the carrier sum,
    normalisation, clip and fade (12)."""
    n, B = 32 * n_ticks, len(lengths)
    ls = lengths.tolist()
    n_fb = sum(1 for x in ls if x)
    nbytes = 4 * (3 * n_ticks * B * 6 + n_fb * n + B * n + n)
    return nbytes, sum(n * (31 * (6 - x) + 12) for x in ls)


def fm_control_work(B: int, n_ticks: int):
    """(bytes, flops) of the control pass: the packed rows read once, the
    (T, B, 6) amplitudes, phase starts and increments and the (T, B) pitch
    factor written once; per item and tick the LFO (~15 operations), the
    pitch EG (~10) and six operator EGs with their amplitude, increment and
    phase wrap (~30 each): ~205."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    return 4 * B * (ft.CTL_WIDTH + n_ticks * 19), B * n_ticks * 205


def bound(work):
    """(bound ms, bound_by) of (bytes, flops) at the card's peaks."""
    nbytes, flops = work
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return max(t_b, t_o), "operations" if t_o >= t_b else "bytes"


def loop_length_presets(seed: int, n: int, length: int) -> np.ndarray:
    """``n`` structured2 presets whose feedback loop has ``length``
    operators: feedback 0 for 0, else feedback 7 on algorithm 1, 6 or 4
    (loops of 1, 2, 3)."""
    from preset_gen_vae_tpu_torch.synth import database as db

    p, _, _ = db.generate_structured_corpus_v2(n, seed=seed)
    if length == 0:
        p[:, 5] = 0.0
    else:
        p[:, 4] = {1: 0, 2: 5, 3: 3}[length] / 31.0
        p[:, 5] = 1.0
    return p.astype(np.float32)


def short_check_presets(seed: int) -> np.ndarray:
    """The short renders' 28 presets of one seed: 16 mixed ones and 2 with
    each loop length 1-3, of which each length once at feedback 0."""
    pr = np.concatenate([mixed_fm_presets(seed)] + [
        loop_length_presets(seed, 2, n) for n in (1, 2, 3)])
    pr[16::2, 5] = 0.0  # each loop length at feedback 0 too
    return pr


def fm_inputs(p: torch.Tensor, pitch, vel, sr: int, n_ticks: int, note_off: int):
    """F1's outputs for presets ``p`` on the card, and F2's other arguments:
    -> (F1's four outputs, F2's argument tuple, ctl)."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    d = ft.decode_presets(p)
    ctl = ft.control_params(d, torch.as_tensor(pitch).cuda(), torch.as_tensor(vel).cuda(), sr)
    got = ft.fm_control(ctl, n_ticks, note_off, sr)
    amps, _, starts, incs = got
    alg, fb_amt = d["algorithm"].to(torch.int32), ft.feedback_amount(d)
    nc = torch.clamp(torch.from_numpy(ft.ALGO_CARRIER).cuda()[alg.long()].sum(-1), min=1.0)
    return got, (amps, starts, incs, alg, fb_amt, nc, d["master_volume"], sr), ctl


def f2_phase_errors(args, ref_sample=None):
    """F2 and its two phases against their plain versions on the same F1
    outputs: -> (max |err| by item of fm_exact against exact_pass, of the
    loop phase against feedback_loop_pass on the items with feedback, and
    of the feed-forward phase, run on the plain loop's output, against
    feedforward_pass; each finished by fade_and_volume where it is a
    waveform). ``ref_sample`` is exact_pass's carrier sum if already made."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    amps, starts, incs, alg, fb_amt, nc, mv, sr = args
    phases, amps_s = ft.sample_phases(starts, incs), ft.upsample_amps(amps)
    if ref_sample is None:
        ref_sample = ft.exact_pass(phases, amps_s, alg, fb_amt)
    out = ft.fm_exact(*args)
    e_f2 = (out - ft.fade_and_volume(ref_sample, nc, mv, sr)).abs().amax(1)
    del out
    on = fb_amt != 0
    loop_ref = ft.feedback_loop_pass(phases, amps_s, alg, fb_amt)
    loop = ft.fm_fb_loop(*args[:5])
    e_loop = torch.where(on[:, None], loop - loop_ref, 0.0).abs().amax(1)
    del loop
    ff_ref = ft.fade_and_volume(ft.feedforward_pass(phases, amps_s, alg, fb_amt, loop_ref), nc,
                                mv, sr)
    e_ff = (ft.fm_exact_ff(loop_ref, *args) - ff_ref).abs().amax(1)
    torch.cuda.synchronize()
    return e_f2, e_loop, e_ff


def phase_fm_kernels():
    """F1 and F2 against their plain versions on 32 mixed presets and 12
    with loops of 1-3 operators at feedback 0 and 7 (two seeds, all 32
    algorithms, short renders), F2's loop and feed-forward phases against
    theirs, F2 against the C++ engine at the full 4 s, then F1, F2, its two
    phases and the plain versions timed at the corpus pass's shapes,
    (1,024, 88,576) and one note of 20,480 presets, every kernel held
    against its plain version at (1,024, 88,576), and the serial chains
    timed: F2 on 32 items of each loop length, the loop phase alone at
    (1,024, 88,576), F1 on 8 items."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft
    from preset_gen_vae_tpu_torch.synth import database as db
    from preset_gen_vae_tpu_torch.synth.render import DexedRenderer

    print(f"[build] fm_render\n{ptxas_report('fm_render', ft.fm_build_command(), ft.FM_SOURCE)}",
          flush=True)
    sr, total = 22050, FM_SHORT / 22050
    err = {"F1": 0.0, "F2": 0.0, "loop": 0.0, "ff": 0.0}
    for seed in (0, 1):
        p = torch.from_numpy(short_check_presets(seed)).cuda()
        pitch, vel = fm_notes(len(p))
        got, args, ctl = fm_inputs(p, pitch, vel, sr, FM_SHORT // ft.BLOCK, int(0.1 * sr))
        want = ft.control_pass(ctl, FM_SHORT // ft.BLOCK, int(0.1 * sr), sr)
        torch.cuda.synchronize()
        errs = f1_errors(got, want)
        if any(errs[k] > F1_BARS[k] for k in errs):
            raise AssertionError(f"F1 against control_pass, seed {seed}: {errs}, bars {F1_BARS}")
        err["F1"] = max(err["F1"], errs["amps"])
        # F2 on F1's own outputs against the plain exact loop on the same
        # inputs: the same f32 operations in the same order, so even a
        # chaotic feedback-7 item (whose samples part after ~100 steps from
        # a last-bit difference) must agree; likewise each phase
        e_f2, e_loop, e_ff = f2_phase_errors(args)
        # end to end, F1 and F2 against the plain loops, where F1's last-bit
        # differences (exp2) reach the audio: held on the items without feedback
        e2e = ft.render_batch(p, pitch, vel, note_on_s=0.1, total_s=total, sample_rate=sr,
                              feedback="exact")
        e2e_ref = ft.plain_render(p, pitch, vel, note_on_s=0.1, total_s=total, sample_rate=sr,
                                  feedback="exact")
        torch.cuda.synchronize()
        no_fb = p[:, 5] == 0
        e_nofb = float((e2e - e2e_ref).abs()[no_fb].max())
        e2e_items = [f"{v:.1e}" for v in (e2e - e2e_ref).abs().mean(1).tolist()]
        worst = {k: float(e.max()) for k, e in (("F2", e_f2), ("loop", e_loop), ("ff", e_ff))}
        for k, v in worst.items():
            err[k] = max(err[k], v)
        lengths = ft.loop_lengths(args[3], args[4]).tolist()
        if not torch.isfinite(e2e).all() or max(worst.values()) > 1e-4 or e_nofb > 1e-4 or \
                set(lengths) != {0, 1, 2, 3}:
            raise AssertionError(
                f"F2, seed {seed}: max |err| on F1's outputs by item {e_f2.tolist()}, loop phase "
                f"{e_loop.tolist()}, feed-forward phase {e_ff.tolist()} (bar 1e-4); end to end "
                f"without feedback {e_nofb} (bar 1e-4); MAE by item {e2e_items}; loop lengths "
                f"{lengths}")
        print(f"[F1/F2 seed {seed}] algorithms {16 * seed + 1}-{16 * seed + 16} and 1, 6, 4, "
              f"{FM_SHORT} samples: F1 max|err| {errs}; on F1's outputs max|err| F2 "
              f"{worst['F2']:.3e}, loop phase {worst['loop']:.3e}, feed-forward phase "
              f"{worst['ff']:.3e}; end to end max|err| without feedback {e_nofb:.3e}, MAE by "
              f"item {e2e_items} (feedback {[round(v * 7) for v in p[:, 5].tolist()]}, loop "
              f"lengths {lengths})", flush=True)

    # ---- F2 against the C++ engine at 4 s (tests/test_fm_jax.py:54-55's limits)
    presets, _, _ = db.generate_structured_corpus_v2(16, seed=0)
    pitch, vel = fm_notes(16)
    cpp = DexedRenderer().render_batch(presets, pitch, vel)
    gpu = ft.render_batch(torch.from_numpy(presets).cuda(), pitch, vel, feedback="exact").cpu()
    cpp_mae = float(np.abs(gpu.numpy() - cpp).mean())
    cpp_rel = float(np.abs(gpu.numpy() - cpp).max() / max(np.abs(cpp).max(), 1e-6))
    print(f"[F2 vs C++ engine] 16 structured2 presets at 4 s: MAE {cpp_mae:.3e} (limit 2e-3), "
          f"max relative deviation {cpp_rel:.3e} (limit 0.15)", flush=True)
    if cpp_mae >= 2e-3 or cpp_rel >= 0.15:
        raise AssertionError(f"F2 against the C++ engine: MAE {cpp_mae}, max rel {cpp_rel}")

    # ---- timing at the corpus pass's shapes
    n_ticks = SAMPLES // ft.BLOCK
    note_off = int(3.0 * 22050)
    entries = {}
    props = torch.cuda.get_device_properties(0)
    for B in (1024, 20480):
        pr, _, _ = db.generate_structured_corpus_v2(B, seed=0)
        p = torch.from_numpy(pr).cuda()
        pitch, vel = np.full(B, 60), np.full(B, 85)
        (amps, pitch_fact, starts, incs), args, ctl = fm_inputs(p, pitch, vel, 22050, n_ticks,
                                                               note_off)
        lengths = ft.loop_lengths(args[3], args[4])
        f1_ms = cuda_ms(lambda c: ft.fm_control(c, n_ticks, note_off, 22050), [ctl], reps=3)
        f2_ms = cuda_ms(lambda a: ft.fm_exact(*a), [args], reps=3)
        loop_ms = cuda_ms(lambda a: ft.fm_fb_loop(*a[:5]), [args], reps=3)
        buf = ft.fm_fb_loop(*args[:5])
        ff_ms = cuda_ms(lambda a: ft.fm_exact_ff(buf, *a), [args], reps=3)
        # the two phases one after the other on one stream: what the
        # pipeline of fm_exact gains by overlapping them
        in_turn_ms = cuda_ms(lambda a: ft.fm_exact_ff(ft.fm_fb_loop(*a[:5]), *a), [args], reps=3)
        wav = ft.fm_exact(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(wav).all() or float(wav.abs().max()) > 1.0:
            raise AssertionError(f"F2 at ({B}, {SAMPLES}): non-finite or out of [-1, 1]")
        del buf, wav
        row = {"F1": f1_ms, "F2": f2_ms, "F2 loop phase": loop_ms, "F2 feed-forward phase": ff_ms,
               "F2 phases in turn": in_turn_ms}
        if B == 1024:
            # the plain versions at the corpus pass's shape, timed, and each
            # kernel held against them there: F1 on every output, F2 and
            # its phases on F1's outputs on every item
            t0 = time.perf_counter()
            want = ft.control_pass(ctl, n_ticks, note_off, 22050)
            torch.cuda.synchronize()
            row["F1 plain"] = (time.perf_counter() - t0) * 1e3
            phases, amps_s = ft.sample_phases(starts, incs), ft.upsample_amps(amps)
            alg, fb_amt = args[3], args[4]
            t0 = time.perf_counter()
            ref = ft.exact_pass(phases, amps_s, alg, fb_amt)
            torch.cuda.synchronize()
            row["F2 plain"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            loop_ref = ft.feedback_loop_pass(phases, amps_s, alg, fb_amt)
            torch.cuda.synchronize()
            row["F2 loop phase plain"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            ft.feedforward_pass(phases, amps_s, alg, fb_amt, loop_ref)
            torch.cuda.synchronize()
            row["F2 feed-forward phase plain"] = (time.perf_counter() - t0) * 1e3
            del phases, amps_s, loop_ref
            errs = f1_errors((amps, pitch_fact, starts, incs), want)
            e_f2, e_loop, e_ff = (float(e.max()) for e in f2_phase_errors(args, ref))
            # the starts part by the increments' summed last-bit differences
            # over 2,768 ticks: reported; start_step holds F1's recurrence
            gated = {k: v for k, v in F1_BARS.items() if k != "starts"}
            print(f"[F1/F2 at ({B}, {SAMPLES})] F1 against control_pass max|err| {errs} (bars "
                  f"{gated}); on F1's outputs over all {B} items (bar 1e-4), F2 against "
                  f"exact_pass max|err| {e_f2:.3e}, loop phase against feedback_loop_pass "
                  f"{e_loop:.3e}, feed-forward phase against feedforward_pass {e_ff:.3e}",
                  flush=True)
            if any(errs[k] > bar for k, bar in gated.items()) or max(e_f2, e_loop, e_ff) > 1e-4:
                raise AssertionError(f"F1/F2 at ({B}, {SAMPLES}) against the plain versions: F1 "
                                     f"{errs}, F2 {e_f2}, loop {e_loop}, feed-forward {e_ff}")
            err["F1"], err["F2"] = max(err["F1"], errs["amps"]), max(err["F2"], e_f2)
            err["loop"], err["ff"] = max(err["loop"], e_loop), max(err["ff"], e_ff)
            del want, ref
            # the serial chains: F2 on 32 items of each loop length alone on
            # the card (loop length 0 is the feed-forward phase only), and
            # F1 on 8 items (two warps)
            for n in (0, 1, 2, 3):
                q = torch.from_numpy(loop_length_presets(0, 32, n)).cuda()
                _, a32, _ = fm_inputs(q, np.full(32, 60), np.full(32, 85), 22050, n_ticks,
                                      note_off)
                got_lengths = set(ft.loop_lengths(a32[3], a32[4]).tolist())
                if got_lengths != {n}:
                    raise AssertionError(f"loop-length-{n} presets: lengths {got_lengths}")
                row[f"F2 32 items loop {n}"] = cuda_ms(lambda a: ft.fm_exact(*a), [a32], reps=3)
            c8 = ctl[:8].contiguous()
            row["F1 8 items"] = cuda_ms(lambda c: ft.fm_control(c, n_ticks, note_off, 22050),
                                        [c8], reps=3)
            ls = lengths.tolist()
            row["F2 items by loop length"] = {n: ls.count(n) for n in sorted(set(ls))}
        for name, work in (("F1", fm_control_work(B, n_ticks)), ("F2", fm_exact_work(B, SAMPLES)),
                           ("F2 loop phase", fm_loop_work(lengths, n_ticks)),
                           ("F2 feed-forward phase", fm_ff_work(lengths, n_ticks))):
            row[f"{name} bound"], row[f"{name} bound_by"] = bound(work)
        entries[B] = row
        print(f"[F1/F2 timing] ({B}, {SAMPLES}), {props.multi_processor_count} SMs: "
              f"{json.dumps(row)}", flush=True)
        del p, ctl, amps, pitch_fact, starts, incs, args
        gc.collect()
        torch.cuda.empty_cache()
    main, big = entries[1024], entries[20480]
    print(f"[F1/F2 chains] at (1,024, {SAMPLES}): F2 {main['F2']:.3f} ms = "
          f"{main['F2'] / main['F2 loop phase']:.3f} x its loop phase alone "
          f"({main['F2 loop phase']:.3f} ms, the measured serial chain; throughput bound "
          f"{main['F2 bound']:.4f} ms); F2 on 32 items by loop length 0/1/2/3: "
          + " / ".join(f"{main[f'F2 32 items loop {n}']:.3f}" for n in range(4))
          + f" ms; F1 {main['F1']:.3f} ms = {main['F1'] / main['F1 8 items']:.3f} x its chain "
          f"(8 items alone, {main['F1 8 items']:.3f} ms)", flush=True)
    # no Pallas kernel stands behind F1 and F2: they replace the JAX
    # package's XLA scans, and no PyTorch call computes an FM render
    common = {"route": "cuda", "source": "preset_gen_vae_tpu_torch/csrc/fm_render.cu",
              "library_ms": None, "launches": None}

    def entry(name, key, replaces, plain, **kw):
        return dict(common, name=name, replaces=replaces, max_abs_err=err[key[0]],
                    ms=main[key[1]], plain_ms=main[plain], bound_ms=main[f"{key[1]} bound"],
                    bound_by=main[f"{key[1]} bound_by"], ms_20480=big[key[1]],
                    bound_ms_20480=big[f"{key[1]} bound"], **kw)

    f1 = entry("fm_control", ("F1", "F1"), "preset_gen_vae_tpu/synth/fm_jax.py:299", "F1 plain",
               serial_chain_ms=main["F1 8 items"])
    f2 = entry("fm_exact", ("F2", "F2"), "preset_gen_vae_tpu/synth/fm_jax.py:489", "F2 plain",
               serial_chain_ms=main["F2 loop phase"], phases_in_turn_ms=main["F2 phases in turn"],
               phases_in_turn_ms_20480=big["F2 phases in turn"],
               ms_32_items_by_loop_length=[main[f"F2 32 items loop {n}"] for n in range(4)],
               mae_vs_cpp_engine=cpp_mae)
    loop = entry("fm_fb_loop", ("loop", "F2 loop phase"), "preset_gen_vae_tpu/synth/fm_jax.py:489",
                 "F2 loop phase plain")
    ff = entry("fm_exact_ff", ("ff", "F2 feed-forward phase"),
               "preset_gen_vae_tpu/synth/fm_jax.py:370", "F2 feed-forward phase plain")
    return [f1, f2, loop, ff]


# F1b against control_pass_vjp: max |err| of each field of the gradient
# row over its largest entry in the plain version (the same arithmetic
# but the transcendental functions' last bits and the order of the
# 8-lane sums); a field that is 0 in the plain version (the switches
# ``on`` and ``lfo_wave``) must be exactly 0
F1B_BAR = 1e-4


def f1b_errors(got, want) -> dict:
    """Each ``CTL_FIELDS`` field's max |F1b - control_pass_vjp| over the
    largest |entry| of the plain version's (the error itself where that is
    0)."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    errs = {}
    for name, _ in ft.CTL_FIELDS:
        g, w = ft._ctl(got, name), ft._ctl(want, name)
        scale = float(w.abs().max())
        errs[name] = float((g - w).abs().max()) / (scale if scale > 0 else 1.0)
    return errs


def short_json(errs: dict) -> str:
    return json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()})


def cotangents(rng, B: int, n_ticks: int):
    """Seeded normal cotangents of F1's four outputs, on the card."""
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
            for shape in ((n_ticks, B, 6), (n_ticks, B), (n_ticks, B, 6), (n_ticks, B, 6))]


def fm_control_bwd_work(B: int, n_ticks: int):
    """(bytes, flops) of F1's adjoint: the packed rows read and the gradient
    rows written once, the four cotangents read once ((T, B, 6) x 3 and
    (T, B) f32); per item and tick ~540 operations: the state walk (the
    LFO, the pitch EG and six EGs, ~76) and the adjoint tick (the tick's
    values again, ~35 shared and ~25 per operator, the adjoints, ~40 per
    operator and ~30 shared). The tape is the design's own traffic and is
    not counted."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    return 4 * (2 * B * ft.CTL_WIDTH + n_ticks * B * 19), B * n_ticks * 540


# the earlier F1b design, one kernel that walked F1's state forward onto a
# tape and then the whole reverse on 8 lanes an item, on an NVIDIA H100
# 80GB HBM3 at 700 W: ms at (1,024 items, 2,768 ticks), at the demo's shape
# (1 item, 1,040 ticks), and on 8 items (its serial chain)
F1B_EARLIER = {"ms": 4.261, "ms_demo_shape": 1.443, "serial_chain_ms": 4.223}


def kernel_event_ms(fn, calls: int = 3) -> dict:
    """{kernel: device ms a call} of the F1b and F2b kernels that ``fn()``
    launches, by the CUDA events that ``fm_torch.kernel_events`` records on
    the stream around each launch, over ``calls`` calls after a warm-up."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    fn()
    torch.cuda.synchronize()
    with ft.kernel_events() as marks:
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    out = {}
    for name, start, stop in marks:
        out[name] = out.get(name, 0.0) + start.elapsed_time(stop) / calls
    return out


def phase_f1b():
    """F1b against ``control_pass_vjp`` on the card, on seeded cotangents,
    over the tape that F1 writes under a gradient (F1's outputs with the
    tape bit-equal to its outputs without): the short renders' 28 presets
    of each seed (4,096 samples) and the sound-match demo's one preset and
    shape (1,040 ticks); then F1b beside F1, taped and not, and the plain
    version at the corpus pass's shape (1,024, 2,768 ticks), held against
    the plain version there too, each of its three kernels by CUDA events,
    at the demo's shape, and on 8 items (the serial chain), with the
    earlier design's numbers beside."""
    from preset_gen_vae_tpu_torch.scripts import sound_match_demo as demo
    from preset_gen_vae_tpu_torch.synth import database as db
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    rng = np.random.default_rng(8)
    sr = 22050

    def taped(ctl, n_ticks, note_off):
        *outs, tape = ft._fm_control_launch(ctl, n_ticks, note_off, sr, taped=True)
        if not all(torch.equal(a, b) for a, b in zip(outs, ft.fm_control(ctl, n_ticks, note_off,
                                                                          sr))):
            raise AssertionError("F1's outputs with the tape differ from without")
        return tape

    def check(name, p, pitch, vel, n_ticks, note_off):
        d = ft.decode_presets(p)
        ctl = ft.control_params(d, torch.as_tensor(pitch).cuda(), torch.as_tensor(vel).cuda(), sr)
        gs = cotangents(rng, len(p), n_ticks)
        got = ft.fm_control_bwd(ctl, taped(ctl, n_ticks, note_off), n_ticks, note_off, sr, *gs)
        want = ft.control_pass_vjp(ctl, n_ticks, note_off, sr, *gs)
        torch.cuda.synchronize()
        errs = f1b_errors(got, want)
        worst = max(errs.values())
        print(f"[F1b {name}] {len(p)} items x {n_ticks} ticks, "
              f"{ft.control_bwd_chunks(len(p), n_ticks)} (chunks, ticks a chunk): max |err| / "
              f"largest entry by field {short_json(errs)} (bar {F1B_BAR})", flush=True)
        if not torch.isfinite(got).all() or worst > F1B_BAR:
            raise AssertionError(f"F1b against control_pass_vjp, {name}: {errs}")
        err["rel"] = max(err["rel"], worst)
        err["abs"] = max(err["abs"], float((got - want).abs().max()))

    regs = {k: v for k, v in ptxas_registers(ptxas_report(
        "fm_render", ft.fm_build_command(), ft.FM_SOURCE)).items() if "control" in k}
    print(f"[build] F1 and F1b registers and spills: {json.dumps(regs)}", flush=True)
    err = {"rel": 0.0, "abs": 0.0}  # the largest of f1b_errors, and of max |err| itself
    for seed in (0, 1):
        pr = short_check_presets(seed)
        check(f"seed {seed}", torch.from_numpy(pr).cuda(), *fm_notes(len(pr)),
              FM_SHORT // ft.BLOCK, int(0.1 * sr))
    demo_ticks = ft.samples_per_render(demo.TOTAL, demo.SR) // ft.BLOCK
    demo_off = int(demo.NOTE_ON * demo.SR)
    p_demo, _, _ = demo.problem(torch.device("cuda"))
    check("demo shape", p_demo, [demo.PITCH], [demo.VELOCITY], demo_ticks, demo_off)

    # ---- timing at the corpus pass's shape and at the demo's
    n_ticks, note_off = SAMPLES // ft.BLOCK, int(3.0 * sr)
    pr, _, _ = db.generate_structured_corpus_v2(1024, seed=0)
    d = ft.decode_presets(torch.from_numpy(pr).cuda())
    ctl = ft.control_params(d, torch.full((1024,), 60).cuda(), torch.full((1024,), 85).cuda(), sr)
    gs = cotangents(rng, 1024, n_ticks)
    tape = taped(ctl, n_ticks, note_off)
    row = {"F1": cuda_ms(lambda c: ft.fm_control(c, n_ticks, note_off, sr), [ctl], reps=3),
           "F1 taped": cuda_ms(lambda c: ft._fm_control_launch(c, n_ticks, note_off, sr,
                                                               taped=True), [ctl], reps=3),
           "F1b": cuda_ms(lambda c: ft.fm_control_bwd(c, tape, n_ticks, note_off, sr, *gs), [ctl],
                          reps=3)}
    row["F1b kernels"] = kernel_event_ms(
        lambda: ft.fm_control_bwd(ctl, tape, n_ticks, note_off, sr, *gs))
    got = ft.fm_control_bwd(ctl, tape, n_ticks, note_off, sr, *gs)
    t0 = time.perf_counter()
    want = ft.control_pass_vjp(ctl, n_ticks, note_off, sr, *gs)
    torch.cuda.synchronize()
    row["F1b plain"] = (time.perf_counter() - t0) * 1e3
    corpus_errs = f1b_errors(got, want)
    if max(corpus_errs.values()) > F1B_BAR:
        raise AssertionError(f"F1b against control_pass_vjp at (1024, {n_ticks}): {corpus_errs}")
    err["rel"] = max(err["rel"], max(corpus_errs.values()))
    err["abs"] = max(err["abs"], float((got - want).abs().max()))
    del got, want
    c8, g8 = ctl[:8].contiguous(), [g[:, :8].contiguous() for g in gs]
    tape8 = taped(c8, n_ticks, note_off)
    row["F1b 8 items"] = cuda_ms(
        lambda c: ft.fm_control_bwd(c, tape8, n_ticks, note_off, sr, *g8), [c8], reps=3)
    row["F1b bound"], row["F1b bound_by"] = bound(fm_control_bwd_work(1024, n_ticks))
    row["tape GB"] = ft.tape_bytes(1024, n_ticks) / 1e9
    row["chunks"] = ft.control_bwd_chunks(1024, n_ticks)
    del gs, g8, tape, tape8
    d1 = ft.decode_presets(p_demo)
    ctl1 = ft.control_params(d1, torch.tensor([demo.PITCH]).cuda(),
                             torch.tensor([demo.VELOCITY]).cuda(), sr)
    g1 = cotangents(rng, 1, demo_ticks)
    tape1 = taped(ctl1, demo_ticks, demo_off)
    row["F1b demo shape"] = cuda_ms(
        lambda c: ft.fm_control_bwd(c, tape1, demo_ticks, demo_off, sr, *g1), [ctl1], reps=10)
    row["F1 demo shape"] = cuda_ms(lambda c: ft.fm_control(c, demo_ticks, demo_off, sr), [ctl1],
                                   reps=10)
    row["F1 taped demo shape"] = cuda_ms(lambda c: ft._fm_control_launch(
        c, demo_ticks, demo_off, sr, taped=True), [ctl1], reps=10)
    row["F1b demo shape bound"] = bound(fm_control_bwd_work(1, demo_ticks))[0]
    row["chunks demo shape"] = ft.control_bwd_chunks(1, demo_ticks)
    print(f"[F1b at (1024, {n_ticks} ticks)] against control_pass_vjp, max |err| / largest entry "
          f"by field (bar {F1B_BAR}) {short_json(corpus_errs)}", flush=True)
    print(f"[F1b timing] {card_line()}: {json.dumps(row)}; F1b = {row['F1b'] / row['F1']:.3f} x "
          f"F1, {row['F1b'] / row['F1b bound']:.1f} x its bound, {row['F1b 8 items']:.3f} ms on "
          f"8 items (its chain); F1 taped = {row['F1 taped'] / row['F1']:.4f} x F1; the earlier "
          f"design's recorded times (not of this run) {json.dumps(F1B_EARLIER)}: "
          f"{F1B_EARLIER['ms'] / row['F1b']:.1f}x at the corpus shape, "
          f"{F1B_EARLIER['ms_demo_shape'] / row['F1b demo shape']:.1f}x at the demo's",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": "fm_control_bwd", "route": "cuda",
            "source": "preset_gen_vae_tpu_torch/csrc/fm_render.cu",
            "replaces": "preset_gen_vae_tpu/synth/fm_jax.py:339", "launches": None,
            "kernels": list(ft.F1B_KERNELS),
            "max_abs_err": err["abs"], "max_err_over_field_max": err["rel"],
            "ms": row["F1b"], "plain_ms": row["F1b plain"],
            "bound_ms": row["F1b bound"], "bound_by": row["F1b bound_by"], "library_ms": None,
            "kernel_ms": row["F1b kernels"],
            "serial_chain_ms": row["F1b 8 items"], "ms_demo_shape": row["F1b demo shape"],
            "bound_ms_demo_shape": row["F1b demo shape bound"], "f1_ms": row["F1"],
            "f1_taped_ms": row["F1 taped"], "chunks": row["chunks"], "registers": regs}


# F2b against exact_pass_vjp: each gradient field's max |err| over its
# largest entry in the plain version, as F1b's bar
F2B_BAR = 1e-4
F2B_FIELDS = ("amps", "starts", "incs", "fb_amt", "master_volume")


def item_finite(grads) -> torch.Tensor:
    """(B,) bool: every entry of the item's gradients is finite."""
    ok = None
    for g in grads:
        f = torch.isfinite(g).all(0).all(-1) if g.dim() == 3 else torch.isfinite(g)
        ok = f if ok is None else ok & f
    return ok


def f2b_errors(got, want, items, fb_items=None) -> dict:
    """Each field's max |F2b - plain| over the plain version's largest
    |entry| on the items ``items`` ((B,) bool); the ``fb_amt`` field on
    ``items & fb_items`` where that is given."""
    errs = {}
    for name, g, w in zip(F2B_FIELDS, got, want):
        sel = items & fb_items if name == "fb_amt" and fb_items is not None else items
        g, w = (g[:, sel], w[:, sel]) if g.dim() == 3 else (g[sel], w[sel])
        if w.numel() == 0:
            continue
        scale = float(w.abs().max())
        errs[name] = float((g - w).abs().max()) / (scale if scale > 0 else 1.0)
    return errs


def f2b_check(name, got, want, feedback, gate_fb7: bool, fb_items=None) -> dict:
    """Holds F2b against its plain version: the items at feedback <= 6 as one
    group at ``F2B_BAR``; each feedback-7 item whose plain gradient is
    finite alone, gated if ``gate_fb7`` and printed otherwise; an item
    whose plain gradient is not finite (a loud feedback-7 loop's true
    gradient outgrows f32) printed with the non-finite entries on each side.
    -> {"rel": worst gated error, "abs": its max |err|}."""
    finite = item_finite(want)
    low = feedback <= 6
    if not bool(finite[low].all()):
        raise AssertionError(f"F2b {name}: the plain gradient is not finite at feedback <= 6")
    errs = f2b_errors(got, want, low, fb_items)
    worst = max(errs.values())
    fb7, bad = [], []
    for b in torch.nonzero(feedback == 7).flatten().tolist():
        one = torch.zeros_like(low)
        one[b] = True
        if bool(finite[b]):
            fb7.append(max(f2b_errors(got, want, one).values()))
        else:
            bad.append((b, *(sum(int((~torch.isfinite(g[:, b] if g.dim() == 3 else g[b])).sum())
                                 for g in gs) for gs in (want, got))))
    print(f"[F2b {name}] {int(low.sum())} items at feedback <= 6: max |err| / largest entry by "
          f"field {short_json(errs)} (bar {F2B_BAR}); {len(fb7)} feedback-7 items with a finite "
          f"plain gradient, each alone ({'gated' if gate_fb7 else 'printed'}): max "
          f"{max(fb7, default=0.0):.2e}; {len(bad)} with a non-finite one (item, non-finite "
          f"entries plain / F2b): {bad}", flush=True)
    gated = max([worst] + (fb7 if gate_fb7 else []))
    if not all(torch.isfinite(g[:, low] if g.dim() == 3 else g[low]).all() for g in got) or \
            gated > F2B_BAR:
        raise AssertionError(f"F2b against its plain version, {name}: {errs}, feedback 7 {fb7}")
    abs_err = max(float((g - w).abs()[:, low].max() if g.dim() == 3 else (g - w).abs()[low].max())
                  for g, w in zip(got, want))
    return {"rel": gated, "abs": abs_err}


def split_vjp(amps, starts, incs, alg, fb_amt, nc, mv, sr, g_out):
    """``exact_pass_vjp`` through F2's two plain phases, ``feedback_loop_pass``
    and ``feedforward_pass``, which compose ``exact_pass`` (within 1e-6,
    tests/test_torch_port_fm.py): the cheaper oracle at full length. Its
    ``fb_amt`` gradient is 0 on the items at feedback 0 (no loop runs
    there)."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in (amps, starts, incs, fb_amt, mv)]
        ph, am = ft.sample_phases(xs[1], xs[2]), ft.upsample_amps(xs[0])
        loop = ft.feedback_loop_pass(ph, am, alg, xs[3])
        out = ft.fade_and_volume(ft.feedforward_pass(ph, am, alg, xs[3], loop), nc, xs[4], sr)
        return torch.autograd.grad(out, xs, g_out)


def fm_exact_bwd_work(lengths, n_ticks: int):
    """(bytes, flops) of F2's backward on this run's items: the waveforms'
    cotangent read once, the loop source's output (the tape) on the items
    with feedback read once, F1's three (T, B, 6) arrays read and their
    gradients written once, the per-item scalars; per item and sample the
    forward's 198 operations recomputed, the adjoint of the six operators
    (~10 each: the two products of the sine's derivative, the modulation
    sum, the three per-tick products) and of the fade, clip and volume
    (~10), and on an item with a loop of L operators the loop recomputed
    with its cosines twice (~35 L each) and the recurrence (4)."""
    n, B = 32 * n_ticks, len(lengths)
    ls = lengths.tolist()
    n_fb = sum(1 for x in ls if x)
    nbytes = 4 * (B * n + n_fb * n + 6 * n_ticks * B * 6 + 5 * B)
    return nbytes, sum(n * (198 + 70 + (70 * x + 4 if x else 0)) for x in ls)


def ptxas_registers(report: str) -> dict:
    """{kernel: ptxas' register and spill lines} from ``ptxas_report``;
    F2's feed-forward kernel as ``<true>`` (taped) and ``<false>``."""
    import re

    out, name = {}, None
    for ln in report.splitlines():
        if "Compiling entry" in ln:
            mangled = re.search(r"'([^']+)'", ln).group(1)
            name = re.match(r"_Z\d+(\w+?_kernel)", mangled).group(1)
            name += {"ILb1E": "<true>", "ILb0E": "<false>"}.get(mangled[len(name) + 4:][:5], "")
            out[name] = ""
        elif name and ("registers" in ln or "spill" in ln):
            out[name] = (out[name] + "; " + ln.split(":", 1)[-1].strip()).lstrip("; ")
    return out


# the earlier F2b design, three kernels with the recurrence one thread per
# item, on an NVIDIA H100 80GB HBM3 at 700 W: ms at (1,024 items, 88,576
# samples) and its kernels' device time by the profiler, at 20,480 items,
# at the demo's shape (1 item, 33,280 samples), and its recurrence on 32
# items (its serial chain)
F2B_EARLIER = {"ms": 6.835, "kernel_ms_profiled": {
    "fm_exact_bwd_ff": 3.252, "fm_exact_bwd_rec": 1.591, "fm_exact_bwd_loop": 2.002},
    "ms_20480": 98.18, "ms_demo_shape": 0.795, "serial_chain_ms": 1.647}


def phase_f2b():
    """F2b against ``exact_pass_vjp`` on the card, both fed the same F1
    outputs, on seeded cotangents: the short renders' 28 presets of each
    seed (4,096 samples; F2's output with the tape on held bit-equal to its
    output without it), the sound-match demo's one preset and shape
    (33,280 samples), and the corpus pass's shape (1,024 items, 88,576
    samples) against the plain phases' composition (``split_vjp``); F2b
    timed there (each kernel by CUDA events) and at 20,480 items beside
    F2, at the demo's shape, and on one item with a loop of three
    operators at full length (its serial chain), with the earlier design's
    numbers beside."""
    from preset_gen_vae_tpu_torch.scripts import sound_match_demo as demo
    from preset_gen_vae_tpu_torch.synth import database as db
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    regs = {k: v for k, v in ptxas_registers(ptxas_report(
        "fm_render", ft.fm_build_command(), ft.FM_SOURCE)).items() if "exact" in k}
    print(f"[build] F2 and F2b registers and spills: {json.dumps(regs)}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(9)
    sr = 22050
    err = {"rel": 0.0, "abs": 0.0}

    def normal(*shape):  # seeded, made on the card: 1.8e9 of them at 20,480 items
        return torch.randn(shape, generator=gen, device="cuda")

    def feedback_of(p):
        return torch.round(p[:, 5].clamp(0, 1) * 7)

    def check(name, p, pitch, vel, n_ticks, note_off, gate_fb7, oracle=ft.exact_pass_vjp,
              fb_only=False):
        _, args, _ = fm_inputs(p, pitch, vel, sr, n_ticks, note_off)
        g = normal(len(p), n_ticks * ft.BLOCK)
        out, tape = ft._fm_exact_launch(*args, taped=True)
        if not torch.equal(out, ft.fm_exact(*args)):
            raise AssertionError(f"F2b {name}: F2's output with the tape differs from without")
        got = ft.fm_exact_bwd(tape, *args, g)
        del out
        want = oracle(*args, g)
        torch.cuda.synchronize()
        r = f2b_check(name, got, want, feedback_of(p), gate_fb7,
                      (args[4] != 0) if fb_only else None)
        err["rel"], err["abs"] = max(err["rel"], r["rel"]), max(err["abs"], r["abs"])
        return args, g, tape

    for seed in (0, 1):
        pr = short_check_presets(seed)
        check(f"seed {seed}", torch.from_numpy(pr).cuda(), *fm_notes(len(pr)),
              FM_SHORT // ft.BLOCK, int(0.1 * sr), gate_fb7=True)
    demo_ticks = ft.samples_per_render(demo.TOTAL, demo.SR) // ft.BLOCK
    demo_off = int(demo.NOTE_ON * demo.SR)
    p_demo, _, _ = demo.problem(torch.device("cuda"))
    a1, g1, tape1 = check("demo shape", p_demo, [demo.PITCH], [demo.VELOCITY], demo_ticks,
                          demo_off, gate_fb7=True)
    row = {"F2b demo shape": cuda_ms(lambda a: ft.fm_exact_bwd(tape1, *a, g1), [a1], reps=10),
           "F2 demo shape": cuda_ms(lambda a: ft.fm_exact(*a), [a1], reps=10)}
    lengths1 = ft.loop_lengths(a1[3], a1[4])
    row["F2b demo shape bound"] = bound(fm_exact_bwd_work(lengths1, demo_ticks))[0]
    del a1, g1, tape1

    # ---- the corpus pass's shape: held against the plain phases' composition
    n_ticks, note_off = SAMPLES // ft.BLOCK, int(3.0 * sr)
    pr, _, _ = db.generate_structured_corpus_v2(1024, seed=0)
    p = torch.from_numpy(pr).cuda()
    timed = {}

    def timed_split_vjp(*a):
        t0 = time.perf_counter()
        out = split_vjp(*a)
        torch.cuda.synchronize()
        timed["s"] = time.perf_counter() - t0
        return out

    args, g, tape = check("at (1024, 88576)", p, np.full(1024, 60), np.full(1024, 85), n_ticks,
                          note_off, gate_fb7=False, oracle=timed_split_vjp, fb_only=True)
    row["F2b plain (split_vjp)"] = timed["s"] * 1e3
    row["F2"] = cuda_ms(lambda a: ft.fm_exact(*a), [args], reps=3)
    row["F2 taped"] = cuda_ms(lambda a: ft._fm_exact_launch(*a, taped=True), [args], reps=3)
    row["F2b"] = cuda_ms(lambda a: ft.fm_exact_bwd(tape, *a, g), [args], reps=3)
    row["F2b kernels"] = kernel_event_ms(lambda: ft.fm_exact_bwd(tape, *args, g))
    row["splits"] = ft.exact_bwd_splits(1024, n_ticks)
    # memory of a backward above its forward
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ft.fm_exact_bwd(tape, *args, g)
    torch.cuda.synchronize()
    row["F2b peak above its inputs GiB"] = (torch.cuda.max_memory_allocated() - before) / 2**30
    row["tape GB"] = tape.numel() * 4 / 1e9
    # the serial chain: one item with a loop of three operators alone, its
    # ticks in the most splits (a step or two each): the splits' walks and
    # the chain over the splits
    fba = args[4]
    lengths = ft.loop_lengths(args[3], fba)
    i3 = torch.nonzero(lengths == 3).flatten()[:1]
    one = [a[:, i3].contiguous() if a.dim() == 3 else a[i3].contiguous() for a in args[:7]]
    tape_1, g_1 = tape[i3].contiguous(), g[i3].contiguous()
    row["F2b 1 item"] = cuda_ms(lambda a: ft.fm_exact_bwd(tape_1, *a, sr, g_1), [one], reps=10)
    row["splits 1 item"] = ft.exact_bwd_splits(1, n_ticks)
    del one, tape_1, g_1
    row["F2b bound"], row["F2b bound_by"] = bound(fm_exact_bwd_work(lengths, n_ticks))
    row["items by loop length"] = {n: lengths.tolist().count(n) for n in range(4)}
    del args, g, tape, p
    gc.collect()
    torch.cuda.empty_cache()
    pr, _, _ = db.generate_structured_corpus_v2(20480, seed=0)
    p = torch.from_numpy(pr).cuda()
    _, args, _ = fm_inputs(p, np.full(20480, 60), np.full(20480, 85), sr, n_ticks, note_off)
    g = normal(20480, SAMPLES)
    _, tape = ft._fm_exact_launch(*args, taped=True)
    row["F2b 20480"] = cuda_ms(lambda a: ft.fm_exact_bwd(tape, *a, g), [args], reps=3)
    row["F2 taped 20480"] = cuda_ms(lambda a: ft._fm_exact_launch(*a, taped=True), [args], reps=3)
    row["F2b bound 20480"] = bound(fm_exact_bwd_work(ft.loop_lengths(args[3], args[4]),
                                                     n_ticks))[0]
    del args, g, tape, p
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[F2b timing] {card_line()}: {json.dumps(row)}; F2b = {row['F2b'] / row['F2']:.3f} x "
          f"F2, {row['F2b'] / row['F2b bound']:.1f} x its bound; one item with a loop of three "
          f"(the chain) {row['F2b 1 item']:.3f} ms; the earlier design's recorded times (not of "
          f"this run) {json.dumps(F2B_EARLIER)}: "
          f"{F2B_EARLIER['ms'] / row['F2b']:.1f}x at the corpus shape, "
          f"{F2B_EARLIER['ms_demo_shape'] / row['F2b demo shape']:.1f}x at the demo's",
          flush=True)
    return {"name": "fm_exact_bwd", "route": "cuda",
            "source": "preset_gen_vae_tpu_torch/csrc/fm_render.cu",
            "replaces": "preset_gen_vae_tpu/synth/fm_jax.py:489", "launches": None,
            "kernels": list(ft.F2B_KERNELS),
            "max_abs_err": err["abs"], "max_err_over_field_max": err["rel"],
            "ms": row["F2b"], "plain_ms": row["F2b plain (split_vjp)"],
            "bound_ms": row["F2b bound"], "bound_by": row["F2b bound_by"], "library_ms": None,
            "serial_chain_ms": row["F2b 1 item"],
            "kernel_ms": row["F2b kernels"], "splits": row["splits"],
            "ms_20480": row["F2b 20480"], "bound_ms_20480": row["F2b bound 20480"],
            "ms_demo_shape": row["F2b demo shape"],
            "bound_ms_demo_shape": row["F2b demo shape bound"], "registers": regs}


def grad_of_demo_loss(demo, render_fn, p, targets):
    x = p.clone().requires_grad_(True)
    loss = demo.spec_loss(demo.render(x, render_fn), targets)
    (g,) = torch.autograd.grad(loss, x)
    return loss.item(), g


SOUND_MATCH_BAR = {"grad": 1e-3, "losses": 1e-3, "reduction": 10.0}
SOUND_MATCH_PLAIN_STEPS = 10


def phase_sound_match():
    """The sound-match demo on the card. First the gradient of its loss at
    its corrupted preset through ``render_batch`` (F1, F1b) against the same
    through ``plain_render`` on the card (max |err| over the largest entry,
    ``SOUND_MATCH_BAR['grad']``); then the path: ``main`` at its own
    constants (400 Adam steps; F1 launched for the target, the initial
    loss and each step, F1b for each step; reduction at least 10x); its
    first 10 losses against 10 steps through ``plain_render`` (relative
    ``SOUND_MATCH_BAR['losses']``); and where a step's time goes (a
    profile of 5 steps)."""
    from preset_gen_vae_tpu_torch.scripts import sound_match_demo as demo
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    dev = torch.device("cuda")
    p, mask, targets = demo.problem(dev)
    loss_k, g_k = grad_of_demo_loss(demo, ft.render_batch, p, targets)
    loss_p, g_p = grad_of_demo_loss(demo, ft.plain_render, p, targets)
    g_err = float((g_k - g_p).abs().max()) / float(g_p.abs().max())
    print(f"[sound_match gradient] demo loss {loss_k:.7f} (plain {loss_p:.7f}); d loss / d preset "
          f"through F1/F1b against plain_render on the card: max |err| / largest entry "
          f"{g_err:.3e} (bar {SOUND_MATCH_BAR['grad']}), largest entry "
          f"{float(g_p.abs().max()):.4e}, {int((g_p != 0).sum())} nonzero entries", flush=True)
    if not torch.isfinite(g_k).all() or g_err > SOUND_MATCH_BAR["grad"]:
        raise AssertionError(f"sound_match gradient: {g_err}")

    counts = {}
    steps = demo.STEPS
    summary, counts["sound_match"], wall, mem = drive(
        "sound_match", lambda: demo.main(["--device", "cuda"]), k1=0, f1=steps + 2, bwd=steps)
    losses = summary.pop("losses")
    print(f"[sound_match path] {json.dumps(summary)}", flush=True)
    t0 = time.perf_counter()
    _, plain_losses, _ = demo.fit(p, mask, targets, SOUND_MATCH_PLAIN_STEPS, ft.plain_render)
    plain_s = time.perf_counter() - t0
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    print(f"[sound_match path] wall {wall:.2f} s, {summary['wall_s'] / steps * 1e3:.2f} ms a step "
          f"(the steps' wall {summary['wall_s']} s), launches {counts['sound_match']}, peak device "
          f"memory {mem:.3f} GiB; losses {losses[0]:.6f} -> {losses[-1]:.6f}; first "
          f"{SOUND_MATCH_PLAIN_STEPS} losses against plain_render's max relative |err| {rel:.3e} "
          f"(bar {SOUND_MATCH_BAR['losses']}; plain {plain_s / SOUND_MATCH_PLAIN_STEPS:.3f} s a "
          f"step)", flush=True)
    if not np.isfinite(losses).all() or summary["reduction"] < SOUND_MATCH_BAR["reduction"] or \
            rel > SOUND_MATCH_BAR["losses"]:
        raise AssertionError(f"sound_match: {summary}, first losses {losses[:10]} against plain "
                             f"{plain_losses}")
    sound_match_profile(demo, p, mask, targets)
    return counts, summary["reduction"]


def exact_render(p, *args, **kw):
    """``render_batch`` with the feedback mode pinned to ``'exact'``."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    return ft.render_batch(p, *args, **dict(kw, feedback="exact"))


def plain_exact_render(p, *args, **kw):
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    return ft.plain_render(p, *args, **dict(kw, feedback="exact"))


def phase_sound_match_exact(unrolled_reduction: float):
    """The sound-match demo's objective through the ``'exact'`` render on the
    card (``exact_render``): its gradient at the corrupted preset through
    F1/F2 and F2b/F1b (one call of each) against ``plain_render``'s on the
    card (``SOUND_MATCH_BAR['grad']``; one plain step, timed); then ``main``
    at its constants through that render (400 Adam steps; F1 and F2 402
    calls, F1b and F2b 400), all losses finite and the last below the
    first; and a profile of 5 steps."""
    from preset_gen_vae_tpu_torch.scripts import sound_match_demo as demo
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    dev = torch.device("cuda")
    p, mask, targets = demo.problem(dev, exact_render)
    n0 = dict(ft.LAUNCHES)
    loss_k, g_k = grad_of_demo_loss(demo, exact_render, p, targets)
    torch.cuda.synchronize()
    calls = {k: ft.LAUNCHES[k] - n0[k] for k in ("fm_control", "fm_exact", "fm_control_bwd",
                                                  "fm_exact_bwd")}
    t0 = time.perf_counter()
    loss_p, g_p = grad_of_demo_loss(demo, plain_exact_render, p, targets)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    g_err = float((g_k - g_p).abs().max()) / float(g_p.abs().max())
    print(f"[sound_match_exact gradient] demo loss through 'exact' {loss_k:.7f} (plain "
          f"{loss_p:.7f}); d loss / d preset through F1/F2 and F2b/F1b against plain_render's "
          f"on the card: max |err| / largest entry {g_err:.3e} (bar {SOUND_MATCH_BAR['grad']}), "
          f"largest entry {float(g_p.abs().max()):.4e}, {int((g_p != 0).sum())} nonzero "
          f"entries; calls {calls}; a plain exact step {plain_s:.1f} s", flush=True)
    if not torch.isfinite(g_k).all() or g_err > SOUND_MATCH_BAR["grad"] or \
            calls != {"fm_control": 1, "fm_exact": 1, "fm_control_bwd": 1, "fm_exact_bwd": 1}:
        raise AssertionError(f"sound_match_exact gradient: {g_err}, calls {calls}")
    counts = {}
    steps = demo.STEPS
    n_ticks = ft.samples_per_render(demo.TOTAL, demo.SR) // ft.BLOCK
    summary, counts["sound_match_exact"], wall, mem = drive(
        "sound_match_exact", lambda: demo.main(["--device", "cuda"], render_fn=exact_render),
        fm=steps + 2, k1=0, bwd=steps, bwd2=steps, n_ticks=n_ticks)
    losses = summary.pop("losses")
    print(f"[sound_match_exact path] {json.dumps(summary)}", flush=True)
    print(f"[sound_match_exact path] wall {wall:.2f} s, {summary['wall_s'] / steps * 1e3:.2f} ms a "
          f"step (the steps' wall {summary['wall_s']} s), launches {counts['sound_match_exact']}, "
          f"peak device memory {mem:.3f} GiB; losses {losses[0]:.6f} -> {losses[-1]:.6f}, "
          f"reduction {summary['reduction']}x ('unrolled' path: {unrolled_reduction}x)",
          flush=True)
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"sound_match_exact: {summary}, losses {losses[:5]} ... "
                             f"{losses[-5:]}")
    sound_match_profile(demo, p, mask, targets, render_fn=exact_render, name="sound_match_exact")
    return counts


def sound_match_profile(demo, p, mask, targets, steps: int = 5, render_fn=None,
                        name: str = "sound_match"):
    """torch.profiler over ``steps`` demo steps (through ``render_fn``, the
    demo's own by default): device-busy share of the window, kernel
    launches a step, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    render_fn = render_fn or demo.fm_torch.render_batch
    demo.fit(p, mask, targets, 2, render_fn)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        demo.fit(p, mask, targets, steps, render_fn)
        torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0 and e.device_type.name == "CUDA":
            rows.append((dev_us / 1e3 / steps, e.count / steps, e.key))
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    top = [f"{k[:60]} {ms:.3f} ms ({n:.0f})" for ms, n, k in rows[:8]]
    print(f"[{name} profile] {steps} steps, {window_ms / steps:.2f} ms a step on the host "
          f"clock (profiled), device {busy:.3f} ms a step ({busy * steps / window_ms:.1%} busy), "
          f"{sum(r[1] for r in rows):.0f} kernel launches a step; top: {'; '.join(top)}",
          flush=True)


CORPUS = {"n_synthetic_presets": 1024}  # the main path's synthetic corpus
# the saved multi-note runs' corpus: the generator they trained on
# (scripts/run_stack3_v2_r5.py:68-77)
CORPUS_V2 = {"n_synthetic_presets": 1024, "synthetic_style": "structured2"}


def fresh_corpus(corpus: dict, root, name: str) -> dict:
    """``corpus`` with a data root of the path's own: its 'disk' corpus cache
    starts empty, so the path's corpus pass is cold and launches K1."""
    return dict(corpus, data_root=str(pathlib.Path(root) / "data_cache" / name.replace(" ", "_")))


# one compact line per driven path, printed again just before the last line
SUMMARY = []


def drive(name: str, fn, fm: int = 0, k1=None, f1=None, bwd: int = 0, bwd2: int = 0,
          n_ticks: int = SAMPLES // 32):
    """Runs one path of the main path with every kernel's launch count set
    to 0 just before it and read just after; fails unless K1 launched (or,
    with ``k1``, launched exactly ``k1`` times: 0 on a warm path), unless
    F1 and F2 each launched ``fm`` times (the path's on-device renders:
    one per note of a 'jax' corpus pass, one per eval batch; ``f1`` for F1
    where it differs: the unrolled renders of the sound-match path) and
    F2's two phases (``fm_fb_loop``, ``fm_exact_ff``) once per segment of
    each F2 call (renders of ``n_ticks`` ticks), unless F1b and each of its
    three kernels launched ``bwd`` times (one per gradient through the
    render) and F2b and each of its three kernels ``bwd2`` times (one per
    gradient through F2). Records the path's line of ``SUMMARY``.
    -> (result, launches, wall seconds, peak device GiB)."""
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    for counts in (sp.LAUNCHES, ft.LAUNCHES):
        for k in counts:
            counts[k] = 0
    gc.collect()  # the previous path's tensors must not count in this one's peak
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**sp.LAUNCHES, **ft.LAUNCHES}
    if (launches["logmel"] < 1) if k1 is None else (launches["logmel"] != k1):
        raise AssertionError(f"K1 launched {launches['logmel']} times on the {name} path, want "
                             f"{'at least 1' if k1 is None else k1}: {launches}")
    n_seg = len(ft.exact_segments(n_ticks))
    want = {"fm_control": fm if f1 is None else f1, "fm_exact": fm, "fm_fb_loop": fm * n_seg,
            "fm_exact_ff": fm * n_seg, **{k: bwd for k in ("fm_control_bwd", *ft.F1B_KERNELS)},
            **{k: bwd2 for k in ("fm_exact_bwd", *ft.F2B_KERNELS)}}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"{name} path: F1/F2/F1b/F2b launched {launches}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    line = {"path": name, "wall_s": round(wall, 3), "peak_gib": round(peak, 3),
            "launches": {k: n for k, n in launches.items() if n}}
    if isinstance(result, dict):
        line.update({k: result[k] for k in ("step_ms", "corpus_seconds", "reduction")
                     if isinstance(result.get(k), (int, float))})
    SUMMARY.append(line)
    return result, launches, wall, peak


def check_train_summary(name: str, summary: dict, epochs_trained: int,
                        input_size=(160, 1, 257, 347), dim_z: int = 610):
    bad = {k: v for k, v in summary.items() if isinstance(v, float) and not np.isfinite(v)}
    if bad:
        raise AssertionError(f"{name}: non-finite metrics: {bad}")
    if summary["dim_z"] != dim_z or summary["input_size"] != list(input_size):
        raise AssertionError(f"{name}: not the configuration's shapes: {summary}")
    if summary["epochs_trained"] != epochs_trained:
        raise AssertionError(f"{name}: epochs_trained {summary['epochs_trained']}")
    print(f"[{name} path] {json.dumps(summary, sort_keys=True)}", flush=True)


def phase_main_path(root: str):
    """The flagship through the port's entry points, three paths in turn:
    train 2 epochs, resume for a third, evaluate the validation split;
    -> (launch counts by path, the train path's summary)."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.evaluation.evaluate import evaluate_model_from_dir
    from preset_gen_vae_tpu_torch.logs.logger import list_checkpoint_epochs, load_checkpoint
    from preset_gen_vae_tpu_torch.training.loop import train_config

    model_c = cfg.ModelConfig(logs_root_dir=root)
    train_c = cfg.TrainConfig(n_epochs=2, minibatch_size=160, lr_warmup_epochs=0, save_period=1,
                              verbosity=1)
    counts = {}

    # ---- train: checkpoints follow the JAX cadence, (epoch > 0 and epoch %
    # save_period == 0) or the last epoch: epoch 1 only
    summary, counts["train"], wall, mem = drive("train", lambda: train_config(
        model_c, train_c, dataset_kwargs=fresh_corpus(CORPUS, root, "train"), device="cuda",
        use_tensorboard=False))
    check_train_summary("train", summary, 2)
    train_summary = summary
    if list_checkpoint_epochs(model_c) != [1]:
        raise AssertionError(f"train: checkpoints {list_checkpoint_epochs(model_c)}, want [1]")
    sched = load_checkpoint(model_c, 1)["scheduler"]
    plateau_loss = summary["ReconsLoss/Backprop/Valid"] + summary["Controls/BackpropLoss/Valid"]
    if not math.isclose(sched["best"], plateau_loss, rel_tol=1e-9):  # it stepped after epoch 1
        raise AssertionError(f"train: plateau scheduler {sched}, validation loss {plateau_loss}")
    print(f"[train path] wall {wall:.2f} s, model build {summary['model_build_seconds']:.2f} s, "
          f"K1 launches {counts['train']['logmel']}, "
          f"{summary['train_steps']} steps, steady step {summary['step_ms']:.2f} ms (first "
          f"{summary['first_step_ms']:.1f} ms), corpus pass {summary['corpus_seconds']:.3f} s "
          f"(render {summary['corpus_render_seconds']:.3f} s), peak device memory {mem:.2f} GiB; "
          f"checkpoints {list_checkpoint_epochs(model_c)}, scheduler {sched}", flush=True)

    # ---- resume: a third epoch from checkpoint 1, the dataset rebuilt
    resume_c = dataclasses.replace(train_c, start_epoch=2, n_epochs=3)
    summary, counts["resume"], wall, mem = drive("resume", lambda: train_config(
        model_c, resume_c, dataset_kwargs=fresh_corpus(CORPUS, root, "resume"), device="cuda",
        use_tensorboard=False))
    check_train_summary("resume", summary, 3)
    restored = load_checkpoint(model_c, 1)
    steps_per_epoch = summary["train_steps"]
    if not summary["start_step"] == restored["state"]["step"] == 2 * steps_per_epoch:
        raise AssertionError(f"resume: step {summary['start_step']}, checkpoint "
                             f"{restored['state']['step']}, {steps_per_epoch} steps an epoch")
    if any(lr != restored["scheduler"]["lr"] for lr in summary["start_lr"]):
        raise AssertionError(f"resume: LRs {summary['start_lr']} vs {restored['scheduler']}")
    if list_checkpoint_epochs(model_c) != [1, 2]:
        raise AssertionError(f"resume: checkpoints {list_checkpoint_epochs(model_c)}")
    print(f"[resume path] wall {wall:.2f} s, K1 launches {counts['resume']['logmel']}, restored "
          f"step {summary['start_step']} = 2 x {steps_per_epoch}, LR {summary['start_lr']} in "
          f"every group = the scheduler's {restored['scheduler']['lr']}, model build "
          f"{summary['model_build_seconds']:.2f} s, steady step "
          f"{summary['step_ms']:.2f} ms, peak device memory {mem:.2f} GiB; checkpoints "
          f"{list_checkpoint_epochs(model_c)}", flush=True)

    # ---- eval: the validation split of checkpoint 2, re-rendered and scored
    phases = {}
    # the default 'jax' re-render: 164 items, one batch, one F1 and one F2 launch
    _, counts["eval"], wall, mem = drive("eval", lambda: evaluate_model_from_dir(
        summary["run_dir"], cfg.EvalConfig(dataset="validation"),
        dataset_kwargs=fresh_corpus(CORPUS, root, "eval"), phase_seconds=phases), fm=1)
    with open(f"{summary['run_dir']}/eval_validation_summary.json") as f:
        ev = json.load(f)
    items = np.load(f"{summary['run_dir']}/eval_validation.items.npz")
    if ev["n_items"] != 164 or len(items["preset_UID"]) != 164:
        raise AssertionError(f"eval: {ev['n_items']} items, want 164")
    for k in ("num_eval_loss", "num_mae", "num_mae_dyn", "acc", "acc_dyn", "spec_mae",
              "mfcc13_mae", "mfcc40_mae"):
        if not np.isfinite(items[k]).all():
            raise AssertionError(f"eval: non-finite {k}")
    if int(np.isnan(items["spec_sc"]).sum()) != ev.get("n_nan_spec_sc", 0) or \
            not np.isfinite(items["spec_sc"][~np.isnan(items["spec_sc"])]).all():
        raise AssertionError("eval: spec_sc has values that are neither finite nor counted")
    print(f"[eval path] {json.dumps(ev, sort_keys=True)}", flush=True)
    print(f"[eval path] wall {wall:.2f} s, launches {counts['eval']}, 164 items (2 batches), "
          f"re-render of 328 notes on the card {phases['render']:.3f} s, seconds per phase "
          f"{json.dumps(phases)}, peak device memory {mem:.2f} GiB", flush=True)
    return counts, train_summary


# the profile path's corpus: 6 train steps an epoch at batch 160 (1,024
# presets give 4), so that the first epoch holds the profiler's 5-step window
PROFILE_CORPUS = {"n_synthetic_presets": 1536}
VALID_LOSSES = ("ReconsLoss/Backprop/Valid", "LatLoss/Valid", "Controls/BackpropLoss/Valid")


def trace_report(trace_path: pathlib.Path, n_steps: int = 5) -> dict:
    """The profiler's Chrome trace: the ``train_step`` spans, the kernel
    launches the host made inside each, the kernels' device time by name,
    and the device-busy share of the window (from the first span's start
    to the last kernel's end; the union of the kernels' intervals)."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("name") == "train_step" and e.get("cat") == "user_annotation")
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    launches = [e["ts"] for e in events if e.get("cat") == "cuda_runtime"
                and "LaunchKernel" in str(e.get("name"))]
    per_step = [sum(a <= t <= b for t in launches) for a, b in spans]
    if len(spans) != n_steps or not kernels or min(per_step, default=0) < 1:
        raise AssertionError(f"profile: {len(spans)} train_step spans, {len(kernels)} kernel "
                             f"events, launches by step {per_step}; want {n_steps} steps, each "
                             f"launching kernels")
    start = spans[0][0]
    end = max(e["ts"] + e["dur"] for e in kernels)
    busy, cursor = 0.0, start
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels):
        a, b = max(a, cursor), min(b, end)
        if b > a:
            busy, cursor = busy + b - a, b
    by_name = collections.Counter()
    for e in kernels:
        by_name[e["name"]] += e["dur"]
    return {"steps": len(spans), "window_ms": (end - start) / 1e3, "device_ms": busy / 1e3,
            "busy_share": busy / (end - start), "kernel_events": len(kernels),
            "launches_by_step": per_step,
            "top": [(name[:80], us / 1e3) for name, us in by_name.most_common(5)]}


def phase_profile_path(root: str):
    """The flagship trains one epoch with the step profiler on: the trace
    of the first 5 steps lands in ``<run_dir>/profile/trace.json``."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.training.loop import train_config

    model_c = cfg.ModelConfig(logs_root_dir=root, run_name="profile")
    train_c = cfg.TrainConfig(n_epochs=1, minibatch_size=160, lr_warmup_epochs=0, verbosity=1,
                              profiler_args={"enabled": True})
    summary, counts, wall, mem = drive("profile", lambda: train_config(
        model_c, train_c, dataset_kwargs=fresh_corpus(PROFILE_CORPUS, root, "profile"),
        device="cuda", use_tensorboard=False))
    check_train_summary("profile", summary, 1)
    rep = trace_report(pathlib.Path(summary["run_dir"]) / "profile" / "trace.json")
    top = "; ".join(f"{name} {ms:.3f} ms" for name, ms in rep["top"])
    print(f"[profile path] {card_line()}: wall {wall:.2f} s, K1 launches {counts['logmel']}, "
          f"{summary['train_steps']} steps (steady {summary['step_ms']:.2f} ms, first "
          f"{summary['first_step_ms']:.1f} ms, profiled); trace of {rep['steps']} steps: window "
          f"{rep['window_ms']:.2f} ms, device busy {rep['device_ms']:.2f} ms "
          f"({rep['busy_share']:.1%}), {rep['kernel_events']} kernels, "
          f"{rep['kernel_events'] / rep['steps']:.0f} a step (launches by step "
          f"{rep['launches_by_step']}); top 5 by device time over the window: {top}; peak "
          f"device memory {mem:.2f} GiB", flush=True)
    return {"profile": counts}


def phase_multiproc1(root: str, train_summary: dict):
    """The main train path again under an NCCL process group of one, with
    ``force_multihost_data``: the loaders carved, rank 0's weights
    broadcast, gradients and scalars all-reduced; the validation losses
    held to the train path's within 2e-3 relative."""
    import torch.distributed as dist

    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.training.loop import train_config

    dist.init_process_group("nccl", init_method=f"file://{root}/nccl_store", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        model_c = cfg.ModelConfig(logs_root_dir=root, run_name="multiproc1")
        train_c = cfg.TrainConfig(n_epochs=2, minibatch_size=160, lr_warmup_epochs=0,
                                  save_period=1, verbosity=1, force_multihost_data=True)
        summary, counts, wall, mem = drive("multiproc1", lambda: train_config(
            model_c, train_c, dataset_kwargs=fresh_corpus(CORPUS, root, "multiproc1"),
            device="cuda", use_tensorboard=False))
    finally:
        dist.destroy_process_group()
    check_train_summary("multiproc1", summary, 2)
    rel = {k: abs(summary[k] - train_summary[k]) / abs(train_summary[k]) for k in VALID_LOSSES}
    if summary["world_size"] != 1 or max(rel.values()) > 2e-3:
        raise AssertionError(f"multiproc1: world {summary['world_size']}, validation losses "
                             f"{rel} relative from the train path's (bar 2e-3)")
    print(f"[multiproc1 path] {card_line()}: NCCL world of 1, wall {wall:.2f} s, K1 launches "
          f"{counts['logmel']}, steady step {summary['step_ms']:.2f} ms (train path "
          f"{train_summary['step_ms']:.2f} ms), validation losses relative to the train path's "
          f"{json.dumps(rel)} (bar 2e-3), peak device memory {mem:.2f} GiB", flush=True)
    return {"multiproc1": counts}


MULTIPROC2_BATCH = 160


def multiproc2_inputs():
    """The flagship's configs and 160 seeded rows (x, v, info) made on the
    card; rows 0-2 have three silent operators (the categorical loss's
    useful items then differ between the two halves)."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
    from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
    from preset_gen_vae_tpu_torch.synth import dexed_params as dx

    B = MULTIPROC2_BATCH
    helper = PresetIndexesHelper(build_dexed_preset_spec())
    L = helper.learnable_preset_size
    model_c, train_c = cfg.resolve(cfg.ModelConfig(),
                                   cfg.TrainConfig(minibatch_size=B, compute_dtype="float32"))
    model_c = dataclasses.replace(model_c, synth_params_count=L,
                                  learnable_params_tensor_length=L, dim_z=L,
                                  input_tensor_size=(B, 1, 257, 347))
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((B, 1, 257, 347), device="cuda", generator=g) * 0.3
    full = torch.rand((B, helper.full_preset_size), device="cuda", generator=g)
    full[:3, torch.as_tensor(dx.operator_volume_indexes()[:3], device="cuda")] = 0.0
    v = torch.from_numpy(helper.full_to_learnable_batch(full.cpu().numpy())).cuda()
    info = torch.tensor([[i, 60, 85] for i in range(B)], dtype=torch.int32, device="cuda")
    return model_c, train_c, helper, x, v, info


def flagship_step(model_c, train_c, helper, x, v, info, dtype) -> dict:
    """One train step of the flagship built from seed 0 in ``dtype`` (TF32
    off), dropout and noise from a generator seeded 11: the total loss
    (averaged over a group's processes), every gradient, every running
    statistic and the generator's state after the step, on the host."""
    from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
    from preset_gen_vae_tpu_torch.parallel import multihost
    from preset_gen_vae_tpu_torch.training.train_step import Criteria, make_optimizer, \
        train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_extended_ae_model(model_c, train_c, helper, seed=0).to("cuda", dtype)
    generator = torch.Generator(device="cuda").manual_seed(11)
    m = train_step(model, make_optimizer(model, train_c), Criteria(model_c, train_c, helper),
                   train_c, x.to(dtype), v.to(dtype), info, 0.2, generator)
    loss = m["TotalLoss"].reshape(1).clone()
    multihost.all_reduce_mean_([loss])
    return {"loss": loss.cpu(),
            "grads": {k: p.grad.cpu() for k, p in model.named_parameters()},
            "stats": {k: b.cpu() for k, b in model.named_buffers()
                      if k.endswith(("running_mean", "running_var"))},
            "generator": generator.get_state()}


MULTIPROC2_DTYPES = ("float64", "float32")


def multiproc2_rank(rank: int, world: int, store: str, out: str):
    """Process ``rank`` of 2 under gloo on the one card: the flagship step on
    its 80 of the 160 rows, in each of ``MULTIPROC2_DTYPES``."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        model_c, train_c, helper, x, v, info = multiproc2_inputs()
        b = MULTIPROC2_BATCH // world
        rows = slice(rank * b, (rank + 1) * b)
        train_c = dataclasses.replace(train_c, minibatch_size=b)
        for name in MULTIPROC2_DTYPES:
            torch.save(flagship_step(model_c, train_c, helper, x[rows], v[rows], info[rows],
                                     getattr(torch, name)), f"{out}/rank{rank}_{name}.pt")
    finally:
        dist.destroy_process_group()


def module_scales(step: dict) -> dict:
    """``kind:name`` -> the largest entry of the tensor, or of its module's
    tensors where the tensor is zero in exact arithmetic: under 1e-6 of
    its module's largest entry in the float64 step (a bias feeding a
    train-mode BatchNorm, the running mean of a BatchNorm whose input has
    zero batch mean)."""
    out = {"loss": float(step["loss"].abs())}
    for kind in ("grads", "stats"):
        module = collections.defaultdict(float)
        for k, t in step[kind].items():
            module[k.rsplit(".", 1)[0]] = max(module[k.rsplit(".", 1)[0]], float(t.abs().max()))
        for k, t in step[kind].items():
            own, mod = float(t.abs().max()), module[k.rsplit(".", 1)[0]]
            out[f"{kind}:{k}"] = own if own >= 1e-6 * mod else mod
    return out


def step_errors(got: dict, want: dict, scales: dict) -> dict:
    """Each tensor's largest difference over its scale (``module_scales``)."""
    out = {"loss": float((got["loss"] - want["loss"]).abs()) / scales["loss"]}
    for kind in ("grads", "stats"):
        for k, t in want[kind].items():
            out[f"{kind}:{k}"] = float((got[kind][k] - t).abs().max()) / scales[f"{kind}:{k}"]
    return out


def phase_multiproc2(root: str):
    """Two processes on the one card (gloo, spawned) each take one flagship
    train step on 80 of the same 160 rows, from the same initial weights;
    against one process's step on the 160 rows: the loss, every averaged
    gradient and every BatchNorm running statistic within 1e-4 of the
    tensor's largest entry, in float64; float32's differences printed."""
    import torch.multiprocessing as mp

    out = pathlib.Path(root) / "multiproc2"
    out.mkdir()

    def run():
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=multiproc2_rank, args=(r, 2, str(out / "store"), str(out)))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        hung = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            p.kill()
        if hung or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"multiproc2: ranks hung {hung}, exit codes "
                                 f"{[p.exitcode for p in procs]}")
        inputs = multiproc2_inputs()
        return {name: flagship_step(*inputs, getattr(torch, name)) for name in MULTIPROC2_DTYPES}

    want, counts, wall, mem = drive("multiproc2", run, k1=0)
    scales = module_scales(want["float64"])
    worst = {}
    for name in MULTIPROC2_DTYPES:
        errs = {}
        for r in range(2):
            got = torch.load(out / f"rank{r}_{name}.pt")
            for k, e in step_errors(got, want[name], scales).items():
                errs[k] = max(errs.get(k, 0.0), e)
        worst[name] = sorted(errs.items(), key=lambda kv: -kv[1])
    n_zero = sum(scales[f"{kind}:{k}"] != float(t.abs().max())
                 for kind in ("grads", "stats") for k, t in want["float64"][kind].items())
    print(f"[multiproc2] {card_line()}: 2 processes x 80 rows (gloo) against 1 x 160, wall "
          f"{wall:.2f} s, peak device memory of this process {mem:.2f} GiB; {n_zero} of "
          f"{len(scales)} tensors zero in exact arithmetic, held at their module's scale; "
          + "; ".join(f"{name}: loss {dict(worst[name])['loss']:.2e}, worst "
                      f"{[(k, f'{e:.2e}') for k, e in worst[name][:3]]}"
                      for name in MULTIPROC2_DTYPES), flush=True)
    if worst["float64"][0][1] > 1e-4:
        raise AssertionError(f"multiproc2: float64 {worst['float64'][:5]} (bar 1e-4)")
    return {"multiproc2": counts}


def remat_step_timing(model_c, train_c, helper, x, v, info, remat: bool, steps: int = 5):
    """The flagship's train step in bf16 autocast on float32 weights, with
    or without ``remat``: (steady ms a step over ``steps`` after 2 warm-up
    steps, peak device GiB during them, and that peak above what was
    allocated before them)."""
    from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
    from preset_gen_vae_tpu_torch.training.train_step import Criteria, make_optimizer, \
        train_step

    tc = dataclasses.replace(train_c, remat=remat, compute_dtype="bfloat16")
    model = build_extended_ae_model(model_c, tc, helper, seed=0).to("cuda")
    opt, crit = make_optimizer(model, tc), Criteria(model_c, tc, helper)
    gen = torch.Generator(device="cuda").manual_seed(11)
    for _ in range(2):
        train_step(model, opt, crit, tc, x, v, info, 0.2, gen)
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        train_step(model, opt, crit, tc, x, v, info, 0.2, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / steps
    peak = torch.cuda.max_memory_allocated()
    return ms, peak / 2**30, (peak - before) / 2**30


def phase_remat():
    """``TrainConfig.remat`` on the card: one flagship step at batch 160 (the
    multiproc2 rows) with remat and without, in float64 (TF32 off): the
    loss, every gradient and every running statistic within 1e-4 of each
    tensor's scale (multiproc2's rule, ``module_scales``) and the
    generator's state equal; then in bf16 autocast the steady step time
    and the peak device memory of each."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def run():
        model_c, train_c, helper, x, v, info = multiproc2_inputs()
        steps = {on: flagship_step(model_c, dataclasses.replace(train_c, remat=on), helper, x, v,
                                   info, torch.float64) for on in (False, True)}
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        timing = {on: remat_step_timing(model_c, train_c, helper, x, v, info, on)
                  for on in (False, True)}
        return steps, timing

    (steps, timing), counts, wall, _ = drive("remat", run, k1=0)
    scales = module_scales(steps[False])
    errs = sorted(step_errors(steps[True], steps[False], scales).items(), key=lambda kv: -kv[1])
    same_gen = torch.equal(steps[True]["generator"], steps[False]["generator"])
    print(f"[remat] {card_line()}: flagship step at batch 160, remat on against off: float64 "
          f"loss {dict(errs)['loss']:.2e}, worst {[(k, f'{e:.2e}') for k, e in errs[:3]]} of "
          f"{len(errs)} tensors (bar 1e-4 of each tensor's scale), generator state equal "
          f"{same_gen}; bf16 steady step {timing[False][0]:.2f} ms off, {timing[True][0]:.2f} ms "
          f"on ({timing[True][0] / timing[False][0]:.3f}x); peak device memory during the steps "
          f"{timing[False][1]:.3f} GiB off, {timing[True][1]:.3f} GiB on (above the model and "
          f"optimizer: {timing[False][2]:.3f} / {timing[True][2]:.3f} GiB); wall {wall:.2f} s",
          flush=True)
    SUMMARY[-1].update(step_ms_bf16={("on" if k else "off"): round(v[0], 3)
                                     for k, v in timing.items()},
                       step_peak_gib_bf16={("on" if k else "off"): round(v[1], 3)
                                           for k, v in timing.items()})
    if errs[0][1] > 1e-4 or not same_gen:
        raise AssertionError(f"remat: float64 {errs[:5]} (bar 1e-4), generator equal {same_gen}")
    return {"remat": counts}


SAVED_RUNS = pathlib.Path(__file__).resolve().parent / "saved" / "FlVAE2"
VARIANT_CORPUS = {"n_synthetic_presets": 512}  # the variant paths' cut corpus


def saved_run_configs(run: str, root: str, model_kw=None, **train_kw):
    """A saved run's frozen configs, retargeted: runs under ``root``,
    ``train_kw`` (epochs, verbosity) over its TrainConfig; its widths,
    notes, flows, heads, losses and corpus render settings stay (a setting
    the file leaves null takes the ModelConfig default)."""
    from preset_gen_vae_tpu_torch import config as cfg

    model_c, train_c = cfg.load_config(SAVED_RUNS / run / "config.json")
    defaults = cfg.ModelConfig()
    unset = {k: getattr(defaults, k) for k in ("dataset_corpus_render_backend",
                                               "dataset_corpus_cache_policy")
             if getattr(model_c, k) is None}
    model_c = dataclasses.replace(model_c, **{
        "logs_root_dir": root, "run_name": f"smoke_{run}", "allow_erase_run": True,
        **unset, **(model_kw or {})})
    return model_c, dataclasses.replace(train_c, start_epoch=0, verbosity=0, **train_kw)


def corpus_fm_launches(model_c, corpus) -> int:
    """F1 and F2 launches of one corpus pass: on the 'jax' backend one per
    note and ``RENDER_ROWS`` presets, else none."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import RENDER_ROWS

    if model_c.dataset_corpus_render_backend != "jax":
        return 0
    return len(model_c.midi_notes) * -(-corpus["n_synthetic_presets"] // RENDER_ROWS)


def variant_train(counts, name, model_c, train_c, corpus, epochs, dim_z):
    """One train path: K1 launched once per 64 presets and note, F1 and F2
    once per note on the 'jax' corpus backend, the input shape (B, stacked
    notes, 257, 347), finite metrics; timings printed."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK
    from preset_gen_vae_tpu_torch.training.loop import train_config

    summary, counts[name], wall, mem = drive(name, lambda: train_config(
        model_c, train_c, dataset_kwargs=fresh_corpus(corpus, model_c.logs_root_dir, name),
        device="cuda", use_tensorboard=False), fm=corpus_fm_launches(model_c, corpus))
    n_notes = len(model_c.midi_notes)
    channels = n_notes if model_c.stack_spectrograms else 1
    check_train_summary(name, summary, epochs, (train_c.minibatch_size, channels, 257, 347),
                        dim_z)
    k1 = n_notes * -(-corpus["n_synthetic_presets"] // CORPUS_CHUNK)
    if counts[name]["logmel"] != k1:
        raise AssertionError(f"{name}: {counts[name]['logmel']} K1 launches, want {k1}")
    print(f"[{name} path] wall {wall:.2f} s, model build {summary['model_build_seconds']:.2f} s, "
          f"corpus backend {model_c.dataset_corpus_render_backend!r} / "
          f"{model_c.dataset_corpus_cache_policy!r}, launches {counts[name]}, "
          f"{summary['train_steps']} steps, steady step "
          f"{summary['step_ms']:.2f} ms (first {summary['first_step_ms']:.1f} ms), corpus pass "
          f"{summary['corpus_seconds']:.3f} s (render {summary['corpus_render_seconds']:.3f} s), "
          f"{summary['n_params']} parameters, input {summary['input_size']}, peak device memory "
          f"{mem:.2f} GiB", flush=True)
    return summary


def variant_eval(counts, name, model_c, run_dir, corpus, latents=None, backend="jax"):
    """One eval path on the run's last checkpoint: the validation items
    (one per preset, or per preset and note when the notes are not
    stacked) inferred, re-rendered (``backend``: 'jax', the default, one
    F1 and one F2 launch per audio batch, or the C++ engine) and scored,
    every metric finite."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK
    from preset_gen_vae_tpu_torch.data.sampler import split_preset_indexes
    from preset_gen_vae_tpu_torch.evaluation.evaluate import evaluate_model_from_dir

    eval_c = cfg.EvalConfig(dataset="validation", audio_render_backend=backend)
    P, n_notes = corpus["n_synthetic_presets"], len(model_c.midi_notes)
    n_items = len(split_preset_indexes(P)["validation"]) * (
        1 if model_c.stack_spectrograms else n_notes)
    fm = corpus_fm_launches(model_c, corpus) + (
        -(-n_items // eval_c.audio_batch_size) if backend == "jax" else 0)
    phases = {}
    _, counts[name], wall, mem = drive(name, lambda: evaluate_model_from_dir(
        run_dir, eval_c, dataset_kwargs=fresh_corpus(corpus, model_c.logs_root_dir, name),
        phase_seconds=phases, latents=latents), fm=fm)
    with open(f"{run_dir}/eval_validation_summary.json") as f:
        ev = json.load(f)
    items = np.load(f"{run_dir}/eval_validation.items.npz")
    if ev["n_items"] != n_items or len(items["preset_UID"]) != n_items:
        raise AssertionError(f"{name}: {ev['n_items']} items, want {n_items}")
    for k in ("num_eval_loss", "num_mae", "num_mae_dyn", "acc", "acc_dyn", "spec_mae",
              "mfcc13_mae", "mfcc40_mae"):
        if not np.isfinite(items[k]).all():
            raise AssertionError(f"{name}: non-finite {k}")
    k1 = n_notes * -(-P // CORPUS_CHUNK)
    if counts[name]["logmel"] != k1:
        raise AssertionError(f"{name}: {counts[name]['logmel']} K1 launches, want {k1}")
    print(f"[{name} path] {json.dumps(ev, sort_keys=True)}", flush=True)
    print(f"[{name} path] wall {wall:.2f} s, model build and restore {phases['model']:.2f} s, "
          f"launches {counts[name]}, {n_items} items, re-render of {2 * n_items} notes "
          f"({backend!r}) {phases['render']:.3f} s, corpus pass (dataset phase) "
          f"{phases['dataset']:.3f} s, seconds per phase {json.dumps(phases)}, peak device "
          f"memory {mem:.2f} GiB", flush=True)
    return items


def phase_variant_paths(root: str):
    """The saved runs' other configurations through the same entry points.
    At 1,024 structured2 presets on their saved 'jax' / 'device' corpus
    render: stack3 48 K1 and 3 F1/F2 launches a pass, 164 eval items (one
    audio batch); multi6 96 K1 and 6 F1/F2 launches, 24 steps, 984 eval
    items (4 audio batches); at 512 presets on the C++ corpus render 8 K1
    launches."""
    from preset_gen_vae_tpu_torch.data.sampler import split_preset_indexes

    counts = {}
    # ---- the repo's best run: 3 stacked notes, full width, 2 epochs
    model_c, train_c = saved_run_configs("r5stack3_v2_20480", root, n_epochs=2)
    summary = variant_train(counts, "stack3 train", model_c, train_c, CORPUS_V2, 2, 610)
    variant_eval(counts, "stack3 eval", model_c, summary["run_dir"], CORPUS_V2)

    # ---- 6 un-stacked notes, MIDI in z0, 1800-channel mixers, 1 epoch
    model_c, train_c = saved_run_configs("r5multi6_v2_12288", root, n_epochs=1)
    summary = variant_train(counts, "multi6 train", model_c, train_c, CORPUS_V2, 1, 610)
    n_train = len(split_preset_indexes(CORPUS_V2["n_synthetic_presets"])["train"]) * 6
    if summary["train_steps"] != n_train // train_c.minibatch_size:
        raise AssertionError(f"multi6: {summary['train_steps']} steps for {n_train} items")
    latents = {}
    items = variant_eval(counts, "multi6 eval", model_c, summary["run_dir"], CORPUS_V2, latents)
    midi = -1.0 + 2.0 * np.stack([items["midi_pitch"], items["midi_velocity"]], 1) / 127.0
    err = float(np.abs(latents["z0"][:, :2] - midi).max())
    if err > 1e-6 or len(set(zip(items["midi_pitch"], items["midi_velocity"]))) != 6:
        raise AssertionError(f"multi6 eval: z0 dims 0-1 off the MIDI head by {err}")
    print(f"[multi6 eval path] z0 dims 0-1 of all {len(midi)} items equal -1 + 2 (pitch, "
          f"velocity) / 127 of their own note (max |err| {err:.1e})", flush=True)

    # ---- FlowParamsLoss, the train-mode pullback (cut corpus)
    model_c, train_c = saved_run_configs("r2flowloss_train", root, n_epochs=1)
    summary = variant_train(counts, "flowloss train", model_c, train_c, VARIANT_CORPUS, 1, 610)
    share = summary["Controls/FlooredShare/Train"]
    n_train = summary["train_steps"] * train_c.minibatch_size
    print(f"[flowloss train path] Controls/BackpropLoss {summary['Controls/BackpropLoss/Train']}"
          f" (train), {summary['Controls/BackpropLoss/Valid']} (valid); items at the -1e8 floor:"
          f" {share * n_train:.0f} of {n_train} trained ({share:.1%}), "
          f"{summary['Controls/FlooredShare/Valid']:.1%} of validation", flush=True)

    # ---- the MLP head, dim_z 256 (cut corpus)
    model_c, train_c = saved_run_configs("r2mlp400", root, n_epochs=1)
    summary = variant_train(counts, "mlp train", model_c, train_c, VARIANT_CORPUS, 1, 256)
    variant_eval(counts, "mlp eval", model_c, summary["run_dir"], VARIANT_CORPUS)
    variant_eval(counts, "mlp eval cpp", model_c, summary["run_dir"], VARIANT_CORPUS,
                 backend="cpp")

    # ---- BasicVAE (Dkl latent loss) with a MAF head, forward direction only
    model_c, train_c = saved_run_configs(
        "r2flowloss_train", root, dict(run_name="smoke_basic_maf", latent_flow_arch=None,
                                       params_regression_architecture="flow_maf_6l300",
                                       forward_controls_loss=True), n_epochs=1)
    summary = variant_train(counts, "basic_maf train", model_c, train_c, VARIANT_CORPUS, 1, 610)
    print(f"[basic_maf train path] LatLoss (Dkl) {summary['LatLoss/Train']} (train), "
          f"{summary['LatLoss/Valid']} (valid)", flush=True)
    return counts


EXAMPLE_BANK = pathlib.Path(__file__).resolve().parent / "docs" / "examples" / "structured2_bank.syx"
SYX_SEEDS = range(32)  # the cartridges written from the structured2 generator


@contextlib.contextmanager
def served_corpus(out: dict, key: str):
    """Keeps on the host as ``out[key]`` the first corpus that a dataset
    serves while the block runs."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset

    load = DexedDataset.load_corpus

    def keep(self, *args, **kwargs):
        corpus = load(self, *args, **kwargs)
        out.setdefault(key, corpus.cpu())
        return corpus

    DexedDataset.load_corpus = keep
    try:
        yield
    finally:
        DexedDataset.load_corpus = load


def corpus_peak(kwargs: dict):
    """(corpus seconds, peak device GiB, launches) of one corpus pass alone
    on the card, outside the main path's counts."""
    import preset_gen_vae_tpu_torch.ops.spectrogram as sp
    from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n0 = sp.LAUNCHES["logmel"]
    ds = DexedDataset(device="cuda", **kwargs)
    ds.load_corpus()
    out = (ds.corpus_seconds, torch.cuda.max_memory_allocated() / 2**30,
           sp.LAUNCHES["logmel"] - n0)
    del ds
    gc.collect()
    return out


def numpy_normalized(raw: np.ndarray, stats: dict, norm: str) -> np.ndarray:
    """The JAX package's normalisation of a raw tier (abstract_dataset.py:
    548-556, and :361-375 for the float16 tier), written out in numpy: each
    op in the raw tier's dtype (the Python-float stats do not promote), then
    rounded to float16."""
    if norm == "min_max":
        x = -1.0 + (raw - stats["min"]) / ((stats["max"] - stats["min"]) / 2.0)
    else:
        x = (raw - stats["mean"]) / stats["std"]
    return x.astype(np.float32).astype(np.float16)


def check_normalization(name: str, cache: pathlib.Path, norm: str, served: torch.Tensor):
    """Holds the first and the last 64-preset chunk of the corpus served on
    the card, and of the float16 tier written beside it, against
    ``numpy_normalized`` of ``specs_raw.npy`` with ``spec_stats.json``: bit
    for bit (the served corpus after the same cast to its dtype)."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK

    raw = np.load(cache / "specs_raw.npy", mmap_mode="r")
    tier = np.load(cache / "specs_norm_f16.npy", mmap_mode="r")
    stats = json.loads((cache / "spec_stats.json").read_text())
    last = (raw.shape[0] - 1) // CORPUS_CHUNK * CORPUS_CHUNK
    for s in (0, last):
        want = numpy_normalized(np.array(raw[s:s + CORPUS_CHUNK]), stats, norm)
        got = served[s:s + CORPUS_CHUNK].cpu()
        if not np.array_equal(np.array(tier[s:s + CORPUS_CHUNK]).view(np.uint16),
                              want.view(np.uint16)) or \
                not torch.equal(got, torch.from_numpy(want).to(got.dtype)):
            raise AssertionError(f"{name}: presets {s}+ are not numpy's normalisation of the "
                                 f"{raw.dtype} raw tier")
    print(f"[{name}] presets 0-{min(CORPUS_CHUNK, raw.shape[0]) - 1} and {last}-"
          f"{raw.shape[0] - 1}: the served corpus ({served.dtype}) and the float16 tier are "
          f"bit-equal to numpy's '{norm}' normalisation of the {raw.dtype} raw tier", flush=True)


def phase_syx_path(root: str):
    """The real-data path at the flagship's full width (default ModelConfig:
    'cpp' render, 'disk' cache): 33 DX7 cartridges (the repo's example bank
    and 32 written from the structured2 generator) imported into one SQLite
    file of 1,056 voices; train 2 epochs (cold corpus pass: 17 K1
    launches, both cache tiers and the sidecar written), resume for a third
    on the same data root (warm: no launch, the train path's corpus bit for
    bit), evaluate twice on the C++ re-render (the first writes the
    ground-truth audio cache, the second reads it and scores bit-equal),
    and interpolate 11 steps between two validation presets."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK, \
        model_config_to_dataset_kwargs
    from preset_gen_vae_tpu_torch.data.sampler import split_preset_indexes
    from preset_gen_vae_tpu_torch.evaluation.evaluate import evaluate_model_from_dir, items_path
    from preset_gen_vae_tpu_torch.evaluation.interpolate import interpolate_presets
    from preset_gen_vae_tpu_torch.synth import database as db
    from preset_gen_vae_tpu_torch.synth.sysex import import_syx_banks, write_syx
    from preset_gen_vae_tpu_torch.training.loop import train_config

    base = pathlib.Path(root) / "syx"
    base.mkdir()
    banks = [EXAMPLE_BANK]
    for seed in SYX_SEEDS:
        presets, names, _ = db.generate_structured_corpus_v2(32, seed=seed)
        banks.append(base / f"bank{seed:02d}.syx")
        banks[-1].write_bytes(write_syx(presets, names))
    voices, _, labels = import_syx_banks(banks, out_sqlite=base / "presets.sqlite")
    if len(voices) != 1056:
        raise AssertionError(f"syx: {len(voices)} voices from {len(banks)} cartridges")
    kw = {"db_path": str(base / "presets.sqlite"), "data_root": str(base / "data_cache")}
    model_c = cfg.ModelConfig(logs_root_dir=root, run_name="smoke_syx")
    train_c = cfg.TrainConfig(n_epochs=2, minibatch_size=160, lr_warmup_epochs=0, save_period=1,
                              verbosity=0)
    counts, served, k1 = {}, {}, -(-1056 // CORPUS_CHUNK)

    # ---- train: the cold corpus pass writes the cache
    with served_corpus(served, "syx train"):
        summary, counts["syx train"], wall, mem = drive("syx train", lambda: train_config(
            model_c, train_c, dataset_kwargs=kw, device="cuda", use_tensorboard=False), k1=k1)
    check_train_summary("syx train", summary, 2)
    (cache,) = (base / "data_cache" / "dexed").iterdir()
    files = {f.name for f in cache.iterdir()}
    want = {"spec_stats.json", "specs_raw.npy", "specs_norm_f16.npy", "render_constraints.json"}
    if not want <= files or summary["corpus_presets"] != 1056 or "_db" not in cache.name:
        raise AssertionError(f"syx train: cache {cache.name} holds {sorted(files)}")
    check_normalization("syx train", cache, "min_max", served["syx train"])  # the default
    cold_s, cold_render_s = summary["corpus_seconds"], summary["corpus_render_seconds"]
    print(f"[syx train path] {len(banks)} cartridges -> {len(voices)} voices "
          f"({dict(collections.Counter(labels))}), wall {wall:.2f} s, model build "
          f"{summary['model_build_seconds']:.2f} s, launches {counts['syx train']}, "
          f"{summary['train_steps']} steps, steady step {summary['step_ms']:.2f} ms (first "
          f"{summary['first_step_ms']:.1f} ms), cold corpus pass {cold_s:.3f} s (render "
          f"{cold_render_s:.3f} s; tiers written to {cache.name}), peak device memory "
          f"{mem:.2f} GiB", flush=True)

    # ---- resume on the same data root: the corpus is reloaded, not rendered
    resume_c = dataclasses.replace(train_c, start_epoch=2, n_epochs=3)
    with served_corpus(served, "syx resume"):
        summary, counts["syx resume"], wall, mem = drive("syx resume", lambda: train_config(
            model_c, resume_c, dataset_kwargs=kw, device="cuda", use_tensorboard=False), k1=0)
    check_train_summary("syx resume", summary, 3)
    if summary["corpus_render_seconds"] != 0.0 or not torch.equal(served["syx train"],
                                                                  served["syx resume"]):
        raise AssertionError("syx resume: the warm corpus is not the train path's")
    warm_s = summary["corpus_seconds"]
    print(f"[syx resume path] wall {wall:.2f} s, launches {counts['syx resume']}, warm corpus "
          f"reload {warm_s:.3f} s against the cold pass's {cold_s:.3f} s, served corpus "
          f"({tuple(served['syx train'].shape)}, {served['syx train'].dtype}) bit-equal to the "
          f"train path's, steady step {summary['step_ms']:.2f} ms, peak device memory "
          f"{mem:.2f} GiB", flush=True)
    del served
    alone = dict(model_config_to_dataset_kwargs(model_c), corpus_dtype=torch.bfloat16, **kw)
    reload_s, reload_gib, n = corpus_peak(alone)
    cold = corpus_peak(dict(alone, data_root=str(base / "cold_cache")))
    if n != 0 or cold[2] != k1:
        raise AssertionError(f"syx corpus passes alone: K1 {n} warm, {cold[2]} cold")
    print(f"[syx corpus alone] bf16 corpus of 1,056 presets: warm reload {reload_s:.3f} s, "
          f"peak device memory {reload_gib:.3f} GiB; cold pass {cold[0]:.3f} s, peak "
          f"{cold[1]:.3f} GiB", flush=True)
    shutil.rmtree(base / "cold_cache")

    # ---- eval twice on the C++ re-render: the ground truth cached, then read
    n_items = len(split_preset_indexes(1056)["validation"])
    gt_dir = cache / "gt_eval_audio"
    evals = []
    for i in (1, 2):
        name, phases = f"syx eval {i}", {}
        eval_c = cfg.EvalConfig(dataset="validation", audio_render_backend="cpp")
        _, counts[name], wall, mem = drive(name, lambda: evaluate_model_from_dir(
            summary["run_dir"], eval_c, dataset_kwargs=kw, phase_seconds=phases), k1=0)
        items = dict(np.load(items_path(summary["run_dir"], "validation")))
        gt_files = sorted(gt_dir.glob("gt_*.npy"))
        if len(gt_files) != 1 or len(items["preset_UID"]) != n_items:
            raise AssertionError(f"{name}: GT files {gt_files}, {len(items['preset_UID'])} items")
        stamp = gt_files[0].stat().st_mtime_ns
        for k in ("num_eval_loss", "num_mae", "acc", "spec_mae", "mfcc13_mae", "mfcc40_mae"):
            if not np.isfinite(items[k]).all():
                raise AssertionError(f"{name}: non-finite {k}")
        evals.append((items, stamp, phases))
        print(f"[{name} path] wall {wall:.2f} s, launches {counts[name]}, {n_items} items, "
              f"re-render on the C++ engine {phases['render']:.3f} s "
              f"({'ground truth rendered and cached' if i == 1 else 'ground truth read'}), "
              f"corpus reload (dataset phase) {phases['dataset']:.3f} s, seconds per phase "
              f"{json.dumps(phases)}, peak device memory {mem:.2f} GiB", flush=True)
    (first, stamp1, _), (second, stamp2, _) = evals
    if stamp1 != stamp2 or list(first) != list(second) or not all(
            np.array_equal(first[k], second[k], equal_nan=True) for k in first):
        raise AssertionError("syx eval 2: not bit-equal to eval 1 or the GT cache was rewritten")
    print(f"[syx eval] the second eval read {gt_dir.name}/{gt_files[0].name} and its "
          f"{len(first)} columns are bit-equal to the first's", flush=True)

    # ---- interpolation between two validation presets
    uid_a, uid_b = (int(u) for u in first["preset_UID"][:2])
    (full, wavs), counts["syx interpolate"], wall, mem = drive("syx interpolate", lambda: (
        interpolate_presets(model_c, train_c, uid_a, uid_b, n_steps=11, mode="slerp",
                            device="cuda", dataset_kwargs=kw)), k1=0)
    if full.shape != (11, 155) or not np.isfinite(full).all() or full.min() < 0 or \
            full.max() > 1 or wavs.shape != (11, SAMPLES) or not np.isfinite(wavs).all():
        raise AssertionError(f"syx interpolate: presets {full.shape}, waveforms {wavs.shape}")
    print(f"[syx interpolate path] UIDs {uid_a} -> {uid_b}, 11 slerp steps, wall {wall:.2f} s, "
          f"launches {counts['syx interpolate']}, presets in [{full.min():.3f}, "
          f"{full.max():.3f}], endpoints differ by {np.abs(full[0] - full[-1]).max():.3f}, "
          f"waveforms {wavs.shape} on the C++ engine, peak device memory {mem:.2f} GiB",
          flush=True)
    return counts


def f16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float16 ulps between two float16 tensors."""
    def ordered(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i + 32768), i)
    return int((ordered(a) - ordered(b)).abs().max())


def phase_disk_jax(root: str):
    """The 'jax' corpus backend on the 'disk' policy: r5stack3_v2_20480's
    saved config on 1,024 structured2 presets, the corpus pass alone, twice
    on one data root. Cold: 48 K1 launches and 3 F1/F2 calls, the sidecar's
    ``raw_tier``; warm: no launch of any kernel and the cold corpus bit for
    bit. The cold corpus is held against the same config's 'device' pass
    (the JAX package states "a few f16 ulps", abstract_dataset.py:400-406):
    at most 2 f16 ulps."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset, \
        model_config_to_dataset_kwargs

    model_c, _ = saved_run_configs("r5stack3_v2_20480", root,
                                   dict(dataset_corpus_cache_policy="disk"))
    kw = dict(model_config_to_dataset_kwargs(model_c), device="cuda", corpus_dtype=torch.float16,
              **fresh_corpus(CORPUS_V2, root, "stack3 disk"))
    counts, corpora, seconds = {}, {}, {}
    for name, fm, k1 in (("stack3 disk cold", 3, 48), ("stack3 disk warm", 0, 0)):
        ds = DexedDataset(**kw)
        corpora[name], counts[name], wall, mem = drive(name, ds.load_corpus, fm=fm, k1=k1)
        seconds[name] = (ds.corpus_seconds, ds.render_seconds)
        print(f"[{name} path] corpus pass {ds.corpus_seconds:.3f} s (render "
              f"{ds.render_seconds:.3f} s), wall {wall:.2f} s, launches {counts[name]}, corpus "
              f"{tuple(corpora[name].shape)} {corpora[name].dtype}, peak device memory "
              f"{mem:.3f} GiB", flush=True)
    check_normalization("stack3 disk cold", ds._corpus_cache_dir(), ds.spectrogram_normalization,
                        corpora["stack3 disk cold"])
    sidecar = json.loads((ds._corpus_cache_dir() / "render_constraints.json").read_text())
    if sidecar.get("raw_tier") != "f16+devstats" or sidecar.get("render_backend") != "jax":
        raise AssertionError(f"stack3 disk: sidecar {sidecar}")
    cold, warm = corpora["stack3 disk cold"], corpora["stack3 disk warm"]
    if seconds["stack3 disk warm"][1] != 0.0 or not torch.equal(cold, warm):
        raise AssertionError("stack3 disk warm: not the cold pass's corpus")
    device = DexedDataset(**dict(kw, corpus_cache_policy="device")).load_corpus()
    ulps = f16_ulps(cold, device)
    print(f"[stack3 disk] warm reload bit-equal to the cold pass; cold 'disk' pass against the "
          f"'device' pass: max {ulps} f16 ulps (bar 2), {int((cold != device).sum())} of "
          f"{cold.numel()} values differ; sidecar {sidecar}", flush=True)
    if ulps > 2:
        raise AssertionError(f"stack3 disk against 'device': {ulps} f16 ulps")
    return counts


# the metrics of an evaluation summary that the eval CLI must reproduce
EVAL_METRICS = ("num_eval_loss", "num_mae", "num_mae_dyn", "acc", "acc_dyn", "spec_mae", "spec_sc",
                "mfcc13_mae", "mfcc40_mae", "latent_entanglement_z0", "latent_entanglement_zK")
CLI_CORPUS = {"n_synthetic_presets": 512}  # the queue's and the loop CLI's cut corpus


def run_module(module: str, *argv: str, timeout: int = 300) -> str:
    """``python -m module argv`` from the repository root in a subprocess;
    fails the smoke on a non-zero exit. -> its standard output."""
    proc = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True,
                          timeout=timeout, cwd=pathlib.Path(__file__).resolve().parent)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {module} {' '.join(argv)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def check_cli_run(name: str, summary: dict, run_dir: pathlib.Path):
    check_train_summary(name, summary, 1)
    if summary["run_dir"] != str(run_dir) or not (run_dir / "checkpoints" / "0").is_dir() or \
            (run_dir / "tensorboard").exists():
        raise AssertionError(f"{name}: run dir {summary['run_dir']}, want {run_dir} with "
                             "checkpoint 0 and no TensorBoard events")


def phase_cli(root: str, train_summary: dict):
    """The port's command-line entry points on the card, each as a user
    runs it: ``scripts.evaluate`` in a subprocess over the train path's run
    (its own cold corpus pass of the same 1,024 presets), held to the
    in-process eval path's summary within 1e-5; ``scripts.train_queue``'s
    ``main`` on a one-entry queue and the loop CLI's ``main``, each 1 epoch
    on 512 presets ('cpp') with ``--no-tensorboard``; ``scripts.clean_logs``
    in a subprocess on the queue's run, which must leave every other run
    as it was. The subprocesses' launches are read from the eval CLI's own
    last line."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.logs.logger import list_checkpoint_epochs
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp
    from preset_gen_vae_tpu_torch.scripts import train_queue
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft
    from preset_gen_vae_tpu_torch.training import loop

    counts = {}
    run_dir = pathlib.Path(train_summary["run_dir"])  # trained, resumed and evaluated
    model_name, run_name = run_dir.parent.name, run_dir.name
    # ---- the eval CLI: the in-process eval's artifacts are kept aside,
    # else evaluate_all_models skips a run evaluated already
    in_process = {}
    for f in ("eval_validation_summary.json", "eval_validation.items.npz"):
        in_process[f] = run_dir / f"{f}.in_process"
        (run_dir / f).rename(in_process[f])
    with open(in_process["eval_validation_summary.json"]) as f:
        want = json.load(f)
    data_root = fresh_corpus(CORPUS, root, "cli_eval")["data_root"]
    out, _, wall, _ = drive("cli_eval", lambda: run_module(
        "preset_gen_vae_tpu_torch.scripts.evaluate", f"{model_name}/{run_name}",
        "--logs-root", root, "--n-presets", str(CORPUS["n_synthetic_presets"]),
        "--data-root", data_root), k1=0)
    launched = json.loads(out.strip().splitlines()[-1])["launches"]
    counts["cli_eval"] = {k: launched.get(k, 0) for k in {**sp.LAUNCHES, **ft.LAUNCHES}}
    c = counts["cli_eval"]
    if c["logmel"] < 1 or c["fm_control"] != 1 or c["fm_exact"] != 1:
        raise AssertionError(f"cli_eval: the subprocess launched {launched}, want K1 at least "
                             "once, F1 and F2 once (164 items, one batch)")
    SUMMARY[-1]["launches"] = launched  # the subprocess's, not this process's zeros
    summary_path = run_dir / "eval_validation_summary.json"
    if not summary_path.exists():
        raise AssertionError(f"cli_eval: no {summary_path}")
    with open(summary_path) as f:
        got = json.load(f)
    diffs = {k: abs(got[k] - want[k]) for k in EVAL_METRICS}
    if got["n_items"] != 164 or got.get("n_nan_spec_sc", 0) != want.get("n_nan_spec_sc", 0) or \
            not all(np.isclose(got[k], want[k], rtol=0, atol=1e-5) for k in EVAL_METRICS):
        raise AssertionError(f"cli_eval: {got['n_items']} items (want 164), differences from "
                             f"the in-process eval {diffs} (bar 1e-5)")
    print(f"[cli_eval path] {card_line()}: python -m preset_gen_vae_tpu_torch.scripts.evaluate "
          f"{model_name}/{run_name}: wall {wall:.2f} s, the subprocess's launches {launched}, "
          f"164 items, largest difference from the in-process eval "
          f"{max(diffs.values()):.3g} (bar 1e-5); its summary printed:\n"
          + "\n".join(out.strip().splitlines()[:-1]), flush=True)

    # ---- the queue and the loop CLI: 1 epoch each, TensorBoard off
    data_root = fresh_corpus(CLI_CORPUS, root, "cli_queue")["data_root"]
    queue = [({"run_name": "cli_queue", "dataset_corpus_render_backend": "cpp"},
              {"n_epochs": 1, "verbosity": 1})]
    summaries, counts["cli_queue"], wall, _ = drive("cli_queue", lambda: train_queue.main(
        ["--no-tensorboard", "--logs-root", root, "--data-root", data_root], run_mods=queue,
        dataset_kwargs=CLI_CORPUS))
    if len(summaries) != 1:
        raise AssertionError(f"cli_queue: {len(summaries)} summaries for a queue of 1")
    queue_dir = pathlib.Path(root) / "FlVAE2" / "cli_queue"
    check_cli_run("cli_queue", summaries[0], queue_dir)
    print(f"[cli_queue path] wall {wall:.2f} s, K1 launches {counts['cli_queue']['logmel']}, "
          f"steady step {summaries[0]['step_ms']:.2f} ms, epoch {summaries[0]['epoch_s']:.2f} s",
          flush=True)
    model_c = cfg.ModelConfig(run_name="cli_loop", logs_root_dir=root)
    summary, counts["cli_loop"], wall, _ = drive("cli_loop", lambda: loop.main(
        ["--no-tensorboard"], model_c=model_c, train_c=cfg.TrainConfig(n_epochs=1, verbosity=1),
        dataset_kwargs=fresh_corpus(CLI_CORPUS, root, "cli_loop")))
    loop_dir = pathlib.Path(root) / "FlVAE2" / "cli_loop"
    check_cli_run("cli_loop", summary, loop_dir)
    print(f"[cli_loop path] wall {wall:.2f} s, K1 launches {counts['cli_loop']['logmel']}, "
          f"steady step {summary['step_ms']:.2f} ms, epoch {summary['epoch_s']:.2f} s", flush=True)

    # ---- clean_logs on the queue's run: the others stay as they were
    def listing(d: pathlib.Path):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*"))

    before = {d: listing(d) for d in (run_dir, loop_dir)}
    out, counts["cli_clean"], wall, _ = drive("cli_clean", lambda: run_module(
        "preset_gen_vae_tpu_torch.scripts.clean_logs", "FlVAE2", "cli_queue", "--logs-root",
        root), k1=0)
    if out != f"Erasing {queue_dir}\n" or queue_dir.exists():
        raise AssertionError(f"cli_clean: printed {out!r}; {queue_dir} exists: "
                             f"{queue_dir.exists()}")
    if any(listing(d) != files for d, files in before.items()) or \
            list_checkpoint_epochs(cfg.ModelConfig(logs_root_dir=root)) != [1, 2]:
        raise AssertionError("cli_clean: a run beside the erased one changed")
    print(f"[cli_clean path] wall {wall:.2f} s: erased {queue_dir}; the train path's run "
          f"({len(before[run_dir])} files, checkpoints [1, 2]) and the loop CLI's untouched",
          flush=True)
    return counts


class Tee:
    """Standard output, also written line for line into a file."""

    def __init__(self, stream, path: pathlib.Path):
        self.stream, self.file = stream, open(path, "w")

    def write(self, text):
        self.file.write(text)
        return self.stream.write(text)

    def flush(self):
        self.file.flush()
        self.stream.flush()


def print_summary(kernels):
    """A compact line per driven path and per kernel, for the end of the
    output."""
    print(f"[summary] {card_line()}", flush=True)
    for line in SUMMARY:
        rest = {k: v for k, v in line.items() if k not in ("path", "launches")}
        print(f"[summary] {line['path']}: {json.dumps(rest)} launches "
              f"{json.dumps(line['launches'])}", flush=True)
    for e in kernels:
        print(f"[summary] kernel {e['name']}: {e['ms']:.4f} ms (bound {e['bound_ms']:.4f} ms by "
              f"{e['bound_by']}, plain {e['plain_ms']:.1f} ms), launches {e['launches']}"
              + (f" ({json.dumps(e['launches_by_kernel'])})" if "launches_by_kernel" in e else ""),
              flush=True)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch/CUDA port on one GPU.")
    ap.add_argument("--out", default=str(pathlib.Path(__file__).resolve().parent / "build" /
                                         "chip_smoke"),
                    help="directory of output.txt (every line printed) and results.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    sys.stdout = Tee(sys.stdout, out / "output.txt")
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    build_kernels()
    k1 = phase_kernels()
    fm = phase_fm_kernels()
    f1b = phase_f1b()
    f2b = phase_f2b()
    root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        counts, train_summary = phase_main_path(root)
        counts.update(phase_variant_paths(root))
        counts.update(phase_syx_path(root))
        counts.update(phase_disk_jax(root))
        sound_match_counts, reduction = phase_sound_match()
        counts.update(sound_match_counts)
        counts.update(phase_sound_match_exact(reduction))
        # last, so that the earlier paths run where they ran before them
        counts.update(phase_profile_path(root))
        counts.update(phase_multiproc1(root, train_summary))
        counts.update(phase_multiproc2(root))
        counts.update(phase_remat())
        counts.update(phase_cli(root, train_summary))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernels = [k1, *fm, f1b, f2b]
    for entry in kernels:
        entry["launches_by_path"] = {name: c[entry["name"]] for name, c in counts.items()}
        entry["launches"] = sum(entry["launches_by_path"].values())
        if "kernels" in entry:
            entry["launches_by_kernel"] = {k: sum(c[k] for c in counts.values())
                                           for k in entry["kernels"]}
        if entry["launches"] < 1 or min(entry.get("launches_by_kernel", {0: 1}).values()) < 1:
            raise AssertionError(f"{entry['name']} was launched on no path of the main path")
    ok = {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}
    with open(out / "results.jsonl", "w") as f:
        for obj in ({"kernels": kernels}, {"summary": SUMMARY}, ok):
            f.write(json.dumps(obj) + "\n")
    print(json.dumps({"kernels": kernels}), flush=True)
    print_summary(kernels)
    print(json.dumps(ok), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
