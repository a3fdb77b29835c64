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
the earlier designs' times beside, holds the decoder's output transposed
conv kernel (``csrc/tconv_out.cu``) against cuDNN at the train step's
shape in bf16 and times it beside its bound, its plain version and the
library call, then
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
the last three on the C++ corpus render, each training path 2 epochs, so
that its second epoch replays the CUDA graph of its K-step group
(``TrainConfig.steps_per_dispatch``, ``training/dispatch.py``; every
training path is held to the graph captures and replays it must show).
Each of these paths caches its corpus under a data root of its own, so
that its corpus pass is cold. Then
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
one's steady step and peak device memory in bf16, then with remat a K=2
group's graph against eager steps; ``dispatch`` trains the flagship on
the 1,024-preset corpus at ``steps_per_dispatch`` 1, 16 and -1 in float32
(every validation scalar within rtol 1e-5, atol 1e-7 of K=1's, on cuDNN's
deterministic algorithms) and bf16, resumes a K=16 run (bit-equal to an
uninterrupted one), and times the bf16 step eagerly against a replay of
16 steps (median of 3 trials, the capture's seconds, the device-busy
share of a traced replay). Last, the ``cli`` paths
drive the port's command-line entry points as a user runs them:
``python -m preset_gen_vae_tpu_torch.scripts.evaluate`` in a subprocess
over the train path's run (its summary held to the in-process eval's
within 1e-5, 164 items), ``scripts.train_queue``'s ``main`` on a one-entry
queue and the loop CLI's ``main`` (``training/loop.py``), each 1 epoch on
512 presets with ``--no-tensorboard``, and ``scripts.clean_logs`` in a
subprocess on the queue's run (only that run erased). Last, the
parallel layer's tensor parallelism and host-fed pipeline: ``tp_step``
takes the flagship's step on multiproc2's 160 rows under a (data=1,
model=2) grid of two gloo processes (its 2 kernels of 44,974,080
elements sharded) and holds the loss, every gathered gradient, every
running statistic and the generator's state to one process's in float64
(1e-8 of each tensor's scale; float32 printed), with each process's peak
memory; ``tp_rows`` does the same for ``r2mlp400`` on 32 rows under a
(1, 4) grid, its head's ``fc4`` sharded by rows; ``tp_train`` trains the
train path's configs through ``train_config`` under the (1, 2) grid
(its processes' launches counted) against its column twin, one process
computing the two sharded Linears in halves as the grid does (every
/Valid scalar within 2e-3, checkpoints compared; those against the
one-process train path printed), and resumes its last checkpoint in this
process beside the twin's (``tp_resume``: every /Valid scalar within
2e-3); ``hostfed`` makes a cold corpus pass host-fed and one resident
(the same tiers and statistics, the host-fed peak lower), then trains
the train path with ``dataset_cache_device=False`` against the resident
corpus, both eager: bit-equal in float32 (cuDNN's deterministic
algorithms), a lower peak, and the bf16 host-fed step against the
resident K=16 step. Last, ``cli_protocols`` runs the flagship's own
protocols through their ``main``: ``scripts.compare_corpus_styles`` on
both corpus styles and ``scripts.run_flowloss`` in both inverse-BN
modes, at 256 presets and 1 epoch on a data root of their own (three
cold passes of 4 K1 each; the style runs' evals re-render through F1 and
F2), each run's name, line keys, finite metrics and 41 validation items
gated. Each path prints
its wall time, launches of every kernel and peak memory, the training
paths also their model build time, steady step, corpus and render
seconds. Runs and caches live in a
temporary directory that is removed at the end.

Run from the repository root with one GPU:

    python3 chip_smoke.py

It prints the card's name and power limit, one line per phase, its
total time, the kernels' JSON line, a compact summary of every path and kernel, and as
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
import functools
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


TCONV_SHAPE = (160, 8, 129, 174)  # dec7's input at the train step's batch (speccnn8l1_bn)


def tconv_out_work(B: int, C: int, H: int, W: int, elem_bytes: int):
    """(bytes, flops) of the decoder's output transposed conv (C -> 1, 5x5,
    stride 2, padding 2) on (B, C, H, W): input, weight, bias read once and
    the (B, 1, 2H - 1, 2W - 1) output written once; a multiply-add for each
    channel and each tap of an output pixel that falls inside the input (9,
    6, 6 or 4 by the pixel's parity inside the image). The taps separate by
    rows and columns, so their count is the product of the two sums."""
    def taps(n: int) -> int:
        out = np.arange(2 * n - 1)[:, None]
        k = np.arange(5)[None, :]
        src = out + 2 - k
        return int(((src % 2 == 0) & (src >= 0) & (src < 2 * n)).sum())

    nbytes = elem_bytes * (B * C * H * W + C * 25 + 1 + B * (2 * H - 1) * (2 * W - 1))
    return nbytes, 2 * B * C * taps(H) * taps(W)


def phase_tconv_out():
    """The decoder's output conv kernel at the train step's shape, bf16,
    channels_last: against cuDNN (bit-equal: no output differs), then timed
    beside its bound, its plain version (``F.conv_transpose2d``, cuDNN on
    the card) and that library call, two inputs in turn (L2 cold)."""
    import torch.nn.functional as F

    from preset_gen_vae_tpu_torch.ops import tconv_out as to

    print(f"[build] tconv_out\n"
          f"{ptxas_report('tconv_out', to.tconv_out_build_command(), to.TCONV_OUT_SOURCE)}",
          flush=True)
    rng = np.random.default_rng(0)
    B, C, H, W = TCONV_SHAPE
    lim = (1.0 / (C * 25)) ** 0.5

    def operands():  # the input channels_last, as the decoder hands it over
        x = torch.from_numpy(rng.standard_normal(TCONV_SHAPE).astype(np.float32))
        w = torch.from_numpy(rng.uniform(-lim, lim, (C, 1, 5, 5)).astype(np.float32))
        b = torch.from_numpy(rng.uniform(-lim, lim, (1,)).astype(np.float32))
        x, w, b = [t.cuda().to(torch.bfloat16) for t in (x, w, b)]
        return x.to(memory_format=torch.channels_last), w, b

    inputs = [operands() for _ in range(2)]
    x, w, b = inputs[0]
    got, ref = to.launch(x, w, b), F.conv_transpose2d(x, w, b, 2, 2)
    torch.cuda.synchronize()
    share = float((got != ref).float().mean())
    err = float((got.float() - ref.float()).abs().max())
    if got.shape != ref.shape or share > 0:
        raise AssertionError(f"tconv_out: shape {tuple(got.shape)} vs {tuple(ref.shape)}, share "
                             f"differing from cuDNN {share} (want 0)")
    ms = cuda_ms(lambda a: to.launch(*a), inputs)
    plain_ms = cuda_ms(lambda a: to.plain(*a), inputs)
    library_ms = cuda_ms(lambda a: F.conv_transpose2d(*a, 2, 2), inputs)
    nbytes, flops = tconv_out_work(B, C, H, W, 2)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    print(f"[tconv_out] bf16 {TCONV_SHAPE}: {share:.3e} of the outputs differ from cuDNN's "
          f"(max |diff| {err:.3e}); kernel {ms:.4f} ms, plain (F.conv_transpose2d) "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms (bytes "
          f"{nbytes / 1e6:.2f} MB = {t_bytes:.4f} ms, {flops / 2e9:.3f} G FMA = {t_ops:.4f} ms);"
          f" {bound_ms / ms:.1%} of the bound, {library_ms / ms:.1f}x faster than the library",
          flush=True)
    return {"name": "tconv_out", "route": "cuda",
            "source": "preset_gen_vae_tpu_torch/csrc/tconv_out.cu", "replaces": None,
            "launches": None, "share_differing": share, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": library_ms}


def build_kernels():
    """Builds K1, F1/F2 and the decoder's output conv at once, one nvcc
    each, started together."""
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp
    from preset_gen_vae_tpu_torch.ops import tconv_out as to
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        for build in [pool.submit(fn) for fn in (sp._logmel_library, ft._fm_library,
                                                 to._tconv_out_library)]:
            build.result()  # re-raises a failed build
    print(f"[build] logmel.cu, fm_render.cu and tconv_out.cu built in parallel in "
          f"{time.time() - t0:.1f} s", flush=True)


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


def f2_phase_errors(args, ref_sample=None, loop_ref=None):
    """F2 and its two phases against their plain versions on the same F1
    outputs: -> (max |err| by item of fm_exact against exact_pass, of the
    loop phase against feedback_loop_pass on the items with feedback, and
    of the feed-forward phase, run on the plain loop's output, against
    feedforward_pass; each finished by fade_and_volume where it is a
    waveform). ``ref_sample`` is exact_pass's carrier sum and ``loop_ref``
    feedback_loop_pass's output, where already made."""
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    amps, starts, incs, alg, fb_amt, nc, mv, sr = args
    phases, amps_s = ft.sample_phases(starts, incs), ft.upsample_amps(amps)
    if ref_sample is None:
        ref_sample = ft.exact_pass(phases, amps_s, alg, fb_amt)
    out = ft.fm_exact(*args)
    e_f2 = (out - ft.fade_and_volume(ref_sample, nc, mv, sr)).abs().amax(1)
    del out
    on = fb_amt != 0
    if loop_ref is None:
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
            del phases, amps_s
            errs = f1_errors((amps, pitch_fact, starts, incs), want)
            e_f2, e_loop, e_ff = (float(e.max()) for e in f2_phase_errors(args, ref, loop_ref))
            del loop_ref
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


def launch_counters():
    """Each kernel wrapper's launch counts (K1; F1, F2, F1b, F2b; the
    decoder's output conv)."""
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp
    from preset_gen_vae_tpu_torch.ops import tconv_out as to
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    return sp.LAUNCHES, ft.LAUNCHES, to.LAUNCHES


def all_launches() -> dict:
    """Every kernel's launches so far in this process, by name."""
    return {k: n for counts in launch_counters() for k, n in counts.items()}


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
    from preset_gen_vae_tpu_torch.synth import fm_torch as ft

    for counts in launch_counters():
        for k in counts:
            counts[k] = 0
    gc.collect()  # the previous path's tensors must not count in this one's peak
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
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
        line.update({k: result[k] for k in GRAPH_KEYS if k in result})
    SUMMARY.append(line)
    return result, launches, wall, peak


# the loop summary's K and CUDA graph counts (training/dispatch.py)
GRAPH_KEYS = ("steps_per_dispatch", "train_graph_captures", "train_graph_replays",
              "eval_graph_captures", "eval_graph_replays", "remainder_graph_captures",
              "remainder_graph_replays")


# the scalars of the loss that the train step backpropagates
LOSS_KEYS = ("ReconsLoss/Backprop/", "LatLoss/", "Controls/BackpropLoss/", "FlowInputReg/",
             "TotalLoss/", "VAELoss/")


def check_train_summary(name: str, summary: dict, epochs_trained: int,
                        input_size=(160, 1, 257, 347), dim_z: int = 610, *, graphs,
                        finite=None):
    """Finite metrics (those whose names start with one of ``finite``, if
    given; the others printed where they are not), the configuration's
    shapes, the epochs, and ``graphs`` = (train, eval): whether the K-step
    group's CUDA graph and the validation step's were captured, once each,
    and replayed (a one-process path with more than one group of steps,
    resp. validation batches, on epochs that are not profiled); neither
    otherwise."""
    nan = {k: v for k, v in summary.items() if isinstance(v, float) and not np.isfinite(v)}
    bad = {k: v for k, v in nan.items() if finite is None or k.startswith(finite)}
    if bad:
        raise AssertionError(f"{name}: non-finite metrics: {bad}")
    if nan:
        print(f"[{name} path] non-finite monitors (not gated): {nan}", flush=True)
    for kind, want in zip(("train", "eval"), graphs):
        got = (summary[f"{kind}_graph_captures"], summary[f"{kind}_graph_replays"])
        if got[0] != int(want) or (got[1] > 0) != bool(want):
            raise AssertionError(f"{name}: {kind} graph captures and replays {got}, want "
                                 f"{'1 and some' if want else 'none'}")
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
    check_train_summary("train", summary, 2, graphs=(True, True))
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
    check_train_summary("resume", summary, 3, graphs=(False, True))
    restored = load_checkpoint(model_c, 1)
    steps_per_epoch = summary["train_steps"]
    if not summary["start_step"] == restored["state"]["step"] == 2 * steps_per_epoch:
        raise AssertionError(f"resume: step {summary['start_step']}, checkpoint "
                             f"{restored['state']['step']}, {steps_per_epoch} steps an epoch")
    # capturable Adam holds its LR as a float32 device tensor
    if any(lr != float(np.float32(restored["scheduler"]["lr"])) for lr in summary["start_lr"]):
        raise AssertionError(f"resume: LRs {summary['start_lr']} vs {restored['scheduler']}")
    if list_checkpoint_epochs(model_c) != [1, 2]:
        raise AssertionError(f"resume: checkpoints {list_checkpoint_epochs(model_c)}")
    print(f"[resume path] wall {wall:.2f} s, K1 launches {counts['resume']['logmel']}, restored "
          f"step {summary['start_step']} = 2 x {steps_per_epoch}, LR {summary['start_lr']} in "
          f"every group = the scheduler's {restored['scheduler']['lr']}, model build "
          f"{summary['model_build_seconds']:.2f} s, steady step "
          f"{summary['step_ms']:.2f} ms, peak device memory {mem:.2f} GiB; checkpoints "
          f"{list_checkpoint_epochs(model_c)}", flush=True)
    train_summary = dict(train_summary, resume_summary=summary)  # tp_train's yardstick

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
    check_train_summary("profile", summary, 1, graphs=(False, True))
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
    check_train_summary("multiproc1", summary, 2, graphs=(False, False))
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


def multiproc2_inputs(run: str = None, B: int = MULTIPROC2_BATCH):
    """The flagship's configs (or, with ``run``, a saved run's, float32)
    and ``B`` seeded rows (x, v, info) made on the card; rows 0-2 have
    three silent operators (the categorical loss's useful items then
    differ between the two halves)."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
    from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
    from preset_gen_vae_tpu_torch.synth import dexed_params as dx

    helper = PresetIndexesHelper(build_dexed_preset_spec())
    L = helper.learnable_preset_size
    if run is None:
        model_c, train_c = cfg.resolve(cfg.ModelConfig(),
                                       cfg.TrainConfig(minibatch_size=B, compute_dtype="float32"))
        model_c = dataclasses.replace(model_c, synth_params_count=L,
                                      learnable_params_tensor_length=L, dim_z=L,
                                      input_tensor_size=(B, 1, 257, 347))
    else:
        model_c, train_c = saved_run_configs(run, "unused", minibatch_size=B,
                                             compute_dtype="float32")
        model_c = dataclasses.replace(model_c, input_tensor_size=(B, 1, 257, 347))
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((B, 1, 257, 347), device="cuda", generator=g) * 0.3
    full = torch.rand((B, helper.full_preset_size), device="cuda", generator=g)
    full[:3, torch.as_tensor(dx.operator_volume_indexes()[:3], device="cuda")] = 0.0
    v = torch.from_numpy(helper.full_to_learnable_batch(full.cpu().numpy())).cuda()
    info = torch.tensor([[i, 60, 85] for i in range(B)], dtype=torch.int32, device="cuda")
    return model_c, train_c, helper, x, v, info


def flagship_step(model_c, train_c, helper, x, v, info, dtype, grid=None) -> dict:
    """One train step of the flagship (or of ``model_c``) built from seed 0
    in ``dtype`` (TF32 off), under a tensor-parallel ``grid`` sharded at
    ``train_c.tp_min_elements``, dropout and noise from a generator seeded
    11: the total loss (averaged over the data group), every gradient (a
    shard's gathered), every running statistic and the generator's state
    after the step, on the host; and the step's peak device memory above
    what was allocated before its model was built (GiB; the gathered
    gradients come after it), where the caller reset the peak statistics
    just before the call."""
    from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
    from preset_gen_vae_tpu_torch.parallel import multihost, sharding_rules
    from preset_gen_vae_tpu_torch.training.train_step import Criteria, make_optimizer, \
        train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    base = torch.cuda.memory_allocated()
    model = build_extended_ae_model(model_c, train_c, helper, seed=0).to("cuda", dtype)
    if grid is not None:
        sharding_rules.shard_model(model, grid, train_c.tp_min_elements)
    generator = torch.Generator(device="cuda").manual_seed(11)
    m = train_step(model, make_optimizer(model, train_c), Criteria(model_c, train_c, helper),
                   train_c, x.to(dtype), v.to(dtype), info, 0.2, generator)
    peak_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    loss = m["TotalLoss"].reshape(1).clone()
    multihost.all_reduce_mean_([loss])
    return {"loss": loss.cpu(), "peak_gib": peak_gib,
            "grads": {k: g.cpu() for k, g in sharding_rules.full_gradients(model).items()},
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
    out = pathlib.Path(root) / "multiproc2"
    out.mkdir()

    def run():
        spawn_ranks(multiproc2_rank, 2, (str(out / "store"), str(out)))
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


def flagship_stepper(model_c, train_c, helper, loader):
    """The flagship built from seed 0 on the card, its capturable Adam,
    criteria and a generator seeded 11; -> (model, generator, step), where
    ``step(sel, latents=True)`` is one train step (beta 0.2, a device
    scalar) on the rows of ``loader`` that index row ``sel`` selects, as
    the loop takes it."""
    from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
    from preset_gen_vae_tpu_torch.training.train_step import Criteria, make_optimizer, \
        train_step

    model = build_extended_ae_model(model_c, train_c, helper, seed=0).to("cuda")
    opt, crit = make_optimizer(model, train_c), Criteria(model_c, train_c, helper)
    gen = torch.Generator(device="cuda").manual_seed(11)
    beta = torch.full((), 0.2, device="cuda")

    def step(sel, latents=True):
        x, v, info = loader.gather(sel)
        return train_step(model, opt, crit, train_c, x, v, info, beta, gen, latents=latents)

    return model, gen, step


def scalar_row(metrics: dict, keys) -> torch.Tensor:
    return torch.stack([metrics[key] for key in keys])


def train_keys(model_c, train_c, helper):
    from preset_gen_vae_tpu_torch.training.train_step import Criteria

    return Criteria(model_c, train_c, helper).scalars + ("TotalLoss",)


def graph_against_eager(model_c, train_c, helper, x, v, info, k: int = 2) -> dict:
    """2k train steps of the flagship on shuffles of the rows (x, v, info),
    eagerly and as a K-step group (``training/dispatch.py``): its first k
    steps the group's warm-up, the next k one capture and replay; with
    cuDNN's deterministic algorithms (float32's default ones are not), so
    that the two can agree to the bit. -> whether the scalar rows are
    within ``DISPATCH_BAR``, their largest difference, the largest
    parameter and buffer difference, whether the generators' states are
    equal, the group's captures and replays."""
    from preset_gen_vae_tpu_torch.data.pipeline import SplitLoader
    from preset_gen_vae_tpu_torch.training.dispatch import TrainGroups

    B = train_c.minibatch_size
    loader = SplitLoader({"x": x, "v": v, "info": info}, np.arange(len(x)), B, shuffle=True,
                         drop_last=True)
    idx = torch.from_numpy(np.stack([next(loader.epoch_index_batches(e))
                                     for e in range(2 * k)])).cuda()
    keys = train_keys(model_c, train_c, helper)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model_a, gen_a, step_a = flagship_stepper(model_c, train_c, helper, loader)
        rows_a = torch.stack([scalar_row(step_a(idx[j]), keys) for j in range(2 * k)])
        model_b, gen_b, step_b = flagship_stepper(model_c, train_c, helper, loader)
        groups = TrainGroups(k, B, step_b, keys, torch.device("cuda"), f"{k} flagship steps",
                             gen_b)
        with groups.call.warm_up():
            warm = [scalar_row(step_b(idx[j]), keys) for j in range(k)]
        rows_b = torch.cat([torch.stack(warm), groups.run(idx[k:])[0]])
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bar = DISPATCH_BAR["atol"] + DISPATCH_BAR["rtol"] * rows_a.abs()
    params = max(float((a.double() - b.double()).abs().max())
                 for a, b in zip(model_a.state_dict().values(), model_b.state_dict().values()))
    return {"rows_within_bar": bool(((rows_a - rows_b).abs() <= bar).all()),
            "rows_max_abs": float((rows_a - rows_b).abs().max()), "params": params,
            "generator_equal": torch.equal(gen_a.get_state(), gen_b.get_state()),
            "captures": groups.call.captures, "replays": groups.call.replays}


def phase_remat():
    """``TrainConfig.remat`` on the card: one flagship step at batch 160 (the
    multiproc2 rows) with remat and without, in float64 (TF32 off): the
    loss, every gradient and every running statistic within 1e-4 of each
    tensor's scale (multiproc2's rule, ``module_scales``) and the
    generator's state equal; then in bf16 autocast the steady step time
    and the peak device memory of each; last, in float32 with remat on, 4
    eager steps against a K=2 group (2 warm-up steps, then one CUDA graph
    capture and replay of 2): scalar rows within the dispatch bar
    (``DISPATCH_BAR``), the generator's state equal, the parameter
    difference printed."""
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def run():
        model_c, train_c, helper, x, v, info = multiproc2_inputs()
        steps = {on: flagship_step(model_c, dataclasses.replace(train_c, remat=on), helper, x, v,
                                   info, torch.float64) for on in (False, True)}
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        timing = {on: remat_step_timing(model_c, train_c, helper, x, v, info, on)
                  for on in (False, True)}
        graphed = graph_against_eager(model_c, dataclasses.replace(train_c, remat=True), helper,
                                      x, v, info)
        return steps, timing, graphed

    (steps, timing, graphed), counts, wall, _ = drive("remat", run, k1=0)
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
    print(f"[remat] remat on, float32, K=2 group (2 warm-up steps, then a CUDA graph of 2 "
          f"replayed) against 4 eager steps: {json.dumps(graphed)}", flush=True)
    if errs[0][1] > 1e-4 or not same_gen:
        raise AssertionError(f"remat: float64 {errs[:5]} (bar 1e-4), generator equal {same_gen}")
    if not graphed["rows_within_bar"] or not graphed["generator_equal"] or \
            (graphed["captures"], graphed["replays"]) != (1, 1):
        raise AssertionError(f"remat: K-step graph against eager steps {graphed}")
    return {"remat": counts}


# K-step dispatch against one step at a time: the bar of the JAX package's
# tests/test_loop.py::test_steps_per_dispatch_matches
DISPATCH_BAR = {"rtol": 1e-5, "atol": 1e-7}
DISPATCH_KS = (1, 16, -1)
DISPATCH_TRIALS = 3
DISPATCH_K = 16  # the timed group: the saved runs' K


def valid_scalars(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k.endswith("/Valid")}


@functools.lru_cache(maxsize=4)
def checkpoint_state(run_dir: str, epoch: int) -> dict:
    """A run's checkpoint ``epoch`` (model, Adam, step, generator), read once."""
    return torch.load(pathlib.Path(run_dir) / "checkpoints" / str(epoch) / "state.pt",
                      map_location="cpu", weights_only=True)


def run_difference(a, b, epoch: int) -> dict:
    """Two runs ((model_c, summary) each): the largest /Valid difference,
    whether every /Valid scalar is within ``DISPATCH_BAR``, and the largest
    difference of checkpoint ``epoch``'s parameters and buffers, of Adam's
    state and whether the generators' states are equal."""
    (_, a_s), (_, b_s) = a, b
    va, vb = valid_scalars(a_s), valid_scalars(b_s)
    ca, cb = (checkpoint_state(x["run_dir"], epoch) for x in (a_s, b_s))

    def worst(ta, tb):
        return max(float((ta[k].double() - tb[k].double()).abs().max()) for k in tb)

    return {"valid_max_abs": max(abs(va[k] - vb[k]) for k in vb),
            "valid_within_bar": va.keys() == vb.keys() and all(
                abs(va[k] - vb[k]) <= DISPATCH_BAR["atol"] + DISPATCH_BAR["rtol"] * abs(vb[k])
                for k in vb),
            "params_max_abs": worst(ca["model"], cb["model"]),
            "adam_max_abs": max(worst(sa, ca["optimizer"]["state"][i])
                                for i, sa in cb["optimizer"]["state"].items()),
            "generator_equal": torch.equal(ca["generator"], cb["generator"]),
            "steps": (ca["step"], cb["step"])}


def trace_busy(trace_path: pathlib.Path) -> dict:
    """A Chrome trace of one replay: the window from the graph's launch on
    the host to the last device activity's end, the union of the device's
    kernel, copy and fill intervals within it, and their count."""
    events = json.loads(trace_path.read_text())["traceEvents"]
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                    and e.get("ph") == "X")
    launch = [e["ts"] for e in events if e.get("cat") == "cuda_runtime"
              and "GraphLaunch" in str(e.get("name"))]
    if not device or not launch:
        return {"busy_share": None, "device_events": len(device), "graph_launches": len(launch)}
    start, end = min(launch), max(b for _, b in device)
    busy, cursor = 0.0, start
    for a, b in device:
        a, b = max(a, cursor), min(b, end)
        if b > a:
            busy, cursor = busy + b - a, b
    return {"busy_share": busy / (end - start), "window_ms": (end - start) / 1e3,
            "device_ms": busy / 1e3, "device_events": len(device), "graph_launches": len(launch)}


def dispatch_step_timing(model_c, train_c, dataset, out_dir: pathlib.Path) -> dict:
    """The flagship's steady train step in bf16 at K=1 (an eager step) and
    K=16 (a replay of the graph of 16 steps) in this process, over 16 train
    batches of the corpus: the group's warm-up (16 eager steps, the first
    with cuDNN's search), its capture (seconds), then ``DISPATCH_TRIALS``
    trials in turns, 16 eager steps and one replay each, synchronised
    (ms a step); last a profiler trace of one replay (device-busy share)."""
    from torch.profiler import ProfilerActivity, profile

    from preset_gen_vae_tpu_torch.data.pipeline import get_split_loaders
    from preset_gen_vae_tpu_torch.training.dispatch import TrainGroups

    helper = dataset.preset_indexes_helper
    loader = get_split_loaders(dataset, train_c)["train"]
    rows = [b for e in range(DISPATCH_K) for b in loader.epoch_index_batches(e)][:DISPATCH_K]
    idx = torch.from_numpy(np.stack(rows)).cuda()
    _, gen, step = flagship_stepper(model_c, train_c, helper, loader)
    groups = TrainGroups(DISPATCH_K, loader.batch_size, step, train_keys(model_c, train_c, helper),
                         torch.device("cuda"), f"{DISPATCH_K} flagship steps", gen)
    with groups.call.warm_up():
        for j in range(DISPATCH_K):
            step(idx[j], False)
    torch.cuda.synchronize()
    groups.run(idx)  # the capture, then its first replay
    torch.cuda.synchronize()
    eager, graph = [], []
    for _ in range(DISPATCH_TRIALS):
        t0 = time.perf_counter()
        for j in range(DISPATCH_K):
            step(idx[j], False)
        torch.cuda.synchronize()
        eager.append((time.perf_counter() - t0) * 1e3 / DISPATCH_K)
        t0 = time.perf_counter()
        groups.run(idx)
        torch.cuda.synchronize()
        graph.append((time.perf_counter() - t0) * 1e3 / DISPATCH_K)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        groups.run(idx)
        torch.cuda.synchronize()
    out_dir.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out_dir / "replay_trace.json"))
    return {"k1_ms": sorted(eager), "k16_ms": sorted(graph),
            "k1_median_ms": float(np.median(eager)), "k16_median_ms": float(np.median(graph)),
            "capture_s": groups.call.capture_s, "replays": groups.call.replays,
            "trace": trace_busy(out_dir / "replay_trace.json")}


def phase_dispatch(root: str):
    """``TrainConfig.steps_per_dispatch`` on the card: the flagship at full
    width on the smoke's 1,024-preset corpus (4 train steps an epoch, 2
    validation batches), trained 2 epochs from one seed at K=1 (eager
    steps), K=16 and K=-1 (both capped at the epoch's 4 steps: the first
    epoch's group is the graph's warm-up, the second epoch replays it),
    through ``train_config`` on one corpus pass per dtype:

    - float32 with TF32 off and cuDNN's deterministic algorithms (the
      float32 step's cuDNN algorithms are not deterministic by default:
      the noise floor, a second K=1 run without them, is printed): every
      /Valid scalar of K=16 and K=-1 within ``DISPATCH_BAR`` of K=1's, the
      largest parameter difference printed;
    - bf16 (the default algorithms): the same runs, their differences
      printed;
    - resume at K=16 (bf16): 2 epochs resumed for a third against 3
      uninterrupted epochs, /Valid scalars, parameters, Adam's state and
      the generator's state bit-equal (the resumed epoch is its group's
      warm-up, the uninterrupted one a replay);
    - the steady step in bf16 at K=1 and K=16 (``dispatch_step_timing``),
      the capture's seconds and the device-busy share of a traced replay.
    """
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.training.loop import prepare_dataset, train_config

    cudnn = torch.backends.cudnn
    flags = (cudnn.allow_tf32, cudnn.deterministic)
    runs, timing, diffs = {}, {}, {}

    def run(name, dataset, dtype, k, **kw):
        model_c = cfg.ModelConfig(logs_root_dir=root, run_name=f"dispatch_{name}")
        train_c = cfg.TrainConfig(**{"n_epochs": 2, "minibatch_size": 160, "lr_warmup_epochs": 0,
                                     "save_period": 1, "verbosity": 0, "compute_dtype": dtype,
                                     "steps_per_dispatch": k, **kw})
        summary = train_config(model_c, train_c, dataset=dataset, device="cuda",
                               use_tensorboard=False)
        epochs = kw.get("n_epochs", 2)
        check_train_summary(f"dispatch {name}", summary, epochs,
                            graphs=(k != 1 and epochs - kw.get("start_epoch", 0) > 1, True))
        return model_c, summary

    def body():
        for dtype in ("float32", "bfloat16"):
            corpus = fresh_corpus(CORPUS, root, f"dispatch_{dtype}")
            model_c, train_c, dataset = prepare_dataset(
                cfg.ModelConfig(logs_root_dir=root), cfg.TrainConfig(compute_dtype=dtype),
                torch.device("cuda"), dataset_kwargs=corpus)
            if dtype == "float32":
                runs["float32 K=1 nondeterministic"] = run("float32_nondet", dataset, dtype, 1)
            cudnn.deterministic = dtype == "float32"
            for k in DISPATCH_KS:
                runs[f"{dtype} K={k}"] = run(f"{dtype}_k{k}", dataset, dtype, k)
            cudnn.deterministic = flags[1]
            for k in DISPATCH_KS[1:]:
                diffs[f"{dtype} K={k}"] = run_difference(runs[f"{dtype} K={k}"],
                                                         runs[f"{dtype} K=1"], 1)
            if dtype == "float32":
                diffs["float32 K=1 nondeterministic"] = run_difference(
                    runs["float32 K=1 nondeterministic"], runs["float32 K=1"], 1)
        runs["bfloat16 K=16 3 epochs"] = run("bfloat16_full", dataset, "bfloat16", 16,
                                             n_epochs=3, save_period=3)
        runs["bfloat16 K=16 resumed"] = run("bfloat16_k16", dataset, "bfloat16", 16,
                                            start_epoch=2, n_epochs=3)
        diffs["resume"] = run_difference(runs["bfloat16 K=16 resumed"],
                                         runs["bfloat16 K=16 3 epochs"], 2)
        timing.update(dispatch_step_timing(model_c, train_c, dataset,
                                           pathlib.Path(root) / "dispatch_trace"))

    try:
        _, counts, wall, mem = drive("dispatch", body, k1=32)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = flags
        checkpoint_state.cache_clear()
    for name, d in diffs.items():
        against = ("2 + 1 epochs at K=16 (bf16) against 3" if name == "resume" else
                   "against K=1" + (" (cuDNN's deterministic algorithms)"
                                    if name.startswith("float32") else ""))
        print(f"[dispatch] {name} {against}: {json.dumps(d)}", flush=True)
    for name, (_, s) in runs.items():
        print(f"[dispatch] run {name}: K {s['steps_per_dispatch']}, loop step "
              f"{s['step_ms']:.2f} ms (first {s['first_step_ms']:.1f} ms), graphs "
              f"{json.dumps({k: s[k] for k in GRAPH_KEYS[1:]})}, capture "
              f"{s['graph_capture_s']:.3f} s, epoch {s['epoch_s']:.3f} s", flush=True)
    t = timing
    spread = {k: (min(t[k]), max(t[k])) for k in ("k1_ms", "k16_ms")}
    print(f"[dispatch] {card_line()}: flagship bf16 steady step, {DISPATCH_TRIALS} trials in "
          f"turns: K=1 median {t['k1_median_ms']:.3f} ms (spread {spread['k1_ms'][0]:.3f}-"
          f"{spread['k1_ms'][1]:.3f}), K=16 median {t['k16_median_ms']:.3f} ms (spread "
          f"{spread['k16_ms'][0]:.3f}-{spread['k16_ms'][1]:.3f}), "
          f"{t['k1_median_ms'] / t['k16_median_ms']:.2f}x; capture of 16 steps "
          f"{t['capture_s']:.3f} s; traced replay {json.dumps(t['trace'])}; wall {wall:.2f} s, "
          f"peak device memory {mem:.2f} GiB", flush=True)
    SUMMARY[-1].update(k1_step_ms=round(t["k1_median_ms"], 3),
                       k16_step_ms=round(t["k16_median_ms"], 3),
                       capture_s=round(t["capture_s"], 3), busy_share=t["trace"]["busy_share"])
    bad = [name for name in ("float32 K=16", "float32 K=-1")
           if not diffs[name]["valid_within_bar"]]
    resume = diffs["resume"]
    exact = (resume["valid_max_abs"] == 0 and resume["params_max_abs"] == 0
             and resume["adam_max_abs"] == 0 and resume["generator_equal"])
    if bad or not exact:
        raise AssertionError(f"dispatch: float32 runs off the bar {bad}, resume exact {exact}")
    return {"dispatch": counts}


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


def variant_train(counts, name, model_c, train_c, corpus, epochs, dim_z, finite=None):
    """One train path: K1 launched once per 64 presets and note, F1 and F2
    once per note on the 'jax' corpus backend, the input shape (B, stacked
    notes, 257, 347), finite metrics (``finite``: those of
    ``check_train_summary``); timings printed."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK
    from preset_gen_vae_tpu_torch.training.loop import train_config

    summary, counts[name], wall, mem = drive(name, lambda: train_config(
        model_c, train_c, dataset_kwargs=fresh_corpus(corpus, model_c.logs_root_dir, name),
        device="cuda", use_tensorboard=False), fm=corpus_fm_launches(model_c, corpus))
    n_notes = len(model_c.midi_notes)
    channels = n_notes if model_c.stack_spectrograms else 1
    check_train_summary(name, summary, epochs, (train_c.minibatch_size, channels, 257, 347),
                        dim_z, graphs=(True, True), finite=finite)
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
    audio batch); stack6 96 K1 and 6 F1/F2 launches a pass, 164 eval items;
    multi6 96 K1 and 6 F1/F2 launches, 24 steps, 984 eval items (4 audio
    batches); at 512 presets on the C++ corpus render 8 K1 launches: the
    flow-loss paths in both BN modes, the MLP head, BasicVAE with a MAF
    head, and the MAF head under FlowParamsLoss (its inverse in every
    forward, then held to ``MAF_INVERSE_BAR``)."""
    from preset_gen_vae_tpu_torch.data.sampler import split_preset_indexes

    counts = {}
    # ---- the repo's best run: 3 stacked notes, full width, 2 epochs
    model_c, train_c = saved_run_configs("r5stack3_v2_20480", root, n_epochs=2)
    summary = variant_train(counts, "stack3 train", model_c, train_c, CORPUS_V2, 2, 610)
    variant_eval(counts, "stack3 eval", model_c, summary["run_dir"], CORPUS_V2)

    # ---- the reference's six notes stacked: the shared CNN six times, mix7 on
    # six channels' features, full width, 2 epochs
    model_c, train_c = saved_run_configs("r5stack6_v2_8192", root, n_epochs=2)
    summary = variant_train(counts, "stack6 train", model_c, train_c, CORPUS_V2, 2, 610)
    variant_eval(counts, "stack6 eval", model_c, summary["run_dir"], CORPUS_V2)

    # ---- 6 un-stacked notes, MIDI in z0, 1800-channel mixers, 2 epochs
    # (24 steps each: a group of 16, the graph's warm-up, then replayed); a
    # saved config is resolved already, so its epoch counts stand as given
    # (config.py: resolve divides an un-stacked run's counts only once)
    model_c, train_c = saved_run_configs("r5multi6_v2_12288", root, n_epochs=2)
    summary = variant_train(counts, "multi6 train", model_c, train_c, CORPUS_V2, 2, 610)
    n_train = len(split_preset_indexes(CORPUS_V2["n_synthetic_presets"])["train"]) * 6
    if summary["train_steps"] != 2 * (n_train // train_c.minibatch_size):
        raise AssertionError(f"multi6: {summary['train_steps']} steps for {n_train} items")
    latents = {}
    items = variant_eval(counts, "multi6 eval", model_c, summary["run_dir"], CORPUS_V2, latents)
    midi = -1.0 + 2.0 * np.stack([items["midi_pitch"], items["midi_velocity"]], 1) / 127.0
    err = float(np.abs(latents["z0"][:, :2] - midi).max())
    if err > 1e-6 or len(set(zip(items["midi_pitch"], items["midi_velocity"]))) != 6:
        raise AssertionError(f"multi6 eval: z0 dims 0-1 off the MIDI head by {err}")
    print(f"[multi6 eval path] z0 dims 0-1 of all {len(midi)} items equal -1 + 2 (pitch, "
          f"velocity) / 127 of their own note (max |err| {err:.1e})", flush=True)

    # ---- FlowParamsLoss, the pullback in train mode, then in eval mode on
    # the running statistics from before the step (cut corpus)
    for mode in ("train", "eval"):
        model_c, train_c = saved_run_configs(f"r2flowloss_{mode}", root, n_epochs=2)
        if train_c.flow_loss_bn_mode != mode:
            raise AssertionError(f"r2flowloss_{mode}: flow_loss_bn_mode "
                                 f"{train_c.flow_loss_bn_mode!r}")
        summary = variant_train(counts, f"flowloss {mode}", model_c, train_c, VARIANT_CORPUS, 2,
                                610)
        print_floored(f"flowloss {mode}", summary, train_c)

    # ---- the MLP head, dim_z 256 (cut corpus)
    model_c, train_c = saved_run_configs("r2mlp400", root, n_epochs=2)
    summary = variant_train(counts, "mlp train", model_c, train_c, VARIANT_CORPUS, 2, 256)
    variant_eval(counts, "mlp eval", model_c, summary["run_dir"], VARIANT_CORPUS)
    variant_eval(counts, "mlp eval cpp", model_c, summary["run_dir"], VARIANT_CORPUS,
                 backend="cpp")

    # ---- BasicVAE (Dkl latent loss) with a MAF head, forward direction only
    model_c, train_c = saved_run_configs(
        "r2flowloss_train", root, dict(run_name="smoke_basic_maf", latent_flow_arch=None,
                                       params_regression_architecture="flow_maf_6l300",
                                       forward_controls_loss=True), n_epochs=2)
    summary = variant_train(counts, "basic_maf train", model_c, train_c, VARIANT_CORPUS, 2, 610)
    print(f"[basic_maf train path] LatLoss (Dkl) {summary['LatLoss/Train']} (train), "
          f"{summary['LatLoss/Valid']} (valid)", flush=True)

    # ---- the MAF head with FlowParamsLoss, which needs the latent flow
    # (BasicVAE has none to pull back through): the head maps z_K -> v by
    # the MAF's inverse (regression.py:121-124), 610 MADE passes a layer in
    # every forward, and pulls the target back by its one-pass forward. The
    # losses are gated finite; the monitors of v (QLoss, accuracy) are not:
    # on the train-mode z_K of a model 2 epochs from its init the inverse's
    # passes can leave f32's range, in the JAX package too
    # (tests/test_torch_port_variants.py::test_maf_inverse_overflows_where_the_jax_one_does)
    model_c, train_c = saved_run_configs(
        "r2flowloss_train", root, dict(run_name="smoke_maf_flowloss",
                                       params_regression_architecture="flow_maf_6l300"),
        n_epochs=2)
    summary = variant_train(counts, "maf flowloss", model_c, train_c, VARIANT_CORPUS, 2, 610,
                            finite=LOSS_KEYS)
    print_floored("maf flowloss", summary, train_c)
    maf_inverse_check(model_c, train_c)
    return counts


def print_floored(name: str, summary: dict, train_c):
    """The FlowParamsLoss scalars of a flow-loss path's last epoch and its
    share of items at the -1e8 floor."""
    share = summary["Controls/FlooredShare/Train"]
    n_train = summary["train_steps"] // 2 * train_c.minibatch_size
    print(f"[{name} path] flow_loss_bn_mode {train_c.flow_loss_bn_mode!r}, "
          f"Controls/BackpropLoss {summary['Controls/BackpropLoss/Train']} (train), "
          f"{summary['Controls/BackpropLoss/Valid']} (valid); items at the -1e8 floor: "
          f"{share * n_train:.0f} of {n_train} trained ({share:.1%}), "
          f"{summary['Controls/FlooredShare/Valid']:.1%} of validation", flush=True)


MAF_INVERSE_BAR = 1e-4  # max |inverse(forward(x)) - x| over max(1, max |x|), float32
MAF_INVERSE_ROWS = 160


def maf_inverse_check(model_c, train_c):
    """The trained MAF head's flow from the path's last checkpoint, in eval
    mode and float32 on the card: ``inverse(forward(x))`` against ``x`` on a
    seeded batch of ``MAF_INVERSE_ROWS`` rows (the forward is one MADE pass a
    layer, the inverse ``features`` passes a layer), the log-determinants
    against each other's negation, and the inverse's device time a call by
    CUDA events."""
    from preset_gen_vae_tpu_torch.logs.logger import load_checkpoint
    from preset_gen_vae_tpu_torch.models.flows import MaskedAffineAutoregressive, \
        RegressionFlow

    arch = model_c.params_regression_architecture.replace("flow_", "")
    flow = RegressionFlow(arch, model_c.dim_z, train_c.reg_fc_dropout)
    prefix = "reg_model.flow."
    state = load_checkpoint(model_c)["state"]["model"]
    flow.load_state_dict({k[len(prefix):]: t for k, t in state.items() if k.startswith(prefix)})
    flow = flow.cuda().eval()
    mafs = [m for m in flow.modules() if isinstance(m, MaskedAffineAutoregressive)]
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((MAF_INVERSE_ROWS, model_c.dim_z), device="cuda", generator=g)
    with torch.no_grad():
        y, logdet = flow.forward(x)
        back, inv_logdet = flow.inverse(y)
        ms = [cuda_ms(lambda a: flow.inverse(a), [y], reps=1) for _ in range(3)]
        graph = torch.cuda.CUDAGraph()  # the same call replayed: the device's time alone
        with torch.cuda.graph(graph):
            replayed, _ = flow.inverse(y)
        replay_ms = cuda_ms(lambda _: graph.replay(), [None], reps=3)
    torch.cuda.synchronize()
    err = float((back - x).abs().max()) / max(1.0, float(x.abs().max()))
    ld_err = float((logdet + inv_logdet).abs().max()) / max(1.0, float(logdet.abs().max()))
    passes = sum(m.features for m in mafs)
    print(f"[maf flowloss inverse] {card_line()}: {len(mafs)} MAF layers, {passes} MADE "
          f"passes an inverse on ({MAF_INVERSE_ROWS}, {model_c.dim_z}) float32, checkpoint "
          f"weights; max |inverse(forward(x)) - x| / max(1, max |x|) {err:.3e} (bar "
          f"{MAF_INVERSE_BAR:.0e}), log-determinants {ld_err:.3e} apart; inverse "
          f"{json.dumps([round(t, 3) for t in ms])} ms a call eagerly (CUDA events, 3 calls; "
          f"the stream waits on the host's launches), {replay_ms:.3f} ms a replay of its CUDA "
          f"graph ({replay_ms / passes * 1e3:.1f} us a MADE pass; replayed output "
          f"{'bit-equal to' if torch.equal(replayed, back) else 'differs from'} the eager "
          f"call's)", flush=True)
    if not (err <= MAF_INVERSE_BAR and ld_err <= MAF_INVERSE_BAR):
        raise AssertionError(f"MAF inverse: {err:.3e} from x, log-determinants {ld_err:.3e} "
                             f"apart (bar {MAF_INVERSE_BAR})")
    SUMMARY.append({"path": "maf inverse", "inverse_ms": min(ms),
                    "inverse_replay_ms": replay_ms, "made_passes": passes, "max_rel_err": err,
                    "launches": {}})


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
    check_train_summary("syx train", summary, 2, graphs=(True, True))
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
    check_train_summary("syx resume", summary, 3, graphs=(False, True))
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
    check_train_summary(name, summary, 1, graphs=(False, False))
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
    from preset_gen_vae_tpu_torch.scripts import train_queue
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
    counts["cli_eval"] = {k: launched.get(k, 0) for k in all_launches()}
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


# ---- the parallel layer's last parts: tensor parallelism and the host-fed
# pipeline (parallel/sharding_rules.py, data/pipeline.py)

def spawn_ranks(target, world: int, args, timeout: float = 600.0):
    """``target(rank, world, *args)`` in ``world`` spawned processes on the
    one card; fails unless each exits 0 in ``timeout`` seconds."""
    import torch.multiprocessing as mp

    gc.collect()
    torch.cuda.empty_cache()  # this process's cached blocks, for the ranks
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, world, *args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        p.kill()
    if hung or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"{target.__name__}: ranks hung {hung}, exit codes "
                             f"{[p.exitcode for p in procs]}")


def tp_rank(rank: int, world: int, store: str, out: str, run, batch: int, dtypes):
    """Process ``rank`` of a (1, ``world``) tensor-parallel grid under gloo on
    the one card: the step of ``multiproc2_inputs(run, batch)`` on all the
    rows, sharded, in each of ``dtypes``."""
    import torch.distributed as dist

    from preset_gen_vae_tpu_torch.models.layers import ShardedLinear
    from preset_gen_vae_tpu_torch.parallel import sharding_rules

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        grid = sharding_rules.make_2d_grid(1, world)
        inputs = multiproc2_inputs(run, batch)
        with sharding_rules.grid_scope(grid):
            for name in dtypes:
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                torch.save(flagship_step(*inputs, getattr(torch, name), grid=grid),
                           f"{out}/rank{rank}_{name}.pt")
    finally:
        dist.destroy_process_group()


def tp_against_one(name: str, root: str, world: int, run=None, batch: int = MULTIPROC2_BATCH,
                   bar: float = 1e-8):
    """A (1, ``world``) grid's step against one process's on the same rows:
    float64 within ``bar`` of each tensor's scale (``module_scales``),
    float32 printed; the plan, its sharded elements and each step's peak
    device memory in each process printed. -> (launch counts, the plan,
    (kernels, elements) sharded)."""
    from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
    from preset_gen_vae_tpu_torch.parallel import sharding_rules

    out = pathlib.Path(root) / name
    out.mkdir()

    def run_both():
        spawn_ranks(tp_rank, world, (str(out / "store"), str(out), run, batch,
                                     MULTIPROC2_DTYPES))
        inputs, steps = multiproc2_inputs(run, batch), {}
        for d in MULTIPROC2_DTYPES:
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            steps[d] = flagship_step(*inputs, getattr(torch, d))
        return steps

    want, counts, wall, _ = drive(name, run_both, k1=0)
    model_c, train_c, helper, *_ = multiproc2_inputs(run, 1)
    full = build_extended_ae_model(model_c, train_c, helper, seed=0)
    plan = sharding_rules.shard_plan(full, world, train_c.tp_min_elements)
    n, elements, total = sharding_rules.count_sharded(full, world, train_c.tp_min_elements)
    scales = module_scales(want["float64"])
    worst, peaks = {}, collections.defaultdict(list)
    for d in MULTIPROC2_DTYPES:
        errs = {}
        for r in range(world):
            got = torch.load(out / f"rank{r}_{d}.pt")
            peaks[d].append(round(got["peak_gib"], 3))
            if not torch.equal(got["generator"], want[d]["generator"]):
                raise AssertionError(f"{name}: rank {r}'s generator state differs ({d})")
            for k, e in step_errors(got, want[d], scales).items():
                errs[k] = max(errs.get(k, 0.0), e)
        worst[d] = sorted(errs.items(), key=lambda kv: -kv[1])
    print(f"[{name}] {card_line()}: {run or 'flagship'} on {batch} rows, a (1, {world}) grid of "
          f"gloo processes against one process, wall {wall:.2f} s; {n} kernels sharded "
          f"({elements:,} of {total:,} elements): {json.dumps(plan)} (0 column, 1 row); a "
          f"step's peak device memory above what was allocated before its model, each "
          f"process against the one process: "
          + ", ".join(f"{d} {peaks[d]} against {want[d]['peak_gib']:.3f} GiB"
                      for d in MULTIPROC2_DTYPES) + "; "
          + "; ".join(f"{d}: loss {dict(worst[d])['loss']:.2e}, worst "
                      f"{[(k, f'{e:.2e}') for k, e in worst[d][:3]]}" for d in MULTIPROC2_DTYPES),
          flush=True)
    if worst["float64"][0][1] > bar:
        raise AssertionError(f"{name}: float64 {worst['float64'][:5]} (bar {bar:g})")
    SUMMARY[-1].update(tp_sharded=n, tp_float64_worst=worst["float64"][0][1],
                       tp_step_peaks_gib=dict(peaks),
                       one_process_step_peak_gib={d: round(want[d]["peak_gib"], 3)
                                                  for d in MULTIPROC2_DTYPES})
    return counts, plan, (n, elements)


TP_ROWS_BATCH = 32  # r2mlp400's rows for four processes on the one card


def phase_tp_step(root: str):
    """The flagship's step under a (data=1, model=2) grid of two gloo
    processes on the card against one process, on multiproc2's 160 rows:
    float64 within 1e-8 of each tensor's scale; 2 kernels, 44,974,080
    elements sharded at the default ``tp_min_elements``."""
    counts, plan, sharded = tp_against_one("tp_step", root, 2)
    if sharded != (2, 44_974_080):
        raise AssertionError(f"tp_step: sharded {sharded}, want (2, 44974080)")
    return {"tp_step": counts}


def phase_tp_rows(root: str):
    """``r2mlp400`` under a (1, 4) grid of four gloo processes against one
    process on 32 rows: its head's ``fc4`` (flax (1024, 610): 610 % 4 != 0)
    sharded by rows, float64 within 1e-8."""
    counts, plan, _ = tp_against_one("tp_rows", root, 4, run="r2mlp400", batch=TP_ROWS_BATCH)
    if plan.get("reg_model.fc4") != 1:
        raise AssertionError(f"tp_rows: reg_model.fc4 not row-sharded: {plan}")
    return {"tp_rows": counts}


def tp_train_rank(rank: int, world: int, store: str, out: str, model_c, train_c, kwargs):
    """Process ``rank`` of a (1, ``world``) grid under gloo: ``train_config``
    on ``cuda:0`` with ``model_parallel_devices = world``; its summary and
    the kernel launches of its process saved. With ``world`` 1, the grid's
    column twin instead (``column_twin_builds``): one process, no process
    group, its steps eager as the grid's (``force_multihost_data``)."""
    import torch.distributed as dist

    from preset_gen_vae_tpu_torch.training.loop import train_config

    twin = world == 1
    if not twin:
        dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                                world_size=world)
    try:
        torch.cuda.reset_peak_memory_stats()
        train_c = dataclasses.replace(train_c, model_parallel_devices=world,
                                      force_multihost_data=twin)
        with column_twin_builds(train_c.tp_min_elements) if twin else contextlib.nullcontext():
            summary = train_config(model_c, train_c, device="cuda:0", use_tensorboard=False,
                                   dataset_kwargs=kwargs)
        torch.save({"summary": summary, "launches": all_launches(),
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30},
                   f"{out}/rank{rank}.pt")
    finally:
        if not twin:
            dist.destroy_process_group()


class _ToColumns(torch.autograd.Function):
    """The input of the column halves: the identity, whose backward hands on
    the halves' input gradients as one sum, as ``layers._CopyToModel``'s
    all-reduce does (summed into the input's other gradients one by one,
    they would round otherwise)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _JoinColumns(torch.autograd.Function):
    """The column halves' outputs joined along the last axis; backward,
    each half's gradient as a tensor of its own, as
    ``layers._GatherFromModel`` hands each process its slice."""

    @staticmethod
    def forward(ctx, *parts):
        ctx.widths = [p.shape[-1] for p in parts]
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, g):
        return tuple(s.contiguous() for s in g.split(ctx.widths, -1))


class GridColumns(torch.nn.Module):
    """A Linear that a (1, 2) grid shards by columns, computed in one process
    as the grid's two processes compute it (``layers.ShardedLinear``): each
    half of the weight (masked, for a ``MaskedDense``) and of the bias in a
    tensor of its own, multiplied on its own, the outputs joined. The
    input's gradient is the sum of the halves', handed on as one tensor,
    as the model group's all-reduce hands it on: a sum of two terms does
    not depend on their order. The parameters are the whole layer's, so that the run's
    checkpoints and Adam's state are a one-process run's."""

    def __init__(self, linear: torch.nn.Linear):
        super().__init__()
        self.weight, self.bias = linear.weight, linear.bias
        self.register_buffer("mask", getattr(linear, "mask", None), persistent=False)

    def forward(self, x):
        import torch.nn.functional as F

        x, parts = _ToColumns.apply(x), []
        for r in range(2):
            w = self.weight.chunk(2)[r]
            w = w.clone() if self.mask is None else w * self.mask.chunk(2)[r]
            parts.append(F.linear(x, w, self.bias.chunk(2)[r].clone()))
        return _JoinColumns.apply(*parts)


def column_twin(model: torch.nn.Module, min_elements: int) -> dict:
    """Replaces in place each Linear that a (1, 2) grid shards at
    ``min_elements`` by its ``GridColumns``: the grid's arithmetic in one
    process. -> the plan. Raises for a layer the grid shards by rows."""
    from preset_gen_vae_tpu_torch.parallel import sharding_rules

    plan = sharding_rules.shard_plan(model, 2, min_elements)
    for name, dim in plan.items():
        if dim != sharding_rules.COLUMN:
            raise NotImplementedError(f"{name} is sharded by rows on a (1, 2) grid")
        parent, _, attr = name.rpartition(".")
        owner = model.get_submodule(parent) if parent else model
        setattr(owner, attr, GridColumns(getattr(owner, attr)))
    return plan


@contextlib.contextmanager
def column_twin_builds(min_elements: int):
    """Inside the block ``train_config`` trains its model's column twin
    (``column_twin``)."""
    from unittest import mock

    from preset_gen_vae_tpu_torch.training import loop

    build = loop.build_extended_ae_model

    def twin_build(*args, **kwargs):
        model = build(*args, **kwargs)
        column_twin(model, min_elements)
        return model

    with mock.patch.object(loop, "build_extended_ae_model", twin_build):
        yield


TP_TRAIN_BAR = 2e-3  # tests/test_parallel_integration.py:76-79


def phase_tp_train(root: str, train_summary: dict):
    """The train path's configs (1,024 presets, 2 epochs, bf16) under a
    (data=1, model=2) grid of two gloo processes through ``train_config``:
    ``tp_kernels_sharded`` 2, its processes' launches counted in the path's
    (rank 0's cold corpus pass: 16 K1), finite metrics. Its one-process
    yardstick is its column twin (``column_twin``), trained in a process of
    its own on the same corpus: every /Valid scalar within 2e-3 relative
    (``TP_TRAIN_BAR``), the checkpoints' parameters, Adam's state and the
    generators' differences printed. At random weights the flows amplify
    any rounding difference to percents in 8 steps, so the scalars are
    held against the grid's own arithmetic; those against the one-process
    train path's (K=16 graphs) are printed. Then each run's last
    checkpoint (layout-free) resumes for a third epoch in this process
    (``tp_resume``: the grid's, from its step; the twin's beside it),
    every /Valid scalar within 2e-3 of each other's."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.logs.logger import load_checkpoint
    from preset_gen_vae_tpu_torch.training.loop import train_config

    out = pathlib.Path(root) / "tp_train"
    out.mkdir()
    train_c = cfg.TrainConfig(n_epochs=2, minibatch_size=160, lr_warmup_epochs=0, save_period=1,
                              verbosity=1)
    model_c = cfg.ModelConfig(logs_root_dir=root, run_name="tp_train")
    twin_c = cfg.ModelConfig(logs_root_dir=root, run_name="tp_train_twin")
    corpus = fresh_corpus(CORPUS, root, "tp_train")
    _, counts, wall, _ = drive("tp_train", lambda: spawn_ranks(
        tp_train_rank, 2, (str(out / "store"), str(out), model_c, train_c, corpus)), k1=0)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    for k in counts:
        counts[k] += sum(r["launches"][k] for r in ranks)
    tp_line = SUMMARY[-1]
    launched = tp_line["launches"] = {k: n for k, n in counts.items() if n}
    summary = ranks[0]["summary"]
    check_train_summary("tp_train", summary, 2, graphs=(False, False))
    if counts["logmel"] != 16 or summary["tp_kernels_sharded"] != 2 or \
            summary["tp_grid"] != [1, 2]:
        raise AssertionError(f"tp_train: K1 {counts['logmel']} (want 16), sharded "
                             f"{summary['tp_kernels_sharded']} (want 2), grid {summary['tp_grid']}")
    # the twin on the corpus cache that rank 0's pass wrote (warm: no K1)
    (out / "twin").mkdir()
    spawn_ranks(tp_train_rank, 1, ("", str(out / "twin"), twin_c, train_c, corpus))
    twin = torch.load(out / "twin" / "rank0.pt", weights_only=False)["summary"]
    check_train_summary("tp_train twin", twin, 2, graphs=(False, False))

    def relative(got: dict, want: dict) -> dict:
        return {k: abs(got[k] - w) / abs(w) if w else abs(got[k])
                for k, w in valid_scalars(want).items()}

    rel = relative(summary, twin)
    d = run_difference((model_c, summary), (twin_c, twin), 1)
    step = load_checkpoint(model_c, 1)["state"]["step"]
    resume_c = dataclasses.replace(train_c, start_epoch=2, n_epochs=3)
    resumed, resume_counts, r_wall, r_mem = drive("tp_resume", lambda: train_config(
        model_c, resume_c, dataset_kwargs=corpus, device="cuda", use_tensorboard=False), k1=0)
    check_train_summary("tp_resume", resumed, 3, graphs=(False, True))
    twin_resumed = train_config(twin_c, resume_c, dataset_kwargs=corpus, device="cuda",
                                use_tensorboard=False)
    checkpoint_state.cache_clear()
    resume_rel = relative(resumed, twin_resumed)
    print(f"[tp_train path] {card_line()}: 2 gloo processes, grid (1, 2), wall {wall:.2f} s, "
          f"launches {launched}, {summary['tp_kernels_sharded']} kernels sharded "
          f"({summary['tp_sharded_elements']:,} elements), steady step {summary['step_ms']:.2f} "
          f"ms (its column twin's {twin['step_ms']:.2f} ms, one process, eager; the one-process "
          f"train path's {train_summary['step_ms']:.2f} ms, K=16 graphs), peak device memory "
          f"of each process {[round(r['peak_gib'], 3) for r in ranks]} GiB; /Valid relative to "
          f"the column twin's {json.dumps(rel)} (bar {TP_TRAIN_BAR:g} on each), checkpoint 1 "
          f"against the twin's {json.dumps(d)}; /Valid relative to the one-process train "
          f"path's (not gated) {json.dumps(relative(summary, train_summary))}; resumed in one "
          f"process from checkpoint 1 (step {step}): wall {r_wall:.2f} s, start step "
          f"{resumed['start_step']}, /Valid relative to the twin's resumed "
          f"{json.dumps(resume_rel)}, peak {r_mem:.3f} GiB", flush=True)
    tp_line.update(tp_train_worst_rel=max(rel.values()),
                       tp_resume_worst_rel=max(resume_rel.values()))
    if max(rel.values()) > TP_TRAIN_BAR or max(resume_rel.values()) > TP_TRAIN_BAR or \
            resumed["start_step"] != step:
        raise AssertionError(f"tp_train: /Valid {rel}, resume {resume_rel} (bar {TP_TRAIN_BAR:g} "
                             f"on each), start step {resumed['start_step']} against the "
                             f"checkpoint's {step}")
    return {"tp_train": counts, "tp_resume": resume_counts}


def phase_hostfed(root: str):
    """The host-fed pipeline (``dataset_cache_device=False``) against the
    resident corpus on the flagship's train path (1,024 presets, 2
    epochs), both eager (K=1): in float32 on cuDNN's deterministic
    algorithms, /Valid, parameters, Adam's state and the generator's state
    bit-equal; then bf16, the host-fed step against the resident K=16
    step. First two cold corpus passes (16 K1 each), host-fed and
    resident, each on a cache of its own: the same tiers and statistics
    bit for bit, each pass's peak device memory beside the raw corpus's
    bytes (the host-fed pass holds a chunk of it at a time). Each run's
    peak device memory (above what was allocated before its dataset),
    steady step and the corpus bytes kept off the card printed; every run
    reloads the corpus from the cache that the host-fed cold pass
    wrote."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.training.loop import prepare_dataset, train_config

    cudnn = torch.backends.cudnn
    flags = (cudnn.allow_tf32, cudnn.deterministic)
    runs, peaks, cold = {}, {}, {}

    corpus = fresh_corpus(CORPUS, root, "hostfed")

    def cold_pass(on_device: bool, kwargs: dict):
        """A cold corpus pass; its peak above what was allocated before it,
        its cache directory, statistics and raw corpus bytes."""
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ds = prepare_dataset(cfg.ModelConfig(), cfg.TrainConfig(dataset_cache_device=on_device),
                             torch.device("cuda"), dataset_kwargs=kwargs)[2]
        ds.load_corpus()
        cold[on_device] = {"peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
                           "dir": ds._corpus_cache_dir(), "stats": ds.spec_stats,
                           "raw_bytes": math.prod(ds._raw_shape()) * 4}

    def run(name, dtype, on_device, k):
        """One run on the warm cache; its peak above what was allocated
        before its dataset was built (the resident corpus counts)."""
        model_c = cfg.ModelConfig(logs_root_dir=root, run_name=f"hostfed_{name}")
        train_c = cfg.TrainConfig(n_epochs=2, minibatch_size=160, lr_warmup_epochs=0,
                                  save_period=1, verbosity=0, compute_dtype=dtype,
                                  steps_per_dispatch=k, dataset_cache_device=on_device)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, train_c, dataset = prepare_dataset(model_c, train_c, torch.device("cuda"),
                                              dataset_kwargs=corpus)
        summary = train_config(model_c, train_c, dataset=dataset, device="cuda",
                               use_tensorboard=False)
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        check_train_summary(f"hostfed {name}", summary, 2, graphs=(k > 1, on_device))
        runs[name] = (model_c, summary)

    def body():
        # the host-fed cold pass writes the cache that every run reloads
        cold_pass(False, corpus)
        cold_pass(True, fresh_corpus(CORPUS, root, "hostfed_resident"))
        cudnn.deterministic = True
        run("float32_resident", "float32", True, 1)
        run("float32_host", "float32", False, 1)
        cudnn.deterministic = flags[1]
        run("bf16_resident_k16", "bfloat16", True, 16)
        run("bf16_host", "bfloat16", False, 1)

    try:
        _, counts, wall, mem = drive("hostfed", body)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = flags
    d = run_difference(runs["float32_host"], runs["float32_resident"], 1)
    checkpoint_state.cache_clear()
    host = runs["float32_host"][1]
    for name, (_, s) in runs.items():
        print(f"[hostfed] run {name}: K {s['steps_per_dispatch']}, corpus on the device "
              f"{s['dataset_cache_device']}, {s['corpus_bytes']:,} corpus bytes, loop step "
              f"{s['step_ms']:.2f} ms (first {s['first_step_ms']:.1f} ms), epoch "
              f"{s['epoch_s']:.3f} s, peak device memory above its base {peaks[name]:.3f} GiB",
              flush=True)
    tiers_equal = all(np.array_equal(np.load(cold[False]["dir"] / n, mmap_mode="r"),
                                     np.load(cold[True]["dir"] / n, mmap_mode="r"))
                      for n in ("specs_raw.npy", "specs_norm_f16.npy"))
    stats_equal = cold[False]["stats"] == cold[True]["stats"]
    print(f"[hostfed] {card_line()}: cold corpus pass ('cpp', {cold[False]['raw_bytes']:,} raw "
          f"bytes in float32), peak device memory above its base host-fed "
          f"{cold[False]['peak_gib']:.3f} GiB against resident {cold[True]['peak_gib']:.3f} GiB; "
          f"tiers equal {tiers_equal}, statistics equal {stats_equal}", flush=True)
    print(f"[hostfed] {card_line()}: float32 host-fed against resident (K=1, cuDNN's "
          f"deterministic algorithms): {json.dumps(d)}; {host['corpus_bytes']:,} corpus bytes off "
          f"the card, peak {peaks['float32_host']:.3f} against {peaks['float32_resident']:.3f} "
          f"GiB; bf16 host-fed step {runs['bf16_host'][1]['step_ms']:.2f} ms against the "
          f"resident K=16 step {runs['bf16_resident_k16'][1]['step_ms']:.2f} ms; wall "
          f"{wall:.2f} s, K1 launches {counts['logmel']}", flush=True)
    SUMMARY[-1].update(host_step_ms=round(runs["bf16_host"][1]["step_ms"], 3),
                       resident_k16_step_ms=round(runs["bf16_resident_k16"][1]["step_ms"], 3),
                       host_peak_gib=round(peaks["float32_host"], 3),
                       resident_peak_gib=round(peaks["float32_resident"], 3),
                       cold_pass_peak_gib={"host": round(cold[False]["peak_gib"], 3),
                                           "resident": round(cold[True]["peak_gib"], 3)})
    exact = (d["valid_max_abs"] == 0 and d["params_max_abs"] == 0 and d["adam_max_abs"] == 0
             and d["generator_equal"])
    if not exact or peaks["float32_host"] >= peaks["float32_resident"] or not tiers_equal or \
            not stats_equal or cold[False]["peak_gib"] >= cold[True]["peak_gib"]:
        raise AssertionError(f"hostfed: bit-equal {exact} ({d}), peaks {peaks}, cold passes "
                             f"{cold}, tiers equal {tiers_equal}")
    return {"hostfed": counts}


# ---- the flagship's own protocols (scripts/compare_corpus_styles.py,
# scripts/run_flowloss.py), each through its main as a user calls it

PROTOCOL_PRESETS = 256  # 4 chunks of 64 presets: 4 K1 a cold pass
PROTOCOL_VALID = 41  # the port's validation split of 256 presets
PROTOCOL_KEYS = {"style", "n_presets", "epochs_trained", "train_wall_s", "eval_wall_s",
                 "n_items", "card", "peak_gib", "launches"}  # the JAX script's and ours
PARAM_METRICS = ("num_eval_loss", "num_mae", "num_mae_dyn", "acc", "acc_dyn")


def printed_lines(fn):
    """``fn()`` with its standard output captured, then printed; -> (its
    result, the JSON objects it printed)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn()
    text = buf.getvalue()
    print(text, end="", flush=True)
    return result, [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def phase_cli_protocols(root: str):
    """The two protocol scripts' ``main(argv)`` in this process on the card,
    at 256 presets and 1 epoch, on a data root of their own ('cpp'/'disk'
    cold): ``compare_corpus_styles`` for both styles (a cold pass each,
    then training and the re-rendering eval, F1 and F2 once a style) and
    ``run_flowloss`` (one cold pass for both BN modes, evals without a
    render). Gates: each run's name and its line's keys, the corpus lines'
    4 K1 each, the training summaries as every training path's, finite
    metrics, 41 validation items in every eval, the comparison file."""
    from preset_gen_vae_tpu_torch.scripts import compare_corpus_styles, run_flowloss

    def argv(name):  # a data root of the script's own: the two share a corpus
        return ["--n-presets", str(PROTOCOL_PRESETS), "--epochs", "1", "--logs-root", root,
                "--data-root", fresh_corpus({}, root, f"cli_protocols_{name}")["data_root"]]
    lines = {}

    def body():
        lines["cmp"] = printed_lines(lambda: compare_corpus_styles.main(argv("cmp")))[1]
        lines["flowloss"] = printed_lines(lambda: run_flowloss.main(argv("flowloss")))[1]

    _, counts, wall, peak = drive("cli_protocols", body, k1=3 * 4, fm=2)
    corpus = [line for group in lines.values() for line in group if line.get("phase") == "corpus"]
    trains = [line for group in lines.values() for line in group if line.get("phase") == "train"]
    evals = [line for group in lines.values() for line in group if line.get("phase") == "eval"]
    runs = [line for line in lines["cmp"] if "run" in line]
    bad = []
    if [c["launches"].get("logmel") for c in corpus] != [4, 4, 4]:
        bad.append(f"K1 launches of the cold passes {[c['launches'] for c in corpus]}, want 4 "
                   "each")
    if [(r["run"], r["style"]) for r in runs] != [
            (f"torch_cmp_{s}_{PROTOCOL_PRESETS}", s) for s in ("structured", "structured2")]:
        bad.append(f"compare_corpus_styles runs {[(r['run'], r['style']) for r in runs]}")
    for r in runs:
        missing = PROTOCOL_KEYS - set(r)
        if missing or r["n_items"] != PROTOCOL_VALID or not all(
                np.isfinite(r[k]) for k in EVAL_METRICS):
            bad.append(f"{r['run']}: missing keys {missing}, {r['n_items']} items, "
                       f"{ {k: r[k] for k in EVAL_METRICS} }")
    modes = [(line["bn_mode"], line["run"]) for line in lines["flowloss"] if "run" in line]
    if modes != [(m, f"torch_flowloss_{m}") for m in ("train", "eval")] or \
            [line.get("bn_mode") for line in trains[2:] + evals[2:]] != ["train", "eval"] * 2:
        bad.append(f"run_flowloss runs {modes}")
    for line in evals:
        metrics = PARAM_METRICS + (() if "bn_mode" in line else EVAL_METRICS[5:])
        if line["n_items"] != PROTOCOL_VALID or not all(np.isfinite(line[k]) for k in metrics):
            bad.append(f"eval {line.get('bn_mode', '')}: {line['n_items']} items, "
                       f"{ {k: line[k] for k in metrics} }")
    if not (pathlib.Path(root) / run_flowloss.COMPARISON).is_file():
        bad.append(f"no {run_flowloss.COMPARISON}")
    if bad:
        raise AssertionError("cli_protocols: " + "; ".join(bad))
    for line in trains:
        name = f"cli_protocols {line.get('bn_mode') or line['run_dir'].rsplit('/', 1)[-1]}"
        check_train_summary(name, {k: v for k, v in line.items() if k != "phase"}, 1,
                            graphs=(False, False), finite=LOSS_KEYS)
    print(f"[cli_protocols path] {card_line()}: compare_corpus_styles (2 styles) and run_flowloss "
          f"(2 BN modes) at {PROTOCOL_PRESETS} presets, 1 epoch: wall {wall:.2f} s, peak "
          f"{peak:.3f} GiB, launches {json.dumps({k: n for k, n in counts.items() if n})}; "
          f"step ms {[round(t['step_ms'], 2) for t in trains]}, train walls "
          f"{[round(t['wall_s'], 2) for t in trains]} s, eval walls "
          f"{[round(e['wall_s'], 2) for e in evals]} s, cold passes "
          f"{[round(c['wall_s'], 2) for c in corpus]} s", flush=True)
    return {"cli_protocols": counts}


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
    t_start = time.perf_counter()
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
    tconv = phase_tconv_out()
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
        counts.update(phase_dispatch(root))
        counts.update(phase_cli(root, train_summary))
        # the parallel layer's last parts, after every earlier path
        counts.update(phase_tp_step(root))
        counts.update(phase_tp_rows(root))
        counts.update(phase_tp_train(root, train_summary))
        counts.update(phase_hostfed(root))
        # the flagship's own protocols, last
        counts.update(phase_cli_protocols(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    kernels = [k1, *fm, f1b, f2b, tconv]
    for entry in kernels:
        entry["launches_by_path"] = {name: c.get(entry["name"], 0) for name, c in counts.items()}
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
    print(f"[smoke] total {time.perf_counter() - t_start:.1f} s from the start of main",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print_summary(kernels)
    print(json.dumps(ok), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
