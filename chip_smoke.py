"""Smoke run of the PyTorch/CUDA port on one GPU.

Builds every hand-written kernel of the port from the sources in this
checkout, holds each against its plain PyTorch version on the card (K1 on
noise and on rendered DX7 notes, there also against a float64 rFFT
witness), times it beside its bound, its plain version and one library
call, then drives the port's main path through its user entry points with
the flagship FlVAE2 at full width (257x347 log-mels, dim_z 610, batch 160)
on a seeded synthetic 1,024-preset corpus, in three paths, each with its
own corpus pass: ``training.loop.train_config`` trains 2 epochs with the
plateau scheduler and checkpoints; a second call resumes from the
checkpoint for a third epoch; ``evaluation.evaluate.evaluate_model_from_dir``
scores the 164 validation items (inference, DX7 re-render, similarity
metrics on the card) and writes the artifacts. Then the saved runs'
other configurations (``saved/FlVAE2/<run>/config.json``, C++ render
backend), each through the same two entry points at full width: the
repo's best run, 3 stacked notes (``r5stack3_v2_20480``, train and eval),
the 6-note un-stacked run with MIDI in z0 (``r5multi6_v2_12288``, train
and eval), FlowParamsLoss (``r2flowloss_train``), the MLP head
(``r2mlp400``, train and eval) and BasicVAE with a MAF head. Each path
prints its wall time, model build time, steady step and peak memory. Runs
live in a temporary directory that is removed at the end.

Run from the repository root with one GPU:

    python3 chip_smoke.py

It prints the card's name and power limit, one line per phase, the
kernels' JSON line, and as its last line
``{"ok": true, "device": {...}}``. Any failed phase ends the run with a
non-zero exit code; without a GPU it fails before printing any result.
"""

from __future__ import annotations

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


def build_report(sp) -> str:
    """ptxas' register, spill and shared-memory lines for K1, and the blocks
    that fit on one SM for each launch configuration of the main path."""
    from preset_gen_vae_tpu_torch import _native

    so = _native.build_shared_library("logmel", sp.logmel_build_command(), [sp.LOGMEL_SOURCE])
    lines = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    lib = sp._logmel_library()
    occ = {f"{name} blocks/SM": lib.logmel_blocks_per_sm(256, n_mels, n_weights, fast)
           for name, n_mels, n_weights, fast in (("exact mel", 257, 1016, 0),
                                                 ("exact linear", 0, 0, 0),
                                                 ("fast mel", 257, 1016, 1))}
    return "\n".join(lines) + f"\n{occ}"


def phase_kernels():
    """K1 against its plain version at the corpus pass's shapes, on noise
    and on rendered notes; K1, plain and the library call timed."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's matmuls in full f32
    rng = np.random.default_rng(0)
    t0 = time.time()
    sp._logmel_library()  # builds csrc/logmel.cu with nvcc
    print(f"[build] logmel kernel built in {time.time() - t0:.1f} s\n{build_report(sp)}",
          flush=True)

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


CORPUS = {"n_synthetic_presets": 1024}  # the main path's synthetic corpus


def drive(name: str, fn):
    """Runs one path of the main path with the launch counts set to 0 just
    before it and read just after; fails unless K1 launched. -> (result,
    launches, wall seconds, peak device GiB)."""
    from preset_gen_vae_tpu_torch.ops import spectrogram as sp

    for k in sp.LAUNCHES:
        sp.LAUNCHES[k] = 0
    gc.collect()  # the previous path's tensors must not count in this one's peak
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(sp.LAUNCHES)
    if launches["logmel"] < 1:
        raise AssertionError(f"K1 was not launched on the {name} path: {launches}")
    return result, launches, wall, torch.cuda.max_memory_allocated() / 2**30


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
    train 2 epochs, resume for a third, evaluate the validation split."""
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
        model_c, train_c, dataset_kwargs=CORPUS, device="cuda", use_tensorboard=False))
    check_train_summary("train", summary, 2)
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
        model_c, resume_c, dataset_kwargs=CORPUS, device="cuda", use_tensorboard=False))
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
    _, counts["eval"], wall, mem = drive("eval", lambda: evaluate_model_from_dir(
        summary["run_dir"], cfg.EvalConfig(dataset="validation"), dataset_kwargs=CORPUS,
        phase_seconds=phases))
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
    print(f"[eval path] wall {wall:.2f} s, K1 launches {counts['eval']['logmel']}, 164 items "
          f"(2 batches), seconds per phase {json.dumps(phases)}, peak device memory "
          f"{mem:.2f} GiB", flush=True)
    return counts


SAVED_RUNS = pathlib.Path(__file__).resolve().parent / "saved" / "FlVAE2"
VARIANT_CORPUS = {"n_synthetic_presets": 512}  # the variant paths' cut corpus


def saved_run_configs(run: str, root: str, model_kw=None, **train_kw):
    """A saved run's frozen configs, retargeted: C++ render backend, runs
    under ``root``, ``train_kw`` (epochs, verbosity) over its TrainConfig;
    its widths, notes, flows, heads and losses stay."""
    from preset_gen_vae_tpu_torch import config as cfg

    model_c, train_c = cfg.load_config(SAVED_RUNS / run / "config.json")
    model_c = dataclasses.replace(model_c, **{
        "logs_root_dir": root, "run_name": f"smoke_{run}", "allow_erase_run": True,
        "dataset_corpus_render_backend": "cpp", "dataset_corpus_cache_policy": "disk",
        **(model_kw or {})})
    return model_c, dataclasses.replace(train_c, start_epoch=0, verbosity=0, **train_kw)


def variant_train(counts, name, model_c, train_c, corpus, epochs, dim_z):
    """One train path: K1 launched once per 64 presets and note, the input
    shape (B, stacked notes, 257, 347), finite metrics; timings printed."""
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK
    from preset_gen_vae_tpu_torch.training.loop import train_config

    summary, counts[name], wall, mem = drive(name, lambda: train_config(
        model_c, train_c, dataset_kwargs=corpus, device="cuda", use_tensorboard=False))
    n_notes = len(model_c.midi_notes)
    channels = n_notes if model_c.stack_spectrograms else 1
    check_train_summary(name, summary, epochs, (train_c.minibatch_size, channels, 257, 347),
                        dim_z)
    k1 = n_notes * -(-corpus["n_synthetic_presets"] // CORPUS_CHUNK)
    if counts[name]["logmel"] != k1:
        raise AssertionError(f"{name}: {counts[name]['logmel']} K1 launches, want {k1}")
    print(f"[{name} path] wall {wall:.2f} s, model build {summary['model_build_seconds']:.2f} s, "
          f"K1 launches {counts[name]['logmel']}, {summary['train_steps']} steps, steady step "
          f"{summary['step_ms']:.2f} ms (first {summary['first_step_ms']:.1f} ms), corpus pass "
          f"{summary['corpus_seconds']:.3f} s (render {summary['corpus_render_seconds']:.3f} s), "
          f"{summary['n_params']} parameters, input {summary['input_size']}, peak device memory "
          f"{mem:.2f} GiB", flush=True)
    return summary


def variant_eval(counts, name, model_c, run_dir, corpus, latents=None):
    """One eval path on the run's last checkpoint: the validation items
    (one per preset, or per preset and note when the notes are not
    stacked) inferred, re-rendered and scored, every metric finite."""
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.data.dexed_dataset import CORPUS_CHUNK
    from preset_gen_vae_tpu_torch.data.sampler import split_preset_indexes
    from preset_gen_vae_tpu_torch.evaluation.evaluate import evaluate_model_from_dir

    phases = {}
    _, counts[name], wall, mem = drive(name, lambda: evaluate_model_from_dir(
        run_dir, cfg.EvalConfig(dataset="validation"), dataset_kwargs=corpus,
        phase_seconds=phases, latents=latents))
    with open(f"{run_dir}/eval_validation_summary.json") as f:
        ev = json.load(f)
    items = np.load(f"{run_dir}/eval_validation.items.npz")
    P, n_notes = corpus["n_synthetic_presets"], len(model_c.midi_notes)
    n_items = len(split_preset_indexes(P)["validation"]) * (
        1 if model_c.stack_spectrograms else n_notes)
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
          f"K1 launches {counts[name]['logmel']}, {n_items} items, seconds per phase "
          f"{json.dumps(phases)}, peak device memory {mem:.2f} GiB", flush=True)
    return items


def phase_variant_paths(root: str):
    """The saved runs' other configurations through the same entry points.
    At 1,024 presets: stack3 48 K1 launches a pass, 164 eval items; multi6
    96 launches, 24 steps, 984 eval items; at 512 presets 8 launches."""
    from preset_gen_vae_tpu_torch.data.sampler import split_preset_indexes

    counts = {}
    # ---- the repo's best run: 3 stacked notes, full width, 2 epochs
    model_c, train_c = saved_run_configs("r5stack3_v2_20480", root, n_epochs=2)
    summary = variant_train(counts, "stack3 train", model_c, train_c, CORPUS, 2, 610)
    variant_eval(counts, "stack3 eval", model_c, summary["run_dir"], CORPUS)

    # ---- 6 un-stacked notes, MIDI in z0, 1800-channel mixers, 1 epoch
    model_c, train_c = saved_run_configs("r5multi6_v2_12288", root, n_epochs=1)
    summary = variant_train(counts, "multi6 train", model_c, train_c, CORPUS, 1, 610)
    n_train = len(split_preset_indexes(CORPUS["n_synthetic_presets"])["train"]) * 6
    if summary["train_steps"] != n_train // train_c.minibatch_size:
        raise AssertionError(f"multi6: {summary['train_steps']} steps for {n_train} items")
    latents = {}
    items = variant_eval(counts, "multi6 eval", model_c, summary["run_dir"], CORPUS, latents)
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

    # ---- BasicVAE (Dkl latent loss) with a MAF head, forward direction only
    model_c, train_c = saved_run_configs(
        "r2flowloss_train", root, dict(run_name="smoke_basic_maf", latent_flow_arch=None,
                                       params_regression_architecture="flow_maf_6l300",
                                       forward_controls_loss=True), n_epochs=1)
    summary = variant_train(counts, "basic_maf train", model_c, train_c, VARIANT_CORPUS, 1, 610)
    print(f"[basic_maf train path] LatLoss (Dkl) {summary['LatLoss/Train']} (train), "
          f"{summary['LatLoss/Valid']} (valid)", flush=True)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    k1 = phase_kernels()
    root = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    try:
        counts = phase_main_path(root)
        counts.update(phase_variant_paths(root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    k1["launches_by_path"] = {name: c["logmel"] for name, c in counts.items()}
    k1["launches"] = sum(k1["launches_by_path"].values())
    print(json.dumps({"kernels": [k1]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
