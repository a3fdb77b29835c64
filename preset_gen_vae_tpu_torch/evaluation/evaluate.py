"""Post-training evaluation pass.

Counterpart: ``preset_gen_vae_tpu/evaluation/evaluate.py:84-371``
(reference: eval.py:34-284). For a saved run: reload its frozen config,
rebuild the dataset (its corpus pass launches K1 on the card), restore a
checkpoint, run the batched eval-mode forward (under the training's
autocast), compute the per-item parameter metrics, full and on the
MIDI-key-dependent subset, and the latent Spearman matrices of z0 and zK;
re-render the ground-truth and inferred presets, score the audio similarity
on the device, and write the artifacts into the run dir. The re-render
follows ``EvalConfig.audio_render_backend``: ``'jax'`` (the default, as in
the JAX package) renders the ground-truth and inferred presets of a batch
together in one call of ``synth/fm_torch.py`` (on the card kernels F1 and
F2) with ``audio_render_feedback``; ``'cpp'`` renders them apart through the
C++ engine on the host, the ground truth once: with ``cache_gt_audio`` (the
default) it is kept in the corpus cache directory and read back by every
later eval of the same items (``_gt_audio_cached``, evaluate.py:44-81 and
266-273 there). The artifacts:

- ``eval_<split>_summary.json``: the JAX package's keys, each metric's
  ``nanmean`` with ``n_nan_<metric>`` where it has NaNs (spectral
  convergence is NaN for a silent reference), the latent entanglements and
  ``n_items``;
- ``eval_<split>_{z0,zK}_spearman_{r,p}.npy``;
- ``eval_<split>.items.npz``: the per-item table, one array per column of
  the JAX package's ``eval_<split>.dataframe.pickle``. The port writes no
  pickle: the card's machine has no pandas, and the port does not need it.

The rows that cyclically pad the last batch are dropped before any metric,
the latent ones included (the JAX package keeps them in its latent
matrices, evaluate.py:190-191 there). ``evaluate_model`` returns the
per-UID means (the JAX package's ``groupby('preset_UID').mean()``) as a
dict of numpy columns.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import pathlib
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import config as cfg
from .._native import REPO_ROOT
from ..data.pipeline import get_split_loaders
from ..device import resolve_device
from ..logs.logger import get_run_dir, load_checkpoint
from ..logs.metrics import LatentMetric
from ..losses.synth_params import CategoricalParamsAccuracy, QuantizedNumericalParamsLoss
from ..models.build import build_extended_ae_model
from ..ops import tconv_out
from ..synth import dexed_params as dx
from ..synth import fm_torch
from ..synth.render import engine_version
from ..training.loop import prepare_dataset
from ..training.train_step import autocast
from ..utils.profile import Spans
from .similarity import batched_audio_errors

KEYS = ("preset_UID", "midi_pitch", "midi_velocity")
PARAM_METRICS = ("num_eval_loss", "num_mae", "num_mae_dyn", "acc", "acc_dyn")
AUDIO_METRICS = ("spec_mae", "spec_sc", "mfcc13_mae", "mfcc40_mae")
# evaluate_model's phase_seconds: the phases, which cover the pass, then parts of them
PHASES = ("dataset", "model", "inference", "render", "similarity", "artifacts",
          "model.init", "model.load", "artifacts.spearman", "artifacts.write", "artifacts.means")


def items_path(run_dir, split: str) -> pathlib.Path:
    return pathlib.Path(run_dir) / f"eval_{split}.items.npz"


def _gt_audio_cached(dataset, renderer, items: np.ndarray) -> np.ndarray:
    """Ground-truth audio (N, samples) float32 of the eval items, (N, 3)
    rows of (uid, pitch, velocity), from a disk cache (evaluate.py:44-81
    there; reference: eval.py:257-259 reads pre-rendered GT wavs). The key
    is the JAX package's: sha1 of the int64 item table with the engine
    version, sample rate and note durations, so either package serves the
    other's file. The first eval renders through the C++ engine, 256 items
    a call, and writes ``gt_<key>.npy`` through a ``.tmp.npy`` rename; later
    ones map it, bit-equal to a fresh render (the engine is deterministic)."""
    key_src = np.ascontiguousarray(items, dtype=np.int64).tobytes() + (
        f"|v{engine_version()}|fs{renderer.Fs}"
        f"|nd{renderer.note_duration[0]}-{renderer.note_duration[1]}").encode()
    key = hashlib.sha1(key_src).hexdigest()[:16]
    cache_dir = dataset._corpus_cache_dir() / "gt_eval_audio"
    cache_dir.mkdir(parents=True, exist_ok=True)
    path = cache_dir / f"gt_{key}.npy"
    if path.exists():
        return np.load(path, mmap_mode="r")
    out = np.empty((len(items), renderer.samples_per_render), dtype=np.float32)
    for s in range(0, len(items), 256):
        rows = items[s:s + 256]
        presets = np.stack([dataset.get_full_preset_params(int(u)) for u in rows[:, 0]])
        out[s:s + len(rows)] = renderer.render_batch(presets, rows[:, 1], rows[:, 2])
    tmp = path.with_suffix(".tmp.npy")
    np.save(tmp, out)
    tmp.rename(path)
    return out


def evaluate_all_models(eval_config: cfg.EvalConfig, saved_root=REPO_ROOT / "saved",
                        device="cuda", dataset=None, dataset_kwargs: Optional[Dict] = None
                        ) -> List[Dict[str, np.ndarray]]:
    """(reference: eval.py:34-62) Evaluates each run of
    ``eval_config.models_names`` (with its k-fold expansion) that has no
    ``items.npz`` for the split yet, unless ``override_previous_eval``."""
    resolve_device(device)
    out = []
    for base_name in eval_config.models_names:
        names = ([f"{base_name}_kf{k}" for k in range(eval_config.k_folds_count)]
                 if eval_config.k_folds_count > 0 else [base_name])
        for name in names:
            model_name, run_name = name.split("/")
            run_dir = pathlib.Path(saved_root) / model_name / run_name
            if items_path(run_dir, eval_config.dataset).exists() and \
                    not eval_config.override_previous_eval:
                continue
            out.append(evaluate_model_from_dir(run_dir, eval_config, device=device,
                                               dataset=dataset, dataset_kwargs=dataset_kwargs))
    return out


def evaluate_model_from_dir(run_dir, eval_config: cfg.EvalConfig, device="cuda", **kwargs):
    """``evaluate_model`` on the configs frozen in ``run_dir/config.json``;
    ``kwargs`` go to ``evaluate_model``."""
    resolve_device(device)
    model_c, train_c = cfg.load_config(pathlib.Path(run_dir) / "config.json")
    return evaluate_model(model_c, train_c, eval_config, device=device, **kwargs)


def per_uid_means(table: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Per-``preset_UID`` means of every other column, NaNs skipped, UIDs
    ascending, float columns in their dtype and integer ones as float64:
    pandas' ``groupby('preset_UID', as_index=False).mean()``."""
    uids, inv = np.unique(table["preset_UID"], return_inverse=True)
    out = {"preset_UID": uids}
    for k, col in table.items():
        if k == "preset_UID":
            continue
        dtype = col.dtype if np.issubdtype(col.dtype, np.floating) else np.float64
        col = np.asarray(col, dtype=np.float64)
        ok = ~np.isnan(col)
        n = np.bincount(inv, weights=ok, minlength=len(uids))
        s = np.bincount(inv, weights=np.where(ok, col, 0.0), minlength=len(uids))
        with np.errstate(invalid="ignore", divide="ignore"):
            out[k] = (s / n).astype(dtype)
    return out


def evaluate_model(model_config: cfg.ModelConfig, train_config: cfg.TrainConfig,
                   eval_config: cfg.EvalConfig, device="cuda", dataset=None,
                   dataset_kwargs: Optional[Dict] = None, render_audio: bool = True,
                   phase_seconds: Optional[Dict[str, float]] = None,
                   latents: Optional[Dict[str, np.ndarray]] = None) -> Dict[str, np.ndarray]:
    """(reference: eval.py:65-243) Returns the per-UID means as numpy
    columns. ``phase_seconds``, if given, receives the wall seconds of each
    phase, each a span of the pass (``utils/profile.py:Spans``), each
    top-level phase ending in a synchronisation: ``dataset`` (config
    resolution and the split loaders; a corpus pass where no dataset is
    given), ``model`` (build and restore), ``inference``, ``render`` (the
    re-render of each batch), ``similarity`` (the rest of the audio
    scoring) and ``artifacts`` (the files and the per-UID means), which
    cover the pass; and under dotted names, parts of a phase:
    ``model.init`` (``build_extended_ae_model`` and the copy to the
    device), ``model.load`` (``load_checkpoint``, ``load_state_dict`` and
    ``eval()``), ``artifacts.spearman`` (the z0 and zK Spearman matrices),
    ``artifacts.write`` (the npz, npy and json files) and ``artifacts.means``
    (``per_uid_means``). Every key is there, 0.0 where its phase does not
    run (``render`` and ``similarity`` without ``render_audio``; the files
    where the run dir is missing). Beside the seconds, ``tconv_out_launches``
    counts the pass's launches of the decoder's output conv kernel (0 on
    the CPU). ``latents`` receives the ``z0`` and ``zK`` rows (N, dim_z) of
    the evaluated items, in the order of the per-item table."""
    dev = resolve_device(device)
    if eval_config.audio_render_backend not in ("jax", "cpp"):
        raise ValueError(f"audio_render_backend={eval_config.audio_render_backend!r}")
    spans = Spans(dev)
    tconv_out_launches = tconv_out.LAUNCHES["tconv_out"]

    @contextlib.contextmanager
    def phase(name):
        with spans.span(name):
            yield
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    with spans.span("evaluate", id=f"{eval_config.dataset}/{eval_config.epoch}"):
        with phase("dataset"):
            model_c, train_c = cfg.resolve(model_config, train_config)
            model_c, train_c, dataset = prepare_dataset(model_c, train_c, dev, dataset,
                                                        dataset_kwargs)
            helper = dataset.preset_indexes_helper
            loader = get_split_loaders(dataset, train_c)[eval_config.dataset]
        with phase("model"):
            with spans.span("model.init"):
                model = build_extended_ae_model(model_c, train_c, helper).to(dev)
            with spans.span("model.load"):
                model.load_state_dict(
                    load_checkpoint(model_c, eval_config.epoch)["state"]["model"])
                model.eval()

        # ---- batched inference and per-item parameter metrics (eval.py:135-176)
        with phase("inference"):
            dynamic_idx = dx.midi_key_related_param_indexes()
            criteria = {
                "num_eval_loss": QuantizedNumericalParamsLoss(helper, loss="mse"),
                "num_mae": QuantizedNumericalParamsLoss(helper, loss="mae"),
                "num_mae_dyn": QuantizedNumericalParamsLoss(
                    helper, loss="mae", limited_vst_params_indexes=dynamic_idx),
                "acc": CategoricalParamsAccuracy(helper),
                "acc_dyn": CategoricalParamsAccuracy(helper,
                                                     limited_vst_params_indexes=dynamic_idx),
            }
            cols = {k: [] for k in KEYS + PARAM_METRICS + ("z0", "zK", "v_out")}
            bs = loader.batch_size
            with torch.no_grad():
                for i, sel in enumerate(loader.epoch_index_batches(0)):
                    n_real = min(bs, loader.n_items - i * bs)  # the rest pads the last batch
                    x, v, info = loader.gather(sel[:n_real])
                    with autocast(dev, train_c):
                        outs = model.forward_full(x, info)
                    v_out = outs[5].float()
                    cols["z0"].append(outs[0][:, 0, :].float())
                    cols["zK"].append(outs[2].float())
                    cols["v_out"].append(v_out)
                    for j, k in enumerate(KEYS):
                        cols[k].append(info[:, j])
                    for k, crit in criteria.items():
                        cols[k].append(crit.per_item(v_out, v))
            cols = {k: torch.cat(c).cpu().numpy() for k, c in cols.items()}  # one fetch
            lat = {}
            for name in ("z0", "zK"):
                lat[name] = LatentMetric(model_c.dim_z)
                lat[name].append(cols[name], cols[name])
            table = {k: cols[k] for k in KEYS + PARAM_METRICS}
            if latents is not None:
                latents.update(z0=cols["z0"], zK=cols["zK"])

        if render_audio:  # ---- re-render and score the audio (eval.py:211-323)
            with spans.span("similarity"):
                inferred = helper.learnable_to_full_batch(cols["v_out"])
                pitch, vel = table["midi_pitch"], table["midi_velocity"]
                errs = {k: [] for k in AUDIO_METRICS}
                B = eval_config.audio_batch_size
            gt_cache = None
            if eval_config.audio_render_backend == "cpp" and eval_config.cache_gt_audio:
                with spans.span("render"):
                    gt_cache = _gt_audio_cached(dataset, dataset.renderer,
                                                np.stack([table[k] for k in KEYS], axis=1))
            for s in range(0, len(inferred), B):
                with spans.span("render"):
                    gt = np.stack([dataset.get_full_preset_params(u)
                                   for u in table["preset_UID"][s:s + B]])
                    gt, est = render_pairs(dataset, eval_config, gt, inferred[s:s + B],
                                           pitch[s:s + B], vel[s:s + B], dev,
                                           gt_audio=None if gt_cache is None
                                           else np.array(gt_cache[s:s + B]))
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
                with spans.span("similarity"):
                    e = batched_audio_errors(gt, est, model_c.stft_args[0], model_c.stft_args[1],
                                             model_c.sampling_rate)
                    for k in AUDIO_METRICS:
                        errs[k].append(e[k])
            with phase("similarity"):
                for k in AUDIO_METRICS:
                    table[k] = torch.cat(errs[k]).cpu().numpy()

        # ---- artifacts (eval.py:331-366)
        with phase("artifacts"):
            run_dir = get_run_dir(model_c)
            if run_dir.exists():
                split = eval_config.dataset
                with spans.span("artifacts.spearman"):  # computed once, kept by the metric
                    entanglement = {name: lat[name].get() for name in ("z0", "zK")}
                with spans.span("artifacts.write"):
                    np.savez(items_path(run_dir, split), **table)
                    for name in ("z0", "zK"):
                        np.save(run_dir / f"eval_{split}_{name}_spearman_r.npy",
                                lat[name].get_spearman_corr())
                        np.save(run_dir / f"eval_{split}_{name}_spearman_p.npy",
                                lat[name].get_spearman_pvalues())
                    metric_cols = [k for k in table if k not in KEYS]
                    summary = {k: float(np.nanmean(table[k])) for k in metric_cols}
                    summary.update({f"n_nan_{k}": int(np.isnan(table[k]).sum())
                                    for k in metric_cols if np.isnan(table[k]).any()})
                    summary.update(latent_entanglement_z0=entanglement["z0"],
                                   latent_entanglement_zK=entanglement["zK"],
                                   n_items=len(table["preset_UID"]))
                    with open(run_dir / f"eval_{split}_summary.json", "w") as f:
                        json.dump(summary, f, indent=2)
            with spans.span("artifacts.means"):
                means = per_uid_means(table)
    if phase_seconds is not None:
        totals = spans.totals()
        phase_seconds.update({k: totals[k]["s"] if k in totals else 0.0 for k in PHASES})
        phase_seconds["tconv_out_launches"] = tconv_out.LAUNCHES["tconv_out"] - tconv_out_launches
    return means


def render_pairs(dataset, eval_config: cfg.EvalConfig, gt_presets: np.ndarray,
                 inferred: np.ndarray, pitches, velocities, dev: torch.device,
                 gt_audio: Optional[np.ndarray] = None):
    """(ground-truth, inferred) audio of one batch, each (n, N) float32 on
    ``dev``. ``'jax'``: one ``fm_torch.render_batch`` call on the two sets
    stacked (evaluate.py:294-304 there), so both go through one engine;
    ``'cpp'``: two calls of the C++ engine on the host, or one for the
    inferred presets where ``gt_audio`` (the cached ground truth) is given."""
    renderer = dataset.renderer
    if eval_config.audio_render_backend == "cpp":
        gt = (renderer.render_batch(gt_presets, pitches, velocities) if gt_audio is None
              else gt_audio)
        est = renderer.render_batch(inferred, pitches, velocities)
        return torch.from_numpy(gt).to(dev), torch.from_numpy(est).to(dev)
    n = len(gt_presets)
    both = fm_torch.render_batch(
        torch.from_numpy(np.concatenate([gt_presets, inferred]).astype(np.float32)).to(dev),
        np.concatenate([pitches, pitches]), np.concatenate([velocities, velocities]),
        note_on_s=float(renderer.note_duration[0]), total_s=float(renderer.total_seconds),
        sample_rate=renderer.Fs, feedback=eval_config.audio_render_feedback)
    return both[:n], both[n:]
