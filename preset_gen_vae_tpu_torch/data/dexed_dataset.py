"""Dexed dataset: the preset corpus (a SQLite database or the seeded
synthetic generators), its constraints, the DX7 renders and the normalised
log-mel corpus resident on the device, with the JAX package's disk cache.

Counterparts: ``preset_gen_vae_tpu/data/dexed_dataset.py:32-337`` and the
parts of ``data/abstract_dataset.py`` it needs (:31-36, 42-74, 111-154,
272-378, 380-556, 572-631); ``model_config_to_dataset_kwargs`` is
``data/build.py:18-41``.

The corpus is rendered on one of two backends:

- ``'cpp'``: the presets are rendered in chunks of 64 by the C++ engine on
  the host; each chunk of waveforms goes to the device and through kernel
  K1 (``SpectrogramProcessor``; on the CPU its plain version); the raw
  corpus is float32 on the device, and its min, max, mean and std are
  reduced there (abstract_dataset.py:272-281);
- ``'jax'``: the on-device FM render of ``synth/fm_torch.py`` (on the card
  kernels F1 and F2) renders a whole note of up to ``RENDER_ROWS`` presets
  per launch, straight into the (rows, N) buffer K1 reads; K1 turns each
  64 rows into log-mels, stored once in float16; min, max, sum and sum of
  squares accumulate in f32 on the device over the real rows and the host
  combines them in f64, as the JAX package's device-resident pass does
  (abstract_dataset.py:380-546). The JAX package's column-chunked layout
  (``data/corpus_device.py``) works around a TPU compiler limit and is not
  ported.

``corpus_cache_policy`` decides where the corpus comes from:

- ``'disk'`` (abstract_dataset.py:331-378): the cache directory
  ``<data_root>/dexed/<tag>`` serves ``specs_norm_f16.npy`` with
  ``spec_stats.json`` when both exist, else normalises ``specs_raw.npy``,
  else renders and writes the raw tier (float32 under ``'cpp'``, float16
  under ``'jax'``), the stats and the float16 normalised tier. The tag, the
  directory, the files and the ``render_constraints.json`` sidecar are the
  JAX package's, so a cache written by either package is served by the
  other, bit for bit. A reload uploads the float16 tier 64 presets at a
  time and casts on the device: the host never holds a float32 copy of the
  whole corpus;
- ``'device'`` (``'jax'`` only): rendered, normalised and kept on the
  device; nothing is written.

The normalisation runs in the raw tier's dtype, as numpy runs it on the
JAX package's raw tier: float32 arithmetic under ``'cpp'``, float16
arithmetic under ``'jax'`` (NEP 50 keeps numpy's ``(raw - min) / c`` in
float16, op for op; see abstract_dataset.py:521-528). The served values
are rounded through float16, the disk tier's dtype, then become the
corpus dtype; under ``'jax'`` a two-byte corpus dtype takes the raw
buffer's place.

``corpus_on_device=False`` (the loop's ``dataset_cache_device=False``)
keeps the corpus off the device, for a corpus larger than the device's
memory: the pass computes where it computes otherwise (K1, and F1/F2
under ``'jax'``, on the card, 64 presets at a time), but the raw corpus
goes to the host chunk by chunk (under ``'disk'`` straight into its tier
file, so that neither the device nor the host holds it whole), the
statistics and the normalisation take it back to the device a chunk at a
time, and the served corpus lives in pinned host memory; a warm
``'disk'`` reload reads the float16 tier straight into it and casts on
the host. The device then holds a chunk of the pass at a time, and the
pass gives the resident one's tiers, statistics and corpus bit for
bit. ``x``, ``v`` and ``info`` are all host tensors then,
which the loaders feed to the card batch by batch (``data/pipeline.py``).

``corpus_tensors`` serves the corpus in the two multi-note layouts of
abstract_dataset.py:609-631: stacked, one item per preset with its notes as
channels, or un-stacked, one item per (preset, note), as a view of the same
buffer.
"""

from __future__ import annotations

import contextlib
import csv
import hashlib
import json
import math
import os
import pathlib
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .._native import REPO_ROOT
from ..ops.spectrogram import SpectrogramConfig, SpectrogramProcessor
from ..synth import database as db
from ..synth import dexed_params as dx
from ..synth import fm_torch
from ..synth.render import DexedRenderer, engine_version
from ..utils.audio_io import write_wav
from .dexed_spec import build_dexed_preset_spec
from .preset import PresetIndexesHelper

CORPUS_CHUNK = 64  # presets per K1 launch, C++ render, normalisation step and disk copy
# presets of one note rendered per F1/F2 launch on the 'jax' backend: 8,192
# rows of 4 s audio are 2.9 GB of f32
RENDER_ROWS = 8192
SYNTHETIC_STYLES = {
    "structured": db.generate_structured_corpus,
    "structured2": db.generate_structured_corpus_v2,
    "uniform": db.generate_random_corpus,
}
NORMALIZATIONS = ("min_max", "mean_std", None)


def default_data_root() -> pathlib.Path:
    """Where the corpus caches live (abstract_dataset.py:31-36 there):
    ``$PGV_TPU_DATA_DIR``, the JAX package's variable, else ``data_cache/``
    at the repository root."""
    return pathlib.Path(os.environ.get("PGV_TPU_DATA_DIR", REPO_ROOT / "data_cache"))


def model_config_to_dataset_kwargs(model_config) -> Dict:
    """(data/build.py:18-41; reference: data/dataset.py:18-25)"""
    return dict(
        note_duration=model_config.note_duration,
        n_fft=model_config.stft_args[0],
        fft_hop=model_config.stft_args[1],
        midi_notes=model_config.midi_notes,
        multichannel_stacked_spectrograms=model_config.stack_spectrograms,
        n_mel_bins=model_config.mel_bins,
        spectrogram_min_dB=model_config.spectrogram_min_dB,
        algos=model_config.dataset_synth_args[0],
        operators=model_config.dataset_synth_args[1],
        vst_params_learned_as_categorical=model_config.synth_vst_params_learned_as_categorical,
        restrict_to_labels=model_config.dataset_labels,
        sample_rate=model_config.sampling_rate,
        corpus_render_backend=model_config.dataset_corpus_render_backend,
        corpus_cache_policy=model_config.dataset_corpus_cache_policy,
    )


@contextlib.contextmanager
def _tier_file(path: pathlib.Path, shape, dtype):
    """A ``.npy`` file mapped for writing, filled by the block and renamed
    from ``.tmp.npy`` to ``path`` once the block is done."""
    tmp = path.with_name(path.stem + ".tmp.npy")
    out = np.lib.format.open_memmap(tmp, mode="w+", dtype=dtype, shape=tuple(shape))
    yield out
    out.flush()
    del out
    os.replace(tmp, path)


def _save_tier(path: pathlib.Path, tensor: torch.Tensor) -> None:
    """Writes a device tensor as a ``.npy`` file 64 presets at a time."""
    dtype = np.float16 if tensor.dtype == torch.float16 else np.float32
    with _tier_file(path, tensor.shape, dtype) as out:
        for s in range(0, tensor.shape[0], CORPUS_CHUNK):
            out[s:s + CORPUS_CHUNK] = tensor[s:s + CORPUS_CHUNK].cpu().numpy()


class DexedDataset:
    def __init__(
        self,
        note_duration=(3.0, 1.0),
        n_fft: int = 1024,
        fft_hop: int = 256,
        midi_notes=((60, 85),),
        multichannel_stacked_spectrograms: bool = False,
        n_mel_bins: int = 257,
        spectrogram_min_dB: float = -120.0,
        spectrogram_normalization: Optional[str] = "min_max",
        algos: Optional[Sequence[int]] = None,
        operators: Optional[Sequence[int]] = None,
        vst_params_learned_as_categorical: Optional[str] = "all<=32",
        restrict_to_labels: Optional[Sequence[str]] = None,
        constant_filter_and_tune_params: bool = True,
        prevent_SH_LFO: bool = True,
        sample_rate: int = 22050,
        db_path=None,
        n_synthetic_presets: int = 4096,
        synthetic_seed: int = 0,
        synthetic_style: str = "structured",
        data_root=None,
        corpus_render_backend: str = "cpp",
        corpus_render_feedback: str = "exact",
        corpus_cache_policy: str = "disk",
        device="cuda",
        corpus_dtype: torch.dtype = torch.float32,
        corpus_on_device: bool = True,
    ):
        if spectrogram_normalization not in NORMALIZATIONS:
            raise ValueError(f"spectrogram_normalization={spectrogram_normalization!r}")
        # (dexed_dataset.py:85-100 there)
        if corpus_render_backend not in ("cpp", "jax"):
            raise ValueError(f"corpus_render_backend={corpus_render_backend!r}")
        if corpus_cache_policy not in ("disk", "device"):
            raise ValueError(f"corpus_cache_policy={corpus_cache_policy!r}")
        if corpus_cache_policy == "device" and corpus_render_backend != "jax":
            raise ValueError("corpus_cache_policy='device' requires corpus_render_backend='jax'")
        if corpus_render_feedback not in ("exact", "unrolled"):
            raise ValueError(f"corpus_render_feedback={corpus_render_feedback!r}")
        if db_path is None and synthetic_style not in SYNTHETIC_STYLES:
            raise ValueError(f"synthetic_style={synthetic_style!r}")
        self.corpus_render_backend = corpus_render_backend
        self.corpus_render_feedback = corpus_render_feedback
        self.corpus_cache_policy = corpus_cache_policy
        self.note_duration = tuple(note_duration)
        self.midi_notes = tuple(tuple(n) for n in midi_notes)
        # (abstract_dataset.py:57)
        self._stacked = multichannel_stacked_spectrograms and len(self.midi_notes) > 1
        self.n_mel_bins = n_mel_bins
        self.spectrogram_normalization = spectrogram_normalization
        self.sample_rate = int(sample_rate)
        self.data_root = pathlib.Path(data_root) if data_root else default_data_root()
        self.device = torch.device(device)
        self.corpus_dtype = corpus_dtype
        self.corpus_on_device = bool(corpus_on_device)
        self.spectrogram = SpectrogramProcessor(
            SpectrogramConfig(n_fft=n_fft, fft_hop=fft_hop, min_dB=spectrogram_min_dB,
                              n_mel_bins=n_mel_bins, sample_rate=sample_rate),
            device=self.device)
        self.algos = tuple(algos) if algos else None
        self.operators = tuple(operators) if operators is not None else (1, 2, 3, 4, 5, 6)
        self.restrict_to_labels = tuple(restrict_to_labels) if restrict_to_labels else None
        # both flags change the rendered audio and key the caches (dexed_dataset.py:101-104)
        self._constant_filter_and_tune = bool(constant_filter_and_tune_params)
        self._prevent_sh_lfo = bool(prevent_SH_LFO)
        self._synthetic = db_path is None
        self._synthetic_args = (n_synthetic_presets, synthetic_seed, synthetic_style)

        # ---- corpus (dexed_dataset.py:106-121) and constraints (:123-141)
        if db_path is not None:
            database = db.PresetDatabase(db_path)
            presets = database.presets_matrix.copy()
            names, labels = database.names, database.labels
            param_names = database.param_names
        else:
            presets, names, labels = SYNTHETIC_STYLES[synthetic_style](
                n_synthetic_presets, seed=synthetic_seed, algos=self.algos)
            param_names = [f"dexed_param_{i}" for i in range(dx.N_PARAMS)]
        if constant_filter_and_tune_params:
            dx.set_default_general_filter_and_tune_params(presets)
        dx.set_operators(presets, self.operators)
        if prevent_SH_LFO:
            dx.prevent_SH_LFO(presets)
        keep = np.ones((presets.shape[0],), dtype=bool)
        if self.algos:
            algo_of = np.rint(presets[:, dx.IDX_ALGORITHM] * 31.0).astype(int) + 1
            keep &= np.isin(algo_of, np.asarray(self.algos))
        if self.restrict_to_labels:
            keep &= np.asarray([any(l in s for l in self.restrict_to_labels) for s in labels])
        self.presets = presets[keep]
        self.names = [n for n, k in zip(names, keep) if k]
        self.labels = [l for l, k in zip(labels, keep) if k]
        self.uids = np.nonzero(keep)[0].astype(np.int64)
        self._uid_to_row = {int(u): i for i, u in enumerate(self.uids)}

        # ---- learnable model spec (dexed_dataset.py:143-151)
        spec = build_dexed_preset_spec(
            algos=self.algos, operators=self.operators,
            vst_params_learned_as_categorical=vst_params_learned_as_categorical,
            constant_filter_and_tune_params=constant_filter_and_tune_params,
            param_names=param_names)
        self._spec = spec
        self.preset_indexes_helper = PresetIndexesHelper(spec)
        self.renderer = DexedRenderer(sample_rate=sample_rate, note_duration=note_duration)
        self.spec_stats: Optional[Dict[str, float]] = None
        self.corpus_seconds: Optional[float] = None  # the whole corpus pass
        self.render_seconds: Optional[float] = None  # its renders
        self._corpus: Optional[torch.Tensor] = None
        if corpus_cache_policy == "disk":  # 'device' writes nothing
            self._check_render_constraints()

    # ------------------------------------------------------------------
    @property
    def valid_presets_count(self) -> int:
        return len(self.uids)

    @property
    def midi_notes_per_preset(self) -> int:
        return len(self.midi_notes)

    @property
    def multichannel_stacked_spectrograms(self) -> bool:
        return self._stacked

    @property
    def learnable_params_count(self) -> int:
        return sum(m is not None for m in self._spec.learnable_model)

    @property
    def learnable_params_tensor_length(self) -> int:
        return self.preset_indexes_helper.learnable_preset_size

    def get_full_preset_params(self, preset_UID: int) -> np.ndarray:
        """The full 155-parameter preset of one UID (dexed_dataset.py:184)."""
        return self.presets[self._uid_to_row[int(preset_UID)]]

    def get_name_from_preset_UID(self, preset_UID: int) -> str:
        """(dexed_dataset.py:187-188)"""
        return self.names[self._uid_to_row[int(preset_UID)]]

    def get_labels_tensor(self, preset_UID: int) -> np.ndarray:
        """The preset's labels as an int8 0/1 vector over ``LABELS_VOCAB``
        (dexed_dataset.py:190-192)."""
        s = self.labels[self._uid_to_row[int(preset_UID)]]
        return np.asarray([1 if v in s else 0 for v in db.LABELS_VOCAB], dtype=np.int8)

    def get_spectrogram_tensor_size(self):
        H = self.n_mel_bins if self.n_mel_bins > 0 else self.spectrogram.n_fft // 2 + 1
        T = 1 + self.renderer.samples_per_render // self.spectrogram.hop
        return (self.midi_notes_per_preset if self._stacked else 1, H, T)

    # ------------------------------------------------------------------ cache
    def _corpus_cache_dir(self) -> pathlib.Path:
        """``<data_root>/dexed/<tag>``, made if missing (abstract_dataset.py:143-146)."""
        d = self.data_root / "dexed" / self._corpus_tag()
        d.mkdir(parents=True, exist_ok=True)
        return d

    def _corpus_tag(self) -> str:
        """The cache's name: abstract_dataset.py:148-154 refined by
        dexed_dataset.py:261-290 there."""
        notes = "-".join(f"{p}.{v}" for p, v in self.midi_notes)
        base = (f"sr{self.sample_rate}_nd{self.note_duration[0]}-{self.note_duration[1]}"
                f"_mel{self.n_mel_bins}_n{self.valid_presets_count}_notes{notes}")
        al = ".".join(str(a) for a in self.algos) if self.algos else "all"
        op = "".join(str(o) for o in self.operators)
        lab = "_".join(l[:4] for l in self.restrict_to_labels) if self.restrict_to_labels else "all"
        # the legacy styles keep their 2-character tag; newer ones their full name
        style_tag = {"structured": "st", "uniform": "un"}.get(self._synthetic_args[2],
                                                              self._synthetic_args[2])
        syn = (f"syn{self._synthetic_args[0]}s{self._synthetic_args[1]}{style_tag}"
               if self._synthetic else f"db{self._corpus_content_hash()}")
        flags = ("cft" if self._constant_filter_and_tune else "nocft") + (
            "_nosh" if self._prevent_sh_lfo else "_sh")
        if self.corpus_render_backend != "cpp":  # 'cpp' keeps the historical tag
            flags += f"_rb{self.corpus_render_backend}"
        return f"{base}_al{al}_op{op}_lab{lab}_{syn}_{flags}"

    def _corpus_content_hash(self) -> str:
        """sha1 of the constrained float32 presets, 10 hex digits
        (dexed_dataset.py:292-300): two databases of one size do not collide."""
        return hashlib.sha1(
            np.ascontiguousarray(self.presets, dtype=np.float32).tobytes()).hexdigest()[:10]

    def _check_render_constraints(self):
        """The ``render_constraints.json`` sidecar (dexed_dataset.py:302-337;
        reference: dexeddataset.py:313-328): written on first use, and a
        cache made under other constraints raises."""
        d = self._corpus_cache_dir()
        path = d / "render_constraints.json"
        current = {
            "engine_version": engine_version(),
            "note_duration": list(self.note_duration),
            "sample_rate": self.sample_rate,
            "operators": list(self.operators),
            "algos": list(self.algos) if self.algos else None,
            "constant_filter_and_tune_params": self._constant_filter_and_tune,
            "prevent_SH_LFO": self._prevent_sh_lfo,
        }
        if self.corpus_render_backend != "cpp":  # 'cpp' stays keyless
            current["render_backend"] = self.corpus_render_backend
            current["render_feedback"] = self.corpus_render_feedback
            # the raw tier is f16 with the device's exact f32 stats
            current["raw_tier"] = "f16+devstats"
        if path.exists():
            with open(path) as f:
                stored = json.load(f)
            if stored != current:
                raise RuntimeError(
                    f"Cached renders at {d} were produced under different "
                    f"constraints ({stored} != {current}); delete the cache "
                    "directory to re-render.")
        else:
            with open(path, "w") as f:
                json.dump(current, f)

    # ------------------------------------------------------------------ corpus
    def _served(self, shape) -> torch.Tensor:
        """An empty served corpus: on the device, or in pinned host memory
        (pageable on a machine without a card) with ``corpus_on_device=False``."""
        if self.corpus_on_device:
            return torch.empty(shape, dtype=self.corpus_dtype, device=self.device)
        return torch.empty(shape, dtype=self.corpus_dtype, pin_memory=self.device.type == "cuda")

    def _raw_shape(self):
        """(P, n_notes, H, W) of the raw corpus."""
        _, H, W = self.get_spectrogram_tensor_size()
        return len(self.uids), len(self.midi_notes), H, W

    def _raw_buffer(self, dtype: torch.dtype) -> torch.Tensor:
        """An empty raw corpus: on the device, or on the host with
        ``corpus_on_device=False``."""
        device = self.device if self.corpus_on_device else torch.device("cpu")
        return torch.empty(self._raw_shape(), dtype=dtype, device=device)

    def _raw_dtype(self) -> torch.dtype:
        return torch.float16 if self.corpus_render_backend == "jax" else torch.float32

    def _chunk(self, raw, s: int) -> torch.Tensor:
        """Presets ``s:s+64`` of a raw corpus (a tensor, or a tier mapped
        from disk) on the device."""
        x = raw[s:s + CORPUS_CHUNK]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.array(x))
        return x.to(self.device)

    def _placed(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (a small host tensor) where the corpus is served from: on
        the device, or in pinned host memory."""
        if self.corpus_on_device:
            return t.to(self.device)
        return t.pin_memory() if self.device.type == "cuda" else t

    def load_corpus(self, force_recompute: bool = False) -> torch.Tensor:
        """The normalised corpus (P, n_notes, H, W) on the device (on the host
        with ``corpus_on_device=False``), built once;
        ``force_recompute`` renders it again, past the memo and the disk tiers."""
        if self._corpus is not None and not force_recompute:
            return self._corpus
        self._corpus = None
        t0, self.render_seconds = time.perf_counter(), 0.0
        if self.corpus_cache_policy == "device":
            self._corpus = self._normalized(self._render_raw())
        else:
            self._corpus = self._disk_corpus(force_recompute)
        self._sync()
        self.corpus_seconds = time.perf_counter() - t0
        return self._corpus

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _disk_corpus(self, force_recompute: bool) -> torch.Tensor:
        """The two cache tiers (abstract_dataset.py:331-378)."""
        d = self._corpus_cache_dir()
        raw_path, norm_path = d / "specs_raw.npy", d / "specs_norm_f16.npy"
        stats_path = d / "spec_stats.json"
        if norm_path.exists() and stats_path.exists() and not force_recompute:
            with open(stats_path) as f:
                self.spec_stats = json.load(f)
            return self._upload(np.load(norm_path, mmap_mode="r"))
        if raw_path.exists() and stats_path.exists() and not force_recompute:
            raw = np.load(raw_path, mmap_mode="r")
            with open(stats_path) as f:
                self.spec_stats = json.load(f)
        else:
            if self.corpus_on_device:
                raw = self._render_raw()
                _save_tier(raw_path, raw)
            else:  # straight into its tier: held whole neither on the host nor on the device
                dtype = np.float16 if self._raw_dtype() == torch.float16 else np.float32
                with _tier_file(raw_path, self._raw_shape(), dtype) as tier:
                    self._render_raw(tier)
                raw = np.load(raw_path, mmap_mode="r")
            with open(stats_path, "w") as f:
                json.dump(self.spec_stats, f)
        return self._normalized(raw, norm_path)

    def _upload(self, tier: np.ndarray) -> torch.Tensor:
        """A float16 tier mapped from disk, 64 presets at a time to the
        device, cast there to the corpus dtype; or, with
        ``corpus_on_device=False``, cast on the host into the host corpus."""
        corpus = self._served(tier.shape)
        for s in range(0, tier.shape[0], CORPUS_CHUNK):
            chunk = torch.from_numpy(np.array(tier[s:s + CORPUS_CHUNK]))
            corpus[s:s + CORPUS_CHUNK] = chunk.to(corpus.device).to(self.corpus_dtype)
        return corpus

    def _render_raw(self, raw=None):
        """Raw log-mels (P, n_notes, H, W), float32 on 'cpp' and float16 on
        'jax', into ``raw`` (a tier mapped for writing), else into a tensor
        on the device (on the host with ``corpus_on_device=False``); sets
        ``spec_stats``. -> ``raw``."""
        if raw is None:
            raw = self._raw_buffer(self._raw_dtype())
        if self.corpus_render_backend == "jax":
            return self._fm_raw(raw)
        return self._cpp_raw(raw)

    @staticmethod
    def _put(raw, index, t: torch.Tensor) -> None:
        """``raw[index] = t`` for a raw tensor or a tier mapped from disk."""
        if isinstance(raw, np.ndarray):
            raw[index] = t.cpu().numpy()
        else:
            raw[index] = t

    def _cpp_raw(self, raw):
        P = len(self.uids)
        for note_i, (pitch, vel) in enumerate(self.midi_notes):
            for s in range(0, P, CORPUS_CHUNK):
                chunk = self.presets[s:s + CORPUS_CHUNK]
                n = chunk.shape[0]
                t_r = time.perf_counter()
                wav = self.renderer.render_batch(chunk, [pitch] * n, [vel] * n)
                self.render_seconds += time.perf_counter() - t_r
                self._put(raw, (slice(s, s + n), note_i),
                          self.spectrogram(torch.from_numpy(wav).to(self.device)))
        self.spec_stats = self._compute_stats(raw)
        return raw

    def _compute_stats(self, raw) -> Dict[str, float]:
        """min, max, mean and std of the raw corpus (abstract_dataset.py:272-281),
        on the device 64 presets at a time (wherever the raw corpus is): the
        extremes, then the sums and the squared deviations in float64."""
        n_el = math.prod(raw.shape)
        ext, total = [], torch.zeros((), dtype=torch.float64, device=self.device)
        for s in range(0, raw.shape[0], CORPUS_CHUNK):
            x = self._chunk(raw, s)
            ext.append(torch.stack(torch.aminmax(x)))
            total += x.sum(dtype=torch.float64)
        ext = torch.stack(ext)
        mean = total / n_el
        sq = torch.zeros((), dtype=torch.float64, device=self.device)
        for s in range(0, raw.shape[0], CORPUS_CHUNK):
            sq += (self._chunk(raw, s).double() - mean).square().sum()
        return {"min": float(ext[:, 0].min()), "max": float(ext[:, 1].max()),
                "mean": float(mean), "std": float((sq / n_el).sqrt())}

    def _fm_raw(self, raw):
        """The 'jax' backend's pass (abstract_dataset.py:380-518 in meaning)."""
        P, (_, H, W) = len(self.uids), self.get_spectrogram_tensor_size()
        n_notes = len(self.midi_notes)
        presets = torch.from_numpy(self.presets).to(self.device)
        parts = []
        on_s, total_s = self.note_duration[0], sum(self.note_duration)
        for note_i, (pitch, vel) in enumerate(self.midi_notes):
            for s in range(0, P, RENDER_ROWS):
                rows = presets[s:s + RENDER_ROWS]
                n = rows.shape[0]
                t_r = time.perf_counter()
                wav = fm_torch.render_batch(rows, np.full(n, pitch), np.full(n, vel), on_s,
                                            total_s, self.sample_rate,
                                            feedback=self.corpus_render_feedback)
                self._sync()
                self.render_seconds += time.perf_counter() - t_r
                for j in range(0, n, CORPUS_CHUNK):
                    sp = self.spectrogram(wav[j:j + CORPUS_CHUNK])
                    parts.append(torch.stack([sp.amin(), sp.amax(), sp.sum(), (sp * sp).sum()]))
                    self._put(raw, (slice(s + j, s + j + sp.shape[0]), note_i), sp)
                del wav
        st = torch.stack(parts).cpu().numpy().astype(np.float64)
        n_el = float(P * n_notes * H * W)
        mean = float(st[:, 2].sum() / n_el)
        var = float(st[:, 3].sum() / n_el) - mean * mean
        self.spec_stats = {"min": float(st[:, 0].min()), "max": float(st[:, 1].max()),
                           "mean": mean, "std": float(np.sqrt(max(var, 0.0)))}
        return raw

    def _normalized(self, raw, norm_path: Optional[pathlib.Path] = None) -> torch.Tensor:
        """The corpus served from the raw one (a tensor, or the raw tier mapped
        from disk), 64 presets at a time on the device: the normalisation
        (abstract_dataset.py:548-556) in the raw dtype, its constants rounded
        to that dtype from the stats' Python floats as numpy rounds them; the
        float16 rounding (written to ``norm_path`` if given); the corpus
        dtype. Without a normalisation the raw values are served as they are
        and no float16 tier is written (abstract_dataset.py:371-377)."""
        norm, st = self.spectrogram_normalization, self.spec_stats
        is_tensor = isinstance(raw, torch.Tensor)
        on_device = is_tensor and raw.device == self.device
        f16 = raw.dtype == (torch.float16 if is_tensor else np.float16)
        raw_np_dtype = np.float16 if f16 else np.float32

        def const(v):
            return torch.from_numpy(np.array(v, dtype=raw_np_dtype)).to(self.device)

        if norm == "min_max":
            shift, scale = const(st["min"]), const((st["max"] - st["min"]) / 2.0)
        elif norm == "mean_std":
            shift, scale = const(st["mean"]), const(st["std"])
        in_place = (on_device and f16 and self.corpus_on_device
                    and torch.empty((), dtype=self.corpus_dtype).element_size() == 2)
        corpus = raw.view(self.corpus_dtype) if in_place else self._served(tuple(raw.shape))
        write = norm is not None and norm_path is not None
        with (_tier_file(norm_path, raw.shape, np.float16) if write
              else contextlib.nullcontext()) as tier:
            for s in range(0, raw.shape[0], CORPUS_CHUNK):
                x = self._chunk(raw, s)
                if norm is not None:
                    x = (x - shift).div_(scale)
                    if norm == "min_max":
                        x = x.add_(-1.0)
                    x = x.to(torch.float16)
                    if tier is not None:
                        tier[s:s + CORPUS_CHUNK] = x.cpu().numpy()
                corpus[s:s + CORPUS_CHUNK] = x.to(self.corpus_dtype)
        return corpus

    def compute_and_store_spectrograms_stats(self) -> Dict[str, float]:
        """Renders the raw corpus and writes the per-preset min/max/mean/var
        CSV, ``spec_stats.json`` and the raw tier (abstract_dataset.py:307-329;
        reference: abstractbasedataset.py:348-391). The per-preset values are
        reduced on the device in float64."""
        self.render_seconds = 0.0
        raw = self._render_raw()
        d = self._corpus_cache_dir()
        with open(d / "spectrograms_stats.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["UID", "min", "max", "mean", "var"])
            for s in range(0, raw.shape[0], CORPUS_CHUNK):
                chunk = self._chunk(raw, s)
                x = chunk.reshape(chunk.shape[0], -1).double()
                mean = x.mean(1)
                rows = torch.stack([x.amin(1), x.amax(1), mean,
                                    (x - mean[:, None]).square().mean(1)], 1).cpu().numpy()
                for uid, row in zip(self.uids[s:s + CORPUS_CHUNK], rows):
                    w.writerow([int(uid), *(float(v) for v in row)])
        with open(d / "spec_stats.json", "w") as f:
            json.dump(self.spec_stats, f)
        _save_tier(d / "specs_raw.npy", raw)
        return self.spec_stats

    def generate_wav_files(self, out_dir=None, n_threads: int = 0) -> int:
        """One 16-bit wav per (preset, MIDI note), rendered by the C++ engine
        64 presets at a time (abstract_dataset.py:283-305; reference:
        dexeddataset.py:278-311); -> the number of files. Training does not
        read them."""
        out_dir = pathlib.Path(out_dir) if out_dir else self._corpus_cache_dir() / "wav"
        out_dir.mkdir(parents=True, exist_ok=True)
        count = 0
        for pitch, vel in self.midi_notes:
            for s in range(0, len(self.uids), CORPUS_CHUNK):
                chunk = self.presets[s:s + CORPUS_CHUNK]
                n = chunk.shape[0]
                wavs = self.renderer.render_batch(chunk, [pitch] * n, [vel] * n, n_threads)
                for uid, wav in zip(self.uids[s:s + CORPUS_CHUNK], wavs):
                    write_wav(out_dir / f"preset{int(uid):06d}_pitch{pitch:03d}_vel{vel:03d}.wav",
                              wav, self.sample_rate)
                    count += 1
        return count

    def corpus_tensors(self) -> Dict[str, torch.Tensor]:
        """x, v (N, L) float32 and info (N, 3) int32 (uid, pitch, velocity),
        all on the device, or all on the host with ``corpus_on_device=False``
        (abstract_dataset.py:581-631). Single-note or
        stacked: N = P items, x (P, n_notes, H, W), info the first note.
        Un-stacked multi-note: N = P * n_notes items, note-major per preset,
        x (N, 1, H, W) a view of the (P, n_notes, H, W) corpus (no second
        corpus-sized buffer), v repeated, info each item's own note."""
        x = self.load_corpus()
        learnable = self.preset_indexes_helper.full_to_learnable_batch(self.presets)
        P, n_notes = x.shape[0], x.shape[1]
        notes = np.asarray(self.midi_notes, dtype=np.int64)
        if self._stacked or n_notes == 1:
            v = learnable
            info = np.stack([self.uids, np.full(P, notes[0, 0]), np.full(P, notes[0, 1])], axis=1)
        else:
            x = x.view(P * n_notes, 1, *x.shape[2:])
            v = np.repeat(learnable, n_notes, axis=0)
            info = np.concatenate([np.repeat(self.uids, n_notes)[:, None], np.tile(notes, (P, 1))],
                                  axis=1)
        return {"x": x, "v": self._placed(torch.from_numpy(v.astype(np.float32))),
                "info": self._placed(torch.from_numpy(info.astype(np.int32)))}
