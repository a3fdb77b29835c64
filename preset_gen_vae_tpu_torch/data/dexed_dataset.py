"""Dexed dataset: the seeded synthetic preset corpus, its constraints, the
DX7 renders and the normalised log-mel corpus resident on the device.

Counterparts: ``preset_gen_vae_tpu/data/dexed_dataset.py:32-244`` and the
parts of ``data/abstract_dataset.py`` it needs (:42-74, 111-154, 272-281,
380-556, 572-631); ``model_config_to_dataset_kwargs`` is ``data/build.py:18-41``.

``load_corpus`` builds the corpus once, on one of two render backends:

- ``'cpp'``: the presets are rendered in chunks of 64 by the C++ engine on
  the host; each chunk of waveforms goes to the device and through kernel
  K1 (``SpectrogramProcessor``; on the CPU its plain version); the corpus
  min/max are taken on the device (abstract_dataset.py:272-281) and the
  min/max-normalised corpus stays there;
- ``'jax'``: the on-device FM render of ``synth/fm_torch.py`` (on the card
  kernels F1 and F2) renders a whole note of up to ``RENDER_ROWS`` presets
  per launch, straight into the (rows, N) buffer K1 reads; K1 turns each
  64 rows into log-mels; min, max, sum and sum of squares accumulate in f32
  on the device over the real rows and the host combines them in f64
  (``spec_stats`` with min/max/mean/std); the raw log-mels are stored once
  in float16 and the min/max affine runs in float16, as the JAX package's
  device-resident pass does (abstract_dataset.py:380-546, its
  ``_finalize`` at :521-533), then becomes the corpus dtype in place when
  that dtype has two bytes. The JAX package's column-chunked layout
  (``data/corpus_device.py``) works around a TPU compiler limit and is not
  ported.

Both keep the normalised corpus on the device as ``(P, n_notes, H, W)``;
``corpus_tensors`` serves it in the two multi-note layouts of
abstract_dataset.py:609-631: stacked, one item per preset with its notes as
channels, or un-stacked, one item per (preset, note), as a view of the same
buffer. ``corpus_cache_policy`` takes the JAX package's values and checks
('device' requires the 'jax' backend); neither persists anything yet: the
disk cache and the SQLite preset database wait for a later slice.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.spectrogram import SpectrogramConfig, SpectrogramProcessor, normalize_min_max
from ..synth import database as db
from ..synth import dexed_params as dx
from ..synth import fm_torch
from ..synth.render import DexedRenderer
from .dexed_spec import build_dexed_preset_spec
from .preset import PresetIndexesHelper

CORPUS_CHUNK = 64  # waveforms turned into log-mels per K1 launch (and per C++ render)
# presets of one note rendered per F1/F2 launch on the 'jax' backend: 8,192
# rows of 4 s audio are 2.9 GB of f32
RENDER_ROWS = 8192
SYNTHETIC_STYLES = {
    "structured": db.generate_structured_corpus,
    "structured2": db.generate_structured_corpus_v2,
    "uniform": db.generate_random_corpus,
}


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
        n_synthetic_presets: int = 4096,
        synthetic_seed: int = 0,
        synthetic_style: str = "structured",
        corpus_render_backend: str = "cpp",
        corpus_render_feedback: str = "exact",
        corpus_cache_policy: str = "disk",
        device="cuda",
        corpus_dtype: torch.dtype = torch.float32,
    ):
        if spectrogram_normalization not in ("min_max", None):
            raise NotImplementedError(f"normalization {spectrogram_normalization!r}")
        # (dexed_dataset.py:85-100 there)
        if corpus_render_backend not in ("cpp", "jax"):
            raise ValueError(f"corpus_render_backend={corpus_render_backend!r}")
        if corpus_cache_policy not in ("disk", "device"):
            raise ValueError(f"corpus_cache_policy={corpus_cache_policy!r}")
        if corpus_cache_policy == "device" and corpus_render_backend != "jax":
            raise ValueError("corpus_cache_policy='device' requires corpus_render_backend='jax'")
        if corpus_render_feedback not in ("exact", "unrolled"):
            raise ValueError(f"corpus_render_feedback={corpus_render_feedback!r}")
        if synthetic_style not in SYNTHETIC_STYLES:
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
        self.device = torch.device(device)
        self.corpus_dtype = corpus_dtype
        self.spectrogram = SpectrogramProcessor(
            SpectrogramConfig(n_fft=n_fft, fft_hop=fft_hop, min_dB=spectrogram_min_dB,
                              n_mel_bins=n_mel_bins, sample_rate=sample_rate),
            device=self.device)
        self.algos = tuple(algos) if algos else None
        self.operators = tuple(operators) if operators is not None else (1, 2, 3, 4, 5, 6)
        self.restrict_to_labels = tuple(restrict_to_labels) if restrict_to_labels else None

        # ---- corpus (dexed_dataset.py:107-121) and constraints (:123-141)
        presets, names, labels = SYNTHETIC_STYLES[synthetic_style](
            n_synthetic_presets, seed=synthetic_seed, algos=self.algos)
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
        self.uids = np.nonzero(keep)[0].astype(np.int64)
        self._uid_to_row = {int(u): i for i, u in enumerate(self.uids)}

        # ---- learnable model spec (dexed_dataset.py:143-151)
        spec = build_dexed_preset_spec(
            algos=self.algos, operators=self.operators,
            vst_params_learned_as_categorical=vst_params_learned_as_categorical,
            constant_filter_and_tune_params=constant_filter_and_tune_params,
            param_names=[f"dexed_param_{i}" for i in range(dx.N_PARAMS)])
        self._spec = spec
        self.preset_indexes_helper = PresetIndexesHelper(spec)
        self.renderer = DexedRenderer(sample_rate=sample_rate, note_duration=note_duration)
        self.spec_stats: Optional[Dict[str, float]] = None
        self.corpus_seconds: Optional[float] = None  # the whole corpus pass
        self.render_seconds: Optional[float] = None  # its renders
        self._corpus: Optional[torch.Tensor] = None

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

    def get_spectrogram_tensor_size(self):
        H = self.n_mel_bins if self.n_mel_bins > 0 else self.spectrogram.n_fft // 2 + 1
        T = 1 + self.renderer.samples_per_render // self.spectrogram.hop
        return (self.midi_notes_per_preset if self._stacked else 1, H, T)

    # ------------------------------------------------------------------
    def load_corpus(self) -> torch.Tensor:
        """The normalised corpus (P, n_notes, H, W) on the device, built once."""
        if self._corpus is not None:
            return self._corpus
        t0, self.render_seconds = time.perf_counter(), 0.0
        if self.corpus_render_backend == "jax":
            self._corpus = self._fm_corpus()
        else:
            self._corpus = self._cpp_corpus()
        self._sync()
        self.corpus_seconds = time.perf_counter() - t0
        return self._corpus

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cpp_corpus(self) -> torch.Tensor:
        P, (_, H, W) = len(self.uids), self.get_spectrogram_tensor_size()
        raw = torch.empty((P, len(self.midi_notes), H, W), dtype=torch.float32,
                          device=self.device)
        for note_i, (pitch, vel) in enumerate(self.midi_notes):
            for s in range(0, P, CORPUS_CHUNK):
                chunk = self.presets[s:s + CORPUS_CHUNK]
                n = chunk.shape[0]
                t_r = time.perf_counter()
                wav = self.renderer.render_batch(chunk, [pitch] * n, [vel] * n)
                self.render_seconds += time.perf_counter() - t_r
                raw[s:s + n, note_i] = self.spectrogram(torch.from_numpy(wav).to(self.device))
        mn, mx = torch.aminmax(raw)
        self.spec_stats = {"min": float(mn), "max": float(mx)}
        if self.spectrogram_normalization is None:
            return raw.to(self.corpus_dtype)
        # the JAX package serves the normalised corpus rounded through its
        # float16 disk tier (abstract_dataset.py:371-377), so the values
        # cast to the corpus dtype are those f16 values; 64 presets at a
        # time, so that the temporaries stay small beside the two buffers
        corpus = torch.empty(raw.shape, dtype=self.corpus_dtype, device=self.device)
        for s in range(0, P, CORPUS_CHUNK):
            x = normalize_min_max(raw[s:s + CORPUS_CHUNK], (mn, mx))  # abstract_dataset.py:548-556
            corpus[s:s + CORPUS_CHUNK] = x.to(torch.float16).to(self.corpus_dtype)
        return corpus

    def _fm_corpus(self) -> torch.Tensor:
        """The 'jax' backend's pass (abstract_dataset.py:380-546 in meaning)."""
        P, (_, H, W) = len(self.uids), self.get_spectrogram_tensor_size()
        n_notes = len(self.midi_notes)
        presets = torch.from_numpy(self.presets).to(self.device)
        raw = torch.empty((P, n_notes, H, W), dtype=torch.float16, device=self.device)
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
                    raw[s + j:s + j + sp.shape[0], note_i] = sp
                del wav
        st = torch.stack(parts).cpu().numpy().astype(np.float64)
        n_el = float(P * n_notes * H * W)
        mean = float(st[:, 2].sum() / n_el)
        var = float(st[:, 3].sum() / n_el) - mean * mean
        self.spec_stats = {"min": float(st[:, 0].min()), "max": float(st[:, 1].max()),
                           "mean": mean, "std": float(np.sqrt(max(var, 0.0)))}
        # the affine in float16, op for op (abstract_dataset.py:521-533)
        f16 = {k: torch.tensor(v, dtype=torch.float16, device=self.device) for k, v in (
            ("min", self.spec_stats["min"]),
            ("half", (self.spec_stats["max"] - self.spec_stats["min"]) / 2.0))}
        in_place = torch.empty((), dtype=self.corpus_dtype).element_size() == 2
        corpus = raw.view(self.corpus_dtype) if in_place else torch.empty(
            raw.shape, dtype=self.corpus_dtype, device=self.device)
        # 64 presets at a time, so that the affine's temporaries stay small
        # beside the one corpus buffer
        for s in range(0, P, CORPUS_CHUNK):
            x = raw[s:s + CORPUS_CHUNK]
            if self.spectrogram_normalization == "min_max":
                x = (x - f16["min"]).div_(f16["half"]).add_(-1.0)
            corpus[s:s + CORPUS_CHUNK] = x.to(self.corpus_dtype)
        return corpus

    def corpus_tensors(self) -> Dict[str, torch.Tensor]:
        """x, v (N, L) float32 and info (N, 3) int32 (uid, pitch, velocity),
        all on the device (abstract_dataset.py:581-631). Single-note or
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
        return {"x": x, "v": torch.from_numpy(v.astype(np.float32)).to(self.device),
                "info": torch.from_numpy(info.astype(np.int32)).to(self.device)}
