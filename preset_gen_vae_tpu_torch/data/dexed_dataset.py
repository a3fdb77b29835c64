"""Dexed dataset: the seeded synthetic preset corpus, its constraints, the
DX7 renders and the normalised log-mel corpus resident on the device.

Counterparts: ``preset_gen_vae_tpu/data/dexed_dataset.py:32-192`` and the
parts of ``data/abstract_dataset.py`` it needs (:42-74, 111-154, 272-281,
548-556, 572-631); ``model_config_to_dataset_kwargs`` is ``data/build.py:18-41``.

The corpus pass (``load_corpus``) renders the presets in chunks with the
C++ engine on the host, moves each chunk of waveforms to the device and
runs kernel K1 there (``SpectrogramProcessor``; on the CPU its plain
version), takes the corpus min/max on the device
(abstract_dataset.py:272-281) and keeps the min/max-normalised corpus on
the device as ``(P, n_notes, H, W)``. ``corpus_tensors`` serves it in the
two multi-note layouts of abstract_dataset.py:609-631: stacked, one item
per preset with its notes as channels, or un-stacked, one item per
(preset, note), as a view of the same buffer. There is no disk cache, no SQLite
preset database and no on-device ('jax') render backend in this slice; the
128-lane chunked corpus layout of ``data/corpus_device.py`` is not needed
by torch indexing and is not ported.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.spectrogram import SpectrogramConfig, SpectrogramProcessor, normalize_min_max
from ..synth import database as db
from ..synth import dexed_params as dx
from ..synth.render import DexedRenderer
from .dexed_spec import build_dexed_preset_spec
from .preset import PresetIndexesHelper

CORPUS_CHUNK = 64  # waveforms rendered and turned into log-mels per K1 launch


def model_config_to_dataset_kwargs(model_config) -> Dict:
    """(data/build.py:18-41; reference: data/dataset.py:18-25). Raises for
    the on-device 'jax' render backend, which is not ported: the C++
    engine's corpus would differ from the one that config asks for."""
    if model_config.dataset_corpus_render_backend != "cpp":
        raise NotImplementedError(
            f"corpus render backend {model_config.dataset_corpus_render_backend!r}: "
            "only 'cpp' is ported")
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
        device="cuda",
        corpus_dtype: torch.dtype = torch.float32,
    ):
        if spectrogram_normalization not in ("min_max", None):
            raise NotImplementedError(f"normalization {spectrogram_normalization!r}")
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
        presets, names, labels = db.generate_structured_corpus(
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
        self.render_seconds: Optional[float] = None  # its host renders
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
        if self.spectrogram_normalization == "min_max":  # abstract_dataset.py:548-556
            raw = normalize_min_max(raw, (mn, mx))
        self._corpus = raw.to(self.corpus_dtype)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.corpus_seconds = time.perf_counter() - t0
        return self._corpus

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
