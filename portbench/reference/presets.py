"""The reference's own view of a cell's corpus: the presets made again from
the seed by the frozen generator, with the dataset's constraints, the
learnable targets ``v``, the items' ``info`` rows, the split and the
configs resolved against it. It reads nothing that the program made.

Each step follows ``DexedDataset.__init__``, ``corpus_tensors``,
``get_split_loaders`` and ``prepare_dataset`` of the port as they stood
when the benchmark was defined (``portbench/reference/frozen`` holds the
code they call)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .frozen import config as fcfg
from .frozen.data.dexed_spec import build_dexed_preset_spec
from .frozen.data.preset import PresetIndexesHelper
from .frozen.data.sampler import build_subset_item_indexes
from .frozen.synth import database as db
from .frozen.synth import dexed_params as dx

STYLES = {"structured": db.generate_structured_corpus,
          "structured2": db.generate_structured_corpus_v2,
          "uniform": db.generate_random_corpus}


@dataclasses.dataclass
class Corpus:
    """Presets (P, 155) after the constraints, their learnable targets and
    items, and the split, as the program's dataset would hold them."""
    presets: np.ndarray
    uids: np.ndarray
    helper: PresetIndexesHelper
    midi_notes: tuple
    stacked: bool
    v: np.ndarray  # (N, L) float32
    info: np.ndarray  # (N, 3) int32: uid, pitch, velocity
    splits: Dict[str, np.ndarray]
    spec_size: tuple  # (C, H, W) of one item
    learnable_params_count: int

    @property
    def valid_presets_count(self) -> int:
        return len(self.uids)

    @property
    def midi_notes_per_preset(self) -> int:
        return len(self.midi_notes)

    @property
    def multichannel_stacked_spectrograms(self) -> bool:
        return self.stacked

    @property
    def learnable_params_tensor_length(self) -> int:
        return self.helper.learnable_preset_size


def load_configs(config_path):
    """(ModelConfig, TrainConfig) of the frozen config module from a
    configuration file's ``model`` and ``train`` sections."""
    return fcfg.load_config(config_path)


def _domain(model_c):
    """(algos, operators, helper, learnable count, notes, stacked, item size)
    of the configuration, which need no preset."""
    algos, operators = model_c.dataset_synth_args
    algos = tuple(algos) if algos else None
    operators = tuple(operators) if operators is not None else (1, 2, 3, 4, 5, 6)
    spec = build_dexed_preset_spec(
        algos=algos, operators=operators,
        vst_params_learned_as_categorical=model_c.synth_vst_params_learned_as_categorical,
        constant_filter_and_tune_params=True,
        param_names=[f"dexed_param_{i}" for i in range(dx.N_PARAMS)])
    notes = tuple(tuple(n) for n in model_c.midi_notes)
    stacked = model_c.stack_spectrograms and len(notes) > 1
    n_fft, hop = model_c.stft_args
    H = model_c.mel_bins if model_c.mel_bins > 0 else n_fft // 2 + 1
    W = 1 + samples_per_note(model_c) // hop
    return (algos, operators, PresetIndexesHelper(spec),
            sum(m is not None for m in spec.learnable_model), notes, stacked,
            (len(notes) if stacked else 1, H, W))


def make_corpus(model_c, train_c, n_presets: int, style: str, seed: int,
                with_presets: bool = True) -> Corpus:
    """The corpus of ``n_presets`` presets of ``style`` from ``seed``;
    without ``with_presets``, only what building the model needs (no
    preset is made, and every preset is taken to pass the constraints)."""
    algos, operators, helper, n_learnable, notes, stacked, size = _domain(model_c)
    corpus = Corpus(presets=np.zeros((0, dx.N_PARAMS), np.float32),
                    uids=np.arange(n_presets, dtype=np.int64), helper=helper, midi_notes=notes,
                    stacked=stacked, v=np.zeros((0, helper.learnable_preset_size), np.float32),
                    info=np.zeros((0, 3), np.int32), splits={}, spec_size=size,
                    learnable_params_count=n_learnable)
    if not with_presets:
        return corpus
    presets, _, _ = STYLES[style](n_presets, seed=seed, algos=algos)
    dx.set_default_general_filter_and_tune_params(presets)
    dx.set_operators(presets, operators)
    dx.prevent_SH_LFO(presets)
    keep = np.ones((presets.shape[0],), dtype=bool)
    if algos:
        algo_of = np.rint(presets[:, dx.IDX_ALGORITHM] * 31.0).astype(int) + 1
        keep &= np.isin(algo_of, np.asarray(algos))
    if model_c.dataset_labels:
        raise NotImplementedError("label-restricted corpora")
    presets = presets[keep]
    uids = np.nonzero(keep)[0].astype(np.int64)
    learnable = helper.full_to_learnable_batch(presets)
    P = len(uids)
    notes_a = np.asarray(notes, dtype=np.int64)
    if stacked or len(notes) == 1:
        v = learnable
        info = np.stack([uids, np.full(P, notes_a[0, 0]), np.full(P, notes_a[0, 1])], axis=1)
    else:
        v = np.repeat(learnable, len(notes), axis=0)
        info = np.concatenate([np.repeat(uids, len(notes))[:, None], np.tile(notes_a, (P, 1))],
                              axis=1)
    corpus.presets, corpus.uids = presets, uids
    corpus.v, corpus.info = v.astype(np.float32), info.astype(np.int32)
    corpus.splits = build_subset_item_indexes(
        corpus, k_fold=train_c.current_k_fold, k_folds_count=train_c.k_folds,
        test_holdout_proportion=train_c.test_holdout_proportion, random_seed=0)
    return corpus


def samples_per_note(model_c) -> int:
    """Samples of one rendered note: its length rounded up to the engine's
    512-sample block (``fm_torch.samples_per_render``)."""
    from .frozen.synth.fm_torch import samples_per_render

    return samples_per_render(float(sum(model_c.note_duration)), int(model_c.sampling_rate))


def resolved_configs(model_c, train_c, corpus: Corpus):
    """The configs resolved against the corpus as ``prepare_dataset`` does."""
    model_c, train_c = fcfg.resolve(model_c, train_c)
    model_c, train_c = fcfg.resolve_with_dataset(model_c, train_c, corpus)
    model_c = dataclasses.replace(model_c, input_tensor_size=(train_c.minibatch_size,
                                                              *corpus.spec_size),
                                  spectrogram_size=corpus.spec_size[1:])
    return model_c, train_c


def feed(corpus: Corpus, device) -> Dict[str, torch.Tensor]:
    """``v`` and ``info`` of every item on ``device``."""
    return {"v": torch.from_numpy(corpus.v).to(device),
            "info": torch.from_numpy(corpus.info).to(device)}
