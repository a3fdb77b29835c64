"""Copy of ``preset_gen_vae_tpu/config.py``, the JAX package's counterpart,
unchanged apart from this paragraph, one default of ``EvalConfig``
(``device``; see there) and the comments of
``dataset_corpus_render_backend``, ``dataset_corpus_cache_policy``,
``steps_per_dispatch``, ``scan_unroll``, ``audio_render_backend``,
``audio_batch_size``, ``cache_gt_audio``,
``main_cuda_device_idx``, the profiler fields, the parallel fields
(``data_parallel_devices`` to ``force_multihost_data``), ``compute_dtype``
and ``dataset_cache_device``, which say what the fields mean in this
package; and ``resolve`` sets the epoch counts only in a config that it
has not resolved already (see there).

Typed, functional configuration system.

Mirrors the reference's module-level ``_Config`` attribute bags and its
``update_dynamic_config_params()`` derivation (reference: config.py:19-202,
utils/config.py:7-50) — but as frozen-by-convention dataclasses and a *pure*
``resolve()`` function that returns new config objects instead of mutating a
module.  Two values the reference mutates from other layers
(``synth_params_count`` / ``learnable_params_tensor_length`` and — for flow
regression — ``dim_z``; reference: data/build.py:34-39, config.py:50,63-64)
are resolved here explicitly via ``resolve_with_dataset()``.

JSON persistence keeps the reference's on-disk layout: a single
``config.json`` with ``{"model": {...}, "train": {...}, "evaluate": {...}}``
sections (reference: logs/logger.py:158-162, utils/config.py:30-50).
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import pathlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple


def _tuplify(x):
    """JSON round-trip turns tuples into lists; restore tuples recursively
    (reference behavior: utils/config.py:36-39)."""
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


@dataclass
class ModelConfig:
    """Model / dataset configuration (reference: config.py:19-75)."""

    name: str = "FlVAE2"
    run_name: str = "00_debug"
    allow_erase_run: bool = True
    # See models/encoder.py for available architectures.
    encoder_architecture: str = "speccnn8l1_bn"
    # 'flow_realnvp_6l300', 'mlp_3l1024', ...
    params_regression_architecture: str = "flow_realnvp_6l300"
    params_reg_softmax: bool = False
    # Audio / spectrogram frontend
    note_duration: Tuple[float, float] = (3.0, 1.0)
    sampling_rate: int = 22050
    stft_args: Tuple[int, int] = (1024, 256)  # (n_fft, hop)
    mel_bins: int = 257  # -1 disables mel-scale
    mel_f_limits: Tuple[float, float] = (0, 11050)
    midi_notes: Tuple[Tuple[int, int], ...] = ((60, 85),)
    stack_spectrograms: bool = False
    stack_specs_deepest_features_mix: bool = False
    increased_dataset_size: Optional[bool] = None  # derived
    spectrogram_min_dB: float = -120.0
    spectrogram_size: Tuple[int, int] = (257, 347)
    input_tensor_size: Optional[Tuple[int, int, int, int]] = None  # derived
    concat_midi_to_z: Optional[bool] = None  # derived
    dim_z: int = 256
    latent_flow_arch: Optional[str] = "realnvp_6l300"
    forward_controls_loss: bool = True
    # Synth / dataset description
    synth: str = "dexed"
    synth_args_str: str = "al*_op*_lab*"  # derived (reference: config.py:62,184-196)
    synth_params_count: int = -1  # set from dataset
    learnable_params_tensor_length: int = -1  # set from dataset
    synth_vst_params_learned_as_categorical: Optional[str] = "all<=32"
    dataset_labels: Optional[Tuple[str, ...]] = None
    # (algos, operators); None means "all"
    dataset_synth_args: Tuple[Optional[Tuple[int, ...]], Optional[Tuple[int, ...]]] = (
        None,
        (1, 2, 3, 4, 5, 6),
    )
    # Offline corpus render engine: 'cpp' = native host engine (ctypes
    # thread pool), 'jax' = the on-device FM render (synth/fm_torch.py,
    # kernels F1 and F2 on the card) feeding the log-mel kernel K1
    # (data/dexed_dataset.py). The two engines agree within the golden
    # tolerance of the JAX package's tests; no reference analog (the
    # reference renders offline wav corpora through a VST process pool,
    # dexeddataset.py:278-328).
    dataset_corpus_render_backend: str = "cpp"
    # Corpus residency: 'disk' = the two-tier npy cache under the data root
    # (specs_raw.npy, specs_norm_f16.npy, spec_stats.json; the JAX
    # package's files, so either package serves the other's cache) —
    # rendered once, reloaded by every later train, resume and eval;
    # 'device' = the normalized corpus is built and stays on the card
    # (requires the 'jax' backend; nothing persisted).
    dataset_corpus_cache_policy: str = "disk"
    logs_root_dir: str = "saved"


@dataclass
class TrainConfig:
    """Training configuration (reference: config.py:78-138)."""

    # the run's creation time, a record in config.json; nothing reads it
    start_datetime: str = field(default_factory=lambda: datetime.datetime.now().isoformat())
    minibatch_size: int = 160
    main_cuda_device_idx: int = 1  # kept for config parity; unused (entry points take ``device``)
    test_holdout_proportion: float = 0.2
    k_folds: int = 5
    current_k_fold: int = 0
    start_epoch: int = 0
    n_epochs: int = 400
    save_period: int = 50
    plot_period: int = 20
    latent_loss: str = "Dkl"  # kept for config parity; neither package reads it
    latent_flow_input_regularization: str = "bn"  # 'bn' or 'dkl'
    params_cat_bceloss: bool = False
    params_cat_softmax_temperature: float = 0.2
    # FlowParamsLoss (forward_controls_loss=False) inverse-pass BN mode:
    # 'train' = reference parity (batch stats + dropout in the inverse
    # flows, running stats updated twice per step, loss.py:318-346);
    # 'eval' = running stats (flows strictly invertible). Measured
    # comparison: PARITY.md.
    flow_loss_bn_mode: str = "train"
    normalize_losses: bool = True
    # Optimizer
    optimizer: str = "Adam"
    initial_learning_rate: float = 2e-4
    lr_warmup_epochs: int = 6
    lr_warmup_start_factor: float = 0.1
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 1e-4
    fc_dropout: float = 0.3
    reg_fc_dropout: float = 0.4
    beta: float = 0.2
    beta_start_value: float = 0.1
    beta_warmup_epochs: int = 25
    beta_cycle_epochs: int = -1  # kept for config parity; neither package reads it
    # Scheduler
    scheduler_name: str = "ReduceLROnPlateau"  # the only one; checked on resume
    scheduler_loss: Tuple[str, ...] = ("ReconsLoss/Backprop", "Controls/BackpropLoss")
    scheduler_lr_factor: float = 0.2
    scheduler_patience: int = 6
    scheduler_cooldown: int = 6
    scheduler_threshold: float = 1e-4
    early_stop_lr_threshold: Optional[float] = None  # derived
    # Misc
    verbosity: int = 1
    init_security_pause: float = 0.0
    logged_samples_count: int = 4  # raised to the note count by resolve; nothing else reads it
    # enabled=True: a torch.profiler window over the first epoch's first 5
    # train steps, written to <run_dir>/profile/trace.json (utils/profile.py)
    profiler_args: Dict = field(default_factory=lambda: {"enabled": False})
    # with the profiler on: stop after 3 train steps, before validation
    profiler_full_trace: bool = False
    profiler_1_GPU: bool = False  # kept for config parity; unused
    # the JAX package's additions (not in the reference). The port trains
    # one process a card (torchrun, parallel/multihost.py) on a grid of
    # n_data x model_parallel_devices processes: data_parallel_devices above
    # 1 must equal n_data, the processes over model_parallel_devices, else
    # training raises; -1 (or 1) takes the processes there are
    data_parallel_devices: int = -1
    # >1: tensor parallelism (parallel/sharding_rules.py): n_data =
    # gcd(minibatch_size, processes // model_parallel_devices), and every 2-D
    # kernel of at least tp_min_elements entries is cut over the processes
    # of one data rank, by its output features where they divide, else by
    # its input features; a world the grid cannot hold raises
    model_parallel_devices: int = 1
    tp_min_elements: int = 1 << 18
    # The multi-process data path (each process trains on its carve of every
    # split, parallel/multihost.py) engages with a process group of more
    # than one; True takes it in one process too (the tests do). It refuses
    # dataset_corpus_cache_policy='device', as the JAX package does.
    force_multihost_data: bool = False
    compute_dtype: str = "bfloat16"  # bf16 autocast on the card; 'float32' runs in full f32
    # True: the corpus stays in device memory, a batch is a gather there.
    # False: the host-fed pipeline (data/pipeline.py): the corpus pass
    # computes on the card a chunk at a time, the corpus lives in pinned
    # host memory and each batch is gathered there and copied to the card,
    # steps one at a time
    dataset_cache_device: bool = True
    # Shard the HBM-resident corpus's rows over the mesh's 'data' axis
    # (per-device HBM ~P/n_data rows; the batch gather partitions as
    # local-gather + mask + psum — tests/test_corpus_sharded.py pins that
    # no corpus-sized all-gather appears). False replicates the corpus
    # per device (pre-round-5 behavior). Irrelevant on a 1-device mesh.
    # Not read here: each process already holds only its carve's rows on
    # its card (parallel/multihost.py:shard_loaders_for_host).
    corpus_rows_sharded: bool = True
    # >1: chain K train steps into ONE device dispatch (lax.scan over K
    # index batches, device-resident corpus only). Identical math/PRNG
    # stream to K=1 (the step folds its own rng from state.step); it only
    # amortizes host dispatch — the bottleneck on weak-host machines.
    # -1: whole-epoch dispatch — K is set to the train loader's batch
    # count, so every epoch is ONE train dispatch + ONE validation scan.
    # In this package (training/dispatch.py): in one process, K whole
    # train steps are one CUDA graph, captured once per run after the first
    # group (run eagerly as its warm-up) and replayed once per group; the
    # remainder steps one at a time, each a replay of a one-step graph. K=1,
    # several processes, the host-fed pipeline (dataset_cache_device=False)
    # and the profiled epoch step eagerly.
    # The validation step of an epoch that draws no figure is a graph
    # replayed per batch, whatever K is (one process, resident corpus).
    steps_per_dispatch: int = 16
    # lax.scan unroll factor for the K-step/whole-epoch scans (>1 inlines
    # that many step bodies per scan iteration, letting XLA overlap work
    # across steps at the cost of compile time). No counterpart here: a
    # graph of K steps holds every step's kernels already, and the factor
    # changes no arithmetic in JAX either; it is read and ignored.
    scan_unroll: int = 1
    remat: bool = False  # rematerialize the forward in backward (big batches)
    seed: int = 0


@dataclass
class EvalConfig:
    """Evaluation configuration (reference: evalconfig.py, utils/config.py:11-22)."""

    start_datetime: str = field(default_factory=lambda: datetime.datetime.now().isoformat())
    models_names: Tuple[str, ...] = ()
    override_previous_eval: bool = False
    k_folds_count: int = 0
    dataset: str = "validation"  # 'validation' or 'test'
    minibatch_size: int = 1
    device: str = "cuda"
    verbosity: int = 2
    load_from_archives: bool = False
    multiprocess_cores_ratio: float = 0.1
    epoch: int = -1
    # 'cpp' = host C++ thread-pool render (reference-like); 'jax' = batched
    # on-device render through synth/fm_torch.py, kernels F1 and F2 on the
    # card (both GT and inferred presets go through the same engine, in one
    # call per batch). 'cpp' remains available as the engine-independence
    # cross-check.
    audio_render_backend: str = "jax"
    # feedback solve for the 'jax' backend: 'exact' (per-sample scan,
    # matches the C++ engine — the DEFAULT: eval is where fidelity matters,
    # VERDICT r3 #6) or 'unrolled' (fast fixed-point approximation,
    # fb_iters=3, within 0.05 MAE of exact on feedback-heavy presets — for
    # throughput-bound uses). Reference render contract: eval.py:190-203.
    audio_render_feedback: str = "exact"
    # audio similarity batch: the items re-rendered and scored per call (one
    # F1 and one F2 launch each under 'jax'); big batches cut the launches
    # and host round trips per item
    audio_batch_size: int = 256
    # reuse ground-truth renders across evals (C++ backend only): GT audio
    # for the eval split is rendered once and disk-cached keyed by
    # (item set, engine version, sample rate) — the reference reads
    # pre-rendered GT wavs instead of re-rendering (eval.py:257-259); the
    # cache sits in the corpus cache directory. Ignored under 'jax', whose
    # GT and inferred audio share one engine, as in the JAX package.
    cache_gt_audio: bool = True


def resolve(model: ModelConfig, train: TrainConfig) -> Tuple[ModelConfig, TrainConfig]:
    """Pure re-implementation of ``update_dynamic_config_params()``
    (reference: config.py:148-202). Returns *new* config objects."""
    model = dataclasses.replace(model)
    train = dataclasses.replace(train)
    # a config that resolve made (a run's config.json) holds its derived
    # flags, and its epoch counts already reset or divided: a second
    # resolve, as train_config makes of a saved run's config, leaves the
    # counts as they are
    flags = (model.increased_dataset_size, model.concat_midi_to_z)

    # stack_spectrograms must be False for 1-note datasets (config.py:155)
    model.stack_spectrograms = model.stack_spectrograms and (len(model.midi_notes) > 1)
    model.increased_dataset_size = (len(model.midi_notes) > 1) and not model.stack_spectrograms
    model.concat_midi_to_z = (len(model.midi_notes) > 1) and not model.stack_spectrograms
    model.input_tensor_size = (
        train.minibatch_size,
        1 if not model.stack_spectrograms else len(model.midi_notes),
        model.spectrogram_size[0],
        model.spectrogram_size[1],
    )

    resolved = flags == (model.increased_dataset_size, model.concat_midi_to_z)

    train.early_stop_lr_threshold = train.initial_learning_rate * 1e-3
    train.logged_samples_count = max(train.logged_samples_count, len(model.midi_notes))
    # Epoch counts increased for algorithm-restricted (reduced) datasets (config.py:167-172)
    if model.dataset_synth_args[0] is not None and not resolved:
        train.n_epochs = 700
        train.lr_warmup_epochs = 10
        train.scheduler_patience = 10
        train.scheduler_cooldown = 10
        train.beta_warmup_epochs = 40
    # Epoch counts reduced for artificially increased datasets (config.py:175-181)
    if model.increased_dataset_size and not resolved:
        N = len(model.midi_notes) - 1
        train.n_epochs = 1 + train.n_epochs // N
        train.lr_warmup_epochs = 1 + train.lr_warmup_epochs // N
        train.scheduler_patience = 1 + train.scheduler_patience // N
        train.scheduler_cooldown = 1 + train.scheduler_cooldown // N
        train.beta_warmup_epochs = 1 + train.beta_warmup_epochs // N

    # Synth-args auto string (config.py:184-196)
    if model.synth == "dexed":
        s = model.synth_args_str
        if model.dataset_synth_args[0] is not None:
            s = s.replace("al*", "al" + ".".join(str(a) for a in model.dataset_synth_args[0]))
        if model.dataset_synth_args[1] is not None:
            s = s.replace("_op*", "_op" + "".join(str(o) for o in model.dataset_synth_args[1]))
        if model.dataset_labels is not None:
            s = s.replace("_lab*", "_" + "_".join(lab[0:4] for lab in model.dataset_labels))
        model.synth_args_str = s
    else:
        raise NotImplementedError(f"Unknown synth prefix for model.synth '{model.synth}'")
    return model, train


def resolve_with_dataset(
    model: ModelConfig, train: TrainConfig, dataset
) -> Tuple[ModelConfig, TrainConfig]:
    """Applies the dataset-dependent config mutations the reference performs in
    data/build.py:15-41: stores the synth params counts and — when a *flow*
    regression is used — forces ``dim_z`` to the learnable preset tensor
    length (reference: data/build.py:34-39, model/build.py:70)."""
    model = dataclasses.replace(model)
    model.synth_params_count = dataset.learnable_params_count
    model.learnable_params_tensor_length = dataset.learnable_params_tensor_length
    if model.params_regression_architecture.startswith("flow_"):
        model.dim_z = dataset.learnable_params_tensor_length
    return model, train


# --------------------------------------------------------------------------
# JSON persistence (reference: utils/config.py:30-50, logs/logger.py:158-162)
# --------------------------------------------------------------------------


def save_config(
    path, model: ModelConfig, train: TrainConfig, evaluate: Optional[EvalConfig] = None
) -> None:
    payload = {
        "model": dataclasses.asdict(model),
        "train": dataclasses.asdict(train),
        "evaluate": dataclasses.asdict(evaluate) if evaluate is not None else {},
    }
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def _from_dict(cls, d: dict):
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k in known:
            kwargs[k] = _tuplify(v) if not isinstance(v, dict) else v
    return cls(**kwargs)


def load_config(path) -> Tuple[ModelConfig, TrainConfig]:
    """Loads a frozen run config (model + train sections)."""
    with open(path, "r") as f:
        payload = json.load(f)
    return _from_dict(ModelConfig, payload["model"]), _from_dict(TrainConfig, payload["train"])


def load_full_config(path) -> Tuple[ModelConfig, TrainConfig, EvalConfig]:
    with open(path, "r") as f:
        payload = json.load(f)
    return (
        _from_dict(ModelConfig, payload["model"]),
        _from_dict(TrainConfig, payload["train"]),
        _from_dict(EvalConfig, payload.get("evaluate", {}) or {}),
    )


# --------------------------------------------------------------------------
# Resume-time consistency check (reference: model/build.py:83-122)
# --------------------------------------------------------------------------

_MODEL_ATTRS_TO_CHECK = (
    "name",
    "run_name",
    "encoder_architecture",
    "dim_z",
    "concat_midi_to_z",
    "latent_flow_arch",
    "logs_root_dir",
    "note_duration",
    "stack_spectrograms",
    "increased_dataset_size",
    "stft_args",
    "spectrogram_size",
    "mel_bins",
    # engine choice changes the rendered training data, so a resume must
    # not silently switch it (caches are namespaced per backend)
    "dataset_corpus_render_backend",
)
_TRAIN_ATTRS_TO_CHECK = (
    "minibatch_size",
    "test_holdout_proportion",
    "normalize_losses",
    "optimizer",
    "scheduler_name",
)


def _is_attr_equal(a, b):
    a = _tuplify(a) if isinstance(a, list) else a
    b = _tuplify(b) if isinstance(b, list) else b
    return a == b


def check_configs_on_resume_from_checkpoint(
    new_model: ModelConfig, new_train: TrainConfig, prev_config_json: dict
) -> None:
    """Raises ValueError on any whitelisted attribute mismatch between the
    new config and a previous run's frozen config.json
    (reference: model/build.py:90-122)."""
    prev_model = prev_config_json["model"]
    for attr in _MODEL_ATTRS_TO_CHECK:
        if attr in prev_model and not _is_attr_equal(
            prev_model[attr], getattr(new_model, attr)
        ):
            raise ValueError(
                f"Model attribute '{attr}' differs between new config "
                f"({getattr(new_model, attr)}) and checkpoint config ({prev_model[attr]})"
            )
    prev_train = prev_config_json["train"]
    for attr in _TRAIN_ATTRS_TO_CHECK:
        if attr in prev_train and not _is_attr_equal(
            prev_train[attr], getattr(new_train, attr)
        ):
            raise ValueError(
                f"Train attribute '{attr}' differs between new config "
                f"({getattr(new_train, attr)}) and checkpoint config ({prev_train[attr]})"
            )
