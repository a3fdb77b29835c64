"""Model factory: config -> an initialised ``ExtendedAE``.

Counterpart: ``preset_gen_vae_tpu/models/build.py:28-112`` (reference:
model/build.py:11-80). Weights are drawn on the CPU from a seeded
``torch.Generator`` with flax's initialisers (``layers.init_like_flax``),
so a seed gives the same model on every device; the caller moves it.
bf16 compute with float32 master weights (``compute_dtype='bfloat16'``,
models/build.py:22-25 there) is the train step's autocast, not a model
property.
"""

from __future__ import annotations

import torch

from ..config import ModelConfig, TrainConfig
from ..data.preset import PresetIndexesHelper
from .decoder import SpectrogramDecoder
from .encoder import SpectrogramEncoder
from .extended_ae import ExtendedAE
from .layers import init_like_flax
from .regression import FlowRegression, MLPRegression
from .vae import BasicVAE, FlowVAE


def build_extended_ae_model(model_config: ModelConfig, train_config: TrainConfig,
                            idx_helper: PresetIndexesHelper, seed: int = 0) -> ExtendedAE:
    _, channels, H, W = model_config.input_tensor_size
    # multi-note single-channel models get wider mixers (reference: build.py:16)
    force_bigger = len(model_config.midi_notes) > 1 and not model_config.stack_spectrograms
    midi_in_z0 = bool(model_config.concat_midi_to_z)
    if midi_in_z0 and model_config.latent_flow_arch is None:
        raise ValueError("MIDI in z0 needs a latent flow (FlowVAE): BasicVAE puts no MIDI "
                         "note in z0, and its encoder would emit dim_z - 2 values "
                         "(models/build.py:35-37, 65-66)")
    encoder = SpectrogramEncoder(
        model_config.encoder_architecture,
        model_config.dim_z - 2 if midi_in_z0 else model_config.dim_z, (H, W), channels,
        train_config.fc_dropout,
        output_bn=train_config.latent_flow_input_regularization.lower() == "bn",
        deepest_features_mix=model_config.stack_specs_deepest_features_mix,
        force_bigger_network=force_bigger)
    decoder = SpectrogramDecoder(model_config.encoder_architecture, model_config.dim_z,
                                 tuple(model_config.spectrogram_size), channels,
                                 train_config.fc_dropout, force_bigger)
    if model_config.latent_flow_arch is None:
        if not model_config.forward_controls_loss:
            raise ValueError("FlowParamsLoss (forward_controls_loss=False) pulls the target back "
                             "through the latent flow's inverse: BasicVAE has no latent flow "
                             "(extended_ae.py:45-47)")
        ae_model = BasicVAE(encoder, decoder, model_config.dim_z)
    else:
        ae_model = FlowVAE(encoder, decoder, model_config.dim_z, model_config.latent_flow_arch,
                           concat_midi_to_z0=midi_in_z0)
    arch = model_config.params_regression_architecture
    if arch.startswith("mlp_"):
        # a non-invertible MLP cannot pull target values back (build.py:87-89)
        if not model_config.forward_controls_loss:
            raise ValueError("an MLP regression head needs forward_controls_loss=True")
        reg_model = MLPRegression(arch.replace("mlp_", ""), model_config.dim_z, idx_helper,
                                  train_config.reg_fc_dropout, model_config.params_reg_softmax)
    elif arch.startswith("flow_"):
        reg_model = FlowRegression(arch.replace("flow_", ""), model_config.dim_z, idx_helper,
                                   train_config.reg_fc_dropout, model_config.forward_controls_loss,
                                   model_config.params_reg_softmax)
    else:
        raise NotImplementedError(f"Synth param regression arch '{arch}' not implemented")
    model = ExtendedAE(ae_model, reg_model)
    return init_like_flax(model, torch.Generator().manual_seed(seed))
