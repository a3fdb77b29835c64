"""Latent-space preset interpolation (sound morphing).

Counterpart: ``preset_gen_vae_tpu/evaluation/interpolate.py:29-130``. Walk
the VAE latent space between two sounds and decode every point into a
playable synth preset: encode both items' spectrograms to z0 = mu (eval
mode, reference VAE.py:181), slerp or lerp between the two latents, push
each point through the latent flow and the regression head, map the
learnable presets to full ones, and render them on the C++ engine, as the
JAX function does.

The port's dataset serves its items from ``corpus_tensors()`` (it has no
``__getitem__``): each UID's first item, its first note when the notes are
not stacked (interpolate.py:81-89 there). As in the JAX package the model
must have a latent flow: ``BasicVAE`` has no ``encode``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import config as cfg
from ..device import resolve_device
from ..logs.logger import load_checkpoint
from ..models.build import build_extended_ae_model
from ..models.vae import FlowVAE
from ..training.loop import prepare_dataset
from ..training.train_step import autocast


def slerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Spherical interpolation between two latent vectors; falls back to
    lerp when the vectors are (near-)colinear. t: (n,) in [0, 1]."""
    a_n = a / np.linalg.norm(a)
    b_n = b / np.linalg.norm(b)
    dot = float(np.clip(np.dot(a_n, b_n), -1.0, 1.0))
    omega = np.arccos(dot)
    t = t[:, None]
    if omega < 1e-4:
        return (1.0 - t) * a[None] + t * b[None]
    so = np.sin(omega)
    return (np.sin((1.0 - t) * omega) / so) * a[None] + (np.sin(t * omega) / so) * b[None]


def interpolate_presets(model_config: cfg.ModelConfig, train_config: cfg.TrainConfig,
                        uid_a: int, uid_b: int, n_steps: int = 9, epoch: int = -1,
                        mode: str = "slerp", dataset=None, render: bool = True, device="cuda",
                        dataset_kwargs: Optional[Dict] = None
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """-> (full presets (n_steps, 155), waveforms (n_steps, samples) or
    None). The endpoints are the DECODED presets of the two items (not the
    ground truths), so the whole path lives in model space. ``device``
    defaults to the card; the dataset is built (its corpus pass, or its
    cache) unless one is given."""
    if mode not in ("slerp", "lerp"):
        raise ValueError(f"unknown interpolation mode '{mode}'")
    dev = resolve_device(device)
    model_c, train_c = cfg.resolve(model_config, train_config)
    model_c, train_c, dataset = prepare_dataset(model_c, train_c, dev, dataset, dataset_kwargs)
    model = build_extended_ae_model(model_c, train_c, dataset.preset_indexes_helper).to(dev)
    if not isinstance(model.ae_model, FlowVAE):
        raise ValueError("interpolation encodes through FlowVAE.encode: the model needs a "
                         "latent flow (latent_flow_arch)")
    model.load_state_dict(load_checkpoint(model_c, epoch)["state"]["model"])
    model.eval()

    tensors = dataset.corpus_tensors()
    per = (dataset.midi_notes_per_preset if dataset.midi_notes_per_preset > 1
           and not dataset.multichannel_stacked_spectrograms else 1)
    rows = torch.tensor([dataset._uid_to_row[int(u)] * per for u in (uid_a, uid_b)],
                        device=dev)
    x, info = tensors["x"][rows].float(), tensors["info"][rows]
    with torch.no_grad(), autocast(dev, train_c):
        mu = model.ae_model.encode(x, info)[:, 0, :].float().cpu().numpy()
    t = np.linspace(0.0, 1.0, n_steps).astype(np.float32)
    if mode == "slerp":
        z_path = slerp(mu[0], mu[1], t)
    else:
        z_path = (1.0 - t[:, None]) * mu[0][None] + t[:, None] * mu[1][None]
    z = torch.from_numpy(np.asarray(z_path, dtype=np.float32)).to(dev)
    with torch.no_grad(), autocast(dev, train_c):
        zK, _ = model.ae_model.flow(z)
        v_path = model.reg_model(zK).float().cpu().numpy()
    full = dataset.preset_indexes_helper.learnable_to_full_batch(v_path)

    wavs = None
    if render:
        pitch, vel = (int(v) for v in info[0, 1:3].cpu())
        wavs = dataset.renderer.render_batch(full, np.full(n_steps, pitch, np.int32),
                                             np.full(n_steps, vel, np.int32))
    return full, wavs
