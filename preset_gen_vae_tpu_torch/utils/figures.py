"""Copy of ``preset_gen_vae_tpu/utils/figures.py:18-206``, the JAX
package's counterpart, unchanged apart from this paragraph, ``_pyplot`` and
its first line in each function: matplotlib is imported when a figure is
drawn, not when the module is imported (the card's machine has none; the
loop draws only where TensorBoard writes), and ``plot_synth_preset_error``
reads the port's own ``synth/dexed_params.py``.

TensorBoard figure plots (reference: utils/figures.py:42-334).

Same figure families: GT/reconstructed spectrogram grids, latent-mu
boxplots, Spearman-correlation matrices, per-parameter preset error
boxplots with quantization-step overlays and operator-group separators.
matplotlib only (the reference additionally uses librosa.display/seaborn
for styling, which changes nothing about the content)."""

from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_train_spectrograms(
    x_in, x_out, sample_info=None, max_cols: int = 4
):
    """GT (top row) vs reconstructed (bottom row) spectrograms
    (reference: utils/figures.py:42-117)."""
    plt = _pyplot()
    x_in = np.asarray(x_in)
    x_out = np.asarray(x_out)
    n = min(x_in.shape[0], max_cols)
    fig, axes = plt.subplots(2, n, figsize=(3 * n, 5), squeeze=False)
    vmin = min(x_in.min(), x_out.min())
    vmax = max(x_in.max(), x_out.max())
    for i in range(n):
        for row, x in enumerate((x_in, x_out)):
            img = x[i, 0] if x.ndim == 4 else x[i]
            axes[row][i].imshow(
                img, origin="lower", aspect="auto", cmap="magma",
                vmin=vmin, vmax=vmax,
            )
            axes[row][i].set_xticks([])
            axes[row][i].set_yticks([])
        title = f"item {i}"
        if sample_info is not None:
            si = np.asarray(sample_info)
            title = f"UID {si[i, 0]} p{si[i, 1]} v{si[i, 2]}"
        axes[0][i].set_title(title, fontsize=8)
    axes[0][0].set_ylabel("GT")
    axes[1][0].set_ylabel("Reconstructed")
    fig.tight_layout()
    return fig, axes


def plot_latent_distributions_stats(latent_metric, max_dims: int = 64):
    """Boxplots of per-dimension z0 mu distributions
    (reference: utils/figures.py:120-136)."""
    plt = _pyplot()
    z = latent_metric.get_z("mu")
    d = min(z.shape[1], max_dims)
    fig, ax = plt.subplots(1, 1, figsize=(max(6, d * 0.12), 4))
    ax.boxplot(list(z[:, :d].T), showfliers=False)
    ax.set_xlabel("latent dimension")
    ax.set_ylabel(r"$\mu(z_0)$")
    ax.set_xticks(range(1, d + 1, max(1, d // 16)))
    fig.tight_layout()
    return fig, ax


def plot_spearman_correlation(latent_metric):
    """|Spearman r| matrix + entanglement scalar in the title
    (reference: utils/figures.py:139-159)."""
    plt = _pyplot()
    r = np.abs(latent_metric.get_spearman_corr())
    fig, ax = plt.subplots(1, 1, figsize=(5, 4))
    im = ax.matshow(r, cmap="viridis", vmin=0.0, vmax=1.0)
    fig.colorbar(im, ax=ax)
    ax.set_title(
        f"|Spearman r|, entanglement={latent_metric.get():.3f}", fontsize=9
    )
    fig.tight_layout()
    return fig, ax


def plot_synth_preset_param(
    ref_preset, inferred_preset=None, preset_UID=None, idx_helper=None
):
    """Fader-style scatter of ONE full (VSTi-representation) preset, GT vs
    optionally inferred, with per-param quantization-step overlays and
    learnable/fixed coloring (reference: utils/figures.py:166-221; the
    reference takes a dataset for metadata — here the PresetIndexesHelper
    carries the same spec: names, cardinalities, learnable mask)."""
    plt = _pyplot()
    ref_preset = np.asarray(ref_preset, dtype=np.float32)
    P = len(ref_preset)
    if inferred_preset is not None:
        inferred_preset = np.asarray(inferred_preset, dtype=np.float32)
        assert len(inferred_preset) == P
    fig, ax = plt.subplots(1, 1, figsize=(max(8, P * 0.09), 4))
    learnable = np.ones(P, dtype=bool)
    names = None
    if idx_helper is not None:
        learnable = np.asarray(
            [idx_helper.full_to_learnable[i] is not None for i in range(P)]
        )
        names = idx_helper.vst_param_names
        # quantized-step overlays (discrete params, reference :179-189)
        for i in range(P):
            card = int(idx_helper.vst_param_cardinals[i])
            if 2 <= card <= 33:
                steps = np.linspace(0.0, 1.0, num=card)
                ax.scatter(np.full(card, i), steps, marker="_",
                           color="lightgrey", s=14, zorder=1)
    ax.scatter(np.arange(P)[learnable], ref_preset[learnable],
               color="tab:blue", s=12, zorder=3, label="GT (learnable)")
    if (~learnable).any():
        ax.scatter(np.arange(P)[~learnable], ref_preset[~learnable],
                   color="grey", s=12, zorder=2, label="GT (fixed)")
    if inferred_preset is not None:
        ax.scatter(np.arange(P)[learnable], inferred_preset[learnable],
                   color="tab:orange", s=12, zorder=4, marker="x",
                   label="inferred")
    # vertical "fader" separators (reference :218)
    for xx in np.arange(P + 1) - 0.5:
        ax.axvline(xx, color="k", lw=0.2, alpha=0.3)
    ax.set_xlim(-0.5, P - 0.5)
    ax.set_ylim(-0.05, 1.05)
    ax.set_ylabel("Param. value")
    step = max(1, P // 24)
    ax.set_xticks(range(0, P, step))
    if names is not None:
        ax.set_xticklabels(
            [f"{i}.{names[i]}" for i in range(0, P, step)],
            rotation=90, fontsize=5,
        )
    if preset_UID is not None:
        ax.set_title(f"Preset UID={preset_UID} (VSTi numerical parameters)")
    ax.legend(fontsize=6, loc="upper right")
    fig.tight_layout()
    return fig, ax


def plot_synth_learnable_preset(
    learnable_preset, idx_helper, preset_UID=None
):
    """Fader-style scatter of ONE preset in its LEARNABLE-tensor
    representation, with quantization steps per learnable slot
    (reference: utils/figures.py:242-270)."""
    plt = _pyplot()
    v = np.asarray(learnable_preset, dtype=np.float32)
    P = v.shape[0]
    assert P == idx_helper.learnable_preset_size
    fig, ax = plt.subplots(1, 1, figsize=(max(8, P * 0.06), 4))
    for i in range(P):
        steps = idx_helper.get_learnable_param_quantized_steps(i)
        if steps is not None and 2 <= len(steps) <= 33:
            ax.scatter(np.full(len(steps), i), steps, marker="_",
                       color="lightgrey", s=10, zorder=1)
    ax.scatter(np.arange(P), v, color="tab:blue", s=8, zorder=3)
    ax.set_xlim(-0.5, P - 0.5)
    ax.set_ylim(-0.05, 1.05)
    ax.set_ylabel("Param. value")
    ax.set_xlabel("learnable slot")
    ax.set_xticks(range(0, P, max(1, P // 24)))
    if preset_UID is not None:
        ax.set_title(f"Preset UID={preset_UID} (learnable parameters)")
    fig.tight_layout()
    return fig, ax


def plot_synth_preset_error(
    v_error: np.ndarray, idx_helper=None, max_params: int = 155
):
    """Per-learnable-parameter error boxplots; operator-block separators for
    Dexed (reference: utils/figures.py:168-334)."""
    plt = _pyplot()
    v_error = np.asarray(v_error)
    # collapse categorical groups to their first slot for readability
    if idx_helper is not None:
        cols = list(idx_helper.num_learn_idx) + list(idx_helper.cat_group_start)
        cols = sorted(int(c) for c in cols)[:max_params]
        data = v_error[:, cols]
    else:
        data = v_error[:, :max_params]
    P = data.shape[1]
    fig, ax = plt.subplots(1, 1, figsize=(max(8, P * 0.09), 4))
    ax.boxplot(list(data.T), showfliers=False)
    ax.axhline(0.0, color="k", lw=0.5)
    # quantization-step overlays for discrete numerical params
    # (reference: utils/figures.py:296-320 draws the +/- one-step band)
    if idx_helper is not None:
        for pos, c in enumerate(cols):
            steps = idx_helper.get_learnable_param_quantized_steps(int(c))
            if steps is not None and 2 <= len(steps) <= 33:
                half = 0.5 * (steps[1] - steps[0])
                ax.plot([pos + 0.7, pos + 1.3], [half, half],
                        color="tab:orange", lw=0.6)
                ax.plot([pos + 0.7, pos + 1.3], [-half, -half],
                        color="tab:orange", lw=0.6)
    if idx_helper is not None and idx_helper.synth_name.lower() == "dexed":
        from ..synth import dexed_params as dx

        # vertical separators between operator parameter blocks
        for op in range(1, 7):
            first_vst = dx.op_param_index(op, 0)
            pos = np.searchsorted(
                [idx_helper.learnable_to_full[c] if c < len(idx_helper.learnable_to_full) else 1e9
                 for c in range(P)],
                first_vst,
            )
            if 0 < pos < P:
                ax.axvline(pos + 0.5, color="grey", lw=0.5, ls="--")
    ax.set_xlabel("learnable parameter")
    ax.set_ylabel("error (inferred - GT)")
    ax.set_xticks(range(1, P + 1, max(1, P // 24)))
    fig.tight_layout()
    return fig, ax
