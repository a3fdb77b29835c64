"""The synthetic, seeded DX7 preset corpus: ``generate_structured_corpus``,
copied from ``preset_gen_vae_tpu/synth/database.py:146-289``; the code is unchanged.

The default ``DexedDataset`` uses it when no preset database is given
(``preset_gen_vae_tpu/data/dexed_dataset.py:107-121``). The SQLite reader,
the other generators and the export helpers wait for a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import dexed_params as dx

LABELS_VOCAB = ("harmonic", "percussive", "sfx")  # reference: synth/dexed.py:205-206


def generate_structured_corpus(
    n_presets: int, seed: int = 0, algos: Optional[Sequence[int]] = None
) -> Tuple[np.ndarray, List[str], List[str]]:
    """Deterministic *structured* synthetic DX7 corpus.

    Stand-in for the reference's 30k human-made preset DB (its
    synth/dexed_presets.sqlite ships as a git-lfs pointer).
    Unlike ``generate_random_corpus`` (uniform draws), presets are sampled
    algorithm-aware, reproducing the *structure* of human DX7 patches:

      - carriers (per-algorithm, dexed_params.ALGORITHM_CARRIER_MASKS) get
        audible priors — high output level, fast-ish attack to full, a
        sustained-vs-percussive bimodal sustain level, release to silence,
        bounded key-scaling/velocity attenuation;
      - modulators get broad level priors (the FM-index/brightness axis),
        varied EG shapes, occasional fixed-frequency mode;
      - low harmonic ratios dominate the coarse-frequency distribution;
      - detune concentrates near center; LFO depths and pitch-EG excursions
        are mostly subtle, occasionally strong.

    Labels follow the carrier envelope: 'percussive' when carriers decay to
    a low sustain, 'sfx' for fixed-mode/heavy-feedback patches, 'harmonic'
    otherwise (vocab parity: reference synth/dexed.py:205-206).

    All discrete params land exactly on their quantized grid (one-hot
    round-trips are exact); goal: <1% near-silent ground-truth renders.
    """
    rng = np.random.default_rng(seed ^ 0x5EED5)
    n = int(n_presets)
    p = rng.random((n, dx.N_PARAMS)).astype(np.float32)

    def u(lo, hi, size=n):
        return (lo + (hi - lo) * rng.random(size)).astype(np.float32)

    def mix(mask, a, b):
        return np.where(mask, a, b).astype(np.float32)

    # ---- algorithm + carrier layout
    allowed = np.asarray(algos, dtype=np.int64) if algos else np.arange(1, 33)
    alg = rng.choice(allowed, n)
    p[:, dx.IDX_ALGORITHM] = (alg - 1).astype(np.float32) / 31.0
    masks = np.asarray([dx.ALGORITHM_CARRIER_MASKS[a - 1] for a in alg])
    carrier = ((masks[:, None] >> np.arange(6)[None, :]) & 1).astype(bool)

    # ---- global block
    p[:, dx.IDX_FEEDBACK] = rng.integers(0, 8, n) / 7.0
    p[:, dx.IDX_LFO_SPEED] = u(0.15, 0.75)
    p[:, dx.IDX_LFO_DELAY] = mix(rng.random(n) < 0.7, u(0.0, 0.2), u(0.0, 1.0))
    subtle = rng.random(n) < 0.7
    p[:, dx.IDX_LFO_PM_DEPTH] = mix(subtle, u(0.0, 0.1), u(0.0, 0.6))
    p[:, dx.IDX_LFO_AM_DEPTH] = mix(rng.random(n) < 0.8, u(0.0, 0.1), u(0.0, 0.8))
    p[:, dx.IDX_PITCH_MOD_SENS] = rng.choice(
        np.arange(8), n, p=[0.25, 0.2, 0.2, 0.15, 0.1, 0.05, 0.03, 0.02]
    ) / 7.0
    # pitch EG: mostly neutral (level 50 = no shift), sometimes gentle sweeps
    neutral_peg = (rng.random(n) < 0.85)[:, None]
    peg_levels = np.clip(
        50.0 / 99.0 + rng.normal(0.0, 8.0 / 99.0, (n, 4)).astype(np.float32),
        0.0, 1.0,
    )
    p[:, dx.IDX_PITCH_EG_FIRST + 4 : dx.IDX_PITCH_EG_FIRST + 8] = np.where(
        neutral_peg, np.float32(50.0 / 99.0), peg_levels
    )

    # ---- per-operator blocks
    # sustained (pad/organ) vs percussive (bell/pluck) preset character
    percussive = rng.random(n) < 0.4
    coarse_probs = np.asarray(
        [0.06, 0.30, 0.18, 0.10, 0.08, 0.05, 0.04, 0.03] + [0.16 / 24] * 24
    )
    for op in range(1, 7):
        b = dx.op_param_index(op, 0)
        c = carrier[:, op - 1]
        # frequency: low harmonic ratios dominate; a few fixed-mode modulators
        p[:, b + dx.OFF_FREQ_COARSE] = rng.choice(
            np.arange(32), n, p=coarse_probs / coarse_probs.sum()
        ) / 31.0
        p[:, b + dx.OFF_FREQ_FINE] = mix(rng.random(n) < 0.7, 0.0, u(0.0, 1.0))
        p[:, b + dx.OFF_MODE] = mix(~c & (rng.random(n) < 0.05), 1.0, 0.0)
        p[:, b + dx.OFF_DETUNE] = np.clip(
            np.rint(7.0 + rng.normal(0.0, 2.0, n)), 0, 14
        ).astype(np.float32) / 14.0
        # output level: carriers loud; modulators span the brightness axis
        mod_lvl = mix(rng.random(n) < 0.45, u(0.55, 0.95), u(0.1, 0.75))
        p[:, b + dx.OFF_OUTPUT_LEVEL] = mix(c, u(0.86, 1.0), mod_lvl)
        # EG: attack to (near-)full...
        p[:, b + dx.OFF_EG_RATES[0]] = mix(
            c, mix(rng.random(n) < 0.9, u(0.6, 1.0), u(0.3, 0.6)), u(0.4, 1.0)
        )
        p[:, b + dx.OFF_EG_LEVELS[0]] = mix(c, u(0.9, 1.0), u(0.7, 1.0))
        # ...through a decay stage...
        p[:, b + dx.OFF_EG_RATES[1]] = u(0.3, 0.8)
        p[:, b + dx.OFF_EG_LEVELS[1]] = mix(c, u(0.7, 1.0), u(0.4, 1.0))
        # ...to a sustained or percussive sustain level...
        p[:, b + dx.OFF_EG_RATES[2]] = u(0.3, 0.7)
        sus_car = mix(percussive, u(0.0, 0.4), u(0.6, 1.0))
        p[:, b + dx.OFF_EG_LEVELS[2]] = mix(c, sus_car, u(0.0, 1.0))
        # ...and a release to silence
        p[:, b + dx.OFF_EG_RATES[3]] = u(0.25, 0.8)
        p[:, b + dx.OFF_EG_LEVELS[3]] = mix(rng.random(n) < 0.95, 0.0, u(0.0, 0.2))
        # key scaling: subtle on carriers (a deep random depth can silence
        # the note entirely), broader on modulators
        ks_on = rng.random(n) < 0.3
        p[:, b + dx.OFF_L_DEPTH] = mix(
            ks_on, mix(c, u(0.0, 0.3), u(0.0, 0.6)), 0.0
        )
        p[:, b + dx.OFF_R_DEPTH] = mix(
            ks_on, mix(c, u(0.0, 0.3), u(0.0, 0.6)), 0.0
        )
        p[:, b + dx.OFF_BREAKPOINT] = np.clip(
            39.0 / 99.0 + rng.normal(0.0, 15.0 / 99.0, n), 0.0, 1.0
        ).astype(np.float32)
        p[:, b + dx.OFF_RATE_SCALING] = rng.choice(
            np.arange(8), n, p=[0.45, 0.25, 0.15, 0.07, 0.04, 0.02, 0.01, 0.01]
        ) / 7.0
        p[:, b + dx.OFF_AMP_MOD_SENS] = rng.choice(
            np.arange(4), n, p=[0.7, 0.15, 0.1, 0.05]
        ) / 3.0
        kv_car = rng.choice(np.arange(8), n, p=[.4, .25, .2, .15, 0, 0, 0, 0])
        kv_mod = rng.integers(0, 8, n)
        p[:, b + dx.OFF_KEY_VELOCITY] = mix(c, kv_car, kv_mod) / 7.0

    # ---- snap every discrete param to its exact quantized grid
    card = dx.param_cardinalities()
    for i in np.nonzero(card > 0)[0]:
        c_i = max(int(card[i]) - 1, 1)
        p[:, i] = np.rint(p[:, i] * c_i) / c_i

    dx.set_default_general_filter_and_tune_params(p)
    dx.set_operators(p, [1, 2, 3, 4, 5, 6])
    dx.prevent_SH_LFO(p)

    # ---- labels from patch character
    fixed_any = np.zeros(n, dtype=bool)
    for op in range(1, 7):
        fixed_any |= p[:, dx.op_param_index(op, dx.OFF_MODE)] > 0.5
    heavy_fb = (p[:, dx.IDX_FEEDBACK] > 6.5 / 7.0) & (
        p[:, dx.IDX_LFO_PM_DEPTH] > 0.3
    )
    labels = np.where(
        fixed_any | heavy_fb, "sfx", np.where(percussive, "percussive", "harmonic")
    )
    names = [f"struct_{seed}_{i:06d}" for i in range(n)]
    return p, names, [str(l) for l in labels]
