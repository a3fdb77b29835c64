"""The synthetic, seeded DX7 preset corpora, copied from
``preset_gen_vae_tpu/synth/database.py``: the generators
``generate_structured_corpus`` (:146-289), ``generate_structured_corpus_v2``
(:292-498) and ``generate_random_corpus`` (:501-534). The code is
unchanged, apart from v2 reading ``ALGO_MOD_DEPTH`` from this package's
``fm_torch``; for a seed each generator returns the JAX package's presets
bit for bit. A generator is picked by ``synthetic_style``
(``'structured'``, ``'structured2'``, ``'uniform'``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import dexed_params as dx
from .fm_torch import ALGO_MOD_DEPTH

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


def generate_structured_corpus_v2(
    n_presets: int, seed: int = 0, algos: Optional[Sequence[int]] = None
) -> Tuple[np.ndarray, List[str], List[str]]:
    """Structured corpus, generation 2: v1's audible-role priors PLUS the
    two correlation families human DX7 patches actually have (round-2
    verdict's realism ask):

      1. **Modulation-depth-aware roles.** v1 only distinguished
         carrier/modulator; v2 walks each algorithm's modulation graph
         (synth/fm_torch.py ALGO_MOD_DEPTH, same public table the engines
         use) and scales priors by depth: depth-1 modulators span the
         brightness/FM-index axis, depth>=2 modulators are progressively
         quieter with mostly-low harmonic ratios — stacked near-full-level
         modulators turn FM into noise, which human patches avoid.
      2. **Patch archetypes (shared EG families).** Each preset draws one
         archetype (pad / pluck / keys / organ / bell / brass) that
         correlates ALL operators' envelopes: e.g. a pluck's modulators
         decay *faster* than its carriers (brightness fades first), a
         pad's modulators sustain, a bell pairs near-zero sustain with an
         inharmonic depth-1 ratio (coarse+fine). v1 drew modulator EGs
         iid, which no human patch bank does.

    Same contract as v1: discrete params land exactly on their quantized
    grid, constraints applied as in the reference dataset
    (dexeddataset.py:81-95), labels use the reference vocab
    (synth/dexed.py:205-206). Selected via ``synthetic_style=
    'structured2'`` (cache tags include the full style name).
    """
    rng = np.random.default_rng(seed ^ 0x5EED52)
    n = int(n_presets)
    p = rng.random((n, dx.N_PARAMS)).astype(np.float32)

    def u(lo, hi, size=n):
        return (lo + (hi - lo) * rng.random(size)).astype(np.float32)

    def mix(mask, a, b):
        return np.where(mask, a, b).astype(np.float32)

    # ---- algorithm, carrier layout, modulation depths
    allowed = np.asarray(algos, dtype=np.int64) if algos else np.arange(1, 33)
    alg = rng.choice(allowed, n)
    p[:, dx.IDX_ALGORITHM] = (alg - 1).astype(np.float32) / 31.0
    masks = np.asarray([dx.ALGORITHM_CARRIER_MASKS[a - 1] for a in alg])
    carrier = ((masks[:, None] >> np.arange(6)[None, :]) & 1).astype(bool)
    depth = ALGO_MOD_DEPTH[alg - 1]  # (n, 6)

    # ---- archetype draw (shared EG family per preset)
    ARCH = ("pad", "pluck", "keys", "organ", "bell", "brass")
    arch = rng.choice(np.arange(6), n, p=[0.20, 0.25, 0.20, 0.12, 0.11, 0.12])
    is_ = {name: arch == i for i, name in enumerate(ARCH)}
    percussive = is_["pluck"] | is_["bell"]

    # ---- global block (archetype-correlated LFO)
    fb_hi = is_["brass"] | (rng.random(n) < 0.15)
    p[:, dx.IDX_FEEDBACK] = mix(fb_hi, rng.integers(4, 8, n),
                                rng.integers(0, 5, n)) / 7.0
    p[:, dx.IDX_LFO_SPEED] = mix(is_["pad"], u(0.15, 0.45), u(0.25, 0.75))
    p[:, dx.IDX_LFO_DELAY] = mix(rng.random(n) < 0.7, u(0.0, 0.2), u(0.0, 1.0))
    vibrato = is_["brass"] | is_["keys"]
    p[:, dx.IDX_LFO_PM_DEPTH] = mix(vibrato & (rng.random(n) < 0.5),
                                    u(0.05, 0.25), u(0.0, 0.1))
    p[:, dx.IDX_LFO_AM_DEPTH] = mix(is_["organ"] & (rng.random(n) < 0.5),
                                    u(0.1, 0.5), u(0.0, 0.1))
    p[:, dx.IDX_PITCH_MOD_SENS] = rng.choice(
        np.arange(8), n, p=[0.25, 0.2, 0.2, 0.15, 0.1, 0.05, 0.03, 0.02]
    ) / 7.0
    neutral_peg = (rng.random(n) < 0.85)[:, None]
    peg_levels = np.clip(
        50.0 / 99.0 + rng.normal(0.0, 8.0 / 99.0, (n, 4)).astype(np.float32),
        0.0, 1.0,
    )
    p[:, dx.IDX_PITCH_EG_FIRST + 4 : dx.IDX_PITCH_EG_FIRST + 8] = np.where(
        neutral_peg, np.float32(50.0 / 99.0), peg_levels
    )

    # ---- per-preset envelope family parameters (carriers)
    #       attack     decay      sustain    release
    car_atk = np.select(
        [is_["pad"], is_["brass"]],
        [u(0.30, 0.55), u(0.45, 0.70)], default=u(0.70, 1.00))
    car_dcy = np.select(
        [is_["bell"], is_["pluck"], is_["keys"]],
        [u(0.20, 0.40), u(0.35, 0.60), u(0.30, 0.55)], default=u(0.40, 0.80))
    car_sus = np.select(
        [is_["pluck"] | is_["bell"], is_["keys"]],
        [u(0.00, 0.15), u(0.25, 0.60)], default=u(0.70, 1.00))
    car_rel = np.select(
        [is_["bell"] | is_["pad"], is_["organ"]],
        [u(0.20, 0.45), u(0.55, 0.90)], default=u(0.35, 0.70))
    # modulator EG family: plucks/bells lose brightness FASTER than
    # amplitude; pads keep modulators sustained
    mod_dcy = np.select(
        [is_["pluck"] | is_["bell"], is_["keys"]],
        [np.clip(car_dcy + u(0.10, 0.25), 0, 1), car_dcy], default=u(0.3, 0.7))
    mod_sus_frac = np.select(
        [is_["pluck"] | is_["bell"], is_["keys"], is_["pad"]],
        [u(0.00, 0.30), u(0.30, 0.80), u(0.85, 1.00)], default=u(0.6, 1.0))

    # ---- depth-1 inharmonicity (bells) and velocity response
    bell_fine = u(0.35, 0.48)  # ~x1.41 partials — classic FM bell
    kv_hi = is_["keys"] | is_["pluck"]

    coarse_car = rng.choice(np.arange(32), n,
                            p=[0.10, 0.62, 0.18, 0.05, 0.05] + [0.0] * 27)
    coarse_d1 = rng.choice(
        np.arange(32), n,
        p=[0.04, 0.28, 0.18, 0.14, 0.10, 0.08, 0.06, 0.05, 0.04, 0.03]
        + [0.0] * 22)
    coarse_deep = rng.choice(np.arange(32), n,
                             p=[0.08, 0.52, 0.25, 0.15] + [0.0] * 28)

    jit = rng.random  # per-op decorrelation jitter

    for op in range(1, 7):
        b = dx.op_param_index(op, 0)
        c = carrier[:, op - 1]
        d = depth[:, op - 1]
        d1, deep = (d == 1), (d >= 2)

        # frequency: carriers anchored near 1x; depth-1 the timbre axis
        # (inharmonic on bells); deeper modulators low ratios
        p[:, b + dx.OFF_FREQ_COARSE] = np.select(
            [c, d1], [coarse_car, coarse_d1], default=coarse_deep) / 31.0
        fine = mix(rng.random(n) < 0.8, 0.0, u(0.0, 0.5))
        p[:, b + dx.OFF_FREQ_FINE] = mix(d1 & is_["bell"], bell_fine, fine)
        p[:, b + dx.OFF_MODE] = mix(~c & (rng.random(n) < 0.04), 1.0, 0.0)
        p[:, b + dx.OFF_DETUNE] = np.clip(
            np.rint(7.0 + rng.normal(0.0, 2.0, n)), 0, 14
        ).astype(np.float32) / 14.0

        # output level by role: carriers loud; depth-1 = FM-index axis;
        # deeper stacks progressively quieter (depth>=2 near-full levels
        # produce noise, rare in human banks)
        lvl_d1 = mix(rng.random(n) < 0.5, u(0.55, 0.95), u(0.25, 0.75))
        lvl_deep = np.clip(
            u(0.15, 0.80) - 0.12 * (d - 2).clip(0, 3), 0.0, 1.0)
        p[:, b + dx.OFF_OUTPUT_LEVEL] = np.select(
            [c, d1], [u(0.86, 1.0), lvl_d1], default=lvl_deep)

        # envelopes: the preset's family value + small per-op jitter
        def fam(base_v, spread):
            return np.clip(
                base_v + (jit(n).astype(np.float32) - 0.5) * spread, 0.0, 1.0)

        p[:, b + dx.OFF_EG_RATES[0]] = mix(c, fam(car_atk, 0.10),
                                           fam(np.clip(car_atk + 0.1, 0, 1),
                                               0.20))
        p[:, b + dx.OFF_EG_LEVELS[0]] = mix(c, u(0.9, 1.0), u(0.7, 1.0))
        p[:, b + dx.OFF_EG_RATES[1]] = mix(c, fam(car_dcy, 0.10),
                                           fam(mod_dcy, 0.12))
        p[:, b + dx.OFF_EG_LEVELS[1]] = mix(c, u(0.7, 1.0), u(0.5, 1.0))
        p[:, b + dx.OFF_EG_RATES[2]] = fam(mix(c, car_dcy, mod_dcy), 0.15)
        sus_car = fam(car_sus, 0.10)
        p[:, b + dx.OFF_EG_LEVELS[2]] = mix(
            c, sus_car, np.clip(sus_car * mod_sus_frac
                                + (jit(n).astype(np.float32) - 0.5) * 0.1,
                                0, 1))
        p[:, b + dx.OFF_EG_RATES[3]] = fam(mix(c, car_rel,
                                               np.clip(car_rel + 0.1, 0, 1)),
                                           0.10)
        p[:, b + dx.OFF_EG_LEVELS[3]] = mix(rng.random(n) < 0.95, 0.0,
                                            u(0.0, 0.2))

        # key scaling / sensitivities (as v1, velocity archetype-biased)
        ks_on = rng.random(n) < 0.3
        p[:, b + dx.OFF_L_DEPTH] = mix(ks_on, mix(c, u(0.0, 0.3),
                                                  u(0.0, 0.6)), 0.0)
        p[:, b + dx.OFF_R_DEPTH] = mix(ks_on, mix(c, u(0.0, 0.3),
                                                  u(0.0, 0.6)), 0.0)
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
        kv_mod = mix(kv_hi, rng.integers(2, 8, n), rng.integers(0, 8, n))
        p[:, b + dx.OFF_KEY_VELOCITY] = mix(c, kv_car, kv_mod) / 7.0

    # ---- snap every discrete param to its exact quantized grid
    card = dx.param_cardinalities()
    for i in np.nonzero(card > 0)[0]:
        c_i = max(int(card[i]) - 1, 1)
        p[:, i] = np.rint(p[:, i] * c_i) / c_i

    dx.set_default_general_filter_and_tune_params(p)
    dx.set_operators(p, [1, 2, 3, 4, 5, 6])
    dx.prevent_SH_LFO(p)

    # ---- labels (reference vocab, synth/dexed.py:205-206)
    fixed_any = np.zeros(n, dtype=bool)
    for op in range(1, 7):
        fixed_any |= p[:, dx.op_param_index(op, dx.OFF_MODE)] > 0.5
    heavy_fb = (p[:, dx.IDX_FEEDBACK] > 6.5 / 7.0) & (
        p[:, dx.IDX_LFO_PM_DEPTH] > 0.3
    )
    labels = np.where(
        fixed_any | heavy_fb, "sfx",
        np.where(percussive, "percussive", "harmonic"),
    )
    names = [f"struct2_{seed}_{i:06d}" for i in range(n)]
    return p, names, [str(l) for l in labels]


def generate_random_corpus(
    n_presets: int, seed: int = 0, algos: Optional[Sequence[int]] = None
) -> Tuple[np.ndarray, List[str], List[str]]:
    """Deterministic plausible DX7 preset corpus.

    Continuous params ~ U[0,1]; discrete params land exactly on their
    quantized grid (so one-hot round-trips are exact); operator output
    levels biased upward so most presets are audible; constraints applied as
    in the reference dataset (constant filter/tune, all ops on, no S&H LFO;
    reference: dexeddataset.py:81-95, synth/dexed.py:298-357).
    """
    rng = np.random.default_rng(seed)
    p = rng.random((n_presets, dx.N_PARAMS)).astype(np.float32)
    card = dx.param_cardinalities()
    for i in np.nonzero(card > 0)[0]:
        c = int(card[i])
        p[:, i] = rng.integers(0, c, n_presets).astype(np.float32) / max(c - 1, 1)
    if algos:
        a = np.asarray(algos, dtype=np.float32) - 1.0
        p[:, dx.IDX_ALGORITHM] = rng.choice(a, n_presets) / 31.0
    # audible bias: carrier levels high, EG sustain above silence
    vol_idx = dx.operator_volume_indexes()
    p[:, vol_idx] = 0.5 + 0.5 * rng.random((n_presets, len(vol_idx))).astype(np.float32)
    for op in range(1, 7):
        b = dx.op_param_index(op, 0)
        p[:, b + dx.OFF_EG_LEVELS[0]] = 0.7 + 0.3 * rng.random(n_presets).astype(np.float32)
        p[:, b + dx.OFF_EG_LEVELS[2]] = 0.5 + 0.5 * rng.random(n_presets).astype(np.float32)
        p[:, b + dx.OFF_EG_RATES[0]] = 0.5 + 0.5 * rng.random(n_presets).astype(np.float32)
    dx.set_default_general_filter_and_tune_params(p)
    dx.set_operators(p, [1, 2, 3, 4, 5, 6])
    dx.prevent_SH_LFO(p)
    names = [f"rnd_{seed}_{i:06d}" for i in range(n_presets)]
    labels = [LABELS_VOCAB[int(i)] for i in rng.integers(0, 3, n_presets)]
    return p, names, labels
