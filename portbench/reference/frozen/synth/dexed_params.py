"""Copy of ``preset_gen_vae_tpu/synth/dexed_params.py``, the JAX package's counterpart,
unchanged apart from this line.

DX7 (Dexed) parameter metadata, as vectorized numpy tables.

The Dexed VST exposes 155 normalized parameters in [0, 1]. Parameters 0-22
are global (filter, tune, algorithm, feedback, LFO, pitch EG, ...), then six
operator blocks of 22 parameters each starting at index 23 (op i block:
``23 + 22*i .. 44 + 22*i``).

Semantics match the reference's metadata helpers (reference:
synth/dexed.py:359-452) but are built once as whole-preset numpy arrays so
downstream code (losses, one-hot encode/decode) is purely vectorized.

Per-operator block layout (offsets within a 22-param block, base = 23+22*i):
  +0..+3   EG rates 1-4        +4..+7   EG levels 1-4
  +8       output level        +9       mode (ratio/fixed)   [cat, card 2]
  +10      freq coarse         +11      freq fine
  +12      detune              +13      key scale breakpoint
  +14/+15  L/R scale depth     +16/+17  L/R scale curve      [cat, card 4]
  +18      rate scaling        +19      amp mod sensitivity
  +20      key velocity        +21      OP on/off switch     [cat, card 2]
"""

from __future__ import annotations

import numpy as np

N_PARAMS = 155
N_OPERATORS = 6
OP_BLOCK_SIZE = 22
OP_BASE = 23  # first parameter index of operator 1

# Global parameter indexes
IDX_CUTOFF, IDX_RESO, IDX_OUTPUT, IDX_MASTER_TUNE = 0, 1, 2, 3
IDX_ALGORITHM = 4
IDX_FEEDBACK = 5
IDX_OSC_KEY_SYNC = 6
IDX_LFO_SPEED, IDX_LFO_DELAY, IDX_LFO_PM_DEPTH, IDX_LFO_AM_DEPTH = 7, 8, 9, 10
IDX_LFO_KEY_SYNC = 11
IDX_LFO_WAVE = 12
IDX_TRANSPOSE = 13
IDX_PITCH_MOD_SENS = 14
IDX_PITCH_EG_FIRST = 15  # 15..22: pitch EG rates 1-4 then levels 1-4

# Per-operator offsets (within a 22-wide block)
OFF_EG_RATES = (0, 1, 2, 3)
OFF_EG_LEVELS = (4, 5, 6, 7)
OFF_OUTPUT_LEVEL = 8
OFF_MODE = 9
OFF_FREQ_COARSE = 10
OFF_FREQ_FINE = 11
OFF_DETUNE = 12
OFF_BREAKPOINT = 13
OFF_L_DEPTH, OFF_R_DEPTH = 14, 15
OFF_L_CURVE, OFF_R_CURVE = 16, 17
OFF_RATE_SCALING = 18
OFF_AMP_MOD_SENS = 19
OFF_KEY_VELOCITY = 20
OFF_SWITCH = 21


def op_param_index(op: int, offset: int) -> int:
    """VST index of per-operator parameter ``offset`` for operator ``op`` in 1..6."""
    return OP_BASE + OP_BLOCK_SIZE * (op - 1) + offset


def operator_switch_indexes() -> np.ndarray:
    """[44, 66, 88, 110, 132, 154] — OP on/off switches (synth/dexed.py:317)."""
    return np.array([op_param_index(i + 1, OFF_SWITCH) for i in range(N_OPERATORS)])


def operator_volume_indexes() -> np.ndarray:
    """[31, 53, ...] — OP output levels (used by useless-param masking,
    reference: data/preset.py:266)."""
    return np.array([op_param_index(i + 1, OFF_OUTPUT_LEVEL) for i in range(N_OPERATORS)])


def param_cardinalities() -> np.ndarray:
    """(155,) int array: number of discrete values per param, or -1 if the
    param is treated as continuous (reference: synth/dexed.py:385-422)."""
    card = np.full((N_PARAMS,), -1, dtype=np.int64)
    card[IDX_ALGORITHM] = 32
    card[IDX_FEEDBACK] = 8
    card[IDX_OSC_KEY_SYNC] = 2
    card[IDX_LFO_KEY_SYNC] = 2
    card[IDX_LFO_WAVE] = 6
    card[IDX_PITCH_MOD_SENS] = 8
    per_op = {
        OFF_MODE: 2,
        OFF_FREQ_COARSE: 32,
        OFF_DETUNE: 15,
        OFF_L_CURVE: 4,
        OFF_R_CURVE: 4,
        OFF_RATE_SCALING: 8,
        OFF_AMP_MOD_SENS: 4,
        OFF_KEY_VELOCITY: 8,
        OFF_SWITCH: 2,
    }
    for op in range(1, N_OPERATORS + 1):
        for off, c in per_op.items():
            card[op_param_index(op, off)] = c
    return card


def numerical_param_indexes() -> list:
    """VST indexes of *numerical* params — those whose values lie on an
    ordered scale, even when discrete (reference: synth/dexed.py:425-442)."""
    idx = [IDX_CUTOFF, IDX_RESO, IDX_OUTPUT, IDX_MASTER_TUNE, IDX_FEEDBACK,
           IDX_LFO_SPEED, IDX_LFO_DELAY, IDX_LFO_PM_DEPTH, IDX_LFO_AM_DEPTH,
           IDX_TRANSPOSE, IDX_PITCH_MOD_SENS]
    idx += list(range(IDX_PITCH_EG_FIRST, IDX_PITCH_EG_FIRST + 8))
    for op in range(1, N_OPERATORS + 1):
        for off in (*OFF_EG_RATES, *OFF_EG_LEVELS, OFF_OUTPUT_LEVEL,
                    OFF_FREQ_COARSE, OFF_FREQ_FINE, OFF_DETUNE, OFF_BREAKPOINT,
                    OFF_L_DEPTH, OFF_R_DEPTH, OFF_RATE_SCALING,
                    OFF_AMP_MOD_SENS, OFF_KEY_VELOCITY):
            idx.append(op_param_index(op, off))
    return idx


def categorical_param_indexes() -> list:
    """VST indexes of *categorical* params — unordered choices
    (reference: synth/dexed.py:445-452)."""
    idx = [IDX_ALGORITHM, IDX_OSC_KEY_SYNC, IDX_LFO_KEY_SYNC, IDX_LFO_WAVE]
    for op in range(1, N_OPERATORS + 1):
        for off in (OFF_MODE, OFF_L_CURVE, OFF_R_CURVE, OFF_SWITCH):
            idx.append(op_param_index(op, off))
    return idx


# Carrier sets of the 32 DX7 algorithms (public hardware spec; must match
# the engine's routing table, csrc/dx7/dx7_engine.cc kAlgos). Bit i-1 set =
# operator i sums into the audio output; all other enabled ops are
# modulators. Used by the structured synthetic-preset generator to give
# carriers audible level/EG priors.
ALGORITHM_CARRIER_MASKS = (
    0b000101, 0b000101, 0b001001, 0b001001, 0b010101, 0b010101,  # 1-6
    0b000101, 0b000101, 0b000101, 0b001001, 0b001001, 0b000101,  # 7-12
    0b000101, 0b000101, 0b000101, 0b000001, 0b000001, 0b000001,  # 13-18
    0b011001, 0b001011, 0b011011, 0b011101, 0b011011, 0b011111,  # 19-24
    0b011111, 0b001011, 0b001011, 0b100101, 0b010111, 0b100111,  # 25-30
    0b011111, 0b111111,                                          # 31-32
)


def midi_key_related_param_indexes() -> list:
    """Params whose effect depends on the played MIDI key/velocity
    (reference: synth/dexed.py:360-374)."""
    idx = []
    for off in (OFF_BREAKPOINT, OFF_L_DEPTH, OFF_R_DEPTH, OFF_L_CURVE,
                OFF_R_CURVE, OFF_RATE_SCALING, OFF_KEY_VELOCITY):
        idx += [op_param_index(op, off) for op in range(1, N_OPERATORS + 1)]
    return sorted(idx)


def mod_wheel_related_param_indexes() -> list:
    """Params whose effect depends on the MIDI mod wheel
    (reference: synth/dexed.py:377-382)."""
    return [op_param_index(op, OFF_AMP_MOD_SENS) for op in range(1, N_OPERATORS + 1)] + [
        IDX_PITCH_MOD_SENS
    ]


# ------------------------------------------------------------------
# Preset constraint mutators (vectorized; reference: synth/dexed.py:298-357)
# ------------------------------------------------------------------


def set_default_general_filter_and_tune_params(preset: np.ndarray) -> None:
    """In-place: cutoff=1, reso=0, output=1, master tune=0.5, transpose=0.5
    (reference: synth/dexed.py:309-312)."""
    preset[..., [IDX_CUTOFF, IDX_RESO, IDX_OUTPUT, IDX_MASTER_TUNE, IDX_TRANSPOSE]] = np.array(
        [1.0, 0.0, 1.0, 0.5, 0.5]
    )


def set_operators(preset: np.ndarray, operators_on) -> None:
    """In-place: enables exactly the given operators (1..6), disables the rest
    (reference: synth/dexed.py:334-343)."""
    switches = operator_switch_indexes()
    preset[..., switches] = 0.0
    for op in operators_on:
        preset[..., switches[op - 1]] = 1.0


def prevent_SH_LFO(preset: np.ndarray) -> None:
    """In-place: replaces a random S&H LFO wave (param 12 > 0.95) by a square
    wave (4/5) so renders stay deterministic (reference: synth/dexed.py:353-357)."""
    sh = preset[..., IDX_LFO_WAVE] > 0.95
    preset[..., IDX_LFO_WAVE] = np.where(sh, 4.0 / 5.0, preset[..., IDX_LFO_WAVE])
