"""The DX7 FM engine's plain PyTorch version: the decode, the control pass
and the audio-rate operators that the reference's render is made of.

Counterpart: ``preset_gen_vae_tpu/synth/fm_jax.py``, the JAX package's
differentiable on-device render. Same decode laws, EG state machine, LFO
(with its sample-and-hold LCG), algorithm table, feedback and fade-out; the
JAX package is the reference, so the sine is the true ``sin(2 pi x)`` and
not the C++ engine's interpolated table.

``_prepare`` decodes a batch of presets into the per-item constants of the
control pass (``control_params``: one (B, CTL_WIDTH) float32 row per
item); ``control_pass`` walks the 32-sample ticks as a Python loop into
(T, B, 6) per-tick arrays; ``sample_phases``, ``upsample_amps``,
``feedforward_pass`` and ``fade_and_volume`` make the audio. The feedback
loop's operators are the caller's (``portbench/reference/corpus.py``).
"""

from __future__ import annotations

import numpy as np
import torch

N_OPS = 6
BLOCK = 32  # control-rate block (samples), as in dx7_engine.cc
ENGINE_BLOCK = 512  # render length rounds up to this (dx7_engine.cc:295)
MOD_INDEX_MAX = 4.0
AMS_DB = np.array([0.0, 1.6, 4.8, 12.0], dtype=np.float32)
PMS_SEMIS = np.array([0.0, 0.09, 0.20, 0.43, 0.87, 1.79, 3.66, 7.0], dtype=np.float32)
SH_SEED = 0x12345678  # the S&H LCG's state at note-on (fm_jax.py:336)


# ---------------------------------------------------------------------------
# Algorithm table (public DX7 spec; fm_jax.py:56-127, dx7_engine.cc:155-188)
# ---------------------------------------------------------------------------
_ALGOS = [
    # (edges [(mod, car), ...] 1-based, carrier bitmask, fb_src, fb_dst)
    ([(2, 1), (4, 3), (5, 4), (6, 5)], 0b000101, 6, 6),
    ([(2, 1), (4, 3), (5, 4), (6, 5)], 0b000101, 2, 2),
    ([(2, 1), (3, 2), (5, 4), (6, 5)], 0b001001, 6, 6),
    ([(2, 1), (3, 2), (5, 4), (6, 5)], 0b001001, 4, 6),
    ([(2, 1), (4, 3), (6, 5)], 0b010101, 6, 6),
    ([(2, 1), (4, 3), (6, 5)], 0b010101, 5, 6),
    ([(2, 1), (4, 3), (5, 3), (6, 5)], 0b000101, 6, 6),
    ([(2, 1), (4, 3), (5, 3), (6, 5)], 0b000101, 4, 4),
    ([(2, 1), (4, 3), (5, 3), (6, 5)], 0b000101, 2, 2),
    ([(2, 1), (3, 2), (5, 4), (6, 4)], 0b001001, 3, 3),
    ([(2, 1), (3, 2), (5, 4), (6, 4)], 0b001001, 6, 6),
    ([(2, 1), (4, 3), (5, 3), (6, 3)], 0b000101, 2, 2),
    ([(2, 1), (4, 3), (5, 3), (6, 3)], 0b000101, 6, 6),
    ([(2, 1), (4, 3), (5, 4), (6, 4)], 0b000101, 6, 6),
    ([(2, 1), (4, 3), (5, 4), (6, 4)], 0b000101, 2, 2),
    ([(2, 1), (3, 1), (5, 1), (4, 3), (6, 5)], 0b000001, 6, 6),
    ([(2, 1), (3, 1), (5, 1), (4, 3), (6, 5)], 0b000001, 2, 2),
    ([(2, 1), (3, 1), (4, 1), (5, 4), (6, 5)], 0b000001, 3, 3),
    ([(2, 1), (3, 2), (6, 4), (6, 5)], 0b011001, 6, 6),
    ([(3, 1), (3, 2), (5, 4), (6, 4)], 0b001011, 3, 3),
    ([(3, 1), (3, 2), (6, 4), (6, 5)], 0b011011, 3, 3),
    ([(2, 1), (6, 3), (6, 4), (6, 5)], 0b011101, 6, 6),
    ([(3, 2), (6, 4), (6, 5)], 0b011011, 6, 6),
    ([(6, 3), (6, 4), (6, 5)], 0b011111, 6, 6),
    ([(6, 4), (6, 5)], 0b011111, 6, 6),
    ([(3, 2), (5, 4), (6, 4)], 0b001011, 6, 6),
    ([(3, 2), (5, 4), (6, 4)], 0b001011, 3, 3),
    ([(2, 1), (4, 3), (5, 4)], 0b100101, 5, 5),
    ([(4, 3), (6, 5)], 0b010111, 6, 6),
    ([(4, 3), (5, 4)], 0b100111, 5, 5),
    ([(6, 5)], 0b011111, 6, 6),
    ([], 0b111111, 6, 6),
]


def _build_algo_tables():
    adj = np.zeros((32, N_OPS, N_OPS), dtype=np.float32)  # [alg, car, mod]
    car = np.zeros((32, N_OPS), dtype=np.float32)
    fb_src = np.zeros((32,), dtype=np.int32)
    fb_dst = np.zeros((32,), dtype=np.int32)
    for a, (edges, mask, s, d) in enumerate(_ALGOS):
        for m, c in edges:
            assert m > c, "algorithm edges must run high->low"
            adj[a, c - 1, m - 1] = 1.0
        for i in range(N_OPS):
            car[a, i] = (mask >> i) & 1
        fb_src[a], fb_dst[a] = s - 1, d - 1
    return adj, car, fb_src, fb_dst


ALGO_ADJ, ALGO_CARRIER, ALGO_FB_SRC, ALGO_FB_DST = _build_algo_tables()


def _build_mod_depths() -> np.ndarray:
    """(32, 6) int32 modulation depth per (algorithm, operator): carriers
    are 0, an operator that modulates a depth-d operator is d+1 (min over
    its targets); feedback self-edges don't affect depth."""
    depth = np.full((32, N_OPS), N_OPS, dtype=np.int32)
    for a, (edges, mask, _s, _d) in enumerate(_ALGOS):
        for i in range(N_OPS):
            if (mask >> i) & 1:
                depth[a, i] = 0
        for _ in range(N_OPS):
            for m, c in edges:
                depth[a, m - 1] = min(depth[a, m - 1], depth[a, c - 1] + 1)
    return depth


ALGO_MOD_DEPTH = _build_mod_depths()


def feedback_loop(adj, carrier, src: int, dst: int) -> list:
    """The operators of one algorithm's feedback loop (0-based), from the
    feedback destination down to its source; ``adj`` (6, 6) [car, mod] and
    ``carrier`` (6,) are the algorithm's rows of ``ALGO_ADJ`` and
    ``ALGO_CARRIER``. F2 runs only these operators sample after sample, and
    that is right only while the loop is one modulation chain from ``dst``
    down to ``src``, no operator outside the loop modulates it, and only
    ``src``'s output leaves it: a table that breaks one raises ValueError."""
    chain = [dst]
    while True:
        cur = chain[-1]
        mods = set(np.flatnonzero(adj[cur]).tolist())
        if mods - set(chain):
            raise ValueError(f"feedback loop {dst + 1}->{src + 1}: an operator outside the loop "
                             f"modulates operator {cur + 1}")
        if mods != set(chain[-2:-1]):
            raise ValueError(f"feedback loop {dst + 1}->{src + 1}: not a single chain at "
                             f"operator {cur + 1}")
        if cur == src:
            return chain
        targets = np.flatnonzero(adj[:, cur]).tolist()
        if carrier[cur] or len(targets) > 1:
            raise ValueError(f"feedback loop {dst + 1}->{src + 1}: operator {cur + 1}'s output "
                             f"leaves the loop")
        if not targets or targets[0] < src:
            raise ValueError(f"feedback loop {dst + 1}->{src + 1}: not a single chain at "
                             f"operator {cur + 1}")
        chain.append(targets[0])


# the columns of one row of ``algorithm_rows``; csrc/fm_render.cu reads the
# same offsets (its ALG_* defines, checked against these by the CPU tests)
ALG_COLUMNS = {"MODS": 0, "CARRIERS": 6, "FB_SRC": 7, "FB_DST": 8, "LOOP_LEN": 9,
               "LOOP_OPS": 10, "LOOP_MASK": 13, "WIDTH": 14}
ALG_LOOP_LEN, ALG_LOOP_OPS, ALG_LOOP_MASK = (ALG_COLUMNS[k] for k in (
    "LOOP_LEN", "LOOP_OPS", "LOOP_MASK"))


def algorithm_rows() -> np.ndarray:
    """(32, 14) int32, the table F2 keeps in constant memory: per algorithm
    the bitmask of each operator's modulators (6 entries, bit m = operator
    m+1 modulates it), the carrier bitmask, the feedback source and
    destination (0-based), the feedback loop's length, its operators from
    the destination down (3 entries, -1 past the length) and its bitmask.
    Raises ValueError where ``feedback_loop`` does."""
    rows = np.full((32, ALG_COLUMNS["WIDTH"]), -1, dtype=np.int32)
    for a in range(32):
        for i in range(N_OPS):
            rows[a, i] = sum(1 << m for m in range(N_OPS) if ALGO_ADJ[a, i, m])
        rows[a, 6] = sum(1 << i for i in range(N_OPS) if ALGO_CARRIER[a, i])
        rows[a, 7], rows[a, 8] = ALGO_FB_SRC[a], ALGO_FB_DST[a]
        loop = feedback_loop(ALGO_ADJ[a], ALGO_CARRIER[a], int(ALGO_FB_SRC[a]),
                             int(ALGO_FB_DST[a]))
        rows[a, ALG_LOOP_LEN] = len(loop)
        rows[a, ALG_LOOP_OPS:ALG_LOOP_OPS + len(loop)] = loop
        rows[a, ALG_LOOP_MASK] = sum(1 << i for i in loop)
    return rows


# f32 constants as the JAX package rounds them (jnp.log of a Python float
# is an f32 log; a Python float meeting an f32 array is cast to f32)
LN10 = float(np.log(np.float32(10.0)))
LN10_OVER_20 = float(np.float32(np.log(np.float32(10.0))) / np.float32(20.0))
TWO_PI = float(np.float32(2.0 * np.pi))
MOD_SCALE = float(np.float32(MOD_INDEX_MAX / (2.0 * np.pi)))

# ---------------------------------------------------------------------------
# Parameter decoding (fm_jax.py:135-230) with straight-through rounding
# ---------------------------------------------------------------------------


def _clip(x, lo=None, hi=None):
    """jnp.clip / jnp.maximum / jnp.minimum against a constant, with their
    gradient at a tie (half to each side; torch.clamp passes all of it)."""
    if lo is not None:
        x = torch.maximum(x, x.new_tensor(lo))
    if hi is not None:
        x = torch.minimum(x, x.new_tensor(hi))
    return x


def _ste(f, x):
    """Straight-through: forward = f(x), gradient = identity."""
    return x + (f(x) - x).detach()


def _qz(x, card):
    """lround(x*(card-1)) clipped, straight-through (fm_jax.py:140-144)."""
    y = x * (card - 1.0)
    return _ste(lambda v: _clip(torch.floor(v + 0.5), 0.0, card - 1.0), y)


def _p99(x):
    return _clip(x, 0.0, 1.0) * 99.0


def _level_to_db(level):
    return 0.74 * (level - 99.0)


def _rate_to_db_per_s(r):
    """DX7 quantized EG timing law (fm_jax.py:155-164)."""
    qr = _clip(_ste(torch.floor, r * (41.0 / 64.0)), hi=63.0)
    octave = _ste(torch.floor, qr * 0.25)
    fine = qr - 4.0 * octave
    return (9600.0 / (7.0 * 32768.0)) * (4.0 + fine) * torch.exp2(octave)


def decode_presets(p):
    """(B, 155) normalized preset matrix -> dict of decoded parameter
    tensors (fm_jax.py:167-201)."""
    d = {}
    d["master_volume"] = _clip(p[:, 2], 0.0, 1.0)
    d["algorithm"] = _qz(p[:, 4], 32)
    d["feedback"] = _qz(p[:, 5], 8)
    d["lfo_speed"] = _p99(p[:, 7])
    d["lfo_delay"] = _p99(p[:, 8])
    d["lfo_pm_depth"] = _p99(p[:, 9])
    d["lfo_am_depth"] = _p99(p[:, 10])
    d["lfo_key_sync"] = _qz(p[:, 11], 2)
    d["lfo_wave"] = _qz(p[:, 12], 6)
    d["transpose"] = _clip(p[:, 13], 0.0, 1.0) * 48.0
    d["pitch_mod_sens"] = _qz(p[:, 14], 8)
    d["peg_rate"] = _p99(p[:, 15:19])
    d["peg_level"] = _p99(p[:, 19:23])
    ops = p[:, 23:23 + 22 * N_OPS].reshape(p.shape[0], N_OPS, 22)
    d["eg_rate"] = _p99(ops[..., 0:4])  # (B, 6, 4)
    d["eg_level"] = _p99(ops[..., 4:8])
    d["out_level"] = _p99(ops[..., 8])
    d["fixed_mode"] = _qz(ops[..., 9], 2)
    d["coarse"] = _qz(ops[..., 10], 32)
    d["fine"] = _p99(ops[..., 11])
    d["detune"] = _qz(ops[..., 12], 15)
    d["breakpoint"] = _p99(ops[..., 13])
    d["l_depth"] = _p99(ops[..., 14])
    d["r_depth"] = _p99(ops[..., 15])
    d["l_curve"] = _qz(ops[..., 16], 4)
    d["r_curve"] = _qz(ops[..., 17], 4)
    d["rate_scaling"] = _qz(ops[..., 18], 8)
    d["amp_mod_sens"] = _qz(ops[..., 19], 4)
    d["key_vel"] = _qz(ops[..., 20], 8)
    d["on"] = _qz(ops[..., 21], 2)
    return d


def _keyscale_db(d, note):
    """Key level-scaling contribution in dB (fm_jax.py:204-219); note (B, 1)."""
    bp_note = d["breakpoint"] + 21.0
    dist = note - bp_note
    left = dist < 0
    depth = torch.where(left, d["l_depth"], d["r_depth"])
    curve = torch.where(left, d["l_curve"], d["r_curve"])
    adist = torch.abs(dist)
    exp_frac = (torch.exp2(adist / 16.0) - 1.0) / (2.0 ** (45.0 / 16.0) - 1.0)
    lin_frac = adist / 45.0
    is_exp = (curve == 1) | (curve == 2)
    frac = torch.where(is_exp, exp_frac, lin_frac)
    db = depth * 0.74 * frac
    db = torch.where(curve <= 1, -db, db)
    return torch.where((depth <= 0.0) | (adist <= 0.0), torch.zeros_like(db), db)


def _op_freqs(d, pitches):
    """Static per-op oscillator frequencies (fm_jax.py:343-357)."""
    base_note = pitches.float()[:, None] + (d["transpose"][:, None] - 24.0)
    base_freq = 440.0 * torch.exp2((base_note - 69.0) / 12.0)  # (B, 1)
    coarse_mod4 = d["coarse"] - 4.0 * _ste(torch.floor, d["coarse"] / 4.0)
    fixed_freq = torch.exp(LN10 * (coarse_mod4 + d["fine"] / 100.0))
    ratio = torch.where(d["coarse"] == 0, torch.full_like(d["coarse"], 0.5), d["coarse"]) * (
        1.0 + d["fine"] / 100.0)
    freq = torch.where(d["fixed_mode"] > 0, fixed_freq, base_freq * ratio)
    return freq * torch.exp2((d["detune"] - 7.0) * (2.0 / 1200.0))  # (B, 6)


def samples_per_render(total_s: float, sample_rate: int) -> int:
    n = int(total_s * sample_rate)
    return (n + ENGINE_BLOCK - 1) // ENGINE_BLOCK * ENGINE_BLOCK


# ---------------------------------------------------------------------------
# Per-item constants of the control pass, packed for F1
# ---------------------------------------------------------------------------

# (name, width): the columns of one packed row; csrc/fm_render.cu reads the
# same offsets (its CTL_* defines, checked against these by the CPU tests)
CTL_FIELDS = (
    ("op_gain_db", 6), ("targets", 24), ("slews", 24), ("eg0", 6),
    ("peg_targets", 4), ("peg_slews", 4), ("peg0", 1), ("lfo_hz", 1),
    ("lfo_phase0", 1), ("lfo_delay_s", 1), ("pmd", 1), ("amd", 1), ("pms", 1),
    ("ams_db", 6), ("on", 6), ("lfo_wave", 1), ("freqs", 6),
)
CTL_OFFSETS = {}
_off = 0
for _name, _width in CTL_FIELDS:
    CTL_OFFSETS[_name] = _off
    _off += _width
CTL_WIDTH = _off
del _off, _name, _width


def control_params(d, pitches, velocities, sample_rate: int) -> torch.Tensor:
    """The control pass's per-item constants (fm_jax.py:264-297) and the
    oscillator frequencies, packed as (B, CTL_WIDTH) float32 rows; EG
    targets and slews are op-major (op * 4 + stage)."""
    tick_s = BLOCK / float(sample_rate)
    B = d["out_level"].shape[0]
    pitch = pitches.float()[:, None]  # (B, 1)
    vel01 = _clip(velocities.float(), 0.0, 127.0) / 127.0
    vel_db = d["key_vel"] / 7.0 * 24.0 * (vel01[:, None] - 1.0)
    op_gain_db = _level_to_db(d["out_level"]) + _keyscale_db(d, pitch) + vel_db
    rs_add = d["rate_scaling"] * (pitch - 60.0) / 6.0
    rates = _clip(d["eg_rate"] + rs_add[..., None], hi=99.0)
    slews = _rate_to_db_per_s(rates) * tick_s
    targets = _level_to_db(d["eg_level"])
    eg0 = torch.where(targets[..., 3] < -70.0, torch.full_like(targets[..., 3], -100.0),
                      targets[..., 3])
    peg_slews = _rate_to_db_per_s(_clip(d["peg_rate"], hi=99.0)) * tick_s
    peg_targets = d["peg_level"] - 50.0
    # LFO hardware curve (fm_jax.py:287-291)
    lfo_s = _qz(d["lfo_speed"] / 99.0, 100)
    sr0 = torch.where(lfo_s == 0, torch.ones_like(lfo_s),
                      _ste(torch.floor, 165.0 * lfo_s / 64.0))
    mult = torch.where(sr0 < 160.0, torch.full_like(sr0, 11.0),
                       11.0 + _ste(torch.floor, (sr0 - 160.0) / 16.0))
    lfo_hz = sr0 * mult * 0.0057
    lfo_phase0 = torch.where(d["lfo_key_sync"] > 0, 0.0, 0.25).to(lfo_hz)
    lfo_delay_s = 5.0 * torch.square(d["lfo_delay"] / 99.0)
    dev = d["out_level"].device
    pms = torch.from_numpy(PMS_SEMIS).to(dev)[d["pitch_mod_sens"].long()]
    ams_db = torch.from_numpy(AMS_DB).to(dev)[d["amp_mod_sens"].long()]
    cols = {
        "op_gain_db": op_gain_db, "targets": targets.reshape(B, 24),
        "slews": slews.reshape(B, 24), "eg0": eg0, "peg_targets": peg_targets,
        "peg_slews": peg_slews, "peg0": peg_targets[:, 3:4], "lfo_hz": lfo_hz[:, None],
        "lfo_phase0": lfo_phase0[:, None], "lfo_delay_s": lfo_delay_s[:, None],
        "pmd": (d["lfo_pm_depth"] / 99.0)[:, None], "amd": (d["lfo_am_depth"] / 99.0)[:, None],
        "pms": pms[:, None], "ams_db": ams_db, "on": d["on"],
        "lfo_wave": d["lfo_wave"][:, None], "freqs": _op_freqs(d, pitches),
    }
    return torch.cat([cols[name].float() for name, _ in CTL_FIELDS], dim=1)


def _ctl(ctl, name):
    off = CTL_OFFSETS[name]
    return ctl[:, off:off + dict(CTL_FIELDS)[name]]


# ---------------------------------------------------------------------------
# Control-rate pass: F1's plain version (fm_jax.py:238-340, 389-394)
# ---------------------------------------------------------------------------


def _lfo_wave_value(wave, phase, sh_value):
    """(fm_jax.py:222-230); the default branch, wave 5, is the S&H value."""
    tri = 4.0 * torch.where(phase < 0.5, phase, 1.0 - phase) - 1.0
    square = torch.where(phase < 0.5, 1.0, -1.0).to(phase)
    out = sh_value
    for w, v in reversed(list(enumerate(
            [tri, 1.0 - 2.0 * phase, 2.0 * phase - 1.0, square,
             torch.sin(TWO_PI * phase)]))):
        out = torch.where(wave == w, v, out)
    return out


def _eg_tick(cur, stage, targets, slews, off):
    """One EG control tick (fm_jax.py:238-249); targets/slews (..., 4)."""
    stage = torch.where(off, torch.full_like(stage, 3), stage)
    target = torch.gather(targets, -1, stage[..., None])[..., 0]
    slew = torch.gather(slews, -1, stage[..., None])[..., 0]
    dlt = target - cur
    step = torch.where(dlt > 0.0, 4.0 * slew + 0.05 * dlt, slew)
    reached = torch.abs(dlt) <= step
    new_cur = torch.where(reached, target, cur + torch.sign(dlt) * step)
    new_stage = torch.where(reached & (stage < 2), stage + 1, stage)
    return new_cur, new_stage


def control_pass(ctl, n_ticks: int, note_off_sample: int, sample_rate: int):
    """F1's plain version, a Python loop over the ticks: -> amps (T, B, 6),
    pitch_fact (T, B), phase starts (T, B, 6) and phase increments
    (T, B, 6). The S&H LCG runs in int64 masked to 32 bits (torch has no
    uint32 arithmetic on the CPU); the phase start of a tick is the
    previous start plus 32 increments, wrapped once (fm_jax.py:389-394)."""
    fs = float(sample_rate)
    B = ctl.shape[0]
    targets = _ctl(ctl, "targets").reshape(B, N_OPS, 4)
    slews = _ctl(ctl, "slews").reshape(B, N_OPS, 4)
    op_gain_db, ams_db, freqs = _ctl(ctl, "op_gain_db"), _ctl(ctl, "ams_db"), _ctl(ctl, "freqs")
    on = _ctl(ctl, "on") > 0
    peg_targets, peg_slews = _ctl(ctl, "peg_targets"), _ctl(ctl, "peg_slews")
    lfo_hz, lfo_delay_s, pmd, amd, pms = (_ctl(ctl, k)[:, 0] for k in (
        "lfo_hz", "lfo_delay_s", "pmd", "amd", "pms"))
    wave = _ctl(ctl, "lfo_wave")[:, 0]
    tick_s = BLOCK / fs
    peg_per_unit = 4.0 / 50.0

    eg_db, eg_stage = _ctl(ctl, "eg0").clone(), torch.zeros((B, N_OPS), dtype=torch.long,
                                                            device=ctl.device)
    peg_db, peg_stage = _ctl(ctl, "peg0")[:, 0], torch.zeros((B,), dtype=torch.long,
                                                              device=ctl.device)
    lfo_phase = _ctl(ctl, "lfo_phase0")[:, 0]
    sh_rng = torch.full((B,), SH_SEED, dtype=torch.int64, device=ctl.device)
    sh_val = torch.zeros_like(lfo_phase)
    phase = torch.zeros_like(freqs)
    amps, pitch_facts, starts, incs = [], [], [], []
    for t in range(n_ticks):
        start = t * BLOCK
        off = torch.tensor(start >= note_off_sample, device=ctl.device)
        t_s = float(np.float32(start) / np.float32(fs))
        ramp = torch.where(lfo_delay_s > 0.0,
                           _clip(t_s / _clip(lfo_delay_s, lo=1e-9), hi=1.0), 1.0)
        lfo_phase = lfo_phase + lfo_hz * tick_s
        wrapped = lfo_phase >= 1.0
        lfo_phase = torch.where(wrapped, lfo_phase - torch.floor(lfo_phase), lfo_phase)
        new_rng = (sh_rng * 1664525 + 1013904223) & 0xFFFFFFFF
        sh_rng = torch.where(wrapped, new_rng, sh_rng)
        new_sh = (sh_rng >> 8).float() / 8388608.0 - 1.0
        sh_val = torch.where(wrapped, new_sh, sh_val)
        lfo = _lfo_wave_value(wave, lfo_phase, sh_val) * ramp

        peg_db, peg_stage = _eg_tick(peg_db, peg_stage, peg_targets, peg_slews, off)
        pitch_fact = torch.exp2((peg_db * peg_per_unit + lfo * pmd * pms) / 12.0)

        eg_db, eg_stage = _eg_tick(eg_db, eg_stage, targets, slews, off)
        am_db = -0.5 * (1.0 + lfo[:, None]) * amd[:, None] * ams_db
        tot_db = _clip(eg_db + op_gain_db + am_db, hi=0.0)
        amp = torch.where(on, torch.exp(tot_db * LN10_OVER_20), 0.0)
        amp = torch.where(amp < 1e-6, 0.0, amp)

        inc = freqs * pitch_fact[:, None] / fs
        amps.append(amp)
        pitch_facts.append(pitch_fact)
        starts.append(phase)
        incs.append(inc)
        nxt = phase + inc * BLOCK
        phase = nxt - torch.floor(nxt)
    return torch.stack(amps), torch.stack(pitch_facts), torch.stack(starts), torch.stack(incs)


# ---------------------------------------------------------------------------
# Audio-rate synthesis (fm_jax.py:370-397, 400-413, 464-516)
# ---------------------------------------------------------------------------


def upsample_amps(amps):
    """(T, B, 6) block targets -> (B, 6, T*BLOCK) per-sample amplitudes,
    linear inside each block from the previous tick's (fm_jax.py:370-379)."""
    T, B, _ = amps.shape
    prev = torch.cat([torch.zeros_like(amps[:1]), amps[:-1]], dim=0)
    w = torch.arange(1, BLOCK + 1, dtype=torch.float32, device=amps.device) / BLOCK
    per = prev[..., None] + (amps - prev)[..., None] * w
    return per.permute(1, 2, 0, 3).reshape(B, N_OPS, T * BLOCK)


def sample_phases(starts, incs):
    """Per-sample phases (B, 6, T*BLOCK): start + inc * s, s = 1..32
    (fm_jax.py:395-397)."""
    T, B, _ = starts.shape
    s = torch.arange(1, BLOCK + 1, dtype=torch.float32, device=starts.device)
    per = starts[..., None] + incs[..., None] * s
    return per.permute(1, 2, 0, 3).reshape(B, N_OPS, T * BLOCK)


def _algo(alg, dev):
    a = alg.long()
    adj, car = (torch.from_numpy(t).to(dev)[a] for t in (ALGO_ADJ, ALGO_CARRIER))
    src = torch.nn.functional.one_hot(torch.from_numpy(ALGO_FB_SRC).to(dev).long()[a], N_OPS)
    dst = torch.nn.functional.one_hot(torch.from_numpy(ALGO_FB_DST).to(dev).long()[a], N_OPS)
    return adj, car, src.float(), dst.float()


def feedback_amount(d):
    """(B,) feedback gain, 2^(fb - 7) pi, 0 when off (fm_jax.py:450-451)."""
    return torch.where(d["feedback"] > 0, torch.exp2(d["feedback"] - 7.0) * float(np.float32(np.pi)),
                       0.0)


def feedforward_pass(phases, amps, alg, fb_amt, loop_out):
    """``fm_exact_ff``'s plain version, vectorized over the samples: the
    operators off the feedback loop (all six at feedback 0, where the
    feedback term is +0), operators high to low; on the items with
    feedback the loop's operators are not computed and the source's output
    is ``loop_out`` (B, N). -> (B, N) carrier sum, as ``exact_pass``'s."""
    B, _, N = phases.shape
    adj, carriers, _, _ = _algo(alg, phases.device)
    rows = torch.from_numpy(algorithm_rows()).to(phases.device)[alg.long()]
    loop = torch.where(fb_amt != 0, rows[:, ALG_LOOP_MASK], 0)
    y = [None] * N_OPS
    for i in range(N_OPS - 1, -1, -1):
        mod = phases.new_zeros((B, N))
        for m in range(i + 1, N_OPS):
            mod = mod + adj[:, i, m, None] * y[m]
        own = torch.sin(TWO_PI * (phases[:, i] + mod * MOD_SCALE)) * amps[:, i]
        # a loop operator other than the source modulates only loop
        # operators and is no carrier, so its value here is never read
        y[i] = torch.where(((loop >> i) & 1).bool()[:, None], loop_out, own)
    return (carriers[:, :, None] * torch.stack(y, dim=1)).sum(1)


def fade_scale(n_samples: int, sample_rate: int) -> np.ndarray:
    """(N,) float32 linear fade-out over the last 0.1 s (fm_jax.py:406-412)."""
    scale = np.ones(n_samples, dtype=np.float32)
    fade_samples = int(np.floor(0.1 * float(sample_rate)))
    if fade_samples > 1:
        idx = np.arange(n_samples)
        tail = idx >= n_samples - fade_samples
        scale[tail] = (n_samples - 1 - idx[tail]) / (fade_samples - 1)
    return scale


def fade_and_volume(sample, n_carriers, master_volume, sample_rate: int):
    """Carrier normalization, master volume, clamp, fade-out
    (fm_jax.py:400-413)."""
    out = sample / n_carriers[:, None] * master_volume[:, None]
    out = _clip(out, -1.0, 1.0)
    return out * torch.from_numpy(fade_scale(sample.shape[1], sample_rate)).to(out.device)


# ---------------------------------------------------------------------------
# The render's inputs
# ---------------------------------------------------------------------------


def _prepare(presets, pitches, velocities, total_s, sample_rate, feedback):
    if feedback not in ("exact", "unrolled"):
        raise ValueError(f"unknown feedback mode '{feedback}'")
    presets = torch.as_tensor(presets)
    dev = presets.device
    pitches = torch.as_tensor(np.asarray(pitches), device=dev)
    velocities = torch.as_tensor(np.asarray(velocities), device=dev)
    B = presets.shape[0]
    if pitches.shape != (B,) or velocities.shape != (B,) or presets.shape != (B, 155):
        raise ValueError(f"presets {tuple(presets.shape)}, pitches {tuple(pitches.shape)} and "
                         f"velocities {tuple(velocities.shape)} must be (B, 155), (B,), (B,)")
    d = decode_presets(presets.float())
    alg = d["algorithm"].to(torch.int32)
    n_carriers = _clip(torch.from_numpy(ALGO_CARRIER).to(dev)[alg.long()].sum(-1), lo=1.0)
    ctl = control_params(d, pitches, velocities, sample_rate)
    n_ticks = samples_per_render(total_s, sample_rate) // BLOCK
    return d, alg, feedback_amount(d), n_carriers, ctl, n_ticks


