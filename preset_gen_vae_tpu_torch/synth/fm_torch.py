"""The DX7 FM engine in PyTorch, with kernels F1 and F2 behind it.

Counterpart: ``preset_gen_vae_tpu/synth/fm_jax.py``, the JAX package's
differentiable on-device render. Same decode laws, EG state machine, LFO
(with its sample-and-hold LCG), algorithm table, feedback and fade-out; the
JAX package is the reference, so the sine is the true ``sin(2 pi x)`` and
not the C++ engine's interpolated table.

``render_batch`` is the wrapper of both kernels:

- a tensor on the CPU goes through ``plain_render``, the plain PyTorch
  versions: the control pass as a Python loop over the 32-sample ticks
  (``control_pass``), the ``'unrolled'`` audio pass vectorized over samples
  and the ``'exact'`` one as a Python loop over the samples
  (``exact_pass``). They stay differentiable, and run on any device, so
  that the kernels can be held against them on the card;
- a tensor on the card launches F1 (``fm_control``: 8 lanes per item, one
  per operator, walk the ticks) and then F2 (``fm_exact``), or, for
  ``'unrolled'``, F1 and the vectorized pass in torch ops. F2 is two
  kernels on one output buffer: ``fm_fb_loop`` runs only the feedback
  loop's operators (1-3; the one part of the work that is serial over
  samples) in one thread per item with feedback, and ``fm_exact_ff`` runs
  every other operator, the carrier sum, the volume, clip and fade, one
  thread per sample; ``fm_exact`` pipelines them over segments of ticks
  on two streams. Their plain versions are ``feedback_loop_pass`` and
  ``feedforward_pass``, which together compute ``exact_pass``. The kernels
  live in ``csrc/fm_render.cu``, are built with nvcc at first use and
  bound with ctypes. Both have a backward, so that either render is
  differentiable on the card: F1b (``fm_control_bwd``, through
  ``FmControl``: F1 under a gradient tapes its state, and the reverse
  walk's ticks are cut into chunks walked in parallel and combined per
  item) and F2b (``fm_exact_bwd``, through ``FmExact``: the operators
  off the feedback loop one thread a sample, the loop's adjoint as a
  linear recurrence over F2's taped loop output, scanned over ticks and
  splits of ticks, the loop's operators one thread a sample again). Their
  plain versions are ``control_pass_vjp`` and ``exact_pass_vjp``. A
  failed build or launch raises; nothing falls back to the plain loops.

The decode and the per-item constants of the control pass
(``control_params``) are torch ops on either device; they pack into one
(B, CTL_WIDTH) float32 row per item, the layout F1 reads. The per-tick
arrays are kept (T, B, 6), as fm_jax's scans produce them, so that
neighbouring threads of F1 and F2 touch neighbouring addresses.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from .. import _native

N_OPS = 6
BLOCK = 32  # control-rate block (samples), as in dx7_engine.cc
ENGINE_BLOCK = 512  # render length rounds up to this (dx7_engine.cc:295)
MOD_INDEX_MAX = 4.0
AMS_DB = np.array([0.0, 1.6, 4.8, 12.0], dtype=np.float32)
PMS_SEMIS = np.array([0.0, 0.09, 0.20, 0.43, 0.87, 1.79, 3.66, 7.0], dtype=np.float32)
SH_SEED = 0x12345678  # the S&H LCG's state at note-on (fm_jax.py:336)

# launches of each hand-written kernel, counted by its wrapper at the launch;
# "fm_exact" counts calls of F2's wrapper, each of which launches
# "fm_fb_loop" and "fm_exact_ff" once per segment of ``exact_segments``;
# "fm_control_bwd" counts calls of F1b's wrapper, each of which launches
# "fm_control_bwd_starts", "fm_control_bwd_chunks" and
# "fm_control_bwd_combine" once; "fm_exact_bwd" counts calls of F2b's
# wrapper, each of which launches "fm_exact_bwd_ff", "fm_exact_bwd_loop"
# and "fm_exact_bwd_seams" once
F1B_KERNELS = ("fm_control_bwd_starts", "fm_control_bwd_chunks", "fm_control_bwd_combine")
F2B_KERNELS = ("fm_exact_bwd_ff", "fm_exact_bwd_loop", "fm_exact_bwd_seams")
LAUNCHES = {"fm_control": 0, "fm_exact": 0, "fm_fb_loop": 0, "fm_exact_ff": 0,
            "fm_control_bwd": 0, **dict.fromkeys(F1B_KERNELS, 0),
            "fm_exact_bwd": 0, **dict.fromkeys(F2B_KERNELS, 0)}
F1_LANES = 8  # F1's and F1b's threads per item (csrc/fm_render.cu's F1_LANES)
TAPE_LANE_BYTES = 8  # F1's tape under a gradient: one float2 per lane and tick
F1B_SUM = 24  # floats of a lane's chunk summary in F1b (csrc/fm_render.cu's F1B_SUM)
# F1b cuts an item's ticks into chunks of at least this many ticks, enough
# of them that items x chunks reaches the target (the walks' parallelism)
CONTROL_BWD_ITEM_CHUNKS = 16384
CONTROL_BWD_MIN_TICKS = 16
# F2b cuts an item's ticks into splits of whole 8-tick steps, enough that
# items x splits reaches the target blocks, at most MAX_SPLITS (csrc)
EXACT_BWD_BLOCKS = 4096
EXACT_BWD_MAX_SPLITS = 256

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


def control_pass_vjp(ctl, n_ticks: int, note_off_sample: int, sample_rate: int, g_amps,
                     g_pitch_fact, g_starts, g_incs):
    """F1b's plain version: the gradient (B, CTL_WIDTH) of ``ctl`` given the
    cotangents of ``control_pass``'s four outputs (any may be None), by
    autograd through ``control_pass`` on ``ctl``'s device."""
    with torch.enable_grad():
        x = ctl.detach().requires_grad_(True)
        pairs = [(out, g) for out, g in zip(
            control_pass(x, n_ticks, note_off_sample, sample_rate),
            (g_amps, g_pitch_fact, g_starts, g_incs)) if g is not None]
        (grad,) = torch.autograd.grad([o for o, _ in pairs], x, [g for _, g in pairs],
                                      allow_unused=True)
    return torch.zeros_like(ctl) if grad is None else grad


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


def unrolled_pass(phases, amps, alg, fb_amt, fb_iters: int):
    """The vectorized damped fixed-point unroll of the feedback
    (fm_jax.py:464-488): (B, N) carrier sum."""
    B, _, N = phases.shape
    adj, carriers, src, dst = _algo(alg, phases.device)
    fb_sig = phases.new_zeros((B, N))
    ys = None
    for _ in range(max(1, fb_iters)):
        fb_term = 0.5 * (torch.nn.functional.pad(fb_sig[:, :-1], (1, 0))
                         + torch.nn.functional.pad(fb_sig[:, :-2], (2, 0))) * fb_amt[:, None]
        y = [None] * N_OPS
        for i in range(N_OPS - 1, -1, -1):
            mod = phases.new_zeros((B, N))
            for m in range(i + 1, N_OPS):
                mod = mod + adj[:, i, m, None] * y[m]
            mod = mod + dst[:, i, None] * fb_term
            y[i] = torch.sin(TWO_PI * (phases[:, i] + mod * MOD_SCALE)) * amps[:, i]
        ys = torch.stack(y, dim=1)
        fb_sig = (src[:, :, None] * ys).sum(1)
    return (carriers[:, :, None] * ys).sum(1)


def exact_pass(phases, amps, alg, fb_amt):
    """F2's carrier sum, plain: a Python loop over the samples carrying the
    two-sample feedback history, operators high to low (fm_jax.py:489-516).
    (B, N). A modulator edge that no item of the batch has adds +0 to every
    item and is skipped."""
    B, _, N = phases.shape
    adj, carriers, src, dst = _algo(alg, phases.device)
    edges = [[m for m in range(i + 1, N_OPS) if bool(adj[:, i, m].any())] for i in range(N_OPS)]
    adj_im = {(i, m): adj[:, i, m] for i in range(N_OPS) for m in edges[i]}
    dst_i = [dst[:, i] for i in range(N_OPS)]
    # per operator the N samples' (B,) rows; unbind, so that autograd keeps
    # one node for all of them (an index per sample would make a full-size
    # zero gradient per sample)
    ph = [phases[:, i].t().contiguous().unbind(0) for i in range(N_OPS)]
    am = [amps[:, i].t().contiguous().unbind(0) for i in range(N_OPS)]
    fb1 = fb2 = phases.new_zeros((B,))
    zero = phases.new_zeros((B,))
    out = []
    for n in range(N):
        fb_term = 0.5 * (fb1 + fb2) * fb_amt
        y = [None] * N_OPS
        for i in range(N_OPS - 1, -1, -1):
            mod = zero
            for m in edges[i]:
                mod = mod + adj_im[i, m] * y[m]
            mod = mod + dst_i[i] * fb_term
            y[i] = torch.sin(TWO_PI * (ph[i][n] + mod * MOD_SCALE)) * am[i][n]
        ys = torch.stack(y, dim=1)
        fb1, fb2 = (src * ys).sum(-1), fb1
        out.append((carriers * ys).sum(-1))
    return torch.stack(out, dim=1)


def feedback_loop_pass(phases, amps, alg, fb_amt):
    """``fm_fb_loop``'s plain version: a Python loop over the samples that
    runs only the feedback loop's operators, destination first, as
    ``exact_pass`` computes them. (B, N): the loop source's output at each
    sample on the items with feedback, 0 on the others."""
    B, _, N = phases.shape
    rows = torch.from_numpy(algorithm_rows()).to(phases.device)[alg.long()]
    length = rows[:, ALG_LOOP_LEN]
    idx = rows[:, ALG_LOOP_OPS:ALG_LOOP_OPS + 3].clamp(min=0).long()[:, :, None].expand(B, 3, N)
    # (3, N, B) as per-operator tuples of (B,) rows, unbound as in exact_pass
    ph = [r.unbind(0) for r in torch.gather(phases, 1, idx).permute(1, 2, 0).contiguous()]
    am = [r.unbind(0) for r in torch.gather(amps, 1, idx).permute(1, 2, 0).contiguous()]
    on = fb_amt != 0
    n_loop = int(length[on].max()) if bool(on.any()) else 1
    longer = [length > j for j in range(n_loop)]
    fb1 = fb2 = zero = phases.new_zeros((B,))
    out = []
    for n in range(N):
        y = 0.5 * (fb1 + fb2) * fb_amt  # the destination's modulation: the feedback term
        for j in range(n_loop):
            y_j = torch.sin(TWO_PI * (ph[j][n] + (zero + y) * MOD_SCALE)) * am[j][n]
            y = y_j if j == 0 else torch.where(longer[j], y_j, y)
        fb1, fb2 = y, fb1
        out.append(y)
    return torch.where(on[:, None], torch.stack(out, dim=1), 0.0)


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


def exact_pass_vjp(amps_t, starts, incs, alg, fb_amt, n_carriers, master_volume,
                   sample_rate: int, g_out):
    """F2b's plain version: the gradients of ``<g_out, waveform>`` by
    ``amps_t``, ``starts``, ``incs`` (each (T, B, 6)), ``fb_amt`` and
    ``master_volume`` (each (B,)), where the waveform is the exact render
    of F1's outputs, ``fade_and_volume(exact_pass(...))``; autograd on
    the inputs' device. ``alg`` and ``n_carriers`` take no gradient.

    An item at feedback 0 has a nonzero ``fb_amt`` gradient here: the
    source's output still meets a zero gain (``render_batch`` zeroes it on
    the way to the preset)."""
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(True) for t in (amps_t, starts, incs, fb_amt,
                                                         master_volume)]
        out = fade_and_volume(exact_pass(sample_phases(xs[1], xs[2]), upsample_amps(xs[0]), alg,
                                         xs[3]), n_carriers, xs[4], sample_rate)
        grads = torch.autograd.grad(out, xs, g_out, allow_unused=True)
    return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads))


# ---------------------------------------------------------------------------
# The wrapper
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


def plain_render(presets, pitches, velocities, note_on_s: float = 3.0, total_s: float = 4.0,
                 sample_rate: int = 22050, feedback: str = "unrolled", fb_iters: int = 3):
    """F1's and F2's plain version on any device: ``render_batch`` with the
    control pass and the exact pass as Python loops (differentiable)."""
    d, alg, fb_amt, n_carriers, ctl, n_ticks = _prepare(presets, pitches, velocities, total_s,
                                                        sample_rate, feedback)
    amps_t, _, starts, incs = control_pass(ctl, n_ticks, int(note_on_s * sample_rate), sample_rate)
    return _audio(d, alg, fb_amt, n_carriers, amps_t, starts, incs, sample_rate, feedback,
                  fb_iters)


def _audio(d, alg, fb_amt, n_carriers, amps_t, starts, incs, sample_rate, feedback, fb_iters):
    phases, amps = sample_phases(starts, incs), upsample_amps(amps_t)
    if feedback == "exact":
        sample = exact_pass(phases, amps, alg, fb_amt)
    else:
        sample = unrolled_pass(phases, amps, alg, fb_amt, fb_iters)
    return fade_and_volume(sample, n_carriers, d["master_volume"], sample_rate)


def render_batch(presets, pitches, velocities, note_on_s: float = 3.0, total_s: float = 4.0,
                 sample_rate: int = 22050, feedback: str = "unrolled", fb_iters: int = 3):
    """Renders a batch of presets to waveforms (fm_jax.py:416-520); the
    wrapper of F1 and F2.

    :param presets: (B, 155) normalized full preset matrix, a tensor; the
        device it lies on picks the path: the CPU takes ``plain_render``,
        the card F1 and then F2 (``'exact'``) or the unrolled pass in torch
        ops. On the card both are differentiable: F1's backward is F1b,
        F2's is F2b
    :param pitches/velocities: (B,) integers, any array-like
    :returns: (B, N) float32 waveforms, N rounded up to the 512-sample
        engine block (the C++ engine's contract)
    """
    presets = torch.as_tensor(presets)
    dev = presets.device
    if dev.type == "cpu":
        return plain_render(presets, pitches, velocities, note_on_s, total_s, sample_rate,
                            feedback, fb_iters)
    if dev.type != "cuda":
        raise ValueError(f"no FM render for device {dev}")
    d, alg, fb_amt, n_carriers, ctl, n_ticks = _prepare(presets, pitches, velocities, total_s,
                                                        sample_rate, feedback)
    amps_t, _, starts, incs = fm_control(ctl, n_ticks, int(note_on_s * sample_rate), sample_rate)
    if feedback == "exact":
        return fm_exact(amps_t, starts, incs, alg, fb_amt, n_carriers, d["master_volume"],
                        sample_rate)
    return _audio(d, alg, fb_amt, n_carriers, amps_t, starts, incs, sample_rate, feedback,
                  fb_iters)


# ---------------------------------------------------------------------------
# F1 and F2: the CUDA kernels' wrappers
# ---------------------------------------------------------------------------

FM_SOURCE = _native.REPO_ROOT / "preset_gen_vae_tpu_torch" / "csrc" / "fm_render.cu"


def fm_build_command():
    """nvcc for sm_90a, without --use_fast_math (__sinf and __expf would miss
    the reference) and with -fmad=false, so that each multiply and add
    rounds as the plain version's separate torch ops do."""
    from ..ops.spectrogram import nvcc_path

    return [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@functools.lru_cache(maxsize=None)
def _fm_library() -> ctypes.CDLL:
    """Builds (first use only) and loads F1, F1b's three kernels, F2's two
    and F2b's three, and hands
    them the algorithm table, which F2's launches copy into constant
    memory. The table is built first, so that one whose feedback loops F2
    cannot split raises before anything is built. Never called at import."""
    rows = np.ascontiguousarray(algorithm_rows())
    lib = ctypes.CDLL(str(_native.build_shared_library("fm_render", fm_build_command(),
                                                       [FM_SOURCE])))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fm_set_algorithms.restype = i
    lib.fm_set_algorithms.argtypes = [p]
    lib.fm_control_launch.restype = i
    lib.fm_control_launch.argtypes = [p, i, i, i, f, f, f, p, p, p, p, p, p]
    lib.fm_control_bwd_starts_launch.restype = i
    lib.fm_control_bwd_starts_launch.argtypes = [p, i, i, i, i, p, p]
    lib.fm_control_bwd_chunks_launch.restype = i
    lib.fm_control_bwd_chunks_launch.argtypes = [p, i, i, i, f, f, f] + [p] * 6 + [i, i, p, p]
    lib.fm_control_bwd_combine_launch.restype = i
    lib.fm_control_bwd_combine_launch.argtypes = [i, i, p, p, p]
    lib.fm_fb_loop_launch.restype = i
    lib.fm_fb_loop_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p, p, p]
    lib.fm_exact_ff_launch.restype = i
    lib.fm_exact_ff_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, p, p, p]
    lib.fm_exact_bwd_ff_launch.restype = i
    lib.fm_exact_bwd_ff_launch.argtypes = [p] * 10 + [i, i, i] + [p] * 12
    lib.fm_exact_bwd_loop_launch.restype = i
    lib.fm_exact_bwd_loop_launch.argtypes = [p] * 11 + [i, i, i] + [p] * 6
    lib.fm_exact_bwd_seams_launch.restype = i
    lib.fm_exact_bwd_seams_launch.argtypes = [i, i, i] + [p] * 7
    for name, want in (("fm_ctl_width", CTL_WIDTH), ("fm_alg_width", rows.shape[1])):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
        if getattr(lib, name)() != want:
            raise RuntimeError(f"fm_render.cu: {name} {getattr(lib, name)()}, Python {want}")
    err = lib.fm_set_algorithms(rows.ctypes.data)
    if err != 0:
        raise RuntimeError(f"copying the algorithm table failed: cudaError_t {err}")
    return lib


@functools.lru_cache(maxsize=8)
def _loop_lengths(dev) -> torch.Tensor:
    """(32,) long on ``dev``: each algorithm's feedback-loop length."""
    return torch.from_numpy(algorithm_rows()[:, ALG_LOOP_LEN].astype(np.int64)).to(dev)


@functools.lru_cache(maxsize=8)
def _loop_stream(dev) -> "torch.cuda.Stream":
    """The stream of ``fm_exact``'s loop segments: the highest priority, so
    that the card schedules the serial chain's blocks ahead of the
    feed-forward blocks queued on the caller's stream."""
    return torch.cuda.Stream(device=dev, priority=-100)


# fm_exact runs its two phases as a pipeline over this many segments of
# ticks: the feed-forward phase of a segment overlaps the loop phase of the next
EXACT_SEGMENTS = 8


def exact_segments(n_ticks: int):
    """[(t0, t1), ...]: ``fm_exact``'s segments of ticks, each a multiple of
    the feed-forward block's 8 ticks long but the last."""
    seg = -(-(-(-n_ticks // EXACT_SEGMENTS)) // 8) * 8
    return [(t, min(n_ticks, t + seg)) for t in range(0, n_ticks, seg)]


def loop_lengths(alg, fb_amt) -> torch.Tensor:
    """(B,) long: each item's feedback-loop length, the operators F2's loop
    phase runs one sample after another (1-3), 0 at feedback 0."""
    return _loop_lengths(alg.device)[alg.long()] * (fb_amt != 0)


def loop_slots(alg, fb_amt) -> torch.Tensor:
    """(B + 96,) int32: the loop phase's item of each thread, the items
    grouped by feedback-loop length (0, then 1, 2, 3), each group starting
    at a multiple of 32, so that a warp's items all take the same time; -1
    pads. Device ops only: no host sync."""
    dev, B = alg.device, alg.shape[0]
    length = loop_lengths(alg, fb_amt)
    counts = (length[:, None] == torch.arange(4, device=dev)).sum(0)
    padded = (counts + 31) // 32 * 32
    order = torch.argsort(length, stable=True)
    group = length[order]
    slot = (torch.cumsum(padded, 0) - padded)[group] + torch.arange(B, device=dev) \
        - (torch.cumsum(counts, 0) - counts)[group]
    slots = torch.full((B + 96,), -1, dtype=torch.int32, device=dev)
    slots[slot] = order.to(torch.int32)
    return slots


def _check(name, t, dtype, shape, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} {tuple(shape)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}, contiguous="
                         f"{t.is_contiguous()}")


def fm_control(ctl, n_ticks: int, note_off_sample: int, sample_rate: int):
    """F1's wrapper: (B, CTL_WIDTH) float32 on the card -> amps (T, B, 6),
    pitch_fact (T, B), phase starts and increments (T, B, 6);
    differentiable in ``ctl`` through ``FmControl`` (F1 taped, F1b
    backward); a call that needs no gradient launches F1 alone and keeps no
    tape."""
    if torch.is_grad_enabled() and ctl.requires_grad:
        return FmControl.apply(ctl, n_ticks, note_off_sample, sample_rate)
    return _fm_control_launch(ctl, n_ticks, note_off_sample, sample_rate, taped=False)[:4]


class FmControl(torch.autograd.Function):
    """F1 forward with its state on a tape, F1b backward."""

    @staticmethod
    def forward(ctx, ctl, n_ticks, note_off_sample, sample_rate):
        *outs, tape = _fm_control_launch(ctl, n_ticks, note_off_sample, sample_rate, taped=True)
        ctx.save_for_backward(ctl, tape)
        ctx.args = (n_ticks, note_off_sample, sample_rate)
        return tuple(outs)

    @staticmethod
    def backward(ctx, g_amps, g_pitch_fact, g_starts, g_incs):
        ctl, tape = ctx.saved_tensors
        return (fm_control_bwd(ctl, tape, *ctx.args, g_amps, g_pitch_fact, g_starts, g_incs),
                None, None, None)


def tape_bytes(n_items: int, n_ticks: int) -> int:
    """Device bytes of F1's tape under a gradient, which F1b reads: 64 a
    tick and item (0.18 GB at 1,024 items and 2,768 ticks)."""
    return n_ticks * n_items * F1_LANES * TAPE_LANE_BYTES


def _fm_control_launch(ctl, n_ticks: int, note_off_sample: int, sample_rate: int, taped: bool):
    """F1: -> (amps, pitch_fact, starts, incs, tape); ``taped``: F1 also
    writes its state, ``tape_bytes(B, n_ticks)`` of it, for F1b (raises
    where that does not fit), else the tape is None."""
    dev = ctl.device
    if dev.type != "cuda":
        raise ValueError(f"F1 runs on the card; the plain version is control_pass ({dev})")
    B = ctl.shape[0]
    _check("ctl", ctl, torch.float32, (B, CTL_WIDTH), dev)
    if B == 0 or n_ticks <= 0:
        raise ValueError(f"empty control pass: {B} items, {n_ticks} ticks")
    tape = None
    if taped:
        try:
            tape = torch.empty((n_ticks, B, F1_LANES, 2), dtype=torch.float32, device=dev)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(f"F1's tape needs {tape_bytes(B, n_ticks) / 2**30:.2f} GiB for "
                               f"{B} items x {n_ticks} ticks, more than {dev} has free") from e
    amps = torch.empty((n_ticks, B, N_OPS), dtype=torch.float32, device=dev)
    pitch_fact = torch.empty((n_ticks, B), dtype=torch.float32, device=dev)
    starts, incs = torch.empty_like(amps), torch.empty_like(amps)
    lib = _fm_library()
    fs = float(sample_rate)
    with torch.cuda.device(dev):
        err = lib.fm_control_launch(
            ctl.data_ptr(), B, n_ticks, note_off_sample, fs, float(np.float32(BLOCK / fs)),
            LN10_OVER_20, amps.data_ptr(), pitch_fact.data_ptr(), starts.data_ptr(),
            incs.data_ptr(), None if tape is None else tape.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fm_control kernel launch failed: cudaError_t {err}")
    LAUNCHES["fm_control"] += 1
    return amps, pitch_fact, starts, incs, tape


def control_bwd_chunks(n_items: int, n_ticks: int):
    """(chunks, ticks a chunk) of F1b's walks: enough chunks that items x
    chunks reaches ``CONTROL_BWD_ITEM_CHUNKS``, each at least
    ``CONTROL_BWD_MIN_TICKS`` long (bar the last, which may be shorter),
    none empty: (16, 173) at 1,024 items and 2,768 ticks, (65, 16) at one
    item and 1,040."""
    n = max(1, min(-(-CONTROL_BWD_ITEM_CHUNKS // n_items), n_ticks // CONTROL_BWD_MIN_TICKS))
    ticks = -(-n_ticks // n)
    return -(-n_ticks // ticks), ticks


def fm_control_bwd(ctl, tape, n_ticks: int, note_off_sample: int, sample_rate: int, g_amps,
                   g_pitch_fact, g_starts, g_incs):
    """F1b's wrapper: ``ctl`` (B, CTL_WIDTH), the tape that F1 wrote for it
    under a gradient (``_fm_control_launch(..., taped=True)``) and the
    cotangents of F1's four outputs on the card (None reads as zeros; any
    strides) -> the gradient of ``ctl``, (B, CTL_WIDTH) float32. Three
    launches on the caller's stream: ``fm_control_bwd_starts`` (each
    chunk's sum of the phase starts' cotangents), ``fm_control_bwd_chunks``
    (each (item, chunk) walked in reverse from zero incoming adjoints) and
    ``fm_control_bwd_combine`` (the chunks combined into each item's row),
    over ``control_bwd_chunks(B, n_ticks)``."""
    dev = ctl.device
    if dev.type != "cuda":
        raise ValueError(f"F1b runs on the card; the plain version is control_pass_vjp ({dev})")
    B = ctl.shape[0]
    _check("ctl", ctl, torch.float32, (B, CTL_WIDTH), dev)
    if B == 0 or n_ticks <= 0:
        raise ValueError(f"empty control pass: {B} items, {n_ticks} ticks")
    _check("tape", tape, torch.float32, (n_ticks, B, F1_LANES, 2), dev)
    shapes = ((n_ticks, B, N_OPS), (n_ticks, B), (n_ticks, B, N_OPS), (n_ticks, B, N_OPS))
    cots = []
    for name, g, shape in zip(("g_amps", "g_pitch_fact", "g_starts", "g_incs"),
                              (g_amps, g_pitch_fact, g_starts, g_incs), shapes):
        g = torch.zeros(shape, dtype=torch.float32, device=dev) if g is None else g.contiguous()
        _check(name, g, torch.float32, shape, dev)
        cots.append(g)
    n_chunk, chunk_ticks = control_bwd_chunks(B, n_ticks)
    sums = torch.empty((n_chunk, B, N_OPS), dtype=torch.float32, device=dev)
    summ = torch.empty((n_chunk, B, F1_LANES, F1B_SUM), dtype=torch.float32, device=dev)
    gctl = torch.empty((B, CTL_WIDTH), dtype=torch.float32, device=dev)
    fs = float(sample_rate)
    with torch.cuda.device(dev):
        _launch("fm_control_bwd_starts", cots[2].data_ptr(), B, n_ticks, n_chunk, chunk_ticks,
                sums.data_ptr())
        _launch("fm_control_bwd_chunks", ctl.data_ptr(), B, n_ticks, note_off_sample, fs,
                float(np.float32(BLOCK / fs)), LN10_OVER_20, *(g.data_ptr() for g in cots),
                tape.data_ptr(), sums.data_ptr(), n_chunk, chunk_ticks, summ.data_ptr())
        _launch("fm_control_bwd_combine", B, n_chunk, summ.data_ptr(), gctl.data_ptr())
    LAUNCHES["fm_control_bwd"] += 1
    return gctl


def _check_exact(amps, starts, incs, alg, fb_amt, *per_item):
    dev = amps.device
    if dev.type != "cuda":
        raise ValueError(f"F2 runs on the card; the plain version is exact_pass ({dev})")
    T, B, _ = amps.shape
    for name, t in (("amps", amps), ("starts", starts), ("incs", incs)):
        _check(name, t, torch.float32, (T, B, N_OPS), dev)
    _check("alg", alg, torch.int32, (B,), dev)
    for name, t in zip(("fb_amt", "n_carriers", "master_volume"), (fb_amt, *per_item)):
        _check(name, t, torch.float32, (B,), dev)
    return dev, T, B


def _launch_loop(lib, amps, starts, incs, alg, fb_amt, slots, t0, t1, fb, out, stream):
    T, B, _ = amps.shape
    err = lib.fm_fb_loop_launch(
        amps.data_ptr(), starts.data_ptr(), incs.data_ptr(), alg.data_ptr(), fb_amt.data_ptr(),
        slots.data_ptr(), slots.shape[0], B, T, t0, t1, fb.data_ptr(), out.data_ptr(),
        stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"fm_fb_loop kernel launch failed: cudaError_t {err}")
    LAUNCHES["fm_fb_loop"] += 1


def _launch_ff(lib, out, amps, starts, incs, alg, fb_amt, n_carriers, master_volume, scale, t0,
               t1, stream, tape=None):
    """``tape``: the loop source's output where it is not in ``out``."""
    T, B, _ = amps.shape
    err = lib.fm_exact_ff_launch(
        amps.data_ptr(), starts.data_ptr(), incs.data_ptr(), alg.data_ptr(), fb_amt.data_ptr(),
        n_carriers.data_ptr(), master_volume.data_ptr(), scale.data_ptr(), B, T, t0, t1,
        None if tape is None else tape.data_ptr(), out.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"fm_exact_ff kernel launch failed: cudaError_t {err}")
    LAUNCHES["fm_exact_ff"] += 1


def fm_exact(amps, starts, incs, alg, fb_amt, n_carriers, master_volume, sample_rate: int):
    """F2's wrapper: F1's (T, B, 6) arrays and the per-item algorithm (int32),
    feedback gain, carrier count and master volume -> (B, T*32) float32
    waveforms, faded, scaled and clipped: the buffer K1 reads.
    Differentiable in ``amps``, ``starts``, ``incs``, ``fb_amt`` and
    ``master_volume`` through ``FmExact`` (F2b backward); a call that needs
    no gradient launches F2 alone and keeps no tape."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (amps, starts, incs, fb_amt,
                                                                  master_volume)):
        return FmExact.apply(amps, starts, incs, alg, fb_amt, n_carriers, master_volume,
                             sample_rate)
    return _fm_exact_launch(amps, starts, incs, alg, fb_amt, n_carriers, master_volume,
                            sample_rate, taped=False)[0]


class FmExact(torch.autograd.Function):
    """F2 forward with the loop source on a tape, F2b backward. ``alg`` and
    ``n_carriers`` take no gradient."""

    @staticmethod
    def forward(ctx, amps, starts, incs, alg, fb_amt, n_carriers, master_volume, sample_rate):
        out, tape = _fm_exact_launch(amps, starts, incs, alg, fb_amt, n_carriers, master_volume,
                                     sample_rate, taped=True)
        ctx.save_for_backward(tape, amps, starts, incs, alg, fb_amt, n_carriers, master_volume)
        ctx.sample_rate = sample_rate
        return out

    @staticmethod
    def backward(ctx, g_out):
        tape, *args = ctx.saved_tensors
        g_amps, g_starts, g_incs, g_fb_amt, g_mv = fm_exact_bwd(tape, *args, ctx.sample_rate,
                                                                g_out)
        return g_amps, g_starts, g_incs, None, g_fb_amt, None, g_mv, None


def _fm_exact_launch(amps, starts, incs, alg, fb_amt, n_carriers, master_volume,
                     sample_rate: int, taped: bool):
    """F2: -> (waveforms, tape). Runs the loop phase (``fm_fb_loop``) and
    the feed-forward phase (``fm_exact_ff``) as a pipeline over
    ``exact_segments``: each loop segment on a high-priority side stream,
    and the feed-forward segment that reads it on the caller's stream once
    it is done, so that the feed-forward work overlaps the next loop
    segment. The loop writes the source's output into ``out`` itself,
    which the feed-forward phase overwrites, or, ``taped``, into a (B,
    T*32) tape of its own that F2b reads (the tape is ``out`` otherwise)."""
    dev, T, B = _check_exact(amps, starts, incs, alg, fb_amt, n_carriers, master_volume)
    out = torch.empty((B, T * BLOCK), dtype=torch.float32, device=dev)  # 256-byte aligned
    tape = torch.empty_like(out) if taped else out
    fb = torch.empty((B, 2), dtype=torch.float32, device=dev)  # the loop's two-sample history
    slots = loop_slots(alg, fb_amt)
    scale = _fade_table(T * BLOCK, int(sample_rate), dev)
    lib = _fm_library()
    main, side = torch.cuda.current_stream(dev), _loop_stream(dev)
    side.wait_stream(main)
    for t in (amps, starts, incs, alg, fb_amt, slots, fb, out, tape):
        t.record_stream(side)  # no reuse of their memory before the side stream is done
    with torch.cuda.device(dev):
        for t0, t1 in exact_segments(T):
            _launch_loop(lib, amps, starts, incs, alg, fb_amt, slots, t0, t1, fb, tape, side)
            main.wait_stream(side)
            _launch_ff(lib, out, amps, starts, incs, alg, fb_amt, n_carriers, master_volume,
                       scale, t0, t1, main, tape if taped else None)
    LAUNCHES["fm_exact"] += 1
    return out, tape


def exact_bwd_splits(n_items: int, n_ticks: int) -> int:
    """F2b's splits of an item's ticks: whole 8-tick steps each, enough that
    items x splits reaches ``EXACT_BWD_BLOCKS`` blocks, at most
    ``EXACT_BWD_MAX_SPLITS``, none empty: 4 at 1,024 items and 2,768
    ticks, 130 (a step each) at one item and 1,040."""
    steps = -(-n_ticks // 8)
    n = max(1, min(-(-EXACT_BWD_BLOCKS // n_items), steps, EXACT_BWD_MAX_SPLITS))
    per = -(-steps // n)
    return -(-steps // per)


def exact_bwd_scratch_bytes(n_items: int, n_samples: int) -> int:
    """Device bytes of F2b's scratch: e (then a), f32 a sample and item; the
    tick maps, 6 f32 a tick and item; and per split and item its map (8
    f32), seam (6) and partial sums (2): 0.43 GB at 1,024 items and 88,576
    samples. The forward's tape under a gradient is another 4 bytes a
    sample and item."""
    n_ticks = n_samples // BLOCK
    splits = exact_bwd_splits(n_items, n_ticks)
    return 4 * n_items * (n_samples + 6 * n_ticks + 16 * splits)


def fm_exact_bwd(tape, amps, starts, incs, alg, fb_amt, n_carriers, master_volume,
                 sample_rate: int, g_out):
    """F2b's wrapper: F2's tape (B, T*32) (the loop source's output on the
    items with feedback), F2's inputs and the waveforms' cotangent (None
    reads as zeros; any strides) on the card -> the gradients of
    ``amps``, ``starts``, ``incs`` ((T, B, 6) float32), ``fb_amt`` and
    ``master_volume`` ((B,) float32), as ``exact_pass_vjp`` gives them.
    Three launches on the caller's stream over ``exact_bwd_splits(B, T)``
    splits of the ticks: ``fm_exact_bwd_ff`` (the operators off the loop;
    e, the tick maps and the splits' maps), ``fm_exact_bwd_loop`` (the
    loop's recurrence and operators) and ``fm_exact_bwd_seams`` (the
    splits' partial sums and seams). Keeps
    ``exact_bwd_scratch_bytes(B, T*32)`` on the card and raises where that
    does not fit."""
    dev = amps.device
    if dev.type != "cuda":
        raise ValueError(f"F2b runs on the card; the plain version is exact_pass_vjp ({dev})")
    dev, T, B = _check_exact(amps, starts, incs, alg, fb_amt, n_carriers, master_volume)
    N = T * BLOCK
    _check("tape", tape, torch.float32, (B, N), dev)
    g_out = torch.zeros((B, N), dtype=torch.float32, device=dev) if g_out is None \
        else g_out.contiguous()
    _check("g_out", g_out, torch.float32, (B, N), dev)
    n_split = exact_bwd_splits(B, T)
    try:
        e = torch.empty((B, N), dtype=torch.float32, device=dev)
        tick_a = torch.empty((T, B, 4), dtype=torch.float32, device=dev)
        tick_b = torch.empty((T, B, 2), dtype=torch.float32, device=dev)
    except torch.cuda.OutOfMemoryError as err:
        raise RuntimeError(f"F2b's scratch needs {exact_bwd_scratch_bytes(B, N) / 2**30:.2f} GiB "
                           f"for {B} items x {N} samples, more than {dev} has free") from err
    split_a, split_b = (torch.empty((n_split, B, 4), dtype=torch.float32, device=dev)
                        for _ in range(2))
    seam = torch.empty((n_split, B, N_OPS), dtype=torch.float32, device=dev)
    part_mv, part_fb = (torch.empty((n_split, B), dtype=torch.float32, device=dev)
                        for _ in range(2))
    g_amps, g_starts, g_incs = (torch.empty((T, B, N_OPS), dtype=torch.float32, device=dev)
                                for _ in range(3))
    g_fb, g_mv = (torch.empty((B,), dtype=torch.float32, device=dev) for _ in range(2))
    scale = _fade_table(N, int(sample_rate), dev)
    ptrs = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    with torch.cuda.device(dev):
        _launch("fm_exact_bwd_ff", *ptrs(amps, starts, incs, alg, fb_amt, n_carriers,
                                         master_volume, scale, tape, g_out), B, T, n_split,
                *ptrs(e, tick_a, tick_b, split_a, split_b, g_amps, g_starts, g_incs, seam,
                      part_mv, part_fb))
        _launch("fm_exact_bwd_loop", *ptrs(amps, starts, incs, alg, fb_amt, tape, e, tick_a,
                                           tick_b, split_a, split_b), B, T, n_split,
                *ptrs(g_amps, g_starts, g_incs, seam, part_fb))
        _launch("fm_exact_bwd_seams", B, T, n_split, *ptrs(seam, part_mv, part_fb, g_amps,
                                                           g_fb, g_mv))
    LAUNCHES["fm_exact_bwd"] += 1
    return g_amps, g_starts, g_incs, g_fb, g_mv


_event_sink: list | None = None  # set by ``kernel_events``


@contextlib.contextmanager
def kernel_events():
    """Yields a list into which each F1b and F2b kernel launched inside
    appends ``(name, start, stop)``: CUDA events recorded on the stream
    just before and just after its launch (read them after a
    synchronize)."""
    global _event_sink
    outer, _event_sink = _event_sink, []
    try:
        yield _event_sink
    finally:
        _event_sink = outer


def _launch(name: str, *args):
    """Launches F1b's or F2b's kernel ``name`` on the current stream with
    ``args`` (pointers and ints); raises where the launch fails; counts
    it; inside ``kernel_events``, records an event on each side of it."""
    sink = _event_sink
    if sink is not None:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
    err = getattr(_fm_library(), f"{name}_launch")(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    if sink is not None:
        stop.record()
        sink.append((name, start, stop))


def fm_fb_loop(amps, starts, incs, alg, fb_amt):
    """F2's loop phase alone over all ticks, on the caller's stream: ->
    (B, T*32) float32 whose rows of items with feedback hold the loop
    source's output at every sample (``feedback_loop_pass``); the other
    rows are left unwritten."""
    dev, T, B = _check_exact(amps, starts, incs, alg, fb_amt)
    out = torch.empty((B, T * BLOCK), dtype=torch.float32, device=dev)
    fb = torch.empty((B, 2), dtype=torch.float32, device=dev)
    slots = loop_slots(alg, fb_amt)
    lib = _fm_library()
    with torch.cuda.device(dev):
        _launch_loop(lib, amps, starts, incs, alg, fb_amt, slots, 0, T, fb, out,
                     torch.cuda.current_stream(dev))
    return out


def fm_exact_ff(out, amps, starts, incs, alg, fb_amt, n_carriers, master_volume,
                sample_rate: int):
    """F2's feed-forward phase alone over all ticks, in place: reads the loop
    source's output from ``out`` (B, T*32) on the items with feedback and
    overwrites every element with the finished sample (``fade_and_volume``
    of ``feedforward_pass``); returns ``out``."""
    dev, T, B = _check_exact(amps, starts, incs, alg, fb_amt, n_carriers, master_volume)
    _check("out", out, torch.float32, (B, T * BLOCK), dev)
    scale = _fade_table(T * BLOCK, int(sample_rate), dev)
    lib = _fm_library()
    with torch.cuda.device(dev):
        _launch_ff(lib, out, amps, starts, incs, alg, fb_amt, n_carriers, master_volume, scale,
                   0, T, torch.cuda.current_stream(dev))
    return out


@functools.lru_cache(maxsize=8)
def _fade_table(n_samples: int, sample_rate: int, dev) -> torch.Tensor:
    return torch.from_numpy(fade_scale(n_samples, sample_rate)).to(dev)
