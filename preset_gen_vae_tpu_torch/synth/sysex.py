"""Copy of ``preset_gen_vae_tpu/synth/sysex.py`` (:57-449 there:
``parse_syx``, ``write_syx``, ``import_syx_banks``, their helpers and the
CLI), unchanged apart from this docstring and the CLI's module name. Each
function returns the JAX module's values bit for bit
(``tests/test_torch_port_real_data.py``).

DX7 SysEx cartridge import/export (32-voice bulk dump, format 9): reads
real DX7 ``.syx`` cartridge banks (the public Yamaha 32-voice packed
bulk-dump format) into the normalized (N, 155) preset matrix, and writes
corpora back out as cartridges that DX7 hardware or the Dexed VST load.

Format (public Yamaha spec; byte layout also implemented by Dexed's
sysex.cc): header F0 43 0n 09 20 00, then 4096 data bytes = 32 voices x
128 packed bytes (operators stored OP6 first), a 2's-complement checksum
of the data bytes, F7. Per-voice packed layout:

  op*17 + 0..3   EG rates R1-R4 (0-99)        op*17 + 4..7  EG levels
  +8 breakpoint  +9 left depth  +10 right depth
  +11 bits0-1 left curve, bits2-3 right curve
  +12 bits0-2 rate scaling, bits3-6 detune (0-14)
  +13 bits0-1 AM sens, bits2-4 key velocity
  +14 output level   +15 bit0 osc mode, bits1-5 freq coarse
  +16 freq fine
  102-109 pitch EG rates+levels   110 algorithm (0-31)
  111 bits0-2 feedback, bit3 osc key sync
  112-115 LFO speed/delay/PM depth/AM depth
  116 bit0 LFO key sync, bits1-3 LFO wave, bits4-6 pitch mod sens
  117 transpose (0-48, 24 = center)   118-127 voice name (ASCII)

Params the cartridge does not carry (filter cutoff/resonance, output,
master tune, per-op on/off switches) take the reference's defaults
(synth/dexed.py:309-312; switches all on).

Wild-format tolerance: concatenated multi-bank files, banks with wrong
checksums (kept with a warning unless ``strict=True``), single-voice
155-byte VCED dumps (F0 43 0n 00 01 1B), and headerless raw 4,096-byte
bank images all import; ``import_syx_banks`` skips unparseable files with
a printed report instead of aborting.

    python -m preset_gen_vae_tpu_torch.synth.sysex BANK.syx ... -o out.sqlite
"""

from __future__ import annotations

import pathlib
from typing import List, Sequence, Tuple

import numpy as np

from . import dexed_params as dx

VOICES_PER_BANK = 32
PACKED_VOICE_BYTES = 128
BANK_DATA_BYTES = VOICES_PER_BANK * PACKED_VOICE_BYTES  # 4096
_HEADER_LEN = 6  # F0 43 0n 09 20 00


def _checksum(data: np.ndarray) -> int:
    """2's-complement checksum over the 4096 data bytes (masked to 7 bits)."""
    return int((128 - (int(data.sum()) & 0x7F)) & 0x7F)


def _find_banks(raw: bytes, strict: bool, problems: List[str]) -> List[np.ndarray]:
    """All 32-voice bulk dumps in a .syx blob (files often concatenate
    several dumps); returns each bank's 4096 data bytes.

    Real-world cartridge rips are messy (VERDICT r4 #7): wrong checksums
    are common (edited dumps whose authors never recomputed the sum).
    Lenient mode (default) keeps the bank and records the problem;
    ``strict=True`` restores the raise."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    banks = []
    i = 0
    while i < len(buf):
        if buf[i] != 0xF0:
            i += 1
            continue
        # Yamaha 32-voice bulk dump: F0 43 0n 09 20 00 <4096> <sum> F7
        end = i + _HEADER_LEN + BANK_DATA_BYTES + 2
        if (
            end <= len(buf)
            and buf[i + 1] == 0x43
            and (buf[i + 2] & 0xF0) == 0x00
            and buf[i + 3] == 0x09
            and buf[i + 4] == 0x20
            and buf[i + 5] == 0x00
            and buf[end - 1] == 0xF7
        ):
            data = buf[i + _HEADER_LEN : i + _HEADER_LEN + BANK_DATA_BYTES]
            if int(buf[end - 2]) != _checksum(data):
                msg = (
                    f"DX7 bank at byte {i}: checksum mismatch "
                    f"(stored {int(buf[end - 2])}, computed {_checksum(data)})"
                )
                if strict:
                    raise ValueError(msg)
                problems.append(msg + " — kept (lenient mode)")
            banks.append(data.copy())
            i = end
        else:
            i += 1
    return banks


# Single-voice VCED dump: F0 43 0n 00 01 1B <155 unpacked bytes> <sum> F7
# (the edit-buffer format hardware sends for "voice transmit"; byte count
# 0x011B = 155). Parameter order is the public VCED table: per-op (OP6
# first) 21 bytes [EG r1-4, EG l1-4, breakpoint, Ldepth, Rdepth, Lcurve,
# Rcurve, rate scaling, AM sens, key velocity, output level, mode, coarse,
# fine, detune], then pitch EG 8, algorithm, feedback, osc sync, LFO
# speed/delay/PMD/AMD/sync/wave, pitch mod sens, transpose, 10-char name.
VCED_DATA_BYTES = 155


def _find_vced_voices(
    raw: bytes, strict: bool, problems: List[str]
) -> List[np.ndarray]:
    buf = np.frombuffer(raw, dtype=np.uint8)
    voices = []
    i = 0
    while i < len(buf):
        end = i + _HEADER_LEN + VCED_DATA_BYTES + 2
        if (
            buf[i] == 0xF0
            and end <= len(buf)
            and buf[i + 1] == 0x43
            and (buf[i + 2] & 0xF0) == 0x00
            and buf[i + 3] == 0x00
            and buf[i + 4] == 0x01
            and buf[i + 5] == 0x1B
            and buf[end - 1] == 0xF7
        ):
            data = buf[i + _HEADER_LEN : i + _HEADER_LEN + VCED_DATA_BYTES]
            if int(buf[end - 2]) != _checksum(data):
                msg = f"VCED voice at byte {i}: checksum mismatch"
                if strict:
                    raise ValueError(msg)
                problems.append(msg + " — kept (lenient mode)")
            voices.append(data.copy())
            i = end
        else:
            i += 1
    return voices


def _unpack_vced(v: np.ndarray) -> Tuple[np.ndarray, str]:
    """155 unpacked VCED bytes -> ((155,) normalized preset, name)."""
    p = np.zeros((dx.N_PARAMS,), dtype=np.float32)
    dx.set_default_general_filter_and_tune_params(p)
    v = v.astype(np.int64)
    for slot in range(6):  # OP6 first, 21 bytes each
        op = 6 - slot
        b = slot * 21
        base = dx.op_param_index(op, 0)
        for j in range(4):
            p[base + dx.OFF_EG_RATES[j]] = min(v[b + j], 99) / 99.0
            p[base + dx.OFF_EG_LEVELS[j]] = min(v[b + 4 + j], 99) / 99.0
        p[base + dx.OFF_BREAKPOINT] = min(v[b + 8], 99) / 99.0
        p[base + dx.OFF_L_DEPTH] = min(v[b + 9], 99) / 99.0
        p[base + dx.OFF_R_DEPTH] = min(v[b + 10], 99) / 99.0
        p[base + dx.OFF_L_CURVE] = min(v[b + 11], 3) / 3.0
        p[base + dx.OFF_R_CURVE] = min(v[b + 12], 3) / 3.0
        p[base + dx.OFF_RATE_SCALING] = min(v[b + 13], 7) / 7.0
        p[base + dx.OFF_AMP_MOD_SENS] = min(v[b + 14], 3) / 3.0
        p[base + dx.OFF_KEY_VELOCITY] = min(v[b + 15], 7) / 7.0
        p[base + dx.OFF_OUTPUT_LEVEL] = min(v[b + 16], 99) / 99.0
        p[base + dx.OFF_MODE] = float(min(v[b + 17], 1))
        p[base + dx.OFF_FREQ_COARSE] = min(v[b + 18], 31) / 31.0
        p[base + dx.OFF_FREQ_FINE] = min(v[b + 19], 99) / 99.0
        p[base + dx.OFF_DETUNE] = min(v[b + 20], 14) / 14.0
        p[base + dx.OFF_SWITCH] = 1.0
    for j in range(8):
        p[dx.IDX_PITCH_EG_FIRST + j] = min(v[126 + j], 99) / 99.0
    p[dx.IDX_ALGORITHM] = min(v[134], 31) / 31.0
    p[dx.IDX_FEEDBACK] = min(v[135], 7) / 7.0
    p[dx.IDX_OSC_KEY_SYNC] = float(min(v[136], 1))
    p[dx.IDX_LFO_SPEED] = min(v[137], 99) / 99.0
    p[dx.IDX_LFO_DELAY] = min(v[138], 99) / 99.0
    p[dx.IDX_LFO_PM_DEPTH] = min(v[139], 99) / 99.0
    p[dx.IDX_LFO_AM_DEPTH] = min(v[140], 99) / 99.0
    p[dx.IDX_LFO_KEY_SYNC] = float(min(v[141], 1))
    p[dx.IDX_LFO_WAVE] = min(v[142], 5) / 5.0
    p[dx.IDX_PITCH_MOD_SENS] = min(v[143], 7) / 7.0
    p[dx.IDX_TRANSPOSE] = min(v[144], 48) / 48.0
    name = bytes(int(c) & 0x7F for c in v[145:155]).decode(
        "ascii", errors="replace"
    ).strip()
    return p, name


def _unpack_voice(v: np.ndarray) -> Tuple[np.ndarray, str]:
    """128 packed bytes -> ((155,) normalized preset, voice name)."""
    p = np.zeros((dx.N_PARAMS,), dtype=np.float32)
    dx.set_default_general_filter_and_tune_params(p)
    v = v.astype(np.int64)

    for slot in range(6):  # dump order: OP6 first
        op = 6 - slot
        b = slot * 17
        base = dx.op_param_index(op, 0)
        for j in range(4):
            p[base + dx.OFF_EG_RATES[j]] = min(v[b + j], 99) / 99.0
            p[base + dx.OFF_EG_LEVELS[j]] = min(v[b + 4 + j], 99) / 99.0
        p[base + dx.OFF_BREAKPOINT] = min(v[b + 8], 99) / 99.0
        p[base + dx.OFF_L_DEPTH] = min(v[b + 9], 99) / 99.0
        p[base + dx.OFF_R_DEPTH] = min(v[b + 10], 99) / 99.0
        p[base + dx.OFF_L_CURVE] = (v[b + 11] & 0x03) / 3.0
        p[base + dx.OFF_R_CURVE] = ((v[b + 11] >> 2) & 0x03) / 3.0
        p[base + dx.OFF_RATE_SCALING] = (v[b + 12] & 0x07) / 7.0
        p[base + dx.OFF_DETUNE] = min((v[b + 12] >> 3) & 0x0F, 14) / 14.0
        p[base + dx.OFF_AMP_MOD_SENS] = (v[b + 13] & 0x03) / 3.0
        p[base + dx.OFF_KEY_VELOCITY] = ((v[b + 13] >> 2) & 0x07) / 7.0
        p[base + dx.OFF_OUTPUT_LEVEL] = min(v[b + 14], 99) / 99.0
        p[base + dx.OFF_MODE] = float(v[b + 15] & 0x01)
        p[base + dx.OFF_FREQ_COARSE] = ((v[b + 15] >> 1) & 0x1F) / 31.0
        p[base + dx.OFF_FREQ_FINE] = min(v[b + 16], 99) / 99.0
        p[base + dx.OFF_SWITCH] = 1.0  # not in the dump: all ops on

    for j in range(8):  # pitch EG rates 1-4 then levels 1-4
        p[dx.IDX_PITCH_EG_FIRST + j] = min(v[102 + j], 99) / 99.0
    p[dx.IDX_ALGORITHM] = min(v[110], 31) / 31.0
    p[dx.IDX_FEEDBACK] = (v[111] & 0x07) / 7.0
    p[dx.IDX_OSC_KEY_SYNC] = float((v[111] >> 3) & 0x01)
    p[dx.IDX_LFO_SPEED] = min(v[112], 99) / 99.0
    p[dx.IDX_LFO_DELAY] = min(v[113], 99) / 99.0
    p[dx.IDX_LFO_PM_DEPTH] = min(v[114], 99) / 99.0
    p[dx.IDX_LFO_AM_DEPTH] = min(v[115], 99) / 99.0
    p[dx.IDX_LFO_KEY_SYNC] = float(v[116] & 0x01)
    p[dx.IDX_LFO_WAVE] = min((v[116] >> 1) & 0x07, 5) / 5.0
    p[dx.IDX_PITCH_MOD_SENS] = min((v[116] >> 4) & 0x07, 7) / 7.0
    p[dx.IDX_TRANSPOSE] = min(v[117], 48) / 48.0

    name = bytes(int(c) & 0x7F for c in v[118:128]).decode(
        "ascii", errors="replace"
    ).strip()
    return p, name


def _pack_voice(p: np.ndarray, name: str) -> np.ndarray:
    """(155,) normalized preset -> 128 packed bytes (inverse of
    ``_unpack_voice``; lossy only for params the cartridge lacks)."""
    v = np.zeros((PACKED_VOICE_BYTES,), dtype=np.uint8)

    def q(x, steps):  # [0,1] -> 0..steps
        return int(np.clip(np.rint(float(x) * steps), 0, steps))

    for slot in range(6):
        op = 6 - slot
        b = slot * 17
        base = dx.op_param_index(op, 0)
        for j in range(4):
            v[b + j] = q(p[base + dx.OFF_EG_RATES[j]], 99)
            v[b + 4 + j] = q(p[base + dx.OFF_EG_LEVELS[j]], 99)
        v[b + 8] = q(p[base + dx.OFF_BREAKPOINT], 99)
        v[b + 9] = q(p[base + dx.OFF_L_DEPTH], 99)
        v[b + 10] = q(p[base + dx.OFF_R_DEPTH], 99)
        v[b + 11] = q(p[base + dx.OFF_L_CURVE], 3) | (
            q(p[base + dx.OFF_R_CURVE], 3) << 2
        )
        v[b + 12] = q(p[base + dx.OFF_RATE_SCALING], 7) | (
            q(p[base + dx.OFF_DETUNE], 14) << 3
        )
        v[b + 13] = q(p[base + dx.OFF_AMP_MOD_SENS], 3) | (
            q(p[base + dx.OFF_KEY_VELOCITY], 7) << 2
        )
        v[b + 14] = q(p[base + dx.OFF_OUTPUT_LEVEL], 99)
        v[b + 15] = q(p[base + dx.OFF_MODE], 1) | (
            q(p[base + dx.OFF_FREQ_COARSE], 31) << 1
        )
        v[b + 16] = q(p[base + dx.OFF_FREQ_FINE], 99)

    for j in range(8):
        v[102 + j] = q(p[dx.IDX_PITCH_EG_FIRST + j], 99)
    v[110] = q(p[dx.IDX_ALGORITHM], 31)
    v[111] = q(p[dx.IDX_FEEDBACK], 7) | (q(p[dx.IDX_OSC_KEY_SYNC], 1) << 3)
    v[112] = q(p[dx.IDX_LFO_SPEED], 99)
    v[113] = q(p[dx.IDX_LFO_DELAY], 99)
    v[114] = q(p[dx.IDX_LFO_PM_DEPTH], 99)
    v[115] = q(p[dx.IDX_LFO_AM_DEPTH], 99)
    v[116] = q(p[dx.IDX_LFO_KEY_SYNC], 1) | (q(p[dx.IDX_LFO_WAVE], 5) << 1) | (
        q(p[dx.IDX_PITCH_MOD_SENS], 7) << 4
    )
    v[117] = q(p[dx.IDX_TRANSPOSE], 48)
    nm = name.encode("ascii", errors="replace")[:10].ljust(10, b" ")
    v[118:128] = np.frombuffer(nm, dtype=np.uint8)
    return v


def parse_syx(
    raw: bytes, strict: bool = False, problems: List[str] | None = None
) -> Tuple[np.ndarray, List[str]]:
    """.syx blob -> ((N, 155) normalized presets, voice names).

    Accepts, in priority order (VERDICT r4 #7 — wild-format cartridges):
    32-voice bulk dumps (possibly several, concatenated; wrong checksums
    tolerated unless ``strict``), single-voice 155-byte VCED dumps, and
    headerless raw 4,096/4,104-byte bank images (rips that lost their
    SysEx framing). ``problems``, if given, collects human-readable notes
    about every tolerated malformation."""
    if problems is None:
        problems = []
    banks = _find_banks(raw, strict, problems)
    presets, names = [], []
    for data in banks:
        for k in range(VOICES_PER_BANK):
            p, name = _unpack_voice(
                data[k * PACKED_VOICE_BYTES : (k + 1) * PACKED_VOICE_BYTES]
            )
            presets.append(p)
            names.append(name)
    for data in _find_vced_voices(raw, strict, problems):
        p, name = _unpack_vced(data)
        presets.append(p)
        names.append(name)
    if not presets:
        # headerless rips: a bare 4096-byte packed bank image, optionally
        # with a trailing checksum (4097) or stripped-framing 4104 layout
        buf = np.frombuffer(raw, dtype=np.uint8)
        data = None
        if len(buf) == BANK_DATA_BYTES:
            data, how = buf, "headerless 4096-byte bank image"
        elif len(buf) == BANK_DATA_BYTES + 1:
            data, how = buf[:BANK_DATA_BYTES], "headerless bank + checksum"
        elif (
            len(buf) == _HEADER_LEN + BANK_DATA_BYTES + 2
            and buf[0] == 0xF0
            and buf[1] == 0x43
        ):
            data = buf[_HEADER_LEN : _HEADER_LEN + BANK_DATA_BYTES]
            how = "bank with corrupt framing (bad substatus or missing F7)"
        if data is not None and not strict:
            if data.max() > 0x7F:
                problems.append(
                    "headerless candidate has bytes >0x7F — masked to 7 bits"
                )
                data = data & 0x7F
            problems.append(f"recovered {how}")
            for k in range(VOICES_PER_BANK):
                p, name = _unpack_voice(
                    data[k * PACKED_VOICE_BYTES : (k + 1) * PACKED_VOICE_BYTES]
                )
                presets.append(p)
                names.append(name)
    if not presets:
        raise ValueError(
            "no DX7 voice data found (32-voice bulk dump F0 43 0n 09 20 00, "
            "single-voice VCED F0 43 0n 00 01 1B, or raw 4096-byte bank)"
        )
    return np.stack(presets), names


def write_syx(presets: np.ndarray, names: Sequence[str] | None = None) -> bytes:
    """(N, 155) normalized presets -> .syx bytes (one 32-voice bulk dump per
    32 presets; the final bank is padded by repeating the last preset)."""
    presets = np.asarray(presets, dtype=np.float32)
    n = presets.shape[0]
    assert n > 0 and presets.shape[1] == dx.N_PARAMS
    names = list(names) if names is not None else [f"VOICE {i:04d}" for i in range(n)]
    out = bytearray()
    for s in range(0, n, VOICES_PER_BANK):
        chunk = list(range(s, min(s + VOICES_PER_BANK, n)))
        while len(chunk) < VOICES_PER_BANK:
            chunk.append(chunk[-1])
        data = np.concatenate(
            [_pack_voice(presets[i], names[i]) for i in chunk]
        )
        out += bytes([0xF0, 0x43, 0x00, 0x09, 0x20, 0x00])
        out += data.tobytes()
        out += bytes([_checksum(data), 0xF7])
    return bytes(out)


def import_syx_banks(paths, out_sqlite=None):
    """Reads DX7 cartridge files into a corpus; optionally writes the
    reference-layout sqlite so the standard ``db_path`` dataset flow
    (data/dexed_dataset.py) serves REAL human presets.

    Labels use the same carrier-envelope heuristic as the synthetic
    generators (vocab parity with the reference's scraped labels,
    synth/dexed.py:205-206).

    Unparseable files are skipped with a printed report rather than
    aborting the import (VERDICT r4 #7: one corrupt cartridge in a
    directory of hundreds must not kill the run); raises only when NO
    file yields any voice.

    :returns: (presets (N, 155), names, labels)
    """
    presets, names = [], []
    skipped: List[str] = []
    for path in ([paths] if isinstance(paths, (str, pathlib.Path)) else paths):
        problems: List[str] = []
        try:
            p, nm = parse_syx(pathlib.Path(path).read_bytes(), problems=problems)
        except (ValueError, OSError) as e:
            skipped.append(f"{path}: {e}")
            continue
        for note in problems:
            print(f"[sysex] {path}: {note}")
        presets.append(p)
        names.extend(nm)
    if skipped:
        print(f"[sysex] skipped {len(skipped)} unparseable file(s):")
        for s in skipped:
            print(f"[sysex]   {s}")
    if not presets:
        raise ValueError(
            f"no DX7 voices found in any of the {len(skipped)} input file(s)"
        )
    presets = np.concatenate(presets)

    # carrier-envelope label heuristic (as generate_structured_corpus)
    alg = np.rint(presets[:, dx.IDX_ALGORITHM] * 31.0).astype(int)
    masks = np.asarray([dx.ALGORITHM_CARRIER_MASKS[a] for a in alg])
    carrier = ((masks[:, None] >> np.arange(6)[None, :]) & 1).astype(bool)
    sus = np.stack(
        [presets[:, dx.op_param_index(op, dx.OFF_EG_LEVELS[2])]
         for op in range(1, 7)], axis=1,
    )
    car_sus = np.where(carrier, sus, np.nan)
    percussive = np.nanmean(car_sus, axis=1) < 0.3
    fixed_any = np.zeros(len(presets), dtype=bool)
    for op in range(1, 7):
        fixed_any |= presets[:, dx.op_param_index(op, dx.OFF_MODE)] > 0.5
    labels = np.where(
        fixed_any, "sfx", np.where(percussive, "percussive", "harmonic")
    ).tolist()

    if out_sqlite is not None:
        from .database import create_database

        create_database(out_sqlite, presets, names, labels)
    return presets, names, labels


if __name__ == "__main__":  # python -m preset_gen_vae_tpu_torch.synth.sysex
    import argparse

    ap = argparse.ArgumentParser(
        description="Import DX7 .syx cartridges into a training database"
    )
    ap.add_argument("syx", nargs="+", help=".syx cartridge files")
    ap.add_argument("-o", "--out", required=True,
                    help="output sqlite path (reference schema)")
    args = ap.parse_args()
    pr, nm, lb = import_syx_banks(args.syx, out_sqlite=args.out)
    import collections

    print(f"imported {len(pr)} voices from {len(args.syx)} file(s) "
          f"-> {args.out}; labels: {dict(collections.Counter(lb))}")
