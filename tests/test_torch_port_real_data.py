"""The port's real-data path against the JAX package's, on the CPU: the
SysEx cartridge codec (``synth/sysex.py``), the SQLite preset database
(``synth/database.py``), ``DexedDataset(db_path=)``, and the
``train_from_syx`` entry point end to end.

Bars: every codec output and every database read bit-equal to the JAX
module's on the same bytes (the sysex fixtures of tests/test_sysex.py:
the exact round trip, checksums strict and lenient, a headerless bank, a
single VCED voice, 50 fuzzed blobs, a corrupt file among good ones); a
database written by either package reads back bit-equal in the other. The
entry point trains the full-width flagship for 2 epochs at batch 16 on 64
voices (the repo's example cartridge and one written from the seeded
``structured2`` generator) and evaluates it on the C++ re-render: every
metric finite.

The module's full-size (257x347) CPU runs take two torch threads
(``two_torch_threads`` of ``_torch_port_fixtures.py``).
"""

import functools
import json
import pathlib

import numpy as np
import pytest

from preset_gen_vae_tpu.data.dexed_dataset import DexedDataset as JaxDexedDataset
from preset_gen_vae_tpu.synth import database as jdb
from preset_gen_vae_tpu.synth import sysex as jsysex
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.scripts import train_from_syx
from preset_gen_vae_tpu_torch.synth import database as db
from preset_gen_vae_tpu_torch.synth import dexed_params as dx
from preset_gen_vae_tpu_torch.synth import sysex
from _torch_port_fixtures import isolated_data_root, two_torch_threads  # noqa: F401 (autouse)

EXAMPLE_BANK = pathlib.Path(__file__).resolve().parents[1] / "docs" / "examples" / \
    "structured2_bank.syx"


def _grid_exact_corpus(n, seed=0):
    """tests/test_sysex.py's fixture: structured2 presets with every
    cartridge-carried parameter on its DX7 step grid."""
    p, names, _ = db.generate_structured_corpus_v2(n, seed=seed)
    steps = {dx.op_param_index(op, off): 99 for op in range(1, 7)
             for off in (dx.OFF_BREAKPOINT, dx.OFF_L_DEPTH, dx.OFF_R_DEPTH,
                         dx.OFF_OUTPUT_LEVEL, dx.OFF_FREQ_FINE, *dx.OFF_EG_RATES,
                         *dx.OFF_EG_LEVELS)}
    steps.update({dx.IDX_PITCH_EG_FIRST + j: 99 for j in range(8)})
    steps.update({i: 99 for i in (dx.IDX_LFO_SPEED, dx.IDX_LFO_DELAY, dx.IDX_LFO_PM_DEPTH,
                                  dx.IDX_LFO_AM_DEPTH)})
    steps[dx.IDX_TRANSPOSE] = 48
    for i, s in steps.items():
        p[:, i] = np.rint(p[:, i] * s) / s
    return p, names


def _parse_both(raw: bytes, **kw):
    """(port's and JAX's (presets, names, problems)), or the ValueError each raised."""
    out = []
    for mod in (sysex, jsysex):
        problems = []
        try:
            out.append((*mod.parse_syx(raw, problems=problems, **kw), problems))
        except ValueError as e:
            out.append(str(e))
    return out


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(got, str):
        assert got == want
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.float32
    assert got[1:] == want[1:]


def _vced_blob(p, name=b"VCEDVOICE "):
    """A single-voice VCED dump of preset ``p`` (tests/test_sysex.py)."""
    v = np.zeros(155, dtype=np.uint8)
    for slot in range(6):
        base, b = dx.op_param_index(6 - slot, 0), slot * 21
        fields = [(dx.OFF_EG_RATES[j], 99) for j in range(4)] + \
            [(dx.OFF_EG_LEVELS[j], 99) for j in range(4)] + \
            [(dx.OFF_BREAKPOINT, 99), (dx.OFF_L_DEPTH, 99), (dx.OFF_R_DEPTH, 99),
             (dx.OFF_L_CURVE, 3), (dx.OFF_R_CURVE, 3), (dx.OFF_RATE_SCALING, 7),
             (dx.OFF_AMP_MOD_SENS, 3), (dx.OFF_KEY_VELOCITY, 7), (dx.OFF_OUTPUT_LEVEL, 99),
             (dx.OFF_MODE, 1), (dx.OFF_FREQ_COARSE, 31), (dx.OFF_FREQ_FINE, 99),
             (dx.OFF_DETUNE, 14)]
        for j, (off, steps) in enumerate(fields):
            v[b + j] = round(float(p[base + off]) * steps)
    for j in range(8):
        v[126 + j] = round(float(p[dx.IDX_PITCH_EG_FIRST + j]) * 99)
    for j, (idx, steps) in enumerate([
            (dx.IDX_ALGORITHM, 31), (dx.IDX_FEEDBACK, 7), (dx.IDX_OSC_KEY_SYNC, 1),
            (dx.IDX_LFO_SPEED, 99), (dx.IDX_LFO_DELAY, 99), (dx.IDX_LFO_PM_DEPTH, 99),
            (dx.IDX_LFO_AM_DEPTH, 99), (dx.IDX_LFO_KEY_SYNC, 1), (dx.IDX_LFO_WAVE, 5),
            (dx.IDX_PITCH_MOD_SENS, 7), (dx.IDX_TRANSPOSE, 48)]):
        v[134 + j] = round(float(p[idx]) * steps)
    v[145:155] = np.frombuffer(name, dtype=np.uint8)
    csum = (128 - (int(v.sum()) & 0x7F)) & 0x7F
    return bytes([0xF0, 0x43, 0x00, 0x00, 0x01, 0x1B]) + v.tobytes() + bytes([csum, 0xF7])


def test_syx_round_trip_is_the_jax_modules():
    p, names = _grid_exact_corpus(40, seed=3)
    blob = sysex.write_syx(p, names)
    assert blob == jsysex.write_syx(p, names) and len(blob) == 2 * (6 + 4096 + 2)
    got, want = _parse_both(blob)
    _assert_same(got, want)
    assert got[0].shape == (64, dx.N_PARAMS) and got[2] == []
    assert sysex.write_syx(got[0], got[1]) == jsysex.write_syx(want[0], want[1])


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "lenient"])
def test_syx_checksum_is_the_jax_modules(strict):
    p, names = _grid_exact_corpus(32)
    blob = bytearray(sysex.write_syx(p, names))
    blob[100] ^= 0x05  # one corrupt data byte
    got, want = _parse_both(bytes(blob), strict=strict)
    _assert_same(got, want)
    if strict:
        assert "checksum" in got
    else:
        assert any("checksum mismatch" in s for s in got[2])


@pytest.mark.parametrize("form", ["bare", "checksum", "framing"])
def test_syx_headerless_bank_is_the_jax_modules(form):
    p, names = _grid_exact_corpus(32, seed=5)
    blob = sysex.write_syx(p, names)
    data = blob[6:6 + sysex.BANK_DATA_BYTES]
    raw = {"bare": data, "checksum": data + blob[-2:-1],
           "framing": blob[:3] + b"\x05" + blob[4:-1] + b"\x00"}[form]
    got, want = _parse_both(raw)
    _assert_same(got, want)
    assert got[0].shape == (32, dx.N_PARAMS) and any("recovered" in s for s in got[2])


def test_syx_single_vced_voice_is_the_jax_modules():
    p, _ = _grid_exact_corpus(32, seed=7)
    got, want = _parse_both(_vced_blob(p[0]))
    _assert_same(got, want)
    assert got[0].shape == (1, dx.N_PARAMS) and got[1] == ["VCEDVOICE"]


def test_syx_fuzz_is_the_jax_modules():
    """50 random blobs salted with header fragments (tests/test_sysex.py),
    every other one around a real bank dump or VCED voice with random bytes
    overwritten: the same presets, names and problems, or the same
    ValueError."""
    rng = np.random.default_rng(0)
    p, names = _grid_exact_corpus(32, seed=13)
    dumps = [np.frombuffer(sysex.write_syx(p, names), dtype=np.uint8),
             np.frombuffer(_vced_blob(p[1]), dtype=np.uint8)]
    parsed = 0
    for trial in range(50):
        n = int(rng.integers(0, 9000))
        raw = rng.integers(0, 256, size=n, dtype=np.uint8)
        for frag in (b"\xf0\x43\x00\x09\x20\x00", b"\xf0\x43\x00\x00\x01\x1b"):
            if n > 700:
                off = int(rng.integers(0, n - 7))
                raw[off:off + 6] = np.frombuffer(frag, dtype=np.uint8)
        if trial % 2:
            dump = dumps[trial // 2 % 2].copy()
            hits = rng.integers(6, len(dump) - 2, size=int(rng.integers(0, 8)))
            dump[hits] = rng.integers(0, 256, size=len(hits), dtype=np.uint8)
            cut = int(rng.integers(0, n + 1))
            raw = np.concatenate([raw[:cut], dump, raw[cut:]])
        got, want = _parse_both(raw.tobytes())
        _assert_same(got, want)
        parsed += not isinstance(got, str)
    assert 0 < parsed < 50


def test_import_syx_banks_skips_a_corrupt_file_as_the_jax_module(tmp_path, capsys):
    p, names = _grid_exact_corpus(64, seed=11)
    good = tmp_path / "good.syx"
    good.write_bytes(sysex.write_syx(p, names))
    bad = tmp_path / "bad.syx"
    bad.write_bytes(b"\x00\x01\x02 not a cartridge at all")
    reports = []
    results = []
    for mod, out in ((sysex, tmp_path / "port.sqlite"), (jsysex, tmp_path / "jax.sqlite")):
        results.append(mod.import_syx_banks([good, bad, EXAMPLE_BANK], out_sqlite=out))
        reports.append(capsys.readouterr().out)
        with pytest.raises(ValueError, match="no DX7 voices"):
            mod.import_syx_banks([bad])
        capsys.readouterr()
    (gp, gn, gl), (wp, wn, wl) = results
    np.testing.assert_array_equal(gp, wp)
    assert gp.shape == (96, dx.N_PARAMS) and gn == wn and gl == wl
    assert reports[0] == reports[1] and "skipped 1 unparseable file" in reports[0]
    assert (tmp_path / "port.sqlite").read_bytes() == (tmp_path / "jax.sqlite").read_bytes()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_database_reads_back_bit_equal_in_the_other_package(tmp_path, writer):
    p, names, labels = db.generate_structured_corpus_v2(40, seed=4)
    path = tmp_path / "presets.sqlite"
    (db if writer == "port" else jdb).create_database(path, p, names, labels)
    got, want = db.PresetDatabase(path), jdb.PresetDatabase(path)
    np.testing.assert_array_equal(got.presets_matrix, p)
    np.testing.assert_array_equal(got.presets_matrix, want.presets_matrix)
    np.testing.assert_array_equal(got.preset_indexes, want.preset_indexes)
    assert (got.names, got.labels, got.param_names) == (want.names, want.labels,
                                                        want.param_names)
    assert len(got) == got.nb_presets == 40 and got.nb_params == dx.N_PARAMS
    for uid in (0, 17, 39):
        np.testing.assert_array_equal(got.get_preset_values(uid), want.get_preset_values(uid))
        assert got.get_preset_name(uid) == want.get_preset_name(uid)
        assert got.get_preset_labels(uid) == want.get_preset_labels(uid)
    got.write_all_presets_to_files(tmp_path / "port_files")
    want.write_all_presets_to_files(tmp_path / "jax_files")
    files = sorted(f.name for f in (tmp_path / "port_files").iterdir())
    assert len(files) == 3 * 40 and files == sorted(
        f.name for f in (tmp_path / "jax_files").iterdir())
    for f in files:
        assert (tmp_path / "port_files" / f).read_bytes() == \
            (tmp_path / "jax_files" / f).read_bytes(), f


@pytest.mark.parametrize("restrict", [None, ("percussive",)], ids=["all", "percussive"])
def test_db_dataset_is_the_jax_packages(tmp_path, restrict):
    """``DexedDataset(db_path=)``: the constrained presets, UIDs, names,
    labels and learnable layout of the JAX package's, and its content-hashed
    cache tag."""
    p, names = _grid_exact_corpus(64, seed=9)
    syx = tmp_path / "bank.syx"
    syx.write_bytes(sysex.write_syx(p, names))
    db_path = tmp_path / "real.sqlite"
    sysex.import_syx_banks([syx, EXAMPLE_BANK], out_sqlite=db_path)
    kw = dict(db_path=str(db_path), operators=(1, 2, 3), restrict_to_labels=restrict)
    port = DexedDataset(device="cpu", data_root=tmp_path / "port", **kw)
    jds = JaxDexedDataset(data_root=tmp_path / "jax", **kw)
    np.testing.assert_array_equal(port.uids, jds.valid_preset_UIDs)
    assert 0 < len(port.uids) <= 96 and (restrict is None) == (len(port.uids) == 96)
    np.testing.assert_array_equal(port.presets, np.stack(
        [jds.get_full_preset_params(u) for u in jds.valid_preset_UIDs]))
    for u in port.uids:
        assert port.get_name_from_preset_UID(u) == jds.get_name_from_preset_UID(u)
        np.testing.assert_array_equal(port.get_labels_tensor(u), jds.get_labels_tensor(u))
    assert port.get_labels_tensor(port.uids[0]).dtype == np.int8
    assert port.learnable_params_tensor_length == jds.learnable_params_tensor_length
    assert port._corpus_tag() == jds._corpus_tag() and "_db" in port._corpus_tag()


def test_train_from_syx_entry_point_on_cpu(tmp_path, capsys, monkeypatch):
    """The user recipe through the port's entry point: cartridges -> SQLite
    -> 2 epochs of the flagship -> eval, one JSON line per phase, every
    metric finite; the eval reloads the corpus cached by the train (both
    tiers and the sidecar under the data root). The script's configs are
    the defaults; here the batch is 16 and the eval re-renders on the C++
    engine (the plain FM render takes ~40 s a note on the CPU)."""
    monkeypatch.setattr(train_from_syx, "TrainConfig",
                        functools.partial(cfg.TrainConfig, minibatch_size=16))
    monkeypatch.setattr(train_from_syx, "EvalConfig",
                        functools.partial(cfg.EvalConfig, audio_render_backend="cpp"))
    p, names, _ = db.generate_structured_corpus_v2(32, seed=31)
    banks = [EXAMPLE_BANK, tmp_path / "bank31.syx"]
    banks[1].write_bytes(sysex.write_syx(p, names))
    data_root = tmp_path / "data"
    train_from_syx.main([*map(str, banks), "--db", str(tmp_path / "real.sqlite"),
                         "--run-name", "syx0", "--epochs", "2",
                         "--logs-root", str(tmp_path / "saved"), "--data-root", str(data_root),
                         "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["phase"] for ln in lines] == ["import", "train", "eval"]
    imported, trained, evaluated = lines
    assert imported["voices"] == 64 and set(imported["labels"]) <= set(db.LABELS_VOCAB)
    assert trained["epochs_trained"] == 2 and trained["corpus_presets"] == 64
    assert trained["input_size"] == [16, 1, 257, 347]
    assert all(np.isfinite(v) for v in trained.values() if isinstance(v, float))
    assert evaluated["epoch"] == 1 and evaluated["n_items"] > 0
    for k in ("num_eval_loss", "acc", "spec_mae", "mfcc13_mae", "mfcc40_mae"):
        assert np.isfinite(evaluated[k]), k
    (cache,) = (data_root / "dexed").iterdir()
    assert {"spec_stats.json", "specs_raw.npy", "specs_norm_f16.npy",
            "render_constraints.json", "gt_eval_audio"} <= {f.name for f in cache.iterdir()}
