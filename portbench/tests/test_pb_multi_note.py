"""The train kind on an un-stacked multi-note model with MIDI in z0, the
layout of ``multi6.train``, on the CPU at a tiny size
(``data/tiny_multi.json``: FlowVAE, dim_z 16, three notes, each (preset,
note) its own item, pitch and velocity in z0 dims 0-1, 16 presets, batch
8), under ``multi6.train``'s own limits: a sound run reads ``correct``
true, and a fault confined to the MIDI path (the program's pitch column
shifted by one note) makes it false.

Beside it, ``train.working_gib``'s reader on fixed contexts: the summary's
``memory`` block, what the run holds on the card less the corpus and the
model state, and None where the summary has no such block (off the card,
or a program without it)."""

import json
import pathlib

import pytest
import torch

from portbench import registry
from portbench.kinds import configs, train
from portbench.run import forbidden_modules

from test_pb_faults import fast_render

TINY = pathlib.Path(__file__).resolve().parent / "data" / "tiny_multi.json"
SEED = 2**31 + 13  # a seed above 32 signed bits, as a run's may be


def _cell():
    limits = json.loads((registry.HERE / "workloads" / "multi6.train.json").read_text())
    return registry.Cell(name="tiny_multi.train", config_path=TINY,
                         config=registry.load_json(TINY), traffic={"kind": "train"},
                         workload=limits, chips=1, end_to_end=[], per_layer=[])


@pytest.fixture(scope="module")
def threads():
    from preset_gen_vae_tpu_torch.synth import fm_torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fm_torch, "render_batch", fast_render)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(threads):
    from preset_gen_vae_tpu_torch.training.loop import prepare_dataset

    cell = _cell()
    model_c, train_c, _, _ = configs(cell, SEED, pathlib.Path("unused"))
    _, _, ds = prepare_dataset(model_c, train_c, torch.device("cpu"), None,
                               {**cell.config["dataset"], "synthetic_seed": SEED})
    ds.load_corpus()
    return ds


def _run(tmp_path, dataset):
    return train.run(_cell(), seed=SEED, seconds=0.1, trace=False, t_start=0.0,
                     runs_root=tmp_path, device="cpu", dataset=dataset)


def test_the_tiny_model_is_the_cells_layout(dataset):
    tensors = dataset.corpus_tensors()
    n_notes = len(_cell().config["model"]["midi_notes"])
    assert tuple(tensors["x"].shape[1:]) == (1, 257, 347)
    assert len(tensors["x"]) == n_notes * dataset.valid_presets_count
    assert tensors["info"][:n_notes, 1:].tolist() == [[40, 85], [60, 42], [70, 127]]


def test_a_sound_run_is_correct(tmp_path, dataset):
    out = _run(tmp_path, dataset)
    assert out.correct, out.checks
    assert {name for name, _, _ in out.checks} == set(_cell().workload["limits"])
    assert out.ctx["summary"]["memory"] is None  # off the card
    assert forbidden_modules() == []


def test_a_pitch_column_shifted_by_one_note_fails(tmp_path, dataset, monkeypatch):
    """Each item's pitch is its preset's next note's: the spectrograms,
    targets and velocities are the program's own, only z0's pitch is
    wrong."""
    tensors = type(dataset).corpus_tensors
    n_notes = len(_cell().config["model"]["midi_notes"])

    def shifted(self):
        out = dict(tensors(self))
        info = out["info"].clone()
        pitch = info[:, 1].view(-1, n_notes)
        info[:, 1] = pitch.roll(-1, dims=1).reshape(-1)
        out["info"] = info
        return out

    monkeypatch.setattr(type(dataset), "corpus_tensors", shifted)
    out = _run(tmp_path, dataset)
    bad = {name for name, v, lim in out.checks if not v <= lim}
    assert not out.correct and "train_loss_gap" in bad, out.checks


GIB = 2**30
MEMORY = {"resident_bytes": int(20.5 * GIB), "corpus_bytes": int(12.25 * GIB),
          "model_state_bytes": int(0.85 * GIB)}


def test_working_memory_is_what_the_run_holds_less_corpus_and_model_state():
    read = registry.metric_reader("train.working_gib")
    ctx = {"kind": "train", "summary": {"step_ms": 33.0, "memory": MEMORY}}
    assert read(ctx) == pytest.approx(20.5 - 12.25 - 0.85, abs=1e-8)


@pytest.mark.parametrize("ctx", [
    {"kind": "train", "summary": {"step_ms": 33.0}},  # a program without the block
    {"kind": "train", "summary": {"step_ms": 33.0, "memory": None}},  # off the card
    {"kind": "eval", "phase_s": {"dataset": 0.05}},
], ids=["no_block", "off_the_card", "eval"])
def test_working_memory_reads_none_without_the_block(ctx):
    assert registry.metric_reader("train.working_gib")(ctx) is None
