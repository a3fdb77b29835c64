"""The port's quality run (``preset_gen_vae_tpu_torch/scripts/run_stack3_v2.py``)
against the JAX package's protocol that produced
``saved/FlVAE2/r4stack3_v2_8192/`` (``scripts/run_stack3_v2_r4.py``), on
the CPU, with no render.

Bars: the run's resolved configs equal the saved ``config.json``'s
``model`` and ``train`` sections field for field, apart from the listed
exceptions; the port's preset split at 8,192 presets equals the JAX
package's index for index, with 1,311 validation presets; the port's
``structured2`` generator at 8,192 presets, seed 0, is bit-equal to the
JAX package's; the run's name is never one of the JAX package's saved
runs (a new run erases its directory); the script trains through the loop
with TensorBoard off, evaluates the last checkpoint on the same dataset,
and resumes through ``start_epoch``; the run's committed record
(``saved/FlVAE2/torch_stack3_v2_8192/``) has the JAX run's configs but
for the listed exceptions and meets the bar.
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.data import sampler as jsampler
from preset_gen_vae_tpu.synth import database as jdb
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data import sampler
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset, \
    model_config_to_dataset_kwargs
from preset_gen_vae_tpu_torch.logs.logger import get_run_dir
from preset_gen_vae_tpu_torch.scripts import run_stack3_v2
from preset_gen_vae_tpu_torch.synth import database as db
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SAVED_RUN = ROOT / "saved" / "FlVAE2" / "r4stack3_v2_8192"
N_PRESETS = 8192

# the fields of the saved config.json that the port's run may not share,
# each with its reason
EXCEPTIONS = {
    ("model", "run_name"): "the port's run is torch_stack3_v2_8192, so that it never "
                           "erases the JAX package's run",
    ("train", "start_datetime"): "the time each run started",
    ("train", "corpus_rows_sharded"): "JAX-only (the TPU corpus's rows over a mesh); the "
                                      "JAX package added it after this run was saved",
}


def resolved_run_configs():
    """The script's configs resolved as the loop resolves them: against a
    dataset of the run's corpus, built on the CPU without its corpus pass."""
    model_c, train_c = cfg.resolve(*run_stack3_v2.run_configs(N_PRESETS, 400))
    kwargs = model_config_to_dataset_kwargs(model_c)
    kwargs.update(device="cpu", n_synthetic_presets=N_PRESETS,
                  synthetic_style=run_stack3_v2.STYLE)
    return cfg.resolve_with_dataset(model_c, train_c, DexedDataset(**kwargs))


def test_run_configs_equal_the_saved_jax_run():
    with open(SAVED_RUN / "config.json") as f:
        saved = json.load(f)
    for section, config in zip(("model", "train"), resolved_run_configs()):
        ours = json.loads(json.dumps(dataclasses.asdict(config)))  # tuples as lists
        theirs = saved[section]
        for k in sorted(set(ours) | set(theirs)):
            if (section, k) in EXCEPTIONS:
                continue
            assert k in ours and k in theirs, (section, k)
            assert ours[k] == theirs[k], (section, k, ours[k], theirs[k])
    assert saved["train"]["n_epochs"] == 400 and saved["train"]["save_period"] == 200
    # the exceptions are the fields that differ, and nothing else hides there
    model_c, train_c = resolved_run_configs()
    assert model_c.run_name != saved["model"]["run_name"]
    assert "corpus_rows_sharded" not in saved["train"]


def test_the_port_runs_saved_config_and_summary():
    """The quality run's committed record: its frozen configs are the JAX
    run's but for the exceptions, and its evaluation covers the JAX run's
    1,311 validation items within the bar set before the run (spec MAE at
    most 5% above the JAX run's 0.08145, accuracy at most 2 points below
    its 47.84%)."""
    ours_dir = get_run_dir(run_stack3_v2.run_configs(N_PRESETS, 400)[0])
    with open(ours_dir / "config.json") as f:
        ours = json.load(f)
    with open(SAVED_RUN / "config.json") as f:
        theirs = json.load(f)
    for section in ("model", "train", "evaluate"):
        keys = set(ours[section]) | set(theirs[section])
        diff = {k for k in keys if ours[section].get(k) != theirs[section].get(k)}
        assert diff == {k for s, k in EXCEPTIONS if s == section}, (section, diff)
    with open(ours_dir / "eval_validation_summary.json") as f:
        summary = json.load(f)
    assert summary["n_items"] == 1311
    assert summary["spec_mae"] <= 0.0855 and summary["acc"] >= 45.8


def test_preset_split_equals_the_jax_split():
    ours = sampler.split_preset_indexes(N_PRESETS)
    theirs = jsampler.split_preset_indexes(N_PRESETS)
    assert set(ours) == set(theirs)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    with open(SAVED_RUN / "eval_validation_summary.json") as f:
        n_items = json.load(f)["n_items"]
    assert len(ours["validation"]) == n_items == 1311


def test_structured2_corpus_is_bit_equal_to_the_jax_generator():
    ours, our_names, our_labels = db.generate_structured_corpus_v2(N_PRESETS, seed=0)
    theirs, their_names, their_labels = jdb.generate_structured_corpus_v2(N_PRESETS, seed=0)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape == (N_PRESETS, 155)
    np.testing.assert_array_equal(ours, theirs)
    assert our_names == their_names and our_labels == their_labels


@pytest.mark.parametrize("n", [N_PRESETS, 4096, 12288, 16384, 20480, 30720])
def test_run_name_is_never_a_saved_jax_run(n):
    model_c, _ = run_stack3_v2.run_configs(n, 400)
    assert model_c.run_name == f"torch_stack3_v2_{n}"
    jax_runs = {p.resolve() for p in (ROOT / "saved").glob("*/*")
                if p.is_dir() and not p.name.startswith(run_stack3_v2.RUN_PREFIX)}
    assert SAVED_RUN.resolve() in jax_runs
    assert get_run_dir(model_c).resolve() not in jax_runs


class _Dataset:
    corpus_seconds = render_seconds = None
    valid_presets_count = 16

    def load_corpus(self):
        self.corpus_seconds, self.render_seconds = 2.0, 1.0


def _fake_pipeline(monkeypatch, tmp_path):
    """The script's heavy calls replaced by recorders: the corpus pass, the
    training (its checkpoints written as the loop writes them) and the eval
    (its summary written)."""
    calls = []
    dataset = _Dataset()

    def prepare(model_c, train_c, dev, ds, kwargs):
        calls.append(("prepare", model_c, train_c, kwargs))
        return model_c, train_c, dataset

    def train(model_c, train_c, dataset=None, device=None, use_tensorboard=True):
        assert dataset.corpus_seconds is not None  # the corpus pass ran before
        calls.append(("train", model_c, train_c, dataset, use_tensorboard))
        last = train_c.n_epochs - 1
        for ep in sorted({train_c.save_period, last}):
            d = get_run_dir(model_c) / "checkpoints" / str(ep)
            d.mkdir(parents=True, exist_ok=True)
            torch.save({"step": 0}, d / "state.pt")
            (d / "meta.json").write_text(json.dumps({"epoch": ep, "scheduler": {"lr": 2e-5}}))
        return {"epochs_trained": train_c.n_epochs, "early_stop": False, "epoch_s": 1.0,
                "step_ms": 1.0}

    def evaluate(model_c, train_c, eval_c, device=None, dataset=None, phase_seconds=None):
        calls.append(("eval", model_c, eval_c, dataset))
        (get_run_dir(model_c) / "eval_validation_summary.json").write_text(
            json.dumps({"spec_mae": 0.1, "n_items": 3}))

    monkeypatch.setattr(run_stack3_v2, "prepare_dataset", prepare)
    monkeypatch.setattr(run_stack3_v2, "train_config", train)
    monkeypatch.setattr(run_stack3_v2, "evaluate_model", evaluate)
    return calls, dataset


def test_script_trains_then_evaluates_the_last_checkpoint(monkeypatch, tmp_path, capsys):
    calls, dataset = _fake_pipeline(monkeypatch, tmp_path)
    out = run_stack3_v2.main(["64", "4", "--logs-root", str(tmp_path), "--data-root",
                              str(tmp_path / "d"), "--device", "cpu"])
    (_, model_c, train_c, kwargs), (_, m2, t2, ds, tb), (_, m3, eval_c, ds3) = calls
    assert kwargs == {"n_synthetic_presets": 64, "synthetic_style": "structured2",
                      "data_root": str(tmp_path / "d")}
    assert model_c.midi_notes == ((40, 85), (50, 85), (60, 85)) and model_c.stack_spectrograms
    assert (model_c.dataset_corpus_render_backend, model_c.dataset_corpus_cache_policy) == \
        ("jax", "device")
    assert (t2.n_epochs, t2.save_period, t2.verbosity, t2.start_epoch) == (4, 2, 0, 0)
    assert ds is dataset and ds3 is dataset and tb is False
    assert (eval_c.epoch, eval_c.dataset, eval_c.override_previous_eval) == (3, "validation", True)
    assert m2.logs_root_dir == m3.logs_root_dir == str(tmp_path)
    assert out["run"] == "torch_stack3_v2_64" and out["epochs_trained"] == 4
    assert out["spec_mae"] == 0.1 and out["n_items"] == 3
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    assert [line.get("phase") for line in lines] == ["corpus", "train", "eval", None]
    assert lines[-1] == json.loads(json.dumps(out))


def test_script_resumes_from_the_last_checkpoint(monkeypatch, tmp_path):
    calls, _ = _fake_pipeline(monkeypatch, tmp_path)
    argv = ["64", "4", "--logs-root", str(tmp_path), "--device", "cpu"]
    with pytest.raises(FileNotFoundError):  # nothing to resume from
        run_stack3_v2.main(argv + ["--resume"])
    run_stack3_v2.main(argv)  # checkpoints 2 and 3
    last = get_run_dir(run_stack3_v2.run_configs(64, 4, str(tmp_path))[0]) / "checkpoints" / "3"
    for f in last.iterdir():  # a run cut after checkpoint 2
        f.unlink()
    last.rmdir()
    calls.clear()
    run_stack3_v2.main(argv + ["--resume"])
    assert [c[0] for c in calls] == ["prepare", "train", "eval"]
    assert calls[1][2].start_epoch == 3 and calls[1][2].n_epochs == 4
    # the last checkpoint ends the run: straight to the evaluation
    calls.clear()
    out = run_stack3_v2.main(argv + ["--resume"])
    assert [c[0] for c in calls] == ["prepare", "eval"] and calls[1][2].epoch == 3
    assert out["epochs_trained"] is None and out["resumed_from_epoch"] == 4
