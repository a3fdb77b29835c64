"""The port's command-line entry points against the JAX package's root
scripts, on the CPU: ``scripts/clean_logs.py`` (root ``clean_logs.py``),
``scripts/train_queue.py`` (root ``train_queue.py``),
``scripts/evaluate.py`` (root ``eval.py``) and ``training/loop.py``'s
``main`` (root ``train.py``).

Bars: with the training, queue, evaluation and erase functions replaced
by recorders in both packages, each port script makes the JAX script's
call with the same constants (configs compared field for field, apart
from the start time and ``EvalConfig.device``, whose default differs by
design), and its options reach the call: ``--no-tensorboard`` as
``use_tensorboard=False``, ``--logs-root`` as ``saved_root`` or
``logs_root_dir``, ``--data-root`` and the corpus options as
``dataset_kwargs``, the run names as ``models_names``. ``clean_logs`` on a
run under a temporary root erases that run and nothing beside it; the
loop's CLI without ``--no-tensorboard`` raises ``ImportError`` where
tensorboard cannot be imported, and with it trains a tiny run on the CPU;
the evaluation's column summary equals numpy's statistics.
"""

import dataclasses
import json
import runpy
import sys

import numpy as np
import pytest

from preset_gen_vae_tpu import config as jcfg
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.scripts import clean_logs, evaluate, train_queue
from preset_gen_vae_tpu_torch.training import loop
from _torch_port_fixtures import isolated_data_root, tiny_configs  # noqa: F401 (autouse)

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def as_dict(config, drop=("start_datetime",)):
    d = json.loads(json.dumps(dataclasses.asdict(config)))
    return {k: v for k, v in d.items() if k not in drop}


def run_jax_script(monkeypatch, name: str, argv=()):
    """Runs the root script ``name`` as ``__main__`` with ``argv``."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(str(ROOT / name), run_name="__main__")


class Recorder:
    def __init__(self, result=None):
        self.calls, self.result = [], result

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.result


# ---- clean_logs

@pytest.mark.parametrize("argv", [[], ["FlVAE2"], ["MyModel", "run7"]])
def test_clean_logs_erases_the_jax_scripts_run(monkeypatch, capsys, argv):
    from preset_gen_vae_tpu.logs import logger as jlogger

    theirs, ours = Recorder(), Recorder()
    monkeypatch.setattr(jlogger, "erase_run", theirs)
    monkeypatch.setattr(clean_logs, "erase_run", ours)
    run_jax_script(monkeypatch, "clean_logs.py", argv)
    jax_out = capsys.readouterr().out
    clean_logs.main(argv)
    port_out = capsys.readouterr().out
    (jax_model,), _ = theirs.calls[0]
    (port_model,), _ = ours.calls[0]
    assert as_dict(port_model) == as_dict(jax_model)
    if len(argv) == 2:
        assert (port_model.name, port_model.run_name) == tuple(argv)
    assert port_out == jax_out
    assert port_out.startswith("Erasing ") and port_out.rstrip().endswith(
        f"saved/{port_model.name}/{port_model.run_name}")


def test_clean_logs_logs_root_reaches_the_run(monkeypatch, tmp_path):
    ours = Recorder()
    monkeypatch.setattr(clean_logs, "erase_run", ours)
    clean_logs.main(["A", "b", "--logs-root", str(tmp_path)])
    (model_c,), _ = ours.calls[0]
    assert (model_c.name, model_c.run_name, model_c.logs_root_dir) == ("A", "b", str(tmp_path))


def test_clean_logs_erases_its_run_and_nothing_beside_it(tmp_path, capsys):
    keep = [tmp_path / "FlVAE2" / "other", tmp_path / "Other" / "target",
            tmp_path / "FlVAE2" / "target_kf0"]
    target = tmp_path / "FlVAE2" / "target"
    for d in keep + [target]:
        (d / "checkpoints" / "1").mkdir(parents=True)
        (d / "config.json").write_text("{}")
    clean_logs.main(["FlVAE2", "target", "--logs-root", str(tmp_path)])
    assert capsys.readouterr().out == f"Erasing {target}\n"
    assert not target.exists()
    assert all((d / "config.json").exists() and (d / "checkpoints" / "1").is_dir() for d in keep)
    clean_logs.main(["FlVAE2", "target", "--logs-root", str(tmp_path)])  # gone: a no-op


# ---- train_queue

@pytest.mark.parametrize("argv", [[], ["--no-tensorboard", "--data-root", "D", "--logs-root",
                                       "L", "--device", "cpu"]])
def test_train_queue_makes_the_jax_scripts_call(monkeypatch, capsys, argv):
    from preset_gen_vae_tpu.training import queue as jqueue

    monkeypatch.setattr("torch.cuda.is_available", lambda: True)  # the default device
    theirs, ours = Recorder([{"a": 1}]), Recorder([{"a": 1}, {"b": 2}])
    monkeypatch.setattr(jqueue, "run_queue", theirs)
    monkeypatch.setattr(train_queue, "run_queue", ours)
    run_jax_script(monkeypatch, "train_queue.py")
    assert capsys.readouterr().out == "{'a': 1}\n"
    assert train_queue.main(argv) == [{"a": 1}, {"b": 2}]
    assert capsys.readouterr().out == "{'a': 1}\n{'b': 2}\n"
    (jax_mods,), jax_kw = theirs.calls[0]
    (port_mods,), port_kw = ours.calls[0]
    jax_script = runpy.run_path(str(ROOT / "train_queue.py"))
    assert port_mods == jax_mods == jax_script["run_mods"] == train_queue.run_mods
    assert port_kw["k_folds_fanout"] is jax_kw["k_folds_fanout"] is False
    assert set(port_kw) == {"base_model", "k_folds_fanout", "device", "dataset_kwargs",
                            "use_tensorboard"}
    logs_root = "saved" if not argv else "L"
    assert as_dict(port_kw["base_model"]) == dict(as_dict(jcfg.ModelConfig()),
                                                  logs_root_dir=logs_root)
    assert port_kw["use_tensorboard"] is (not argv)
    assert port_kw["device"] == ("cuda" if not argv else "cpu")
    assert port_kw["dataset_kwargs"] == (None if not argv else {"data_root": "D"})


def test_train_queue_hands_its_queue_and_corpus_to_run_queue(monkeypatch):
    ours = Recorder([])
    monkeypatch.setattr(train_queue, "run_queue", ours)
    mods = [({"run_name": "q"}, {"n_epochs": 1})]
    train_queue.main(["--device", "cpu", "--data-root", "D"], run_mods=mods,
                     dataset_kwargs={"n_synthetic_presets": 512})
    (port_mods,), kw = ours.calls[0]
    assert port_mods is mods
    assert kw["dataset_kwargs"] == {"data_root": "D", "n_synthetic_presets": 512}


# ---- evaluate

@pytest.mark.parametrize("argv", [[], ["FlVAE2/a", "FlVAE2/b", "--n-presets", "1024", "--style",
                                       "structured2", "--synthetic-seed", "3", "--data-root", "D",
                                       "--logs-root", "L", "--device", "cpu"]])
def test_evaluate_makes_the_jax_scripts_call(monkeypatch, capsys, argv):
    from preset_gen_vae_tpu.evaluation import evaluate as jevaluate

    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    theirs, ours = Recorder([]), Recorder([])
    monkeypatch.setattr(jevaluate, "evaluate_all_models", theirs)
    monkeypatch.setattr(evaluate, "evaluate_all_models", ours)
    run_jax_script(monkeypatch, "eval.py")
    evaluate.main(argv)
    (jax_ec,), jax_kw = theirs.calls[0]
    (port_ec,), port_kw = ours.calls[0]
    assert jax_kw == {}
    want = as_dict(jax_ec, drop=("start_datetime", "device"))
    if argv:
        want["models_names"] = ["FlVAE2/a", "FlVAE2/b"]
    assert as_dict(port_ec, drop=("start_datetime", "device")) == want
    assert (jax_ec.models_names, jax_ec.dataset) == ((), "validation")
    assert port_kw["saved_root"] == ROOT / ("saved" if not argv else "L")
    assert port_kw["device"] == ("cuda" if not argv else "cpu")
    assert port_kw["dataset_kwargs"] == (None if not argv else {
        "n_synthetic_presets": 1024, "synthetic_style": "structured2", "synthetic_seed": 3,
        "data_root": "D"})
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]).keys() == {"launches"}


def test_evaluate_logs_root_absolute_is_kept(monkeypatch, tmp_path):
    ours = Recorder([])
    monkeypatch.setattr(evaluate, "evaluate_all_models", ours)
    evaluate.main(["--logs-root", str(tmp_path), "--device", "cpu"])
    assert ours.calls[0][1]["saved_root"] == tmp_path


def test_evaluate_prints_each_runs_column_summary(monkeypatch, capsys):
    rng = np.random.default_rng(0)
    table = {"preset_UID": np.arange(7), "spec_mae": rng.random(7),
             "spec_sc": np.array([0.5, np.nan, 0.25, 1.0, np.nan, 2.0, 0.0])}
    monkeypatch.setattr(evaluate, "evaluate_all_models", Recorder([table, table]))
    evaluate.main(["X/y", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == list(evaluate.STATS) and lines[4] == lines[0]
    rows = {line.split()[0]: [float(v) for v in line.split()[1:]] for line in lines[1:4]}
    for k, col in table.items():
        col = np.asarray(col, dtype=np.float64)
        col = col[~np.isnan(col)]
        np.testing.assert_allclose(rows[k], [len(col), col.mean(), col.std(ddof=1), col.min(),
                                             col.max()], rtol=1e-5)
    assert rows["spec_sc"][0] == 5


# ---- the loop's CLI (root train.py)

def test_loop_cli_makes_the_jax_scripts_call(monkeypatch, capsys):
    from preset_gen_vae_tpu.training import loop as jloop

    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    theirs, ours = Recorder({"x": 1}), Recorder({"x": 1})
    monkeypatch.setattr(jloop, "train_config", theirs)
    monkeypatch.setattr(loop, "train_config", ours)
    run_jax_script(monkeypatch, "train.py")
    for argv, tb, device in (([], True, "cuda"), (["--no-tensorboard", "--device", "cpu"], False,
                                                  "cpu")):
        ours.calls.clear()
        assert loop.main(argv) == {"x": 1}
        (jm, jt), jax_kw = theirs.calls[0]
        (pm, pt), port_kw = ours.calls[0]
        assert jax_kw == {}
        assert as_dict(pm) == as_dict(jm)
        assert as_dict(pt) == as_dict(jt)
        assert port_kw == {"device": device, "dataset_kwargs": None, "use_tensorboard": tb}
    assert capsys.readouterr().out.splitlines()[-1] == "{'x': 1}"


def _block_tensorboard(monkeypatch):
    for name in ("tensorboard", "torch.utils.tensorboard",
                 "preset_gen_vae_tpu_torch.logs.tbwriter"):
        monkeypatch.delitem(sys.modules, name, raising=False)
    monkeypatch.setitem(sys.modules, "tensorboard", None)  # `import tensorboard` raises


def test_loop_cli_without_the_flag_raises_where_tensorboard_is_missing(monkeypatch, tmp_path):
    _block_tensorboard(monkeypatch)
    model_c, train_c = tiny_configs(cfg, tmp_path, "cli_tb", n_epochs=1)
    corpus = {"n_synthetic_presets": 16, "data_root": str(tmp_path / "data")}
    with pytest.raises(ImportError):
        loop.main(["--device", "cpu"], model_c=model_c, train_c=train_c, dataset_kwargs=corpus)
    summary = loop.main(["--device", "cpu", "--no-tensorboard"], model_c=model_c,
                        train_c=train_c, dataset_kwargs=corpus)
    run_dir = tmp_path / "TestVAE" / "cli_tb"
    assert summary["epochs_trained"] == 1 and summary["run_dir"] == str(run_dir)
    assert (run_dir / "checkpoints" / "0").is_dir() and not (run_dir / "tensorboard").exists()
    assert summary["epoch_s"] > 0 and summary["first_epoch_s"] == summary["epoch_s"]
