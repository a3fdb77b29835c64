"""The port's counterparts of the flagship's own protocols against the JAX
package's root scripts, on the CPU, with no render:
``preset_gen_vae_tpu_torch/scripts/compare_corpus_styles.py`` (root
``scripts/compare_corpus_styles.py``, the runs ``r3cmp_structured_30720``
and ``r3cmp_structured2_30720``) and ``.../run_flowloss.py`` (root
``scripts/run_flowloss_r2.py``, ``r2flowloss_train`` and ``_eval``).

Bars: with the heavy calls of both packages replaced by recorders (the
port's on ``run_stack3_v2``, whose protocol body both scripts run), each
port script's resolved ``ModelConfig`` and ``TrainConfig`` equal the JAX
script's field for field, apart from the run name, the logs root and the
start time; the corpus style and ``flow_loss_bn_mode`` reach the dataset
and the loop; one dataset serves both FlowParamsLoss modes, evaluated with
``render_audio=False``; the run names are the port's and never a saved JAX
run's; the printed lines carry the JAX scripts' keys; ``--resume`` skips a
finished run; the validation split has 4,916 presets at 30,720 and 328 at
2,048 in both packages, from datasets built without their corpus pass.
The quality runs' committed records (``saved/FlVAE2/torch_*``) have their
JAX run's configs but for the run name, the start time and the fields
the JAX package added after that run was saved, each at the default the
run had; and their evaluations cover the JAX run's validation items
exactly. Their bars are in ``PERF.md``, each beside its result.
"""

import dataclasses
import json
import pathlib
import runpy
import sys

import jax
import pytest
import torch

from preset_gen_vae_tpu import config as jcfg
from preset_gen_vae_tpu.data import sampler as jsampler
from preset_gen_vae_tpu.data.dexed_dataset import DexedDataset as JaxDexedDataset
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data import sampler
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.logs.logger import get_run_dir
from preset_gen_vae_tpu_torch.scripts import compare_corpus_styles, run_flowloss, run_stack3_v2
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SAVED = ROOT / "saved" / "FlVAE2"
DIFFER = ("run_name", "logs_root_dir", "start_datetime")  # the fields allowed to differ
SUMMARY = {"spec_mae": 0.1, "acc": 50.0, "n_items": 3}
JAX_KEYS = {"style", "n_presets", "epochs_trained", "train_wall_s", "eval_wall_s"}


def as_dict(config):
    d = json.loads(json.dumps(dataclasses.asdict(config)))  # tuples as lists
    return {k: v for k, v in d.items() if k not in DIFFER}


def resolved(config_module, model_c, train_c):
    return [as_dict(c) for c in config_module.resolve(model_c, train_c)]


# ------------------------------------------------------------ the JAX scripts
def run_jax_script(monkeypatch, tmp_path, name, argv=()):
    """Runs ``scripts/<name>`` as ``__main__`` in ``tmp_path`` with its
    dataset, training and evaluation recorded; -> the calls."""
    from preset_gen_vae_tpu.data import build as jbuild
    from preset_gen_vae_tpu.evaluation import evaluate as jevaluate
    from preset_gen_vae_tpu.logs import logger as jlogger
    from preset_gen_vae_tpu.training import loop as jloop

    calls = []

    def get_dataset(model_c, train_c, **kwargs):
        calls.append(("dataset", kwargs))
        return object()

    def train(model_c, train_c, dataset=None, **kwargs):
        calls.append(("train", model_c, train_c, dataset, kwargs))
        return {"epochs_trained": train_c.n_epochs}

    def evaluate(model_c, train_c, eval_c, dataset=None, **kwargs):
        calls.append(("eval", model_c, eval_c, dataset, kwargs))
        run_dir = tmp_path / model_c.run_name
        run_dir.mkdir(parents=True, exist_ok=True)
        (run_dir / "eval_validation_summary.json").write_text(json.dumps(SUMMARY))

    monkeypatch.setattr(jbuild, "get_dataset", get_dataset)
    monkeypatch.setattr(jloop, "train_config", train)
    monkeypatch.setattr(jevaluate, "evaluate_model", evaluate)
    monkeypatch.setattr(jlogger, "get_run_dir", lambda m: tmp_path / m.run_name)
    monkeypatch.setattr(jlogger, "list_checkpoint_epochs", lambda m: [0, 3])
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)  # no compile cache
    (tmp_path / "saved").mkdir(parents=True, exist_ok=True)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    runpy.run_path(str(ROOT / "scripts" / name), run_name="__main__")
    return calls


# ------------------------------------------------------------ the port's scripts
class _Dataset:
    corpus_seconds = render_seconds = None
    valid_presets_count = 16

    def load_corpus(self):
        self.corpus_seconds, self.render_seconds = 2.0, 1.0


def fake_pipeline(monkeypatch):
    """The protocol body's heavy calls replaced by recorders: the corpus
    pass, the training (its checkpoints written as the loop writes them)
    and the evaluation (its summary written)."""
    calls = []

    def prepare(model_c, train_c, dev, ds, kwargs):
        calls.append(("prepare", model_c, train_c, kwargs))
        return model_c, train_c, _Dataset()

    def train(model_c, train_c, dataset=None, device=None, use_tensorboard=True):
        assert dataset.corpus_seconds is not None  # the corpus pass ran before
        calls.append(("train", model_c, train_c, dataset, use_tensorboard))
        last = train_c.n_epochs - 1  # the loop's checkpoints
        for ep in [e for e in range(1, last) if e % train_c.save_period == 0] + [last]:
            d = get_run_dir(model_c) / "checkpoints" / str(ep)
            d.mkdir(parents=True, exist_ok=True)
            torch.save({"step": 0}, d / "state.pt")
            (d / "meta.json").write_text(json.dumps({"epoch": ep, "scheduler": {"lr": 2e-5}}))
        return {"epochs_trained": train_c.n_epochs, "early_stop": False, "epoch_s": 1.0,
                "step_ms": 1.0}

    def evaluate(model_c, train_c, eval_c, device=None, dataset=None, phase_seconds=None,
                 **kwargs):
        calls.append(("eval", model_c, eval_c, dataset, kwargs))
        (get_run_dir(model_c) / "eval_validation_summary.json").write_text(json.dumps(SUMMARY))

    monkeypatch.setattr(run_stack3_v2, "prepare_dataset", prepare)
    monkeypatch.setattr(run_stack3_v2, "train_config", train)
    monkeypatch.setattr(run_stack3_v2, "evaluate_model", evaluate)
    return calls


def port_argv(tmp_path, *extra):
    return ["--logs-root", str(tmp_path), "--data-root", str(tmp_path / "d"), "--device", "cpu",
            *extra]


CASES = {  # case: (JAX script, its argv, port script, its argv, the case's key)
    "cmp_structured": ("compare_corpus_styles.py", ["--styles", "structured"],
                       compare_corpus_styles, ["--styles", "structured"], "structured"),
    "cmp_structured2": ("compare_corpus_styles.py",
                        ["--n-presets", "30720", "--epochs", "400", "--styles", "structured2"],
                        compare_corpus_styles,
                        ["--n-presets", "30720", "--epochs", "400", "--styles", "structured2"],
                        "structured2"),
    "flowloss_train": ("run_flowloss_r2.py", [], run_flowloss, [], "train"),
    "flowloss_eval": ("run_flowloss_r2.py", [], run_flowloss, [], "eval"),
}


def _train_call(calls, key):
    """The training call of ``key``, a corpus style or a BN mode, by its
    run's name in either package."""
    (call,) = [c for c in calls if c[0] == "train" and (
        f"cmp_{key}_" in c[1].run_name or c[1].run_name.endswith(f"flowloss_{key}"))]
    return call


@pytest.mark.parametrize("case", sorted(CASES))
def test_configs_equal_the_jax_scripts(monkeypatch, tmp_path, case):
    jax_name, jax_argv, script, argv, key = CASES[case]
    theirs = _train_call(run_jax_script(monkeypatch, tmp_path / "jax", jax_name, jax_argv), key)
    ours = _train_call(_run_port(monkeypatch, tmp_path / "port", script, argv), key)
    assert resolved(cfg, ours[1], ours[2]) == resolved(jcfg, theirs[1], theirs[2])
    assert ours[1].run_name != theirs[1].run_name
    assert ours[1].logs_root_dir == str(tmp_path / "port")


def _run_port(monkeypatch, tmp_path, script, argv):
    calls = fake_pipeline(monkeypatch)
    script.main(port_argv(tmp_path, *argv))
    return calls


@pytest.mark.parametrize("case", sorted(CASES))
def test_style_and_bn_mode_reach_the_dataset_and_the_loop(monkeypatch, tmp_path, case):
    jax_name, jax_argv, script, argv, key = CASES[case]
    jax_calls = run_jax_script(monkeypatch, tmp_path / "jax", jax_name, jax_argv)
    calls = _run_port(monkeypatch, tmp_path / "port", script, argv)
    jax_data = [c[1] for c in jax_calls if c[0] == "dataset"]
    data = [c[3] for c in calls if c[0] == "prepare"]
    # one dataset a style, one for both BN modes, as in the JAX scripts
    assert len(data) == len(jax_data) == 1
    want = dict(jax_data[0])
    want.setdefault("synthetic_style", "structured")  # the JAX dataset's default
    assert data[0] == {**want, "data_root": str(tmp_path / "port" / "d")}
    _, model_c, train_c, dataset, tb = _train_call(calls, key)
    evals = [c for c in calls if c[0] == "eval" and c[1].run_name == model_c.run_name]
    assert len(evals) == 1 and evals[0][3] is dataset and tb is False
    jax_eval = [c for c in jax_calls if c[0] == "eval"
                and c[1].run_name == _train_call(jax_calls, key)[1].run_name][0]
    assert evals[0][4] == {k: v for k, v in jax_eval[4].items() if k == "render_audio"}
    if script is run_flowloss:
        assert train_c.flow_loss_bn_mode == key and not model_c.forward_controls_loss
        assert evals[0][4] == {"render_audio": False}
        assert len({id(c[3]) for c in calls if c[0] in ("train", "eval")}) == 1
    else:
        assert data[0]["synthetic_style"] == key and model_c.forward_controls_loss


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_names_and_printed_keys(monkeypatch, tmp_path, capsys, case):
    jax_name, jax_argv, script, argv, key = CASES[case]
    run_jax_script(monkeypatch, tmp_path / "jax", jax_name, jax_argv)
    jax_lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    calls = _run_port(monkeypatch, tmp_path / "port", script, argv)
    lines = [json.loads(s) for s in capsys.readouterr().out.strip().splitlines()]
    model_c = _train_call(calls, key)[1]
    jax_runs = {p.name for p in SAVED.iterdir() if p.is_dir() and not p.name.startswith("torch_")}
    assert model_c.run_name not in jax_runs
    if script is compare_corpus_styles:
        n = int(argv[argv.index("--n-presets") + 1]) if "--n-presets" in argv else 2048
        assert model_c.run_name == f"torch_cmp_{key}_{n}"
        assert f"r3cmp_{key}_30720" in jax_runs
        (jax_line,) = [s for s in jax_lines if s["style"] == key]
        (line,) = [s for s in lines if s.get("run") == model_c.run_name]
        assert set(jax_line) == JAX_KEYS | set(SUMMARY) and set(jax_line) <= set(line)
        assert (line["style"], line["n_presets"]) == (key, n)
        assert {"card", "peak_gib", "launches"} <= set(line)
        assert set(line["launches"]) == {"corpus", "train", "eval"}
    else:
        assert model_c.run_name == f"torch_flowloss_{key}" and f"r2flowloss_{key}" in jax_runs
        for phase in ("train", "eval"):
            (jax_line,) = [s for s in jax_lines if (s["phase"], s["bn_mode"]) == (phase, key)]
            (line,) = [s for s in lines if (s.get("phase"), s.get("bn_mode")) == (phase, key)]
            assert list(line)[:2] == ["phase", "bn_mode"] and set(jax_line) <= set(line)
        assert [s["phase"] for s in lines if "phase" in s][0] == "corpus"
        with open(tmp_path / "port" / run_flowloss.COMPARISON) as f:
            comparison = json.load(f)
        with open(tmp_path / "jax" / "saved" / "flowloss_r2_comparison.json") as f:
            jax_comparison = json.load(f)
        assert set(comparison) == set(jax_comparison) == set(run_flowloss.BN_MODES)
        assert set(comparison[key]) == set(jax_comparison[key]) == {"train", "eval"}
        assert comparison[key]["eval"] == jax_comparison[key]["eval"] == SUMMARY


@pytest.mark.parametrize("script", [compare_corpus_styles, run_flowloss],
                         ids=["compare_corpus_styles", "run_flowloss"])
def test_resume_skips_a_finished_run(monkeypatch, tmp_path, script):
    calls = fake_pipeline(monkeypatch)
    argv = port_argv(tmp_path, "--n-presets", "64", "--epochs", "4")
    with pytest.raises(FileNotFoundError):  # nothing to resume from
        script.main(argv + ["--resume"])
    script.main(argv)
    n_runs = sum(c[0] == "train" for c in calls)
    assert n_runs == 2  # two styles, or two BN modes
    calls.clear()
    script.main(argv + ["--resume"])
    assert [c[0] for c in calls if c[0] != "prepare"] == ["eval"] * n_runs
    assert all(c[2].epoch == 3 for c in calls if c[0] == "eval")


@pytest.mark.parametrize("n,n_valid", [(30720, 4916), (2048, 328)])
def test_validation_split_size_in_both_packages(n, n_valid, tmp_path):
    ours = sampler.split_preset_indexes(n)
    theirs = jsampler.split_preset_indexes(n)
    assert len(ours["validation"]) == len(theirs["validation"]) == n_valid
    style = "structured2" if n == 30720 else "structured"
    assert DexedDataset(device="cpu", n_synthetic_presets=n,
                        synthetic_style=style).valid_presets_count == n
    assert JaxDexedDataset(data_root=str(tmp_path), n_synthetic_presets=n,
                           synthetic_style=style).valid_presets_count == n
    saved = {30720: "r3cmp_structured2_30720", 2048: "r2flowloss_train"}[n]
    with open(SAVED / saved / "eval_validation_summary.json") as f:
        assert json.load(f)["n_items"] == n_valid


# fields the JAX package added after the JAX run was saved; the port's runs
# hold each at its default, which is what the JAX run did without the field
# (K steps a dispatch train as one at a time: test_torch_port_dispatch.py)
ADDED_LATER = {
    ("model", "dataset_corpus_render_backend"): "cpp",
    ("model", "dataset_corpus_cache_policy"): "disk",
    ("train", "corpus_rows_sharded"): True,
    ("train", "steps_per_dispatch"): 16,
    ("train", "scan_unroll"): 1,
}
QUALITY_RUNS = {  # the port's run: (the JAX run, its validation items)
    "torch_flowloss_train": ("r2flowloss_train", 328),
    "torch_flowloss_eval": ("r2flowloss_eval", 328),
    "torch_cmp_structured2_30720": ("r3cmp_structured2_30720", 4916),
    "torch_cmp_structured_30720": ("r3cmp_structured_30720", 4916),
    "torch_stack3_v2_20480": ("r5stack3_v2_20480", 3277),  # run_stack3_v2.py 20480 400
}


@pytest.mark.parametrize("run", sorted(QUALITY_RUNS))
def test_committed_run_has_the_jax_runs_configs_and_items(run):
    jax_run, n_items = QUALITY_RUNS[run]
    with open(SAVED / run / "config.json") as f:
        ours = json.load(f)
    with open(SAVED / jax_run / "config.json") as f:
        theirs = json.load(f)
    for section in ("model", "train", "evaluate"):
        for k in set(ours[section]) | set(theirs[section]):
            if k in ("run_name", "start_datetime") or \
                    ours[section].get(k) == theirs[section].get(k):
                continue
            assert k not in theirs[section] and ADDED_LATER[(section, k)] == ours[section][k], \
                (section, k)
    assert ours["model"]["run_name"] == run
    for name in (run, jax_run):
        with open(SAVED / name / "eval_validation_summary.json") as f:
            assert json.load(f)["n_items"] == n_items, name
