"""Discovery by name: every cell of ``BENCHMARK.json`` finds its
configuration, traffic mix, limits and per-layer readers in files of their
own, and a configuration, a cell and a metric added as new files and new
entries are found without a change to any file that is there."""

import json
import pathlib
import shutil

import pytest

from portbench import registry

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = registry.find_cell(ROOT, cell)
    assert c.config["model"] and c.config["train"] and c.config["dataset"]
    assert registry.kind_module(c.traffic["kind"]).run
    assert set(c.workload["limits"]) and c.workload["sample_presets"] > 0
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(registry.metric_reader(m["name"]))


def test_every_metric_and_config_has_its_file():
    for m in BENCH["per_layer"]:
        assert (registry.HERE / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert (registry.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (registry.HERE / "workloads" / f"{w['name']}.json").is_file()


def test_a_new_config_cell_and_metric_are_found_as_new_files(tmp_path):
    bench_dir = tmp_path / "portbench"
    shutil.copytree(registry.HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__",
                                                                            "tests"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((registry.HERE / "configs" / "flvae2.json").read_text())
    config["dataset"]["n_synthetic_presets"] = 2048
    (bench_dir / "configs" / "flvae2_small.json").write_text(json.dumps(config))
    (bench_dir / "workloads" / "flvae2_small.train.json").write_text(
        json.dumps({"sample_presets": 4, "limits": {"train_loss_gap": 0.1}}))
    (bench_dir / "metrics" / "train.steps_per_epoch.py").write_text(
        "def read(ctx):\n    return ctx.get('steps_per_epoch')\n")
    bench["configs"].append({"name": "flvae2_small", "source": "x",
                             "file": "portbench/configs/flvae2_small.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "flvae2_small.train", "config": "flvae2_small",
                               "traffic": "train_epochs", "chips": 1, "why": "x"})
    bench["end_to_end"][0]["workloads"].append("flvae2_small.train")
    bench["per_layer"].append({"name": "train.steps_per_epoch", "unit": "steps",
                               "better": "higher", "source": "program_counter",
                               "layer": "epoch loop", "moves": "train_items_per_s",
                               "workloads": ["flvae2_small.train"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = registry.find_cell(tmp_path, "flvae2_small.train", bench_dir)
    assert cell.config["dataset"]["n_synthetic_presets"] == 2048
    assert cell.traffic["kind"] == "train"
    assert "train.steps_per_epoch" in [m["name"] for m in cell.per_layer]
    got = registry.read_per_layer(cell.per_layer, {"kind": "train", "steps_per_epoch": 12,
                                                   "corpus_s": None}, bench_dir)
    assert got == {"train.steps_per_epoch": 12.0}
    for p, data in before.items():  # no file that was there changed
        assert p.read_bytes() == data, p
    # a metric that names no cell is read in every cell that reports what it moves
    other = registry.find_cell(tmp_path, "flvae2.train", bench_dir)
    assert "train.steps_per_epoch" not in [m["name"] for m in other.per_layer]
