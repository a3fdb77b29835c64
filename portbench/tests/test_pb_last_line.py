"""The shape of a run's last line: the keys a reader takes, in order,
with ``checks`` last, the units of the cell's metrics, the per-layer
metrics read by their readers under ``--trace 1``, and strict JSON where a
reading is not finite."""

import json
import math
import pathlib

from portbench import registry
from portbench.kinds import Outcome, make_checks
from portbench.run import result_line

ROOT = pathlib.Path(__file__).resolve().parents[2]
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
          "memory_peak_bytes": 123}


def _outcome(checks):
    ctx = {"kind": "train", "summary": {"step_ms": 31.0, "epoch_s": 4.7}, "epochs": 6,
           "steps_per_epoch": 122, "window_s": 28.2, "flops_per_step": 4.8e11,
           "busy_s": 26.0, "trace_window_s": 28.2, "corpus_s": 3.0, "corpus_bound_s": 0.0165,
           "graph_capture_s": 3.4}
    return Outcome(correct=all(v <= lim for _, v, lim in checks), attempted=117120, failed=0,
                   end_to_end={"train_items_per_s": 4153.2, "setup_s": 61.5,
                               "peak_device_gib": 12.25},
                   ctx=ctx, checks=checks, peak_bytes=123, busy_s=26.0, window_s=28.2,
                   breakdown={"device_ops": [["k", 1.0]], "idle_gaps": [["aten::item", 0.1]]})


def test_untraced_line():
    cell = registry.find_cell(ROOT, "flvae2.train")
    checks = make_checks({"train_loss_gap": 0.01, "grad_rms_gap": 0.5},
                         {"train_loss_gap": 0.002, "grad_rms_gap": 0.1})
    line = result_line(_outcome(checks), cell, False, DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    assert line["metrics"] == {"train_items_per_s": {"value": 4153.2, "unit": "items/s"},
                               "peak_device_gib": {"value": 12.25, "unit": "GiB"},
                               "setup_s": {"value": 61.5, "unit": "s"}}
    assert line["checks"]["train_loss_gap"] == {"value": 0.002, "limit": 0.01}
    json.loads(json.dumps(line))


def test_traced_line_reads_the_per_layer_metrics():
    cell = registry.find_cell(ROOT, "flvae2.train")
    line = result_line(_outcome([]), cell, True, {**DEVICE, "busy_s": 26.0, "window_s": 28.2})
    assert list(line)[-1] == "checks" and "breakdown" in line
    got = line["metrics"]
    assert set(got) == {m["name"] for m in cell.per_layer}
    assert got["train.step_ms"] == {"value": 31.0, "unit": "ms"}
    assert math.isclose(got["device_idle_pct.train"]["value"], 100 * (1 - 26.0 / 28.2))


def test_a_missing_reading_fails_and_stays_strict_json():
    cell = registry.find_cell(ROOT, "flvae2.train")
    checks = make_checks({"train_loss_gap": 0.01}, {})
    out = _outcome(checks)
    assert out.correct is False
    line = result_line(out, cell, False, DEVICE)
    assert line["checks"]["train_loss_gap"] == {"value": None, "limit": 0.01}
    json.loads(json.dumps(line, allow_nan=False))
