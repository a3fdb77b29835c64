"""The yardstick's arithmetic against hand counts: the work formulas and
their bound, the device-busy union and the idle gaps, and the per-layer
readers that turn a run's record into a share."""

import math

import pytest

from portbench import registry, work
from portbench.kinds import corpus_bound_s
from portbench.reference import presets as rp


def test_logmel_work_by_hand():
    B, S, n_fft, hop, mels, nnz = 2, 1024, 256, 64, 10, 40
    T = 1 + S // hop
    nbytes, flops = work.logmel_work(B, S, n_fft, hop, mels, nnz)
    assert nbytes == 4 * (B * S + nnz + 2 * mels + 1 + B * mels * T)
    assert flops == B * T * (2.5 * n_fft * 8 + 3 * (n_fft // 2 + 1) + 2 * nnz)


def test_fm_work_by_hand():
    assert work.fm_exact_work(3, 100) == (4 * 3 * (94 + 100), 3 * 100 * 198)
    assert work.fm_control_work(3, 10) == (4 * 3 * (94 + 10 * 19), 3 * 10 * 205)


def test_bound_takes_the_larger_side_of_each_work():
    by_bytes = (3.35e12, 1.0)  # 1 s of bytes, no time of operations
    by_ops = (1.0, 67e12)  # 1 s of f32 operations
    assert work.bound_s([by_bytes]) == pytest.approx(1.0)
    assert work.bound_s([by_ops]) == pytest.approx(1.0)
    assert work.bound_s([by_bytes, by_ops]) == pytest.approx(2.0)
    assert work.bound_s([(1.0, 989e12)], work.BF16_FLOP_PER_S) == pytest.approx(1.0)


def test_busy_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 7), (9, 12)]
    assert work.busy_union(iv, 0, 10) == pytest.approx(3 + 2 + 1)
    assert work.busy_union(iv, 1.5, 5.75) == pytest.approx(1.5 + 0.75)
    gaps = work.idle_gaps(iv, 0, 10)
    assert gaps == [(3, 5), (7, 9)]
    assert work.idle_gaps([], 0, 1) == [(0, 1)]


def test_corpus_bound_of_the_flagship():
    model_c, _ = rp.load_configs(registry.HERE / "configs" / "flvae2.json")
    rows, n, ticks, frames = 30720, 88576, 88576 // 32, 1 + 88576 // 256
    got = corpus_bound_s(model_c, rows)
    f2 = max(4 * rows * (94 + n) / 3.35e12, rows * n * 198 / 67e12)  # by operations
    f1 = max(4 * rows * (94 + ticks * 19) / 3.35e12, rows * ticks * 205 / 67e12)
    k1_bytes = 4 * (rows * n + rows * 257 * frames)  # the filterbank's few kB aside
    assert f2 == rows * n * 198 / 67e12
    assert got == pytest.approx(f2 + f1 + k1_bytes / 3.35e12, rel=1e-3)
    assert math.isfinite(got)


def _read(name, ctx):
    return registry.metric_reader(name)(ctx)


def test_train_readers():
    ctx = {"kind": "train", "summary": {"step_ms": 30.0, "epoch_s": 4.0},
           "epochs": 5, "steps_per_epoch": 120, "window_s": 20.0,
           "flops_per_step": 5e11, "busy_s": 18.0, "trace_window_s": 20.0,
           "corpus_s": 3.0, "corpus_bound_s": 0.03, "graph_capture_s": 2.5}
    assert _read("train.step_ms", ctx) == 30.0
    assert _read("train.epoch_rest_ms", ctx) == pytest.approx(4000.0 - 120 * 30.0)
    assert _read("train.mfu", ctx) == pytest.approx(100 * 5e11 * 600 / 20.0 / 989e12)
    assert _read("device_idle_pct.train", ctx) == pytest.approx(10.0)
    assert _read("setup.corpus_s", ctx) == 3.0
    assert _read("setup.corpus_roofline_pct", ctx) == pytest.approx(1.0)
    assert _read("setup.graph_capture_s", ctx) == 2.5


def test_readers_find_nothing_outside_their_kind():
    ctx = {"kind": "eval"}
    for name in ("train.step_ms", "train.mfu", "train.epoch_rest_ms", "device_idle_pct.train",
                 "setup.graph_capture_s", "setup.corpus_s", "setup.corpus_roofline_pct"):
        assert _read(name, ctx) is None
    # no trace, no idle share; no count of operations, no mfu
    assert _read("device_idle_pct.train", {"kind": "train", "trace_window_s": None}) is None
    assert _read("train.mfu", {"kind": "train", "flops_per_step": None}) is None


@pytest.mark.parametrize("step_ms", [37.3, 44.1, 53.9])
def test_window_epochs_fill_the_window_and_stay_under_the_save_period(step_ms):
    from portbench.kinds.train import STEP_MARGIN, measured_epoch, window_epochs

    sizing = {"train_steps": 122, "step_ms": step_ms}
    e = window_epochs(sizing, 51.0, 200)
    assert e * 122 * step_ms * STEP_MARGIN / 1e3 >= 51.0 and 1 <= e < 200
    assert window_epochs(sizing, 1e6, 200) == 199
    assert window_epochs(sizing, 51.0, 1) == 1

    class Train:
        save_period = 200

    assert measured_epoch(Train) == 200
    Train.save_period = 1
    assert measured_epoch(Train) == 2
