"""The readers of the program's spans: each reads its value from a run's
context as the runners record it (a train call's summary ``spans`` and
``span_epochs``; an eval window's mean ``phase_s``), and gives None for
the other kind of cell and where the program has no spans (a program
without them: a summary without ``spans``, passes without the dotted
parts of their phases)."""

import pytest

from portbench import registry

SPANS = {  # two window epochs of flvae2.train: 7 groups of 16, 10 steps left over
    "epoch": {"s": 9.62, "self_s": 0.002, "n": 2},
    "epoch.start": {"s": 0.001, "self_s": 0.001, "n": 2, "host_only": True},
    "epoch.batches": {"s": 0.004, "self_s": 0.004, "n": 2, "host_only": True},
    "epoch.replays": {"s": 0.01, "self_s": 0.01, "n": 14, "device_s": 7.168, "steps": 224},
    "epoch.remainder": {"s": 1.9, "self_s": 0.05, "n": 2, "device_s": 1.8, "steps": 20},
    "train_step": {"s": 1.85, "self_s": 1.85, "n": 20},
    "epoch.fetch": {"s": 6.1, "self_s": 6.1, "n": 2},
    "epoch.train_scalars": {"s": 0.03, "self_s": 0.03, "n": 2, "host_only": True},
    "epoch.validation": {"s": 0.9, "self_s": 0.0, "n": 2},
    "epoch.validation.batches": {"s": 0.002, "self_s": 0.002, "n": 2, "host_only": True},
    "epoch.validation.steps": {"s": 0.1, "self_s": 0.1, "n": 2, "device_s": 0.6},
    "epoch.validation.fetch": {"s": 0.7, "self_s": 0.7, "n": 2},
    "epoch.validation.scalars": {"s": 0.098, "self_s": 0.098, "n": 2, "host_only": True},
    "epoch.schedule": {"s": 0.001, "self_s": 0.001, "n": 2, "host_only": True},
    "epoch.checkpoint": {"s": 0.6, "self_s": 0.6, "n": 1, "host_only": True},
    "epoch.log": {"s": 0.0002, "self_s": 0.0002, "n": 2, "host_only": True},
}
TRAIN = {"kind": "train", "summary": {"spans": SPANS, "span_epochs": 2, "step_ms": 37.4}}
PHASES = {"dataset": 0.05, "model": 2.0, "inference": 0.8, "render": 0.6, "similarity": 0.6,
          "artifacts": 1.9, "model.init": 1.6, "model.load": 0.39, "artifacts.spearman": 1.2,
          "artifacts.write": 0.5, "artifacts.means": 0.15}
EVAL = {"kind": "eval", "phase_s": PHASES}
HOST_ONLY = 0.001 + 0.004 + 0.03 + 0.002 + 0.098 + 0.001 + 0.6 + 0.0002

EXPECTED = {
    "train.replay_step_ms": (TRAIN, 1e3 * 7.168 / 224),
    "train.remainder_ms": (TRAIN, 1e3 * 1.8 / 2),
    "train.validation_ms": (TRAIN, 1e3 * 0.9 / 2),
    "train.host_only_ms": (TRAIN, 1e3 * HOST_ONLY / 2),
    "train.checkpoint_ms": (TRAIN, 600.0),
    "eval.loaders_s": (EVAL, 0.05),
    "eval.model_init_s": (EVAL, 1.6),
    "eval.checkpoint_load_s": (EVAL, 0.39),
    "eval.artifacts_s": (EVAL, 1.9),
}
# each kind as a program without spans records it
NO_SPANS = {"train": {"kind": "train", "summary": {"step_ms": 37.4, "epoch_s": 4.8}},
            "eval": {"kind": "eval", "phase_s": {k: PHASES[k] for k in (
                "dataset", "model", "inference", "render", "similarity", "artifacts")}}}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_reads_its_spans(name):
    ctx, want = EXPECTED[name]
    assert registry.metric_reader(name)(ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_gives_none_for_the_other_kind(name):
    ctx = EVAL if EXPECTED[name][0] is TRAIN else TRAIN
    assert registry.metric_reader(name)(ctx) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_a_reader_gives_none_without_spans(name):
    kind = EXPECTED[name][0]["kind"]
    assert registry.metric_reader(name)(NO_SPANS[kind]) is None


def test_the_remainder_reads_0_without_steps_left_over_and_none_off_the_card():
    read = registry.metric_reader("train.remainder_ms")
    spans = {k: v for k, v in SPANS.items() if k not in ("epoch.remainder", "train_step")}
    assert read({"kind": "train", "summary": {"spans": spans, "span_epochs": 2}}) == 0.0
    cpu = {k: {f: x for f, x in v.items() if f != "device_s"} for k, v in SPANS.items()}
    ctx = {"kind": "train", "summary": {"spans": cpu, "span_epochs": 2}}
    assert read(ctx) is None
    assert registry.metric_reader("train.replay_step_ms")(ctx) is None


def test_the_checkpoint_reads_none_where_the_window_wrote_none():
    spans = {k: v for k, v in SPANS.items() if k != "epoch.checkpoint"}
    ctx = {"kind": "train", "summary": {"spans": spans, "span_epochs": 2}}
    assert registry.metric_reader("train.checkpoint_ms")(ctx) is None
    assert registry.metric_reader("train.host_only_ms")(ctx) == pytest.approx(
        1e3 * (HOST_ONLY - 0.6) / 2)
