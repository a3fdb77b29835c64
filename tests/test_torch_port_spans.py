"""The port's spans (``utils/profile.py:Spans``) and where the epoch loop and
the evaluation pass open them.

- The facility: nesting, self time, counts, counters and ids; the totals
  over chosen ids; no ``record_function`` opened while no profiler records;
  named events nested in a ``torch.profiler`` trace on the CPU.
- ``train_config`` on the loop tests' 64-preset corpus (40 train items) at
  batch 5 and K = 3, 8 batches an epoch (two groups, two steps left over),
  over 3 epochs: the spans of the two epochs after the first match
  ``dispatch_sizes``, the steps left over replayed from the one-step graph
  (on the CPU its body, eagerly) and only the first epoch's warm-up
  group stepping eagerly, each epoch's top-level spans cover its wall within
  5%, the logger's epoch times are the epoch spans', and every number of
  the summary is finite.
- ``evaluate_model`` on that run: every phase key, each part no larger
  than its phase, the phases cover the pass's wall; without the audio, the
  render and similarity read 0.
"""

import math
import time

import pytest
import torch

from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.evaluation import evaluate as ev
from preset_gen_vae_tpu_torch.logs import logger
from preset_gen_vae_tpu_torch.training import loop
from preset_gen_vae_tpu_torch.training.dispatch import dispatch_sizes
from preset_gen_vae_tpu_torch.utils.profile import Spans
from _torch_port_fixtures import isolated_data_root, tiny_configs, two_torch_threads  # noqa: F401

N_PRESETS, BATCH, K, EPOCHS = 64, 5, 3, 3
TOP = ("dataset", "model", "inference", "render", "similarity", "artifacts")


def test_spans_nest_count_and_sum_self_time():
    spans = Spans()
    for epoch in (4, 5):
        with spans.span("epoch", id=epoch) as outer:
            with spans.span("epoch.a", host_only=True) as a:
                a.count("steps", 3)
                time.sleep(0.002)
            with spans.span("epoch.a") as a:
                a.count("steps", 2)
                with spans.span("inner"):
                    time.sleep(0.001)
            time.sleep(0.001)
        assert outer.parent is None and outer.id == epoch
    by_name = {}
    for r in spans.records:
        by_name.setdefault(r.name, []).append(r)
    assert [r.id for r in by_name["epoch.a"]] == [4, 4, 5, 5]
    assert all(r.parent.name == "epoch" for r in by_name["epoch.a"])
    assert all(r.parent.name == "epoch.a" for r in by_name["inner"])
    t = spans.totals()
    assert t["epoch"]["n"] == 2 and t["epoch.a"]["n"] == 4 and t["inner"]["n"] == 2
    assert t["epoch.a"]["steps"] == 10 and t["epoch.a"]["host_only"] is True
    assert "host_only" not in t["epoch"] and "device_s" not in t["epoch.a"]
    assert t["epoch"]["self_s"] == pytest.approx(t["epoch"]["s"] - t["epoch.a"]["s"])
    assert t["epoch.a"]["self_s"] == pytest.approx(t["epoch.a"]["s"] - t["inner"]["s"])
    assert t["epoch"]["self_s"] >= 0.002 and t["inner"]["self_s"] == t["inner"]["s"]
    one = spans.totals([5])
    assert one["epoch"]["n"] == 1 and one["epoch.a"]["steps"] == 5
    assert one["epoch"]["s"] == pytest.approx(by_name["epoch"][1].s)
    assert spans.totals([]) == {}


def test_no_record_function_without_a_profiler(monkeypatch):
    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    spans = Spans()
    with spans.span("epoch", id=0), spans.span("epoch.fetch"):
        torch.ones(4).sum()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("epoch", id=1), spans.span("epoch.fetch"):
            torch.ones(4).sum()
    assert opened == ["epoch", "epoch.fetch"]


def test_spans_nest_as_named_events_in_a_profiler_trace():
    spans = Spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with spans.span("epoch", id=0):
            with spans.span("epoch.replays", device=True):
                torch.ones(64).sum()
            with spans.span("epoch.fetch"):
                torch.ones(64).sum()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("epoch")}
    assert set(events) == {"epoch", "epoch.replays", "epoch.fetch"}
    outer = events["epoch"]
    for name in ("epoch.replays", "epoch.fetch"):
        e = events[name]
        assert outer.start_ns() <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= outer.start_ns() + outer.duration_ns()
    assert "device_s" not in spans.totals()["epoch.replays"]  # no card: no events


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """3 epochs at batch 5 and K = 3, with the loop's Spans and the logger's
    epoch times kept."""
    root = tmp_path_factory.mktemp("spans")
    dataset = DexedDataset(n_synthetic_presets=N_PRESETS, device="cpu")
    model_c, train_c = tiny_configs(cfg, root, "spans", minibatch_size=BATCH, n_epochs=EPOCHS,
                                    steps_per_dispatch=K)
    made, logged = [], []

    class Kept(Spans):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    finished = logger.RunLogger.on_epoch_finished
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "Spans", Kept)
        mp.setattr(logger.RunLogger, "on_epoch_finished",
                   lambda self, epoch, dur: logged.append(dur) or finished(self, epoch, dur))
        summary = loop.train_config(model_c, train_c, dataset=dataset, device="cpu",
                                    use_tensorboard=False)
    return dict(summary=summary, spans=made[0], logged=logged, dataset=dataset,
                model_c=model_c, train_c=train_c)


def test_train_spans_match_the_dispatch(trained):
    s = trained["summary"]
    n_batches = s["train_steps"] // EPOCHS
    sizes = dispatch_sizes(n_batches, K)
    assert n_batches == 8 and n_batches % K and s["steps_per_dispatch"] == K
    groups, singles = [k for k in sizes if k > 1], [k for k in sizes if k == 1]
    window = EPOCHS - 1
    assert s["span_epochs"] == window
    t = s["spans"]
    assert t["epoch"]["n"] == window
    assert (t["epoch.replays"]["n"], t["epoch.replays"]["steps"]) == (
        window * len(groups), window * sum(groups))
    assert (t["epoch.remainder"]["n"], t["epoch.remainder"]["steps"]) == (
        window, window * len(singles))
    assert t["epoch.remainder"]["replayed"] == window * len(singles)
    # the first epoch's: no step of the window runs eagerly
    assert "epoch.warmup" not in t and "epoch.capture" not in t and "train_step" not in t
    for name in ("epoch.start", "epoch.batches", "epoch.fetch", "epoch.train_scalars",
                 "epoch.validation", "epoch.validation.batches", "epoch.validation.steps",
                 "epoch.validation.fetch", "epoch.validation.scalars", "epoch.schedule",
                 "epoch.log", "epoch.checkpoint"):  # save_period 1: every epoch
        assert t[name]["n"] == window, name
    assert {k for k, v in t.items() if v.get("host_only")} == {
        "epoch.start", "epoch.batches", "epoch.train_scalars", "epoch.validation.batches",
        "epoch.validation.scalars", "epoch.schedule", "epoch.checkpoint", "epoch.log"}
    # the first epoch: its warm-up group, then the groups and steps of every epoch
    first = trained["spans"].totals([trained["train_c"].start_epoch])
    assert first["epoch.warmup"]["steps"] == first["train_step"]["n"] == groups[0]
    assert first["epoch.replays"]["steps"] + groups[0] == sum(groups)
    assert first["epoch.remainder"]["replayed"] == first["epoch.remainder"]["steps"] == len(singles)


def test_train_spans_cover_each_epoch(trained):
    records = trained["spans"].records
    epochs = [r for r in records if r.name == "epoch"]
    assert [r.id for r in epochs] == list(range(EPOCHS))
    for epoch in epochs:
        top = sum(r.s for r in records if r.parent is epoch)
        assert top <= epoch.s and top >= 0.95 * epoch.s, (epoch.id, top, epoch.s)
    s = trained["summary"]
    assert s["epoch_s"] == pytest.approx(sum(r.s for r in epochs[1:]) / (EPOCHS - 1))
    assert s["spans"]["epoch"]["s"] == pytest.approx(sum(r.s for r in epochs[1:]))
    # the logger's epoch times: the same clock, read just before each span closes
    for dur, epoch in zip(trained["logged"], epochs):
        assert 0 < dur <= epoch.s and epoch.s - dur < 0.05 * epoch.s


def test_every_number_of_the_summary_is_finite(trained):
    def numbers(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                yield from numbers(v, f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                yield from numbers(v, f"{path}/{i}")
        elif isinstance(x, (int, float)) and not isinstance(x, bool):
            yield path, x

    found = list(numbers(trained["summary"], ""))
    assert any(p.startswith("/spans/") for p, _ in found)
    assert [p for p, v in found if not math.isfinite(v)] == []


def test_evaluate_spans_cover_the_pass(trained):
    eval_c = cfg.EvalConfig(epoch=EPOCHS - 1, audio_render_backend="cpp")
    phases = {}
    t0 = time.perf_counter()
    ev.evaluate_model(trained["model_c"], trained["train_c"], eval_c, device="cpu",
                      dataset=trained["dataset"], phase_seconds=phases)
    wall = time.perf_counter() - t0
    assert set(phases) == {*ev.PHASES, "tconv_out_launches"} and set(TOP) < set(ev.PHASES)
    assert phases.pop("tconv_out_launches") == 0  # the plain version on the CPU
    assert all(v > 0 for v in phases.values()), phases
    assert phases["model.init"] + phases["model.load"] <= phases["model"]
    assert sum(phases[f"artifacts.{k}"] for k in ("spearman", "write", "means")) <= \
        phases["artifacts"]
    top = sum(phases[k] for k in TOP)
    assert 0.98 * wall <= top <= wall, (top, wall)

    quiet = {}
    ev.evaluate_model(trained["model_c"], trained["train_c"], eval_c, device="cpu",
                      dataset=trained["dataset"], phase_seconds=quiet, render_audio=False)
    assert set(quiet) == {*ev.PHASES, "tconv_out_launches"}
    assert quiet["render"] == quiet["similarity"] == 0.0 and quiet["artifacts.write"] > 0
