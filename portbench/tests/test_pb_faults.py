"""A whole run of the train kind on the CPU, past the harness's look for a
card, at a tiny size (``data/tiny_train.json``: BasicVAE, dim_z 16, an MLP
head, full-size log-mels, 40 presets, batch 8): a sound run reads
``correct`` true, and each fault that a train cell can have, planted in the
port underneath, makes it false under the flagship cell's own limits:

- a step that returns its state unchanged (the weights put back after it);
- half of the batch left out, the losses the mean over the rest;
- an answer altered where it is produced (the step's reported loss);
- a corpus row altered where it is produced (the log-mel 30 dB high);
- a fault in the measured call alone (its state left unchanged), which
  the numbers of the resumed epoch catch.

One card (no exchange between chips), so there is no collective to leave
out. The sound run's process loads no JAX.

The port's plain FM render on the CPU, a Python loop over 88,576 samples,
takes a minute a corpus; the module puts the reference's render, the same
operations with the feedback loop in NumPy, in its place (``fast_render``)."""

import json
import pathlib

import pytest
import torch

from portbench import registry
from portbench.kinds import configs, train
from portbench.run import forbidden_modules

ROOT = pathlib.Path(__file__).resolve().parents[2]
TINY = pathlib.Path(__file__).resolve().parent / "data" / "tiny_train.json"
SEED = 2**31 + 9  # a seed above 32 signed bits, as a run's may be


def _cell():
    limits = json.loads((registry.HERE / "workloads" / "flvae2.train.json").read_text())
    return registry.Cell(name="tiny.train", config_path=TINY, config=registry.load_json(TINY),
                         traffic={"kind": "train"}, workload=limits, chips=1, end_to_end=[],
                         per_layer=[])


def fast_render(presets, pitches, velocities, note_on_s=3.0, total_s=4.0, sample_rate=22050,
                feedback="unrolled", fb_iters=3):
    """``fm_torch.render_batch``'s exact render on the CPU, by the
    reference's loop."""
    from portbench.reference.corpus import render

    assert feedback == "exact"
    presets = torch.as_tensor(presets)
    return render(presets.cpu().numpy(), pitches, velocities, note_on_s, total_s,
                  sample_rate).to(presets.device)


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


def _run(tmp_path, dataset=None):
    return train.run(_cell(), seed=SEED, seconds=0.1, trace=False, t_start=0.0,
                     runs_root=tmp_path, device="cpu", dataset=dataset)


def test_a_sound_run_is_correct(tmp_path, dataset, threads):
    out = _run(tmp_path, dataset)
    assert out.correct, out.checks
    assert {name for name, _, _ in out.checks} == set(_cell().workload["limits"])
    assert out.end_to_end["train_items_per_s"] > 0 and out.end_to_end["setup_s"] > 0
    assert forbidden_modules() == []


def _wrap_step(monkeypatch, wrap):
    from preset_gen_vae_tpu_torch.training import loop

    monkeypatch.setattr(loop, "train_step", wrap(loop.train_step))


def _unchanged(step):
    def run(model, optimizer, *args, **kwargs):
        saved = [p.detach().clone() for p in model.parameters()]
        m = step(model, optimizer, *args, **kwargs)
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)
        return m
    return run


def _half_batch(step):
    def run(model, optimizer, criteria, train_c, x, v, info, *args, **kwargs):
        half = x.shape[0] // 2
        return step(model, optimizer, criteria, train_c, x[:half], v[:half], info[:half],
                    *args, **kwargs)
    return run


def _altered_answer(step):
    def run(*args, **kwargs):
        m = step(*args, **kwargs)
        m["TotalLoss"] = m["TotalLoss"] * 1.1
        return m
    return run


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered_answer],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_a_fault_in_the_step_fails(tmp_path, dataset, threads, monkeypatch, fault):
    _wrap_step(monkeypatch, fault)
    out = _run(tmp_path, dataset)
    assert not out.correct, out.checks


def test_an_altered_corpus_row_fails(tmp_path, threads, monkeypatch):
    from preset_gen_vae_tpu_torch.ops import spectrogram

    call = spectrogram.SpectrogramProcessor.__call__
    monkeypatch.setattr(spectrogram.SpectrogramProcessor, "__call__",
                        lambda self, x: call(self, x) + 30.0)
    out = _run(tmp_path)
    bad = [name for name, v, lim in out.checks if not v <= lim]
    assert "corpus_row_mean_gap" in bad, out.checks


def test_a_fault_in_the_measured_call_alone_fails(tmp_path, dataset, threads, monkeypatch):
    from preset_gen_vae_tpu_torch.training import loop

    first = train.measured_epoch(configs(_cell(), SEED, tmp_path)[1])
    plain, faulty = loop.train_step, _unchanged(loop.train_step)
    calls = loop.train_config

    def train_config(model_c, train_c, **kwargs):
        monkeypatch.setattr(loop, "train_step", faulty if train_c.start_epoch == first else plain)
        return calls(model_c, train_c, **kwargs)

    monkeypatch.setattr(loop, "train_config", train_config)
    out = _run(tmp_path, dataset)
    bad = {name for name, v, lim in out.checks if not v <= lim}
    assert bad and all(name.startswith("resumed.") for name in bad), out.checks
