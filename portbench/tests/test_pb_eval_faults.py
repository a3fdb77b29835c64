"""A whole run of the eval kind on the CPU, past the harness's look for a
card, at the tiny size of ``test_pb_faults.py``: a sound run reads
``correct`` true, and each fault that an eval cell can have, planted in
the port underneath, makes it false under the flagship eval cell's own
limits:

- half of the batch left out (the model run on the first half of each
  batch, its outputs repeated over the rest);
- an answer altered where it is produced: the inferred presets, and,
  apart, the re-rendered audio (the inferred presets' audio replaced by
  the ground truth's).

An evaluation updates no state and runs on one card, so the faults of a
state left unchanged and of an exchange left out do not arise. The port's
render is replaced as in ``test_pb_faults.py``."""

import json
import pathlib

import pytest
import torch

from portbench import registry
from portbench.kinds import configs
from portbench.kinds import eval as keval
from test_pb_faults import TINY, fast_render

SEED = 2**31 + 17


def _cell():
    limits = json.loads((registry.HERE / "workloads" / "flvae2.eval.json").read_text())
    return registry.Cell(name="tiny.eval", config_path=TINY, config=registry.load_json(TINY),
                         traffic={"kind": "eval", "audio_batch_size": 4},
                         workload={**limits, "sample_presets": 2, "sample_items": 3},
                         chips=1, end_to_end=[], per_layer=[])


@pytest.fixture(scope="module")
def cpu():
    from preset_gen_vae_tpu_torch.synth import fm_torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fm_torch, "render_batch", fast_render)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset(cpu):
    from preset_gen_vae_tpu_torch.training.loop import prepare_dataset

    cell = _cell()
    model_c, train_c, _, _ = configs(cell, SEED, pathlib.Path("unused"))
    _, _, ds = prepare_dataset(model_c, train_c, torch.device("cpu"), None,
                               {**cell.config["dataset"], "synthetic_seed": SEED})
    ds.load_corpus()
    return ds


def _run(tmp_path, dataset):
    return keval.run(_cell(), seed=SEED, seconds=0.0, trace=False, t_start=0.0,
                     runs_root=tmp_path, device="cpu", dataset=dataset)


def test_a_sound_run_is_correct(tmp_path, dataset):
    out = _run(tmp_path, dataset)
    assert out.correct, out.checks
    assert {name for name, _, _ in out.checks} == set(_cell().workload["limits"])
    assert out.end_to_end["eval_items_per_s"] > 0


def _wrap_model(monkeypatch, wrap):
    from preset_gen_vae_tpu_torch.evaluation import evaluate

    build = evaluate.build_extended_ae_model

    def built(*args, **kwargs):
        model = build(*args, **kwargs)
        model.forward_full = wrap(model.forward_full)
        return model

    monkeypatch.setattr(evaluate, "build_extended_ae_model", built)


def _half_batch(forward):
    def run(x, info, *args, **kwargs):
        half = max(x.shape[0] // 2, 1)
        outs = forward(x[:half], info[:half], *args, **kwargs)
        rows = torch.arange(x.shape[0]) % half
        return tuple(o[rows] if o.dim() else o for o in outs)
    return run


def _altered_presets(forward):
    def run(*args, **kwargs):
        outs = forward(*args, **kwargs)
        return outs[:5] + (outs[5] + 0.1,)
    return run


@pytest.mark.parametrize("fault", [_half_batch, _altered_presets],
                         ids=["half_batch", "presets_altered"])
def test_a_fault_in_the_inference_fails(tmp_path, dataset, monkeypatch, fault):
    _wrap_model(monkeypatch, fault)
    assert not _run(tmp_path, dataset).correct


def test_altered_audio_fails(tmp_path, dataset, monkeypatch):
    from preset_gen_vae_tpu_torch.evaluation import evaluate

    pairs = evaluate.render_pairs

    def render_pairs(*args, **kwargs):
        gt, _ = pairs(*args, **kwargs)
        return gt, gt.clone()

    monkeypatch.setattr(evaluate, "render_pairs", render_pairs)
    out = _run(tmp_path, dataset)
    bad = [name for name, v, lim in out.checks if not v <= lim]
    assert "audio_error_gap" in bad, out.checks
