"""The port's un-stacked six-note FlVAE2 with MIDI in z0
(``r5multi6_v2_12288``, the benchmark's ``multi6``) against the
benchmark's plain reference, ``portbench/reference/frozen``, on the CPU:
one train step, then the eval forward.

The model is built at its published widths from the benchmark's
configuration file: the ``force_bigger_network`` mixers (``mix7`` 256 ->
1800, ``mix8`` 1800 -> 2048, ``unmix1`` 2048 -> 1800, ``dec1`` reading
1800 channels), dim_z 610 with the encoder emitting 608, 257x347 log-mels;
the flows are cut from 6 layers to 3 (width 300 kept), as in
``tests/test_torch_port_multinote.py``. The batch is one preset's six
notes, float32, dropout at the configuration's rates. Both sides start
from the same seeded weights (``portbench/reference/seeded.py``) and draw
their dropout masks and VAE noise from generators in the same state.

Tolerances. The two are the same float32 operations on one device, so
today they agree to the last bit; the tolerances leave room for float32
rounding of a reordered sum (a relative 1e-7 an operation, amplified
through the 1800-wide mixers' sums and the flows' BatchNorms) and
nothing more: losses 1e-5 relative, each gradient leaf and each running
statistic 1e-4 of its norm, the eval outputs 1e-5 of each tensor's
largest magnitude. A wrong MIDI path is outside them: with the notes'
pitches and velocities permuted among the six items in ``info`` (the
spectrograms and targets unchanged), every loss term moves past its
tolerance, the step's total loss by more than 1e-3 (measured 2.6e-3; the
reconstruction alone by 4.4e-5, MIDI being 2 of the random decoder's 610
inputs), and the gradients by a median of more than a hundredth of their
norms (measured 0.54).

The frozen reference is a copy of the port's plain modules that the
benchmark keeps for its ``correct`` comparison, so this file holds the port
to what the benchmark compares it with, not to the model's definition:
the same train and eval steps against the JAX package's live in
``tests/test_torch_port_multinote.py``. Nothing here imports JAX or the
JAX package."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from portbench.reference import presets as rp
from portbench.reference import seeded
from portbench.reference.frozen.training import train_step as fstep
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
from preset_gen_vae_tpu_torch.synth import dexed_params as dx
from preset_gen_vae_tpu_torch.training import train_step as ts
from _torch_port_fixtures import isolated_data_root, two_torch_threads  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = ROOT / "portbench" / "configs" / "multi6.json"
FLOW = "realnvp_3l300"
SEED = 2**31 + 22
BETA = 0.2
LOSSES = ("ReconsLoss/Backprop", "LatLoss", "Controls/BackpropLoss", "TotalLoss")
EVAL_METRICS = ("ReconsLoss/Backprop", "ReconsLoss/MSE", "LatLoss", "Controls/BackpropLoss",
                "Controls/QLoss", "Controls/Accuracy")
EVAL_OUTPUTS = ("z0_mu", "z0", "x_out", "v_out")
LOSS_RTOL = 1e-5  # float32 sums reordered, over a 6 x 257 x 347 batch
LEAF_RTOL = 1e-4  # of each leaf's norm: rounding through 1800-wide sums and the flows' BNs
OUTPUT_TOL = 1e-5  # of each eval output's largest magnitude
MIDI_LOSS_GAP = 1e-3  # the least total-loss gap that the permuted notes must make
MIDI_LEAF_GAP = 1e-2  # the least median gradient gap that they must make


def _configs():
    """The frozen side's resolved configs and preset helper, and the port's,
    from the benchmark's ``multi6`` file: flows of 3 layers, a batch of 6,
    float32."""
    fmc, ftc = rp.load_configs(CONFIG)
    fmc = dataclasses.replace(fmc, latent_flow_arch=FLOW,
                              params_regression_architecture=f"flow_{FLOW}")
    ftc = dataclasses.replace(ftc, minibatch_size=6, compute_dtype="float32", seed=SEED)
    corpus = rp.make_corpus(fmc, ftc, 3, "structured2", SEED)
    fmc, ftc = rp.resolved_configs(fmc, ftc, corpus)
    pm = cfg.ModelConfig(**dataclasses.asdict(fmc))
    pt = cfg.TrainConfig(**dataclasses.asdict(ftc))
    algos, operators = pm.dataset_synth_args
    helper = PresetIndexesHelper(build_dexed_preset_spec(
        algos=tuple(algos) if algos else None, operators=tuple(operators),
        vst_params_learned_as_categorical=pm.synth_vst_params_learned_as_categorical,
        constant_filter_and_tune_params=True,
        param_names=[f"dexed_param_{i}" for i in range(dx.N_PARAMS)]))
    return (fmc, ftc, corpus), (pm, pt, helper)


def _batch(corpus):
    """One preset's six items: seeded log-mels in [-1, 1], its learnable
    targets repeated, each item's own (uid, pitch, velocity)."""
    g = torch.Generator().manual_seed(SEED)
    x = torch.rand((6, 1, 257, 347), generator=g) * 2.0 - 1.0
    v = torch.from_numpy(corpus.v[:6])
    info = torch.from_numpy(corpus.info[:6])
    return x, v, info


def _step_and_eval(model, optimizer, criteria, train_c, step, evaluate, x, v, info):
    generator = torch.Generator().manual_seed(SEED ^ 0x5EED)
    m = step(model, optimizer, criteria, train_c, x, v, info, torch.tensor(BETA),
             generator)
    losses = {k: float(m[k]) for k in LOSSES}
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    stats = {n: b.detach().clone() for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}
    e = evaluate(model, criteria, train_c, x, v, info)
    return dict(losses=losses, grads=grads, stats=stats,
                eval={k: float(e[k]) for k in EVAL_METRICS},
                outputs={k: e[k].detach().float().clone() for k in EVAL_OUTPUTS})


@pytest.fixture(scope="module")
def stepped():
    (fmc, ftc, corpus), (pm, pt, helper) = _configs()
    x, v, info = _batch(corpus)
    ref = seeded.reference_model(fmc, ftc, corpus.helper, torch.device("cpu"))
    seeded.seed_weights(ref, SEED)
    start = {k: t.clone() for k, t in ref.state_dict().items()}
    out = {"ref": _step_and_eval(ref, fstep.make_optimizer(ref, ftc),
                                 fstep.Criteria(fmc, ftc, corpus.helper), ftc,
                                 fstep.train_step, fstep.eval_step, x, v, info)}
    del ref
    # the notes' (pitch, velocity) moved one item on: each spectrogram's
    # z0 gets another item's note
    permuted = info.clone()
    permuted[:, 1:] = info[:, 1:].roll(1, dims=0)
    for name, rows in (("permuted", permuted), ("port", info)):
        port = build_extended_ae_model(pm, pt, helper)
        port.load_state_dict(start)
        out[name] = _step_and_eval(port, ts.make_optimizer(port, pt), ts.Criteria(pm, pt, helper),
                                   pt, ts.train_step, ts.eval_step, x, v, rows)
    out["port_model"], out["info"] = port, info
    return out


def _leaf_gaps(got, want):
    """Each leaf's |got - want| over its norm (over 1 where it is nought)."""
    assert set(got) == set(want)
    return {n: float((got[n] - w).norm()) / (float(w.norm()) or 1.0) for n, w in want.items()}


def test_the_model_is_multi6_at_its_published_widths(stepped):
    sd = stepped["port_model"].state_dict()
    assert stepped["port_model"].ae_model.concat_midi_to_z0
    shapes = {k: tuple(sd[f"ae_model.{k}.weight"].shape) for k in (
        "encoder.mix7.Conv_0", "encoder.mix8.Conv_0", "encoder.mlp_out",
        "decoder.unmix1.TorchConvTranspose2d_0", "decoder.single_ch_cnn.dec1.TorchConvTranspose2d_0")}
    assert shapes == {"encoder.mix7.Conv_0": (1800, 256, 4, 4),
                      "encoder.mix8.Conv_0": (2048, 1800, 1, 1),
                      "encoder.mlp_out": (2 * 608, 24576),  # mu and log-variance of 608 dims
                      "decoder.unmix1.TorchConvTranspose2d_0": (2048, 1800, 1, 1),
                      "decoder.single_ch_cnn.dec1.TorchConvTranspose2d_0": (1800, 256, 4, 4)}
    assert stepped["port"]["outputs"]["z0"].shape == (6, 610)


def test_train_step_loss_terms_match_the_reference(stepped):
    got, want = stepped["port"]["losses"], stepped["ref"]["losses"]
    for k in LOSSES:
        assert got[k] == pytest.approx(want[k], rel=LOSS_RTOL), k


def test_train_step_gradients_match_the_reference(stepped):
    gaps = _leaf_gaps(stepped["port"]["grads"], stepped["ref"]["grads"])
    assert len(gaps) > 100
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < LEAF_RTOL, (worst, gaps[worst])


def test_running_statistics_after_the_step_match_the_reference(stepped):
    gaps = _leaf_gaps(stepped["port"]["stats"], stepped["ref"]["stats"])
    assert len(gaps) > 40
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] < LEAF_RTOL, (worst, gaps[worst])


def test_eval_forward_after_the_step_matches_the_reference(stepped):
    port, ref = stepped["port"], stepped["ref"]
    for k in EVAL_METRICS:
        assert port["eval"][k] == pytest.approx(ref["eval"][k], rel=LOSS_RTOL, abs=1e-7), k
    for k in EVAL_OUTPUTS:
        want = ref["outputs"][k]
        err = float((port["outputs"][k] - want).abs().max() / want.abs().max())
        assert err < OUTPUT_TOL, (k, err)
    # z0's dims 0-1 are each item's pitch and velocity, mapped to [-1, 1]
    midi = -1.0 + 2.0 * stepped["info"][:, 1:3].float() / 127.0
    torch.testing.assert_close(port["outputs"]["z0_mu"][:, :2], midi)


def test_permuted_notes_fall_outside_the_tolerances(stepped):
    """The same comparisons with the notes permuted on the port's side
    fall outside the tolerances above: every loss term, the total loss by
    more than 1e-3, the gradients, the running statistics and z0."""
    got, want = stepped["permuted"], stepped["ref"]
    gaps = {k: abs(got["losses"][k] - want["losses"][k]) / abs(want["losses"][k])
            for k in LOSSES}
    assert min(gaps.values()) > LOSS_RTOL and gaps["TotalLoss"] > MIDI_LOSS_GAP, gaps
    grads = _leaf_gaps(got["grads"], want["grads"])
    assert float(np.median(list(grads.values()))) > MIDI_LEAF_GAP
    assert max(_leaf_gaps(got["stats"], want["stats"]).values()) > LEAF_RTOL
    z0 = got["outputs"]["z0"] - want["outputs"]["z0"]
    assert float(z0.abs().max() / want["outputs"]["z0"].abs().max()) > 100 * OUTPUT_TOL
