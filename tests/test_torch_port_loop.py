"""The port's epoch loop against the JAX package's: LR warm-up, plateau
scheduler, early stop and beta warm-up; checkpoints and exact resume; the
NaN check and the queue's retries.

Schedules are compared to the last bit: the port's ``EpochSchedule`` and a
replica of the JAX loop's scheduling lines (loop.py:437-446, 471-478,
814-822 there, with the JAX package's ``LinearDynamicParam`` and
``ReduceLROnPlateau``) take the same seeded validation losses. The JAX
optimizer keeps its learning rate as float32, so the JAX loop's early-stop
test reads that float32 back; the port keeps the float the schedule gives,
and the test holds both to the same LR floats and the same early-stop
epoch.

The training runs use the full-width flagship (257x347 log-mels, the
realnvp_6l300 flows) on one shared 64-preset corpus at batch 16 on the CPU,
operators 1-2 only (learnable size 250): 40 train items (2 steps an epoch),
11 validation items (one padded batch). Resume bar: a 3-epoch run and a
2-epoch run resumed for 1 epoch agree on every /Valid scalar, ``final_lr``
and every parameter and buffer to 1e-6 relative (measured: bit-equal).
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu import config as jcfg
from preset_gen_vae_tpu.training.schedulers import ReduceLROnPlateau as JaxPlateau
from preset_gen_vae_tpu.utils.hparams import LinearDynamicParam as JaxLinear
from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.logs.logger import list_checkpoint_epochs, load_checkpoint
from preset_gen_vae_tpu_torch.training import loop
from preset_gen_vae_tpu_torch.training import queue as q
from preset_gen_vae_tpu_torch.training.train_step import SCALARS
from preset_gen_vae_tpu_torch.utils.exception import ModelConvergenceError
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)

SCHEDULE = dict(lr_warmup_epochs=3, lr_warmup_start_factor=0.1, beta_warmup_epochs=5,
                scheduler_patience=2, scheduler_cooldown=2, scheduler_lr_factor=0.2)
# every plateau step counts as bad (best * (1 - 2) = -inf), so each one
# drops the LR after `patience` epochs: the scheduler acts every epoch
ALWAYS_BAD = dict(lr_warmup_epochs=0, scheduler_patience=0, scheduler_threshold=2.0)


def _losses(n=48, seed=0):
    """Seeded validation losses: a descent, plateaus with 1e-6 jitter, a
    second descent, a long plateau (to drive the LR under the early-stop
    threshold)."""
    rng = np.random.default_rng(seed)
    base = np.concatenate([np.linspace(3.0, 1.5, 8), np.full(9, 1.5), np.linspace(1.5, 1.0, 6),
                           np.full(n - 23, 1.0)])
    noise = rng.uniform(-1e-6, 1e-6, (2, n))
    return base * 0.7 + noise[0], base * 0.3 + noise[1]


def _jax_schedule(tc, recons, controls, start=0, sched=None):
    """The JAX loop's scheduling lines, epoch by epoch:
    -> [(lr, beta, lr after validation, early stop)]."""
    lr_warmup = JaxLinear(tc.lr_warmup_start_factor, 1.0, end_epoch=tc.lr_warmup_epochs,
                          current_epoch=start)
    beta_warmup = JaxLinear(tc.beta_start_value, tc.beta, end_epoch=tc.beta_warmup_epochs,
                            current_epoch=start)
    out = []
    for epoch in range(start, len(recons)):
        if epoch <= tc.lr_warmup_epochs:
            lr = lr_warmup.get(epoch) * tc.initial_learning_rate
            sched.lr = lr
        else:
            lr = sched.lr
        beta = float(beta_warmup.get(epoch))
        if epoch > tc.lr_warmup_epochs:
            sched.step(float(recons[epoch]) + float(controls[epoch]))
        stop = float(jnp.asarray(sched.lr, jnp.float32)) < tc.early_stop_lr_threshold
        out.append((lr, beta, sched.lr, stop))
        if stop:
            break
    return out


def _jax_plateau(tc):
    return JaxPlateau(tc.initial_learning_rate, factor=tc.scheduler_lr_factor,
                      patience=tc.scheduler_patience, cooldown=tc.scheduler_cooldown,
                      threshold=tc.scheduler_threshold)


def _port_schedule(schedule, recons, controls, start=0):
    out = []
    for epoch in range(start, len(recons)):
        lr, beta = schedule.epoch_start(epoch)
        lr_end, stop = schedule.epoch_end(epoch, {"ReconsLoss/Backprop": float(recons[epoch]),
                                                  "Controls/BackpropLoss": float(controls[epoch])})
        out.append((lr, beta, lr_end, stop))
        if stop:
            break
    return out


def test_schedule_matches_jax_to_the_bit():
    recons, controls = _losses()
    _, tc = cfg.resolve(cfg.ModelConfig(), cfg.TrainConfig(**SCHEDULE))
    _, jtc = jcfg.resolve(jcfg.ModelConfig(), jcfg.TrainConfig(**SCHEDULE))
    assert tc.early_stop_lr_threshold == jtc.early_stop_lr_threshold
    got = _port_schedule(loop.EpochSchedule(tc), recons, controls)
    want = _jax_schedule(jtc, recons, controls, sched=_jax_plateau(jtc))
    assert got == want  # exact floats: same LRs, betas and early-stop epoch
    lrs = [r[0] for r in got]
    assert lrs[:4] == pytest.approx([tc.initial_learning_rate * f for f in (0.1, 0.4, 0.7, 1.0)])
    assert len(set(lrs)) >= 8  # warm-up, then five plateau drops
    assert got[-1][3] and not any(r[3] for r in got[:-1])  # stops on the drop under 2e-7
    assert 40 <= len(recons) and len(got) < len(recons)


def test_schedule_state_round_trip_matches_jax():
    """The scheduler's state goes through JSON (as meta.json holds it) after
    the first epoch that leaves it in a cooldown, into a schedule that
    resumes at the next epoch."""
    recons, controls = _losses(seed=1)
    _, tc = cfg.resolve(cfg.ModelConfig(), cfg.TrainConfig(**SCHEDULE))
    _, jtc = jcfg.resolve(jcfg.ModelConfig(), jcfg.TrainConfig(**SCHEDULE))
    first, head = loop.EpochSchedule(tc), []
    for epoch in range(len(recons)):
        head += _port_schedule(first, recons[:epoch + 1], controls[:epoch + 1], start=epoch)
        if first.plateau.cooldown_counter > 0:
            break
    cut = len(head)
    assert 5 < cut < 30
    state = json.loads(json.dumps(first.plateau.state_dict()))
    resumed = loop.EpochSchedule(dataclasses.replace(tc, start_epoch=cut))
    resumed.plateau.load_state_dict(state)
    tail = _port_schedule(resumed, recons, controls, start=cut)
    assert head + tail == _jax_schedule(jtc, recons, controls, sched=_jax_plateau(jtc))
    assert tail[-1][3]  # the resumed schedule reaches the early stop


@pytest.fixture(scope="module")
def dataset():
    return DexedDataset(n_synthetic_presets=64, operators=(1, 2), device="cpu")


def _run(tmp, dataset, run_name, **train_kwargs):
    model_c = cfg.ModelConfig(dataset_synth_args=(None, (1, 2)), logs_root_dir=str(tmp),
                              run_name=run_name)
    kw = {"minibatch_size": 16, "save_period": 1, "verbosity": 0, **train_kwargs}
    summary = loop.train_config(model_c, cfg.TrainConfig(**kw), dataset=dataset, device="cpu",
                                use_tensorboard=False)
    return model_c, summary


@pytest.fixture(scope="module")
def resumed(dataset, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("runs")
    sched = dict(ALWAYS_BAD, scheduler_cooldown=1, scheduler_lr_factor=0.5)
    full_c, full = _run(tmp, dataset, "full", n_epochs=3, **sched)
    cut_c, cut = _run(tmp, dataset, "cut", n_epochs=2, **sched)
    cut_epochs = list_checkpoint_epochs(cut_c)
    _, res = _run(tmp, dataset, "cut", start_epoch=2, n_epochs=3, **sched)
    return dict(full_c=full_c, full=full, cut_c=cut_c, cut=cut, cut_epochs=cut_epochs,
                res=res, tmp=tmp, sched=sched)


def test_resume_is_exact(resumed):
    full, res = resumed["full"], resumed["res"]
    assert full["epochs_trained"] == res["epochs_trained"] == 3
    assert resumed["cut"]["epochs_trained"] == 2
    assert res["start_step"] == resumed["cut"]["train_steps"] == 2 * res["train_steps"] == 4
    init = 2e-4
    # the LR fell after epoch 1, before the cut, and the restored cooldown
    # kept it there after epoch 2
    assert resumed["cut"]["final_lr"] == res["start_lr"][0] == init * 0.5
    assert full["final_lr"] == res["final_lr"] == init * 0.5
    valid = [k for k in full if k.endswith("/Valid")]
    assert len(valid) == 9  # 7 step scalars, VAELoss, LatCorr
    for k in valid:
        assert res[k] == pytest.approx(full[k], rel=1e-6, abs=1e-12), k
    a = load_checkpoint(resumed["full_c"], 2)["state"]
    b = load_checkpoint(resumed["cut_c"], 2)["state"]
    assert a["step"] == b["step"] == 6
    assert a["model"].keys() == b["model"].keys()
    for k, t in a["model"].items():
        u = b["model"][k]
        if t.is_floating_point():
            scale = float(t.abs().max()) or 1.0
            assert float((t - u).abs().max()) <= 1e-6 * scale, k
        else:
            assert torch.equal(t, u), k


def test_checkpoints_follow_the_jax_cadence(resumed):
    """(epoch > 0 and epoch % save_period == 0) or the last epoch or early
    stop (loop.py:869-875 there): save_period 1 saves every epoch but 0."""
    assert list_checkpoint_epochs(resumed["full_c"]) == [1, 2]
    assert resumed["cut_epochs"] == [1]
    assert list_checkpoint_epochs(resumed["cut_c"]) == [1, 2]
    ckpt = load_checkpoint(resumed["cut_c"], 1)  # torch.load(weights_only=True)
    assert ckpt["epoch"] == 1 and set(ckpt["state"]) == {"model", "optimizer", "step",
                                                         "generator"}
    assert ckpt["scheduler"] == {"lr": 1e-4, "best": float("inf"), "num_bad_epochs": 0,
                                 "cooldown_counter": 1}


def test_resume_with_a_changed_config_raises(resumed, dataset):
    with pytest.raises(ValueError, match="test_holdout_proportion"):
        _run(resumed["tmp"], dataset, "cut", start_epoch=3, n_epochs=4,
             test_holdout_proportion=0.25, **resumed["sched"])


def test_early_stop_stops_and_saves(dataset, tmp_path):
    model_c, s = _run(tmp_path, dataset, "early", n_epochs=5, save_period=50,
                      scheduler_lr_factor=1e-4, scheduler_cooldown=0, **ALWAYS_BAD)
    assert s["early_stop"] and s["epochs_trained"] == 2
    assert s["final_lr"] == pytest.approx(2e-8) and s["final_lr"] < 2e-7
    assert list_checkpoint_epochs(model_c) == [1]  # neither save_period nor the last epoch


def test_nan_loss_raises(dataset, tmp_path, monkeypatch):
    def nan_step(*args, **kwargs):
        return {k: torch.tensor(float("nan")) for k in SCALARS + ("TotalLoss",)}

    monkeypatch.setattr(loop, "train_step", nan_step)
    with pytest.raises(ModelConvergenceError, match="epoch 0"):
        _run(tmp_path, dataset, "nan", n_epochs=2)


def test_run_queue_retries_with_new_seeds_then_aborts(monkeypatch):
    """tests/test_loop.py::test_run_queue_nan_retry for the port: each
    retry bumps the seed by 1000 x restart; after max_restarts the queue
    raises."""
    seeds = []

    def diverging(model_c, train_c, **kw):
        seeds.append(train_c.seed)
        assert kw == {"device": "cpu"}
        raise ModelConvergenceError("NaN at epoch 0")

    monkeypatch.setattr(q, "train_config", diverging)
    with pytest.raises(RuntimeError, match="diverged 3 times"):
        q.run_queue([({"run_name": "r0"}, {})], max_restarts=2, device="cpu")
    assert seeds == [0, 1000, 3000]


def test_expand_k_folds():
    mods = q.expand_k_folds([({"run_name": "r"}, {})], 3)
    assert [m["run_name"] for m, _ in mods] == ["r_kf0", "r_kf1", "r_kf2"]
    assert [t["current_k_fold"] for _, t in mods] == [0, 1, 2]
