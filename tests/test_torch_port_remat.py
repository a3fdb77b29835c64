"""``TrainConfig.remat`` in the port's train step: the forward runs under a
non-reentrant ``torch.utils.checkpoint`` and is recomputed in the
backward, as the JAX step wraps its forward in ``jax.checkpoint``
(``preset_gen_vae_tpu/training/train_step.py:257-260``; its test,
``tests/test_train_step.py:144-156``, holds the loss with and without).

The recompute must be the same math. The dropout masks and the VAE noise
come from the step's explicit generator, and the recompute reuses the
forward's draws (a selective checkpoint), leaving the generator where the
forward left it; the
train-mode BatchNorms (``layers.BatchNorm``, ``flows.BatchNormFlow``)
update their running statistics in the forward only, not again in the
recompute; the FlowParamsLoss pullback, whose train-mode BatchNorms chain
further updates after the forward's, stays outside the checkpoint. So one
step with remat and one without, in float64 on the CPU from the same
weights and generator seed, give the same loss, every gradient, every
running statistic and the generator's state within 1e-10 of each tensor's
largest entry (measured: bit-equal), in three cases of one test: the
flagship (dropout 0.3 and 0.4, the noise), FlowParamsLoss with
``flow_loss_bn_mode='train'``, and two gloo processes each stepping on
half the rows (sync-BN: the recompute all-reduces the batch moments again
and updates nothing). The step with remat runs every BatchNorm's forward
twice.
"""

import dataclasses

import pytest
import torch
import torch.multiprocessing as mp

from preset_gen_vae_tpu_torch.models import flows, layers
import _torch_port_ranks as ranks
from _torch_port_fixtures import two_torch_threads  # noqa: F401

BATCH = 8


def assert_same_step(got: dict, want: dict):
    """Loss, gradients and running statistics within 1e-10 of each
    tensor's largest entry (exactly, where that is 0); the generator's
    state equal."""
    assert torch.equal(got["generator"], want["generator"])
    assert float((got["loss"] - want["loss"]).abs()) <= 1e-10 * float(want["loss"].abs())
    for kind in ("grads", "stats"):
        assert got[kind].keys() == want[kind].keys()
        for k, t in want[kind].items():
            err = float((got[kind][k] - t).abs().max())
            assert err <= 1e-10 * float(t.abs().max()), (kind, k, err)
    assert len(want["grads"]) > 200 and len(want["stats"]) > 50


def two_ranks(tmp_path):
    """Both ranks' steps without and with remat, in two spawned gloo
    processes on 4 of the 8 rows each."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=ranks.rank_step, args=(r, 2, str(tmp_path / "store"),
                                                       str(tmp_path), BATCH, (False, True)))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        p.kill()
    assert not hung, f"ranks {hung} did not finish in 180 s"
    assert [p.exitcode for p in procs] == [0, 0]
    return [(torch.load(tmp_path / f"rank{r}_remat.pt"), torch.load(tmp_path / f"rank{r}.pt"))
            for r in range(2)]


@pytest.mark.parametrize("case", ["flagship", "flowloss", "two_ranks"])
def test_remat_steps_as_without(case, tmp_path, monkeypatch):
    if case == "two_ranks":
        for got, want in two_ranks(tmp_path):
            assert_same_step(got, want)
        return
    model_c, train_c, helper, x, v, info = ranks.flagship_batch(BATCH)
    assert train_c.fc_dropout > 0 and train_c.reg_fc_dropout > 0
    if case == "flowloss":
        model_c = dataclasses.replace(model_c, forward_controls_loss=False)
        train_c = dataclasses.replace(train_c, flow_loss_bn_mode="train")
    calls = {"bn": 0}
    for cls in (layers.BatchNorm, flows.BatchNormFlow):
        forward = cls.forward

        def counted(self, *a, _forward=forward, **k):
            calls["bn"] += 1
            return _forward(self, *a, **k)

        monkeypatch.setattr(cls, "forward", counted)
    steps, n_calls = {}, {}
    for remat in (False, True):
        calls["bn"] = 0
        steps[remat] = ranks.one_step(model_c, dataclasses.replace(train_c, remat=remat), helper,
                                      x, v, info)
        n_calls[remat] = calls["bn"]
    assert_same_step(steps[True], steps[False])
    # the flagship's BatchNorms run in the forward only, FlowParamsLoss's
    # also in the pullback, which is not recomputed
    assert n_calls[False] > 0 and n_calls[True] > n_calls[False]
    if case == "flagship":
        assert n_calls[True] == 2 * n_calls[False]
