"""K-step dispatch in the port's loop (``training/dispatch.py``) against the
JAX loop's K-step scan, and the graph-safety repairs of the step.

- Grouping: ``dispatch_k`` and ``dispatch_sizes`` against a replica of the
  JAX loop's lines (``preset_gen_vae_tpu/training/loop.py:225-233`` for K,
  ``:597-622`` for the groups and the remainder), for 1-40 batches and K
  in {1, 2, 4, 16, -1}.
- Runs: the flagship at full width on the loop tests' shared 64-preset
  corpus (operators 1-2) at batch 12: 3 steps an epoch (40 train items),
  so that K=2 takes a group and a remainder step and K=-1 one group of 3,
  and one padded validation batch. On the CPU the groups and the
  remainder's one-step graph run their steps eagerly through the static
  buffers that the card's graphs use. 2 epochs at K=2 and at K=-1 against
  K=1, and 2 epochs at K=2 resumed for a third against 3 epochs at K=2:
  every /Valid scalar, every parameter and buffer, Adam's state and the
  generator's state bit-equal. The remainder path: one group and a
  remainder (K=2; its one-step graph built), no remainder (K=-1; none
  built), and K=2 with every epoch a plot epoch (TensorBoard on), whose
  train latents keep the order in which the steps ran.
- The repaired helpers against the JAX functions on seeded inputs:
  ``segment_softmax_scatter`` and ``preset_activation`` (tables on the
  module, no boolean-mask gather), the two ``-inf`` sites
  (``_masked_argmax`` under QLoss and accuracy, the categorical softmax
  of ``SynthParamsLoss``); and ``load_optimizer_state`` restoring either
  Adam form into either.
- On the card (marked ``cuda``, skipped here): K steps replayed from a
  CUDA graph against K eager steps, a group followed by replays of the
  remainder's one-step graph (captured after the group's graph or before
  it) against eager steps, a step under
  ``torch.cuda.set_sync_debug_mode('error')``, and a capture during which
  the garbage collector would destroy an earlier run's graph.

The JAX package is imported by the tests that call it, so that the card's
machine, which has no flax, collects the module and runs its card tests
(``python -m pytest tests/test_torch_port_dispatch.py -m cuda``).
"""

import gc

import numpy as np
import pytest
import torch

from preset_gen_vae_tpu_torch import config as cfg
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec
from preset_gen_vae_tpu_torch.data.pipeline import SplitLoader
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper
from preset_gen_vae_tpu_torch.logs.logger import load_checkpoint
from preset_gen_vae_tpu_torch.logs.metrics import LatentMetric
from preset_gen_vae_tpu_torch.losses import synth_params as sp
from preset_gen_vae_tpu_torch.models import regression as reg
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model
from preset_gen_vae_tpu_torch.training import loop
from preset_gen_vae_tpu_torch.training import train_step as ts
from preset_gen_vae_tpu_torch.training.dispatch import TrainGroups, dispatch_k, dispatch_sizes
import _torch_port_ranks as ranks
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)
from _torch_port_fixtures import two_torch_threads  # noqa: F401 (autouse)

BATCH = 12  # 3 train steps an epoch on the 40 train items


def jax_dispatches(n_batches: int, steps_per_dispatch: int):
    """The JAX loop's dispatches over an epoch, by their number of steps
    (loop.py:225-233 and 588-622 there)."""
    K = int(steps_per_dispatch)
    if K == -1:
        K = n_batches
    K = max(1, min(K, max(1, n_batches)))
    if K == 1:
        return K, [1] * n_batches
    out, buf = [], []
    for batch in range(n_batches):
        buf.append(batch)
        if len(buf) == K:
            out.append(K)
            buf = []
    return K, out + [1 for _ in buf]


@pytest.mark.parametrize("steps_per_dispatch", [1, 2, 4, 16, -1])
def test_grouping_matches_the_jax_loop(steps_per_dispatch):
    for n in range(1, 41):
        k = dispatch_k(steps_per_dispatch, n)
        assert (k, dispatch_sizes(n, k)) == jax_dispatches(n, steps_per_dispatch), n
        assert sum(dispatch_sizes(n, k)) == n


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The runs of the module, on one dataset: K=1, 2 and -1 for 2 epochs;
    K=2 for 3 epochs; the K=2 2-epoch run resumed for a third; K=2 for 2
    plot epochs. ``records`` holds each run's K of every ``TrainGroups``
    built (``built``), the latents of its train steps in the order they ran
    (``stepped``) and the train latents that ``LatCorr/Train`` received,
    an epoch an entry (``logged``)."""
    tmp = tmp_path_factory.mktemp("runs")
    dataset = DexedDataset(n_synthetic_presets=64, operators=(1, 2), device="cpu")
    records = {}

    def run(name, k, use_tensorboard=False, **kw):
        built, stepped, logged, made = [], [], [], []

        class Groups(TrainGroups):
            def __init__(self, k, *args, **kwargs):
                built.append(k)
                super().__init__(k, *args, **kwargs)

        class Latents(LatentMetric):
            def __init__(self, *args, **kwargs):
                made.append(self)
                super().__init__(*args, **kwargs)

            def append(self, z0_mu, z0):
                if self is made[0]:  # LatCorr/Train, made first
                    logged.append((z0_mu.copy(), z0.copy()))
                super().append(z0_mu, z0)

        def recording_step(*args, **kwargs):
            m = ts.train_step(*args, **kwargs)
            if kwargs.get("latents"):
                stepped.append((m["z0_mu"].float().numpy().copy(), m["z0"].float().numpy().copy()))
            return m

        model_c = cfg.ModelConfig(dataset_synth_args=(None, (1, 2)), logs_root_dir=str(tmp),
                                  run_name=name)
        train_c = cfg.TrainConfig(**{"minibatch_size": BATCH, "save_period": 1, "verbosity": 0,
                                     "n_epochs": 2, "steps_per_dispatch": k, **kw})
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(loop, "TrainGroups", Groups)
            mp.setattr(loop, "LatentMetric", Latents)
            mp.setattr(loop, "train_step", recording_step)
            summary = loop.train_config(model_c, train_c, dataset=dataset, device="cpu",
                                        use_tensorboard=use_tensorboard)
        records[name] = dict(built=built, stepped=stepped, logged=logged)
        return model_c, summary

    out = {k: run(f"k{k}", k) for k in (1, 2, -1)}
    out["full"] = run("full", 2, n_epochs=3)
    out["resumed"] = run("k2", 2, start_epoch=2, n_epochs=3)
    out["plot"] = run("plot", 2, use_tensorboard=True, plot_period=1)
    out["records"] = records
    return out


def assert_same_run(got, want, epoch: int):
    """/Valid scalars, then checkpoint ``epoch``'s model, Adam state, step
    and generator state, all bit-equal."""
    (got_c, got_s), (want_c, want_s) = got, want
    valid = [k for k in want_s if k.endswith("/Valid")]
    assert len(valid) == 9
    assert {k: got_s[k] for k in valid} == {k: want_s[k] for k in valid}
    a, b = load_checkpoint(got_c, epoch)["state"], load_checkpoint(want_c, epoch)["state"]
    assert a["step"] == b["step"] and torch.equal(a["generator"], b["generator"])
    assert a["model"].keys() == b["model"].keys()
    for k, t in b["model"].items():
        assert torch.equal(a["model"][k], t), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sb) > 100
    for i, st in sb.items():
        for k, t in st.items():
            assert torch.equal(sa[i][k], t), (i, k)


@pytest.mark.parametrize("k", [2, -1])
def test_k_steps_a_dispatch_train_as_one_at_a_time(runs, k):
    assert_same_run(runs[k], runs[1], 1)
    s, one = runs[k][1], runs[1][1]
    assert (s["steps_per_dispatch"], one["steps_per_dispatch"]) == ({2: 2, -1: 3}[k], 1)
    assert s["train_steps"] == one["train_steps"] == 6
    # the CPU captures no graph
    assert s["train_graph_captures"] == s["eval_graph_captures"] == s["train_graph_replays"] == 0
    assert s["remainder_graph_captures"] == s["remainder_graph_replays"] == 0


@pytest.mark.parametrize("case, run, built", [("one_group_and_a_remainder", "k2", [2, 1]),
                                               ("no_remainder", "k-1", [3]),
                                               ("plot_epochs", "plot", [2, 1])])
def test_the_steps_left_over_train_as_one_at_a_time(runs, case, run, built):
    """The epoch's 3 steps at K=2 are a group and one step left over, which
    a one-step ``TrainGroups`` takes (its graph on the card); K=-1 leaves
    none and builds no second one. Each run bit-equal to K=1; on the plot
    epochs the train latents are the steps' own, in the order they ran."""
    key = {"k2": 2, "k-1": -1, "plot": "plot"}[run]
    assert_same_run(runs[key], runs[1], 1)
    record = runs["records"][run]
    assert record["built"] == built and runs["records"]["k1"]["built"] == []
    s = runs[key][1]
    assert s["remainder_graph_captures"] == s["remainder_graph_replays"] == 0  # the CPU's
    logged, stepped = record["logged"], record["stepped"]
    if case != "plot_epochs":
        assert logged == []
        return
    assert len(logged) == 2 and len(stepped) == 6  # 2 epochs of 3 steps
    for epoch, (z0_mu, z0) in enumerate(logged):
        steps = stepped[3 * epoch:3 * epoch + 3]
        assert np.array_equal(z0_mu, np.concatenate([m for m, _ in steps]))
        assert np.array_equal(z0, np.concatenate([z for _, z in steps]))


def test_resume_at_k2_is_exact(runs):
    assert runs["resumed"][1]["start_step"] == 6 and runs["resumed"][1]["epochs_trained"] == 3
    assert_same_run(runs["resumed"], runs["full"], 2)


@pytest.fixture(scope="module")
def helpers():
    from preset_gen_vae_tpu.data.dexed_spec import build_dexed_preset_spec as jax_spec
    from preset_gen_vae_tpu.data.preset import PresetIndexesHelper as JaxHelper

    return PresetIndexesHelper(build_dexed_preset_spec()), JaxHelper(jax_spec())


def seeded_rows(helper, seed, n=24):
    rng = np.random.default_rng(seed)
    v_in = helper.full_to_learnable_batch(rng.random((n, helper.full_preset_size))
                                          .astype(np.float32))
    return v_in, (rng.standard_normal(v_in.shape) * 2.0).astype(np.float32)


@pytest.mark.parametrize("cat_softmax", [True, False])
def test_preset_activation_matches_jax(helpers, cat_softmax):
    import jax.numpy as jnp

    from preset_gen_vae_tpu.models import regression as jreg

    helper, jhelper = helpers
    _, x = seeded_rows(helper, 5)
    tables = reg.ActivationTables(helper)
    assert not tables.state_dict()  # non-persistent: no checkpoint or weight map holds them
    got = reg.preset_activation(torch.from_numpy(x), tables, cat_softmax).numpy()
    want = np.asarray(jreg.preset_activation(jnp.asarray(x), jhelper, cat_softmax))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for t in (0.1, 1.0):
        got = reg.segment_softmax_scatter(torch.from_numpy(x), tables, t).numpy()
        want = np.asarray(jreg.segment_softmax_scatter(
            jnp.asarray(x), jhelper.cat_group_idx_matrix, jhelper.cat_group_mask, t))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_inf_sites_match_jax(helpers):
    """``_masked_argmax`` (QLoss and accuracy) and the categorical softmax of
    ``SynthParamsLoss`` with a Python -inf in place of a fresh tensor."""
    import jax.numpy as jnp

    from preset_gen_vae_tpu.losses import synth_params as jsp

    helper, jhelper = helpers
    v_in, logits = seeded_rows(helper, 9)
    v_out = 1.0 / (1.0 + np.exp(-logits))
    t_in, t_out, j_in, j_out = (torch.from_numpy(v_in), torch.from_numpy(v_out),
                                jnp.asarray(v_in), jnp.asarray(v_out))
    for port, jax_crit in ((sp.QuantizedNumericalParamsLoss(helper),
                            jsp.QuantizedNumericalParamsLoss(jhelper)),
                           (sp.CategoricalParamsAccuracy(helper),
                            jsp.CategoricalParamsAccuracy(jhelper))):
        np.testing.assert_allclose(port.per_item(t_out, t_in).numpy(),
                                   np.asarray(jax_crit.per_item(j_out, j_in)), rtol=0, atol=1e-6)
    kw = dict(normalize_losses=True, cat_bce=False, cat_softmax=True, cat_softmax_t=0.1)
    got = float(sp.SynthParamsLoss(helper, **kw)(t_out, t_in))
    assert got == pytest.approx(float(jsp.SynthParamsLoss(jhelper, **kw)(j_out, j_in)), rel=1e-5)


@pytest.mark.parametrize("saved_capturable", [False, True])
def test_optimizer_state_restores_into_either_form(saved_capturable):
    """A plain Adam's state dict (the checkpoints before capturable Adam)
    and a capturable one's, each restored into both forms: the receiving
    optimizer keeps its learning rate's form (the same device tensor,
    filled in place), its ``capturable`` flag and its step counts' form."""
    def adam(capturable):
        p = torch.nn.Parameter(torch.ones(3))
        lr = torch.tensor(1e-3) if capturable else 1e-3
        return torch.optim.Adam([p], lr=lr, capturable=capturable)

    saved = adam(saved_capturable)
    saved.param_groups[0]["params"][0].grad = torch.ones(3)
    if not saved_capturable:
        saved.step()
    else:  # a capturable Adam steps only on the card: its state as the card leaves it
        saved.state[saved.param_groups[0]["params"][0]] = {
            "step": torch.tensor(1.0), "exp_avg": torch.full((3,), 0.1),
            "exp_avg_sq": torch.full((3,), 1e-3)}
    ts.set_learning_rate(saved, 5e-4)
    state = saved.state_dict()
    for capturable in (False, True):
        opt = adam(capturable)
        lr = opt.param_groups[0]["lr"]
        ts.load_optimizer_state(opt, state)
        group = opt.param_groups[0]
        assert group["capturable"] is capturable
        assert float(group["lr"]) == pytest.approx(5e-4, rel=1e-7)
        assert (group["lr"] is lr) if capturable else isinstance(group["lr"], float)
        step = opt.state[group["params"][0]]["step"]
        assert step.dtype == torch.float32 and float(step) == 1.0


def flagship_on_card():
    """The flagship (float32) and a loader over 64 seeded rows on the card;
    -> (model, optimizer, generator, step function, index rows)."""
    model_c, train_c, helper, x, v, info = ranks.flagship_batch(64)
    model = build_extended_ae_model(model_c, train_c, helper, seed=0).cuda()
    optimizer = ts.make_optimizer(model, train_c)
    criteria = ts.Criteria(model_c, train_c, helper)
    tensors = {"x": torch.from_numpy(x).cuda(), "v": torch.from_numpy(v).cuda(),
               "info": torch.from_numpy(info).cuda()}
    loader = SplitLoader(tensors, np.arange(64), 16, shuffle=False, drop_last=True)
    generator = torch.Generator(device="cuda").manual_seed(11)
    beta = torch.full((), 0.2, device="cuda")

    def step(sel, latents=True):
        xb, vb, ib = loader.gather(sel)
        return ts.train_step(model, optimizer, criteria, train_c, xb, vb, ib, beta, generator,
                             latents=latents)

    idx = torch.from_numpy(np.stack(list(loader.epoch_index_batches()))).cuda()
    return model, optimizer, generator, step, idx


def scalar_row(metrics, keys):
    return torch.stack([metrics[k] for k in keys])


@pytest.mark.cuda
def test_graph_replay_of_k_steps_matches_eager_steps_on_card(monkeypatch):
    """4 eager steps against a K=2 group run as its warm-up (2 eager steps)
    and then one capture and replay (2 steps), in float32 with TF32 off and
    cuDNN's deterministic algorithms (its default float32 algorithms are
    not): the scalar rows, every parameter and buffer and the generator's
    state bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    keys = ts.SCALARS + ("TotalLoss",)
    model_a, _, gen_a, step_a, idx = flagship_on_card()
    rows_a = torch.stack([scalar_row(step_a(idx[j]), keys) for j in range(4)])
    model_b, _, gen_b, step_b, _ = flagship_on_card()
    groups = TrainGroups(2, 16, step_b, keys, torch.device("cuda"), "the test's group", gen_b)
    with groups.call.warm_up():
        rows_b = [scalar_row(step_b(idx[j]), keys) for j in range(2)]
    rows_b = torch.cat([torch.stack(rows_b), groups.run(idx[2:4])[0].clone()])
    torch.cuda.synchronize()
    assert groups.call.captures == groups.call.replays == 1
    assert torch.equal(rows_a, rows_b)
    for (k, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


@pytest.mark.cuda
@pytest.mark.parametrize("remainder_first", [False, True], ids=["group_first", "remainder_first"])
def test_one_step_graph_replays_match_eager_steps_on_card(monkeypatch, remainder_first):
    """7 eager steps against a K=2 group's warm-up (2 eager steps) and its
    graph (2 steps), with 3 replays of a one-step graph that shares the
    group's call: captured on the group's stream with no warm-up of its
    own, after the group's graph and into its pool, or (one group an
    epoch) before it, in a pool of its own. float32 with TF32 off and
    cuDNN's deterministic algorithms: the scalar rows, every parameter and
    buffer, Adam's state and the generator's state bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    keys, dev = ts.SCALARS + ("TotalLoss",), torch.device("cuda")
    model_a, opt_a, gen_a, step_a, idx = flagship_on_card()
    idx = torch.cat([idx, idx])[:7]
    rows_a = torch.stack([scalar_row(step_a(idx[j]), keys) for j in range(7)])
    model_b, opt_b, gen_b, step_b, _ = flagship_on_card()
    groups = TrainGroups(2, 16, step_b, keys, dev, "the test's group", gen_b)
    rest = TrainGroups(1, 16, step_b, keys, dev, "the test's step", gen_b, shares=groups.call)
    assert rest.call.stream is groups.call.stream
    with groups.call.warm_up():
        rows_b = [torch.stack([scalar_row(step_b(idx[j]), keys) for j in range(2)])]
    j = 2
    for graphs in ([rest, groups, rest, rest] if remainder_first else [groups, rest, rest, rest]):
        rows_b.append(graphs.run(idx[j:j + graphs.k])[0].clone())
        j += graphs.k
    torch.cuda.synchronize()
    assert (groups.call.captures, groups.call.replays) == (1, 1)
    assert (rest.call.captures, rest.call.replays) == (1, 3)
    assert torch.equal(rows_a, torch.cat(rows_b))
    for (k, a), b in zip(model_a.state_dict().items(), model_b.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = opt_a.state_dict()["state"], opt_b.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) > 100
    for i, st in sa.items():
        for k, t in st.items():
            assert torch.equal(sb[i][k], t), (i, k)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


@pytest.mark.cuda
def test_a_step_makes_the_host_wait_nowhere_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync check reads the card's stream")
    _, _, _, step, idx = flagship_on_card()
    step(idx[0])  # the first step builds the device tables
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(idx[1])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_an_earlier_runs_graph_collected_during_a_capture_on_card():
    """Two runs in one process, each capturing a K=2 group: the first run's
    graph is left in a reference cycle (a group and its graphed call refer
    to each other), and while the second captures, the garbage collector
    runs at every allocation. Destroying a graph during a capture would
    invalidate it; the capture collects before it starts and not during."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    keys = ts.SCALARS + ("TotalLoss",)
    threshold = gc.get_threshold()
    for n in range(2):
        model, _, gen, step, idx = flagship_on_card()
        groups = TrainGroups(2, 16, step, keys, torch.device("cuda"), f"run {n}", gen)
        with groups.call.warm_up():
            for j in range(2):
                step(idx[j])
        if n == 1:
            gc.set_threshold(1, 1, 1)
        try:
            rows = groups.run(idx[2:4])[0].clone()
        finally:
            gc.set_threshold(*threshold)
        torch.cuda.synchronize()
        assert groups.call.captures == 1 and torch.isfinite(rows).all()
        del model, gen, step, groups, rows
