"""Device-time breakdown of the PyTorch port's train step on one GPU.

Builds the flagship FlVAE2 (257x347 inputs, dim_z 610, batch 160, bf16
autocast), or with ``--run NAME`` the configuration of the saved run
``saved/FlVAE2/NAME`` (its notes, heads, flows and losses), with random
weights and inputs from ``--seed``, warms up, then
traces five train steps and one eval step with ``torch.profiler``
and prints: the card's name and power limit, the mean step time (host
clock around synchronised steps), the device-busy share of the traced
window, the kernels ranked by device time, and the calls in one train step
that make the host wait for the card (``torch.cuda.set_sync_debug_mode``),
by source line. With ``--blocks`` it also traces five eval-mode forwards
(``eval_step`` without gradients), wraps each encoder and decoder block
(``enc*``, ``dec*``, ``mix*``, ``unmix*``) and the two CNN stacks in a
``record_function`` range, the forward by module hooks and the backward by
full backward hooks, and prints, for the train step and for the eval
forward, each range's kernels by device time: a kernel counts in the
innermost range open on the thread that launched it (a block whose module
is not called, such as a decoder's output conv run through its op, counts
in its stack's range; the encoder's first block's backward, whose input
needs no gradient, outside any). Run from the repository root:

    python3 scripts/profile_torch_step.py [--run r5stack3_v2_20480] [--blocks]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from preset_gen_vae_tpu_torch import config as cfg  # noqa: E402
from preset_gen_vae_tpu_torch.data.dexed_spec import build_dexed_preset_spec  # noqa: E402
from preset_gen_vae_tpu_torch.data.preset import PresetIndexesHelper  # noqa: E402
from preset_gen_vae_tpu_torch.models.build import build_extended_ae_model  # noqa: E402
from preset_gen_vae_tpu_torch.training import train_step as ts  # noqa: E402

BATCH, STEPS, TOP = 160, 5, 25  # flagship batch, traced steps, kernels listed
SAVED_RUNS = pathlib.Path(__file__).resolve().parents[1] / "saved" / "FlVAE2"
BLOCK = re.compile(r"(^|\.)((enc|dec|mix|unmix)\d+|single_ch_cnn)$")  # modules given a range
RANGE = "block "  # the prefix of their ranges' names


def block_ranges(model: torch.nn.Module) -> list:
    """Forward and full backward hooks that open a ``record_function`` range
    ``block fwd <name>`` / ``block bwd <name>`` when each block module starts
    and close it when it ends; returns the hooks' handles."""
    from torch.autograd.profiler import record_function

    handles, open_ranges = [], collections.defaultdict(list)

    def opener(key):
        def hook(*_):
            rf = record_function(key)
            rf.__enter__()
            open_ranges[key].append(rf)
        return hook

    def closer(key):
        def hook(*_):
            open_ranges[key].pop().__exit__(None, None, None)
        return hook

    for name, mod in model.named_modules():
        if BLOCK.search(name):
            fwd, bwd = f"{RANGE}fwd {name}", f"{RANGE}bwd {name}"
            handles += [mod.register_forward_pre_hook(opener(fwd)),
                        mod.register_forward_hook(closer(fwd)),
                        mod.register_full_backward_pre_hook(opener(bwd)),
                        mod.register_full_backward_hook(closer(bwd))]
    return handles


def kernels_by_range(prof, steps: int) -> dict:
    """{range: {"ms": device ms a step, "kernels": [[name, ms a step,
    launches a step], ...]}}: each kernel in the innermost block range
    around the CPU event that launched it ("outside" where none is)."""
    found = collections.defaultdict(lambda: collections.defaultdict(lambda: [0.0, 0]))

    def walk(evt, where):
        if evt.name.startswith(RANGE):
            where = evt.name[len(RANGE):]
        for k in evt.kernels:
            row = found[where][k.name]
            row[0] += k.duration / 1e3 / steps
            row[1] += 1
        for child in evt.cpu_children:
            walk(child, where)

    for evt in prof.events():
        if evt.cpu_parent is None:
            walk(evt, "outside")
    out = {}
    for where, rows in found.items():
        ranked = sorted(rows.items(), key=lambda kv: -kv[1][0])
        out[where] = {"ms": sum(v[0] for v in rows.values()),
                      "kernels": [[n[:90], round(ms, 4), c / steps] for n, (ms, c) in ranked[:8]]}
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["ms"]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--run", default=None, help="saved run whose configuration to profile")
    ap.add_argument("--blocks", action="store_true",
                    help="attribute the kernels of the train step and the eval forward to blocks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    helper = PresetIndexesHelper(build_dexed_preset_spec())
    L, B = helper.learnable_preset_size, BATCH
    mc, tc = (cfg.load_config(SAVED_RUNS / args.run / "config.json") if args.run
              else (cfg.ModelConfig(), cfg.TrainConfig()))
    mc, tc = cfg.resolve(mc, dataclasses.replace(tc, minibatch_size=B))
    C = mc.input_tensor_size[1]
    dim_z = L if mc.params_regression_architecture.startswith("flow_") else mc.dim_z
    mc = dataclasses.replace(mc, synth_params_count=L, learnable_params_tensor_length=L,
                             dim_z=dim_z, input_tensor_size=(B, C, 257, 347))
    print(f"{args.run or 'flagship'}: input {list(mc.input_tensor_size)}, dim_z {dim_z}, "
          f"{mc.params_regression_architecture}, latent flow {mc.latent_flow_arch}, "
          f"forward_controls_loss {mc.forward_controls_loss}")
    model = build_extended_ae_model(mc, tc, helper, seed=args.seed).to(dev)
    opt, crit = ts.make_optimizer(model, tc), ts.Criteria(mc, tc, helper)
    rng = np.random.default_rng(args.seed)
    x = torch.from_numpy(rng.uniform(-1, 1, (B, C, 257, 347)).astype(np.float32)).to(
        dev, torch.bfloat16)
    v = torch.from_numpy(helper.full_to_learnable_batch(
        rng.random((B, helper.full_preset_size)).astype(np.float32))).to(dev)
    notes = mc.midi_notes
    info = torch.tensor([[0, *notes[i % len(notes)]] for i in range(B)], dtype=torch.int32,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def step():
        return ts.train_step(model, opt, crit, tc, x, v, info, 0.2, gen)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        step()
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = collections.Counter(f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    times = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    handles = block_ranges(model) if args.blocks else []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    t0 = time.perf_counter()
    ts.eval_step(model, crit, tc, x, v, info)
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    # device rows only; '#' marks record_function ranges such as
    # "Optimizer.step#Adam.step", whose device time repeats their kernels'
    kernels = [e for e in prof.key_averages() if e.device_time_total > 0
               and e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    busy = sum(e.device_time_total for e in kernels) / 1e6  # us -> s
    kernels.sort(key=lambda e: -e.device_time_total)
    print(json.dumps({"batch": B, "step_ms": float(np.mean(times)) * 1e3,
                      "step_ms_min": float(np.min(times)) * 1e3, "eval_step_ms": eval_ms,
                      "profiled_window_s": window, "device_busy_s": busy,
                      "device_busy_share": busy / window,
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "host_syncs_per_step": sum(syncs.values()),
                      "host_syncs_by_line": dict(syncs)}))
    print(f"{'device ms/step':>14} {'share':>6} {'calls':>6}  kernel")
    for e in kernels[:TOP]:
        ms = e.device_time_total / 1e3 / STEPS
        print(f"{ms:14.3f} {e.device_time_total / 1e6 / busy:6.1%} {e.count // STEPS:6d}  "
              f"{e.key[:110]}")
    if args.blocks:
        with torch.no_grad():
            for _ in range(2):
                ts.eval_step(model, crit, tc, x, v, info)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as eval_prof:
                for _ in range(STEPS):
                    ts.eval_step(model, crit, tc, x, v, info)
                torch.cuda.synchronize()
        for handle in handles:
            handle.remove()
        for what, p in (("train_step", prof), ("eval_forward", eval_prof)):
            for where, row in kernels_by_range(p, STEPS).items():
                print(json.dumps({"blocks": what, "range": where, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
