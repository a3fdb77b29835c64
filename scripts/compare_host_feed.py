"""Times two designs of the port's host-fed input pipeline
(``TrainConfig.dataset_cache_device=False``) on one GPU, end to end.

Both gather each batch on the host into pinned memory and copy it to the
card with ``non_blocking=True``:

- ``side_stream``: two pinned staging buffers reused batch after batch,
  the copy on a side stream, ordered before the step by an event; batch
  i+1's copy starts once step i is enqueued, so that it can overlap step
  i on the device;
- ``plain``: a fresh pinned tensor a batch (PyTorch's caching host
  allocator), the copy on the current stream, after step i.

Trains the flagship FlVAE2 at full width (bf16, batch 160, K=1: the
host-fed path steps eagerly) for ``--epochs`` epochs on a seeded
``--presets`` synthetic corpus, host-fed, once per design in turns
side_stream, plain, plain, side_stream, every run from the same seed on
one corpus pass; each run's loader is given the design by replacing
``SplitLoader.device_batches``. Prints the card's name and power limit,
a line per run (the loop's steady step and epoch time, and its
parameters' largest difference from the first run's), then one JSON
line: each design's steps and epochs, averaged over its two runs. Run
from the repository root:

    python3 scripts/compare_host_feed.py [--epochs 4] [--presets 1024]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from preset_gen_vae_tpu_torch import config as cfg  # noqa: E402
from preset_gen_vae_tpu_torch.data.pipeline import SplitLoader  # noqa: E402
from preset_gen_vae_tpu_torch.training.loop import prepare_dataset, train_config  # noqa: E402


def _host_fed(loader: SplitLoader, device: torch.device) -> bool:
    return loader.tensors["x"].device.type == "cpu" and device.type == "cuda"


def side_stream_batches(self: SplitLoader, batches, device: torch.device):
    """(x, v, info) on ``device`` of each index batch: two pinned staging
    buffers, the copy on a side stream behind an event, batch i+1 staged
    once batch i has been handed out; a buffer refilled once its last copy
    is done."""
    if not _host_fed(self, device):
        for sel in batches:
            yield self.gather(sel)
        return
    stream = torch.cuda.Stream(device)
    staging = getattr(self, "_staging", None)
    if staging is None:
        staging = self._staging = [
            {k: torch.empty((self.batch_size, *t.shape[1:]), dtype=t.dtype, pin_memory=True)
             for k, t in self.tensors.items()} for _ in range(2)]
        self._copied = [None, None]
    done = self._copied

    def stage(i: int, sel):
        slot = i % 2
        if done[slot] is not None:
            done[slot].synchronize()
        sel = torch.as_tensor(sel, dtype=torch.int64)
        staged = {k: torch.index_select(t, 0, sel, out=staging[slot][k][:len(sel)])
                  for k, t in self.tensors.items()}
        with torch.cuda.stream(stream):
            out = tuple(staged[k].to(device, non_blocking=True, copy=True)
                        for k in ("x", "v", "info"))
        done[slot] = torch.cuda.Event()
        done[slot].record(stream)
        return out, done[slot]

    batches = iter(batches)
    first = next(batches, None)
    pending = None if first is None else stage(0, first)
    i = 0
    while pending is not None:
        out, event = pending
        current = torch.cuda.current_stream(device)
        current.wait_event(event)
        for t in out:  # made on the side stream, read on the current one
            t.record_stream(current)
        yield out
        i += 1
        sel = next(batches, None)
        pending = None if sel is None else stage(i, sel)


def plain_batches(self: SplitLoader, batches, device: torch.device):
    """(x, v, info) on ``device`` of each index batch: a gather into a fresh
    pinned tensor, copied on the current stream."""
    for sel in batches:
        if not _host_fed(self, device):
            yield self.gather(sel)
            continue
        sel = torch.as_tensor(sel, dtype=torch.int64)
        yield tuple(torch.index_select(self.tensors[k], 0, sel, out=torch.empty(
            (len(sel), *self.tensors[k].shape[1:]), dtype=self.tensors[k].dtype,
            pin_memory=True)).to(device, non_blocking=True) for k in ("x", "v", "info"))


DESIGNS = {"side_stream": side_stream_batches, "plain": plain_batches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--presets", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_host_feed: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    root = pathlib.Path(tempfile.mkdtemp(prefix="compare_host_feed_"))
    corpus = {"n_synthetic_presets": args.presets, "data_root": str(root / "data")}
    train_c = cfg.TrainConfig(n_epochs=args.epochs, minibatch_size=160, lr_warmup_epochs=0,
                              save_period=args.epochs, verbosity=0, steps_per_dispatch=1,
                              dataset_cache_device=False)
    _, _, dataset = prepare_dataset(cfg.ModelConfig(), train_c, dev, dataset_kwargs=corpus)
    dataset.load_corpus()  # the one corpus pass, before the runs
    results, first = {k: [] for k in DESIGNS}, None
    for i, name in enumerate(("side_stream", "plain", "plain", "side_stream")):
        model_c = cfg.ModelConfig(logs_root_dir=str(root), run_name=f"{name}_{i}")
        with mock.patch.object(SplitLoader, "device_batches", DESIGNS[name]):
            s = train_config(model_c, train_c, dataset=dataset, device=dev,
                             use_tensorboard=False)
        state = torch.load(pathlib.Path(s["run_dir"]) / "checkpoints" / str(args.epochs - 1) /
                           "state.pt", map_location="cpu", weights_only=True)["model"]
        first = first or state
        diff = max(float((state[k].double() - t.double()).abs().max()) for k, t in first.items())
        results[name].append((s["step_ms"], s["epoch_s"]))
        print(f"[{name}] run {i}: step {s['step_ms']:.3f} ms, epoch {s['epoch_s']:.4f} s, "
              f"{s['train_steps']} steps, parameters' largest difference from run 0 {diff:g}",
              flush=True)
    print(json.dumps({name: {"step_ms": float(np.mean([r[0] for r in runs])),
                             "epoch_s": float(np.mean([r[1] for r in runs])),
                             "step_ms_runs": [r[0] for r in runs]}
                      for name, runs in results.items()}), flush=True)
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
