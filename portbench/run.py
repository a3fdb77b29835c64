"""The benchmark of the PyTorch and CUDA port, one run of one cell:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port. The cell's traffic kind (``kinds/<kind>.py``) builds its
inputs and weights from the seed, warms up, measures for about
``--seconds`` seconds, then checks what the timed path produced against the
plain reference (``portbench/reference``). The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device`` and, traced, ``breakdown``; ``checks``, each
compared number with its limit, comes last. The same numbers end standard
error.

The run exits with a code other than 0 and prints no result where the card
or the cards the cell asks for are missing, where the checkout lacks the
port, or where ``jax``, ``jaxlib``, ``flax`` or the JAX package
``preset_gen_vae_tpu`` is loaded when the window has closed."""

from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "preset_gen_vae_tpu")


def process_start() -> float:
    """The perf_counter time at which this process started (from
    ``/proc/self/stat``), or this module's import where that is unreadable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return min(time.perf_counter() - max(age, 0.0), T_IMPORT)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of ``FORBIDDEN`` (a whole name: ``preset_gen_vae_tpu_torch``
    is not ``preset_gen_vae_tpu``)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def cache_env(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout.
    The port builds its CUDA libraries into ``build/`` itself."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")


def runs_root(root: pathlib.Path, cell: str) -> pathlib.Path:
    """Where the cell's run directories go: under ``$TMPDIR``, else under the
    checkout's ``build/``."""
    base = os.environ.get("TMPDIR")
    return (pathlib.Path(base) if base else root / "build") / "portbench_runs" / cell


def parse(argv=None):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell of the port")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_check(chips: int):
    """The card's name, or None (and a message) where the cell's cards are
    missing."""
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return None
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return None
    return torch.cuda.get_device_name(0)


def result_line(outcome, cell, trace: bool, device: dict) -> dict:
    from . import registry

    if trace:
        values = registry.read_per_layer(cell.per_layer, outcome.ctx)
        units = {m["name"]: m["unit"] for m in cell.per_layer}
    else:
        values = {m["name"]: outcome.end_to_end[m["name"]] for m in cell.end_to_end
                  if m["name"] in outcome.end_to_end}
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
    line = {"correct": outcome.correct, "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
            "device": device}
    if trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {name: {"value": _finite(v), "limit": lim}
                      for name, v, lim in outcome.checks}
    return line


def _finite(v: float):
    """``v``, or None where it is NaN or infinite (strict JSON has neither);
    such a reading has already failed its check."""
    return v if math.isfinite(v) else None


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    root = pathlib.Path.cwd()
    cache_env(root)
    try:
        from . import registry

        cell = registry.find_cell(root, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    kind = card_check(cell.chips)
    if kind is None:
        return 3
    try:
        import preset_gen_vae_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the checkout holds no port ({e})", file=sys.stderr)
        return 4
    import torch

    runner = registry.kind_module(cell.traffic["kind"])
    outcome = runner.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                         t_start=t_start, runs_root=runs_root(root, cell.name))
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of {found} are loaded in the process that measured",
              file=sys.stderr)
        return 5
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(outcome.peak_bytes)}
    if args.trace:
        device.update(busy_s=outcome.busy_s, window_s=outcome.window_s)
    line = result_line(outcome, cell, bool(args.trace), device)
    for name, value, limit in outcome.checks:
        print(f"check {name}: {value!r} limit {limit!r} {'ok' if value <= limit else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
