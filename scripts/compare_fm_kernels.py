"""Times the FM render kernels of this checkout against those of another
checkout (the parent commit) on one GPU, in turns parent, change, change,
parent, on the same inputs: F1 (``fm_control``) at (B, 2,768 ticks) and
F2 (``fm_exact``) on F1's outputs at (B, 88,576 samples), B = 1,024, 8,192
and 20,480 structured2 presets (seed 0, note 60, velocity 85), and
whether the two checkouts' outputs are equal bit for bit; and this
checkout's F2 with its tape on (``FmExact``, the forward under a
gradient) against F2 without it, bit for bit, and timed.

Make the other checkout in a directory that .gitignore lists, e.g.

    git archive <commit> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 scripts/compare_fm_kernels.py --parent build/parent

Prints the card's name and power limit, then one JSON line per B (ms per
call, CUDA events, 3 calls after a warm-up).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from preset_gen_vae_tpu_torch.synth import database as db  # noqa: E402
from preset_gen_vae_tpu_torch.synth import fm_torch as ft  # noqa: E402


def load_other(root: pathlib.Path):
    """The other checkout's ``synth/fm_torch.py`` as a module of this
    package (so that it builds with this checkout's ``_native``), reading
    its own ``csrc/fm_render.cu``."""
    pkg = root / "preset_gen_vae_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "preset_gen_vae_tpu_torch.synth._fm_other", pkg / "synth" / "fm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.FM_SOURCE = (pkg / "csrc" / "fm_render.cu").resolve()
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_fm_kernels: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    other = load_other(args.parent)
    sr, n_ticks, note_off = 22050, cs.SAMPLES // ft.BLOCK, 3 * 22050
    for B in (1024, 8192, 20480):
        pr, _, _ = db.generate_structured_corpus_v2(B, seed=0)
        p = torch.from_numpy(pr).cuda()
        _, f2_args, ctl = cs.fm_inputs(p, np.full(B, 60), np.full(B, 85), sr, n_ticks, note_off)
        row, outs = {}, {}
        for turn, (name, mod) in enumerate((("parent", other), ("change", ft), ("change", ft),
                                            ("parent", other))):
            f1 = cs.cuda_ms(lambda c: mod.fm_control(c, n_ticks, note_off, sr), [ctl], reps=3)
            f2 = cs.cuda_ms(lambda a: mod.fm_exact(*a), [f2_args], reps=3)
            row[f"{name} {turn}"] = {"F1": f1, "F2": f2}
            outs[name] = [t.clone() for t in mod.fm_control(ctl, n_ticks, note_off, sr)] + [
                mod.fm_exact(*f2_args).clone()]
        row["bit-equal"] = [bool(torch.equal(a, b)) for a, b in zip(outs["parent"],
                                                                      outs["change"])]
        row["F2 taped"] = cs.cuda_ms(lambda a: ft.FmExact.apply(*a), [f2_args], reps=3)
        row["F2 taped bit-equal"] = bool(torch.equal(ft.FmExact.apply(*f2_args),
                                                     outs["change"][-1]))
        print(json.dumps({"B": B, **row}), flush=True)
        del p, f2_args, ctl, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
