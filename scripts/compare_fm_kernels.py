"""Times the FM render kernels of this checkout against those of another
checkout (the parent commit) on one GPU, in turns parent, change, change,
parent, on the same inputs: F1 (``fm_control``) at (B, 2,768 ticks) and
F2 (``fm_exact``) on F1's outputs at (B, 88,576 samples), B = 1,024, 8,192
and 20,480 structured2 presets (seed 0, note 60, velocity 85), and
whether the two checkouts' outputs are equal bit for bit; and this
checkout's F2 with its tape on (``FmExact``, the forward under a
gradient) against F2 without it, bit for bit, and timed. Then the two
backwards, F1b (``fm_control_bwd``) and F2b (``fm_exact_bwd``), on seeded
cotangents at B = 1,024 and at the sound-match demo's shape (one item,
1,040 ticks), in the same turns: their times, and the largest difference
of each gradient field over its largest entry in the other checkout's
(F2b's on the items at feedback <= 6), the change's backward kernels by
CUDA events; and this checkout's F1 with its tape against F1 without it,
bit for bit, and timed.

Make the other checkout in a directory that .gitignore lists, e.g.

    git archive <commit> | (mkdir -p build/parent && tar -x -C build/parent)
    python3 scripts/compare_fm_kernels.py --parent build/parent

Prints the card's name and power limit, then one JSON line per B and one
per backward shape (ms per call, CUDA events, 3 calls after a warm-up;
10 at the demo's shape). ``--backward-only`` skips the forwards' lines.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
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


def control_bwd(mod, ctl, n_ticks, note_off, sr, gs):
    """A checkout's F1b on ``ctl``: over F1's tape where its F1b reads one,
    else as its wrapper takes it (it walks F1's state itself)."""
    if "tape" in inspect.signature(mod.fm_control_bwd).parameters:
        tape = mod._fm_control_launch(ctl, n_ticks, note_off, sr, taped=True)[-1]
        return lambda c: mod.fm_control_bwd(c, tape, n_ticks, note_off, sr, *gs)
    return lambda c: mod.fm_control_bwd(c, n_ticks, note_off, sr, *gs)


def field_errors(got, want, fields) -> dict:
    """{field: max |got - want| over want's largest entry} for the named
    slices of two tuples or rows."""
    out = {}
    for name, g, w in zip(fields, got, want):
        scale = float(w.abs().max())
        out[name] = float((g - w).abs().max()) / (scale if scale > 0 else 1.0)
    return out


def compare_backwards(other, B: int, n_ticks: int, note_off: int, sr: int, seed: int) -> dict:
    """F1b and F2b of both checkouts at (B, n_ticks) in turns, and the
    difference of their gradients."""
    if B == 1:
        from preset_gen_vae_tpu_torch.scripts import sound_match_demo as demo

        p = demo.problem(torch.device("cuda"))[0]
        pitch, vel = [demo.PITCH], [demo.VELOCITY]
    else:
        p = torch.from_numpy(db.generate_structured_corpus_v2(B, seed=0)[0]).cuda()
        pitch, vel = np.full(B, 60), np.full(B, 85)
    _, f2_args, ctl = cs.fm_inputs(p, pitch, vel, sr, n_ticks, note_off)
    rng = np.random.default_rng(seed)
    gs = cs.cotangents(rng, B, n_ticks)
    g_out = torch.from_numpy(rng.standard_normal((B, n_ticks * ft.BLOCK)).astype(np.float32)).cuda()
    _, tape = ft._fm_exact_launch(*f2_args, taped=True)
    reps = 10 if B == 1 else 3
    row, outs = {"B": B, "ticks": n_ticks}, {}
    for turn, (name, mod) in enumerate((("parent", other), ("change", ft), ("change", ft),
                                        ("parent", other))):
        f1b = control_bwd(mod, ctl, n_ticks, note_off, sr, gs)
        row[f"{name} {turn}"] = {
            "F1b": cs.cuda_ms(f1b, [ctl], reps=reps),
            "F2b": cs.cuda_ms(lambda a: mod.fm_exact_bwd(tape, *a, g_out), [f2_args], reps=reps)}
        outs[name] = (f1b(ctl).clone(), [t.clone() for t in mod.fm_exact_bwd(tape, *f2_args,
                                                                            g_out)])
    row["F1b vs parent"] = field_errors([ft._ctl(outs["change"][0], n) for n, _ in ft.CTL_FIELDS],
                                        [ft._ctl(outs["parent"][0], n) for n, _ in ft.CTL_FIELDS],
                                        [n for n, _ in ft.CTL_FIELDS])
    low = torch.round(p[:, 5].clamp(0, 1) * 7) <= 6
    pick = lambda t: t[:, low] if t.dim() == 3 else t[low]  # noqa: E731
    row["F2b vs parent, feedback <= 6"] = field_errors(
        [pick(t) for t in outs["change"][1]], [pick(t) for t in outs["parent"][1]],
        ("amps", "starts", "incs", "fb_amt", "master_volume"))
    f1b_change = control_bwd(ft, ctl, n_ticks, note_off, sr, gs)
    row["change kernels"] = {**cs.kernel_event_ms(lambda: f1b_change(ctl)),
                             **cs.kernel_event_ms(lambda: ft.fm_exact_bwd(tape, *f2_args, g_out))}
    row["F1"] = cs.cuda_ms(lambda c: ft.fm_control(c, n_ticks, note_off, sr), [ctl], reps=reps)
    row["F1 taped"] = cs.cuda_ms(lambda c: ft._fm_control_launch(c, n_ticks, note_off, sr,
                                                                 taped=True), [ctl], reps=reps)
    plain = ft.fm_control(ctl, n_ticks, note_off, sr)
    row["F1 taped bit-equal"] = all(bool(torch.equal(a, b)) for a, b in zip(
        ft._fm_control_launch(ctl, n_ticks, note_off, sr, taped=True)[:4], plain))
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="root of the other checkout")
    ap.add_argument("--backward-only", action="store_true",
                    help="compare F1b and F2b only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("compare_fm_kernels: no CUDA device available", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    other = load_other(args.parent)
    sr, n_ticks, note_off = 22050, cs.SAMPLES // ft.BLOCK, 3 * 22050
    for B in () if args.backward_only else (1024, 8192, 20480):
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
    for B, ticks, note_off_b in ((1024, n_ticks, note_off), (1, 1040, 22050)):
        print(json.dumps(compare_backwards(other, B, ticks, note_off_b, sr, seed=B)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
