"""The gradient through the port's FM render and the port's sound-match
demo (``preset_gen_vae_tpu_torch/scripts/sound_match_demo.py``) against
the JAX package's (``synth/fm_jax.py``, ``scripts/sound_match_demo.py``,
imported by file path), on the CPU at short renders: the control pass's
VJP (``control_pass_vjp``, F1b's plain version) from presets to the
amplitudes, per-sample phases and increments against ``jax.vjp`` on the
same numpy cotangents, the demo's loss and gradient, its first Adam
steps against optax's, its ``main`` on the CPU, and ``render_batch``'s
gradient contract; and F1b's algorithm written out in torch against
autograd. F1b itself (``csrc/fm_render.cu``) runs only on the card
(marked ``cuda``).

Measured on the CPU (torch 2.13, jax 0.9 on the CPU), against the bars
below: the control pass's VJP 2.6e-7 of its largest entry; the spectra
7.2e-7; the demo's loss 1.5e-7 relative on a rendered note (equal at the
corrupted preset), its gradient by the waveform 3.9e-5 and by the preset
8.1e-6 of the largest entry; 5 Adam steps' losses 4.1e-7 relative,
learning rates 2.2e-8 relative.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from preset_gen_vae_tpu.synth import fm_jax
from preset_gen_vae_tpu.synth.database import generate_structured_corpus
from preset_gen_vae_tpu_torch.scripts import sound_match_demo as demo
from preset_gen_vae_tpu_torch.synth import fm_torch as ft
from test_torch_port_fm import loop_length_presets, mixed_presets, notes

ROOT = pathlib.Path(__file__).resolve().parents[1]
SR = 22050
N_SHORT = 4096
NOTE_ON, TOTAL = 0.1, N_SHORT / SR  # note-off inside the render: all four EG stages
# the demo at a short note: 2,560 samples, 6 coarse and 36 fine frames
DEMO_NOTE_ON, DEMO_TOTAL = 0.05, 0.1


def jax_demo():
    """The JAX package's ``scripts/sound_match_demo.py`` as a module."""
    spec = importlib.util.spec_from_file_location("jax_sound_match_demo",
                                                  ROOT / "scripts" / "sound_match_demo.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def short_demo(monkeypatch):
    monkeypatch.setattr(demo, "NOTE_ON", DEMO_NOTE_ON)
    monkeypatch.setattr(demo, "TOTAL", DEMO_TOTAL)
    return demo


def test_control_pass_vjp_matches_jax():
    """From 22 seeded presets (all four EG stages, every LFO wave, loops of
    1-3 operators) through the decode (straight-through estimators
    included), the control pass and the per-sample phases, the gradient
    of <cotangents, (amps, phases, inc)> by the presets: the port's
    ``control_pass_vjp`` chained with autograd of the decode and of
    ``sample_phases``, against ``jax.vjp`` on the same numpy cotangents,
    within 1e-4 of the largest entry (f32 sums of up to 4,096 terms in
    another order, and the two frameworks' exp2 in the last bit)."""
    p = np.concatenate([mixed_presets(16), loop_length_presets()])
    pitch, vel = notes(len(p))
    B, T = len(p), N_SHORT // ft.BLOCK
    rng = np.random.default_rng(8)
    g_amps, g_phases, g_inc = (rng.standard_normal(s).astype(np.float32)
                               for s in ((T, B, 6), (B, 6, N_SHORT), (T, B, 6)))

    def jax_control(x):
        d = fm_jax.decode_presets(x)
        amps, pf = fm_jax._control_pass(d, jnp.asarray(pitch), jnp.asarray(vel), NOTE_ON, TOTAL,
                                        SR)
        phases, inc = fm_jax._per_sample_phases(fm_jax._op_freqs(d, jnp.asarray(pitch)), pf, SR)
        return amps, phases, inc

    _, vjp = jax.vjp(jax_control, jnp.asarray(p))
    (want,) = vjp((jnp.asarray(g_amps), jnp.asarray(g_phases), jnp.asarray(g_inc)))
    want = np.asarray(want)

    x = torch.from_numpy(p).requires_grad_(True)
    ctl = ft.control_params(ft.decode_presets(x), torch.from_numpy(pitch), torch.from_numpy(vel),
                            SR)
    note_off = int(NOTE_ON * SR)
    _, _, starts, incs = ft.control_pass(ctl.detach(), T, note_off, SR)
    starts, incs = starts.requires_grad_(True), incs.requires_grad_(True)
    g_starts, g_incs = torch.autograd.grad(ft.sample_phases(starts, incs), (starts, incs),
                                           torch.from_numpy(g_phases))
    g_ctl = ft.control_pass_vjp(ctl.detach(), T, note_off, SR, torch.from_numpy(g_amps), None,
                                g_starts, g_incs + torch.from_numpy(g_inc))
    ctl.backward(g_ctl)
    got = x.grad.numpy()
    scale = float(np.abs(want).max())
    assert g_ctl.shape == (B, ft.CTL_WIDTH) and scale > 0 and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    # the switches take no gradient; every other field of the row some
    for name, _ in ft.CTL_FIELDS:
        field = ft._ctl(g_ctl, name)
        assert bool((field == 0).all()) == (name in ("on", "lfo_wave")), name


def test_control_pass_vjp_takes_none_for_a_zero_cotangent():
    """A None cotangent reads as zeros: the same row as explicit zeros;
    all four None give a zero row."""
    p = mixed_presets(4)
    pitch, vel = notes(4)
    ctl = ft.control_params(ft.decode_presets(torch.from_numpy(p)), torch.from_numpy(pitch),
                            torch.from_numpy(vel), SR)
    T, off = 16, int(0.005 * SR)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((T, 4, 6)).astype(np.float32))
    a = ft.control_pass_vjp(ctl, T, off, SR, g, None, None, g)
    b = ft.control_pass_vjp(ctl, T, off, SR, g, torch.zeros(T, 4), torch.zeros(T, 4, 6), g)
    assert torch.equal(a, b) and float(a.abs().max()) > 0
    assert torch.equal(ft.control_pass_vjp(ctl, T, off, SR, None, None, None, None),
                       torch.zeros_like(ctl))


# ---------------------------------------------------------------------------
# F1b's algorithm (csrc/fm_render.cu: fm_control_bwd_starts,
# fm_control_bwd_chunks, fm_control_bwd_combine) written out in torch,
# vectorized over chunks, items and operators where the kernels have lanes:
# F1's tape, the chunks' sums of the phase starts' cotangents, each chunk's
# reverse walk from zero incoming adjoints re-deriving each tick from the
# tape (the lanes' sums taken where the kernel shuffles), and the combine
# ---------------------------------------------------------------------------


def _pick(v, stage):
    return torch.gather(v, -1, stage[..., None])[..., 0]


def _eg_tick_bwd(cur, stage, targets, slews, off, g, g_targets, g_slews, act):
    """eg_tick_bwd where ``act``: -> the pre-tick level's adjoint;
    accumulates into the stage's target and slew adjoints."""
    stage = torch.where(off, 3, stage)
    dlt = _pick(targets, stage) - cur
    pos = dlt > 0
    reached = dlt.abs() <= torch.where(pos, 4.0 * _pick(slews, stage) + 0.05 * dlt,
                                       _pick(slews, stage))
    g_step = g * torch.sign(dlt)
    g_dlt = torch.where(pos, g_step * 0.05, 0.0)
    one_hot = torch.nn.functional.one_hot(stage, 4).float() * act[..., None]
    g_targets += one_hot * torch.where(reached, g, g_dlt)[..., None]
    g_slews += one_hot * torch.where(reached, 0.0, torch.where(pos, g_step * 4.0, g_step))[
        ..., None]
    return torch.where(act, torch.where(reached, 0.0, g - g_dlt), g)


def _lfo_wave_bwd(wave, phase, g):
    out = torch.zeros_like(g)
    for w, v in enumerate([torch.where(phase < 0.5, g * 4.0, -(g * 4.0)), g * -2.0, g * 2.0,
                           torch.zeros_like(g), g * torch.cos(ft.TWO_PI * phase) * ft.TWO_PI]):
        out = torch.where(wave == w, v, out)
    return out


def _ramp(t_s, delay):
    return torch.where(delay > 0, torch.minimum(t_s / torch.maximum(delay, torch.tensor(1e-9)),
                                                torch.tensor(1.0)), 1.0)


def _ramp_bwd(t_s, delay, g):
    m = torch.maximum(delay, torch.tensor(1e-9))
    r = t_s / m
    g_m = -(torch.where(r < 1, g, torch.where(r == 1, 0.5 * g, 0.0)) * t_s) * ((1.0 / m) ** 2)
    g_d = torch.where(delay > 1e-9, g_m, torch.where(delay == torch.tensor(1e-9), 0.5 * g_m, 0.0))
    return torch.where(delay > 0, g_d, 0.0)


def f1_tape(c, B, T, note_off, tick_s):
    """F1's state walk under a gradient: each tick's pre-tick EG levels and
    stages (T, B, 6), pitch-EG level and stage (T, B, 1), and LFO phase and
    S&H value after its step (T, B)."""
    targets, slews = c["targets"].reshape(B, 6, 4), c["slews"].reshape(B, 6, 4)
    peg_targets, peg_slews = c["peg_targets"][:, None], c["peg_slews"][:, None]
    hz = c["lfo_hz"][:, 0]
    eg, stage = c["eg0"].clone(), torch.zeros((B, 6), dtype=torch.long)
    peg, peg_stage = c["peg0"].clone(), torch.zeros((B, 1), dtype=torch.long)
    phase, sh = c["lfo_phase0"][:, 0].clone(), torch.zeros(B)
    rng = torch.full((B,), ft.SH_SEED, dtype=torch.int64)
    tape = []
    for t in range(T):
        off = torch.tensor(t * ft.BLOCK >= note_off)
        phase = phase + hz * tick_s
        wrapped = phase >= 1.0
        phase = torch.where(wrapped, phase - torch.floor(phase), phase)
        rng = torch.where(wrapped, (rng * 1664525 + 1013904223) & 0xFFFFFFFF, rng)
        sh = torch.where(wrapped, (rng >> 8).float() / 8388608.0 - 1.0, sh)
        tape.append((eg, stage, peg, peg_stage, phase, sh))
        peg, peg_stage = ft._eg_tick(peg, peg_stage, peg_targets, peg_slews, off)
        eg, stage = ft._eg_tick(eg, stage, targets, slews, off)
    return [torch.stack(x) for x in zip(*tape)]


def f1b_in_torch(ctl, T, note_off, sr, g_amps, g_pitch_fact, g_starts, g_incs, chunks=1):
    """The gradient row, by F1b's operations in F1b's order, its ticks cut
    into ``chunks`` chunks as ``control_bwd_chunks`` cuts them (one chunk:
    the serial walk)."""
    B, fs = ctl.shape[0], float(sr)
    tick_s, c20 = float(np.float32(ft.BLOCK / fs)), ft.LN10_OVER_20
    c = {name: ft._ctl(ctl, name) for name, _ in ft.CTL_FIELDS}
    L = -(-T // chunks)
    C = -(-T // L)
    tb = torch.arange(C) * L
    te = torch.clamp(tb + L, max=T)
    x = lambda v: v.expand(C, *v.shape)  # noqa: E731  the chunks' copies
    targets, slews = x(c["targets"].reshape(B, 6, 4)), x(c["slews"].reshape(B, 6, 4))
    peg_targets, peg_slews = x(c["peg_targets"][:, None]), x(c["peg_slews"][:, None])
    delay, pmd, amd, pms = (c[k][:, 0] for k in ("lfo_delay_s", "pmd", "amd", "pms"))
    wave, on = c["lfo_wave"][:, 0].long(), c["on"] > 0
    eg_t, st_t, peg_t, pst_t, ph_t, sh_t = f1_tape(c, B, T, note_off, tick_s)
    # (1) each chunk's sum of g_starts, its last tick first; a_start entering
    # a chunk: the later chunks' sums, the last first
    sums = torch.zeros(C, B, 6)
    for j in range(L):
        t = te - 1 - j
        sums = torch.where((t >= tb)[:, None, None], sums + g_starts[t.clamp(min=0)], sums)
    a_start = torch.zeros(C, B, 6)
    for cc in range(C - 1, 0, -1):
        a_start[:cc] = a_start[:cc] + sums[cc]
    # (2) each chunk walked in reverse from zero incoming a_eg, a_peg, a_lfo:
    # its sums, the products of its multipliers (pm, pmp) and the sums'
    # sensitivities to the incoming adjoints (s_*, s_hz)
    a_eg, pm = torch.zeros(C, B, 6), torch.ones(C, B, 6)
    a_peg, pmp = torch.zeros(C, B, 1), torch.ones(C, B, 1)
    a_lfo, s_hz = torch.zeros(C, B), torch.zeros(C, B)
    g_tg, g_sl, s_tg, s_sl = (torch.zeros(C, B, 6, 4) for _ in range(4))
    g_ptg, g_psl, s_ptg, s_psl = (torch.zeros(C, B, 1, 4) for _ in range(4))
    g_gain, g_ams, g_freq, g_amd = (torch.zeros(C, B, 6) for _ in range(4))
    g_hz, g_delay, g_pmd, g_pms = (torch.zeros(C, B) for _ in range(4))
    for j in range(L):
        t = te - 1 - j
        act = (t >= tb)[:, None]  # (C, 1)
        tt = t.clamp(min=0)
        eg_pre, st, peg_pre, peg_st, phase, sh = (v[tt] for v in (eg_t, st_t, peg_t, pst_t,
                                                                  ph_t, sh_t))
        off = (tt * ft.BLOCK >= note_off)[:, None]
        t_s = torch.from_numpy(np.float32(tt.numpy() * ft.BLOCK) / np.float32(fs))[:, None]
        ramp = _ramp(t_s, delay)
        lfo_raw = ft._lfo_wave_value(wave, phase, sh)
        lfo = lfo_raw * ramp
        peg_new, _ = ft._eg_tick(peg_pre, peg_st, peg_targets, peg_slews, off[..., None])
        pf = torch.exp2((peg_new[..., 0] * 0.08 + lfo * pmd * pms) / 12.0)
        eg_new, _ = ft._eg_tick(eg_pre, st, targets, slews, off[..., None])
        am_lfo = (-0.5 * (1.0 + lfo) * amd)[..., None]
        tot = eg_new + c["op_gain_db"] + am_lfo * c["ams_db"]
        amp = torch.where(on, torch.exp(torch.clamp(tot, max=0.0) * c20), 0.0)
        amp = torch.where(amp < 1e-6, 0.0, amp)
        g0 = torch.where(amp > 0, g_amps[tt] * amp * c20, 0.0)
        g_tot = torch.where(tot < 0, g0, torch.where(tot == 0, 0.5 * g0, 0.0))
        upd = lambda new, old: torch.where(act[..., None], new, old)  # noqa: E731
        a_eg = upd(a_eg + g_tot, a_eg)
        g_gain, g_ams = upd(g_gain + g_tot, g_gain), upd(g_ams + g_tot * am_lfo, g_ams)
        g_am_lfo = g_tot * c["ams_db"]
        g_amd = upd(g_amd + g_am_lfo * (-0.5 * (1.0 + lfo))[..., None], g_amd)
        c_lfo = torch.where(act, (g_am_lfo * amd[:, None] * -0.5).sum(-1), 0.0)
        g_fp = (g_incs[tt] + a_start * 32.0) / fs
        a_start = upd(a_start + g_starts[tt], a_start)
        g_freq = upd(g_freq + g_fp * pf[..., None], g_freq)
        c_pf = torch.where(act, (g_fp * c["freqs"]).sum(-1) + g_pitch_fact[tt], 0.0)
        a_eg = _eg_tick_bwd(eg_pre, st, targets, slews, off[..., None], a_eg, g_tg, g_sl,
                            act[..., None].expand_as(a_eg))
        pm = _eg_tick_bwd(eg_pre, st, targets, slews, off[..., None], pm, s_tg, s_sl,
                          act[..., None].expand_as(pm))
        g_semis = c_pf * pf * 0.6931472 / 12.0
        a_peg = upd(a_peg + (g_semis * 0.08)[..., None], a_peg)
        g_pms = torch.where(act, g_pms + g_semis * (lfo * pmd), g_pms)
        g_lfo_pmd = g_semis * pms
        g_pmd = torch.where(act, g_pmd + g_lfo_pmd * lfo, g_pmd)
        g_lfo = c_lfo + g_lfo_pmd * pmd
        g_delay = torch.where(act, g_delay + _ramp_bwd(t_s, delay, g_lfo * lfo_raw), g_delay)
        a_lfo = torch.where(act, a_lfo + _lfo_wave_bwd(wave, phase, g_lfo * ramp), a_lfo)
        g_hz = torch.where(act, g_hz + a_lfo * tick_s, g_hz)
        s_hz = torch.where(act, s_hz + tick_s, s_hz)
        a_peg = _eg_tick_bwd(peg_pre, peg_st, peg_targets, peg_slews, off[..., None], a_peg,
                             g_ptg, g_psl, act[..., None].expand_as(a_peg))
        pmp = _eg_tick_bwd(peg_pre, peg_st, peg_targets, peg_slews, off[..., None], pmp, s_ptg,
                           s_psl, act[..., None].expand_as(pmp))
    # (3) the combine over the chunks from the last, the incoming adjoints
    # from 0
    tot = {k: torch.zeros(B, *v.shape[2:]) for k, v in (
        ("tg", g_tg), ("sl", g_sl), ("ptg", g_ptg), ("psl", g_psl), ("gain", g_gain),
        ("ams", g_ams), ("freq", g_freq), ("amd", g_amd), ("hz", g_hz), ("delay", g_delay),
        ("pmd", g_pmd), ("pms", g_pms))}
    a_e, a_p, a_l = torch.zeros(B, 6), torch.zeros(B, 1), torch.zeros(B)
    for cc in range(C - 1, -1, -1):
        tot["tg"] = tot["tg"] + (g_tg[cc] + s_tg[cc] * a_e[..., None])
        tot["sl"] = tot["sl"] + (g_sl[cc] + s_sl[cc] * a_e[..., None])
        tot["ptg"] = tot["ptg"] + (g_ptg[cc] + s_ptg[cc] * a_p[..., None])
        tot["psl"] = tot["psl"] + (g_psl[cc] + s_psl[cc] * a_p[..., None])
        for k, v in (("gain", g_gain), ("ams", g_ams), ("freq", g_freq), ("amd", g_amd),
                     ("delay", g_delay), ("pmd", g_pmd), ("pms", g_pms)):
            tot[k] = tot[k] + v[cc]
        tot["hz"] = tot["hz"] + (g_hz[cc] + s_hz[cc] * a_l)
        a_l = a_l + a_lfo[cc]
        a_e = pm[cc] * a_e + a_eg[cc]
        a_p = pmp[cc] * a_p + a_peg[cc]
    cols = {"op_gain_db": tot["gain"], "targets": tot["tg"].reshape(B, 24),
            "slews": tot["sl"].reshape(B, 24), "eg0": a_e, "peg_targets": tot["ptg"][:, 0],
            "peg_slews": tot["psl"][:, 0], "peg0": a_p, "lfo_hz": tot["hz"][:, None],
            "lfo_phase0": a_l[:, None], "lfo_delay_s": tot["delay"][:, None],
            "pmd": tot["pmd"][:, None], "amd": tot["amd"].sum(1, keepdim=True),
            "pms": tot["pms"][:, None], "ams_db": tot["ams"], "on": torch.zeros(B, 6),
            "lfo_wave": torch.zeros(B, 1), "freqs": tot["freq"]}
    return torch.cat([cols[name] for name, _ in ft.CTL_FIELDS], 1)


@pytest.mark.parametrize("chunks", [1, 7, 64])
@pytest.mark.parametrize("shape", ["short", "demo"])
def test_f1b_algorithm_in_torch_matches_control_pass_vjp(shape, chunks):
    """F1b's arithmetic, its ticks in 1 (the serial walk), 7 or 64 chunks,
    run in torch on the CPU, against autograd through the control pass on
    the same seeded cotangents: within 1e-5 of each field's largest entry
    (measured: 1.3e-7 on 38 mixed presets at 128 ticks, 2.6e-7 on the demo
    generator's 2 presets at 1,040 ticks, in one chunk), the switches
    exactly 0. The kernels run these operations; the card holds them
    against ``control_pass_vjp`` at 1e-4 (``chip_smoke.py``)."""
    if shape == "short":
        p, T, note_off = np.concatenate([mixed_presets(32), loop_length_presets()]), 128, \
            int(0.1 * SR)
    else:
        p, T, note_off = generate_structured_corpus(2, seed=33)[0], 1040, SR
    pitch, vel = notes(len(p))
    ctl = ft.control_params(ft.decode_presets(torch.from_numpy(p)), torch.from_numpy(pitch),
                            torch.from_numpy(vel), SR)
    rng = np.random.default_rng(0 if shape == "short" else 1)
    B = len(p)
    gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in ((T, B, 6), (T, B), (T, B, 6), (T, B, 6))]
    want = ft.control_pass_vjp(ctl, T, note_off, SR, *gs)
    got = f1b_in_torch(ctl, T, note_off, SR, *gs, chunks=chunks)
    for name, _ in ft.CTL_FIELDS:
        g, w = ft._ctl(got, name), ft._ctl(want, name)
        scale = float(w.abs().max())
        if name in ("on", "lfo_wave"):
            assert scale == 0 and bool((g == 0).all())
        else:
            assert scale > 0 and float((g - w).abs().max()) <= 1e-5 * scale, name


@pytest.mark.parametrize("items, ticks, chunks, per", [
    (1024, 2768, 16, 173), (1, 1040, 65, 16), (20480, 2768, 1, 2768), (3, 5, 1, 5),
    (38, 128, 8, 16)])
def test_control_bwd_chunks(items, ticks, chunks, per):
    """F1b's chunks: enough that items x chunks reaches 16,384, at least
    16 ticks each but the last, none empty."""
    assert ft.control_bwd_chunks(items, ticks) == (chunks, per)
    assert (chunks - 1) * per < ticks <= chunks * per


def test_spec_loss_and_its_gradient_by_the_waveform_match_the_jax_demo():
    """The demo's framing, window and multi-resolution loss on a rendered
    note (4,096 samples) against a corrupted render: the loss within 1e-5
    relative, the spectra within 1e-5, d loss / d waveform within 1e-4 of
    its largest entry (the two frameworks' FFTs round differently, and a
    sample's gradient sums its frames' bins)."""
    jd = jax_demo()
    p = mixed_presets(2, seed=4)
    pitch, vel = notes(2)
    wav = ft.render_batch(torch.from_numpy(p), pitch, vel, note_on_s=NOTE_ON, total_s=TOTAL,
                          sample_rate=SR).numpy()
    w, t = wav[:1], wav[1:] * 0.7
    targets_j = [jd._mag(jnp.asarray(t), n, h) for n, h in jd.SCALES]
    targets_t = [demo._mag(torch.from_numpy(t), n, h) for n, h in demo.SCALES]
    assert demo.SCALES == jd.SCALES
    for a, b in zip(targets_t, targets_j):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=0)
    want_loss, want_grad = jax.value_and_grad(lambda x: jd.spec_loss(x, targets_j))(jnp.asarray(w))
    x = torch.from_numpy(w).requires_grad_(True)
    loss = demo.spec_loss(x, targets_t)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * float(want_loss)
    scale = float(np.abs(want_grad).max())
    assert scale > 0 and float(np.abs(x.grad.numpy() - np.asarray(want_grad)).max()) <= 1e-4 * scale


def jax_problem():
    """The JAX demo's target, corrupted preset, mask and render, at the
    short note (its lines 58-81)."""
    jd = jax_demo()
    p_target = jnp.asarray(generate_structured_corpus(1, seed=33)[0])

    def render(p):
        return fm_jax.render_batch(p, jnp.array([60]), jnp.array([95]), note_on_s=DEMO_NOTE_ON,
                                   total_s=DEMO_TOTAL, sample_rate=jd.SR, feedback="unrolled",
                                   fb_iters=3)

    targets = [jd._mag(render(p_target), n, h) for (n, h) in jd.SCALES]
    p = np.asarray(p_target).copy()
    mask = np.zeros((1, p.shape[1]), dtype=np.float32)
    for op in range(6):
        b = 23 + 22 * op
        p[:, b + 8] *= 0.5
        p[:, b + 4:b + 8] *= 0.6
        mask[:, b + 4:b + 9] = 1.0
    return jd, render, targets, jnp.asarray(p), jnp.asarray(mask)


def test_demo_problem_and_gradient_match_the_jax_demo(short_demo):
    """The corrupted preset and the mask bit-equal to the JAX demo's; the
    loss at the corrupted preset within 1e-5 relative and its gradient by
    the preset (through the unrolled render at 2,560 samples) within 1e-3
    of the largest entry (the bar of the render's own gradient test)."""
    jd, render, targets, p_j, mask_j = jax_problem()
    want_loss, want = jax.value_and_grad(lambda x: jd.spec_loss(render(x), targets))(p_j)
    p, mask, targets_t = short_demo.problem(torch.device("cpu"))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(mask_j))
    x = p.clone().requires_grad_(True)
    loss = short_demo.spec_loss(short_demo.render(x), targets_t)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * float(want_loss)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(x.grad.numpy() - want).max()) <= 1e-3 * scale
    assert float(np.abs(x.grad.numpy() * mask.numpy()).max()) > 0


def test_first_adam_steps_match_optax(short_demo):
    """5 steps of the port's loop (torch Adam, the LambdaLR of the cosine
    schedule, the mask before and after) against 5 of the JAX demo's step
    (optax.adam of optax.cosine_decay_schedule): each step's loss within
    1e-4 relative, each step's learning rate within 1e-6 relative, and the
    unmasked columns never move."""
    jd, render, targets, p_j, mask_j = jax_problem()
    schedule = optax.cosine_decay_schedule(2e-2, jd.STEPS, alpha=0.02)
    opt = optax.adam(schedule)
    state = opt.init(p_j)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(lambda x: jd.spec_loss(render(x), targets))(p)
        updates, s = opt.update(g * mask_j, s, p)
        return optax.apply_updates(p, updates * mask_j), s, loss

    want = []
    for _ in range(5):
        p_j, state, loss = step(p_j, state)
        want.append(float(loss))
    assert short_demo.STEPS == jd.STEPS
    p0, mask, targets_t = short_demo.problem(torch.device("cpu"))
    p, losses, lrs = short_demo.fit(p0, mask, targets_t, 5)
    np.testing.assert_allclose(losses, want, rtol=1e-4, atol=0)
    np.testing.assert_allclose(lrs, [float(schedule(k)) for k in range(5)], rtol=1e-6, atol=0)
    assert torch.equal(p[mask == 0], p0[mask == 0]) and not torch.equal(p, p0)
    assert losses[-1] < losses[0]


def test_demo_main_on_the_cpu(short_demo, monkeypatch, capsys):
    """``main --device cpu`` at 3 steps of a short note prints the JAX demo's
    JSON line (its six keys) and returns it with the losses."""
    monkeypatch.setattr(short_demo, "STEPS", 3)
    out = short_demo.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["demo", "steps", "initial_spectral_mse", "final_spectral_mse",
                          "reduction", "wall_s"]
    assert line["demo"] == "sound_match_through_synth" and line["steps"] == 3
    assert out == dict(line, losses=out["losses"]) and len(out["losses"]) == 3
    assert line["final_spectral_mse"] == round(out["losses"][-1], 5)
    assert 0 < line["final_spectral_mse"] < line["initial_spectral_mse"] and line["reduction"] >= 1


def test_render_gradient_on_the_cpu_is_the_plain_path(monkeypatch):
    """On the CPU a render that requires a gradient, in either feedback mode,
    takes ``plain_render`` (the same gradient, bit for bit) and builds or
    launches no kernel; F1b's wrapper refuses CPU tensors."""
    def no_build():
        raise AssertionError("built a kernel for a CPU tensor")

    monkeypatch.setattr(ft, "_fm_library", no_build)
    before = dict(ft.LAUNCHES)
    p = mixed_presets(2, seed=5)
    pitch, vel = notes(2)
    kw = dict(note_on_s=0.02, total_s=1024 / SR, sample_rate=SR, fb_iters=2)
    for feedback in ("unrolled", "exact"):
        grads = []
        for fn in (ft.render_batch, ft.plain_render):
            x = torch.from_numpy(p).requires_grad_(True)
            torch.mean(torch.square(fn(x, pitch, vel, feedback=feedback, **kw))).backward()
            grads.append(x.grad)
        assert torch.equal(*grads) and float(grads[0].abs().max()) > 0, feedback
    assert ft.LAUNCHES == before
    ctl = torch.zeros((2, ft.CTL_WIDTH))
    with pytest.raises(ValueError, match="card"):
        ft.fm_control_bwd(ctl, torch.zeros((4, 2, 8, 2)), 4, 0, SR, None, None, None, None)


def test_tape_size():
    """F1's tape under a gradient, which F1b reads: a float2 per lane, 8
    lanes an item, per tick: 181 MB at the corpus pass's 1,024 items and
    2,768 ticks."""
    assert ft.tape_bytes(1024, 2768) == 2768 * 1024 * 8 * 8 == 181_403_648
    assert ft.tape_bytes(1, 1040) == 66_560


@pytest.mark.cuda
def test_f1b_matches_control_pass_vjp_on_card():
    """On the card, 22 mixed presets at 128 ticks on seeded cotangents: F1
    with its tape gives F1's outputs bit for bit; F1b on that tape within
    1e-4 of each gradient field's largest entry in ``control_pass_vjp``
    (the switches exactly 0), one launch of each of its kernels; through
    ``fm_control``'s autograd, the same row."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    p = torch.from_numpy(np.concatenate([mixed_presets(16), loop_length_presets()])).cuda()
    pitch, vel = notes(len(p))
    ctl = ft.control_params(ft.decode_presets(p), torch.from_numpy(pitch).cuda(),
                            torch.from_numpy(vel).cuda(), SR)
    B, T, off = len(p), N_SHORT // ft.BLOCK, int(NOTE_ON * SR)
    rng = np.random.default_rng(8)
    gs = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
          for s in ((T, B, 6), (T, B), (T, B, 6), (T, B, 6))]
    *outs, tape = ft._fm_control_launch(ctl, T, off, SR, taped=True)
    assert all(torch.equal(a, b) for a, b in zip(outs, ft.fm_control(ctl, T, off, SR)))
    n0 = dict(ft.LAUNCHES)
    got = ft.fm_control_bwd(ctl, tape, T, off, SR, *gs)
    assert {k: ft.LAUNCHES[k] - n0[k] for k in ("fm_control_bwd", *ft.F1B_KERNELS)} == dict.fromkeys(
        ("fm_control_bwd", *ft.F1B_KERNELS), 1)
    want = ft.control_pass_vjp(ctl, T, off, SR, *gs)
    for name, _ in ft.CTL_FIELDS:
        g, w = ft._ctl(got, name), ft._ctl(want, name)
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * scale if scale > 0 else bool((g == 0).all())
    x = ctl.detach().requires_grad_(True)
    outs = ft.fm_control(x, T, off, SR)
    torch.autograd.backward(outs, gs)
    assert torch.equal(x.grad, got)


@pytest.mark.cuda
def test_exact_render_gradient_on_card():
    """On the card an 'exact' render of an input that requires a gradient
    runs F1 and F2 (with its tape) forward and F2b and F1b backward, one
    call each: d mean(w^2) / d presets of 22 items at feedback 0-6 (loops
    of 1-3 operators), 1,024 samples, within 1e-3 of the largest entry of
    the same through ``plain_render`` on the card. Without a gradient, or
    under no_grad, F2 keeps no tape and F2b is not launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    pr = np.concatenate([mixed_presets(16), loop_length_presets()])
    pr[:, 5] = np.minimum(pr[:, 5], 6 / 7)
    p = torch.from_numpy(pr).cuda()
    pitch, vel = notes(len(p))
    kw = dict(note_on_s=0.02, total_s=1024 / SR, sample_rate=SR, feedback="exact")
    grads, launches = [], []
    for fn in (ft.render_batch, ft.plain_render):
        x = p.clone().requires_grad_(True)
        n0 = dict(ft.LAUNCHES)
        torch.mean(torch.square(fn(x, pitch, vel, **kw))).backward()
        torch.cuda.synchronize()
        grads.append(x.grad)
        launches.append({k: ft.LAUNCHES[k] - n0[k] for k in n0})
    none = dict.fromkeys(ft.LAUNCHES, 0)
    seg = len(ft.exact_segments(1024 // ft.BLOCK))
    assert launches == [dict(none, fm_control=1, fm_exact=1, fm_fb_loop=seg, fm_exact_ff=seg,
                             fm_control_bwd=1, **dict.fromkeys(ft.F1B_KERNELS, 1),
                             fm_exact_bwd=1, **dict.fromkeys(ft.F2B_KERNELS, 1)), none]
    scale = float(grads[1].abs().max())
    assert scale > 0 and torch.isfinite(grads[0]).all()
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-3 * scale
    for grad_mode in (True, False):
        n0 = dict(ft.LAUNCHES)
        with torch.set_grad_enabled(grad_mode):
            out = ft.render_batch(p if grad_mode else p.clone().requires_grad_(True), pitch, vel,
                                  **kw)
        assert out.shape == (len(p), 1024) and torch.isfinite(out).all() and not out.requires_grad
        assert {k: ft.LAUNCHES[k] - n0[k] for k in n0} == dict(
            none, fm_control=1, fm_exact=1, fm_fb_loop=seg, fm_exact_ff=seg)
