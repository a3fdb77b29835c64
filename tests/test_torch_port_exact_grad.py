"""The gradient of the port's ``'exact'`` FM render against the JAX
package's (``synth/fm_jax.py``, ``render_batch(feedback="exact")``
differentiated by XLA through its per-sample ``lax.scan``), on the CPU at
short renders: the preset gradient of ``render_batch`` against
``jax.grad``, ``exact_pass_vjp`` (F2b's plain version) chained with the
decode and F1b's plain version against ``jax.vjp`` on the same numpy
cotangents, and F2b's algorithm written out in torch against
``exact_pass_vjp``. F2b itself (``csrc/fm_render.cu``) runs only on the
card (``tests/test_torch_port_sound_match.py``, marked ``cuda``).

Measured on the CPU (torch 2.13, jax on the CPU), against the bars
below: the preset gradient 5.1e-6 of its largest entry at 2,048 samples;
F2b's algorithm in torch 2.5e-7 of each field's largest entry.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.synth import fm_jax
from preset_gen_vae_tpu_torch.synth import fm_torch as ft
from test_torch_port_fm import mixed_presets, notes

SR = 22050
N_GRAD = 2048  # samples of the render's gradient checks
NOTE_ON = 0.05  # note-off inside the render: the release stage too
LOOP_ALGORITHM = {1: 0, 2: 5, 3: 3}  # a 0-based algorithm with a loop of 1, 2, 3 operators


def loop_presets(length: int, feedback=(0, 3, 5, 6), seed: int = 11) -> np.ndarray:
    """One mixed preset per feedback level on an algorithm whose loop has
    ``length`` operators (0: the mixed algorithms, at feedback 0)."""
    p = mixed_presets(len(feedback), seed=seed)
    if length:
        p[:, 4] = LOOP_ALGORITHM[length] / 31.0
        p[:, 5] = np.asarray(feedback) / 7.0
    else:
        p[:, 5] = 0.0
    return p


def f1_outputs(p, n_samples: int):
    """The plain control pass's outputs for presets ``p`` and F2's other
    arguments: (amps, starts, incs, alg, fb_amt, n_carriers, volume, sr)."""
    pitch, vel = notes(len(p))
    d = ft.decode_presets(torch.from_numpy(p))
    ctl = ft.control_params(d, torch.from_numpy(pitch), torch.from_numpy(vel), SR)
    amps, _, starts, incs = ft.control_pass(ctl, n_samples // ft.BLOCK, int(NOTE_ON * SR), SR)
    alg, fb_amt = d["algorithm"].to(torch.int32), ft.feedback_amount(d)
    nc = ft._clip(torch.from_numpy(ft.ALGO_CARRIER)[alg.long()].sum(-1), lo=1.0)
    return amps, starts, incs, alg, fb_amt, nc, d["master_volume"], SR


@pytest.mark.parametrize("length", [1, 2, 3])
def test_exact_render_gradient_matches_jax(length):
    """d mean(w^2) / d presets of an 'exact' render (2,048 samples) of four
    presets whose feedback loop has ``length`` operators, at feedback 0, 3,
    5 and 6, against jax.grad of fm_jax's: within 1e-4 of the largest entry
    (f32 sums over the samples in another order; measured 5.1e-6). The
    feedback column takes a gradient on the items with feedback only: at
    feedback 0 the gain's ``where`` stops it, as JAX's does."""
    p = loop_presets(length)
    pitch, vel = notes(len(p))
    kw = dict(note_on_s=NOTE_ON, total_s=N_GRAD / SR, sample_rate=SR, feedback="exact")

    def jloss(x):
        return jnp.mean(jnp.square(fm_jax.render_batch(x, jnp.asarray(pitch), jnp.asarray(vel),
                                                       **kw)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(p)))
    x = torch.from_numpy(p).requires_grad_(True)
    torch.mean(torch.square(ft.render_batch(x, pitch, vel, **kw))).backward()
    got = x.grad.numpy()
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * scale
    assert got[0, 5] == 0.0 and want[0, 5] == 0.0 and np.all(got[1:, 5] != 0.0)


def test_exact_pass_vjp_chained_with_the_decode_matches_jax_vjp():
    """From 14 presets (loops of 0-3 operators, feedback 0-6) through the
    decode, the control pass (``control_pass_vjp``) and the exact pass
    (``exact_pass_vjp``, with the gain's and the volume's gradients
    carried back through the decode), the gradient of <g, waveform> by the
    presets against ``jax.vjp`` of fm_jax's exact render on the same numpy
    cotangent g (2,048 samples): within 1e-4 of the largest entry."""
    p = np.concatenate([mixed_presets(2, seed=6)] + [
        loop_presets(n, feedback=(2, 4, 6, 0), seed=12 + n) for n in (1, 2, 3)])
    p[:2, 5] = np.minimum(p[:2, 5], 6 / 7)
    pitch, vel = notes(len(p))
    B, T = len(p), N_GRAD // ft.BLOCK
    g = np.random.default_rng(5).standard_normal((B, N_GRAD)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: fm_jax.render_batch(
        x, jnp.asarray(pitch), jnp.asarray(vel), note_on_s=NOTE_ON, total_s=N_GRAD / SR,
        sample_rate=SR, feedback="exact"), jnp.asarray(p))
    (want,) = vjp(jnp.asarray(g))
    want = np.asarray(want)

    x = torch.from_numpy(p).requires_grad_(True)
    d = ft.decode_presets(x)
    ctl = ft.control_params(d, torch.from_numpy(pitch), torch.from_numpy(vel), SR)
    alg, fb_amt, mv = d["algorithm"].to(torch.int32), ft.feedback_amount(d), d["master_volume"]
    nc = ft._clip(torch.from_numpy(ft.ALGO_CARRIER)[alg.long()].sum(-1), lo=1.0)
    note_off = int(NOTE_ON * SR)
    amps, _, starts, incs = ft.control_pass(ctl.detach(), T, note_off, SR)
    g_amps, g_starts, g_incs, g_fb, g_mv = ft.exact_pass_vjp(
        amps, starts, incs, alg, fb_amt.detach(), nc, mv.detach(), SR, torch.from_numpy(g))
    assert g_amps.shape == g_starts.shape == g_incs.shape == (T, B, 6)
    assert g_fb.shape == g_mv.shape == (B,)
    g_ctl = ft.control_pass_vjp(ctl.detach(), T, note_off, SR, g_amps, None, g_starts, g_incs)
    torch.autograd.backward([ctl, fb_amt, mv], [g_ctl, g_fb, g_mv])
    got = x.grad.numpy()
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# F2b's algorithm (csrc/fm_render.cu: fm_exact_bwd_ff, fm_exact_bwd_loop,
# fm_exact_bwd_seams) written out in torch, vectorized over items, ticks
# and splits where the kernels have threads
# ---------------------------------------------------------------------------


def _bit(mask, i):
    return ((mask >> i) & 1).bool()


def _shift(x, k):
    """x[:, n - k], zero before the start."""
    return torch.nn.functional.pad(x[:, :-k], (k, 0))


def clip_bwd(o, g):
    """The gradient of ``_clip(o, -1, 1)`` times g: half at a tie on either
    side, as jnp.clip's."""
    m = torch.maximum(o, torch.tensor(-1.0))
    d_min = torch.where(m < 1, 1.0, torch.where(m == 1, 0.5, 0.0))
    d_max = torch.where(o > -1, 1.0, torch.where(o == -1, 0.5, 0.0))
    return g * d_min * d_max


def tick_sums(g_ph, g_amp, T):
    """One operator's per-sample phase and amplitude cotangents (B, N) ->
    its (T, B) columns of g_starts, g_incs and g_amps: each sample's
    amplitude cotangent goes w_s to its tick and 1 - w_s to the one before."""
    B = g_ph.shape[0]
    s = torch.arange(1, ft.BLOCK + 1, dtype=torch.float32)
    w = s / ft.BLOCK
    ph, amp = g_ph.reshape(B, T, ft.BLOCK), g_amp.reshape(B, T, ft.BLOCK)
    cur, prev = (amp * w).sum(-1), (amp - amp * w).sum(-1)
    g_amps = cur + torch.nn.functional.pad(prev[:, 1:], (0, 1))
    return ph.sum(-1).t(), (ph * s).sum(-1).t(), g_amps.t()


def ldexp(x, e):
    """x 2^e, exact where the result is a normal float32 (2^e in two
    factors, so that e may pass float32's exponent range)."""
    h = torch.div(e, 2, rounding_mode="floor")
    return x * torch.exp2(h.float()) * torch.exp2((e - h).float())


def split_ticks(T: int, splits: int):
    """F2b's splits of the ticks (``exact_bwd_splits``' geometry for
    ``splits``): (count, steps a split, first ticks, ends)."""
    steps = -(-T // 8)
    per = -(-steps // splits)
    n = -(-steps // per)
    tb = torch.arange(n) * per * 8
    return n, per, tb, torch.clamp(tb + per * 8, max=T)


def tick_maps(e, k, T):
    """Each tick's affine map of the state T[n] = (k[n] a[n], k[n+1]
    a[n+1]): T[32 t] = A_t T[32 t + 32] + b_t, its 32 samples walked from
    the end (fm_exact_bwd_ff's 8 lanes) -> A (B, T, 4) row-major, b (B,
    T, 2)."""
    B = e.shape[0]
    ek, kk = e.reshape(B, T, ft.BLOCK), k.reshape(B, T, ft.BLOCK)
    p = [torch.ones(B, T), torch.zeros(B, T), torch.zeros(B, T), torch.ones(B, T)]
    q0, q1 = torch.zeros(B, T), torch.zeros(B, T)
    for i in range(ft.BLOCK - 1, -1, -1):
        kv = kk[..., i]
        h0, h1 = p[2] + p[0], p[3] + p[1]
        p = [kv * h0, kv * h1, p[0], p[1]]
        r = (ek[..., i] + q1) + q0
        q0, q1 = kv * r, q0
    return torch.stack(p, -1), torch.stack([q0, q1], -1)


def compose(u, v):
    """The span map u = (p, q, ex) followed by the later span's v, as the
    kernel's ``compose``: 2^eu pu (2^ev pv x + qv) + qu, the product's
    entries renormalised to [0.5, 1) by a power of two."""
    (up, uq, ue), (vp, vq, ve) = u, v
    q = torch.stack([ldexp(up[..., 0] * vq[..., 0] + up[..., 1] * vq[..., 1], ue) + uq[..., 0],
                     ldexp(up[..., 2] * vq[..., 0] + up[..., 3] * vq[..., 1], ue) + uq[..., 1]], -1)
    p = torch.stack([up[..., 0] * vp[..., 0] + up[..., 1] * vp[..., 2],
                     up[..., 0] * vp[..., 1] + up[..., 1] * vp[..., 3],
                     up[..., 2] * vp[..., 0] + up[..., 3] * vp[..., 2],
                     up[..., 2] * vp[..., 1] + up[..., 3] * vp[..., 3]], -1)
    big = p.abs().amax(-1)
    e2 = torch.where((big > 0) & torch.isfinite(big), torch.frexp(big)[1], 0)
    return ldexp(p, -e2[..., None]), q, ue + ve + e2


def split_maps(A, b, T, splits, threads=256):
    """Each split's map, T[32 tb] = 2^ex P x + q -> P (B, S, 4), q (B, S,
    2), ex (B, S), as fm_exact_bwd_ff's block composes it: each of its
    ``threads`` threads composes a run of the split's ticks in time order,
    then the runs compose in pairs, each product renormalised."""
    B = A.shape[0]
    n, per, tb, te = split_ticks(T, splits)
    out = []
    for s in range(n):
        run = -(-int(te[s] - tb[s]) // threads)
        slots = (torch.tensor([1.0, 0.0, 0.0, 1.0]).repeat(B, threads, 1),
                 torch.zeros(B, threads, 2), torch.zeros(B, threads, dtype=torch.int32))
        for j in range(run):
            t = int(tb[s]) + torch.arange(threads) * run + j
            act = (t < te[s])[None, :]
            tt = t.clamp(max=T - 1)
            nxt = compose(slots, (A[:, tt], b[:, tt], torch.zeros(B, threads, dtype=torch.int32)))
            slots = tuple(torch.where(act[..., None] if x.dim() == 3 else act, x, y)
                          for x, y in zip(nxt, slots))
        w = 1
        while w < threads:
            at = torch.arange(0, threads, 2 * w)
            pair = compose(tuple(x[:, at] for x in slots), tuple(x[:, at + w] for x in slots))
            for x, y in zip(slots, pair):
                x[:, at] = y
            w *= 2
        out.append(tuple(x[:, 0] for x in slots))
    return tuple(torch.stack(x, 1) for x in zip(*out))


def recurrence_by_scan(e, k, T, splits):
    """a[n] = e[n] + k[n+1] a[n+1] + k[n+2] a[n+2] as F2b scans it: the
    tick maps, the splits' maps, the state entering each split through
    the later splits' maps from the last, the state entering each tick
    through the tick maps from its split's end, and each tick walked from
    its state. One split: the chain over the ticks is serial."""
    B = e.shape[0]
    A, b = tick_maps(e, k, T)
    pa, qa, ex = split_maps(A, b, T, splits)
    n, per, tb, te = split_ticks(T, splits)
    x = torch.zeros(B, 2)
    entering = [None] * n
    for s in range(n - 1, -1, -1):
        entering[s] = x
        x = torch.stack([ldexp(pa[:, s, 0] * x[:, 0] + pa[:, s, 1] * x[:, 1], ex[:, s]) + qa[:, s, 0],
                         ldexp(pa[:, s, 2] * x[:, 0] + pa[:, s, 3] * x[:, 1], ex[:, s]) + qa[:, s, 1]],
                        -1)
    x = torch.stack(entering, 1)  # (B, S, 2)
    tin = torch.zeros(B, T, 2)
    for j in range(per * 8):
        t = te - 1 - j
        act = (t >= tb)[None, :, None]
        tt = t.clamp(min=0)
        tin[:, tt] = torch.where(act, x, tin[:, tt])
        m, c = A[:, tt], b[:, tt]
        x_new = torch.stack([(m[..., 0] * x[..., 0] + m[..., 1] * x[..., 1]) + c[..., 0],
                             (m[..., 2] * x[..., 0] + m[..., 3] * x[..., 1]) + c[..., 1]], -1)
        x = torch.where(act, x_new, x)
    ek, kk = e.reshape(B, T, ft.BLOCK), k.reshape(B, T, ft.BLOCK)
    a = torch.zeros(B, T, ft.BLOCK)
    x0, x1 = tin[..., 0], tin[..., 1]
    for i in range(ft.BLOCK - 1, -1, -1):
        r = (ek[..., i] + x1) + x0
        a[..., i] = r
        x0, x1 = kk[..., i] * r, x0
    return a.reshape(B, T * ft.BLOCK), ex


def f2b_in_torch(amps_t, starts, incs, alg, fb_amt, nc, mv, sr, g_out, splits=1):
    """The gradients of ``exact_pass_vjp``, by F2b's operations, the
    recurrence scanned over ``splits`` splits of the ticks."""
    T, B, _ = amps_t.shape
    col = lambda v: v[:, None]  # noqa: E731
    phases, amps = ft.sample_phases(starts, incs), ft.upsample_amps(amps_t)
    tape = ft.feedback_loop_pass(phases, amps, alg, fb_amt)  # what F2 keeps under a gradient
    rows = torch.from_numpy(ft.algorithm_rows())[alg.long()]
    mods, carriers, src, dst = rows[:, :6], rows[:, 6], rows[:, 7], rows[:, 8]
    on = fb_amt != 0
    loop = torch.where(on, rows[:, ft.ALG_LOOP_MASK], 0)
    # ---- (a): the operators off the loop, forward (the source from the tape)
    y, sn, cs = [None] * 6, [None] * 6, [None] * 6
    for i in range(5, -1, -1):
        mod = torch.zeros_like(tape)
        for m in range(i + 1, 6):
            mod = mod + torch.where(col(_bit(mods[:, i], m)), y[m], 0.0)
        arg = ft.TWO_PI * (phases[:, i] + mod * ft.MOD_SCALE)
        sn[i], cs[i] = torch.sin(arg), torch.cos(arg)
        y[i] = torch.where(col(_bit(loop, i)), torch.where(col(src == i), tape, 0.0),
                           sn[i] * amps[:, i])
    sample = torch.zeros_like(tape)
    for i in range(6):
        sample = sample + torch.where(col(_bit(carriers, i)), y[i], 0.0)
    # ... then backward: fade, clip, volume, carrier sum, operators low to high
    q = sample / col(nc)
    g_o = clip_bwd(q * col(mv), g_out * torch.from_numpy(ft.fade_scale(T * ft.BLOCK, sr)))
    g_mv = (g_o * q).sum(1)
    g_sample = g_o * col(mv) / col(nc)
    g_y = [torch.where(col(_bit(carriers, i)), g_sample, 0.0) for i in range(6)]
    g_ph, g_amp = [None] * 6, [None] * 6
    e, g_dst = torch.zeros_like(tape), torch.zeros_like(tape)
    for i in range(6):
        e = torch.where(col(on & (src == i)), g_y[i], e)  # complete: only lower operators read it
        off = col(~_bit(loop, i))
        g_amp[i] = torch.where(off, g_y[i] * sn[i], 0.0)
        g_u = g_y[i] * amps[:, i] * cs[i] * ft.TWO_PI
        g_ph[i] = torch.where(off, g_u, 0.0)
        g_mod = torch.where(off, g_u * ft.MOD_SCALE, 0.0)
        for m in range(i + 1, 6):
            g_y[m] = g_y[m] + torch.where(col(_bit(mods[:, i], m)), g_mod, 0.0)
        g_dst = torch.where(col(dst == i), g_mod, g_dst)
    y_src = torch.stack(y, 1)[torch.arange(B), src.long()]
    half = 0.5 * (_shift(y_src, 1) + _shift(y_src, 2))  # the feedback term over its gain
    g_fb = (g_dst * half).sum(1)  # at feedback 0: the term that meets a zero gain
    # (a) and (b): k[n], the loop's derivative by its input, times half the gain
    length = rows[:, ft.ALG_LOOP_LEN]
    ops = rows[:, ft.ALG_LOOP_OPS:ft.ALG_LOOP_OPS + 3].clamp(min=0).long()
    pick = lambda x, j: x[torch.arange(B), ops[:, j]]  # noqa: E731
    ly, lsn, lcs, d = half * col(fb_amt), [], [], torch.ones_like(tape)
    for j in range(3):
        inner = ft.TWO_PI * (pick(phases, j) + ly * ft.MOD_SCALE)
        lsn.append(torch.sin(inner))
        lcs.append(torch.cos(inner))
        use = col(length > j)
        ly = torch.where(use, lsn[j] * pick(amps, j), ly)
        d = torch.where(use, d * (pick(amps, j) * lcs[j] * ft.TWO_PI * ft.MOD_SCALE), d)
    k = torch.where(col(on), d * col(fb_amt) * 0.5, 0.0)
    # ---- the recurrence, scanned over ticks and splits
    a, _ = recurrence_by_scan(e, k, T, splits)
    # ---- (b): the loop's operators from a[n], source back to destination
    g = a
    for j in range(2, -1, -1):
        use = col(on & (length > j))
        g_u = g * pick(amps, j) * lcs[j] * ft.TWO_PI
        for i in range(6):
            at = use & col(ops[:, j] == i)
            g_amp[i] = torch.where(at, g * lsn[j], g_amp[i])
            g_ph[i] = torch.where(at, g_u, g_ph[i])
        g = torch.where(use, g_u * ft.MOD_SCALE, g)
    g_fb = torch.where(on, (g * half).sum(1), g_fb)
    cols = [tick_sums(g_ph[i], g_amp[i], T) for i in range(6)]
    g_starts, g_incs, g_amps = (torch.stack([c[r] for c in cols], -1) for r in range(3))
    return g_amps, g_starts, g_incs, g_fb, g_mv


def serial_recurrence(e, k):
    """a[n] = (e[n] + k[n+2] a[n+2]) + k[n+1] a[n+1], sample after sample
    from the end."""
    B, N = e.shape
    a, kk = torch.zeros((B, N + 2)), torch.nn.functional.pad(k, (0, 2))
    for n in range(N - 1, -1, -1):
        a[:, n] = (e[:, n] + kk[:, n + 2] * a[:, n + 2]) + kk[:, n + 1] * a[:, n + 1]
    return a[:, :N]


@pytest.mark.parametrize("splits", [1, 4, 32])
@pytest.mark.parametrize("length", [0, 1, 2, 3])
def test_f2b_algorithm_in_torch_matches_exact_pass_vjp(length, splits):
    """F2b's arithmetic (e and k, the recurrence scanned over the ticks'
    and the splits' maps, the loop's operators, the per-tick sums and the
    two-tick amplitude split), run in torch on the CPU over 1, 4 or 32
    splits of the ticks (one split: the chain over the ticks is serial;
    32: a step each), against autograd through the exact pass on the same
    seeded cotangent (1,024 samples), on items whose loop has ``length``
    operators at feedback 0, 2, 4, 6 and 7 (0: mixed algorithms at
    feedback 0, where the gain still takes a gradient: the source's output
    meets a zero gain): within 1e-5 of each field's largest entry (measured
    2.5e-7). The kernels run these operations; the card holds them
    against ``exact_pass_vjp`` at 1e-4 (``chip_smoke.py``)."""
    fb = (0, 2, 4, 6, 7) if length else (0,) * 8
    args = f1_outputs(loop_presets(length, feedback=fb, seed=20 + length), 1024)
    assert set(ft.loop_lengths(args[3], args[4]).tolist()) == ({0, length} if length else {0})
    g = torch.from_numpy(np.random.default_rng(length).standard_normal(
        (len(fb), 1024)).astype(np.float32))
    want = ft.exact_pass_vjp(*args, g)
    got = f2b_in_torch(*args, g, splits=splits)
    for name, a, b in zip(("amps", "starts", "incs", "fb_amt", "master_volume"), got, want):
        assert a.shape == b.shape and torch.isfinite(b).all(), name
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-5 * scale, name


def loud_presets(feedback=(3, 4, 5)) -> np.ndarray:
    """Loop-of-one presets at ``feedback`` with every operator at full output
    level, full EG levels and fast rates: a loud loop."""
    p = loop_presets(1, feedback=feedback, seed=0)
    for op in range(6):
        base = 23 + 22 * op
        p[:, base:base + 4] = 0.9
        p[:, base + 4:base + 9] = 1.0
        p[:, base + 19:base + 21] = 0.0
        p[:, base + 21] = 1.0
    return p


@pytest.mark.parametrize("splits", [1, 4])
def test_f2b_scan_renormalises_a_loud_loops_products(splits, monkeypatch):
    """Loud loops of one operator at feedback 3, 4 and 5 (1,024 samples),
    whose plain gradient is finite: the product of a split's tick maps
    leaves float32's range (its power-of-two exponent passes -149, where
    an unnormalised product would be 0), and the scan, which keeps each
    product's entries in [0.5, 1) and its exponent apart, still gives
    ``exact_pass_vjp``'s gradients within 1e-5 of each field's largest
    entry (measured 2.5e-7)."""
    args = f1_outputs(loud_presets(), 1024)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 1024)).astype(np.float32))
    want = ft.exact_pass_vjp(*args, g)
    seen = {}
    scan = recurrence_by_scan

    def kept(*a):
        out = scan(*a)
        seen["ex"] = out[1]
        return out

    monkeypatch.setattr(sys.modules[__name__], "recurrence_by_scan", kept)
    got = f2b_in_torch(*args, g, splits=splits)
    assert int(seen["ex"].min()) < -149
    for name, a, b in zip(("amps", "starts", "incs", "fb_amt", "master_volume"), got, want):
        assert torch.isfinite(b).all() and torch.isfinite(a).all(), name
        scale = float(b.abs().max())
        assert scale > 0 and float((a - b).abs().max()) <= 1e-5 * scale, name


def test_one_split_scan_is_the_serial_recurrence():
    """With one split the scan's chain over the ticks gives the serial
    recurrence's a[n] within 1e-6 of its largest entry on seeded e and k
    (|k| < 1.2, 4,096 samples), and 32 splits the same."""
    rng = np.random.default_rng(5)
    e = torch.from_numpy(rng.standard_normal((3, 4096)).astype(np.float32))
    k = torch.from_numpy((rng.random((3, 4096)) * 1.2 - 0.6).astype(np.float32))
    want = serial_recurrence(e, k)
    scale = float(want.abs().max())
    for splits in (1, 32):
        got, _ = recurrence_by_scan(e, k, 128, splits)
        assert float((got - want).abs().max()) <= 1e-6 * scale, splits


def test_clip_gradient_halves_at_a_tie():
    """The clip's gradient in F2b: 1 inside, 0 outside and half at exactly
    -1 or 1, as autograd through ``_clip`` (jnp.clip's rule) gives it."""
    o = torch.tensor([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0], requires_grad=True)
    g = torch.arange(1.0, 8.0)
    ft._clip(o, -1.0, 1.0).backward(g)
    assert torch.equal(clip_bwd(o.detach(), g), o.grad)
    assert o.grad.tolist() == [0.0, 1.0, 3.0, 4.0, 5.0, 3.0, 0.0]


def test_exact_pass_vjp_contract():
    """``exact_pass_vjp`` returns the five gradients on the inputs' shapes;
    a zero cotangent gives zeros."""
    args = f1_outputs(loop_presets(1, feedback=(0, 4)), 256)
    T, B = args[0].shape[:2]
    g = torch.from_numpy(np.random.default_rng(3).standard_normal((B, 256)).astype(np.float32))
    grads = ft.exact_pass_vjp(*args, g)
    assert [tuple(x.shape) for x in grads] == [(T, B, 6)] * 3 + [(B,)] * 2
    assert all(float(x.abs().max()) > 0 for x in grads)
    assert all(not bool(x.any()) for x in ft.exact_pass_vjp(*args, torch.zeros_like(g)))


def test_exact_gradient_on_the_cpu_builds_nothing_and_f2b_refuses_cpu_tensors(monkeypatch):
    """On the CPU an 'exact' render that requires a gradient takes the plain
    path and builds or launches no kernel; F2b's wrappers and F2's
    autograd function refuse CPU tensors rather than run the plain loops."""
    def no_build():
        raise AssertionError("built a kernel for a CPU tensor")

    monkeypatch.setattr(ft, "_fm_library", no_build)
    before = dict(ft.LAUNCHES)
    x = torch.from_numpy(loop_presets(2, feedback=(0, 5))).requires_grad_(True)
    ft.render_batch(x, [60, 60], [85, 85], total_s=0.03, feedback="exact").sum().backward()
    assert ft.LAUNCHES == before and float(x.grad.abs().max()) > 0
    args = f1_outputs(loop_presets(1, feedback=(0, 4)), 256)
    tape = torch.zeros((2, 256))
    with pytest.raises(ValueError, match="F2b runs on the card"):
        ft.fm_exact_bwd(tape, *args, None)
    with pytest.raises(ValueError, match="card"):
        ft.FmExact.apply(*args)
    assert ft.LAUNCHES == before


def test_exact_bwd_scratch_size():
    """F2b's scratch: e (then a), f32 a sample and item, the tick maps (6
    f32 a tick and item) and per split and item 16 f32: 0.43 GB at the
    corpus pass's 1,024 items and 88,576 samples (4 splits), 0.17 MB at
    the demo's one item and 33,280 samples (130 splits)."""
    assert ft.exact_bwd_scratch_bytes(1024, 88576) == 4 * 1024 * (88576 + 6 * 2768 + 16 * 4) \
        == 431_095_808
    assert ft.exact_bwd_scratch_bytes(1, 33280) == 4 * (33280 + 6 * 1040 + 16 * 130) == 166_400


@pytest.mark.parametrize("items, ticks, splits, per", [
    (1024, 2768, 4, 87), (1, 1040, 130, 1), (20480, 2768, 1, 346), (3, 5, 1, 1), (64, 128, 16, 1),
    (2, 2768, 173, 2)])
def test_exact_bwd_splits(items, ticks, splits, per):
    """F2b's splits: whole 8-tick steps, enough that items x splits
    reaches 4,096 blocks, at most 256 and at most one a step, none empty
    (the kernels' split_ticks: ``per`` steps a split, the last shorter)."""
    assert ft.exact_bwd_splits(items, ticks) == splits
    n, got_per, tb, te = split_ticks(ticks, splits)
    assert n == splits and got_per == per
    assert int(tb[0]) == 0 and int(te[-1]) == ticks and bool((te > tb).all())
    assert torch.equal(tb[1:], te[:-1])
