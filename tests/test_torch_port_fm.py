"""The port's FM engine (``preset_gen_vae_tpu_torch/synth/fm_torch.py``)
against the JAX package's (``preset_gen_vae_tpu/synth/fm_jax.py``) on the
same seeded presets, on the CPU, at short renders (1,024 to 4,096 samples):
the decode, the control pass, the S&H generator, both feedback modes of
the render, and the gradient of the unrolled render; F2's two phases'
plain versions (``feedback_loop_pass``, ``feedforward_pass``) against
``exact_pass``, and the feedback loops they split off. Kernels F1 and F2
(``csrc/fm_render.cu``) run only on the card (marked ``cuda``); their
layout constants, tables and entry points are checked here against the
Python side.

Measured on the CPU (torch 2.13, jax on the CPU), against the bars below:
decode bit-equal; control pass amplitudes 9.5e-7, pitch factor 1.2e-7,
increments 3.5e-7 relative, per-sample phases 5.7e-5 (cycles); render
max |err| 9.2e-6 without feedback, MAE 7.2e-7 over all (exact and
unrolled); gradient 6.8e-6 of its largest entry, once ``clip`` and
``minimum`` split their gradient at a tie as JAX's do (torch.clamp passes
all of it, and a preset's master volume sits at the clip's edge).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.synth import fm_jax
from preset_gen_vae_tpu.synth.database import generate_structured_corpus_v2
from preset_gen_vae_tpu_torch.synth import fm_torch as ft

SR = 22050
N_SHORT = 4096
NOTE_ON, TOTAL = 0.1, N_SHORT / SR  # note-off inside the render: all four EG stages
QUANTIZED = ("algorithm", "feedback", "lfo_key_sync", "lfo_wave", "pitch_mod_sens",
             "fixed_mode", "coarse", "detune", "l_curve", "r_curve", "rate_scaling",
             "amp_mod_sens", "key_vel", "on")


def mixed_presets(n: int = 16, seed: int = 3) -> np.ndarray:
    """``n`` structured2 presets, each algorithm a turn, feedback 0 and 7
    in turn, the LFO fast and deep, every other one S&H (wave 5, which the
    generator itself never draws), key sync on and off."""
    p, _, _ = generate_structured_corpus_v2(n, seed=seed)
    i = np.arange(n)
    p[:, 4] = (i % 32) / 31.0
    p[:, 5] = np.where(i % 3 == 0, 0.0, np.where(i % 3 == 1, 1.0, p[:, 5]))
    p[:, 7] = 0.9 + 0.1 * (i % 2)  # LFO speed: wraps within the short render
    p[:, 8] = np.where(i % 4 == 0, 0.3, 0.0)  # LFO delay: the ramp
    p[:, 9] = 0.8  # pitch-mod depth
    p[:, 10] = 0.5  # amp-mod depth
    p[:, 11] = (i // 2) % 2  # LFO key sync
    p[:, 12] = np.where(i % 2 == 0, 1.0, (i % 5) / 5.0)  # S&H, or waves 0-4
    p[:, 14] = 1.0  # pitch-mod sensitivity 7
    return p.astype(np.float32)


def notes(n: int):
    pitch = np.array([60, 48, 72, 40, 55, 67, 84, 60] * (n // 8 + 1))[:n].astype(np.int32)
    vel = np.array([85, 100, 64, 127, 42, 85, 110, 1] * (n // 8 + 1))[:n].astype(np.int32)
    return pitch, vel


def test_decode_presets_matches_jax():
    """Quantized fields equal; the rest within 1e-6 relative."""
    p = mixed_presets()
    want = fm_jax.decode_presets(jnp.asarray(p))
    got = ft.decode_presets(torch.from_numpy(p))
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), got[k].numpy()
        if k in QUANTIZED:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)


def _jax_control(p, pitch, vel):
    d = fm_jax.decode_presets(jnp.asarray(p))
    amps, pf = fm_jax._control_pass(d, jnp.asarray(pitch), jnp.asarray(vel), NOTE_ON, TOTAL, SR)
    phases, inc = fm_jax._per_sample_phases(fm_jax._op_freqs(d, jnp.asarray(pitch)), pf, SR)
    return [np.asarray(a) for a in (amps, pf, phases, inc)]


def _port_control(p, pitch, vel):
    d = ft.decode_presets(torch.from_numpy(p))
    ctl = ft.control_params(d, torch.from_numpy(pitch), torch.from_numpy(vel), SR)
    n = ft.samples_per_render(TOTAL, SR)
    return ctl, ft.control_pass(ctl, n // ft.BLOCK, int(NOTE_ON * SR), SR)


def test_control_pass_matches_jax():
    """Amplitudes and pitch factor within 1e-5 of fm_jax's scans, the
    increments within 1e-5 relative; the per-sample phases built from the
    per-tick phase starts within 1e-4 cycles: a start is the sum of the
    ticks' increments before it, so the pitch factor's f32 noise (the two
    frameworks' exp2 differ in the last bit) adds up over the 128 ticks."""
    p = mixed_presets()
    pitch, vel = notes(len(p))
    amps, pf, phases, inc = _jax_control(p, pitch, vel)
    ctl, (g_amps, g_pf, g_starts, g_incs) = _port_control(p, pitch, vel)
    assert ctl.shape == (len(p), ft.CTL_WIDTH)
    assert g_amps.shape == amps.shape == (N_SHORT // 32, len(p), 6)
    np.testing.assert_allclose(g_amps.numpy(), amps, atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_pf.numpy(), pf, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(g_incs.numpy(), inc, atol=0, rtol=1e-5)
    np.testing.assert_allclose(ft.sample_phases(g_starts, g_incs).numpy(), phases, atol=1e-4,
                               rtol=0)
    assert float(amps.max()) > 0.1 and float(np.abs(np.diff(pf, axis=0)).max()) > 1e-3


def test_sample_and_hold_draws_the_jax_sequence():
    """The plain version's int64 LCG masked to 32 bits draws, bit for bit,
    the uint32 sequence fm_jax draws (fm_jax.py:313-316), over 20,000
    steps, and the S&H values made from it are equal."""
    n = 20000
    state = np.uint32(ft.SH_SEED)
    ref = np.empty(n, dtype=np.uint32)
    jstate = jnp.uint32(ft.SH_SEED)
    jref = []
    with np.errstate(over="ignore"):
        for k in range(n):
            state = state * np.uint32(1664525) + np.uint32(1013904223)
            ref[k] = state
    step = jax.jit(lambda r: r * jnp.uint32(1664525) + jnp.uint32(1013904223))
    for _ in range(64):
        jstate = step(jstate)
        jref.append(int(jstate))
    got = torch.full((1,), ft.SH_SEED, dtype=torch.int64)
    seq = []
    for _ in range(n):
        got = (got * 1664525 + 1013904223) & 0xFFFFFFFF
        seq.append(int(got))
    assert seq == ref.astype(np.int64).tolist() and seq[:64] == jref
    sh_port = (torch.tensor(seq) >> 8).float() / 8388608.0 - 1.0
    sh_jax = np.asarray((jnp.asarray(ref) >> 8).astype(jnp.float32) / 8388608.0 - 1.0)
    np.testing.assert_array_equal(sh_port.numpy(), sh_jax)


def test_sample_and_hold_control_matches_jax():
    """Wave 5 through the whole control pass: the pitch factor follows the
    held values within 1e-5, with several draws inside the render."""
    p = mixed_presets()[::2]  # the S&H rows
    assert np.all(p[:, 12] == 1.0)
    pitch, vel = notes(len(p))
    _, pf, _, _ = _jax_control(p, pitch, vel)
    _, (_, g_pf, _, _) = _port_control(p, pitch, vel)
    np.testing.assert_allclose(g_pf.numpy(), pf, atol=1e-5, rtol=1e-5)
    assert len(np.unique(np.round(pf[:, 1], 6))) >= 4  # three draws at least


@pytest.mark.parametrize("feedback", ["exact", "unrolled"])
def test_render_matches_jax(feedback):
    """Max |err| <= 1e-4 on presets with feedback 0; MAE <= 1e-3 over all,
    where the feedback recurrence amplifies f32 noise."""
    p = mixed_presets()
    pitch, vel = notes(len(p))
    want = np.asarray(fm_jax.render_batch(jnp.asarray(p), jnp.asarray(pitch), jnp.asarray(vel),
                                          note_on_s=NOTE_ON, total_s=TOTAL, sample_rate=SR,
                                          feedback=feedback))
    got = ft.render_batch(torch.from_numpy(p), pitch, vel, note_on_s=NOTE_ON, total_s=TOTAL,
                          sample_rate=SR, feedback=feedback)
    assert got.dtype == torch.float32 and got.shape == want.shape == (len(p), N_SHORT)
    got = got.numpy()
    no_fb = p[:, 5] == 0
    assert no_fb.sum() >= 5 and (~no_fb).sum() >= 5
    assert float(np.abs(got - want)[no_fb].max()) <= 1e-4
    assert float(np.abs(got - want).mean()) <= 1e-3
    assert float(np.abs(want).max()) > 0.1


def test_render_contract():
    """N rounds up to the 512-sample engine block; |w| <= 1; the fade-out
    ends on an exact zero; the same call gives the same audio."""
    p = mixed_presets(4)
    pitch, vel = notes(4)
    out = ft.render_batch(torch.from_numpy(p), pitch, vel, note_on_s=0.02, total_s=0.05,
                          sample_rate=SR, feedback="exact")
    assert out.shape == (4, 1536) == (4, ft.samples_per_render(0.05, SR))
    assert float(out.abs().max()) <= 1.0 and torch.all(out[:, -1] == 0.0)
    again = ft.render_batch(torch.from_numpy(p), pitch, vel, note_on_s=0.02, total_s=0.05,
                            sample_rate=SR, feedback="exact")
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="feedback"):
        ft.render_batch(torch.from_numpy(p), pitch, vel, feedback="iterative")


def test_unrolled_gradient_matches_jax():
    """d mean(w^2) / d presets of a two-preset unrolled render (1,024
    samples, fb_iters 2) against jax.grad: within 1e-3 of the largest
    entry, straight-through estimators included."""
    p = mixed_presets(2, seed=5)
    pitch, vel = notes(2)
    kw = dict(note_on_s=0.02, total_s=1024 / SR, sample_rate=SR, feedback="unrolled", fb_iters=2)

    def jloss(x):
        return jnp.mean(jnp.square(fm_jax.render_batch(x, jnp.asarray(pitch), jnp.asarray(vel),
                                                       **kw)))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(p)))
    x = torch.from_numpy(p).requires_grad_(True)
    torch.mean(torch.square(ft.render_batch(x, pitch, vel, **kw))).backward()
    got = x.grad.numpy()
    scale = float(np.abs(want).max())
    assert scale > 0 and np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= 1e-3 * scale
    lvl_cols = [23 + 22 * op + 8 for op in range(6)]
    assert float(np.abs(got[:, lvl_cols]).max()) > 0.0


def test_algorithm_tables_match_jax_and_the_kernel_rows():
    for name in ("ALGO_ADJ", "ALGO_CARRIER", "ALGO_FB_SRC", "ALGO_FB_DST", "ALGO_MOD_DEPTH"):
        np.testing.assert_array_equal(getattr(ft, name), getattr(fm_jax, name), err_msg=name)
    rows = ft.algorithm_rows()
    assert rows.shape == (32, ft.ALG_COLUMNS["WIDTH"])
    for a in range(32):
        for i in range(6):
            assert [(rows[a, i] >> m) & 1 for m in range(6)] == ft.ALGO_ADJ[a, i].tolist()
        assert [(rows[a, 6] >> i) & 1 for i in range(6)] == ft.ALGO_CARRIER[a].tolist()
        assert (rows[a, 7], rows[a, 8]) == (ft.ALGO_FB_SRC[a], ft.ALGO_FB_DST[a])
        n = rows[a, ft.ALG_LOOP_LEN]
        loop = rows[a, ft.ALG_LOOP_OPS:ft.ALG_LOOP_OPS + 3].tolist()
        assert loop[n:] == [-1] * (3 - n)
        assert rows[a, ft.ALG_LOOP_MASK] == sum(1 << i for i in loop[:n])


def loop_of(a):
    """Algorithm ``a``'s feedback loop read straight from fm_torch's tables:
    the operators on a modulation path from the destination down to the
    source, both included (edges run from higher to lower operators)."""
    src, dst = int(ft.ALGO_FB_SRC[a]), int(ft.ALGO_FB_DST[a])
    reach = {src}
    for x in range(src + 1, dst + 1):
        if any(ft.ALGO_ADJ[a, c, x] for c in reach):
            reach.add(x)
    down = {dst}
    for x in range(dst - 1, src - 1, -1):
        if any(ft.ALGO_ADJ[a, x, m] for m in down):
            down.add(x)
    return sorted(reach & down, reverse=True)


@pytest.mark.parametrize("a", range(32), ids=lambda a: f"algorithm{a + 1}")
def test_feedback_loop_is_a_chain_only_its_source_leaves(a):
    """The three properties that let F2 run only the feedback loop sample
    after sample: the loop is one modulation chain from the destination
    down to the source; no operator outside it modulates it; only the
    source's output leaves it (as a modulator or a carrier). Loop lengths
    over the 32 algorithms: 1 in 30, 2 in algorithm 6, 3 in algorithm 4."""
    loop = loop_of(a)
    adj, car = ft.ALGO_ADJ[a], ft.ALGO_CARRIER[a]
    assert loop[0] == ft.ALGO_FB_DST[a] and loop[-1] == ft.ALGO_FB_SRC[a]
    for hi, lo in zip(loop, loop[1:]):
        assert np.flatnonzero(adj[lo]).tolist() == [hi]  # a chain, fed from inside only
    assert not adj[loop[0]].any()
    for op in loop[:-1]:
        assert not car[op] and np.flatnonzero(adj[:, op]).tolist() == [loop[loop.index(op) + 1]]
    assert ft.feedback_loop(adj, car, int(ft.ALGO_FB_SRC[a]), int(ft.ALGO_FB_DST[a])) == loop
    assert len(loop) == {3: 3, 5: 2}.get(a, 1)


class _FakeFn:
    def __init__(self, ret):
        self.ret, self.restype, self.argtypes = ret, None, None

    def __call__(self, *args):
        return self.ret


def _fake_library(monkeypatch):
    """Stubs the nvcc build and the ctypes load: ``_fm_library`` then binds a
    stand-in whose entry points record their argtypes."""
    names = re.findall(r"^int (fm_\w+)\(", ft.FM_SOURCE.read_text(), flags=re.M)
    ret = {"fm_ctl_width": ft.CTL_WIDTH, "fm_alg_width": ft.ALG_COLUMNS["WIDTH"]}
    lib = type("FakeLib", (), {})()
    for name in names:
        setattr(lib, name, _FakeFn(ret.get(name, 0)))
    built = []
    monkeypatch.setattr(ft._native, "build_shared_library", lambda *a: built.append(a) or "x.so")
    monkeypatch.setattr(ft.ctypes, "CDLL", lambda path: lib)
    return lib, built


@pytest.mark.parametrize("broken", ["outside_modulator", "not_a_chain", "leaves_the_loop"])
def test_loader_refuses_a_table_whose_loop_f2_cannot_split(monkeypatch, broken):
    """The loader checks the three properties before it builds anything: a
    table patched to break one raises ValueError and builds nothing."""
    adj, car = ft.ALGO_ADJ.copy(), ft.ALGO_CARRIER.copy()
    if broken == "outside_modulator":  # algorithm 2: operator 3 modulates the loop's operator 2
        adj[1, 1, 2] = 1.0
        match = "outside the loop modulates operator 2"
    elif broken == "not_a_chain":  # algorithm 4: the chain 6->5->4 loses its edge 5->4
        adj[3, 3, 4] = 0.0
        match = "not a single chain at operator 5"
    else:  # algorithm 4: operator 5, inside the loop, becomes a carrier
        car[3, 4] = 1.0
        match = "operator 5's output leaves the loop"
    _, built = _fake_library(monkeypatch)
    monkeypatch.setattr(ft, "ALGO_ADJ", adj)
    monkeypatch.setattr(ft, "ALGO_CARRIER", car)
    with pytest.raises(ValueError, match=match):
        ft._fm_library.__wrapped__()
    assert built == []


def test_kernel_source_reads_the_python_layout():
    """F1 and F1b read the packed control row at the offsets of
    ``CTL_FIELDS``, F2 the algorithm rows at the columns of
    ``ALG_COLUMNS``; F1's tape for F1b is a float2 for each of F1's lanes,
    as ``tape_bytes`` counts it, F1's launcher writes it only when it is
    given one and F1b's walk reads it as such; F1b's chunk summaries and
    F2b's split limit are the Python side's; F2's feed-forward launcher
    reads the loop's output from a tape only when it is given one; the
    constants of csrc/fm_render.cu are the plain version's floats."""
    src = ft.FM_SOURCE.read_text()
    defines = dict(re.findall(r"#define (CTL_\w+) (\d+)", src))
    want = {f"CTL_{name.upper()}": str(off) for name, off in ft.CTL_OFFSETS.items()}
    want["CTL_WIDTH"] = str(ft.CTL_WIDTH)
    assert defines == want
    alg = dict(re.findall(r"#define ALG_(\w+) (\d+)", src))
    assert alg == {k: str(v) for k, v in ft.ALG_COLUMNS.items()}
    consts = dict(re.findall(r"#define (\w+_F) ([0-9.]+)f", src))
    assert np.float32(consts["TWO_PI_F"]) == np.float32(ft.TWO_PI)
    assert np.float32(consts["MOD_SCALE_F"]) == np.float32(ft.MOD_SCALE)
    assert f"#define SH_SEED {hex(ft.SH_SEED)}u" in src
    assert re.search(r"#define F1_LANES (\d+)", src).group(1) == str(ft.F1_LANES)
    assert ft.TAPE_LANE_BYTES == 8 and "float2* __restrict__ tape" in src
    f1 = src.split("int fm_control_launch(")[1].split("\n}")[0]
    assert "if (tape)" in f1 and "<true>" in f1 and "<false>" in f1 and "nullptr);" in f1
    assert "reinterpret_cast<float2*>(tape)" in f1
    chunks = src.split("int fm_control_bwd_chunks_launch(")[1].split("\n}")[0]
    assert "reinterpret_cast<const float2*>(tape)" in chunks
    assert re.search(r"#define F1B_SUM (\d+)", src).group(1) == str(ft.F1B_SUM)
    assert re.search(r"#define MAX_SPLITS (\d+)", src).group(1) == str(ft.EXACT_BWD_MAX_SPLITS)
    ff = src.split("int fm_exact_ff_launch(")[1].split("\n}")[0]
    assert "if (tape)" in ff and "<true>" in ff and "<false>" in ff and "nullptr, out" in ff


def test_kernel_events_record_each_launch_inside_only(monkeypatch):
    """``kernel_events`` yields a (name, start, stop) pair of events for each
    F1b or F2b kernel launched inside it, recorded just before and just
    after the launch; a nested block gets its own list and the outer one
    comes back after it; a launch outside records nothing; every launch
    counts once either way."""
    lib, _ = _fake_library(monkeypatch)
    monkeypatch.setattr(ft, "_fm_library", lambda: lib)
    recorded = []

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            recorded.append(self)

    monkeypatch.setattr(ft.torch.cuda, "Event", Event)
    monkeypatch.setattr(ft.torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    before = dict(ft.LAUNCHES)
    ft._launch("fm_exact_bwd_seams", 1, 1, 1)
    with ft.kernel_events() as outer:
        ft._launch("fm_control_bwd_starts", 0)
        with ft.kernel_events() as inner:
            ft._launch("fm_exact_bwd_ff", 0)
        ft._launch("fm_control_bwd_combine", 0)
    assert ft._event_sink is None
    assert [m[0] for m in outer] == ["fm_control_bwd_starts", "fm_control_bwd_combine"]
    assert [m[0] for m in inner] == ["fm_exact_bwd_ff"]
    assert recorded == [e for m in (outer[0], inner[0], outer[1]) for e in m[1:]]
    assert {k: ft.LAUNCHES[k] - before[k] for k in before if ft.LAUNCHES[k] != before[k]} == {
        "fm_exact_bwd_seams": 1, "fm_control_bwd_starts": 1, "fm_exact_bwd_ff": 1,
        "fm_control_bwd_combine": 1}


def test_kernel_build_command(monkeypatch):
    """nvcc for sm_90a without fast math and without multiply-add
    contraction; every C entry point of the source is bound with as many
    argtypes as it has parameters, and the kernels' launchers are F1's,
    F1b's three, F2's two phases' and F2b's three."""
    cmd = ft.fm_build_command()
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd and "-fmad=false" in cmd
    assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
    src = ft.FM_SOURCE.read_text()
    params = {name: len([a for a in args.split(",") if a.strip()]) for name, args in
              re.findall(r"^int (fm_\w+)\(([^)]*)\)", src, flags=re.M)}
    assert sorted(n for n in params if n.endswith("_launch")) == [
        "fm_control_bwd_chunks_launch", "fm_control_bwd_combine_launch",
        "fm_control_bwd_starts_launch", "fm_control_launch", "fm_exact_bwd_ff_launch",
        "fm_exact_bwd_loop_launch", "fm_exact_bwd_seams_launch", "fm_exact_ff_launch",
        "fm_fb_loop_launch"]
    lib, built = _fake_library(monkeypatch)
    assert ft._fm_library.__wrapped__() is lib and len(built) == 1
    assert built[0][1] == cmd and built[0][2] == [ft.FM_SOURCE]
    for name, n in params.items():
        assert len(getattr(lib, name).argtypes) == n, name


@pytest.mark.parametrize("seed", [0, 3])
def test_loop_and_feedforward_passes_make_the_exact_pass(seed):
    """F2's two phases in their plain versions: the loop pass (only the
    loop's operators, sample after sample) and the feed-forward pass (all
    other operators, vectorized over samples) give ``exact_pass``'s carrier
    sum within 1e-6 on every item, feedback-7 items included (measured on
    the CPU: 2.4e-7): the loop pass carries the same floats as the exact
    loop, so even a chaotic item does not part."""
    p = mixed_presets(32, seed=seed)
    pitch, vel = notes(len(p))
    d = ft.decode_presets(torch.from_numpy(p))
    ctl = ft.control_params(d, torch.from_numpy(pitch), torch.from_numpy(vel), SR)
    amps, _, starts, incs = ft.control_pass(ctl, 2048 // ft.BLOCK, int(0.05 * SR), SR)
    alg, fb_amt = d["algorithm"].to(torch.int32), ft.feedback_amount(d)
    phases, amps_s = ft.sample_phases(starts, incs), ft.upsample_amps(amps)
    want = ft.exact_pass(phases, amps_s, alg, fb_amt)
    loop = ft.feedback_loop_pass(phases, amps_s, alg, fb_amt)
    got = ft.feedforward_pass(phases, amps_s, alg, fb_amt, loop)
    on = fb_amt != 0
    assert 10 <= int(on.sum()) < len(p)
    assert torch.all(loop[~on] == 0.0) and float(loop[on].abs().max()) > 0.1
    assert float((got - want).abs().max()) <= 1e-6
    assert float(want.abs().max()) > 0.1


def test_wrappers_take_the_plain_path_only_on_the_cpu(monkeypatch):
    """A CPU tensor never builds or launches a kernel; the kernels' wrappers
    refuse CPU tensors instead of running the plain loops."""
    def no_build():
        raise AssertionError("built a kernel for a CPU tensor")

    monkeypatch.setattr(ft, "_fm_library", no_build)
    before = dict(ft.LAUNCHES)
    p = mixed_presets(2)
    ft.render_batch(torch.from_numpy(p), [60, 60], [85, 85], total_s=0.03, feedback="exact")
    assert ft.LAUNCHES == before
    ctl = torch.zeros((2, ft.CTL_WIDTH))
    with pytest.raises(ValueError, match="card"):
        ft.fm_control(ctl, 4, 0, SR)
    z = torch.zeros((4, 2, 6))
    per_item = (torch.zeros(2, dtype=torch.int32), *torch.zeros((3, 2)))
    with pytest.raises(ValueError, match="card"):
        ft.fm_exact(z, z, z, *per_item, SR)
    with pytest.raises(ValueError, match="card"):
        ft.fm_fb_loop(z, z, z, *per_item[:2])
    with pytest.raises(ValueError, match="card"):
        ft.fm_exact_ff(torch.zeros((2, 128)), z, z, z, *per_item, SR)


def loop_length_presets() -> np.ndarray:
    """Six items, one for each feedback-loop length 1, 2 and 3 (algorithms
    1, 6 and 4) at feedback 0 (no loop runs) and at feedback 7."""
    p = mixed_presets(6, seed=7)
    p[:, 4] = np.repeat(np.array([0, 5, 3]) / 31.0, 2)
    p[:, 5] = np.tile([0.0, 1.0], 3)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("feedback", ["exact", "unrolled"])
def test_kernels_match_plain_on_card(feedback):
    """On the card, 16 mixed items and six items with feedback loops of 1,
    2 and 3 operators at feedback 0 and 7, 4,096 samples: F1 against
    control_pass within 1e-5 (phase starts 1e-4); F2 on F1's outputs
    against the plain exact loop on the same inputs within 1e-4 on every
    item (the same f32 operations, so even a chaotic feedback-7 item
    agrees), its loop phase against ``feedback_loop_pass`` and its
    feed-forward phase against ``feedforward_pass`` likewise; end to end,
    max |err| <= 1e-4 without feedback; one launch of each kernel. A render
    of an input that requires a gradient launches F1 and then F1b once,
    and ``'exact'`` F2 and F2b once too; its gradient is the plain path's
    within 1e-3 of the largest entry (``'exact'``: on the items below
    feedback 7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    p = torch.from_numpy(np.concatenate([mixed_presets(), loop_length_presets()])).cuda()
    pitch, vel = notes(len(p))
    d = ft.decode_presets(p)
    ctl = ft.control_params(d, torch.from_numpy(pitch).cuda(), torch.from_numpy(vel).cuda(), SR)
    T = N_SHORT // ft.BLOCK
    got = ft.fm_control(ctl, T, int(NOTE_ON * SR), SR)
    want = ft.control_pass(ctl, T, int(NOTE_ON * SR), SR)
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 1e-4, 1e-5)):
        torch.testing.assert_close(g, w, atol=tol, rtol=1e-5)
    amps, _, starts, incs = got
    alg, fb_amt = d["algorithm"].to(torch.int32), ft.feedback_amount(d)
    nc = ft._clip(torch.from_numpy(ft.ALGO_CARRIER).cuda()[alg.long()].sum(-1), lo=1.0)
    mv = d["master_volume"]
    assert set(ft.loop_lengths(alg, fb_amt).tolist()) == {0, 1, 2, 3}
    n0 = dict(ft.LAUNCHES)
    f2 = ft.fm_exact(amps, starts, incs, alg, fb_amt, nc, mv, SR)
    n_seg = len(ft.exact_segments(T))
    none = dict.fromkeys(n0, 0)
    assert n_seg == 8 and {k: ft.LAUNCHES[k] - n0[k] for k in n0} == dict(
        none, fm_exact=1, fm_fb_loop=n_seg, fm_exact_ff=n_seg)
    phases, amps_s = ft.sample_phases(starts, incs), ft.upsample_amps(amps)
    plain = ft.fade_and_volume(ft.exact_pass(phases, amps_s, alg, fb_amt), nc, mv, SR)
    assert float((f2 - plain).abs().max()) <= 1e-4
    on = fb_amt != 0
    loop_ref = ft.feedback_loop_pass(phases, amps_s, alg, fb_amt)
    loop = ft.fm_fb_loop(amps, starts, incs, alg, fb_amt)
    assert float((loop - loop_ref)[on].abs().max()) <= 1e-4
    ff = ft.fm_exact_ff(loop_ref.clone(), amps, starts, incs, alg, fb_amt, nc, mv, SR)
    ff_ref = ft.fade_and_volume(ft.feedforward_pass(phases, amps_s, alg, fb_amt, loop_ref), nc,
                                mv, SR)
    assert float((ff - ff_ref).abs().max()) <= 1e-4
    n0 = dict(ft.LAUNCHES)
    out = ft.render_batch(p, pitch, vel, note_on_s=NOTE_ON, total_s=TOTAL, sample_rate=SR,
                          feedback=feedback)
    ref = ft.plain_render(p, pitch, vel, note_on_s=NOTE_ON, total_s=TOTAL, sample_rate=SR,
                          feedback=feedback)
    torch.cuda.synchronize()
    exact = feedback == "exact"
    assert {k: ft.LAUNCHES[k] - n0[k] for k in n0} == dict(
        none, fm_control=1, fm_exact=exact, fm_fb_loop=exact * n_seg,
        fm_exact_ff=exact * n_seg)
    no_fb = p[:, 5] == 0
    assert float((out - ref).abs()[no_fb].max()) <= 1e-4
    kw = dict(note_on_s=0.02, total_s=1024 / SR, sample_rate=SR, feedback=feedback)
    grads, launches = [], []
    for fn in (ft.render_batch, ft.plain_render):
        x = p.clone().requires_grad_(True)
        n0 = dict(ft.LAUNCHES)
        torch.mean(torch.square(fn(x, pitch, vel, **kw))).backward()
        torch.cuda.synchronize()
        grads.append(x.grad)
        launches.append({k: ft.LAUNCHES[k] - n0[k] for k in n0})
    seg = len(ft.exact_segments(1024 // ft.BLOCK))
    f2 = dict(fm_exact=1, fm_fb_loop=seg, fm_exact_ff=seg, fm_exact_bwd=1,
              **dict.fromkeys(ft.F2B_KERNELS, 1)) if exact else {}
    assert launches == [dict(none, fm_control=1, fm_control_bwd=1,
                             **dict.fromkeys(ft.F1B_KERNELS, 1), **f2), none]
    # 'exact': a loud feedback-7 loop is chaotic, and F1's last bits part
    # the two renders' trajectories there; each item's row is its own
    rows = torch.round(p[:, 5] * 7) < 7 if exact else torch.ones_like(p[:, 5], dtype=torch.bool)
    scale = float(grads[1][rows].abs().max())
    assert scale > 0 and float((grads[0] - grads[1])[rows].abs().max()) <= 1e-3 * scale
