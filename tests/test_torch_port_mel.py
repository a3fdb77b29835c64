"""The port's log-mel frontend (K1's plain version and wrapper) and DX7
render binding against the JAX package, on the same seeded inputs.

Tolerances: 0.05 dB for f32 paths (the JAX package's own Pallas-vs-XLA
bar, tests/test_pallas_mel.py); 1 dB above -60 dB for bf16 'fast' inputs.
The CUDA kernel itself only runs on the card (marked ``cuda``); its host
tables, its mel runs and, in ``_kernel_emulation``, its decomposition (tiles,
packing, radix-8 passes, split, sparse mel) are checked here on the CPU."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.ops.pallas_mel import PallasSpectrogramProcessor
from preset_gen_vae_tpu.ops.spectrogram import SpectrogramConfig as JaxSpecConfig
from preset_gen_vae_tpu.ops.spectrogram import SpectrogramProcessor as JaxSpec
from preset_gen_vae_tpu.synth.render import DexedRenderer as JaxRenderer
from preset_gen_vae_tpu_torch.ops import spectrogram as sp
from preset_gen_vae_tpu_torch.synth import database as port_db
from preset_gen_vae_tpu_torch.synth.render import DexedRenderer


def _wave(shape, seed=7):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("n_mel_bins", [257, -1])
def test_plain_logmel_matches_jax(n_mel_bins):
    x = _wave((2, 88576))
    ref = np.asarray(JaxSpec(JaxSpecConfig(n_mel_bins=n_mel_bins))(jnp.asarray(x)))
    proc = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=n_mel_bins), device="cpu")
    got = proc(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, n_mel_bins if n_mel_bins > 0 else 513, 347)
    np.testing.assert_allclose(got, ref, atol=5e-2)


def test_partial_tile_matches_pallas_interpret():
    """A (1, 22016) waveform gives T=87 frames: with tile_t=100 the Pallas
    kernel's only tile is partial."""
    x = _wave((1, 22016), seed=3)
    pal = PallasSpectrogramProcessor(JaxSpecConfig(n_mel_bins=257), tile_t=100,
                                     interpret=True)
    ref = np.asarray(pal(jnp.asarray(x)))
    got = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=257),
                                  device="cpu")(torch.from_numpy(x))
    assert got.shape == ref.shape == (1, 257, 87)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-2)


@pytest.mark.parametrize("n_mel_bins", [257, -1])
def test_fast_within_1db_of_exact(n_mel_bins):
    x = torch.from_numpy(_wave((2, 22016), seed=5))
    c = sp.SpectrogramConfig(n_mel_bins=n_mel_bins)
    exact = sp.SpectrogramProcessor(c, device="cpu")(x)
    fast = sp.SpectrogramProcessor(c, device="cpu", precision="fast")(x)
    loud = exact > -60.0
    assert loud.float().mean() > 0.5
    assert float((fast - exact).abs()[loud].max()) < 1.0


def test_wrapper_runs_plain_only_for_cpu_tensors():
    proc = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=64), device="cpu")
    x = torch.from_numpy(_wave((1, 4096)))
    before = dict(sp.LAUNCHES)
    assert torch.equal(proc(x), proc.plain(x))
    assert sp.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError):
        proc(x.to("meta"))


def test_processor_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=257))


def _within_f32_ulps(got, want, ulps):
    """|got - want| <= ulps f32 spacings at |want| (exact where want is 0)."""
    spacing = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    return bool(np.all(np.abs(got.astype(np.float64) - want) <= ulps * spacing))


def test_fft_tables_match_float64():
    win64 = np.hanning(1024) / np.abs(np.fft.rfft(np.hanning(1024))).max()
    tw64 = np.exp(-2j * np.pi * np.arange(512) / 512)
    post64 = np.exp(-2j * np.pi * np.arange(513) / 1024)
    for dtype, max_ulp in ((np.float32, 1.0), (np.float64, 1e-6)):
        win, tw, post = sp.fft_tables(1024, dtype)
        assert win.dtype == tw.dtype == post.dtype == dtype
        assert win.shape == (1024,) and tw.shape == (512, 2) and post.shape == (513, 2)
        for got, want in ((win, win64), (tw[:, 0], tw64.real), (tw[:, 1], tw64.imag),
                          (post[:, 0], post64.real), (post[:, 1], post64.imag)):
            assert _within_f32_ulps(got, want, max_ulp)
    exact = sp.SpectrogramProcessor(sp.SpectrogramConfig(), device="cpu")
    fast = sp.SpectrogramProcessor(sp.SpectrogramConfig(), device="cpu", precision="fast")
    assert exact.window.dtype == torch.float64 and fast.window.dtype == torch.float32


def test_mel_runs_rebuild_the_filterbank():
    proc = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=257), device="cpu")
    fb = proc.mel_fb.numpy()
    start, length, weights = sp.mel_runs(fb)
    assert length.sum() == weights.size == np.count_nonzero(fb) == 1016
    assert length.min() >= 1 and length.max() <= 14
    off = np.concatenate([[0], np.cumsum(length)])
    dense = np.zeros_like(fb)
    for m in range(fb.shape[1]):
        dense[start[m]:start[m] + length[m], m] = weights[off[m]:off[m + 1]]
    assert np.array_equal(dense, fb)
    assert np.array_equal(proc.mel_off.numpy(), off) and np.array_equal(proc.mel_start.numpy(), start)


def test_mel_runs_raise_on_a_split_filter(monkeypatch):
    fb = np.zeros((3, 513), dtype=np.float32)  # (n_mels, n_bins), as mel_filterbank gives
    fb[0, 2:5] = 1.0
    fb[1, [7, 9]] = 0.5  # bins 7 and 9 but not 8
    fb[2, 10] = 1.0
    with pytest.raises(ValueError, match="filter 1"):
        sp.mel_runs(fb.T)
    monkeypatch.setattr(sp, "mel_filterbank", lambda *args, **kwargs: fb)
    with pytest.raises(ValueError, match="filter 1"):
        sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=3), device="cpu")


def _fft8(v):
    """The kernel's in-register 8-point DFT (fft8 in csrc/logmel.cu) on the
    last axis: three radix-2 stages, then bit-reversed to natural order."""
    v = list(v.unbind(-1))
    h = 0.70710678118654752440

    def bfly(a, b):
        v[a], v[b] = v[a] + v[b], v[a] - v[b]

    for a in range(4):
        bfly(a, a + 4)
    v[5] = torch.complex((v[5].real + v[5].imag) * h, (v[5].imag - v[5].real) * h)
    v[6] = v[6] * -1j
    v[7] = torch.complex((v[7].imag - v[7].real) * h, -(v[7].real + v[7].imag) * h)
    for a, b in ((0, 2), (1, 3), (4, 6), (5, 7)):
        bfly(a, b)
    v[3], v[7] = v[3] * -1j, v[7] * -1j
    for a, b in ((0, 1), (2, 3), (4, 5), (6, 7)):
        bfly(a, b)
    return torch.stack([v[0], v[4], v[2], v[6], v[1], v[5], v[3], v[7]], dim=-1)


def _kernel_emulation(proc, x, dtype=torch.float64, twiddles="powers"):
    """K1's exact-mode decomposition in torch, index for index: tiles of 16
    frames read from a zero-filled waveform span; z[n] = xw[2n] + i xw[2n+1];
    three radix-8 Stockham passes (point j + 64r times t^r, t = W_{8Ns}^(j % Ns)
    from the host table, written to (j // Ns) 8Ns + j % Ns + r Ns); the split
    with the host's split twiddles; |X|^2 rounded to f32; mel sums over each
    filter's run in f32; the dB tile written with the partial tile masked.
    ``dtype`` is the FFT's working precision (the kernel's exact mode: f64).
    ``twiddles="powers"`` makes t^r by products, as the kernel does;
    ``"table"`` reads each point's twiddle W_{8Ns}^(r (j % Ns)) from the table."""
    TT, NZ, GT = 16, 512, 64
    B, S = x.shape
    hop, T = proc.hop, sp.num_frames(S, 1024, proc.hop)
    win, tw, post = (t.to(dtype) for t in (proc.window.view(NZ, 2), proc.twiddles,
                                           proc.split_twiddles))
    tw = torch.complex(tw[:, 0], tw[:, 1])
    post = torch.complex(post[:, 0], post[:, 1])
    j, r, n, k = torch.arange(GT), torch.arange(8), torch.arange(NZ), torch.arange(NZ + 1)
    span = (TT - 1) * hop + 1024
    out = torch.full((B, proc.n_out, T), float("nan"))
    for t0 in range(0, T, TT):
        s = t0 * hop - 512 + torch.arange(span)
        wav = torch.where((s >= 0) & (s < S), x[:, s.clamp(0, S - 1)], torch.zeros(()))
        at = torch.arange(min(TT, T - t0))[:, None] * hop + 2 * n  # (frames, NZ)
        z = torch.complex(wav[:, at].to(dtype) * win[:, 0], wav[:, at + 1].to(dtype) * win[:, 1])
        for ns in (1, 8, 64):
            v = z[..., j[:, None] + GT * r]  # (B, frames, 64, 8)
            if twiddles == "table":
                v = v * tw[((j[:, None] % ns) * (NZ // (8 * ns)) * r) % NZ]
            else:
                t = tw[(j % ns) * (NZ // (8 * ns))][:, None]
                powers = [torch.ones_like(t)]
                for _ in range(7):
                    powers.append(powers[-1] * t)  # t^r by products, as the kernel does
                v = v * torch.cat(powers, dim=-1)
            dst = (j[:, None] // ns) * ns * 8 + j[:, None] % ns + r * ns
            z = torch.empty_like(z)
            z[..., dst] = _fft8(v)
        a, m = z[..., k % NZ], z[..., (NZ - k) % NZ].conj()
        X = 0.5 * (a + m) - 1j * post * (0.5 * (a - m))
        mag = torch.sqrt((X.real * X.real + X.imag * X.imag).float())  # (B, frames, 513)
        if proc.use_mel:
            start, off, w = proc.mel_start, proc.mel_off, proc.mel_w
            acc = torch.zeros(mag.shape[:2] + (proc.n_out,))
            for i in range(int((off[1:] - off[:-1]).max())):
                live = off[:-1] + i < off[1:]
                wi = torch.where(live, w[(off[:-1] + i).clamp(max=w.numel() - 1)], 0.0)
                acc = acc + mag[..., (start + i).clamp(max=NZ)] * wi
            mag = acc
        out[:, :, t0:t0 + TT] = proc.linear_to_log_scale(mag).transpose(-1, -2)
    return out


@pytest.mark.parametrize("n_mel_bins", [257, -1])
@pytest.mark.parametrize("source", ["noise", "rendered"])
def test_kernel_decomposition_matches_plain(n_mel_bins, source):
    """The emulation holds the plain version at 0.05 dB (on rendered notes
    wherever plain is above -100 dB, where f32 rounding in plain itself
    stays below 0.01 dB) and, on rendered notes, a float64 rFFT witness at
    0.01 dB over every bin."""
    if source == "noise":
        x = _wave((2, 22016), seed=11)  # T = 87: the last of 6 tiles is partial
    else:
        presets, _, _ = port_db.generate_structured_corpus(2, seed=0)
        x = DexedRenderer().render_batch(presets, [60, 60], [85, 85])
    proc = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=n_mel_bins), device="cpu")
    got = _kernel_emulation(proc, torch.from_numpy(x))
    ref = proc.plain(torch.from_numpy(x))
    assert got.shape == ref.shape and torch.isfinite(got).all()
    sel = ref > (-100.0 if source == "rendered" else -1e9)
    assert float((got - ref).abs()[sel].max()) < 0.05
    if source == "rendered":
        assert float((ref <= -119.99).float().mean()) > 0.3  # the spectra reach the floor
        assert np.abs(got.numpy() - _f64_witness(proc, x)).max() < 0.01


def _f64_witness(proc, x):
    """numpy's float64 rFFT of the same frames through the same window, mel
    and log floor: (B, n_out, T)."""
    frames = proc.frame(torch.from_numpy(x).double()).numpy()
    mag = np.abs(np.fft.rfft(frames * sp.fft_tables(1024, np.float64)[0], axis=-1))
    if proc.use_mel:
        mag = mag @ proc.mel_fb.numpy().astype(np.float64)
    return 20 * np.log10(np.maximum(mag, proc.floor_amp)).transpose(0, 2, 1)


@functools.lru_cache(maxsize=None)
def _witness_notes():
    """chip_smoke.py's witness inputs: the first 4 presets of the 64-preset
    structured corpus (seed 0), rendered at note (60, 85)."""
    presets, _, _ = port_db.generate_structured_corpus(64, seed=0)
    return DexedRenderer().render_batch(presets[:4], [60] * 4, [85] * 4)


@pytest.mark.parametrize("dtype,twiddles,passes", [
    (torch.float64, "powers", True),  # the kernel's exact mode
    (torch.float32, "powers", False),
    (torch.float32, "table", False),
], ids=["f64-powers", "f32-powers", "f32-table"])
def test_exact_mode_needs_an_f64_fft(dtype, twiddles, passes):
    """Why the kernel's exact mode runs its FFT in f64. chip_smoke.py holds
    the kernel, over every bin of its witness notes at mel 257, within
    max(2 x plain's error, 0.01 dB) of a float64 rFFT. The decomposition
    meets that in f64 and misses it in f32, whether the twiddles are powers
    of one table entry or read per point from the f32 table. Measured here:
    plain 2.03e-2 dB; f64 9.8e-6 dB; f32 1.00e-1 dB (powers), 7.00e-2 dB
    (table)."""
    x = _witness_notes()
    proc = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=257), device="cpu")
    witness = _f64_witness(proc, x)
    plain_err = np.abs(proc.plain(torch.from_numpy(x)).numpy() - witness).max()
    got = _kernel_emulation(proc, torch.from_numpy(x), dtype, twiddles)
    err = np.abs(got.numpy() - witness).max()
    assert (err <= max(2 * plain_err, 0.01)) == passes, (err, plain_err)


def test_kernel_build_command_targets_hopper():
    cmd = sp.logmel_build_command()
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd


@pytest.mark.cuda
@pytest.mark.parametrize("n_mel_bins,shape", [(257, (4, 88576)), (-1, (2, 88576)),
                                              (257, (3, 22016)), (257, "rendered")])
def test_kernel_matches_plain_on_card(n_mel_bins, shape):
    """Exact within 0.05 dB of plain (on rendered notes wherever plain is
    above -100 dB), fast within 1 dB above -60 dB."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    if shape == "rendered":
        presets, _, _ = port_db.generate_structured_corpus(8, seed=0)
        x = torch.from_numpy(DexedRenderer().render_batch(presets, [60] * 8, [85] * 8)).cuda()
    else:
        x = torch.from_numpy(_wave(shape)).cuda()
    for precision, tol in (("exact", 0.05), ("fast", 1.0)):
        proc = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=n_mel_bins),
                                       device="cuda", precision=precision)
        n0 = sp.LAUNCHES["logmel"]
        got, ref = proc(x), proc.plain(x)
        torch.cuda.synchronize()
        assert sp.LAUNCHES["logmel"] == n0 + 1
        floor = -60.0 if precision == "fast" else (-100.0 if shape == "rendered" else -1e9)
        sel = ref > floor
        assert float((got - ref).abs()[sel].max()) < tol


def test_renderer_matches_jax_binding():
    """The port builds the engine itself without -march=native; both
    bindings render the same presets to the same audio. The bound is 5e-4:
    under -ffast-math the two builds contract multiply-adds differently,
    which moves samples by up to ~1.2e-4 on this corpus."""
    presets, _, _ = port_db.generate_structured_corpus(4, seed=1)
    pitches, vels = [60] * 4, [85] * 4
    a = DexedRenderer().render_batch(presets, pitches, vels)
    b = JaxRenderer().render_batch(presets, pitches, vels)
    assert a.shape == b.shape == (4, 88576)
    assert np.abs(a).max() > 1e-2
    np.testing.assert_allclose(a, b, atol=5e-4)


def test_normalize_min_max_and_denormalize_match_jax():
    from preset_gen_vae_tpu.ops.spectrogram import denormalize as jax_denormalize
    from preset_gen_vae_tpu.ops.spectrogram import normalize_min_max as jax_normalize

    spec = np.random.default_rng(2).uniform(-120.0, 10.0, (3, 16, 9)).astype(np.float32)
    stats = {"min": float(spec.min()), "max": float(spec.max())}
    got = sp.normalize_min_max(torch.from_numpy(spec), (stats["min"], stats["max"]))
    want = np.asarray(jax_normalize(jnp.asarray(spec), (stats["min"], stats["max"])))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert float(got.min()) == pytest.approx(-1.0) and float(got.max()) == pytest.approx(1.0)
    back = sp.denormalize(got, "min_max", stats)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_denormalize(jnp.asarray(want),
                                                                        "min_max", stats)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(back.numpy(), spec, atol=1e-4)
