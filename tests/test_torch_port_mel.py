"""The port's log-mel frontend (K1's plain version and wrapper) and DX7
render binding against the JAX package, on the same seeded inputs.

Tolerances: 0.05 dB for f32 paths (the JAX package's own Pallas-vs-XLA
bar, tests/test_pallas_mel.py); 1 dB above -60 dB for bf16 'fast' inputs.
The CUDA kernel itself only runs on the card (marked ``cuda``)."""

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
    got = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=257))(torch.from_numpy(x))
    assert got.shape == ref.shape == (1, 257, 87)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-2)


@pytest.mark.parametrize("n_mel_bins", [257, -1])
def test_fast_within_1db_of_exact(n_mel_bins):
    x = torch.from_numpy(_wave((2, 22016), seed=5))
    c = sp.SpectrogramConfig(n_mel_bins=n_mel_bins)
    exact = sp.SpectrogramProcessor(c)(x)
    fast = sp.SpectrogramProcessor(c, precision="fast")(x)
    loud = exact > -60.0
    assert loud.float().mean() > 0.5
    assert float((fast - exact).abs()[loud].max()) < 1.0


def test_wrapper_runs_plain_only_for_cpu_tensors():
    proc = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=64))
    x = torch.from_numpy(_wave((1, 4096)))
    before = dict(sp.LAUNCHES)
    assert torch.equal(proc(x), proc.plain(x))
    assert sp.LAUNCHES == before  # the plain version is no launch
    with pytest.raises(ValueError):
        proc(x.to("meta"))


def test_kernel_build_command_targets_hopper():
    cmd = sp.logmel_build_command()
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd


@pytest.mark.cuda
@pytest.mark.parametrize("n_mel_bins,shape", [(257, (4, 88576)), (-1, (2, 88576)),
                                              (257, (3, 22016))])
def test_kernel_matches_plain_on_card(n_mel_bins, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.from_numpy(_wave(shape)).cuda()
    for precision, tol in (("exact", 0.05), ("fast", 1.0)):
        proc = sp.SpectrogramProcessor(sp.SpectrogramConfig(n_mel_bins=n_mel_bins),
                                       device="cuda", precision=precision)
        n0 = sp.LAUNCHES["logmel"]
        got, ref = proc(x), proc.plain(x)
        torch.cuda.synchronize()
        assert sp.LAUNCHES["logmel"] == n0 + 1
        sel = ref > (-60.0 if precision == "fast" else -1e9)
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
