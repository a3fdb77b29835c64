"""The port's disk corpus cache and the eval's ground-truth audio cache
against the JAX package's, on the CPU.

- The cache tag, directory and ``render_constraints.json`` sidecar equal
  the JAX package's, byte for byte, over the synthetic styles, a SQLite
  database, algorithm/operator/label subsets, the constraint flags, both
  render backends and a note duration given as a list (a config read from
  JSON); a sidecar written under other constraints raises in both.
- Caches are interchangeable: a cache written by JAX
  ``load_spectrogram_corpus`` is served by the port bit-equal to the JAX
  package's values, from the float16 tier and, with that tier deleted,
  from the raw tier alone; a cache written by the port is served by the
  JAX package bit-equal to the port's values, both ways again. Under
  ``'cpp'`` and ``'jax'``, ``'min_max'`` and ``'mean_std'``. The port's
  ``'cpp'`` stats are within 1e-6 relative of ``_compute_stats`` on the
  same raw tier (float64 sums against numpy's float32 ones).
- A warm reload renders nothing and serves the cold pass's corpus, bit for
  bit, in float32 and bfloat16; ``force_recompute`` renders again;
  ``'device'`` writes nothing; without a normalisation no float16 tier is
  written and the raw values are served.
- ``compute_and_store_spectrograms_stats``, ``generate_wav_files`` and
  ``utils/audio_io.py`` against the JAX package's.
- The GT-audio cache key is the JAX package's, and a ground-truth file the
  JAX package wrote is served by the port without a render.

Small sizes: 6 presets, two stacked notes of 0.2 s (the ``'jax'`` backend
with the unrolled feedback).
"""

import json
import wave

import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.data.dexed_dataset import DexedDataset as JaxDexedDataset
from preset_gen_vae_tpu.evaluation.evaluate import _gt_audio_cached as jax_gt_audio_cached
from preset_gen_vae_tpu.synth import database as jdb
from preset_gen_vae_tpu.synth.render import engine_version as jax_engine_version
from preset_gen_vae_tpu.utils import audio_io as jaudio
from preset_gen_vae_tpu_torch.data import dexed_dataset as dd
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from preset_gen_vae_tpu_torch.evaluation.evaluate import _gt_audio_cached
from preset_gen_vae_tpu_torch.synth.render import engine_version
from preset_gen_vae_tpu_torch.utils import audio_io
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)

SHORT = dict(n_synthetic_presets=6, synthetic_seed=1, note_duration=(0.15, 0.05),
             midi_notes=((60, 85), (48, 100)), multichannel_stacked_spectrograms=True)
JAX_BACKEND = dict(corpus_render_backend="jax", corpus_render_feedback="unrolled")
TIERS = ("specs_raw.npy", "specs_norm_f16.npy", "spec_stats.json")


def _no_render(monkeypatch):
    """Makes any corpus render of the port's raise."""
    def refuse(self):
        raise AssertionError("rendered a corpus that the cache holds")
    monkeypatch.setattr(DexedDataset, "_render_raw", refuse)


def test_engine_versions_agree():
    assert engine_version() == jax_engine_version() > 0


def test_default_data_root_is_the_variable_else_the_repo(monkeypatch, tmp_path):
    monkeypatch.setenv("PGV_TPU_DATA_DIR", str(tmp_path))
    assert dd.default_data_root() == tmp_path
    assert DexedDataset(device="cpu", **SHORT).data_root == tmp_path
    monkeypatch.delenv("PGV_TPU_DATA_DIR")
    assert dd.default_data_root() == dd.REPO_ROOT / "data_cache"


def _database(path):
    p, names, labels = jdb.generate_structured_corpus_v2(48, seed=5)
    jdb.create_database(path, p, names, labels)
    return str(path)


TAG_CASES = {
    "structured": dict(n_synthetic_presets=40),
    "structured2": dict(n_synthetic_presets=40, synthetic_style="structured2", synthetic_seed=3),
    "uniform": dict(n_synthetic_presets=40, synthetic_style="uniform"),
    "subsets": dict(n_synthetic_presets=80, algos=(1, 5, 17, 32), operators=(1, 2, 3),
                    restrict_to_labels=("harmonic", "percussive")),
    "flags": dict(n_synthetic_presets=40, constant_filter_and_tune_params=False,
                  prevent_SH_LFO=False, n_mel_bins=64),
    "jax_backend": dict(n_synthetic_presets=40, synthetic_style="structured2", **JAX_BACKEND),
    "json_lists": dict(n_synthetic_presets=40, note_duration=[0.5, 0.25],
                       midi_notes=[[40, 85], [60, 100]], multichannel_stacked_spectrograms=True),
    "db_path": dict(db_path="db", operators=(2, 4, 6)),
    "db_path_jax": dict(db_path="db", **JAX_BACKEND),
}


@pytest.mark.parametrize("case", list(TAG_CASES))
def test_tag_directory_and_sidecar_are_the_jax_packages(tmp_path, case):
    kw = dict(TAG_CASES[case])
    if kw.get("db_path") == "db":
        kw["db_path"] = _database(tmp_path / "presets.sqlite")
    port = DexedDataset(device="cpu", data_root=tmp_path / "port", **kw)
    jds = JaxDexedDataset(data_root=tmp_path / "jax", **kw)
    assert port._corpus_tag() == jds._corpus_tag()
    d_port, d_jax = port._corpus_cache_dir(), jds._corpus_cache_dir()
    assert d_port.relative_to(tmp_path / "port") == d_jax.relative_to(tmp_path / "jax")
    sidecar = "render_constraints.json"
    assert (d_port / sidecar).read_bytes() == (d_jax / sidecar).read_bytes()
    stored = json.loads((d_port / sidecar).read_text())
    assert ("raw_tier" in stored) == (kw.get("corpus_render_backend") == "jax")
    if "json_lists" in case:
        assert "_nd0.5-0.25_" in port._corpus_tag() and "notes40.85-60.100" in port._corpus_tag()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_sidecar_of_other_constraints_raises_in_both(tmp_path, writer):
    kw = dict(n_synthetic_presets=8, **JAX_BACKEND)
    if writer == "port":
        DexedDataset(device="cpu", data_root=tmp_path, **kw)
    else:
        JaxDexedDataset(data_root=tmp_path, **kw)
    other = dict(kw, corpus_render_feedback="exact")  # same tag, another sidecar
    with pytest.raises(RuntimeError, match="different constraints"):
        DexedDataset(device="cpu", data_root=tmp_path, **other)
    with pytest.raises(RuntimeError, match="different constraints"):
        JaxDexedDataset(data_root=tmp_path, **other)


CROSS = [(b, n) for b in ("cpp", "jax") for n in ("min_max", "mean_std")]


def _kw(backend, norm):
    return dict(SHORT, spectrogram_normalization=norm,
                **(JAX_BACKEND if backend == "jax" else {}))


@pytest.mark.parametrize("backend,norm", CROSS)
def test_a_jax_written_cache_is_served_by_the_port(tmp_path, monkeypatch, backend, norm):
    kw = _kw(backend, norm)
    jds = JaxDexedDataset(data_root=tmp_path, **kw)
    want = jds.load_spectrogram_corpus()
    d = jds._corpus_cache_dir()
    raw_dtype = np.load(d / "specs_raw.npy", mmap_mode="r").dtype
    assert raw_dtype == (np.float16 if backend == "jax" else np.float32)
    _no_render(monkeypatch)
    port = DexedDataset(device="cpu", data_root=tmp_path, **kw)
    assert torch.equal(port.load_corpus(), torch.from_numpy(want))  # the f16 tier
    assert port.spec_stats == jds.spec_stats and port.render_seconds == 0.0
    jax_tier = np.load(d / "specs_norm_f16.npy")
    (d / "specs_norm_f16.npy").unlink()
    port = DexedDataset(device="cpu", data_root=tmp_path, **kw)
    assert torch.equal(port.load_corpus(), torch.from_numpy(want))  # the raw tier alone
    rewritten = np.load(d / "specs_norm_f16.npy")
    assert rewritten.dtype == np.float16 and np.array_equal(rewritten, jax_tier)
    assert not list(d.glob("*.tmp.npy"))


@pytest.mark.parametrize("backend,norm", CROSS)
def test_a_port_written_cache_is_served_by_the_jax_package(tmp_path, backend, norm):
    kw = _kw(backend, norm)
    port = DexedDataset(device="cpu", data_root=tmp_path, **kw)
    got = port.load_corpus()
    assert port.render_seconds > 0.0
    d = port._corpus_cache_dir()
    assert all((d / f).exists() for f in TIERS) and not list(d.glob("*.tmp.npy"))
    raw = np.load(d / "specs_raw.npy")
    assert raw.dtype == (np.float16 if backend == "jax" else np.float32)
    stats = json.loads((d / "spec_stats.json").read_text())
    assert stats == port.spec_stats and list(stats) == ["min", "max", "mean", "std"]
    if backend == "cpp":  # the JAX package's own stats of this raw tier
        want_stats = JaxDexedDataset._compute_stats(None, raw)
        assert (stats["min"], stats["max"]) == (want_stats["min"], want_stats["max"])
        for k in ("mean", "std"):
            assert stats[k] == pytest.approx(want_stats[k], rel=1e-6), k
    jds = JaxDexedDataset(data_root=tmp_path, **kw)
    assert torch.equal(got, torch.from_numpy(jds.load_spectrogram_corpus()))
    assert jds.spec_stats == port.spec_stats
    (d / "specs_norm_f16.npy").unlink()
    jds = JaxDexedDataset(data_root=tmp_path, **kw)
    assert torch.equal(got, torch.from_numpy(jds.load_spectrogram_corpus()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_warm_reload_renders_nothing_and_serves_the_cold_corpus(tmp_path, monkeypatch, dtype):
    cold = DexedDataset(device="cpu", data_root=tmp_path, corpus_dtype=dtype, **SHORT)
    want = cold.load_corpus()
    assert cold.render_seconds > 0.0 and want.dtype == dtype
    with monkeypatch.context() as mp:
        _no_render(mp)
        warm = DexedDataset(device="cpu", data_root=tmp_path, corpus_dtype=dtype, **SHORT)
        got = warm.load_corpus()
    assert torch.equal(got, want) and warm.render_seconds == 0.0
    assert warm.spec_stats == cold.spec_stats
    again = warm.load_corpus(force_recompute=True)
    assert warm.render_seconds > 0.0 and torch.equal(again, want)


def test_the_device_policy_writes_nothing_and_serves_the_disk_corpus(tmp_path):
    kw = dict(SHORT, **JAX_BACKEND)
    device = DexedDataset(device="cpu", data_root=tmp_path / "device",
                          corpus_cache_policy="device", **kw).load_corpus()
    assert not (tmp_path / "device").exists()
    disk = DexedDataset(device="cpu", data_root=tmp_path / "disk", **kw).load_corpus()
    assert torch.equal(device, disk)


@pytest.mark.parametrize("backend", ["cpp", "jax"])
def test_without_normalization_the_raw_values_are_served(tmp_path, backend):
    kw = _kw(backend, None)
    port = DexedDataset(device="cpu", data_root=tmp_path / "port", **kw)
    got = port.load_corpus()
    d = port._corpus_cache_dir()
    assert not (d / "specs_norm_f16.npy").exists()
    assert torch.equal(got, torch.from_numpy(np.load(d / "specs_raw.npy").astype(np.float32)))
    jds = JaxDexedDataset(data_root=tmp_path / "port", **kw)  # the port's raw tier
    assert torch.equal(got, torch.from_numpy(jds.load_spectrogram_corpus()))


def test_compute_and_store_spectrograms_stats_matches_jax(tmp_path):
    """The port's files against the JAX package's on the port's raw corpus:
    per-preset CSV rows within 1e-5 relative (float64 against float32
    reductions), the same stats and raw tier."""
    port = DexedDataset(device="cpu", data_root=tmp_path / "port", **SHORT)
    stats = port.compute_and_store_spectrograms_stats()
    d = port._corpus_cache_dir()
    raw = np.load(d / "specs_raw.npy")
    jds = JaxDexedDataset(data_root=tmp_path / "jax", **SHORT)
    jds._compute_spec_corpus = lambda *a, **k: raw
    want = jds.compute_and_store_spectrograms_stats()
    dj = jds._corpus_cache_dir()
    assert list(stats) == list(want) and stats["min"] == want["min"]
    assert json.loads((d / "spec_stats.json").read_text()) == stats
    np.testing.assert_array_equal(np.load(dj / "specs_raw.npy"), raw)
    rows = [np.loadtxt(x / "spectrograms_stats.csv", delimiter=",", skiprows=1) for x in (d, dj)]
    assert rows[0].shape == (6, 5)
    np.testing.assert_array_equal(rows[0][:, 0], rows[1][:, 0])
    np.testing.assert_allclose(rows[0][:, 1:], rows[1][:, 1:], rtol=1e-5)


def test_generate_wav_files_matches_jax(tmp_path):
    """The same files, 16-bit PCM of the two engine builds' renders, within
    one PCM step."""
    port = DexedDataset(device="cpu", data_root=tmp_path / "port", **SHORT)
    jds = JaxDexedDataset(data_root=tmp_path / "jax", **SHORT)
    assert port.generate_wav_files(tmp_path / "wp") == jds.generate_wav_files(tmp_path / "wj") == 12
    names = sorted(f.name for f in (tmp_path / "wp").iterdir())
    assert names == sorted(f.name for f in (tmp_path / "wj").iterdir())
    assert names[0] == "preset000000_pitch048_vel100.wav"
    for name in names:
        a, sr = audio_io.read_wav(tmp_path / "wp" / name)
        b, _ = audio_io.read_wav(tmp_path / "wj" / name)
        assert sr == 22050 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1.01 / 32767)


def test_audio_io_is_the_jax_modules(tmp_path):
    x = np.random.default_rng(2).uniform(-1.2, 1.2, 1000).astype(np.float32)
    audio_io.write_wav(tmp_path / "p" / "x.wav", x, 16000)
    jaudio.write_wav(tmp_path / "j" / "x.wav", x, 16000)
    assert (tmp_path / "p" / "x.wav").read_bytes() == (tmp_path / "j" / "x.wav").read_bytes()
    with wave.open(str(tmp_path / "x32.wav"), "wb") as f:  # a 32-bit file
        f.setnchannels(1)
        f.setsampwidth(4)
        f.setframerate(8000)
        f.writeframes((x.clip(-0.99, 0.99) * 2147483647.0).astype("<i4").tobytes())
    for name in ("p/x.wav", "x32.wav"):
        got, want = audio_io.read_wav(tmp_path / name), jaudio.read_wav(tmp_path / name)
        assert got[1] == want[1] and got[0].dtype == np.float32
        np.testing.assert_array_equal(got[0], want[0])


def test_gt_audio_cache_key_and_file_are_the_jax_packages(tmp_path, monkeypatch):
    """Both packages name the ground-truth file of the same items the same;
    a file the JAX package wrote is served by the port without a render,
    bit for bit, and the port's own file holds its engine's renders."""
    port = DexedDataset(device="cpu", data_root=tmp_path / "shared", **SHORT)
    jds = JaxDexedDataset(data_root=tmp_path / "shared", **SHORT)
    items = np.array([[u, p, v] for u in port.uids for p, v in port.midi_notes], np.int32)
    want = jax_gt_audio_cached(jds, jds._renderer, items)
    (jax_file,) = (jds._corpus_cache_dir() / "gt_eval_audio").glob("gt_*.npy")
    with monkeypatch.context() as mp:
        mp.setattr(port.renderer, "render_batch", lambda *a: pytest.fail("rendered"))
        served = _gt_audio_cached(port, port.renderer, items)
    np.testing.assert_array_equal(served, want)
    own = DexedDataset(device="cpu", data_root=tmp_path / "own", **SHORT)
    got = _gt_audio_cached(own, own.renderer, items)
    (own_file,) = (own._corpus_cache_dir() / "gt_eval_audio").glob("gt_*.npy")
    assert own_file.name == jax_file.name and not list(own_file.parent.glob("*.tmp.npy"))
    presets = np.stack([own.get_full_preset_params(u) for u in items[:, 0]])
    np.testing.assert_array_equal(got, own.renderer.render_batch(presets, items[:, 1], items[:, 2]))
    np.testing.assert_array_equal(np.load(own_file), got)
    np.testing.assert_allclose(got, want, atol=1e-5)
    other = _gt_audio_cached(own, own.renderer, items[::-1].copy())  # another item table
    assert len(list(own_file.parent.glob("gt_*.npy"))) == 2 and other.shape == got.shape
