"""The port's ``'cpp'`` corpus against the JAX package's disk path on the
CPU: the JAX package serves the min/max-normalised corpus rounded through
its float16 disk tier (``preset_gen_vae_tpu/data/abstract_dataset.py``,
``load_spectrogram_corpus``), and the port's corpus holds those values in
its own dtype. Both sides are fed the same raw log-mels (the JAX
package's), so that only the normalisation and the rounding chain are
compared, bit for bit."""

import numpy as np
import pytest
import torch

from preset_gen_vae_tpu.data.dexed_dataset import DexedDataset as JaxDexedDataset
from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)

KW = dict(n_synthetic_presets=6, synthetic_seed=1, note_duration=(0.15, 0.05),
          midi_notes=((60, 85), (48, 100)), multichannel_stacked_spectrograms=True)


@pytest.fixture(scope="module")
def jax_disk_corpus(tmp_path_factory):
    """(raw log-mels, the corpus the JAX disk path serves), f32 numpy."""
    jds = JaxDexedDataset(data_root=tmp_path_factory.mktemp("jax_corpus"), **KW)
    raw = jds._compute_spec_corpus()
    jds._compute_spec_corpus = lambda *a, **k: raw
    return raw, jds.load_spectrogram_corpus()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpp_corpus_serves_the_jax_disk_tier(jax_disk_corpus, monkeypatch, tmp_path, dtype):
    """In float32 the port's corpus is the JAX package's f16-rounded corpus;
    in bfloat16 (the corpus dtype on the card) it is that corpus cast to
    bfloat16, bit for bit, where a direct cast of the f32 normalised values
    differs in some elements by one bf16 ulp. The port's pass is cold (its
    own empty cache directory); its stats are ``_compute_stats``' (min and
    max exact, mean and std, summed in float64, within 1e-6 relative of
    numpy's float32 reductions)."""
    raw, want = jax_disk_corpus
    assert raw.dtype == np.float32 and want.dtype == np.float32
    port = DexedDataset(device="cpu", corpus_dtype=dtype, data_root=tmp_path, **KW)
    assert (port.corpus_render_backend, port.spectrogram_normalization) == ("cpp", "min_max")
    notes = iter(torch.from_numpy(raw[:, i].copy()) for i in range(raw.shape[1]))
    monkeypatch.setattr(type(port.spectrogram), "__call__", lambda self, wav: next(notes))
    got = port.load_corpus()
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    want_stats = JaxDexedDataset._compute_stats(None, raw)
    assert list(port.spec_stats) == list(want_stats)
    assert (port.spec_stats["min"], port.spec_stats["max"]) == (float(raw.min()),
                                                                float(raw.max()))
    for k in ("mean", "std"):
        assert port.spec_stats[k] == pytest.approx(want_stats[k], rel=1e-6), k
    assert torch.equal(got, torch.from_numpy(want).to(dtype))
    direct = (-1.0 + (raw - raw.min()) / ((float(raw.max()) - float(raw.min())) / 2.0))
    assert not torch.equal(got, torch.from_numpy(direct.astype(np.float32)).to(dtype))
