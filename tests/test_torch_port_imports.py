"""The PyTorch port stands alone and never falls back to the CPU quietly.

- No file of ``preset_gen_vae_tpu_torch`` (nor ``chip_smoke.py``) imports
  jax, flax, optax, orbax or the JAX package ``preset_gen_vae_tpu``. The
  check matches ``preset_gen_vae_tpu`` exactly or as the prefix
  ``preset_gen_vae_tpu.``, so the port's own name does not match.
- Entry points default to the card and raise where there is none.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "preset_gen_vae_tpu_torch"
FORBIDDEN = ("jax", "flax", "optax", "orbax", "preset_gen_vae_tpu")


def _is_forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_prefix_rule():
    assert _is_forbidden("preset_gen_vae_tpu.ops.mel") and _is_forbidden("jax.numpy")
    assert not _is_forbidden("preset_gen_vae_tpu_torch.ops.mel")
    assert not _is_forbidden("jaxlike")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files for m in _imports(f) if _is_forbidden(m)]
    assert not bad, bad


def test_entry_points_raise_without_a_card(monkeypatch):
    from preset_gen_vae_tpu_torch.device import resolve_device
    from preset_gen_vae_tpu_torch.training.loop import train_config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_config()  # device defaults to "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_dataset_and_frontend_do_not_move_to_cpu_quietly():
    from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
    from preset_gen_vae_tpu_torch.ops.spectrogram import SpectrogramConfig, SpectrogramProcessor

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        SpectrogramProcessor(SpectrogramConfig(), device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        DexedDataset(n_synthetic_presets=4)  # device defaults to "cuda"
