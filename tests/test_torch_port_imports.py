"""The PyTorch port stands alone and never falls back to the CPU quietly.

- No file of ``preset_gen_vae_tpu_torch`` (nor ``chip_smoke.py``) imports
  jax, flax, optax, orbax or the JAX package ``preset_gen_vae_tpu``. The
  check matches ``preset_gen_vae_tpu`` exactly or as the prefix
  ``preset_gen_vae_tpu.``, so the port's own name does not match.
- Every module of the port imports in a process where those packages and
  pandas, tensorboard and matplotlib cannot be imported (the card's
  machine has none of the last three), except ``logs/tbwriter.py``, which
  ``RunLogger`` loads only for ``use_tensorboard=True`` and which raises
  there.
- Entry points, the ``python -m`` scripts among them, default to the card
  and raise where there is none.
- Every port test module that builds a dataset, trains or evaluates takes
  the autouse ``isolated_data_root`` of ``_torch_port_fixtures.py``, so
  that no test caches a corpus in, or is served one from, the
  repository's ``data_cache/``.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from _torch_port_fixtures import isolated_data_root  # noqa: F401 (autouse)

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


BLOCKED = FORBIDDEN + ("pandas", "tensorboard", "matplotlib")
_GUARD = """
import importlib, sys
for name in {blocked!r}:
    sys.modules[name] = None  # `import name` now raises ImportError
for module in {modules!r}:
    importlib.import_module(module)
try:
    importlib.import_module("preset_gen_vae_tpu_torch.logs.tbwriter")
except ImportError:
    print("tbwriter raised")
"""


def test_every_module_imports_without_the_blocked_packages():
    modules = sorted(".".join(f.relative_to(ROOT).with_suffix("").parts)
                     for f in PORT.rglob("*.py") if f.name != "tbwriter.py")
    modules = [m.removesuffix(".__init__") for m in modules]
    assert len(modules) > 30 and "preset_gen_vae_tpu_torch.evaluation.evaluate" in modules
    assert {f"preset_gen_vae_tpu_torch.{m}" for m in (
        "synth.sysex", "utils.audio_io", "evaluation.interpolate", "scripts.train_from_syx",
        "scripts.preset_morph_demo", "scripts.sound_match_demo", "utils.profile",
        "utils.figures", "utils.label", "parallel.multihost", "parallel.sharding_rules",
        "scripts.dump_figures",
        "scripts.clean_logs", "scripts.train_queue", "scripts.evaluate", "scripts.run_stack3_v2",
        "scripts.run_6note", "scripts.compare_corpus_styles", "scripts.run_flowloss",
        "scripts.latent_nan_report", "training.loop", "training.dispatch")
    } <= set(modules)
    code = _GUARD.format(blocked=BLOCKED, modules=modules)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "tbwriter raised"


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from preset_gen_vae_tpu_torch import config as cfg
    from preset_gen_vae_tpu_torch.device import resolve_device
    from preset_gen_vae_tpu_torch.evaluation import evaluate as ev
    from preset_gen_vae_tpu_torch.evaluation.interpolate import interpolate_presets
    from preset_gen_vae_tpu_torch.evaluation.similarity import SimilarityEvaluator
    from preset_gen_vae_tpu_torch.scripts import compare_corpus_styles, dump_figures, evaluate, \
        latent_nan_report, preset_morph_demo, run_flowloss, run_stack3_v2, sound_match_demo, \
        train_from_syx, train_queue
    from preset_gen_vae_tpu_torch.synth import database, sysex
    from preset_gen_vae_tpu_torch.training import loop
    from preset_gen_vae_tpu_torch.training.loop import train_config
    from preset_gen_vae_tpu_torch.training.queue import run_queue

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bank = tmp_path / "bank.syx"
    bank.write_bytes(sysex.write_syx(database.generate_structured_corpus_v2(32, seed=0)[0]))
    calls = [
        lambda: train_config(),  # device defaults to "cuda"
        lambda: run_queue([({}, {})]),
        lambda: ev.evaluate_model(cfg.ModelConfig(), cfg.TrainConfig(), cfg.EvalConfig()),
        lambda: ev.evaluate_model_from_dir(tmp_path, cfg.EvalConfig()),
        lambda: ev.evaluate_all_models(cfg.EvalConfig(models_names=("FlVAE2/none",)),
                                       saved_root=tmp_path),
        lambda: SimilarityEvaluator([[0.0] * 4096, [0.0] * 4096]),
        lambda: interpolate_presets(cfg.ModelConfig(), cfg.TrainConfig(), 0, 1),
        lambda: preset_morph_demo.main(["--logs-root", str(tmp_path)]),
        lambda: train_from_syx.main([str(bank), "--logs-root", str(tmp_path)]),
        lambda: sound_match_demo.main([]),
        lambda: dump_figures.main([str(tmp_path)]),
        lambda: compare_corpus_styles.main(["--logs-root", str(tmp_path)]),
        lambda: run_flowloss.main(["--logs-root", str(tmp_path)]),
        lambda: latent_nan_report.main(["FlVAE2/none", "--logs-root", str(tmp_path)]),
        lambda: resolve_device(),
    ]
    # the command-line entry points: on the card by default, on the CPU
    # only with --device cpu (their heavy calls recorded, not run)
    clis = [(loop, "train_config", []), (train_queue, "run_queue", []),
            (evaluate, "evaluate_all_models", []),
            (run_stack3_v2, "prepare_dataset", ["8", "1", "--logs-root", str(tmp_path)])]
    calls += [lambda m=m, argv=argv: m.main(argv) for m, _, argv in clis]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")

    class Reached(Exception):
        pass

    def reached(*args, **kwargs):
        raise Reached(args, kwargs)

    for module, heavy, argv in clis:
        monkeypatch.setattr(module, heavy, reached)
        with pytest.raises(Reached) as got:
            module.main(argv + ["--device", "cpu"])
        args, kwargs = got.value.args
        assert torch.device("cpu") in (*args, torch.device(kwargs.get("device", "cuda")))


def test_dataset_and_frontend_do_not_move_to_cpu_quietly():
    from preset_gen_vae_tpu_torch.data.dexed_dataset import DexedDataset
    from preset_gen_vae_tpu_torch.ops.spectrogram import SpectrogramConfig, SpectrogramProcessor

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        SpectrogramProcessor(SpectrogramConfig(), device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        DexedDataset(n_synthetic_presets=4)  # device defaults to "cuda"


CACHING_CALLS = ("DexedDataset(", "train_config(", "evaluate_model", "evaluate_all_models(",
                 "prepare_dataset(", "interpolate_presets(", "run_queue(", "train_from_syx",
                 "preset_morph_demo")


def _takes_isolated_data_root(path: pathlib.Path) -> bool:
    return any(isinstance(n, ast.ImportFrom) and n.module == "_torch_port_fixtures"
               and "isolated_data_root" in {a.name for a in n.names}
               for n in ast.walk(ast.parse(path.read_text(), filename=str(path))))


def test_port_test_modules_that_cache_a_corpus_isolate_their_data_root():
    tests = sorted((ROOT / "tests").glob("test_torch_port_*.py"))
    caching = [p for p in tests if any(c in p.read_text() for c in CACHING_CALLS)]
    assert len(caching) >= 10 and pathlib.Path(__file__).resolve() in caching
    missing = [p.name for p in caching if not _takes_isolated_data_root(p)]
    assert not missing, missing
