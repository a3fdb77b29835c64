"""The benchmark's guard against JAX and the JAX package, and the
reference's independence from the port.

- ``forbidden_modules`` compares whole top-level names:
  ``preset_gen_vae_tpu_torch`` is not ``preset_gen_vae_tpu``;
- a fresh process that imports every module of the harness and the port's
  modules that the windows drive loads none of ``jax``, ``jaxlib``,
  ``flax`` or ``preset_gen_vae_tpu``;
- a fresh process that imports the whole reference loads nothing of the
  port either, and no reference source names the port or JAX."""

import ast
import pathlib
import subprocess
import sys

from portbench.run import FORBIDDEN, forbidden_modules

ROOT = pathlib.Path(__file__).resolve().parents[2]
REFERENCE = ROOT / "portbench" / "reference"


def test_forbidden_names_are_whole_top_level_names():
    assert forbidden_modules(["preset_gen_vae_tpu_torch", "preset_gen_vae_tpu_torch.training.loop",
                              "numpy", "jaxtyping", "flaxen.x"]) == []
    assert forbidden_modules(["preset_gen_vae_tpu.ops.pallas_mel"]) == ["preset_gen_vae_tpu"]
    assert forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == ["flax", "jax",
                                                                            "jaxlib"]
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "preset_gen_vae_tpu"}


def _top_levels_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_the_benchmark_process_loads_no_jax():
    names = _top_levels_after(
        "import portbench.run, portbench.registry, portbench.control, portbench.trace\n"
        "import portbench.kinds.train\n"
        "import preset_gen_vae_tpu_torch.training.loop\n"
        "import preset_gen_vae_tpu_torch.data.dexed_dataset\n"
        "import preset_gen_vae_tpu_torch.evaluation.evaluate\n"
        "from portbench import registry\n"
        "for m in ('train.step_ms', 'train.mfu', 'setup.corpus_s'):\n"
        "    registry.metric_reader(m)\n")
    assert "preset_gen_vae_tpu_torch" in names and "portbench" in names
    assert not names & set(FORBIDDEN), names & set(FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    modules = sorted(p.relative_to(ROOT).with_suffix("").as_posix().replace("/", ".")
                     for p in REFERENCE.rglob("*.py") if p.name != "__init__.py")
    names = _top_levels_after("".join(f"import {m}\n" for m in modules))
    banned = {"preset_gen_vae_tpu_torch", *FORBIDDEN}
    assert not names & banned
    for path in REFERENCE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
