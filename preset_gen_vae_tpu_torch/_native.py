"""Builds the port's native shared libraries from the repository's sources.

Both native parts of the port (the DX7 render engine, compiled with ``g++``,
and the CUDA kernels, compiled with ``nvcc``) are built at first use into
the gitignored ``build/`` directory at the repository root and loaded with
ctypes. A library's file name carries a hash of its sources and of the
compiler command, so an edited source is rebuilt and a stale library is
never loaded. The build writes to a temporary file and renames it, so
processes that build the same library at once never load a partial file.

A failed build raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
from typing import Sequence

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
BUILD_DIR = REPO_ROOT / "build"


def build_shared_library(
    name: str, compiler: Sequence[str], sources: Sequence[pathlib.Path]
) -> pathlib.Path:
    """Compiles ``sources`` with ``compiler + sources + ['-o', out]`` into
    ``build/<name>_<hash>.so`` unless that file exists; returns its path.
    The compiler's output is kept beside it as ``<name>_<hash>.log``."""
    digest = hashlib.sha256(" ".join(compiler).encode())
    for src in sources:
        digest.update(pathlib.Path(src).read_bytes())
    out = BUILD_DIR / f"{name}_{digest.hexdigest()[:12]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [*compiler, *(str(s) for s in sources), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {name} failed ({' '.join(cmd)}):\n{proc.stdout}{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out
