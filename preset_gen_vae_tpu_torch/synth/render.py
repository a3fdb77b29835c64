"""ctypes binding of the in-repo C++ DX7 engine (counterpart of
``preset_gen_vae_tpu/synth/render.py:25-163``).

The port compiles ``csrc/dx7/dx7_engine.cc`` itself, with ``g++``, into the
gitignored ``build/`` directory (``_native.build_shared_library``). It never
loads ``csrc/libdx7.so``: that file is built with ``-march=native`` and may
come from another host. A failed build raises.

Render contract (reference: synth/dexed.py:247-259): one MIDI note of a
155-parameter normalized preset, note-on for ``note_duration[0]`` seconds,
``note_duration[0] + note_duration[1]`` seconds in all, rounded up to the
engine's 512-sample block. Batches fan out over the engine's own C++
thread pool.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np

from .. import _native
from . import dexed_params as dx

_SOURCE = _native.REPO_ROOT / "csrc" / "dx7" / "dx7_engine.cc"
# the engine Makefile's flags (csrc/Makefile:5) without -march=native, so
# the library runs on any x86-64 host
_CXX = ["g++", "-O3", "-std=c++17", "-fPIC", "-ffast-math", "-shared", "-pthread"]

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _engine() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_native.build_shared_library("dx7", _CXX, [_SOURCE])))
    lib.dx7_render_batch.restype = ctypes.c_int
    lib.dx7_render_batch.argtypes = [
        _f32p, ctypes.c_int, _i32p, _i32p, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _f32p, ctypes.c_int,
    ]
    lib.dx7_engine_version.restype = ctypes.c_int
    lib.dx7_engine_version.argtypes = []
    lib.dx7_samples_per_render.restype = ctypes.c_int
    lib.dx7_samples_per_render.argtypes = [ctypes.c_float, ctypes.c_int]
    return lib


def engine_version() -> int:
    return int(_engine().dx7_engine_version())


class DexedRenderer:
    """Deterministic offline renderer (reference API surface:
    synth/dexed.py:217-296). Building the engine happens here, at first
    construction, never at import."""

    def __init__(self, sample_rate: int = 22050,
                 note_duration: Tuple[float, float] = (3.0, 1.0)):
        self._lib = _engine()
        self.Fs = int(sample_rate)
        self.note_duration = tuple(note_duration)

    @property
    def total_seconds(self) -> float:
        return self.note_duration[0] + self.note_duration[1]

    @property
    def samples_per_render(self) -> int:
        n = int(self._lib.dx7_samples_per_render(self.total_seconds, self.Fs))
        if n < 0:
            raise ValueError(f"invalid render length for {self.note_duration} s")
        return n

    def render_batch(self, presets: np.ndarray, midi_pitches: Sequence[int],
                     midi_velocities: Sequence[int], n_threads: int = 0) -> np.ndarray:
        """(N, 155) presets -> (N, samples) float32 waveforms (0 threads =
        all cores)."""
        presets = np.ascontiguousarray(presets, dtype=np.float32)
        n = presets.shape[0]
        pitches = np.ascontiguousarray(midi_pitches, dtype=np.int32)
        vels = np.ascontiguousarray(midi_velocities, dtype=np.int32)
        if presets.shape != (n, dx.N_PARAMS) or pitches.shape != (n,) or vels.shape != (n,):
            raise ValueError(
                f"presets {presets.shape}, pitches {pitches.shape} and velocities "
                f"{vels.shape} must be (N, {dx.N_PARAMS}), (N,) and (N,)"
            )
        out = np.zeros((n, self.samples_per_render), dtype=np.float32)
        res = self._lib.dx7_render_batch(
            presets.ctypes.data_as(_f32p), n,
            pitches.ctypes.data_as(_i32p), vels.ctypes.data_as(_i32p),
            self.note_duration[0], self.total_seconds, self.Fs,
            out.ctypes.data_as(_f32p), int(n_threads),
        )
        if res < 0:
            raise RuntimeError("dx7_render_batch failed")
        return out
