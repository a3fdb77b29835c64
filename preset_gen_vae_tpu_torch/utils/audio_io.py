"""Copy of ``preset_gen_vae_tpu/utils/audio_io.py`` (``write_wav`` and
``read_wav``, :13-40 there), unchanged apart from this docstring.

Wav file IO with the standard library only (the reference uses soundfile +
ffmpeg mp3 export, utils/audio.py:276-282); 16/32-bit PCM wav covers the
dataset and the morph demo's needs."""

from __future__ import annotations

import pathlib
import wave

import numpy as np


def write_wav(path, x: np.ndarray, sample_rate: int = 22050) -> None:
    """float waveform in [-1, 1] -> 16-bit PCM wav."""
    x = np.asarray(x, dtype=np.float32)
    pcm = np.clip(x, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def read_wav(path):
    """-> (float32 waveform in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        sw = f.getsampwidth()
        raw = f.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32767.0
    elif sw == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483647.0
    else:
        raise ValueError(f"Unsupported sample width {sw}")
    return x, sr
