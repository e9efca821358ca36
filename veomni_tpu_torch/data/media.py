"""Media preprocessing: the image resize target and the audio front end.

Port of ``veomni_tpu/data/media.py``: ``smart_resize`` (``:58``), the
qwen-vl pixel-budget resize target, and the audio half (``:191-281``), host
numpy as in the reference:

* ``load_audio``: a wav path, wav bytes, a ``.npy`` path or an array ->
  mono float32 at ``sample_rate`` (``scipy.io.wavfile``: int PCM over its
  type's max, uint8 centred at 128, float as it is; channels averaged;
  ``scipy.signal.resample_poly`` between rates; ``max_seconds`` cuts);
* ``_mel_filterbank``: the Slaney mel filterbank [n_mels, n_fft // 2 + 1];
* ``log_mel_spectrogram``: Whisper-style log-mel features [frames, n_mels]
  (n_fft 400, hop 160, a periodic Hann window, the top-8-dB floor and the
  ``(x + 4) / 4`` scale), the input of the omni audio towers.

``load_video`` (its lazy ``cv2``) waits for the video path (ROADMAP.md
queue 1, slice F item 4's video half).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import numpy as np


def smart_resize(height: int, width: int, *, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> Tuple[int, int]:
    """(h, w): both sides rounded to multiples of ``factor`` with h * w kept
    within [min_pixels, max_pixels] (reference ``video_utils.py:226``)."""
    if height < factor or width < factor:
        scale = factor / min(height, width)
        height, width = math.ceil(height * scale), math.ceil(width * scale)
    h = max(factor, round(height / factor) * factor)
    w = max(factor, round(width / factor) * factor)
    if h * w > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h = max(factor, math.floor(height / beta / factor) * factor)
        w = max(factor, math.floor(width / beta / factor) * factor)
    elif h * w < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h = math.ceil(height * beta / factor) * factor
        w = math.ceil(width * beta / factor) * factor
    return h, w


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------

def load_audio(audio: Union[str, bytes, np.ndarray], *, sample_rate: int = 16000,
               max_seconds: float = 0.0) -> np.ndarray:
    """-> mono float32 in [-1, 1] at ``sample_rate``. An array is taken as
    already at ``sample_rate``, as is a ``.npy`` file."""
    if isinstance(audio, np.ndarray):
        wav, sr = audio.astype(np.float32), sample_rate
    elif isinstance(audio, str) and audio.endswith(".npy"):
        wav, sr = np.load(audio).astype(np.float32), sample_rate
    else:
        import io

        from scipy.io import wavfile

        sr, wav = wavfile.read(io.BytesIO(audio) if isinstance(audio, bytes) else audio)
        if wav.dtype.kind == "i":
            wav = wav.astype(np.float32) / np.iinfo(wav.dtype).max
        elif wav.dtype.kind == "u":
            wav = (wav.astype(np.float32) - 128.0) / 128.0
        else:
            wav = wav.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=-1)
    if sr != sample_rate:
        from scipy.signal import resample_poly

        g = math.gcd(int(sr), int(sample_rate))
        wav = resample_poly(wav, sample_rate // g, sr // g).astype(np.float32)
    if max_seconds:
        wav = wav[: int(max_seconds * sample_rate)]
    return wav


def _hz_to_mel(f):
    """Slaney's mel scale: linear below 1 kHz, logarithmic above."""
    f = np.asarray(f, np.float64)
    log_region = 15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log_region, 3.0 * f / 200.0)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                    200.0 * m / 3.0)


def _mel_filterbank(n_mels: int, n_fft: int, sample_rate: int) -> np.ndarray:
    """Slaney-normalized triangular filters [n_mels, n_fft // 2 + 1] f32
    (WhisperFeatureExtractor's and librosa's defaults)."""
    fft_freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    mel_pts = _mel_to_hz(np.linspace(0, _hz_to_mel(sample_rate / 2), n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-9)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-9)
        fb[i] = np.maximum(0.0, np.minimum(up, down)) * (2.0 / max(hi - lo, 1e-9))
    return fb.astype(np.float32)


def log_mel_spectrogram(wav: np.ndarray, *, n_mels: int = 128, n_fft: int = 400,
                        hop_length: int = 160, sample_rate: int = 16000) -> np.ndarray:
    """Whisper-style log-mel features [n_frames, n_mels] f32 of a mono wav
    (reflect-padded by n_fft / 2 on each side)."""
    pad = n_fft // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    n_frames = 1 + (len(x) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    spec = np.abs(np.fft.rfft(x[idx] * window, axis=-1)) ** 2  # [T, F]
    mel = spec @ _mel_filterbank(n_mels, n_fft, sample_rate).T
    logmel = np.log10(np.maximum(mel, 1e-10))
    logmel = np.maximum(logmel, logmel.max() - 8.0)
    return ((logmel + 4.0) / 4.0).astype(np.float32)
