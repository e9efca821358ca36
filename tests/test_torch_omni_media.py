"""The port's audio front end (``veomni_tpu_torch/data/media.py``) against the
JAX package's (``veomni_tpu/data/media.py``), on wav files written from
numpy seeds: ``load_audio`` on int16, uint8, float32 and stereo wavs at 16
and 44.1 kHz (the last resampled), wav bytes, ``.npy`` files, arrays and
``max_seconds``; ``_mel_filterbank``; ``log_mel_spectrogram``. Every output
equal to the reference's within 1e-6 relative (both are the same numpy and
scipy calls; the tolerance covers a reordered product).
"""

import numpy as np
import pytest

from veomni_tpu.data import media as jm
from veomni_tpu_torch.data import media as tm

CASES = [  # (rate, dtype, channels)
    (16000, np.int16, 1), (44100, np.int16, 1), (16000, np.uint8, 1),
    (16000, np.float32, 1), (44100, np.float32, 2), (16000, np.int16, 2),
]


def _signal(rate, seconds, rng):
    t = np.arange(int(rate * seconds)) / rate
    return 0.6 * np.sin(2 * np.pi * (300 + 900 * t) * t) + 0.1 * rng.standard_normal(len(t))


def _write(path, rate, dtype, channels, rng):
    from scipy.io import wavfile

    x = _signal(rate, 0.7, rng)
    if channels == 2:
        x = np.stack([x, -0.5 * x], -1)
    if dtype == np.int16:
        x = (x * 30000).astype(np.int16)
    elif dtype == np.uint8:
        x = (x * 100 + 128).astype(np.uint8)
    else:
        x = x.astype(np.float32)
    wavfile.write(str(path), rate, x)
    return str(path)


def close(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("rate,dtype,channels", CASES,
                         ids=[f"{r}-{np.dtype(d).name}-{c}ch" for r, d, c in CASES])
def test_load_audio_and_features_match_jax(tmp_path, rate, dtype, channels):
    rng = np.random.default_rng(rate + channels)
    path = _write(tmp_path / "a.wav", rate, dtype, channels, rng)
    wav = tm.load_audio(path)
    close(wav, jm.load_audio(path))
    assert abs(len(wav) - int(0.7 * 16000)) <= 1  # at 16 kHz
    with open(path, "rb") as f:
        close(tm.load_audio(f.read(), max_seconds=0.25), jm.load_audio(path, max_seconds=0.25))
    close(tm.log_mel_spectrogram(wav), jm.log_mel_spectrogram(jm.load_audio(path)))


def test_npy_arrays_and_filterbanks_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = _signal(16000, 0.5, rng).astype(np.float32)
    np.save(tmp_path / "a.npy", x)
    close(tm.load_audio(str(tmp_path / "a.npy")), jm.load_audio(str(tmp_path / "a.npy")))
    close(tm.load_audio(x.astype(np.float64)), jm.load_audio(x.astype(np.float64)))
    close(tm.load_audio(x, sample_rate=8000), jm.load_audio(x, sample_rate=8000))
    for n_mels, n_fft, rate in ((128, 400, 16000), (80, 400, 16000), (32, 512, 8000)):
        close(tm._mel_filterbank(n_mels, n_fft, rate), jm._mel_filterbank(n_mels, n_fft, rate))
        close(tm.log_mel_spectrogram(x, n_mels=n_mels, n_fft=n_fft, sample_rate=rate),
              jm.log_mel_spectrogram(x, n_mels=n_mels, n_fft=n_fft, sample_rate=rate))
    assert tm.log_mel_spectrogram(x).shape == (1 + len(x) // 160, 128)
