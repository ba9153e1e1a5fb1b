"""Mel filterbank features.

The port's counterpart of ``setk_tpu/dsp/mel.py``: librosa.filters.mel
(sr, n_fft, n_mels, fmin, fmax, htk=True, norm="slaney") as a float64
numpy constant built on the host, and its application as one
``torch.matmul`` of (..., T, F) magnitudes by the (F, M) weights, on the
magnitudes' device.
"""

import numpy as np
import torch

from setk_tpu_torch.utils.common import EPSILON

__all__ = ["hz_to_mel", "mel_to_hz", "mel_filterbank", "mel_fbank"]


def hz_to_mel(freq, htk: bool = True):
    freq = np.asarray(freq, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    # Slaney scale (linear below 1 kHz, log above)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (freq - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(freq / min_log_hz) / logstep, mels)


def mel_to_hz(mels, htk: bool = True):
    mels = np.asarray(mels, dtype=np.float64)
    if htk:
        return 700.0 * (10.0**(mels / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)), freqs)


def mel_filterbank(sr: int,
                   n_fft: int,
                   num_mels: int = 80,
                   fmin: float = 0.0,
                   fmax: float | None = None,
                   htk: bool = True,
                   norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank, shape (num_mels, n_fft//2 + 1)."""
    if fmax is None:
        fmax = sr / 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk),
                          num_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:num_mels + 2] - hz_pts[:num_mels])
        weights *= enorm[:, None]
    return weights.astype(np.float32)


def mel_fbank(spectrogram: torch.Tensor,
              weights: np.ndarray,
              apply_log: bool = False) -> torch.Tensor:
    """Apply a mel filterbank to magnitude spectra ``(..., T, F)`` ->
    (..., T, M) f32, on the spectra's device."""
    spectrogram = torch.as_tensor(spectrogram, dtype=torch.float32)
    w = torch.as_tensor(weights, dtype=torch.float32,
                        device=spectrogram.device)
    fbank = torch.matmul(spectrogram, w.T)
    if apply_log:
        fbank = torch.log(torch.clamp(fbank, min=EPSILON))
    return fbank
