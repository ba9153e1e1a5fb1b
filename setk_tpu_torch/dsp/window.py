"""Analysis/synthesis window construction (host numpy constants).

Counterpart of ``setk_tpu/dsp/window.py``: periodic (DFT-even) windows
matching ``scipy.signal.get_window(..., fftbins=True)``, librosa's
pad_center and window_sumsquare, and the reciprocal envelope in hop
blocks that the fused iSTFT kernel consumes.
"""

import numpy as np

__all__ = ["make_window", "pad_center", "window_sumsquare",
           "wss_inverse_blocks"]


def _periodic_cosine_sum(coeffs, n):
    """Generalized cosine window, periodic form: sum_k a_k cos(2 pi k t / n)."""
    t = np.arange(n)
    w = np.zeros(n, dtype=np.float64)
    for k, a in enumerate(coeffs):
        w += a * np.cos(2.0 * np.pi * k * t / n)
    return w


def make_window(name: str, frame_len: int, dtype=np.float32) -> np.ndarray:
    """Build a periodic window of length ``frame_len``.

    Supported: hann, sqrthann, hamming, blackman, rect/rectangular/boxcar.
    """
    if name in ("rect", "rectangular", "boxcar", "none"):
        w = np.ones(frame_len, dtype=np.float64)
    elif name == "hann":
        w = _periodic_cosine_sum([0.5, -0.5], frame_len)
    elif name == "sqrthann":
        w = np.sqrt(np.maximum(_periodic_cosine_sum([0.5, -0.5], frame_len), 0))
    elif name == "hamming":
        w = _periodic_cosine_sum([0.54, -0.46], frame_len)
    elif name == "blackman":
        w = _periodic_cosine_sum([0.42, -0.5, 0.08], frame_len)
    else:
        raise ValueError(f"Unsupported window: {name}")
    return w.astype(dtype)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Center-pad a window to ``size`` samples (librosa.util.pad_center)."""
    n = window.shape[0]
    if size < n:
        raise ValueError(f"Target size {size} < window length {n}")
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))


def window_sumsquare(window: np.ndarray,
                     n_frames: int,
                     frame_hop: int,
                     n_fft: int) -> np.ndarray:
    """Sum of squared, hop-shifted windows — the iSTFT normalization envelope.

    Equivalent to librosa.filters.window_sumsquare for a precomputed window
    already padded to n_fft.
    """
    total = n_fft + frame_hop * (n_frames - 1)
    wss = np.zeros(total, dtype=np.float64)
    w2 = (window.astype(np.float64))**2
    for t in range(n_frames):
        beg = t * frame_hop
        wss[beg:beg + n_fft] += w2
    return wss


def wss_inverse_blocks(window: np.ndarray, n_frames: int, frame_hop: int,
                       n_fft: int, nsamps: int) -> np.ndarray:
    """Reciprocal window-sum-square envelope for the center-trimmed iSTFT,
    reshaped to (nsamps // hop, hop) sample blocks (the layout the fused
    beamform+iSTFT kernel consumes).  Zero-envelope samples pass through
    unscaled, matching dsp.stft.inverse_stft's guard."""
    wss = window_sumsquare(window, n_frames, frame_hop, n_fft)
    wss = wss[n_fft // 2:n_fft // 2 + nsamps]
    tiny = float(np.finfo(np.float32).tiny)
    inv = np.where(wss > tiny, 1.0 / np.maximum(wss, tiny), 1.0)
    return inv.astype(np.float32).reshape(nsamps // frame_hop, frame_hop)
