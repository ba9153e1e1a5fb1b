"""Batched STFT / iSTFT in PyTorch with librosa-0.8.1 semantics.

Counterpart of ``setk_tpu/dsp/stft.py``: window of length ``frame_len``
center-padded to ``n_fft``, optional reflect center-padding of the
signal by n_fft//2, frames of n_fft samples every ``frame_hop``, rFFT;
the inverse windows each irFFT frame, overlap-adds, divides by the
squared-window envelope where it is above float32 ``tiny`` and trims or
zero-pads to ``nsamps``.  Every function is batched over leading axes;
the complex layout is ``(..., T, F)``.  This is the plain path
(``torch.fft``); the main path's fused kernels live in ``ops/cuda``.
"""

from dataclasses import dataclass
from functools import cached_property

import numpy as np
import torch

from setk_tpu_torch.utils.common import EPSILON, nextpow2
from setk_tpu_torch.dsp.window import make_window, pad_center, window_sumsquare

__all__ = [
    "StftConfig", "num_frames", "frame_signal",
    "forward_stft", "inverse_stft", "overlap_add"
]

# librosa.util.tiny(float32 array)
_TINY = float(np.finfo(np.float32).tiny)


@dataclass(frozen=True)
class StftConfig:
    """STFT parameterization (the toolkit-wide flag set)."""
    frame_len: int = 512
    frame_hop: int = 256
    window: str = "hann"
    center: bool = True
    round_power_of_two: bool = True

    @property
    def n_fft(self) -> int:
        return nextpow2(self.frame_len) if self.round_power_of_two \
            else self.frame_len

    @property
    def num_bins(self) -> int:
        return self.n_fft // 2 + 1

    @cached_property
    def padded_window(self) -> np.ndarray:
        """Analysis window of length frame_len, center-padded to n_fft."""
        return pad_center(make_window(self.window, self.frame_len), self.n_fft)

    def num_frames(self, num_samples: int) -> int:
        return num_frames(num_samples, self)


def num_frames(num_samples: int, cfg: StftConfig) -> int:
    """Frame count the forward transform produces for this many samples."""
    n_fft, hop = cfg.n_fft, cfg.frame_hop
    if cfg.center:
        num_samples = num_samples + 2 * (n_fft // 2)
    if num_samples < n_fft:
        raise ValueError(
            f"num_samples {num_samples} too short for n_fft {n_fft}")
    return 1 + (num_samples - n_fft) // hop


def _reflect_pad(samps: torch.Tensor, pad: int) -> torch.Tensor:
    """numpy ``mode="reflect"`` padding of the last axis (edge excluded)."""
    s = samps.shape[-1]
    if pad >= s:
        raise ValueError(f"reflect pad {pad} needs more than {s} samples")
    idx = np.concatenate([np.arange(pad, 0, -1), np.arange(s),
                          np.arange(s - 2, s - 2 - pad, -1)])
    return samps[..., torch.as_tensor(idx, device=samps.device)]


def frame_signal(samps: torch.Tensor, cfg: StftConfig) -> torch.Tensor:
    """Slice ``(..., S)`` samples into ``(..., T, n_fft)`` frames.

    Applies the center reflect-padding but NOT the window.
    """
    n_fft, hop = cfg.n_fft, cfg.frame_hop
    if cfg.center:
        samps = _reflect_pad(samps, n_fft // 2)
    return samps.unfold(-1, n_fft, hop)


def _window(cfg: StftConfig, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                           device=like.device)


def forward_stft(samps: torch.Tensor,
                 cfg: StftConfig,
                 apply_abs: bool = False,
                 apply_log: bool = False,
                 apply_pow: bool = False) -> torch.Tensor:
    """STFT of ``(..., S)`` float32 samples -> ``(..., T, F)`` complex64."""
    if apply_log:
        apply_abs = True
    frames = frame_signal(samps, cfg) * _window(cfg, samps)
    spec = torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)
    if apply_abs:
        spec = spec.abs()
    if apply_pow:
        spec = spec**2
    if apply_log:
        spec = torch.log(torch.clamp(spec, min=EPSILON))
    return spec


def overlap_add(frames: torch.Tensor, frame_hop: int) -> torch.Tensor:
    """Overlap-add ``(..., T, L)`` frames at the given hop -> ``(..., S)``.

    When L is a multiple of the hop each frame splits into R = L//hop
    hop-sized chunks and output chunk j accumulates frames[j - r, r]
    (R shifted dense adds); otherwise an index_add over the flat frames.
    """
    *batch, n_frames, frame_len = frames.shape
    total = frame_len + frame_hop * (n_frames - 1)
    if frame_len % frame_hop == 0:
        ratio = frame_len // frame_hop
        chunks = frames.reshape(*batch, n_frames, ratio, frame_hop)
        out = frames.new_zeros((*batch, n_frames + ratio - 1, frame_hop))
        for r in range(ratio):
            out[..., r:r + n_frames, :] += chunks[..., :, r, :]
        return out.reshape(*batch, total)
    idx = (np.arange(n_frames)[:, None] * frame_hop +
           np.arange(frame_len)[None, :]).reshape(-1)
    flat = frames.reshape(*batch, n_frames * frame_len)
    out = frames.new_zeros((*batch, total))
    return out.index_add_(-1, torch.as_tensor(idx, device=frames.device),
                          flat)


def inverse_stft(stft_mat: torch.Tensor,
                 cfg: StftConfig,
                 nsamps: int | None = None,
                 norm: float | None = None,
                 power: float | None = None) -> torch.Tensor:
    """iSTFT of ``(..., T, F)`` complex -> ``(..., S)`` real samples.

    ``norm``/``power`` renormalize the output amplitude/power;
    ``nsamps`` trims or zero-pads to an exact length.
    """
    n_fft, hop = cfg.n_fft, cfg.frame_hop
    n_frames = stft_mat.shape[-2]
    window = cfg.padded_window
    frames = torch.fft.irfft(stft_mat, n=n_fft, dim=-1)
    frames = frames * _window(cfg, frames)
    samps = overlap_add(frames, hop)
    wss = torch.as_tensor(window_sumsquare(window, n_frames, hop, n_fft),
                          dtype=samps.dtype, device=samps.device)
    samps = torch.where(wss > _TINY, samps / torch.clamp(wss, min=_TINY),
                        samps)
    if cfg.center:
        half = n_fft // 2
        samps = samps[..., half:samps.shape[-1] - half]
    if nsamps is not None:
        cur = samps.shape[-1]
        if nsamps <= cur:
            samps = samps[..., :nsamps]
        else:
            samps = torch.nn.functional.pad(samps, (0, nsamps - cur))
    if norm is not None:
        peak = samps.abs().amax(dim=-1, keepdim=True)
        samps = samps * norm / (peak + EPSILON)
    if power is not None:
        cur_pow = (samps**2).sum(dim=-1, keepdim=True) / samps.shape[-1]
        samps = samps * torch.sqrt(power / torch.clamp(cur_pow, min=EPSILON))
    return samps
