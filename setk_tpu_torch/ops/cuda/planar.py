"""Planar STFT (kernel 9) and planar iSTFT (kernel 10).

Counterpart of ``setk_tpu/ops/pallas/stft.py``'s
``forward_stft_pallas_planar`` (:195, over ``_stft_pallas_blocks`` :126
and ``_stft_pallas_wavblocks`` :157) and ``inverse_stft_pallas_planar``
(:365, over ``_istft_pallas`` :300); kernel source
``setk_tpu_torch/csrc/planar_stft.cu``.  For n_fft = 2 hop, n_fft a power
of two in [256, 2048]:

  stft_planar:  samples (..., S) int16 or f32 and the analysis window
                (n_fft,) -> re, im (..., T, n_fft/2) f32 (bins 0 ..
                n_fft/2 - 1) and the real Nyquist bin (..., T), with
                center reflect framing or none; T is the frame count
                (no padding rows), S >= n_fft;
  istft_planar: a beamformed spectrum re, im (B, T, n_fft/2) and its
                Nyquist real part (B, T), the synthesis window and the
                reciprocal window-sum-square of the center-trimmed
                signal -> (B, nsamps) f32 for center framing and any
                nsamps: samples at or past (T - 1) hop are zeros, as
                ``dsp.stft.inverse_stft`` zero-pads after its trim;
  beamform_istft_planar: kernel 10 with the MVDR beamform folded in: the
                observation's planes re, im (B, N, T, n_fft/2), its
                Nyquist plane (B, N, T) and the weights w (B, n_fft/2 +
                1, N) complex64 -> (B, nsamps) f32, ``planar_beamform``
                (setk_tpu/enhance/pipeline.py:259-269) then istft_planar.

int16 audio enters as is, with 1/32768 folded into the analysis window;
the output matches running on ``wav.float() / 32768``.  Each kernel has
a plain PyTorch version of the same function beside it.
"""

import math

import numpy as np
import torch

from setk_tpu_torch.dsp.window import wss_inverse_blocks
from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.ops.cuda.fused_mvdr import input_scale

__all__ = ["PLANAR_NFFT", "planar_frames", "valid_samples",
           "istft_wss_inverse", "stft_planar", "stft_planar_plain",
           "istft_planar", "istft_planar_plain", "planar_beamform",
           "beamform_istft_planar", "beamform_istft_planar_plain"]

PLANAR_NFFT = (256, 512, 1024, 2048)
MAX_MICS = 8    # beamform_istft_planar's weights sit in shared memory


def planar_frames(nsamps: int, n_fft: int, center: bool) -> int:
    """Frames of hop n_fft / 2 over ``nsamps`` samples."""
    hop = n_fft // 2
    return 1 + nsamps // hop if center else 1 + (nsamps - n_fft) // hop


def valid_samples(n_frames: int, hop: int, nsamps: int) -> int:
    """Samples of a center-trimmed iSTFT that carry signal: the rest of
    ``nsamps`` are zeros."""
    return min(nsamps, (n_frames - 1) * hop)


def istft_wss_inverse(window: np.ndarray, n_frames: int,
                      nsamps: int) -> np.ndarray:
    """The reciprocal window-sum-square over the signal-carrying samples
    of a center-trimmed iSTFT at hop n_fft / 2, flat, whole hop blocks."""
    hop = window.shape[0] // 2
    blocks = -(-valid_samples(n_frames, hop, nsamps) // hop)
    return wss_inverse_blocks(window, n_frames, hop, 2 * hop,
                              blocks * hop).reshape(-1)


def stft_planar_plain(samps: torch.Tensor, window: torch.Tensor,
                      center: bool = True):
    """Plain version of kernel 9: (..., S), (n_fft,) -> re, im, nyq."""
    n_fft = window.shape[0]
    hop = n_fft // 2
    x = samps.to(torch.float32)
    if center:
        lead = x.shape[:-1]
        x = torch.nn.functional.pad(x.reshape(-1, 1, x.shape[-1]),
                                    (hop, hop), mode="reflect")
        x = x.reshape(*lead, -1)
    frames = x.unfold(-1, n_fft, hop)                 # (..., T, n_fft)
    spec = torch.fft.rfft(frames * (window * input_scale(samps)), dim=-1)
    return (spec.real[..., :hop].contiguous(),
            spec.imag[..., :hop].contiguous(),
            spec.real[..., hop].contiguous())


def istft_planar_plain(er: torch.Tensor, ei: torch.Tensor, ny: torch.Tensor,
                       window: torch.Tensor, wss_inv: torch.Tensor,
                       nsamps: int) -> torch.Tensor:
    """Plain version of kernel 10: (B,T,n_fft/2) x2, (B,T) -> (B, nsamps)."""
    b, t, hop = er.shape
    zero = er.new_zeros((b, t, 1))
    # only the real part of bins 0 and n_fft/2 enters the inverse real DFT
    enh = torch.complex(torch.cat([er, ny[..., None]], dim=-1),
                        torch.cat([zero, ei[..., 1:], zero], dim=-1))
    frames = torch.fft.irfft(enh, n=2 * hop, dim=-1) * window
    halves = frames.reshape(b, t, 2, hop)
    # 50% overlap-add with the center trim: out[j] = P[j+1] + Q[j]
    ola = (halves[:, 1:, 0] + halves[:, :-1, 1]).reshape(b, -1)
    n_valid = valid_samples(t, hop, nsamps)
    out = ola[:, :n_valid] * wss_inv[:n_valid]
    return torch.nn.functional.pad(out, (0, nsamps - n_valid))


def planar_beamform(re: torch.Tensor, im: torch.Tensor, nyq: torch.Tensor,
                    w: torch.Tensor):
    """enh[b, t, f] = sum_n conj(w[b, f, n]) obs[b, n, t, f] on the planes:
    (B, N, T, n_fft/2) x2, (B, N, T), (B, n_fft/2 + 1, N) -> enh_re,
    enh_im (B, T, n_fft/2) and the Nyquist bin's real part (B, T)."""
    fh = re.shape[-1]
    wr = w[:, :fh].real.transpose(1, 2)[:, :, None, :]    # (B, N, 1, FH)
    wi = w[:, :fh].imag.transpose(1, 2)[:, :, None, :]
    enh_re = (wr * re + wi * im).sum(1)                   # (B, T, FH)
    enh_im = (wr * im - wi * re).sum(1)
    ny_re = (w[:, fh].real[:, :, None] * nyq).sum(1)      # (B, T)
    return enh_re, enh_im, ny_re


def beamform_istft_planar_plain(re: torch.Tensor, im: torch.Tensor,
                                nyq: torch.Tensor, w: torch.Tensor,
                                window: torch.Tensor, wss_inv: torch.Tensor,
                                nsamps: int) -> torch.Tensor:
    """Plain version of kernel 10 with the beamform: ``planar_beamform``
    then ``istft_planar_plain``."""
    return istft_planar_plain(*planar_beamform(re, im, nyq, w), window,
                              wss_inv, nsamps)


def _check_window(fn: str, window: torch.Tensor, device) -> int:
    n_fft = window.shape[0] if window.ndim == 1 else -1
    if n_fft not in PLANAR_NFFT or window.dtype != torch.float32 or \
            window.device != device:
        raise ValueError(f"{fn}: window must be a float32 (n_fft,) tensor "
                         f"on {device} with n_fft in {PLANAR_NFFT}; got "
                         f"{window.dtype} {tuple(window.shape)} on "
                         f"{window.device}")
    return n_fft


def stft_planar(samps: torch.Tensor, window: torch.Tensor,
                center: bool = True):
    """Kernel 9: (re, im, nyq) planes of (..., S) samples.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``stft_planar.launches`` counts those launches).
    """
    if samps.device.type == "cpu":
        return stft_planar_plain(samps, window, center)
    if samps.device.type != "cuda" or samps.ndim < 1 or \
            samps.dtype not in (torch.int16, torch.float32) or \
            not samps.is_contiguous():
        raise ValueError(f"stft_planar: samples must be a contiguous int16 "
                         f"or float32 CUDA tensor, got {samps.dtype} "
                         f"{tuple(samps.shape)} on {samps.device}")
    n_fft = _check_window("stft_planar", window, samps.device)
    s = samps.shape[-1]
    rows = math.prod(samps.shape[:-1])
    if rows == 0 or s < n_fft:
        raise ValueError(f"stft_planar: shape {tuple(samps.shape)} needs "
                         f"at least one row of S >= n_fft = {n_fft} samples")
    t = planar_frames(s, n_fft, center)
    lead = samps.shape[:-1]
    win = (window * input_scale(samps)).contiguous()
    re = torch.empty((*lead, t, n_fft // 2), dtype=torch.float32,
                     device=samps.device)
    im = torch.empty_like(re)
    nyq = torch.empty((*lead, t), dtype=torch.float32, device=samps.device)
    _build.launch("planar_stft", "stft_planar_launch", samps.device,
                  samps.data_ptr(), win.data_ptr(), re.data_ptr(),
                  im.data_ptr(), nyq.data_ptr(), rows, s, n_fft, int(center),
                  int(samps.dtype == torch.int16))
    stft_planar.launches += 1
    return re, im, nyq


def istft_planar(er: torch.Tensor, ei: torch.Tensor, ny: torch.Tensor,
                 window: torch.Tensor, wss_inv: torch.Tensor,
                 nsamps: int) -> torch.Tensor:
    """Kernel 10: (B, nsamps) float32 waveform of a planar spectrum.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``istft_planar.launches`` counts those launches).
    """
    if er.device.type == "cpu":
        return istft_planar_plain(er, ei, ny, window, wss_inv, nsamps)
    dev = er.device
    n_fft = _check_window("istft_planar", window, dev)
    if er.ndim != 3 or er.shape[-1] != n_fft // 2 or er.shape[1] < 2:
        raise ValueError(f"istft_planar: re must be (B, T >= 2, "
                         f"{n_fft // 2}), got {tuple(er.shape)}")
    b, t, _ = er.shape
    n_valid = _check_istft("istft_planar", (("re", er, er.shape),
                                            ("im", ei, er.shape),
                                            ("nyq", ny, (b, t))),
                           wss_inv, t, n_fft, nsamps, dev)
    out = torch.empty((b, nsamps), dtype=torch.float32, device=dev)
    _build.launch("planar_stft", "istft_planar_launch", dev, er.data_ptr(),
                  ei.data_ptr(), ny.data_ptr(), window.data_ptr(),
                  wss_inv.data_ptr(), out.data_ptr(), b, t, n_fft, n_valid,
                  nsamps)
    istft_planar.launches += 1
    return out


def beamform_istft_planar(re: torch.Tensor, im: torch.Tensor,
                          nyq: torch.Tensor, w: torch.Tensor,
                          window: torch.Tensor, wss_inv: torch.Tensor,
                          nsamps: int) -> torch.Tensor:
    """Kernel 10 with the beamform: (B, nsamps) float32 waveform of the
    MVDR output of an observation's planes (``planar_beamform`` then
    ``istft_planar``), no beamformed spectrum in device memory.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``beamform_istft_planar.launches`` counts those launches).
    """
    if re.device.type == "cpu":
        return beamform_istft_planar_plain(re, im, nyq, w, window, wss_inv,
                                           nsamps)
    dev = re.device
    n_fft = _check_window("beamform_istft_planar", window, dev)
    fh = n_fft // 2
    if re.ndim != 4 or re.shape[-1] != fh or re.shape[2] < 2 or \
            not 1 <= re.shape[1] <= MAX_MICS:
        raise ValueError(f"beamform_istft_planar: re must be (B, 1 <= N <= "
                         f"{MAX_MICS}, T >= 2, {fh}), got "
                         f"{tuple(re.shape)}")
    b, n, t, _ = re.shape
    if w.device != dev or w.dtype != torch.complex64 or \
            w.shape != (b, fh + 1, n) or not w.is_contiguous():
        raise ValueError(f"beamform_istft_planar: w must be a contiguous "
                         f"complex64 {(b, fh + 1, n)} tensor on {dev}")
    n_valid = _check_istft("beamform_istft_planar",
                           (("re", re, re.shape), ("im", im, re.shape),
                            ("nyq", nyq, (b, n, t))),
                           wss_inv, t, n_fft, nsamps, dev)
    out = torch.empty((b, nsamps), dtype=torch.float32, device=dev)
    _build.launch("planar_stft", "beamform_istft_planar_launch", dev,
                  re.data_ptr(), im.data_ptr(), nyq.data_ptr(), w.data_ptr(),
                  window.data_ptr(), wss_inv.data_ptr(), out.data_ptr(), b,
                  n, t, n_fft, n_valid, nsamps)
    beamform_istft_planar.launches += 1
    return out


def _check_istft(fn, planes, wss_inv, t, n_fft, nsamps, dev) -> int:
    """Raise unless every (name, tensor, shape) of ``planes`` is a
    contiguous float32 tensor of that shape on ``dev`` and wss_inv covers
    the samples with signal; return their count."""
    n_valid = valid_samples(t, n_fft // 2, nsamps)
    for name, x, shape in planes:
        if x.device != dev or x.dtype != torch.float32 or \
                x.shape != shape or not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous float32 "
                             f"{tuple(shape)} tensor on {dev}")
    if wss_inv.device != dev or wss_inv.dtype != torch.float32 or \
            wss_inv.ndim != 1 or wss_inv.shape[0] < n_valid or \
            not wss_inv.is_contiguous() or not 1 <= nsamps:
        raise ValueError(f"{fn}: wss_inv must be a contiguous float32 "
                         f"vector of >= {n_valid} samples on {dev} and "
                         f"nsamps >= 1")
    return n_valid


for _fn in (stft_planar, istft_planar, beamform_istft_planar):
    _fn.launches = 0
