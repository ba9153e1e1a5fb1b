"""Fused STFT+covariance (kernel A) and beamform+iSTFT (kernel B).

Counterpart of ``setk_tpu/ops/pallas/fused_mvdr.py``'s
``stft_covar_pallas`` and ``beamform_istft_pallas`` (kernel source:
``setk_tpu_torch/csrc/fused_mvdr.cu``).  The contract is the one at
setk_tpu/enhance/pipeline.py:118-132, in natural bin order:

  kernel A: wav (B, N, S) int16 or f32, mask (B, T, 257) f32 ->
            Rs, Rn numerators (B, 257, N, N) complex64, with
            Rs = sum_t m y y^H and Rn = sum_t max(1 - m, 0) y y^H;
  kernel B: wav, weights w (B, 257, N) complex64 and the reciprocal
            window-sum-square envelope (S / 256, 256) -> (B, S) f32.

Geometry: n_fft 512, hop 256, center reflect padding, N <= 8,
S % 256 == 0, S >= 512, T = S / 256 + 1 frames (any T).  int16 audio
enters as is, with 1/32768 folded into the analysis window.  Each
kernel has a plain PyTorch version of the same function beside it.
"""

import torch

from setk_tpu_torch.dsp.stft import StftConfig, frame_signal
from setk_tpu_torch.ops.cuda import _build

__all__ = ["fused_geometry_ok", "stft_covar", "stft_covar_plain",
           "beamform_istft", "beamform_istft_plain", "input_scale"]

NFFT = 512
HOP = 256
BINS = NFFT // 2 + 1
MAX_MICS = 8


def fused_geometry_ok(num_mics: int, nsamps: int) -> bool:
    """The kernels' gate on the waveform shape."""
    return 1 <= num_mics <= MAX_MICS and nsamps % HOP == 0 and nsamps >= NFFT


def input_scale(wav: torch.Tensor) -> float:
    """Sample scale folded into the analysis window."""
    return 1.0 / 32768.0 if wav.dtype == torch.int16 else 1.0


# the kernels' framing: n_fft 512, hop 256, center (the window is passed)
_GEOMETRY = StftConfig(frame_len=NFFT, frame_hop=HOP, center=True)


def _frames_spectrum(wav: torch.Tensor, window: torch.Tensor):
    """(B, N, S) -> (B, N, T, 257) windowed center-reflect STFT."""
    frames = frame_signal(wav.to(torch.float32), _GEOMETRY)
    return torch.fft.rfft(frames * (window * input_scale(wav)), dim=-1)


def stft_covar_plain(wav: torch.Tensor, mask: torch.Tensor,
                     window: torch.Tensor):
    """Plain version of kernel A: (B,N,S), (B,T,257), (512,) -> Rs, Rn."""
    spec = _frames_spectrum(wav, window)              # (B, N, T, F)
    ms = mask.to(torch.float32)
    mn = torch.clamp(1.0 - ms, min=0.0)
    obs = spec.permute(0, 3, 1, 2)                    # (B, F, N, T)

    def covar(m):
        weighted = obs * m.transpose(1, 2)[:, :, None, :]
        return weighted @ obs.conj().transpose(-1, -2)

    return covar(ms), covar(mn)


def beamform_istft_plain(wav: torch.Tensor, w: torch.Tensor,
                         wss_inv: torch.Tensor,
                         window: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel B: (B,N,S), (B,257,N), (S/256,256) -> (B,S)."""
    b, _, s = wav.shape
    spec = _frames_spectrum(wav, window)              # (B, N, T, F)
    enh = (w.conj().transpose(1, 2)[:, :, None, :] * spec).sum(1)
    # only the real part of bins 0 and 256 enters the inverse real DFT
    enh[..., 0] = enh[..., 0].real
    enh[..., -1] = enh[..., -1].real
    frames = torch.fft.irfft(enh, n=NFFT, dim=-1) * window  # (B, T, 512)
    n_frames = frames.shape[1]
    halves = frames.reshape(b, n_frames, 2, HOP)
    # 50% overlap-add with the center trim: out[j] = P[j+1] + Q[j]
    out = halves[:, 1:, 0] + halves[:, :-1, 1]        # (B, T-1, 256)
    return (out * wss_inv).reshape(b, s)


def _check(name, t, device, dtype, shape):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} {shape} "
                         f"tensor on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_wav(fn, wav):
    if wav.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {wav.device}")
    if wav.ndim != 3 or wav.dtype not in (torch.int16, torch.float32) or \
            not wav.is_contiguous():
        raise ValueError(f"{fn}: wav must be a contiguous (B, N, S) int16 "
                         f"or float32 tensor")
    b, n, s = wav.shape
    if b == 0 or not fused_geometry_ok(n, s):
        raise ValueError(f"{fn}: shape {tuple(wav.shape)} is outside the "
                         f"kernel's gate (N <= {MAX_MICS}, S % {HOP} == 0, "
                         f"S >= {NFFT})")
    return b, n, s


def _frame_runs(batch: int, n_frames: int, device: torch.device) -> int:
    """Runs of frames kernel A splits each utterance into: the most that
    keep every block in one wave at two blocks per SM (its register
    budget), with at least 16 frames a run."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(2 * sms // batch, n_frames // 16))


def stft_covar(wav: torch.Tensor, mask: torch.Tensor,
               window: torch.Tensor):
    """Kernel A: Rs, Rn numerators (B, 257, N, N) complex64.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``stft_covar.launches`` counts those launches).
    """
    if wav.device.type == "cpu":
        return stft_covar_plain(wav, mask, window)
    b, n, s = _check_wav("stft_covar", wav)
    t = s // HOP + 1
    _check("mask", mask, wav.device, torch.float32, (b, t, BINS))
    _check("window", window, wav.device, torch.float32, (NFFT,))
    win = (window * input_scale(wav)).contiguous()
    runs = _frame_runs(b, t, wav.device)
    part = torch.empty((b, runs, BINS, n * (n + 1)), dtype=torch.complex64,
                       device=wav.device)
    rs = torch.empty((b, BINS, n, n), dtype=torch.complex64,
                     device=wav.device)
    rn = torch.empty_like(rs)
    lib = _build.library("fused_mvdr")
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stft_covar_launch(wav.data_ptr(), mask.data_ptr(),
                                    win.data_ptr(), part.data_ptr(),
                                    rs.data_ptr(), rn.data_ptr(), b, n, s,
                                    runs, int(wav.dtype == torch.int16),
                                    stream)
    _build.check(err, "stft_covar_launch")
    stft_covar.launches += 1
    return rs, rn


def beamform_istft(wav: torch.Tensor, w: torch.Tensor,
                   wss_inv: torch.Tensor,
                   window: torch.Tensor) -> torch.Tensor:
    """Kernel B: enhanced (B, S) float32 waveform.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``beamform_istft.launches`` counts those launches).
    """
    if wav.device.type == "cpu":
        return beamform_istft_plain(wav, w, wss_inv, window)
    b, n, s = _check_wav("beamform_istft", wav)
    _check("w", w, wav.device, torch.complex64, (b, BINS, n))
    _check("wss_inv", wss_inv, wav.device, torch.float32, (s // HOP, HOP))
    _check("window", window, wav.device, torch.float32, (NFFT,))
    win = (window * input_scale(wav)).contiguous()
    out = torch.empty((b, s), dtype=torch.float32, device=wav.device)
    lib = _build.library("fused_mvdr")
    with torch.cuda.device(wav.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.beamform_istft_launch(wav.data_ptr(), w.data_ptr(),
                                        wss_inv.data_ptr(), win.data_ptr(),
                                        window.data_ptr(), out.data_ptr(),
                                        b, n, s,
                                        int(wav.dtype == torch.int16),
                                        stream)
    _build.check(err, "beamform_istft_launch")
    beamform_istft.launches += 1
    return out


stft_covar.launches = 0
beamform_istft.launches = 0
