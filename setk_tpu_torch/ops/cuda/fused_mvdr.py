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

The online (chunked EMA) pair, counterpart of ``stft_covar_online_pallas``
and ``beamform_istft_online_pallas``, in three launches (the MVDR solve
between them is ``ops/cuda/mvdr.mvdr_power`` on every chunk's state):

  kernel A per chunk (stft_covar_chunks): each chunk of ``chunk`` frames
            summed on its own (a block takes one chunk or, for short
            chunks, several) -> per-chunk numerators (B, C, 257, N (N+1))
            complex64, Rs pairs then Rn pairs of the upper triangle in row
            order;
  covar_ema: the chunk sums normalized by the chunk's mask sums and
            carried as E <- alpha E + (1 - alpha) R_c (the first chunk
            initializes) -> Es, En (B, C, 257, N, N) complex64;
  beamform_istft_online: kernel B with weights (B, C, 257, N), frame t
            beamformed with chunk t // chunk's row.

C = ceil(T / chunk) for any chunk >= 1 (the TPU's chunk | 128 and
chunk >= 8 do not apply).

Geometry: n_fft 512, hop 256, center reflect padding, N <= 8,
S % 256 == 0, S >= 512, T = S / 256 + 1 frames (any T).  int16 audio
enters as is, with 1/32768 folded into the analysis window.  Each
kernel has a plain PyTorch version of the same function beside it.
"""

import ctypes
import math

import torch

from setk_tpu_torch.dsp.stft import StftConfig, frame_signal
from setk_tpu_torch.ops.cuda import _build

__all__ = ["fused_geometry_ok", "stft_covar", "stft_covar_plain",
           "beamform_istft", "beamform_istft_plain", "input_scale",
           "num_chunks", "stft_covar_chunks", "stft_covar_chunks_plain",
           "covar_ema", "covar_ema_plain", "beamform_istft_online",
           "beamform_istft_online_plain"]

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
    spec = _frames_spectrum(wav, window)              # (B, N, T, F)
    enh = (w.conj().transpose(1, 2)[:, :, None, :] * spec).sum(1)
    return _synthesize(enh, wss_inv, window)


def _synthesize(enh: torch.Tensor, wss_inv: torch.Tensor,
                window: torch.Tensor) -> torch.Tensor:
    """(B, T, 257) beamformed spectrum -> (B, (T-1) 256) waveform."""
    b = enh.shape[0]
    # only the real part of bins 0 and 256 enters the inverse real DFT
    enh[..., 0] = enh[..., 0].real
    enh[..., -1] = enh[..., -1].real
    frames = torch.fft.irfft(enh, n=NFFT, dim=-1) * window  # (B, T, 512)
    n_frames = frames.shape[1]
    halves = frames.reshape(b, n_frames, 2, HOP)
    # 50% overlap-add with the center trim: out[j] = P[j+1] + Q[j]
    out = halves[:, 1:, 0] + halves[:, :-1, 1]        # (B, T-1, 256)
    return (out * wss_inv).reshape(b, -1)


def num_chunks(n_frames: int, chunk: int) -> int:
    """Chunks of ``chunk`` frames that cover ``n_frames`` frames."""
    return -(-n_frames // chunk)


def _by_chunk(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """(..., T) -> (..., C, chunk), zero-padded at the end."""
    t = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, num_chunks(t, chunk) * chunk - t))
    return x.reshape(*x.shape[:-1], -1, chunk)


def _mics_of_pairs(two_np: int) -> int:
    """N from the N (N+1) pair sums of a part row."""
    return (math.isqrt(4 * two_np + 1) - 1) // 2


def _upper(n: int, device) -> torch.Tensor:
    """Row and column of the upper triangle's pairs, in row order."""
    return torch.triu_indices(n, n, device=device)


def stft_covar_chunks_plain(wav: torch.Tensor, mask: torch.Tensor,
                            window: torch.Tensor, chunk: int) -> torch.Tensor:
    """Plain version of kernel A per chunk: (B,N,S), (B,T,257), (512,) ->
    part (B, C, 257, N (N+1)) complex64."""
    spec = _frames_spectrum(wav, window)              # (B, N, T, F)
    n = spec.shape[1]
    obs = _by_chunk(spec.permute(0, 3, 1, 2), chunk)  # (B, F, N, C, L)
    obs = obs.permute(0, 3, 1, 2, 4)                  # (B, C, F, N, L)
    ms = mask.to(torch.float32).transpose(1, 2)       # (B, F, T)
    row, col = _upper(n, wav.device)

    def pairs(m):
        m = _by_chunk(m, chunk).transpose(1, 2)       # (B, C, F, L)
        r = (obs * m[..., None, :]) @ obs.conj().transpose(-1, -2)
        return r[..., row, col]

    return torch.cat([pairs(ms), pairs(torch.clamp(1.0 - ms, min=0.0))],
                     dim=-1)


def covar_ema_plain(part: torch.Tensor, mask: torch.Tensor, chunk: int,
                    alpha: float):
    """Plain version of covar_ema: part (B, C, 257, N (N+1)), mask
    (B, T, 257) -> Es, En (B, C, 257, N, N) complex64."""
    b, c, f, two_np = part.shape
    n = _mics_of_pairs(two_np)
    row, col = _upper(n, part.device)
    ms = mask.to(torch.float32).transpose(1, 2)       # (B, F, T)

    def state(pairs, m):
        r = part.new_zeros((b, c, f, n, n))
        r[..., col, row] = pairs.conj()
        r[..., row, col] = pairs
        den = _by_chunk(m, chunk).sum(-1).transpose(1, 2)   # (B, C, F)
        r = r / torch.clamp(den, min=1e-6)[..., None, None]
        e = [r[:, 0]]
        for i in range(1, c):
            e.append(alpha * e[-1] + (1.0 - alpha) * r[:, i])
        return torch.stack(e, dim=1)

    half = two_np // 2
    return (state(part[..., :half], ms),
            state(part[..., half:], torch.clamp(1.0 - ms, min=0.0)))


def beamform_istft_online_plain(wav: torch.Tensor, w: torch.Tensor,
                                wss_inv: torch.Tensor, window: torch.Tensor,
                                chunk: int) -> torch.Tensor:
    """Plain version of the online kernel B: (B,N,S), w (B,C,257,N),
    (S/256,256) -> (B,S); frame t takes chunk t // chunk's weights."""
    spec = _frames_spectrum(wav, window)              # (B, N, T, F)
    t = spec.shape[2]
    w_t = w.repeat_interleave(chunk, dim=1)[:, :t]    # (B, T, F, N)
    enh = (w_t.conj().permute(0, 3, 1, 2) * spec).sum(1)
    return _synthesize(enh, wss_inv, window)


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


def _launch(fn: str, device: torch.device, *args) -> None:
    _build.launch("fused_mvdr", fn, device, *args)


_LAYOUTS = {}


def kernel_a_layout(num_mics: int, int16: bool, device: torch.device) -> dict:
    """Kernel A's shape on ``device`` for ``num_mics`` mics: blocks an SM,
    threads a block, frames a tile, shared memory bytes and the SMs."""
    key = (device.index, num_mics, int16)
    if key not in _LAYOUTS:
        out = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            _build.check(_build.library("fused_mvdr").stft_covar_layout(
                num_mics, int(int16), ctypes.addressof(out)),
                "stft_covar_layout")
        _LAYOUTS[key] = dict(zip(("blocks_per_sm", "threads",
                                  "frames_a_tile", "smem_bytes", "sms"),
                                 out))
    return _LAYOUTS[key]


def kernel_b_layout(num_mics: int, int16: bool, online: bool, batch: int,
                    nsamps: int, device: torch.device) -> dict:
    """Kernel B's shape on ``device`` (``online``: the per-chunk entry):
    blocks an SM, threads a block, frames a tile, shared memory bytes, the
    SMs, and the runs of output blocks an utterance that its launch takes
    for ``batch`` utterances of ``nsamps`` samples (the launcher picks
    them with frame_runs' rule)."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        _build.check(_build.library("fused_mvdr").beamform_istft_layout(
            num_mics, int(int16), int(online), batch, nsamps,
            ctypes.addressof(out)), "beamform_istft_layout")
    return dict(zip(("blocks_per_sm", "threads", "frames_a_tile",
                     "smem_bytes", "sms", "runs"), out))


def frame_runs(batch: int, n_frames: int, slots: int, tile: int) -> int:
    """Runs of frames kernel A splits each utterance into, a block each:
    the fewest that fill the card's ``slots`` (blocks an SM x SMs) as well
    as any count does, each run at least one tile of ``tile`` frames."""
    most = max(1, min(-(-2 * slots // batch), n_frames // tile))

    def filled(k):
        blocks = batch * k
        return blocks / (-(-blocks // slots) * slots)

    return max(range(1, most + 1), key=lambda k: (filled(k), -k))


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
    layout = kernel_a_layout(n, wav.dtype == torch.int16, wav.device)
    runs = frame_runs(b, t, layout["blocks_per_sm"] * layout["sms"],
                      layout["frames_a_tile"])
    part = torch.empty((b, runs, BINS, n * (n + 1)), dtype=torch.complex64,
                       device=wav.device)
    rs = torch.empty((b, BINS, n, n), dtype=torch.complex64,
                     device=wav.device)
    rn = torch.empty_like(rs)
    _launch("stft_covar_launch", wav.device, wav.data_ptr(),
            mask.data_ptr(), win.data_ptr(), part.data_ptr(), rs.data_ptr(),
            rn.data_ptr(), b, n, s, runs, int(wav.dtype == torch.int16))
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
    _launch("beamform_istft_launch", wav.device, wav.data_ptr(),
            w.data_ptr(), wss_inv.data_ptr(), win.data_ptr(),
            window.data_ptr(), out.data_ptr(), b, n, s,
            int(wav.dtype == torch.int16))
    beamform_istft.launches += 1
    return out


def _check_chunk(fn: str, chunk: int) -> None:
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"{fn}: chunk must be an int >= 1, got {chunk!r}")


def stft_covar_chunks(wav: torch.Tensor, mask: torch.Tensor,
                      window: torch.Tensor, chunk: int) -> torch.Tensor:
    """Kernel A with one run per chunk of frames: the per-chunk
    numerators (B, C, 257, N (N+1)) complex64, Rs pairs then Rn pairs.

    A CPU tensor runs the plain version; a CUDA tensor launches kernel A
    (counted in ``stft_covar.launches``: it is the same kernel).
    """
    if wav.device.type == "cpu":
        return stft_covar_chunks_plain(wav, mask, window, chunk)
    b, n, s = _check_wav("stft_covar_chunks", wav)
    _check_chunk("stft_covar_chunks", chunk)
    t = s // HOP + 1
    _check("mask", mask, wav.device, torch.float32, (b, t, BINS))
    _check("window", window, wav.device, torch.float32, (NFFT,))
    win = (window * input_scale(wav)).contiguous()
    part = torch.empty((b, num_chunks(t, chunk), BINS, n * (n + 1)),
                       dtype=torch.complex64, device=wav.device)
    _launch("stft_covar_chunks_launch", wav.device, wav.data_ptr(),
            mask.data_ptr(), win.data_ptr(), part.data_ptr(), b, n, s, chunk,
            int(wav.dtype == torch.int16))
    stft_covar.launches += 1
    return part


def covar_ema(part: torch.Tensor, mask: torch.Tensor, chunk: int,
              alpha: float):
    """The online state after each chunk: Es, En (B, C, 257, N, N)
    complex64 from kernel A's per-chunk numerators and the mask.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``covar_ema.launches`` counts those launches).
    """
    if part.device.type == "cpu":
        return covar_ema_plain(part, mask, chunk, alpha)
    if part.device.type != "cuda" or part.ndim != 4:
        raise ValueError(f"covar_ema: part must be a (B, C, 257, N (N+1)) "
                         f"CUDA tensor, got {tuple(part.shape)} on "
                         f"{part.device}")
    _check_chunk("covar_ema", chunk)
    b, c, _, two_np = part.shape
    n = _mics_of_pairs(two_np)
    t = mask.shape[1] if mask.ndim == 3 else -1
    if not 1 <= n <= MAX_MICS or n * (n + 1) != two_np or t < 1 or \
            num_chunks(t, chunk) != c:
        raise ValueError(f"covar_ema: part {tuple(part.shape)} does not "
                         f"hold chunks of {chunk} frames of mask "
                         f"{tuple(mask.shape)}")
    _check("part", part, part.device, torch.complex64,
           (b, c, BINS, two_np))
    _check("mask", mask, part.device, torch.float32, (b, t, BINS))
    es = torch.empty((b, c, BINS, n, n), dtype=torch.complex64,
                     device=part.device)
    en = torch.empty_like(es)
    _launch("covar_ema_launch", part.device, part.data_ptr(),
            mask.data_ptr(), es.data_ptr(), en.data_ptr(), b, n, t, chunk,
            float(alpha))
    covar_ema.launches += 1
    return es, en


def beamform_istft_online(wav: torch.Tensor, w: torch.Tensor,
                          wss_inv: torch.Tensor, window: torch.Tensor,
                          chunk: int) -> torch.Tensor:
    """Online kernel B: enhanced (B, S) float32 waveform from per-chunk
    weights w (B, C, 257, N) complex64.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``beamform_istft_online.launches`` counts those launches).
    """
    if wav.device.type == "cpu":
        return beamform_istft_online_plain(wav, w, wss_inv, window, chunk)
    b, n, s = _check_wav("beamform_istft_online", wav)
    _check_chunk("beamform_istft_online", chunk)
    _check("w", w, wav.device, torch.complex64,
           (b, num_chunks(s // HOP + 1, chunk), BINS, n))
    _check("wss_inv", wss_inv, wav.device, torch.float32, (s // HOP, HOP))
    _check("window", window, wav.device, torch.float32, (NFFT,))
    win = (window * input_scale(wav)).contiguous()
    out = torch.empty((b, s), dtype=torch.float32, device=wav.device)
    _launch("beamform_istft_online_launch", wav.device, wav.data_ptr(),
            w.data_ptr(), wss_inv.data_ptr(), win.data_ptr(),
            window.data_ptr(), out.data_ptr(), b, n, s, chunk,
            int(wav.dtype == torch.int16))
    beamform_istft_online.launches += 1
    return out


for _fn in (stft_covar, beamform_istft, covar_ema, beamform_istft_online):
    _fn.launches = 0
