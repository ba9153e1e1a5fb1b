"""The fused MVDR enhancement pipeline (the main path on the card).

Counterpart of ``setk_tpu/enhance/pipeline.py: enhance_fused``
(pipeline.py:60-196) for ``beamformer="mvdr"`` with the power-iteration
steer, with or without BAN: kernel A (ops/cuda/fused_mvdr.stft_covar)
emits the Rs/Rn numerators with no spectrum in device memory, the
per-bin solve (ops/cuda/mvdr.mvdr_power) gives the weights, and kernel
B (fused_mvdr.beamform_istft) recomputes the DFT to beamform and
resynthesize.  Bins stay in natural order.  ``enhance_plain`` runs the
same steps through the kernels' plain versions on any device; it is
what the kernels are held against.
"""

import functools

import torch

from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.dsp.window import wss_inverse_blocks
from setk_tpu_torch.enhance.beamformer import do_ban
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.utils.device import full_f32_matmuls

__all__ = ["fused_supported", "enhance_fused", "enhance_plain"]


def fused_supported(cfg: StftConfig, num_mics: int, nsamps: int,
                    out_samps: int) -> bool:
    """The port's gate for the fused kernels: n_fft 512, hop 256,
    center, N <= 8, S % 256 == 0, S >= 512 and out_samps == (T-1)*256.
    Any frame count T (the TPU's T <= 512 cap does not apply)."""
    if not (cfg.n_fft == fm.NFFT and cfg.frame_hop == fm.HOP and cfg.center
            and fm.fused_geometry_ok(num_mics, nsamps)):
        return False
    return out_samps == (cfg.num_frames(nsamps) - 1) * fm.HOP


@functools.lru_cache(maxsize=64)
def _constants(cfg: StftConfig, n_frames: int, out_samps: int,
               device: torch.device):
    """The analysis window and the reciprocal window-sum-square blocks on
    ``device``, built once per shape: a host-to-device copy from pageable
    memory waits for the work already queued on the card, so building them
    per call would serialize consecutive batches.  Callers never write
    to them."""
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=device)
    wss_inv = torch.as_tensor(
        wss_inverse_blocks(cfg.padded_window, n_frames, cfg.frame_hop,
                           cfg.n_fft, out_samps), device=device)
    return window, wss_inv


def _run(wav, mask_s, cfg, ban, power_iters, nsamps, stft_covar,
         mvdr_power, beamform_istft):
    b, n, s = wav.shape
    out_samps = nsamps if nsamps is not None else s
    if not fused_supported(cfg, n, s, out_samps):
        raise ValueError(f"wav {tuple(wav.shape)} with out_samps "
                         f"{out_samps} is outside the fused kernels' gate")
    t = cfg.num_frames(s)
    window, wss_inv = _constants(cfg, t, out_samps, wav.device)
    mask = mask_s.to(torch.float32).contiguous()
    rs_num, rn_num = stft_covar(wav, mask, window)     # (B, F, N, N)
    den_s = mask.sum(dim=1)                            # (B, F)
    den_n = t - den_s
    rs = rs_num / torch.clamp(den_s, min=1e-6)[..., None, None]
    rn = rn_num / torch.clamp(den_n, min=1e-6)[..., None, None]
    w = mvdr_power(rs, rn, power_iters=power_iters)   # (B, F, N)
    if ban:
        w = do_ban(w, rn).contiguous()
    return beamform_istft(wav, w, wss_inv, window)


def enhance_fused(wav: torch.Tensor,
                  mask_s: torch.Tensor,
                  cfg: StftConfig,
                  beamformer: str = "mvdr",
                  ban: bool = False,
                  steer: str = "power",
                  power_iters: int = 15,
                  nsamps: int | None = None) -> torch.Tensor:
    """(B, N, S) wav + (B, T, F) speech mask -> (B, S) enhanced wav.

    ``wav`` may be int16: the kernels convert it with 1/32768 folded
    into the analysis window.  The output matches running on
    ``wav.float() / 32768``.
    """
    if beamformer != "mvdr":
        raise NotImplementedError(
            f"fused beamformer {beamformer!r} arrives with ROADMAP queue 2 "
            f"items 4-6 (gevd, pmwf and capon solves)")
    if steer != "power":
        raise NotImplementedError(
            "the fused pipeline's eigh steer arrives with the batched "
            "small-matrix EVD kernel, ROADMAP queue 2 item 14")
    return _run(wav, mask_s, cfg, ban, power_iters, nsamps, fm.stft_covar,
                mv.mvdr_power, fm.beamform_istft)


def enhance_plain(wav: torch.Tensor,
                  mask_s: torch.Tensor,
                  cfg: StftConfig,
                  ban: bool = False,
                  power_iters: int = 15,
                  nsamps: int | None = None) -> torch.Tensor:
    """``enhance_fused`` through the kernels' plain versions, on the
    tensors' own device: the reference the kernels are held against."""
    full_f32_matmuls(wav.device)
    return _run(wav, mask_s, cfg, ban, power_iters, nsamps,
                fm.stft_covar_plain, mv.mvdr_power_plain,
                fm.beamform_istft_plain)
