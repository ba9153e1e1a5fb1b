"""Batched mask-based enhancement: the main-path library entry.

Counterpart of ``setk_tpu/parallel/enhance_step.enhance_batch``
(enhance_step.py:30-121).  On a CUDA device the whole step runs
through the fused kernels: enhance/pipeline.enhance_fused for every
beamformer in ``FUSED_BEAMFORMERS``, and for ``chunk_size > 0``
enhance/pipeline.mvdr_enhance_fused_online (mvdr, power steer, no BAN).
On the CPU it runs the spectrum-domain plain path (STFT -> masked PSDs
-> weights -> beamform -> iSTFT), one-shot or online (chunked EMA), as
the JAX package does off the TPU.  The other online cases on the card
come with ROADMAP queue 1 item 13, the sharded multi-device step with
queue 1 item 12.
"""

import numpy as np
import torch

from setk_tpu_torch.dsp.stft import StftConfig, forward_stft, inverse_stft
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance.pipeline import (check_fused_options,
                                             enhance_fused,
                                             fused_online_supported,
                                             fused_supported,
                                             mvdr_enhance_fused_online)
from setk_tpu_torch.utils.device import resolve_device

__all__ = ["enhance_batch", "check_cuda_options"]


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def check_cuda_options(beamformer: str, ban: bool, steer: str,
                       chunk_size: int) -> None:
    """Raise on options the kernels on a CUDA device do not run (the
    shape gate aside): offline, ``check_fused_options``; online, all but
    mvdr with the power steer and no BAN."""
    if chunk_size <= 0:
        check_fused_options(beamformer, steer)
        return
    if beamformer not in bf.WEIGHT_FNS:
        raise ValueError(f"Unknown online beamformer: {beamformer}")
    if beamformer != "mvdr" or ban or steer != "power":
        what = beamformer + ("+BAN" if ban else "") + (
            f" with the {steer} steer" if beamformer == "mvdr" else "")
        raise NotImplementedError(
            f"online (chunked EMA) {what} on a CUDA device arrives with "
            f"the batched small-matrix EVD kernel (queue 2 item 14), "
            f"ROADMAP queue 1 item 13; the online kernels run mvdr with the "
            f"power steer and no BAN")


def enhance_batch(wav,
                  mask_s,
                  cfg: StftConfig,
                  beamformer: str = "mvdr",
                  ban: bool = False,
                  nsamps: int | None = None,
                  steer: str = "auto",
                  chunk_size: int = -1,
                  alpha: float = 0.8,
                  device=None) -> torch.Tensor:
    """(B, N, S) int16 or float32 wav + (B, T, F) mask -> (B, S') float32.

    ``device``: where to run; by default a tensor ``wav`` keeps its own
    device and a numpy ``wav`` goes to ``cuda`` (``RuntimeError`` when
    there is none; pass ``device="cpu"`` for the plain path).
    ``steer="auto"`` is the power iteration on CUDA and the full
    eigendecomposition on the CPU (mvdr only; the online path uses each
    beamformer's default weights, as the JAX package does).
    ``chunk_size > 0`` runs the online (chunked EMA) variant with EMA
    factor ``alpha``; on CUDA it runs the online kernels for mvdr with
    the power steer and no BAN, for any chunk size.  On CUDA, what the
    kernels do not cover raises ``NotImplementedError`` naming the
    ROADMAP item that brings it, before anything is copied to the card;
    nothing falls back to a plain path on the card.
    """
    dev = resolve_device(device, like=wav)
    on_cuda = dev.type == "cuda"
    steer_r = ("power" if on_cuda else "eigh") if steer == "auto" else steer
    out_samps = nsamps if nsamps is not None else wav.shape[-1]
    if on_cuda:
        # refuse before anything is copied to the card
        check_cuda_options(beamformer, ban, steer_r, chunk_size)
        n, s = wav.shape[-2], wav.shape[-1]
        if not (fused_online_supported(cfg, n, s, out_samps, chunk_size)
                if chunk_size > 0 else fused_supported(cfg, n, s,
                                                       out_samps)):
            raise NotImplementedError(
                f"STFT geometry {cfg} with wav {tuple(wav.shape)} and "
                f"nsamps {out_samps} is outside the fused kernels' gate; "
                f"the planar path arrives with ROADMAP queue 2 items 9-11")
    wav = _as_tensor(wav, dev)
    mask_s = _as_tensor(mask_s, dev).to(torch.float32)
    if on_cuda and chunk_size > 0:
        return mvdr_enhance_fused_online(wav.contiguous(), mask_s, cfg,
                                         chunk_size=chunk_size, alpha=alpha,
                                         nsamps=nsamps)
    if on_cuda:
        return enhance_fused(wav.contiguous(), mask_s, cfg,
                             beamformer=beamformer, ban=ban, steer=steer_r,
                             nsamps=nsamps)
    if wav.dtype == torch.int16:
        wav = wav.to(torch.float32) / 32768.0
    spec = forward_stft(wav, cfg)                    # (B, N, T, F)
    obs = spec.permute(0, 3, 1, 2)                   # (B, F, N, T)
    mask = mask_s.transpose(1, 2)                    # (B, F, T)
    if chunk_size > 0:
        t = obs.shape[-1]
        # the noise mask is made before padding, so pad frames carry
        # mask_n = 0 and drop out of both covariance denominators
        mask_n = torch.clamp(1.0 - mask, min=0.0)
        pad = (-t) % chunk_size
        obs = torch.nn.functional.pad(obs, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
        mask_n = torch.nn.functional.pad(mask_n, (0, pad))
        enh = bf.online_supervised_run(beamformer, obs, mask, mask_n=mask_n,
                                       chunk_size=chunk_size, alpha=alpha,
                                       ban=ban)[..., :t]
    else:
        kw = {"steer": steer_r} if beamformer == "mvdr" else {}
        enh = bf.supervised_run(beamformer, obs, mask, ban=ban, **kw)
    return inverse_stft(enh.transpose(-1, -2), cfg, nsamps=out_samps)
