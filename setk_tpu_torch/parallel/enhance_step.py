"""Batched mask-based enhancement: the main-path library entry.

Counterpart of ``setk_tpu/parallel/enhance_step.enhance_batch``
(enhance_step.py:30-121).  On a CUDA device the step follows the JAX
package's dispatch on the TPU (enhance_step.py:93-121):
  1. the fused kernels (enhance/pipeline.enhance_fused) for every
     beamformer in ``FUSED_BEAMFORMERS`` inside the fused gate, and for
     ``chunk_size > 0`` enhance/pipeline.mvdr_enhance_fused_online (mvdr,
     power steer, no BAN) inside the same gate;
  2. else, for mvdr with the power steer and no BAN inside the planar
     gate, the planar kernels (enhance/pipeline.mvdr_enhance_planar);
  3. else the spectrum-domain run: the STFT, ``supervised_run`` (the
     pair-covariance kernel and the per-bin solves) and the iSTFT, the
     transforms in ``torch.fft`` as the JAX package leaves them to XLA
     there; it serves mvdr (power steer, with or without BAN) and
     pmwf-0/1.
What no kernel set covers raises ``NotImplementedError`` naming its
ROADMAP item before anything is copied to the card (``check_cuda_options``).
On the CPU it runs the spectrum-domain plain path (STFT -> masked PSDs
-> weights -> beamform -> iSTFT), one-shot or online (chunked EMA), as
the JAX package does off the TPU.  The sharded multi-device step comes
with ROADMAP queue 1 item 12.
"""

import numpy as np
import torch

from setk_tpu_torch.dsp.stft import StftConfig, forward_stft, inverse_stft
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance.pipeline import (FUSED_BEAMFORMERS,
                                             check_fused_options,
                                             enhance_fused,
                                             fused_online_supported,
                                             fused_supported,
                                             mvdr_enhance_fused_online,
                                             mvdr_enhance_planar,
                                             planar_supported)
from setk_tpu_torch.ops.cuda.covariance_pair import MAX_MICS
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device

__all__ = ["enhance_batch", "check_cuda_options"]


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


# the beamformers whose weights need an EVD outside the fused kernels
_EVD_BEAMFORMERS = ("gevd", "mpdr", "mpdr-whiten")


def check_cuda_options(beamformer: str, ban: bool, steer: str,
                       chunk_size: int, cfg: StftConfig | None = None,
                       num_mics: int | None = None,
                       nsamps: int | None = None,
                       out_samps: int | None = None) -> str | None:
    """Raise on what the kernels on a CUDA device do not run; with the
    geometry (``cfg``, N, S and the output length) return the branch
    that runs it: "fused", "online", "planar" or "spectrum".

    Without the geometry only the options are checked: offline,
    ``check_fused_options`` (an unknown name, the eigh steer); online,
    all but mvdr with the power steer and no BAN.  With it: N > 8, online
    outside the fused online gate, and gevd, mpdr and mpdr-whiten outside
    the fused gate (their weights need the EVD) raise too.
    """
    if chunk_size <= 0:
        check_fused_options(beamformer, steer)
    else:
        if beamformer not in bf.WEIGHT_FNS:
            raise ValueError(f"Unknown online beamformer: {beamformer}")
        if beamformer != "mvdr" or ban or steer != "power":
            what = beamformer + ("+BAN" if ban else "") + (
                f" with the {steer} steer" if beamformer == "mvdr" else "")
            raise NotImplementedError(
                f"online (chunked EMA) {what} on a CUDA device arrives with "
                f"the batched small-matrix EVD kernel, ROADMAP queue 1 item "
                f"13; the online kernels run mvdr with "
                f"the power steer and no BAN")
    if cfg is None:
        return None
    where = f"STFT geometry {cfg} with N={num_mics}, S={nsamps}"
    if num_mics > MAX_MICS:
        raise NotImplementedError(
            f"{num_mics} mics on a CUDA device arrive with ROADMAP queue 1 "
            f"item 15; the kernels take N <= {MAX_MICS}")
    cfg.num_frames(nsamps)                   # too short raises ValueError
    if chunk_size > 0:
        if fused_online_supported(cfg, num_mics, nsamps, out_samps,
                                  chunk_size):
            return "online"
        raise NotImplementedError(
            f"online mvdr at {where} and nsamps {out_samps} is outside the "
            f"online kernels' gate; its spectrum-domain run (eigh weights) "
            f"on a CUDA device arrives with ROADMAP queue 1 item 13")
    if beamformer in FUSED_BEAMFORMERS and fused_supported(
            cfg, num_mics, nsamps, out_samps):
        return "fused"
    if beamformer in _EVD_BEAMFORMERS:
        raise NotImplementedError(
            f"{beamformer} at {where} and nsamps {out_samps} is outside the "
            f"fused kernels' gate; its weights there need the batched "
            f"small-matrix EVD kernel, ROADMAP queue 1 item 13")
    if beamformer == "mvdr" and not ban and planar_supported(cfg, num_mics,
                                                             nsamps):
        return "planar"
    return "spectrum"


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
    the power steer and no BAN, for any chunk size, inside the fused
    gate.  One-shot on CUDA: the fused kernels, else the planar kernels,
    else the spectrum-domain run (module docstring).  On CUDA, what the
    kernels do not cover raises ``NotImplementedError`` naming the
    ROADMAP item that brings it, before anything is copied to the card;
    nothing falls back to a plain path on the card.
    """
    dev = resolve_device(device, like=wav)
    on_cuda = dev.type == "cuda"
    steer_r = ("power" if on_cuda else "eigh") if steer == "auto" else steer
    out_samps = nsamps if nsamps is not None else wav.shape[-1]
    branch = None
    if on_cuda:
        # refuse before anything is copied to the card
        branch = check_cuda_options(beamformer, ban, steer_r, chunk_size,
                                    cfg, wav.shape[-2], wav.shape[-1],
                                    out_samps)
    wav = _as_tensor(wav, dev)
    mask_s = _as_tensor(mask_s, dev).to(torch.float32)
    if branch == "online":
        return mvdr_enhance_fused_online(wav.contiguous(), mask_s, cfg,
                                         chunk_size=chunk_size, alpha=alpha,
                                         nsamps=nsamps)
    if branch == "fused":
        return enhance_fused(wav.contiguous(), mask_s, cfg,
                             beamformer=beamformer, ban=ban, steer=steer_r,
                             nsamps=nsamps)
    if branch == "planar":
        return mvdr_enhance_planar(wav.contiguous(), mask_s, cfg,
                                   nsamps=nsamps)
    # the spectrum-domain run: the plain path on the CPU; on the card
    # the covariance pair and the mvdr solve run their kernels
    full_f32_matmuls(dev)
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
