"""Batched mask-based enhancement: the main-path library entry.

Counterpart of ``setk_tpu/parallel/enhance_step.enhance_batch``
(enhance_step.py:30-121), offline form.  On a CUDA device the whole
step runs through the fused kernels (enhance/pipeline.enhance_fused);
on the CPU it runs the spectrum-domain plain path (STFT -> masked PSDs
-> MVDR -> beamform -> iSTFT), as the JAX package does off the TPU.
The sharded multi-device step comes with ROADMAP queue 1 item 12.
"""

import numpy as np
import torch

from setk_tpu_torch.dsp.stft import StftConfig, forward_stft, inverse_stft
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance.pipeline import enhance_fused, fused_supported
from setk_tpu_torch.utils.device import resolve_device

__all__ = ["enhance_batch"]


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


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
    eigendecomposition on the CPU.  On CUDA, what the kernels do not
    cover raises ``NotImplementedError`` naming the ROADMAP item that
    brings it; nothing falls back to a plain path on the card.
    """
    dev = resolve_device(device, like=wav)
    wav = _as_tensor(wav, dev)
    mask_s = _as_tensor(mask_s, dev).to(torch.float32)
    on_cuda = dev.type == "cuda"
    steer_r = ("power" if on_cuda else "eigh") if steer == "auto" else steer
    out_samps = nsamps if nsamps is not None else wav.shape[-1]
    if chunk_size > 0:
        raise NotImplementedError(
            "online (chunked EMA) enhancement arrives with ROADMAP queue 1 "
            "item 2 (plain path) and queue 2 items 7-8 (kernels)")
    if on_cuda:
        if not fused_supported(cfg, wav.shape[-2], wav.shape[-1], out_samps):
            raise NotImplementedError(
                f"STFT geometry {cfg} with wav {tuple(wav.shape)} and "
                f"nsamps {out_samps} is outside the fused kernels' gate; "
                f"the planar path arrives with ROADMAP queue 2 items 9-11")
        return enhance_fused(wav.contiguous(), mask_s, cfg,
                             beamformer=beamformer, ban=ban, steer=steer_r,
                             nsamps=nsamps)
    if wav.dtype == torch.int16:
        wav = wav.to(torch.float32) / 32768.0
    spec = forward_stft(wav, cfg)                    # (B, N, T, F)
    obs = spec.permute(0, 3, 1, 2)                   # (B, F, N, T)
    mask = mask_s.transpose(1, 2)                    # (B, F, T)
    kw = {"steer": steer_r} if beamformer == "mvdr" else {}
    enh = bf.supervised_run(beamformer, obs, mask, ban=ban, **kw)
    return inverse_stft(enh.transpose(-1, -2), cfg, nsamps=out_samps)
