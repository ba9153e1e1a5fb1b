"""Mask-weighted PSDs and the MVDR weight solve — the port's plain path.

Counterpart of the MVDR part of ``setk_tpu/enhance/beamformer.py``,
batched over leading axes, with the same layouts (F: bins, N: mics,
T: frames):

    obs     (..., F, N, T)   complex STFT observations
    mask    (..., F, T)      real T-F masks
    covar   (..., F, N, N)   Hermitian PSDs
    weight  (..., F, N)      beamformer weights

This spectrum-domain path is what ``enhance_batch`` runs on the CPU; on
a CUDA device the main path runs the fused kernels instead, and the
parts of this module that have no kernel yet raise there.  The mpdr,
gevd and pmwf weights and the online run come with ROADMAP queue 1
item 2.
"""

import torch

from setk_tpu_torch.utils.common import EPSILON
from setk_tpu_torch.ops.linalg import (solve_pevd, hermitianize,
                                       equilibrated_hermitian_solve,
                                       power_iteration)

__all__ = [
    "covar_stats", "compute_covar", "compute_covar_pair", "beamform",
    "do_ban", "fix_steer_phase", "mvdr_weights", "supervised_run",
    "WEIGHT_FNS"
]

_OTHERS = "arrives with ROADMAP queue 1 item 2"


def covar_stats(obs: torch.Tensor, mask: torch.Tensor):
    """Unnormalized statistics: num = sum_t m y y^H, den = sum_t m."""
    den = mask.sum(-1)
    num = (mask[..., None, :] * obs) @ obs.conj().transpose(-1, -2)
    return num, den


def compute_covar(obs: torch.Tensor, mask: torch.Tensor,
                  denom_floor: float = 1e-6) -> torch.Tensor:
    """R[f] = sum_t m[f,t] y y^H / max(sum_t m[f,t], denom_floor)."""
    num, den = covar_stats(obs, mask)
    return num / torch.clamp(den, min=denom_floor)[..., None, None]


def compute_covar_pair(obs: torch.Tensor, mask_s: torch.Tensor,
                       mask_n: torch.Tensor | None = None,
                       denom_floor: float = 1e-6):
    """(Rs, Rn) with Rn from the literal sum_t max(1 - m, 0) y y^H (never
    total minus masked, which goes indefinite for masks near one)."""
    rs = compute_covar(obs, mask_s, denom_floor)
    rn = compute_covar(obs,
                       torch.clamp(1 - mask_s, min=0) if mask_n is None
                       else mask_n,
                       denom_floor)
    return rs, rn


def beamform(weight: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """w^H y per bin: (..., F, N) x (..., F, N, T) -> (..., F, T)."""
    return (weight.conj()[..., None] * obs).sum(-2)


def do_ban(weight: torch.Tensor, rn: torch.Tensor) -> torch.Tensor:
    """Blind Analytic Normalization post-filter."""
    num = torch.einsum("...a,...ab,...bc,...c->...", weight.conj(), rn, rn,
                       weight)
    den = torch.einsum("...a,...ab,...b->...", weight.conj(), rn, weight)
    filters = torch.sqrt(num.abs()) / torch.clamp(den.real, min=EPSILON)
    return filters[..., None] * weight


def fix_steer_phase(steer: torch.Tensor,
                    ref_channel: int = 0) -> torch.Tensor:
    """Rotate each steer vector so its reference-channel entry is
    real-positive (the enhanced signal is the source as seen there)."""
    ref = steer[..., ref_channel]
    phase = ref / torch.clamp(ref.abs(), min=EPSILON)
    return steer * phase.conj()[..., None]


def _capon(steer: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """w = R^{-1} d / (d^H R^{-1} d), equilibrated solve and guarded
    denominator (degenerate bins get a bounded weight)."""
    num = equilibrated_hermitian_solve(r, steer)
    den = (steer.conj() * num).sum(-1)
    den = torch.where(den.abs() < EPSILON,
                      torch.full_like(den, EPSILON), den)
    return num / den[..., None]


def mvdr_weights(rs: torch.Tensor, rn: torch.Tensor,
                 steer: str = "eigh",
                 power_iters: int = 15) -> torch.Tensor:
    """MVDR with the steer vector from Rs's principal eigenvector.

    ``steer="power"`` uses fixed-count power iteration; on a CUDA tensor
    it is the fused per-bin kernel (ops/cuda/mvdr.py), as the JAX
    package dispatches to its Pallas kernel on the TPU.
    """
    if steer == "power":
        if rs.device.type == "cuda":
            from setk_tpu_torch.ops.cuda.mvdr import mvdr_power
            return mvdr_power(rs.contiguous(), rn.contiguous(),
                              power_iters=power_iters)
        vec = power_iteration(hermitianize(rs), num_iters=power_iters)
    elif steer == "eigh":
        if rs.device.type == "cuda":
            raise NotImplementedError(
                "the eigh steer on a CUDA device arrives with the batched "
                "small-matrix EVD kernel, ROADMAP queue 2 item 14")
        vec = solve_pevd(rs)
    else:
        raise ValueError(f"Unknown steer method: {steer}")
    return _capon(fix_steer_phase(vec), rn)


WEIGHT_FNS = {"mvdr": mvdr_weights}


def supervised_run(beamformer: str,
                   obs: torch.Tensor,
                   mask_s: torch.Tensor,
                   mask_n: torch.Tensor | None = None,
                   ban: bool = False,
                   **kwargs) -> torch.Tensor:
    """One-shot mask-based beamforming: masks + obs -> enhanced STFT
    (..., F, T)."""
    if beamformer not in WEIGHT_FNS:
        raise NotImplementedError(f"beamformer {beamformer!r} {_OTHERS}")
    if obs.device.type == "cuda":
        raise NotImplementedError(
            "the spectrum-domain supervised run on a CUDA device arrives "
            "with the planar STFT/iSTFT and pair-covariance kernels, "
            "ROADMAP queue 2 items 9-11; enhance_batch runs the fused kernels")
    rs, rn = compute_covar_pair(obs, mask_s, mask_n)
    weight = WEIGHT_FNS[beamformer](rs, rn, **kwargs)
    if ban:
        weight = do_ban(weight, rn)
    return beamform(weight, obs)
