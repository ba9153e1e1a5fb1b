"""Masked covariances of one observation against K weight classes
(kernel 13).

Counterpart of ``setk_tpu/ops/pallas/covariance.py``'s
``masked_covar_pallas`` (:46); kernel source
``setk_tpu_torch/csrc/covariance.cu``:

  masked_covar: obs (L, F, N, T) complex64 and weights (K, L, F, T) f32 ->
      num (K, L, F, N, N) complex64, num[k] = sum_t w[k] y y^H,
      Hermitian-filled; y is read once for all K classes.

The mask-sum denominator is the caller's (``covar_stats``), as on the TPU.
N <= 8, any K (four classes a launch), F and T.  The plain PyTorch version
of the same function is ``masked_covar_plain``.
"""

import torch

from setk_tpu_torch.ops.cuda import _build

__all__ = ["MAX_MICS", "masked_covar", "masked_covar_plain"]

MAX_MICS = 8
_CLASSES_PER_LAUNCH = 4


def masked_covar_plain(obs: torch.Tensor, weight: torch.Tensor):
    """Plain version of kernel 13."""
    mobs = weight[..., None, :].to(obs.dtype) * obs
    return mobs @ obs.conj().transpose(-1, -2)


def masked_covar(obs: torch.Tensor, weight: torch.Tensor):
    """Kernel 13: (K, L, F, N, N) complex64 numerators sum_t w y y^H.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``masked_covar.launches`` counts those launches, one for every four
    classes).  Both tensors must be contiguous on one CUDA device.
    """
    if obs.device.type == "cpu":
        return masked_covar_plain(obs, weight)
    if obs.dtype != torch.complex64 or obs.ndim != 4 or \
            not obs.is_contiguous() or 0 in obs.shape:
        raise ValueError(f"masked_covar: obs must be a contiguous non-empty "
                         f"complex64 (L, F, N, T) CUDA tensor, got "
                         f"{obs.dtype} {tuple(obs.shape)}")
    lead, f, n, t = obs.shape
    if n > MAX_MICS:
        raise ValueError(f"masked_covar: N = {n} > {MAX_MICS}")
    if weight.device != obs.device or weight.dtype != torch.float32 or \
            weight.ndim != 4 or not weight.is_contiguous() or \
            tuple(weight.shape[1:]) != (lead, f, t) or weight.shape[0] < 1:
        raise ValueError(f"masked_covar: weights must be a contiguous float32 "
                         f"(K, {lead}, {f}, {t}) tensor on {obs.device}, got "
                         f"{weight.dtype} {tuple(weight.shape)} on "
                         f"{weight.device}")
    k = weight.shape[0]
    num = torch.empty((k, lead, f, n, n), dtype=torch.complex64,
                      device=obs.device)
    for k0 in range(0, k, _CLASSES_PER_LAUNCH):
        kk = min(_CLASSES_PER_LAUNCH, k - k0)
        _build.launch("covariance", "masked_covar_launch", obs.device,
                      obs.data_ptr(), weight[k0].data_ptr(),
                      num[k0].data_ptr(), lead * f, n, t, kk)
        masked_covar.launches += 1
    return num


masked_covar.launches = 0
