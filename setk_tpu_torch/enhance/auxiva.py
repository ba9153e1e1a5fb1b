"""AuxIVA blind source separation (Ono 2011 auxiliary-function IP updates).

The port's counterpart of ``setk_tpu/enhance/auxiva.py``: identity
demixing init, contrast r = sqrt(sum_f |y|^2), per-source weighted
covariances V, the IP update w = (W^H V)^{-1} e_s normalized by
w^H V w.  In an epoch the weights 1 / r are fixed, so all N sources'
covariances are one call of kernel 13 (``ops/cuda/covariance.
masked_covar``, one launch for every four sources on a CUDA tensor, its
plain version on the CPU).  The per-bin N x N complex systems stay with
``torch.linalg.solve``, as the JAX package leaves them to
``jnp.linalg.solve``.  N > 8 on the card raises (ROADMAP queue 1 item
15); the CPU runs any N.
"""

import torch

from setk_tpu_torch.ops.cuda.covariance import MAX_MICS, masked_covar
from setk_tpu_torch.utils.common import EPSILON
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device

__all__ = ["auxiva"]


def _as_tensor(x, dev):
    return torch.as_tensor(x).to(device=dev, dtype=torch.complex64)


def auxiva(spectra, epochs: int = 20, device=None) -> torch.Tensor:
    """Separate (N, T, F) complex STFTs into N sources, same shape, on
    ``device`` (else the tensor's own; a numpy array goes to ``cuda``)."""
    dev = resolve_device(device, like=spectra)
    n, t, f = spectra.shape
    if dev.type == "cuda" and n > MAX_MICS:
        raise NotImplementedError(
            f"AuxIVA of N = {n} > {MAX_MICS} sources on a CUDA device "
            f"arrives with ROADMAP queue 1 item 15")
    full_f32_matmuls(dev)
    spectra = _as_tensor(spectra, dev)
    x = spectra.permute(2, 1, 0)  # F x T x N
    # kernel 13's observation (1, F, N, T), read once for all N classes
    obs = spectra.permute(2, 0, 1)[None].contiguous()
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    w = eye.expand(f, n, n).clone()
    for _ in range(epochs):
        y = torch.matmul(x, w.conj())
        r = torch.sqrt(torch.sum(y.abs()**2, dim=0))  # T x N
        gr = 1.0 / (r.T + EPSILON)  # N x T
        weight = gr[:, None, None, :].expand(n, 1, f, t).contiguous()
        v_all = masked_covar(obs, weight)[:, 0] / t  # N x F x N x N
        for src in range(n):
            v = v_all[src]
            # IP update: solve (W^H V) w = e_src per bin
            wh_v = torch.matmul(w.conj().transpose(-1, -2), v)
            rhs = eye[:, src].expand(f, n)
            wn = torch.linalg.solve(wh_v, rhs[..., None])[..., 0]
            denom = torch.einsum("fx,fxy,fy->f", wn.conj(), v, wn)
            w[:, :, src] = wn / denom[:, None]
    y = torch.matmul(x, w.conj())
    return y.permute(2, 1, 0)
