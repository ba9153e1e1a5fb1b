"""The whole CGMM / CACGMM EM loop in one launch (kernel 15).

Counterpart of ``setk_tpu/ops/pallas/cacgmm_em.py``: ``_em_blocks``
(:301) via ``cacgmm_em_pallas`` (:483) and ``cgmm_em_pallas`` (:507);
kernel source ``setk_tpu_torch/csrc/cacgmm_em.cu`` (lanes over a bin's
frames, its Jacobi ``jacobi_regularized_inverse_group`` of
``csrc/jacobi.cuh`` on lane groups, beside kernel 14's thread Jacobi):

  cacgmm_em_fused / cgmm_em_fused: obs (..., F, M, T) complex64 (CACGMM:
      L2-normalised over mics by the caller; CGMM: the raw spectra),
      gamma0 and kernel0 / phi0 (K, ..., F, T) or, with
      ``init="higuchi"`` (K = 2), none -> gamma (K, ..., F, T) and the Q
      history (num_iters,), plus with ``return_state`` the state dict
      {covar (K, ..., F, M, M), alpha (K, ..., F)[, phi (K, ..., F, T)]}.

The expressions are ``_em_kernel``'s; the TPU's VMEM gates do not apply.
The kernel reads obs, gamma0 and kernel0 in the caller's layout and
writes gamma and the kernel plane in it, so the wrapper moves no data.
The port's gate (``em_fused_supported``): M <= 8, K <= 4, num_iters >= 1.
``em_plain`` is the plain PyTorch version of the same function,
with the Jacobi of ``ops/cuda/eigh_small.py``.
"""

import math

import torch

from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.ops.cuda.eigh_small import SWEEPS, _jacobi_planes
from setk_tpu_torch.utils.common import EPSILON

__all__ = ["MAX_MICS", "MAX_CLASSES", "em_fused_supported", "em",
           "em_plain", "cacgmm_em_fused", "cgmm_em_fused"]

MAX_MICS = 8
MAX_CLASSES = 4


def em_fused_supported(shape, num_classes: int, num_iters: int) -> bool:
    """The port's fused-EM gate: M <= 8, K <= 4, num_iters >= 1, any T."""
    return shape[-2] <= MAX_MICS and num_classes <= MAX_CLASSES and \
        num_iters >= 1


def _em_plain_bins(z, gamma, kern, fm, k_classes, num_iters, cg,
                   update_alpha, sweeps):
    """The EM over bins: z (nb, M, T) complex, gamma/kern (K, nb, T) or
    None for the Higuchi init, fm (nb, T).  Returns (gamma, kern, q per
    bin (iters, nb), covar (K, nb, M, M) complex, alpha (K, nb))."""
    nb, m, t = z.shape
    zr, zi = z.real, z.imag
    fm_den = torch.clamp(fm.sum(-1), min=1.0)

    def prod(i, j):
        # conj(z_i) z_j as planes (nb, T)
        return (zr[:, i] * zr[:, j] + zi[:, i] * zi[:, j],
                zr[:, i] * zi[:, j] - zi[:, i] * zr[:, j])

    def e_step(cre, cim, alpha, eye=None):
        """cre/cim (K, nb, M, M), alpha (K, nb) -> gamma, quad, log_marg."""
        ks = [k for k in range(k_classes) if k != eye]
        b_re = torch.zeros_like(cre)
        b_im = torch.zeros_like(cim)
        logdet = torch.zeros((k_classes, nb), dtype=z.real.dtype,
                             device=z.device)
        ir, ii, ld = _jacobi_planes(cre[ks].reshape(-1, m, m),
                                    cim[ks].reshape(-1, m, m), sweeps)
        b_re[ks] = ir.reshape(len(ks), nb, m, m)
        b_im[ks] = ii.reshape(len(ks), nb, m, m)
        logdet[ks] = ld.reshape(len(ks), nb)
        qds = torch.zeros((k_classes, nb, t), dtype=zr.dtype, device=z.device)
        for i in range(m):
            p_re, _ = prod(i, i)
            d = b_re[:, :, i, i, None] * p_re
            if eye is not None:
                d[eye] = p_re
            qds = qds + d
        for i in range(m):
            for j in range(i + 1, m):
                p_re, p_im = prod(i, j)
                d = 2.0 * (b_re[:, :, i, j, None] * p_re -
                           b_im[:, :, i, j, None] * p_im)
                if eye is not None:
                    d[eye] = 0.0
                qds = qds + d
        quad = torch.clamp(qds, min=EPSILON)
        if cg:
            quad = quad * (1.0 / m)
        log_pdf = -m * torch.log(quad) - logdet[..., None]
        mx = log_pdf[0]
        for k in range(1, k_classes):
            mx = torch.maximum(mx, log_pdf[k])
        num = torch.exp(log_pdf - mx) * alpha[..., None]
        den = num[0]
        for k in range(1, k_classes):
            den = den + num[k]
        den = torch.clamp(den, min=EPSILON)
        gamma = torch.clamp(num / den, max=1.0)
        return gamma, quad, mx + torch.log(den)

    def covars(w):
        """(K, nb, T) weights -> sum_t w z_i conj(z_j) as (K, nb, M, M)."""
        cre = torch.empty((w.shape[0], nb, m, m), dtype=zr.dtype,
                          device=z.device)
        cim = torch.empty_like(cre)
        for i in range(m):
            for j in range(i, m):
                p_re, p_im = prod(i, j)
                cre[:, :, i, j] = (w * p_re).sum(-1)
                cim[:, :, i, j] = -(w * p_im).sum(-1)
                if j != i:
                    cre[:, :, j, i] = cre[:, :, i, j]
                    cim[:, :, j, i] = -cim[:, :, i, j]
        return cre, cim

    alpha = torch.full((k_classes, nb), 1.0 / k_classes, dtype=zr.dtype,
                       device=z.device)
    if gamma is None:
        # Higuchi: class 0 the fm-weighted sample covariance, class 1 = I
        cre, cim = covars(fm[None])
        cre = torch.cat([cre / fm_den[:, None, None],
                         torch.eye(m, dtype=zr.dtype, device=z.device).expand(
                             1, nb, m, m)])
        cim = torch.cat([cim / fm_den[:, None, None], torch.zeros_like(cim)])
        gamma, kern, _ = e_step(cre, cim, alpha, eye=1)
    q = []
    for _ in range(num_iters):
        g = gamma * fm
        den = torch.clamp(g.sum(-1), min=EPSILON)
        w = (g / torch.clamp(kern, min=EPSILON)) * (m / den)[..., None]
        if update_alpha:
            alpha = g.sum(-1) / fm_den
        cre, cim = covars(w)
        gamma, kern, log_marg = e_step(cre, cim, alpha)
        q.append((log_marg * fm).sum(-1))
    return gamma, kern, torch.stack(q), torch.complex(cre, cim), alpha


def _check(obs, gamma0, kernel0, num_iters, init, num_classes):
    """(lead, F, M, T, K) of a valid call."""
    if num_iters < 1:
        raise ValueError(f"num_iters must be >= 1, got {num_iters}")
    *lead, f, m, t = obs.shape
    if init is not None:
        if init != "higuchi" or num_classes != 2:
            raise ValueError("the in-kernel init is the K=2 Higuchi "
                             "construction")
        k_classes = 2
    else:
        k_classes = gamma0.shape[0]
        want = (k_classes, *lead, f, t)
        if tuple(gamma0.shape) != want or tuple(kernel0.shape) != want:
            raise ValueError(f"gamma0/kernel0 must be {want}, got "
                             f"{tuple(gamma0.shape)}, {tuple(kernel0.shape)}")
    return lead, f, m, t, k_classes


def em_plain(obs, gamma0, kernel0, num_iters, model, update_alpha,
             frame_mask=None, return_state=False, sweeps=SWEEPS, init=None,
             num_classes=2):
    """Plain version of kernel 15 (``em``'s arguments and results)."""
    lead, f, m, t, k = _check(obs, gamma0, kernel0, num_iters, init,
                              num_classes)
    nb = math.prod(lead) * f
    fm_full = _frame_mask(frame_mask, lead, f, t, obs.device)
    z = obs.reshape(nb, m, t)
    g0 = k0 = None
    if init is None:
        g0 = gamma0.to(torch.float32).reshape(k, nb, t)
        k0 = kernel0.to(torch.float32).reshape(k, nb, t)
    gamma, kern, q_bins, covar, alpha = _em_plain_bins(
        z, g0, k0, fm_full.reshape(nb, t), k, num_iters, model == "cg",
        update_alpha, sweeps)
    return _results(gamma, kern, q_bins, covar, alpha, fm_full, lead, f, m,
                    t, k, model, return_state, obs.dtype)


def _frame_mask(frame_mask, lead, f, t, device):
    if frame_mask is None:
        return torch.ones((*lead, f, t), dtype=torch.float32, device=device)
    return torch.as_tensor(frame_mask, dtype=torch.float32,
                           device=device).expand(*lead, f, t)


def _results(gamma, kern, q_bins, covar, alpha, fm_full, lead, f, m, t, k,
             model, return_state, dtype):
    """Per-bin results -> the public shapes; Q = sum over bins of the
    per-bin sums over max(sum fm, 1)."""
    q_hist = q_bins.sum(-1) / torch.clamp(fm_full.sum(), min=1.0)
    gamma = gamma.reshape(k, *lead, f, t)
    if not return_state:
        return gamma, q_hist
    state = {"covar": covar.reshape(k, *lead, f, m, m).to(dtype),
             "alpha": alpha.reshape(k, *lead, f)}
    if model == "cg":
        state["phi"] = kern.reshape(k, *lead, f, t)
    return gamma, q_hist, state


def em(obs, gamma0, kernel0, num_iters, model, update_alpha,
       frame_mask=None, return_state=False, sweeps=SWEEPS, init=None,
       num_classes=2):
    """Kernel 15: the EM of ``model`` "cacg" or "cg" over obs
    (..., F, M, T); see the module docstring for the shapes.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``em.launches`` counts those launches) on obs, gamma0 and kernel0 as
    they lie (a copy only where they are not contiguous complex64 /
    float32), or raises before any allocation.
    """
    if obs.device.type == "cpu":
        return em_plain(obs, gamma0, kernel0, num_iters, model, update_alpha,
                        frame_mask, return_state, sweeps, init, num_classes)
    lead, f, m, t, k = _check(obs, gamma0, kernel0, num_iters, init,
                              num_classes)
    if obs.dtype != torch.complex64 or not em_fused_supported(
            obs.shape, k, num_iters):
        raise ValueError(f"em: needs complex64 obs with M <= {MAX_MICS} and "
                         f"K <= {MAX_CLASSES}, got {obs.dtype}, M = {m}, "
                         f"K = {k}")
    dev = obs.device
    nb = math.prod(lead) * f
    z = obs.reshape(nb, m, t).contiguous()
    g0 = k0 = None
    if init is None:
        g0, k0 = (x.to(dev, torch.float32).reshape(k, nb, t).contiguous()
                  for x in (gamma0, kernel0))
    fm_full = _frame_mask(frame_mask, lead, f, t, dev)
    if frame_mask is None:
        fm_ptr, strides = None, (0, 0, 0)
    else:
        fm3 = fm_full.reshape(-1, f, t)
        fm_ptr, strides = fm3.data_ptr(), fm3.stride()
    gamma = torch.empty((k, nb, t), dtype=torch.float32, device=dev)
    kern = torch.empty_like(gamma)
    q_bins = torch.empty((num_iters, nb), dtype=torch.float32, device=dev)
    covar = torch.empty((k, nb, m, m), dtype=torch.complex64, device=dev)
    alpha = torch.empty((k, nb), dtype=torch.float32, device=dev)
    _build.launch("cacgmm_em", "cacgmm_em_launch", dev, z.data_ptr(),
                  fm_ptr, *strides, None if g0 is None else g0.data_ptr(),
                  None if k0 is None else k0.data_ptr(), gamma.data_ptr(),
                  kern.data_ptr(), q_bins.data_ptr(), covar.data_ptr(),
                  alpha.data_ptr(), nb, f, t, m, k, num_iters,
                  int(model == "cg"), int(init is not None),
                  int(update_alpha), sweeps)
    em.launches += 1
    return _results(gamma, kern, q_bins, covar, alpha, fm_full, lead, f, m,
                    t, k, model, return_state, obs.dtype)


em.launches = 0


def cacgmm_em_fused(obs, gamma0, kernel0, num_iters, update_alpha=True,
                    frame_mask=None, return_state=False, sweeps=SWEEPS,
                    init=None):
    """Fused CACGMM EM on L2-normalised obs (cacgmm_em_pallas's API)."""
    return em(obs, gamma0, kernel0, num_iters, "cacg", update_alpha,
              frame_mask, return_state, sweeps, init, 2)


def cgmm_em_fused(obs, gamma0, phi0, num_iters, update_alpha=False,
                  frame_mask=None, return_state=False, sweeps=SWEEPS,
                  init=None):
    """Fused CGMM EM on raw obs (cgmm_em_pallas's API); the state gains
    the final phi plane."""
    return em(obs, gamma0, phi0, num_iters, "cg", update_alpha, frame_mask,
              return_state, sweeps, init, 2)
