"""CGMM / CACGMM spatial clustering by EM, batched over bins and utterances.

Counterpart of ``setk_tpu/enhance/cluster.py``: the Higuchi CGMM and Ito
CACGMM EM with the regularized-covariance updates (eigenvalues scaled by
their maximum and floored), the K=2 covariance init, state resume, the
Q history, and the host-side frequency permutation alignment
(``permu_aligner``, numpy/scipy, copied rather than imported).

Dispatch is the JAX package's TPU dispatch with "on a TPU" read as "on a
CUDA tensor" (``use_fused=None``): a fresh run (the Higuchi init, a given
``gamma_init`` or a random init) hands the whole loop to the fused EM
kernel (ops/cuda/cacgmm_em.py, kernel 15), the Higuchi init inside it;
state resume, ``use_fused=False`` and K > 4 take the scan, which runs
``_weighted_covar`` (kernel 13) and ``regularized_inverse`` (kernel 14)
once an iteration on the card.  On the CPU everything is the plain path.
Random inits draw ``torch.rand`` from a ``torch.Generator`` on the
tensor's device (seed 0 unless the caller passes one): other numbers than
``jax.random`` gives from the same seed.
"""

import numpy as np
import torch

from setk_tpu_torch.enhance.beamformer import covar_stats
from setk_tpu_torch.ops.cuda.cacgmm_em import (MAX_MICS, cacgmm_em_fused,
                                               cgmm_em_fused,
                                               em_fused_supported)
from setk_tpu_torch.ops.linalg import regularized_inverse
from setk_tpu_torch.utils.common import EPSILON
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device

__all__ = ["cgmm_em", "cacgmm_em", "norm_observation", "permu_aligner",
           "check_mics"]


def norm_observation(mat: torch.Tensor, axis: int = -1,
                     eps: float = EPSILON) -> torch.Tensor:
    """L2-normalize observation vectors along ``axis``."""
    den = torch.clamp(torch.linalg.vector_norm(mat, dim=axis, keepdim=True),
                      min=eps)
    return mat / den


def _posterior(log_pdf, alpha, frame_mask=None):
    """Softmax posterior over the class axis (first) with priors, and the
    Q statistic (mean log marginal over valid frames), through a
    max-shifted logsumexp; gamma is clamped to <= 1 (f32 rounding can give
    1 + ulp, which makes downstream (1 - mask) weights negative)."""
    mx = log_pdf.max(0, keepdim=True).values
    num = torch.exp(log_pdf - mx) * alpha[..., None]
    den = torch.clamp(num.sum(0, keepdim=True), min=EPSILON)
    log_marg = mx[0] + torch.log(den[0])
    post = torch.clamp(num / den, max=1.0)
    if frame_mask is None:
        q = log_marg.mean()
    else:
        fm = frame_mask.expand(log_marg.shape)
        q = (log_marg * fm).sum() / torch.clamp(fm.sum(), min=1.0)
    return post, q


def _weighted_covar(obs, weight):
    """R = sum_t w[k,...,t] z[...,t] z[...,t]^H: obs (..., F, M, T) +
    weight (K, ..., F, T) -> (K, ..., F, M, M), through covar_stats (one
    read of obs for all K classes on the card)."""
    num, _ = covar_stats(obs[None], weight)
    return num


def _cgmm_quad(obs, r_inv):
    """z^H R^{-1} z: (K, ..., F, T), floored at EPSILON."""
    quad = torch.einsum("...xt,k...xy,...yt->k...t", obs.conj(), r_inv, obs)
    return torch.clamp(quad.abs(), min=EPSILON)


def _quad_pairs(obs, r_inv):
    """z^H R^{-1} z as the M^2 pair loop of the JAX init path."""
    m = obs.shape[-2]
    quad = None
    for i in range(m):
        zi = obs[..., i, :]
        d = r_inv[..., i, i].real[..., None] * (zi.real ** 2 + zi.imag ** 2)
        quad = d if quad is None else quad + d
        for j in range(i + 1, m):
            p = zi.conj() * obs[..., j, :]
            rij = r_inv[..., i, j][..., None]
            quad = quad + 2.0 * (rij.real * p.real - rij.imag * p.imag)
    return torch.clamp(quad, min=EPSILON)


def _cgmm_predict(obs, phi, covar, alpha, frame_mask=None, logdet=None):
    m = obs.shape[-2]
    if logdet is None:
        _, logdet = regularized_inverse(covar, return_logdet=True)
    log_pdf = -m * torch.log(phi) - logdet[..., None]
    return _posterior(log_pdf, alpha, frame_mask)


def _as_tensor(x, dev, dtype):
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=dev, dtype=dtype)


def check_mics(dev: torch.device, num_mics: int) -> None:
    """Refuse M > 8 on the card (kernels 13-15 are templated to M <= 8)."""
    if dev.type == "cuda" and num_mics > MAX_MICS:
        raise NotImplementedError(
            f"clustering M = {num_mics} > {MAX_MICS} mics on a CUDA device "
            f"arrives with ROADMAP queue 1 item 15")


def _prepare(obs, num_iters, device, frame_mask, gamma_init=None,
             state=None):
    """Check, then move the inputs to the run's device: num_iters < 1 is a
    ValueError anywhere; M > 8 on the card raises before any copy.
    Returns (whether the run is on the card, obs, fm, gamma_init, state)."""
    if num_iters < 1:
        raise ValueError(f"num_iters must be >= 1, got {num_iters}")
    dev = resolve_device(device, like=obs)
    check_mics(dev, obs.shape[-2])
    full_f32_matmuls(dev)

    def put(x, dtype):
        return None if x is None else _as_tensor(x, dev, dtype)

    obs = put(obs, torch.complex64)
    fm = put(frame_mask, torch.float32)
    gamma = put(gamma_init, torch.float32)
    if state is not None:
        state = {k: put(v, torch.complex64 if k == "covar" else
                        torch.float32) for k, v in state.items()}
    return dev.type == "cuda", obs, fm, gamma, state


def _uniform_init(num_classes, shape, obs, generator):
    """Uniform gamma normalized over the classes, drawn from ``generator``
    (by default one seeded 0 on obs' device), on obs' device."""
    gen = generator
    if gen is None:
        gen = torch.Generator(device=obs.device)
        gen.manual_seed(0)
    gamma = torch.rand((num_classes, *shape), generator=gen,
                       device=gen.device)
    return (gamma / gamma.sum(0, keepdim=True)).to(obs.device)


def _sample_covar(obs, fm):
    """The fm-weighted sample covariance (Higuchi's speech init)."""
    *batch, f, _, t = obs.shape
    if fm is None:
        w0 = torch.ones((1, *batch, f, t), device=obs.device)
        return _weighted_covar(obs, w0)[0] / t
    w0 = fm.expand(*batch, f, t)[None]
    return (_weighted_covar(obs, w0)[0] /
            torch.clamp(fm.sum(-1), min=1.0)[..., None, None])


def cgmm_em(obs,
            num_classes: int,
            num_iters: int = 20,
            gamma_init=None,
            update_alpha: bool = False,
            generator: torch.Generator | None = None,
            state: dict | None = None,
            return_state: bool = False,
            frame_mask=None,
            use_fused: bool | None = None,
            sweeps: int | None = None,
            device=None):
    """CGMM EM over obs (..., F, M, T).

    Returns (gamma (K, ..., F, T), q_history (num_iters,)), plus the state
    dict {phi, covar, alpha} with ``return_state``, resumable through
    ``state``.  K=2 without ``gamma_init`` takes the Higuchi init (Rs the
    sample covariance, Rn = I), else the given or a random gamma.
    ``sweeps`` sets the fused kernel's Jacobi sweeps (default 6).
    ``device``: by default a tensor keeps its device and a numpy array
    goes to ``cuda``.
    """
    on_card, obs, fm, gamma_init, state = _prepare(
        obs, num_iters, device, frame_mask, gamma_init, state)
    dev = obs.device
    *batch, f, m, t = obs.shape
    kw = {} if sweeps is None else {"sweeps": sweeps}
    if state is not None:
        phi, covar, alpha = state["phi"], state["covar"], state["alpha"]
        gamma, _ = _cgmm_predict(obs, phi, covar, alpha)
        return _cgmm_scan(obs, phi, covar, alpha, gamma, m, num_iters,
                          update_alpha, return_state, frame_mask=fm)
    if use_fused is None:
        use_fused = on_card
    fused = use_fused and em_fused_supported(obs.shape, num_classes,
                                             num_iters)
    if fused and gamma_init is None and num_classes == 2:
        # the K=2 Higuchi covariance init inside the kernel
        return cgmm_em_fused(obs, None, None, num_iters,
                             update_alpha=update_alpha, frame_mask=fm,
                             return_state=return_state, init="higuchi", **kw)
    if gamma_init is not None:
        gamma = gamma_init
        g = gamma if fm is None else gamma * fm
        den = torch.clamp(g.sum(-1, keepdim=True), min=EPSILON)
        covar = _weighted_covar(obs, g) / den[..., None]
    elif num_classes == 2:
        rs = _sample_covar(obs, fm)
        rn = torch.eye(m, dtype=obs.dtype, device=dev).expand(rs.shape)
        covar = torch.stack([rs, rn])
        gamma = None
    else:
        gamma = _uniform_init(num_classes, (*batch, f, t), obs, generator)
        g = gamma if fm is None else gamma * fm
        den = torch.clamp(g.sum(-1, keepdim=True), min=EPSILON)
        covar = _weighted_covar(obs, g) / den[..., None]
    # phi from R^{-1}: one shared inverse (the predict needs its logdet)
    r_inv, logdet0 = regularized_inverse(covar, return_logdet=True)
    phi = _quad_pairs(obs, r_inv) / m
    alpha = torch.full((num_classes, *batch, f), 1.0 / num_classes,
                       device=dev)
    gamma, _ = _cgmm_predict(obs, phi, covar, alpha, logdet=logdet0)
    if fused:
        shape = (num_classes, *batch, f, t)
        return cgmm_em_fused(obs, gamma.expand(shape), phi.expand(shape),
                             num_iters, update_alpha=update_alpha,
                             frame_mask=fm, return_state=return_state, **kw)
    return _cgmm_scan(obs, phi, covar, alpha, gamma, m, num_iters,
                      update_alpha, return_state, frame_mask=fm)


def _cgmm_scan(obs, phi, covar, alpha, gamma, m, num_iters, update_alpha,
               return_state, frame_mask=None):
    fm = frame_mask
    q_hist = []
    for _ in range(num_iters):
        g = gamma if fm is None else gamma * fm
        # M-step: R and phi (reference order: update then predict)
        den = torch.clamp(g.sum(-1, keepdim=True), min=EPSILON)
        covar = _weighted_covar(obs, g * m / phi) / den[..., None]
        r_inv, logdet = regularized_inverse(covar, return_logdet=True)
        phi = _cgmm_quad(obs, r_inv) / m
        if update_alpha:
            if fm is None:
                alpha = gamma.mean(-1)
            else:
                alpha = g.sum(-1) / torch.clamp(
                    fm.expand(gamma.shape).sum(-1), min=1.0)
        # E-step
        gamma, q = _cgmm_predict(obs, phi, covar, alpha, fm, logdet=logdet)
        q_hist.append(q)
    q_hist = torch.stack(q_hist)
    if return_state:
        return gamma, q_hist, {"phi": phi, "covar": covar, "alpha": alpha}
    return gamma, q_hist


def _cacgmm_predict(obs, covar, alpha, frame_mask=None):
    m = obs.shape[-2]
    b_inv, logdet = regularized_inverse(covar, return_logdet=True)
    kernel = _cgmm_quad(obs, b_inv)
    log_pdf = -m * torch.log(kernel) - logdet[..., None]
    gamma, q = _posterior(log_pdf, alpha, frame_mask)
    return gamma, kernel, q


def cacgmm_em(obs,
              num_classes: int,
              num_iters: int = 20,
              gamma_init=None,
              cgmm_init: bool = False,
              update_alpha: bool = True,
              generator: torch.Generator | None = None,
              state: dict | None = None,
              return_state: bool = False,
              frame_mask=None,
              use_fused: bool | None = None,
              sweeps: int | None = None,
              device=None):
    """CACGMM EM over obs (..., F, M, T), L2-normalized over the mic axis
    inside.

    Returns (gamma (K, ..., F, T), q_history), plus the state dict
    {covar, alpha} with ``return_state``, resumable through ``state``.
    """
    on_card, obs, fm, gamma_init, state = _prepare(
        obs, num_iters, device, frame_mask, gamma_init, state)
    dev = obs.device
    obs = norm_observation(obs, axis=-2)
    *batch, f, m, t = obs.shape
    alpha = torch.full((num_classes, *batch, f), 1.0 / num_classes,
                       device=dev)
    kw = {} if sweeps is None else {"sweeps": sweeps}
    if use_fused is None:
        use_fused = on_card
    fused = use_fused and state is None and em_fused_supported(
        obs.shape, num_classes, num_iters)
    if fused and cgmm_init and num_classes == 2 and gamma_init is None:
        # the covariance init inside the kernel
        return cacgmm_em_fused(obs, None, None, num_iters,
                               update_alpha=update_alpha, frame_mask=fm,
                               return_state=return_state, init="higuchi",
                               **kw)
    if state is not None:
        covar, alpha = state["covar"], state["alpha"]
        gamma, kernel, _ = _cacgmm_predict(obs, covar, alpha)
    elif cgmm_init and num_classes == 2:
        rs = _sample_covar(obs, fm)
        rn = torch.eye(m, dtype=obs.dtype, device=dev).expand(rs.shape)
        gamma, kernel, _ = _cacgmm_predict(obs, torch.stack([rs, rn]), alpha)
    else:
        if gamma_init is None:
            gamma = _uniform_init(num_classes, (*batch, f, t), obs,
                                  generator)
        else:
            gamma = gamma_init
        kernel = torch.ones((num_classes, *batch, f, t), device=dev)
    if fused:
        shape = (num_classes, *batch, f, t)
        return cacgmm_em_fused(obs, gamma.expand(shape), kernel.expand(shape),
                               num_iters, update_alpha=update_alpha,
                               frame_mask=fm, return_state=return_state,
                               **kw)
    q_hist = []
    for _ in range(num_iters):
        g = gamma if fm is None else gamma * fm
        # M-step: B update with kernel weighting
        den = torch.clamp(g.sum(-1, keepdim=True), min=EPSILON)
        covar = m * _weighted_covar(obs, g / kernel) / den[..., None]
        if update_alpha:
            if fm is None:
                alpha = gamma.mean(-1)
            else:
                alpha = g.sum(-1) / torch.clamp(
                    fm.expand(gamma.shape).sum(-1), min=1.0)
        # E-step
        gamma, kernel, q = _cacgmm_predict(obs, covar, alpha, fm)
        q_hist.append(q)
    q_hist = torch.stack(q_hist)
    if return_state:
        return gamma, q_hist, {"covar": covar, "alpha": alpha}
    return gamma, q_hist


# --------------------------------------------------------------------------
# Frequency permutation alignment (host side, numpy)
# --------------------------------------------------------------------------

# per-band alignment schedules (iterations, begin, end) keyed by F
_BAND_PLANS = {
    257: [[20, 70, 170], [2, 90, 190], [2, 50, 150], [2, 110, 210],
          [2, 30, 130], [2, 130, 230], [2, 0, 110], [2, 150, 257]],
    513: [[20, 100, 200], [2, 120, 220], [2, 80, 180], [2, 140, 240],
          [2, 60, 160], [2, 160, 260], [2, 40, 140], [2, 180, 280],
          [2, 0, 120], [2, 200, 300], [2, 220, 320], [2, 240, 340],
          [2, 260, 360], [2, 280, 380], [2, 300, 400], [2, 320, 420],
          [2, 340, 440], [2, 360, 460], [2, 380, 480], [2, 400, 513]]
}


def _norm_np(mat, axis):
    den = np.maximum(np.linalg.norm(mat, axis=axis, keepdims=True), EPSILON)
    return mat / den


def permu_aligner(masks, transpose=False):
    """Greedy per-band Hungarian alignment of cluster masks over frequency.

    masks: K x T x F (or K x F x T with transpose=True), numpy: the band
    sweeps are sequential with a data-dependent early exit.
    """
    from scipy.optimize import linear_sum_assignment
    masks = np.asarray(masks)
    if masks.ndim != 3:
        raise RuntimeError("Expect 3D TF-masks, K x T x F or K x F x T")
    if transpose:
        masks = np.transpose(masks, (0, 2, 1))
    num_k, _, num_f = masks.shape
    feature = _norm_np(masks.copy(), axis=1)
    mapping = np.stack([np.full(num_f, k, dtype=np.int64)
                        for k in range(num_k)])
    if num_f not in _BAND_PLANS:
        raise ValueError(f"Unsupported num_bins: {num_f}")
    for itr, beg, end in _BAND_PLANS[num_f]:
        for _ in range(itr):
            centroid = _norm_np(np.mean(feature[..., beg:end], axis=-1),
                                axis=-1)
            changed = False
            for f in range(beg, end):
                score = centroid @ _norm_np(feature[..., f], axis=-1).T
                index, permu = linear_sum_assignment(score, maximize=True)
                if np.any(permu != index):
                    feature[..., f] = feature[permu, :, f]
                    mapping[..., f] = mapping[permu, f]
                    changed = True
            if not changed:
                break
    aligned = np.zeros_like(masks)
    for f in range(num_f):
        aligned[..., f] = masks[mapping[..., f], :, f]
    return aligned if not transpose else np.transpose(aligned, (0, 2, 1))
