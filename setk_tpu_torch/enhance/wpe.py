"""WPE dereverberation and factored WPD, batched over leading axes.

Counterpart of ``setk_tpu/enhance/wpe.py``: delayed tap stacking, the
context-smoothed power lambda, the per-bin N taps x N taps normal-equation
solve (GWPE), and Nakatani's factored WPD interleaving a WPE step, a CGMM
mask and a lambda-weighted MVDR.  Layouts as there: obs (..., F, N, T)
complex, lambda (..., F, T).

Dispatch is the JAX package's with "on a TPU" read as "on a CUDA device"
(``use_fused=None``): where ``wpe_fused_supported`` admits the shape (N <= 8,
N taps <= 128) the card runs the tap-free fused loop, kernels 18 -> 17 per
iteration and 19 at the end (ops/cuda/wpe_gram.py, ops/cuda/cholesky.py);
elsewhere, or with ``use_fused=False``, the tap-matrix scan, whose
normal-equation solve is kernel 16 for 16 <= N taps <= 128.  WPD on the
card takes the fused WPE step with its own lambda, the fused CGMM
(kernel 15, 3 Jacobi sweeps), the pair covariance (kernel 12) and the
power-steer MVDR solve (kernel 2); outside the gate (N taps > 128) its
scan runs the CGMM, the masked covariance (kernel 13) and the eigh steer
(the EVD kernel) as ``setk_tpu/enhance/wpe.py:272`` does, and N > 8 on a
CUDA device raises (ROADMAP queue 1 item 15) before anything is copied.
On the CPU ``use_fused=True`` runs the kernels' plain versions in
the fused order.  Entry points run on ``cuda`` unless ``device="cpu"``.
"""

import torch

from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance.cluster import _as_tensor, cgmm_em
from setk_tpu_torch.ops.cuda.cholesky import solve_wpe_gram
from setk_tpu_torch.ops.cuda.eigh_small import MAX_DIM
from setk_tpu_torch.ops.cuda.mvdr import mvdr_power
from setk_tpu_torch.ops.cuda.wpe_gram import (tap_rows, wpe_apply, wpe_gram,
                                              wpe_fused_supported)
from setk_tpu_torch.ops.linalg import (equilibrated_hermitian_solve,
                                       hermitian_solve, solve_pevd)
from setk_tpu_torch.utils.common import EPSILON
from setk_tpu_torch.utils.device import full_f32_matmuls, resolve_device

__all__ = ["compute_tap_mat", "compute_lambda", "wpe_step", "wpe", "wpd"]


# (..., F, N, T) -> (..., F, N*taps, T): block k holds the observation
# delayed by k + delay frames, zero in front (kernels 18 and 19 build the
# same rows on the card)
compute_tap_mat = tap_rows


def compute_lambda(dereverb: torch.Tensor, context: int = 0) -> torch.Tensor:
    """Context-smoothed mean power: (..., F, N, T) -> (..., F, T).

    Mean over mics of |d|^2, then a (2 context + 1)-frame sliding average
    with edge-correct counts, floored at EPSILON.
    """
    power = (dereverb.real**2 + dereverb.imag**2).mean(-2)
    t = power.shape[-1]
    acc = torch.zeros_like(power)
    counts = torch.zeros(t, dtype=power.dtype, device=power.device)
    for c in range(-context, context + 1):
        s, e = max(c, 0), min(t, t + c)
        if e <= s:
            continue
        acc[..., s:e] += power[..., max(-c, 0):min(t, t - c)]
        counts[s:e] += 1.0
    return torch.clamp(acc / counts, min=EPSILON)


def wpe_step(reverb: torch.Tensor, taps_mat: torch.Tensor,
             lambda_: torch.Tensor, equilibrate: bool = False
             ) -> torch.Tensor:
    """One WPE filter update and application.

    reverb (..., F, N, T), taps_mat (..., F, NK, T), lambda (..., F, T);
    returns the dereverberated (..., F, N, T).  Both operands weighted by
    1 / sqrt(lambda) give corr and cross from one Gram of [reverb; taps];
    ``equilibrate`` (WPD) solves after symmetric Jacobi scaling; on a
    CUDA device the solve is kernel 16 for 16 <= NK <= 128.
    """
    n = reverb.shape[-2]
    s = torch.rsqrt(torch.clamp(lambda_, min=EPSILON))[..., None, :]
    y2 = torch.cat([reverb * s, taps_mat * s], dim=-2)
    gram = y2 @ y2.conj().transpose(-1, -2)
    corr = gram[..., n:, n:]
    cross = gram[..., n:, :n]
    solve = equilibrated_hermitian_solve if equilibrate else hermitian_solve
    filt = solve(corr, cross)
    return reverb - filt.conj().transpose(-1, -2) @ taps_mat


def _wpe_fused(reverb, taps, delay, context, num_iters):
    """Tap-free fused WPE: per iteration the weighted Gram (kernel 18, d
    and lambda from the previous filter) and the Gram-layout solve
    (kernel 17), then the filter application (kernel 19)."""
    *lead, f, n, t = reverb.shape
    nk = n * taps
    obs = reverb.reshape(-1, n, t).contiguous()
    g = None
    for i in range(num_iters):
        gram = wpe_gram(obs, g, taps, delay, context, use_g=i > 0)
        g = solve_wpe_gram(gram, row0=n, n=nk, k=n)
    return wpe_apply(obs, g, taps, delay).reshape(*lead, f, n, t)


def wpe(reverb,
        taps: int = 10,
        delay: int = 3,
        context: int = 1,
        num_iters: int = 3,
        use_fused: bool | None = None,
        device=None) -> torch.Tensor:
    """GWPE over (..., F, N, T): iterate lambda -> filter.

    ``device``: by default a tensor keeps its device and a numpy array
    goes to ``cuda``.  Returns complex64 on that device.
    """
    dev = resolve_device(device, like=reverb)
    if use_fused is None:
        use_fused = dev.type == "cuda" and wpe_fused_supported(
            reverb.shape[-2], taps)
    full_f32_matmuls(dev)
    reverb = _as_tensor(reverb, dev, torch.complex64)
    if use_fused:
        return _wpe_fused(reverb, taps, delay, context, num_iters)
    taps_mat = compute_tap_mat(reverb, taps, delay)
    dereverb = reverb
    for _ in range(num_iters):
        # zero-padded frames give lambda = 0: the floor keeps 0/0 out of
        # the tap correlations but weights them 1/EPSILON (the JAX
        # package's semantics; ROADMAP queue 3)
        lam = torch.clamp(compute_lambda(dereverb, context=context),
                          min=EPSILON)
        dereverb = wpe_step(reverb, taps_mat, lam)
    return dereverb


def _wpd_wpe_step_fused(obs, lam, n, taps, delay):
    """WPD's WPE step through the fused kernels with the WPD lambda as an
    operand: Gram (kernel 18), equilibrated solve at the loading floor
    4 N taps EPSILON (kernel 17), application (kernel 19)."""
    nk = n * taps
    gram = wpe_gram(obs, None, taps, delay, 0, use_g=False, lam=lam)
    g = solve_wpe_gram(gram, row0=n, n=nk, k=n, eps_rel=4.0 * nk * EPSILON,
                       equilibrate=True)
    return wpe_apply(obs, g, taps, delay)


def wpd(obs,
        cgmm_iters: int = 10,
        wpd_iters: int = 3,
        taps: int = 10,
        delay: int = 3,
        context: int = 1,
        update_alpha: bool = False,
        use_fused: bool | None = None,
        device=None):
    """Factored WPD: joint dereverberation and denoising.

    obs (F, N, T) complex (leading batch axes allowed).  Each outer
    iteration: a WPE step with the current lambda, CGMM masks on the
    dereverberated signal, then a lambda-weighted MVDR; lambda becomes the
    enhanced power.  Returns (tf_mask (..., F, T), enhanced (..., F, T)).
    """
    *lead, f, n, t = obs.shape
    dev = resolve_device(device, like=obs)
    if use_fused is None:
        use_fused = dev.type == "cuda" and wpe_fused_supported(n, taps)
    if dev.type == "cuda" and not use_fused and n > MAX_DIM:
        raise NotImplementedError(
            f"WPD of N = {n} > {MAX_DIM} mics on a CUDA device arrives "
            f"with ROADMAP queue 1 item 15")
    full_f32_matmuls(dev)
    obs = _as_tensor(obs, dev, torch.complex64)
    if use_fused:
        obs_flat = obs.reshape(-1, n, t).contiguous()
    else:
        taps_mat = compute_tap_mat(obs, taps, delay)
    enhanced = tf_mask = None
    for i in range(wpd_iters):
        if i == 0:
            lam = compute_lambda(obs, context=context)
        else:
            lam = torch.clamp(enhanced.abs()**2, min=EPSILON)
        if use_fused:
            der = _wpd_wpe_step_fused(obs_flat, lam.reshape(-1, t).to(
                torch.float32).contiguous(), n, taps, delay).reshape(
                    obs.shape)
        else:
            der = wpe_step(obs, taps_mat, lam, equilibrate=True)
        # the masks only seed the weighted MVDR: 3 Jacobi sweeps in the
        # fused EM on the card
        gamma, _ = cgmm_em(der, 2, num_iters=cgmm_iters,
                           update_alpha=update_alpha,
                           sweeps=3 if use_fused else None)
        tf_mask = gamma[0]  # speech class (sample-covariance init)
        if use_fused:
            # (Rs, Rd) in one pass over der; Rd normalized by sum(1 / lambda)
            # (the Capon weight is scale-invariant in Rd)
            rs, rd = bf.compute_covar_pair(der, tf_mask, 1.0 / lam)
            weight = mvdr_power(rs.contiguous(), rd.contiguous())
            enhanced = bf.beamform(weight, der)
        else:
            rd = (der / lam[..., None, :]) @ der.conj().transpose(-1, -2) / t
            rs = bf.compute_covar(der, tf_mask)
            steer = bf.fix_steer_phase(solve_pevd(rs))
            num = equilibrated_hermitian_solve(rd, steer)
            den = (steer.conj() * num).sum(-1)
            weight = num / den[..., None]
            enhanced = (weight.conj()[..., None] * der).sum(-2)
    return tf_mask, enhanced
