"""Mask-weighted PSDs and the supervised weight solves — the plain path.

Counterpart of ``setk_tpu/enhance/beamformer.py`` (the mvdr, mpdr,
gevd and pmwf weights, one-shot and online runs), batched over leading
axes, with the same layouts (F: bins, N: mics, T: frames):

    obs     (..., F, N, T)   complex STFT observations
    mask    (..., F, T)      real T-F masks
    covar   (..., F, N, N)   Hermitian PSDs
    weight  (..., F, N)      beamformer weights

This spectrum-domain path is what ``enhance_batch`` runs on the CPU,
and on a CUDA device for the geometries neither the fused nor the planar
kernels cover (mvdr with the power steer, with or without BAN, and
pmwf-0/1).  There ``compute_covar_pair`` runs the pair-covariance kernel
(ops/cuda/covariance_pair.pair_covar) for N <= 8, as the JAX package runs
its Pallas pair kernel on the TPU, and the power-steer MVDR solve runs
``mvdr_power``.  The single masked covariance (``covar_stats``,
``compute_covar``) runs the masked covariance kernel
(ops/cuda/covariance.masked_covar, kernel 13) for N <= 8, one read of
the observation for all K weight classes of the clustering EM.  What has
no kernel yet raises on a CUDA tensor: N > 8 (ROADMAP queue 1 item 15)
and the EVD (``ops.linalg.eigh``).
"""

import functools

import torch

from setk_tpu_torch.ops.cuda import covariance_pair as cp
from setk_tpu_torch.ops.cuda.covariance import MAX_MICS, masked_covar
from setk_tpu_torch.utils.common import EPSILON
from setk_tpu_torch.ops.linalg import (solve_pevd, hermitianize,
                                       hermitian_solve,
                                       equilibrated_hermitian_solve,
                                       power_iteration)

__all__ = [
    "covar_stats", "compute_covar", "compute_covar_pair", "beamform",
    "do_ban", "rank1_constraint", "fix_steer_phase", "mvdr_weights",
    "mpdr_weights", "gevd_weights", "pmwf_weights", "pmwf_select_ref",
    "pmwf_select_powers", "supervised_run", "online_supervised_run",
    "WEIGHT_FNS"
]


def covar_stats(obs: torch.Tensor, mask: torch.Tensor):
    """Unnormalized statistics: num = sum_t m y y^H, den = sum_t m.

    obs (..., F, N, T) and mask (..., F, T) broadcast over their leading
    axes (the clustering EM passes one observation against K classes).
    On a CUDA tensor with N <= 8 the numerator is kernel 13, which reads
    the observation once for every class that only its leading axes add;
    N > 8 there raises (ROADMAP queue 1 item 15).
    """
    den = mask.sum(-1)
    if obs.device.type != "cuda":
        num = (mask[..., None, :] * obs) @ obs.conj().transpose(-1, -2)
        return num, den
    *obs_lead, f, n, t = obs.shape
    if n > MAX_MICS:
        raise NotImplementedError(
            f"a masked covariance of N = {n} > {MAX_MICS} mics on a CUDA "
            f"device arrives with ROADMAP queue 1 item 15")
    lead = torch.broadcast_shapes(tuple(obs_lead), tuple(mask.shape[:-2]))
    while obs_lead and obs_lead[0] == 1:
        obs_lead = obs_lead[1:]
    # the classes are the leading axes only the mask has; obs is
    # expanded (copied) only where it broadcasts inside its own axes
    n_cls = len(lead) - len(obs_lead)
    if tuple(lead[n_cls:]) != tuple(obs_lead):
        n_cls = 0
    y = obs.reshape(*obs_lead, f, n, t).to(torch.complex64).expand(
        *lead[n_cls:], f, n, t).reshape(-1, f, n, t).contiguous()
    w = mask.to(torch.float32).expand(*lead, f, t).reshape(
        -1, y.shape[0], f, t).contiguous()
    num = masked_covar(y, w)
    return num.reshape(*lead, f, n, n).to(obs.dtype), den


def compute_covar(obs: torch.Tensor, mask: torch.Tensor,
                  denom_floor: float = 1e-6) -> torch.Tensor:
    """R[f] = sum_t m[f,t] y y^H / max(sum_t m[f,t], denom_floor)."""
    num, den = covar_stats(obs, mask)
    return num / torch.clamp(den, min=denom_floor)[..., None, None]


def compute_covar_pair(obs: torch.Tensor, mask_s: torch.Tensor,
                       mask_n: torch.Tensor | None = None,
                       denom_floor: float = 1e-6):
    """(Rs, Rn) with Rn from the literal sum_t max(1 - m, 0) y y^H (never
    total minus masked, which goes indefinite for masks near one).

    For N <= 8 both numerators come from one pass over obs through
    ``ops.cuda.covariance_pair.pair_covar`` (kernel 12 on a CUDA tensor,
    its plain version on the CPU), in the (B, N, T, F) layout of the
    STFT: when obs is a permuted view of a spectrum, as in
    ``enhance_batch``, nothing is copied.  Each covariance is normalized
    by max(sum_t mask, ``denom_floor``), as compute_covar_pair_pallas
    does (setk_tpu/ops/pallas/covariance_pair.py:170-206).
    """
    *lead, f, n, t = obs.shape
    if n > cp.MAX_MICS:
        rs = compute_covar(obs, mask_s, denom_floor)
        rn = compute_covar(obs,
                           torch.clamp(1 - mask_s, min=0) if mask_n is None
                           else mask_n,
                           denom_floor)
        return rs, rn
    on_cuda = obs.device.type == "cuda"
    ntf = obs.movedim(-3, -1).reshape(-1, n, t, f)      # (B, N, T, F)

    def frames_by_bins(m):                              # (..., F, T) -> (B, T, F)
        m = m.to(torch.float32).expand(*lead, f, t).movedim(-1, -2)
        m = m.reshape(-1, t, f)
        return m.contiguous() if on_cuda else m

    ms = frames_by_bins(mask_s)
    mn = (torch.clamp(1.0 - ms, min=0.0) if mask_n is None
          else frames_by_bins(mask_n))
    rs_re, rs_im, rn_re, rn_im = cp.pair_covar(
        ntf.contiguous() if on_cuda else ntf, ms, mn)

    def finish(num_re, num_im, m):
        num = torch.complex(num_re, num_im).permute(0, 3, 1, 2)
        den = torch.clamp(m.sum(1), min=denom_floor)    # (B, F)
        return (num / den[..., None, None]).reshape(*lead, f, n, n).to(
            obs.dtype)

    return finish(rs_re, rs_im, ms), finish(rn_re, rn_im, mn)


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


def rank1_constraint(rs: torch.Tensor,
                     rn: torch.Tensor | None = None) -> torch.Tensor:
    """Rank-1 approximation of Rs (GEV-based with ``rn``), rescaled to
    Rs's trace."""
    pvec = solve_pevd(rs, rn)
    if rn is not None:
        pvec = (rn * pvec[..., None, :]).sum(-1)
    appro = pvec[..., :, None] * pvec.conj()[..., None, :]
    tr_a = torch.diagonal(appro, dim1=-2, dim2=-1).sum(-1)
    scale = (torch.diagonal(rs, dim1=-2, dim2=-1).sum(-1) /
             torch.clamp(tr_a.abs(), min=EPSILON))
    return scale[..., None, None] * appro


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
        vec = solve_pevd(rs)
    else:
        raise ValueError(f"Unknown steer method: {steer}")
    return _capon(fix_steer_phase(vec), rn)


def mpdr_weights(rs: torch.Tensor, ry: torch.Tensor,
                 rn: torch.Tensor | None = None) -> torch.Tensor:
    """MPDR: Capon on the observation PSD Ry.  The steer vector is Rs's
    principal eigenvector, or with ``rn`` the whitened GEV vector
    Rn x (principal generalized eigenvector of (Rs, Rn))."""
    if rn is None:
        steer = solve_pevd(rs)
    else:
        steer = (rn * solve_pevd(rs, rn)[..., None, :]).sum(-1)
    return _capon(fix_steer_phase(steer), ry)


def gevd_weights(rs: torch.Tensor, rn: torch.Tensor) -> torch.Tensor:
    """Max-SNR / GEV beamformer: the principal generalized eigenvector,
    v^H Rn v = 1, phase-anchored to channel 0."""
    return fix_steer_phase(solve_pevd(rs, rn))


def pmwf_weights(rs: torch.Tensor, rn: torch.Tensor,
                 beta: float = 0.0, ref_channel: int = -1,
                 rank1_appro: str = "") -> torch.Tensor:
    """Parameterized multichannel Wiener filter (Souden):
    w = Rn^{-1} Rs u / (beta + tr(Rn^{-1} Rs)); beta 0 is the MVDR form,
    1 the MCWF.  ``ref_channel < 0`` picks the reference channel by the
    estimated output SNR; ``rank1_appro`` "eig" or "gev" replaces Rs by
    its rank-1 approximation first."""
    if rank1_appro == "eig":
        rs = rank1_constraint(rs)
    elif rank1_appro == "gev":
        rs = rank1_constraint(rs, rn=rn)
    num = hermitian_solve(rn, rs)                     # (..., F, N, N)
    den = beta + torch.diagonal(num, dim1=-2, dim2=-1).sum(-1)
    return pmwf_select_ref(num / den[..., None, None], rs, rn,
                           ref_channel=ref_channel)


def _select_column(weight_mat: torch.Tensor, snr: torch.Tensor):
    """Column argmax(snr) of every bin's weight matrix; snr (..., C)."""
    ref = torch.argmax(snr, dim=-1)                   # (...)
    idx = ref[..., None, None, None].expand(*weight_mat.shape[:-1], 1)
    return torch.gather(weight_mat, -1, idx)[..., 0]


def pmwf_select_ref(weight_mat: torch.Tensor, rs: torch.Tensor,
                    rn: torch.Tensor, ref_channel: int = -1) -> torch.Tensor:
    """The PMWF output column: ``ref_channel`` or, when negative, the
    channel c of largest sum_f w_c^H Rs w_c / sum_f w_c^H Rn w_c."""
    if ref_channel >= 0:
        return weight_mat[..., ref_channel]
    wc = weight_mat.transpose(-1, -2)                 # rows = channels
    pow_s = torch.einsum("...fca,...fab,...fcb->...c", wc.conj(), rs,
                         wc).real
    pow_n = torch.einsum("...fca,...fab,...fcb->...c", wc.conj(), rn,
                         wc).real
    return _select_column(weight_mat,
                          pow_s / torch.clamp(pow_n, min=EPSILON))


def pmwf_select_powers(weight_mat: torch.Tensor, pow_s: torch.Tensor,
                       pow_n: torch.Tensor) -> torch.Tensor:
    """``pmwf_select_ref(ref_channel=-1)`` from precomputed per-bin,
    per-channel powers (..., F, C), as the pmwf_solve kernel emits them."""
    snr = (pow_s.sum(-2) / torch.clamp(pow_n.sum(-2), min=EPSILON))
    return _select_column(weight_mat, snr)


WEIGHT_FNS = {
    "mvdr": mvdr_weights,
    "gevd": gevd_weights,
    "pmwf-0": functools.partial(pmwf_weights, beta=0.0),
    "pmwf-1": functools.partial(pmwf_weights, beta=1.0),
}


def supervised_run(beamformer: str,
                   obs: torch.Tensor,
                   mask_s: torch.Tensor,
                   mask_n: torch.Tensor | None = None,
                   ban: bool = False,
                   **kwargs) -> torch.Tensor:
    """One-shot mask-based beamforming: masks + obs -> enhanced STFT
    (..., F, T).

    On a CUDA tensor the covariance pair runs kernel 12 and mvdr's power
    steer runs ``mvdr_power``; what needs the EVD (the eigh steer, gevd,
    mpdr, mpdr-whiten) or the single masked covariance (mpdr's Ry) raises.
    """
    rs, rn = compute_covar_pair(obs, mask_s, mask_n)
    if beamformer in ("mpdr", "mpdr-whiten"):
        ry = compute_covar(obs, torch.ones_like(mask_s))
        weight = mpdr_weights(rs, ry,
                              rn=rn if beamformer == "mpdr-whiten" else None)
    elif beamformer in WEIGHT_FNS:
        weight = WEIGHT_FNS[beamformer](rs, rn, **kwargs)
    else:
        raise ValueError(f"Unknown beamformer: {beamformer}")
    if ban:
        weight = do_ban(weight, rn)
    return beamform(weight, obs)


def online_supervised_run(beamformer: str,
                          obs: torch.Tensor,
                          mask_s: torch.Tensor,
                          mask_n: torch.Tensor | None = None,
                          chunk_size: int = 32,
                          alpha: float = 0.8,
                          ban: bool = False) -> torch.Tensor:
    """Chunked online beamforming with EMA covariance state.

    T splits into chunks; (Rs, Rn) carry over chunks as
    R <- alpha R + (1 - alpha) R_chunk (the first chunk initializes) and
    each chunk is beamformed with the weights of the state after it.  BAN
    normalizes against the chunk's own Rn, as the JAX package does.  T
    must be a multiple of ``chunk_size`` (pad upstream; masks zero the
    pad frames).  The plain path: on a CUDA tensor it raises; the card
    runs online mvdr through the online kernels
    (enhance/pipeline.mvdr_enhance_fused_online) and the rest of the
    online family arrives with ROADMAP queue 1 item 13.
    """
    if beamformer not in WEIGHT_FNS:
        raise ValueError(f"Unknown online beamformer: {beamformer}")
    if obs.device.type == "cuda":
        raise NotImplementedError(
            "the spectrum-domain online run on a CUDA device arrives with "
            "the batched small-matrix EVD kernel, ROADMAP queue 1 item 13; "
            "enhance_batch runs online mvdr through the online kernels")
    t_frames = obs.shape[-1]
    if t_frames % chunk_size:
        raise ValueError(f"T={t_frames} not a multiple of {chunk_size}")
    m_n = torch.clamp(1 - mask_s, min=0) if mask_n is None else mask_n
    rs_ema = rn_ema = None
    chunks = []
    for beg in range(0, t_frames, chunk_size):
        end = beg + chunk_size
        obs_k = obs[..., beg:end]
        rs = compute_covar(obs_k, mask_s[..., beg:end])
        rn = compute_covar(obs_k, m_n[..., beg:end])
        if rs_ema is None:
            rs_ema, rn_ema = rs, rn
        else:
            rs_ema = rs_ema * alpha + (1.0 - alpha) * rs
            rn_ema = rn_ema * alpha + (1.0 - alpha) * rn
        weight = WEIGHT_FNS[beamformer](rs_ema, rn_ema)
        if ban:
            weight = do_ban(weight, rn)
        chunks.append(beamform(weight, obs_k))
    return torch.cat(chunks, dim=-1)
