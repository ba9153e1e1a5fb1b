"""Eigenvalue-floored inverse of small Hermitian matrices (kernel 14), and
the batched Hermitian EVD, both by round-robin complex Jacobi with a stop.

Counterpart of ``setk_tpu/ops/pallas/eigh_small.py``: ``_jacobi_flat``
(:183) via ``regularized_inverse_pallas`` (:207); kernel source
``setk_tpu_torch/csrc/eigh_small.cu``:

  regularized_inverse: a (..., M, M) complex64 -> (inv (..., M, M)
      complex64, logdet (...) f32): eigenvalues scaled by their maximum,
      floored at EPSILON and inverted, the logdet of the scaled spectrum.
      ``regularized_inverse_kernel`` (a thread a matrix) and
      ``regularized_inverse_lanes_kernel`` (a lane group a matrix), picked
      by the matrix count and M; ``regularized_inverse_plain`` is their
      plain version: the EVD's sweeps below (``sweeps`` = 6, the TPU's
      count, a cap), then the TPU kernel's floored inverse.  M <= 8 on the
      card.

``jacobi_regularized_inverse_plain`` keeps the TPU kernel's own cyclic
sweeps and statements (eigh_small.py:40-167, ``csrc/jacobi.cuh``), which
kernel 15's Jacobi runs.

  hermitian_eigh: a (..., M, M) [, b (..., M, M)] complex64 -> (w (..., M)
      f32 ascending, V (..., M, M) complex64 in columns): the EVD of
      herm(a), or with b the generalized EVD of (herm(a), herm(b)) by
      Cholesky whitening of the loaded b (v^H B v = I), the statements of
      setk_tpu/ops/linalg.py:178-199.  No TPU kernel: the JAX package runs
      XLA's eigh there.  Kernel source csrc/eigh_small.cu
      ``hermitian_eigh_kernel`` (a thread a matrix) and
      ``hermitian_eigh_lanes_kernel`` (a lane group a matrix);
      ``hermitian_eigh_plain`` is their plain version: the same round-robin
      sweeps (``eigh_schedule``), angle formulas and stop (every
      off-diagonal |a_pq| <= M EPS ||A||_F at a sweep's start; ``sweeps``
      is a cap, ``eigh_sweeps_needed`` counts what each matrix takes), the
      same Cholesky, substitutions and order of columns.
"""

import torch

from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.utils.common import EPSILON

__all__ = ["MAX_DIM", "SWEEPS", "EIGH_SWEEPS", "regularized_inverse",
           "regularized_inverse_plain", "inverse_sweeps_needed",
           "inverse_form", "inverse_forms",
           "jacobi_regularized_inverse_plain", "hermitian_eigh",
           "hermitian_eigh_plain", "eigh_schedule", "eigh_sweeps_needed",
           "eigh_form", "eigh_forms"]

MAX_DIM = 8
# kernel 14's sweeps: the TPU kernel's _SWEEPS, a cap on the card
SWEEPS = 6
# the EVD's sweeps: setk_tpu/ops/jacobi.py jacobi_eigh's default
EIGH_SWEEPS = 8
_TINY = 1e-30


def _hermitianize_planes(a_re: torch.Tensor, a_im: torch.Tensor):
    """jacobi.cuh's hermitianize on (n, M, M) f32 planes (fresh tensors)."""
    m = a_re.shape[-1]
    a_re = 0.5 * (a_re + a_re.transpose(-1, -2))
    a_im = 0.5 * (a_im - a_im.transpose(-1, -2))
    a_im = a_im * (1.0 - torch.eye(m, dtype=a_im.dtype, device=a_im.device))
    return a_re, a_im


def _jacobi_sweeps(a_re: torch.Tensor, a_im: torch.Tensor, sweeps: int):
    """jacobi.cuh's jacobi_sweeps: diagonalizes the Hermitian planes in
    place and returns V = (v_re, v_im)."""
    m = a_re.shape[-1]
    v_re = torch.eye(m, dtype=a_re.dtype, device=a_re.device).expand(
        a_re.shape).clone()
    v_im = torch.zeros_like(a_re)
    one = torch.ones((), dtype=a_re.dtype, device=a_re.device)
    for _ in range(sweeps):
        for p in range(m - 1):
            for q in range(p + 1, m):
                apq_re, apq_im = a_re[:, p, q], a_im[:, p, q]
                r2 = apq_re * apq_re + apq_im * apq_im
                r = torch.sqrt(torch.clamp(r2, min=_TINY))
                # phase e^{i phi} = apq / r, 1 for an annihilated entry
                safe = r2 > _TINY
                ph_re = torch.where(safe, apq_re / r, one)
                ph_im = torch.where(safe, apq_im / r, 0.0 * one)
                tau = (a_re[:, q, q] - a_re[:, p, p]) / (2.0 * r)
                sgn = torch.where(tau >= 0, one, -one)
                t = sgn / (tau.abs() + torch.sqrt(1.0 + tau * tau))
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = t * c
                _rotate(a_re, a_im, v_re, v_im, [(p, q)],
                        [(c, s, ph_re, ph_im)])
    return v_re, v_im


def _rotate(a_re, a_im, v_re, v_im, pairs, angles):
    """A <- G^H A G and V <- V G for the disjoint rotations of ``pairs``
    ((x, y) each: G[x][x] = c, G[x][y] = s, G[y][x] = -conj(ph) s,
    G[y][y] = conj(ph) c, with ``angles`` (c, s, ph_re, ph_im) each):
    every pair's columns, then every pair's rows, then V's columns."""
    gs = []
    for c, s, ph_re, ph_im in angles:
        gs.append((c[:, None], s[:, None], (-ph_re * s)[:, None],
                   (ph_im * s)[:, None], (ph_re * c)[:, None],
                   (-ph_im * c)[:, None]))
    for (x, y), (c, gxy, gyx_re, gyx_im, gyy_re, gyy_im) in zip(pairs, gs):
        # columns: A <- A G on columns x, y
        akx_re, akx_im = a_re[:, :, x].clone(), a_im[:, :, x].clone()
        aky_re, aky_im = a_re[:, :, y].clone(), a_im[:, :, y].clone()
        a_re[:, :, x] = akx_re * c + aky_re * gyx_re - aky_im * gyx_im
        a_im[:, :, x] = akx_im * c + aky_re * gyx_im + aky_im * gyx_re
        a_re[:, :, y] = akx_re * gxy + aky_re * gyy_re - aky_im * gyy_im
        a_im[:, :, y] = akx_im * gxy + aky_re * gyy_im + aky_im * gyy_re
    for (x, y), (c, gxy, gyx_re, gyx_im, gyy_re, gyy_im) in zip(pairs, gs):
        # rows: A <- G^H A on rows x, y
        axk_re, axk_im = a_re[:, x, :].clone(), a_im[:, x, :].clone()
        ayk_re, ayk_im = a_re[:, y, :].clone(), a_im[:, y, :].clone()
        a_re[:, x, :] = axk_re * c + ayk_re * gyx_re + ayk_im * gyx_im
        a_im[:, x, :] = axk_im * c + ayk_im * gyx_re - ayk_re * gyx_im
        a_re[:, y, :] = axk_re * gxy + ayk_re * gyy_re + ayk_im * gyy_im
        a_im[:, y, :] = axk_im * gxy + ayk_im * gyy_re - ayk_re * gyy_im
    for (x, y), (c, gxy, gyx_re, gyx_im, gyy_re, gyy_im) in zip(pairs, gs):
        # V <- V G
        vkx_re, vkx_im = v_re[:, :, x].clone(), v_im[:, :, x].clone()
        vky_re, vky_im = v_re[:, :, y].clone(), v_im[:, :, y].clone()
        v_re[:, :, x] = vkx_re * c + vky_re * gyx_re - vky_im * gyx_im
        v_im[:, :, x] = vkx_im * c + vky_re * gyx_im + vky_im * gyx_re
        v_re[:, :, y] = vkx_re * gxy + vky_re * gyy_re - vky_im * gyy_im
        v_im[:, :, y] = vkx_im * gxy + vky_re * gyy_im + vky_im * gyy_re


def eigh_schedule(m: int) -> list:
    """One sweep of the EVD's round-robin ("chess tournament", Brent-Luk)
    order, as eigh_small.cu's rr_player gives it: a list of rounds, each
    a list of disjoint (x, y) pairs, every pair {x, y} of 0..M-1 once a
    sweep.  Players 0..P-1 (P = M rounded up to even; index M is the bye
    of an odd M) sit at positions 0..P-1; position 0 keeps player 0,
    position k >= 1 holds player (k - 1 + r) % (P - 1) + 1 in round r;
    slot i pairs positions i and P-1-i.  P - 1 rounds a sweep."""
    players = m + (m & 1)

    def player(pos, r):
        return 0 if pos == 0 else (pos - 1 + r) % (players - 1) + 1

    return [[(player(i, r), player(players - 1 - i, r))
             for i in range(players // 2)
             if max(player(i, r), player(players - 1 - i, r)) < m]
            for r in range(players - 1)]


def _eigh_angle(app, aqq, apq_re, apq_im, still):
    """eigh_small.cu's rr_angle: (c, s, ph_re, ph_im) of the rotation
    that annihilates a_pq, the identity where ``still`` is False or
    |a_pq|^2 <= 1e-30; one rsqrt for the phase and tau, one reciprocal
    for t, one rsqrt for c."""
    one = torch.ones((), dtype=app.dtype, device=app.device)
    zero = torch.zeros((), dtype=app.dtype, device=app.device)
    r2 = apq_re * apq_re + apq_im * apq_im
    rotate = still & (r2 > _TINY)
    rs = torch.rsqrt(torch.where(rotate, r2, one))
    ph_re = torch.where(rotate, apq_re * rs, one)
    ph_im = torch.where(rotate, apq_im * rs, zero)
    tau = (aqq - app) * 0.5 * rs
    q = tau * tau + 1.0
    sgn = torch.where(tau >= 0, one, -one)
    # past ~1.8e19 t is below 3e-20: 0
    t = torch.where(rotate & (q < float("inf")),
                    sgn / (tau.abs() + q * torch.rsqrt(q)), zero)
    c = torch.where(rotate, torch.rsqrt(t * t + 1.0), one)
    s = torch.where(rotate, t * c, zero)
    return c, s, ph_re, ph_im


def _eigh_tolerance(a_re, a_im):
    """The stopping test's bar on |a_pq|^2, (M EPS ||A||_F)^2: ||A||_F^2
    summed in the kernel's row-major order.  Below M EPS ||A||_F an entry
    sits at f32's rounding floor, where a bar of EPS ||A||_F alone is
    missed by a few matrices in a thousand (rank one plus noise), which
    then run every sweep."""
    m = a_re.shape[-1]
    f2 = torch.zeros_like(a_re[:, 0, 0])
    for i in range(m):
        for j in range(m):
            f2 = f2 + (a_re[:, i, j] * a_re[:, i, j] +
                       a_im[:, i, j] * a_im[:, i, j])
    return (m * EPSILON) ** 2 * f2


def _eigh_converged(a_re, a_im, tol2):
    """Every off-diagonal |a_pq|^2 <= tol2 (p < q), per matrix."""
    m = a_re.shape[-1]
    done = torch.ones_like(tol2, dtype=torch.bool)
    for p in range(m - 1):
        for q in range(p + 1, m):
            done &= (a_re[:, p, q] * a_re[:, p, q] +
                     a_im[:, p, q] * a_im[:, p, q]) <= tol2
    return done


def _eigh_sweeps(a_re: torch.Tensor, a_im: torch.Tensor, sweeps: int):
    """The EVD kernel's sweeps on Hermitian planes, in place: at most
    ``sweeps`` round-robin sweeps, each round's angles from the round's
    starting A, then its columns, rows and V; a matrix stops (identity
    rotations) once every off-diagonal entry passes _eigh_converged at a
    sweep's start.  Returns (v_re, v_im, sweeps each matrix took)."""
    m = a_re.shape[-1]
    v_re = torch.eye(m, dtype=a_re.dtype, device=a_re.device).expand(
        a_re.shape).clone()
    v_im = torch.zeros_like(a_re)
    taken = torch.zeros(a_re.shape[0], dtype=torch.int64,
                        device=a_re.device)
    tol2 = _eigh_tolerance(a_re, a_im)
    rounds = eigh_schedule(m)
    for _ in range(sweeps):
        still = ~_eigh_converged(a_re, a_im, tol2)
        if not bool(still.any()):
            break
        taken += still.to(torch.int64)
        for pairs in rounds:
            angles = [_eigh_angle(a_re[:, x, x], a_re[:, y, y],
                                  a_re[:, x, y], a_im[:, x, y], still)
                      for x, y in pairs]
            _rotate(a_re, a_im, v_re, v_im, pairs, angles)
    return v_re, v_im, taken


def _floored_inverse(w: torch.Tensor, v_re: torch.Tensor,
                     v_im: torch.Tensor):
    """The TPU kernel's ending on the eigenvalues w (n, M) and V planes:
    w /= max(max(w), EPS); w = max(w, EPS); inv = V diag(1/w) V^H, each
    entry summed over y = 0..M-1 in order, the upper triangle mirrored;
    logdet = sum log w in index order.  Returns (inv_re, inv_im,
    logdet)."""
    m = w.shape[-1]
    wmax = w[:, 0]
    for i in range(1, m):
        wmax = torch.maximum(wmax, w[:, i])
    wmax = torch.clamp(wmax, min=EPSILON)
    logdet = torch.zeros_like(wmax)
    winv = []
    for i in range(m):
        wi = torch.clamp(w[:, i] / wmax, min=EPSILON)
        logdet = logdet + torch.log(wi)
        winv.append(1.0 / wi)
    inv_re = torch.empty_like(v_re)
    inv_im = torch.empty_like(v_im)
    for i in range(m):
        for j in range(i, m):
            acc_re = torch.zeros_like(wmax)
            acc_im = torch.zeros_like(wmax)
            for y in range(m):
                p_re = (v_re[:, i, y] * v_re[:, j, y] +
                        v_im[:, i, y] * v_im[:, j, y])
                p_im = (v_im[:, i, y] * v_re[:, j, y] -
                        v_re[:, i, y] * v_im[:, j, y])
                acc_re = acc_re + p_re * winv[y]
                acc_im = acc_im + p_im * winv[y]
            inv_re[:, i, j], inv_im[:, i, j] = acc_re, acc_im
            if j != i:
                inv_re[:, j, i], inv_im[:, j, i] = acc_re, -acc_im
    return inv_re, inv_im, logdet


def _jacobi_planes(a_re: torch.Tensor, a_im: torch.Tensor, sweeps: int):
    """The Jacobi of eigh_small.py:40-167 on (n, M, M) f32 planes; returns
    (inv_re, inv_im, logdet)."""
    a_re, a_im = _hermitianize_planes(a_re, a_im)
    v_re, v_im = _jacobi_sweeps(a_re, a_im, sweeps)
    return _floored_inverse(torch.diagonal(a_re, dim1=-2, dim2=-1), v_re,
                            v_im)


def jacobi_regularized_inverse_plain(covar: torch.Tensor,
                                     sweeps: int = SWEEPS):
    """The TPU kernel's cyclic Jacobi (eigh_small.py:40-167, jacobi.cuh's
    statements, which kernel 15 runs): (inv, logdet) of (..., M, M)
    complex."""
    lead, m = covar.shape[:-2], covar.shape[-1]
    flat = covar.reshape(-1, m, m)
    inv_re, inv_im, logdet = _jacobi_planes(
        flat.real.to(torch.float32), flat.imag.to(torch.float32), sweeps)
    inv = torch.complex(inv_re, inv_im).reshape(*lead, m, m)
    return inv.to(covar.dtype), logdet.reshape(lead)


def _inverse_planes(covar: torch.Tensor, sweeps: int):
    """Kernel 14's arithmetic on (..., M, M) ``covar``: (inv_re, inv_im,
    logdet, sweeps each matrix took), flat over the leading axes."""
    m = covar.shape[-1]
    flat = covar.reshape(-1, m, m)
    a_re, a_im = _hermitianize_planes(flat.real.to(torch.float32),
                                      flat.imag.to(torch.float32))
    v_re, v_im, taken = _eigh_sweeps(a_re, a_im, sweeps)
    return (*_floored_inverse(torch.diagonal(a_re, dim1=-2, dim2=-1), v_re,
                              v_im), taken)


def regularized_inverse_plain(covar: torch.Tensor, sweeps: int = SWEEPS):
    """Plain version of kernel 14: (inv, logdet) of (..., M, M) complex,
    the EVD's round-robin sweeps (at most ``sweeps``, each matrix stopping
    once it passes the EVD's test), then the floored inverse."""
    lead, m = covar.shape[:-2], covar.shape[-1]
    inv_re, inv_im, logdet, _ = _inverse_planes(covar, sweeps)
    inv = torch.complex(inv_re, inv_im).reshape(*lead, m, m)
    return inv.to(covar.dtype), logdet.reshape(lead)


def inverse_sweeps_needed(covar: torch.Tensor, sweeps: int = SWEEPS):
    """The sweeps kernel 14 takes on each matrix of ``covar``, (...)
    int64, at most ``sweeps``: what its operation count is taken from."""
    return _inverse_planes(covar, sweeps)[3].reshape(covar.shape[:-2])


_FORMS = {None: -1, "thread": 0, "lanes": 1}


def regularized_inverse(covar: torch.Tensor, sweeps: int = SWEEPS,
                        form: str | None = None):
    """Kernel 14: (inv (..., M, M) complex64, logdet (...) f32).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``regularized_inverse.launches`` counts those launches), any batch in
    one launch, in the form the launcher picks by the matrix count and M
    (``form`` None), or a thread a matrix ("thread") or a lane group a
    matrix ("lanes") where ``inverse_forms`` offers it.
    """
    if form not in _FORMS:
        raise ValueError(f"regularized_inverse: form {form!r} is not one of "
                         f"{sorted(_FORMS, key=str)}")
    if covar.device.type == "cpu":
        return regularized_inverse_plain(covar, sweeps)
    m = covar.shape[-1]
    if covar.dtype != torch.complex64 or covar.ndim < 2 or \
            covar.shape[-2] != m or covar.numel() == 0:
        raise ValueError(f"regularized_inverse: covar must be a non-empty "
                         f"complex64 (..., M, M) CUDA tensor, got "
                         f"{covar.dtype} {tuple(covar.shape)}")
    if m > MAX_DIM:
        raise ValueError(f"regularized_inverse: M = {m} > {MAX_DIM}")
    if sweeps < 0:
        raise ValueError(f"regularized_inverse: sweeps = {sweeps} < 0")
    if form is not None and form not in inverse_forms(m):
        raise ValueError(f"regularized_inverse: no {form!r} form at M = {m}")
    lead = covar.shape[:-2]
    src = covar.contiguous()
    inv = torch.empty_like(src)
    logdet = torch.empty(lead, dtype=torch.float32, device=covar.device)
    _build.launch("eigh_small", "regularized_inverse_launch", covar.device,
                  src.data_ptr(), inv.data_ptr(), logdet.data_ptr(),
                  src.numel() // (m * m), m, sweeps, _FORMS[form])
    regularized_inverse.launches += 1
    return inv, logdet


regularized_inverse.launches = 0

# the M at which each form of kernel 14 is built: those at which its
# launcher's pick (eigh_small.cu kInverseLanesUpTo) can take it
_INVERSE_BUILT = {"thread": (1, 2, 3, 5, 6, 7), "lanes": (4, 5, 6, 7, 8)}


def inverse_forms(m: int) -> tuple:
    """The forms kernel 14 is built in at M: a thread a matrix at M <= 3
    and 5-7, a lane group a matrix at M >= 4."""
    return tuple(form for form, ms in _INVERSE_BUILT.items() if m in ms)


def inverse_form(n: int, m: int) -> str:
    """The form kernel 14's launcher takes for n matrices of M x M (builds
    the kernel library)."""
    pick = _build.library("eigh_small").regularized_inverse_pick(n, m)
    return "lanes" if pick else "thread"


def _loaded_cholesky_planes(b_re: torch.Tensor, b_im: torch.Tensor,
                            eps_rel: float):
    """eigh_small.cu's loaded_cholesky on (n, M, M) planes: the strictly
    lower triangle of L in (l_re, l_im) and the reciprocal pivots dinv
    (n, M)."""
    m = b_re.shape[-1]
    l_re, l_im = _hermitianize_planes(b_re, b_im)
    tr = torch.zeros_like(l_re[:, 0, 0])
    for i in range(m):
        tr = tr + l_re[:, i, i]
    load = eps_rel * (tr / m) + EPSILON
    dinv = torch.empty_like(l_re[:, 0])
    for j in range(m):
        d = l_re[:, j, j] + load
        for q in range(j):
            d = d - (l_re[:, j, q] * l_re[:, j, q] +
                     l_im[:, j, q] * l_im[:, j, q])
        dinv[:, j] = 1.0 / torch.sqrt(d)
        re, im = l_re[:, j + 1:, j], l_im[:, j + 1:, j]
        for q in range(j):
            lrq, liq = l_re[:, j, q, None], l_im[:, j, q, None]
            re = re - (l_re[:, j + 1:, q] * lrq + l_im[:, j + 1:, q] * liq)
            im = im - (l_im[:, j + 1:, q] * lrq - l_re[:, j + 1:, q] * liq)
        l_re[:, j + 1:, j] = re * dinv[:, j, None]
        l_im[:, j + 1:, j] = im * dinv[:, j, None]
    return l_re, l_im, dinv


def _whiten_planes(a_re, a_im, l_re, l_im, dinv):
    """C = L^{-1} A L^{-H} as the kernel forms it: X = L^{-1} A by rows,
    then each row z of C solving z L^H = x, in place."""
    m = a_re.shape[-1]
    for i in range(m):
        re, im = a_re[:, i, :], a_im[:, i, :]
        for q in range(i):
            lr, li = l_re[:, i, q, None], l_im[:, i, q, None]
            re = re - (lr * a_re[:, q, :] - li * a_im[:, q, :])
            im = im - (lr * a_im[:, q, :] + li * a_re[:, q, :])
        a_re[:, i, :] = re * dinv[:, i, None]
        a_im[:, i, :] = im * dinv[:, i, None]
    for j in range(m):
        re, im = a_re[:, :, j], a_im[:, :, j]
        for q in range(j):
            lr, li = l_re[:, j, q, None], l_im[:, j, q, None]
            re = re - (a_re[:, :, q] * lr + a_im[:, :, q] * li)
            im = im - (a_im[:, :, q] * lr - a_re[:, :, q] * li)
        a_re[:, :, j] = re * dinv[:, j, None]
        a_im[:, :, j] = im * dinv[:, j, None]


def _back_substitute_planes(v_re, v_im, l_re, l_im, dinv):
    """V <- L^{-H} V, every column at once, rows from the last up."""
    m = v_re.shape[-1]
    for i in range(m - 1, -1, -1):
        re, im = v_re[:, i, :], v_im[:, i, :]
        for q in range(i + 1, m):
            lr, li = l_re[:, q, i, None], l_im[:, q, i, None]
            re = re - (lr * v_re[:, q, :] + li * v_im[:, q, :])
            im = im - (lr * v_im[:, q, :] - li * v_re[:, q, :])
        v_re[:, i, :] = re * dinv[:, i, None]
        v_im[:, i, :] = im * dinv[:, i, None]


def _eigh_planes(a: torch.Tensor, b: torch.Tensor | None, sweeps: int,
                 eps_rel: float):
    """The EVD kernel's arithmetic on (n, M, M) inputs: (diag of the
    diagonalized A (n, M), V planes, sweeps each matrix took)."""
    m = a.shape[-1]
    flat = a.reshape(-1, m, m)
    a_re, a_im = _hermitianize_planes(flat.real.to(torch.float32),
                                      flat.imag.to(torch.float32))
    if b is not None:
        fb = b.reshape(-1, m, m)
        chol = _loaded_cholesky_planes(fb.real.to(torch.float32),
                                       fb.imag.to(torch.float32), eps_rel)
        _whiten_planes(a_re, a_im, *chol)
        a_re, a_im = _hermitianize_planes(a_re, a_im)
    v_re, v_im, taken = _eigh_sweeps(a_re, a_im, sweeps)
    if b is not None:
        _back_substitute_planes(v_re, v_im, *chol)
    return torch.diagonal(a_re, dim1=-2, dim2=-1), v_re, v_im, taken


def hermitian_eigh_plain(a: torch.Tensor, b: torch.Tensor | None = None,
                         sweeps: int = EIGH_SWEEPS, eps_rel: float = 1e-6):
    """Plain version of the EVD kernel: (w (..., M) f32 ascending,
    V (..., M, M) in a's complex type)."""
    lead, m = a.shape[:-2], a.shape[-1]
    w, v_re, v_im, _ = _eigh_planes(a, b, sweeps, eps_rel)
    # ascending, NaN last, ties in index order: the kernel's ranks
    order = torch.argsort(torch.where(torch.isnan(w), float("inf"), w),
                          dim=-1, stable=True)
    cols = order[:, None, :].expand(-1, m, -1)
    v = torch.complex(torch.gather(v_re, -1, cols),
                      torch.gather(v_im, -1, cols))
    return (torch.gather(w, -1, order).reshape(*lead, m),
            v.reshape(*lead, m, m).to(a.dtype))


def eigh_sweeps_needed(a: torch.Tensor, b: torch.Tensor | None = None,
                       sweeps: int = EIGH_SWEEPS, eps_rel: float = 1e-6):
    """The sweeps the EVD takes on each matrix of ``a`` (and ``b``), (...)
    int64, at most ``sweeps``: what its operation count (the bound of a
    loop that ends early) is taken from."""
    return _eigh_planes(a, b, sweeps, eps_rel)[3].reshape(a.shape[:-2])


def hermitian_eigh(a: torch.Tensor, b: torch.Tensor | None = None,
                   sweeps: int = EIGH_SWEEPS, eps_rel: float = 1e-6,
                   form: str | None = None):
    """The EVD kernel: (w (..., M) f32 ascending, V (..., M, M) complex64).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``hermitian_eigh.launches`` counts those launches), any batch in one
    launch, in the form the launcher picks by the matrix count and M
    (``form`` None), or a thread a matrix ("thread") or a lane group a
    matrix ("lanes") where ``eigh_forms`` offers it.
    """
    if form not in _FORMS:
        raise ValueError(f"hermitian_eigh: form {form!r} is not one of "
                         f"{sorted(_FORMS, key=str)}")
    if a.device.type == "cpu":
        return hermitian_eigh_plain(a, b, sweeps, eps_rel)
    m = a.shape[-1]
    if form is not None and form not in eigh_forms(m):
        raise ValueError(f"hermitian_eigh: no {form!r} form at M = {m}")
    for x in (a,) if b is None else (a, b):
        if x.dtype != torch.complex64 or x.ndim < 2 or \
                x.shape[-2] != m or x.shape != a.shape or \
                x.device != a.device or x.numel() == 0:
            raise ValueError(f"hermitian_eigh: a (and b) must be non-empty "
                             f"complex64 (..., M, M) tensors of one shape "
                             f"on one CUDA device, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if m > MAX_DIM:
        raise ValueError(f"hermitian_eigh: M = {m} > {MAX_DIM}")
    if sweeps < 0:
        raise ValueError(f"hermitian_eigh: sweeps = {sweeps} < 0")
    src = a.contiguous()
    bsrc = None if b is None else b.contiguous()
    w = torch.empty(a.shape[:-1], dtype=torch.float32, device=a.device)
    v = torch.empty_like(src)
    _build.launch("eigh_small", "hermitian_eigh_form_launch", a.device,
                  src.data_ptr(), None if bsrc is None else bsrc.data_ptr(),
                  w.data_ptr(), v.data_ptr(), src.numel() // (m * m), m,
                  sweeps, eps_rel, _FORMS[form])
    hermitian_eigh.launches += 1
    return w, v


# the M at which each form of the EVD kernel is built: those at which its
# launcher's pick (eigh_small.cu kLanesUpTo) can take it
_BUILT = {"thread": (1, 2, 3, 5, 6, 7), "lanes": (4, 5, 6, 7, 8)}


def eigh_forms(m: int) -> tuple:
    """The forms the EVD kernel is built in at M: a thread a matrix at M
    <= 3 and 5-7, a lane group a matrix at M >= 4."""
    return tuple(form for form, ms in _BUILT.items() if m in ms)


def eigh_form(n: int, m: int) -> str:
    """The form the EVD kernel's launcher takes for n matrices of M x M
    (builds the kernel library)."""
    pick = _build.library("eigh_small").hermitian_eigh_pick(n, m)
    return "lanes" if pick else "thread"


hermitian_eigh.launches = 0
