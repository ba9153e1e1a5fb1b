"""Eigenvalue-floored inverse of small Hermitian matrices by cyclic
complex Jacobi (kernel 14), and the batched Hermitian EVD on the same
sweeps.

Counterpart of ``setk_tpu/ops/pallas/eigh_small.py``: ``_jacobi_flat``
(:183) via ``regularized_inverse_pallas`` (:207); kernel source
``setk_tpu_torch/csrc/eigh_small.cu`` over ``csrc/jacobi.cuh``, the
Jacobi that kernel 15 shares:

  regularized_inverse: a (..., M, M) complex64 -> (inv (..., M, M)
      complex64, logdet (...) f32): eigenvalues scaled by their maximum,
      floored at EPSILON and inverted, the logdet of the scaled spectrum.

``jacobi_regularized_inverse_plain`` is the plain PyTorch version: the
same cyclic sweeps and statements as ``jacobi_regularized_inverse``
(eigh_small.py:40-167), vectorised over the matrices.  M <= 8 on the card.

  hermitian_eigh: a (..., M, M) [, b (..., M, M)] complex64 -> (w (..., M)
      f32 ascending, V (..., M, M) complex64 in columns): the EVD of
      herm(a), or with b the generalized EVD of (herm(a), herm(b)) by
      Cholesky whitening of the loaded b (v^H B v = I), the statements of
      setk_tpu/ops/linalg.py:178-199.  No TPU kernel: the JAX package runs
      XLA's eigh there.  Kernel source csrc/eigh_small.cu
      ``hermitian_eigh_kernel``; ``hermitian_eigh_plain`` is its plain
      version, the same sweeps (with an annihilated entry left alone), the
      same Cholesky, substitutions and order of columns.
"""

import torch

from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.utils.common import EPSILON

__all__ = ["MAX_DIM", "SWEEPS", "EIGH_SWEEPS", "regularized_inverse",
           "jacobi_regularized_inverse_plain", "hermitian_eigh",
           "hermitian_eigh_plain"]

MAX_DIM = 8
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


def _jacobi_sweeps(a_re: torch.Tensor, a_im: torch.Tensor, sweeps: int,
                   skip_annihilated: bool):
    """jacobi.cuh's jacobi_sweeps: diagonalizes the Hermitian planes in
    place and returns V = (v_re, v_im).  ``skip_annihilated`` gives an
    entry of |a_pq|^2 <= 1e-30 the identity rotation (the EVD's form)."""
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
                if skip_annihilated:
                    t = torch.where(safe, t, 0.0 * one)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = t * c
                gqp_re, gqp_im = (-ph_re * s)[:, None], (ph_im * s)[:, None]
                gqq_re, gqq_im = (ph_re * c)[:, None], (-ph_im * c)[:, None]
                gpq_re, c = s[:, None], c[:, None]
                # columns: A <- A G on columns p, q
                akp_re, akp_im = a_re[:, :, p].clone(), a_im[:, :, p].clone()
                akq_re, akq_im = a_re[:, :, q].clone(), a_im[:, :, q].clone()
                a_re[:, :, p] = akp_re * c + akq_re * gqp_re - akq_im * gqp_im
                a_im[:, :, p] = akp_im * c + akq_re * gqp_im + akq_im * gqp_re
                a_re[:, :, q] = (akp_re * gpq_re + akq_re * gqq_re -
                                 akq_im * gqq_im)
                a_im[:, :, q] = (akp_im * gpq_re + akq_re * gqq_im +
                                 akq_im * gqq_re)
                # rows: A <- G^H A on rows p, q
                apk_re, apk_im = a_re[:, p, :].clone(), a_im[:, p, :].clone()
                aqk_re, aqk_im = a_re[:, q, :].clone(), a_im[:, q, :].clone()
                a_re[:, p, :] = apk_re * c + aqk_re * gqp_re + aqk_im * gqp_im
                a_im[:, p, :] = apk_im * c + aqk_im * gqp_re - aqk_re * gqp_im
                a_re[:, q, :] = (apk_re * gpq_re + aqk_re * gqq_re +
                                 aqk_im * gqq_im)
                a_im[:, q, :] = (apk_im * gpq_re + aqk_im * gqq_re -
                                 aqk_re * gqq_im)
                # V <- V G
                vkp_re, vkp_im = v_re[:, :, p].clone(), v_im[:, :, p].clone()
                vkq_re, vkq_im = v_re[:, :, q].clone(), v_im[:, :, q].clone()
                v_re[:, :, p] = vkp_re * c + vkq_re * gqp_re - vkq_im * gqp_im
                v_im[:, :, p] = vkp_im * c + vkq_re * gqp_im + vkq_im * gqp_re
                v_re[:, :, q] = (vkp_re * gpq_re + vkq_re * gqq_re -
                                 vkq_im * gqq_im)
                v_im[:, :, q] = (vkp_im * gpq_re + vkq_re * gqq_im +
                                 vkq_im * gqq_re)
    return v_re, v_im


def _jacobi_planes(a_re: torch.Tensor, a_im: torch.Tensor, sweeps: int):
    """The Jacobi of eigh_small.py:40-167 on (n, M, M) f32 planes; returns
    (inv_re, inv_im, logdet)."""
    m = a_re.shape[-1]
    a_re, a_im = _hermitianize_planes(a_re, a_im)
    v_re, v_im = _jacobi_sweeps(a_re, a_im, sweeps, skip_annihilated=False)
    # w /= max(max(w), EPS); w = max(w, EPS); inv = V diag(1/w) V^H
    w = torch.diagonal(a_re, dim1=-2, dim2=-1)
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
    inv_re = torch.empty_like(a_re)
    inv_im = torch.empty_like(a_im)
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


def jacobi_regularized_inverse_plain(covar: torch.Tensor,
                                     sweeps: int = SWEEPS):
    """Plain version of kernel 14: (inv, logdet) of (..., M, M) complex."""
    lead, m = covar.shape[:-2], covar.shape[-1]
    flat = covar.reshape(-1, m, m)
    inv_re, inv_im, logdet = _jacobi_planes(
        flat.real.to(torch.float32), flat.imag.to(torch.float32), sweeps)
    inv = torch.complex(inv_re, inv_im).reshape(*lead, m, m)
    return inv.to(covar.dtype), logdet.reshape(lead)


def regularized_inverse(covar: torch.Tensor, sweeps: int = SWEEPS):
    """Kernel 14: (inv (..., M, M) complex64, logdet (...) f32).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``regularized_inverse.launches`` counts those launches).
    """
    if covar.device.type == "cpu":
        return jacobi_regularized_inverse_plain(covar, sweeps)
    m = covar.shape[-1]
    if covar.dtype != torch.complex64 or covar.ndim < 2 or \
            covar.shape[-2] != m or covar.numel() == 0:
        raise ValueError(f"regularized_inverse: covar must be a non-empty "
                         f"complex64 (..., M, M) CUDA tensor, got "
                         f"{covar.dtype} {tuple(covar.shape)}")
    if m > MAX_DIM:
        raise ValueError(f"regularized_inverse: M = {m} > {MAX_DIM}")
    lead = covar.shape[:-2]
    src = covar.contiguous()
    inv = torch.empty_like(src)
    logdet = torch.empty(lead, dtype=torch.float32, device=covar.device)
    _build.launch("eigh_small", "regularized_inverse_launch", covar.device,
                  src.data_ptr(), inv.data_ptr(), logdet.data_ptr(),
                  src.numel() // (m * m), m, sweeps)
    regularized_inverse.launches += 1
    return inv, logdet


regularized_inverse.launches = 0


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


def hermitian_eigh_plain(a: torch.Tensor, b: torch.Tensor | None = None,
                         sweeps: int = EIGH_SWEEPS, eps_rel: float = 1e-6):
    """Plain version of the EVD kernel: (w (..., M) f32 ascending,
    V (..., M, M) in a's complex type)."""
    lead, m = a.shape[:-2], a.shape[-1]
    flat = a.reshape(-1, m, m)
    a_re, a_im = _hermitianize_planes(flat.real.to(torch.float32),
                                      flat.imag.to(torch.float32))
    if b is not None:
        fb = b.reshape(-1, m, m)
        chol = _loaded_cholesky_planes(fb.real.to(torch.float32),
                                       fb.imag.to(torch.float32), eps_rel)
        _whiten_planes(a_re, a_im, *chol)
        a_re, a_im = _hermitianize_planes(a_re, a_im)
    v_re, v_im = _jacobi_sweeps(a_re, a_im, sweeps, skip_annihilated=True)
    if b is not None:
        _back_substitute_planes(v_re, v_im, *chol)
    w = torch.diagonal(a_re, dim1=-2, dim2=-1)
    # ascending, NaN last, ties in index order: the kernel's ranks
    order = torch.argsort(torch.where(torch.isnan(w), float("inf"), w),
                          dim=-1, stable=True)
    cols = order[:, None, :].expand(-1, m, -1)
    v = torch.complex(torch.gather(v_re, -1, cols),
                      torch.gather(v_im, -1, cols))
    return (torch.gather(w, -1, order).reshape(*lead, m),
            v.reshape(*lead, m, m).to(a.dtype))


def hermitian_eigh(a: torch.Tensor, b: torch.Tensor | None = None,
                   sweeps: int = EIGH_SWEEPS, eps_rel: float = 1e-6):
    """The EVD kernel: (w (..., M) f32 ascending, V (..., M, M) complex64).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``hermitian_eigh.launches`` counts those launches), one thread a
    matrix, any batch in one launch.
    """
    if a.device.type == "cpu":
        return hermitian_eigh_plain(a, b, sweeps, eps_rel)
    m = a.shape[-1]
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
    _build.launch("eigh_small", "hermitian_eigh_launch", a.device,
                  src.data_ptr(), None if bsrc is None else bsrc.data_ptr(),
                  w.data_ptr(), v.data_ptr(), src.numel() // (m * m), m,
                  sweeps, eps_rel)
    hermitian_eigh.launches += 1
    return w, v


hermitian_eigh.launches = 0
