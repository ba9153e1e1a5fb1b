"""Batched Hermitian linear algebra for per-frequency-bin solves.

Counterpart of the parts of ``setk_tpu/ops/linalg.py`` that the
supervised beamformers need: hermitianize, scale-invariant diagonal
loading, the loaded Cholesky solve, its equilibrated form, power
iteration, the principal eigenvector and the generalized EVD by Cholesky
whitening, and the clustering EM's eigenvalue-floored
``regularized_inverse``.  Every op is batched over leading axes.

``eigh`` and ``generalized_eigh`` on a CUDA tensor with M <= 8 run the
batched EVD kernel (ops/cuda/eigh_small.hermitian_eigh: one launch for
any batch, the generalized form whitening inside the kernel), where the
JAX package runs XLA's eigh; M > 8 there raises (ROADMAP queue 1 item 15).
On the CPU they are ``torch.linalg``, as the JAX package's LAPACK there.
``hermitian_solve`` on a CUDA tensor with 16 <= N <= 128 runs the medium
Cholesky kernel (ops/cuda/cholesky.py, kernel 16), as the JAX package runs
its lane-batched Pallas Cholesky there on the TPU.
``regularized_inverse`` on a CUDA tensor with M <= 8 runs the Jacobi
kernel (ops/cuda/eigh_small.py, kernel 14), as the JAX package runs its
Pallas Jacobi on the TPU; the CPU takes the eigh-based plain path.
"""

import torch

from setk_tpu_torch.ops.cuda.cholesky import MAX_DIM as MAX_SOLVE_DIM
from setk_tpu_torch.ops.cuda.cholesky import hermitian_solve_lanes
from setk_tpu_torch.ops.cuda.eigh_small import MAX_DIM, hermitian_eigh
from setk_tpu_torch.ops.cuda.eigh_small import \
    regularized_inverse as jacobi_inverse
from setk_tpu_torch.utils.common import EPSILON

# the smallest system kernel 16 takes on the card (the TPU's Pallas floor)
KERNEL_MIN_DIM = 16

__all__ = [
    "hermitianize", "eigh", "principal_eigvec", "solve_pevd",
    "generalized_eigh", "hermitian_solve", "equilibrated_hermitian_solve",
    "power_iteration", "regularized_inverse"
]


def _eigh_kernel(a: torch.Tensor, b: torch.Tensor | None, eps_rel: float):
    """The EVD kernel on (..., M, M) ``a`` (and ``b``), M <= 8."""
    m = a.shape[-1]
    if m > MAX_DIM:
        raise NotImplementedError(
            f"a Hermitian EVD of M = {m} > {MAX_DIM} on a CUDA device "
            f"arrives with ROADMAP queue 1 item 15")
    w, v = hermitian_eigh(
        a.to(torch.complex64),
        None if b is None else b.to(torch.complex64), eps_rel=eps_rel)
    return w, v.to(a.dtype)


def eigh(mat: torch.Tensor):
    """Batched Hermitian EVD: (w ascending, V in columns).  On a CUDA
    tensor the EVD kernel (of herm(mat)), else ``torch.linalg.eigh``."""
    if _on_card(mat):
        return _eigh_kernel(mat, None, 0.0)
    return torch.linalg.eigh(mat)


def hermitianize(mat: torch.Tensor) -> torch.Tensor:
    """(R + R^H) / 2 over the trailing two axes."""
    return 0.5 * (mat + mat.conj().transpose(-1, -2))


def _diag_load(mat: torch.Tensor, eps_rel: float) -> torch.Tensor:
    """Add eps_rel * mean(diag) * I + EPSILON * I (scale-invariant loading)."""
    n = mat.shape[-1]
    tr = torch.diagonal(mat, dim1=-2, dim2=-1).real.sum(-1) / n
    eye = torch.eye(n, dtype=mat.dtype, device=mat.device)
    return mat + (eps_rel * tr + EPSILON)[..., None, None] * eye


def _on_card(a: torch.Tensor) -> bool:
    return a.device.type == "cuda"


def hermitian_solve(a: torch.Tensor, b: torch.Tensor,
                    eps_rel: float = 1e-6,
                    assume_hermitian: bool = False) -> torch.Tensor:
    """Solve a x = b for Hermitian (PSD) ``a`` via Cholesky + loading.

    b: (..., N) vector or (..., N, K) matrix right-hand side.  For
    16 <= N <= 128 on a CUDA tensor the solve is kernel 16
    (ops/cuda/cholesky.hermitian_solve_lanes), as the JAX package runs its
    lane-batched Pallas Cholesky on the TPU; elsewhere ``torch.linalg``.
    """
    vec = b.ndim == a.ndim - 1
    rhs = b[..., None] if vec else b
    n = a.shape[-1]
    if _on_card(a) and KERNEL_MIN_DIM <= n <= MAX_SOLVE_DIM:
        x = hermitian_solve_lanes(a.to(torch.complex64).contiguous(),
                                  rhs.to(torch.complex64).contiguous(),
                                  eps_rel, assume_hermitian).to(a.dtype)
        return x[..., 0] if vec else x
    loaded = _diag_load(a if assume_hermitian else hermitianize(a), eps_rel)
    # a system that is not positive definite after loading solves to NaN
    # (as jnp.linalg.cholesky gives it; callers skip non-finite output)
    chol, info = torch.linalg.cholesky_ex(loaded)
    chol = torch.where((info == 0)[..., None, None], chol,
                       torch.full_like(chol, float("nan")))
    y = torch.linalg.solve_triangular(chol, rhs, upper=False)
    x = torch.linalg.solve_triangular(chol.conj().transpose(-1, -2), y,
                                      upper=True)
    return x[..., 0] if vec else x


def equilibrated_hermitian_solve(a: torch.Tensor, b: torch.Tensor,
                                 eps_rel: float = 1e-6) -> torch.Tensor:
    """``hermitian_solve`` after symmetric Jacobi equilibration.

    A -> D A D with D = diag(A)^{-1/2} restores a unit diagonal so the
    relative loading acts per row; the solution is unscaled afterwards
    (exact math).  All-zero rows keep scale 1.  The loading floor
    self-scales with the system size: eps_rel >= 4 * N * f32_eps.
    """
    vec = b.ndim == a.ndim - 1
    rhs = b[..., None] if vec else b
    eps_rel = max(eps_rel, 4.0 * a.shape[-1] * EPSILON)
    diag = torch.diagonal(a, dim1=-2, dim2=-1).abs()
    d = torch.where(diag > 0, torch.rsqrt(torch.clamp(diag, min=1e-30)),
                    torch.ones_like(diag)).to(a.dtype)
    a2 = a * d[..., :, None] * d[..., None, :]
    x2 = hermitian_solve(a2, rhs * d[..., :, None], eps_rel=eps_rel)
    x = x2 * d[..., :, None]
    return x[..., 0] if vec else x


def principal_eigvec(mat: torch.Tensor) -> torch.Tensor:
    """Eigenvector of the largest eigenvalue, unit L2 norm, per matrix."""
    _, vecs = eigh(mat)
    return vecs[..., :, -1]


def generalized_eigh(a: torch.Tensor, b: torch.Tensor,
                     eps_rel: float = 1e-6):
    """Generalized Hermitian EVD ``a v = w b v`` by Cholesky whitening of
    the loaded, hermitianized ``b``: eigenvalues ascending, eigenvectors
    normalized so that ``v^H b v = I`` (scipy.linalg.eigh's convention,
    up to per-vector phase).  On a CUDA tensor one launch of the EVD
    kernel does the loading, the whitening, the EVD and the back
    substitution."""
    if _on_card(a):
        return _eigh_kernel(a, b, eps_rel)
    chol = torch.linalg.cholesky(_diag_load(hermitianize(b), eps_rel))
    # C = L^{-1} a L^{-H}: with X = L^{-1} a (a Hermitian), C = L^{-1} X^H
    li_a = torch.linalg.solve_triangular(chol, hermitianize(a), upper=False)
    c = torch.linalg.solve_triangular(chol, li_a.conj().transpose(-1, -2),
                                      upper=False)
    w, u = eigh(hermitianize(c))
    v = torch.linalg.solve_triangular(chol.conj().transpose(-1, -2), u,
                                      upper=True)
    return w, v


def solve_pevd(rs: torch.Tensor, rn=None, eps_rel: float = 1e-6):
    """Principal eigenvector of hermitianized ``rs``, or with ``rn`` the
    principal generalized eigenvector of (rs, rn)."""
    if rn is None:
        return principal_eigvec(hermitianize(rs))
    _, v = generalized_eigh(rs, rn, eps_rel=eps_rel)
    return v[..., :, -1]


def regularized_inverse(covar: torch.Tensor, return_logdet: bool = False):
    """Eigenvalue-floored inverse of batched Hermitian matrices.

    The reference's regularization: eigenvalues scaled by their maximum,
    floored at EPSILON and inverted, with the logdet of the scaled
    spectrum.  On the CPU one batched ``torch.linalg.eigh``; on a CUDA
    tensor with M <= 8 the Jacobi kernel (kernel 14, the EVD's round-robin
    sweeps with the TPU kernel's floored inverse); M > 8 on the card raises
    (ROADMAP queue 1 item 15).
    """
    m = covar.shape[-1]
    if _on_card(covar):
        if m > MAX_DIM:
            raise NotImplementedError(
                f"a regularized inverse of M = {m} > {MAX_DIM} on a CUDA "
                f"device arrives with ROADMAP queue 1 item 15")
        inv, logdet = jacobi_inverse(covar.to(torch.complex64))
        return (inv, logdet) if return_logdet else inv
    w, v = torch.linalg.eigh(hermitianize(covar))
    w = w / torch.clamp(w.max(-1, keepdim=True).values, min=EPSILON)
    w = torch.clamp(w, min=EPSILON)
    inv = torch.einsum("...xy,...y,...zy->...xz", v, (1.0 / w).to(v.dtype),
                       v.conj())
    if return_logdet:
        return inv, torch.log(w).sum(-1)
    return inv


def power_iteration(mat: torch.Tensor,
                    num_iters: int = 20,
                    init: torch.Tensor | None = None) -> torch.Tensor:
    """Principal eigenvector by fixed-iteration power method.

    The default start is a ramp (k+1)/n, which de-symmetrizes the start
    so it is not orthogonal to the principal vector.
    """
    n = mat.shape[-1]
    if init is None:
        ramp = torch.arange(1, n + 1, dtype=torch.float32,
                            device=mat.device) / n
        v = ramp.to(mat.dtype).expand(mat.shape[:-1]).clone()
    else:
        v = init
    for _ in range(num_iters):
        v = (mat * v[..., None, :]).sum(-1)
        v = v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            min=EPSILON)
    return v
