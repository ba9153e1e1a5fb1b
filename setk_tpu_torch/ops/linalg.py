"""Batched Hermitian linear algebra for per-frequency-bin solves.

Counterpart of the parts of ``setk_tpu/ops/linalg.py`` that the MVDR
main path needs: hermitianize, scale-invariant diagonal loading, the
loaded Cholesky solve, its equilibrated form, power iteration and the
plain principal eigenvector.  Every op is batched over leading axes.
The generalized EVD and the regularized inverse come with the other
beamformers and the clustering EM.
"""

import torch

from setk_tpu_torch.utils.common import EPSILON

__all__ = [
    "hermitianize", "eigh", "principal_eigvec", "solve_pevd",
    "hermitian_solve", "equilibrated_hermitian_solve", "power_iteration"
]


def eigh(mat: torch.Tensor):
    """Batched Hermitian EVD (eigenvalues ascending)."""
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


def hermitian_solve(a: torch.Tensor, b: torch.Tensor,
                    eps_rel: float = 1e-6,
                    assume_hermitian: bool = False) -> torch.Tensor:
    """Solve a x = b for Hermitian (PSD) ``a`` via Cholesky + loading.

    b: (..., N) vector or (..., N, K) matrix right-hand side.
    """
    vec = b.ndim == a.ndim - 1
    rhs = b[..., None] if vec else b
    loaded = _diag_load(a if assume_hermitian else hermitianize(a), eps_rel)
    chol = torch.linalg.cholesky(loaded)
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


def solve_pevd(rs: torch.Tensor, rn=None, eps_rel: float = 1e-6):
    """Principal eigenvector of hermitianized ``rs``.

    The generalized form (``rn`` given) arrives with the GEVD family.
    """
    if rn is not None:
        raise NotImplementedError(
            "generalized EVD arrives with ROADMAP queue 1 item 2")
    return principal_eigvec(hermitianize(rs))


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
