"""Loaded Hermitian Cholesky solves of medium systems (kernels 16, 17).

Counterpart of ``setk_tpu/ops/pallas/cholesky.py``; kernel source
``setk_tpu_torch/csrc/cholesky.cu`` over ``csrc/cholesky.cuh``, the body
both kernels share:

  hermitian_solve_lanes (kernel 16; ``_solve_lanes`` :384 via
      ``hermitian_solve_lanes_pallas`` :413): a (..., n, n) and b (..., n, k)
      complex64 -> x (..., n, k), a hermitianized unless
      ``assume_hermitian``, loaded by (eps_rel / n) tr(a) + EPSILON;
  solve_wpe_gram (kernel 17; ``solve_wpe_gram_pallas`` :304): the WPE
      normal equations read out of a (bins, g, g) complex64 Gram, corr =
      gram[row0:row0+n, row0:row0+n] against cross = gram[row0:row0+n, :k],
      optionally Jacobi-equilibrated (load eps_rel, the WPD path).

The ``*_plain`` functions are the plain PyTorch versions: the same
right-looking column loop, vectorised over the systems.  n <= 128 on the
card.
"""

import torch

from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.utils.common import EPSILON

__all__ = ["MAX_DIM", "hermitian_solve_lanes", "hermitian_solve_lanes_plain",
           "solve_wpe_gram", "solve_wpe_gram_plain"]

MAX_DIM = 128
_TINY = 1e-30


def _chol_solve_plain(low: torch.Tensor, b: torch.Tensor,
                      load: torch.Tensor) -> torch.Tensor:
    """Solve (A + load I) x = b through the Cholesky of A's lower triangle:
    low (bins, n, n), b (bins, n, k) complex, load (bins,) real.  The loop
    orders of cholesky.cuh: right-looking factorization and forward
    substitution, back substitution with q descending."""
    low, y = low.clone(), b.clone()
    n = low.shape[-1]
    dinv = []
    for j in range(n):
        inv = 1.0 / torch.sqrt(torch.clamp(low[:, j, j].real + load,
                                           min=EPSILON))
        col = low[:, j + 1:, j] * inv[:, None]
        low[:, j + 1:, j] = col
        low[:, j + 1:, j + 1:] -= col[:, :, None] * col.conj()[:, None, :]
        dinv.append(inv[:, None])
    z = torch.empty_like(y)
    for q in range(n):
        yq = y[:, q] * dinv[q]
        y[:, q + 1:] -= low[:, q + 1:, q, None] * yq[:, None]
        z[:, q] = yq
    for q in reversed(range(n)):
        xq = z[:, q] * dinv[q]
        z[:, :q] -= low[:, q, :q, None].conj() * xq[:, None]
        y[:, q] = xq
    return y


def hermitian_solve_lanes_plain(a: torch.Tensor, b: torch.Tensor,
                                eps_rel: float = 1e-6,
                                assume_hermitian: bool = False):
    """Plain version of kernel 16."""
    *lead, n, _ = a.shape
    k = b.shape[-1]
    a = a.reshape(-1, n, n)
    if not assume_hermitian:
        a = 0.5 * (a + a.conj().transpose(-1, -2))
    tr = torch.diagonal(a, dim1=-2, dim2=-1).real.sum(-1)
    x = _chol_solve_plain(a, b.reshape(-1, n, k), (eps_rel / n) * tr +
                          EPSILON)
    return x.reshape(*lead, n, k)


def solve_wpe_gram_plain(gram: torch.Tensor, row0: int, n: int, k: int,
                         eps_rel: float = 1e-6, equilibrate: bool = False):
    """Plain version of kernel 17: x (bins, n, k)."""
    corr = gram[:, row0:row0 + n, row0:row0 + n]
    cross = gram[:, row0:row0 + n, :k]
    if equilibrate:
        dj = torch.diagonal(corr, dim1=-2, dim2=-1).real
        sc = torch.where(dj > _TINY,
                         1.0 / torch.sqrt(torch.clamp(dj, min=_TINY)),
                         torch.ones_like(dj))
        corr = corr * (sc[:, :, None] * sc[:, None, :])
        cross = cross * sc[:, :, None]
        load = torch.full_like(dj[:, 0], eps_rel)
    else:
        tr = torch.diagonal(corr, dim1=-2, dim2=-1).real.sum(-1)
        load = (eps_rel / n) * tr + EPSILON
    x = _chol_solve_plain(corr, cross, load)
    return x * sc[:, :, None] if equilibrate else x


def _check(what: str, tensors, shapes):
    ref = tensors[0]
    for t, shape in zip(tensors, shapes):
        if t.device != ref.device or t.dtype != torch.complex64 or \
                tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{what}: needs a contiguous complex64 "
                             f"{tuple(shape)} tensor on {ref.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def hermitian_solve_lanes(a: torch.Tensor, b: torch.Tensor,
                          eps_rel: float = 1e-6,
                          assume_hermitian: bool = False) -> torch.Tensor:
    """Kernel 16: x (..., n, k) complex64 solving the loaded a x = b.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``hermitian_solve_lanes.launches`` counts those launches).  a and b
    must be contiguous complex64 on one device, 1 <= n <= 128.
    """
    if a.device.type == "cpu":
        return hermitian_solve_lanes_plain(a, b, eps_rel, assume_hermitian)
    if a.ndim < 2 or a.shape[-1] != a.shape[-2] or a.numel() == 0 or \
            not 1 <= a.shape[-1] <= MAX_DIM or b.ndim != a.ndim or \
            b.shape[-1] < 1:
        raise ValueError(f"hermitian_solve_lanes: needs a (..., n, n) with "
                         f"1 <= n <= {MAX_DIM} and b (..., n, k), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    n, k = a.shape[-1], b.shape[-1]
    _check("hermitian_solve_lanes", (a, b),
           (a.shape, (*a.shape[:-1], k)))
    x = torch.empty_like(b)
    _build.launch("cholesky", "hermitian_solve_launch", a.device,
                  a.data_ptr(), b.data_ptr(), x.data_ptr(),
                  a.numel() // (n * n), n, k, eps_rel,
                  int(not assume_hermitian))
    hermitian_solve_lanes.launches += 1
    return x


def solve_wpe_gram(gram: torch.Tensor, row0: int, n: int, k: int,
                   eps_rel: float = 1e-6,
                   equilibrate: bool = False) -> torch.Tensor:
    """Kernel 17: x (bins, n, k) complex64 from a (bins, g, g) Gram.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``solve_wpe_gram.launches`` counts those launches).
    """
    if gram.device.type == "cpu":
        return solve_wpe_gram_plain(gram, row0, n, k, eps_rel, equilibrate)
    g = gram.shape[-1]
    if gram.ndim != 3 or gram.shape[1] != g or gram.shape[0] < 1 or \
            not 1 <= n <= MAX_DIM or row0 < 0 or row0 + n > g or \
            not 1 <= k <= g:
        raise ValueError(f"solve_wpe_gram: needs a (bins, g, g) Gram with "
                         f"row0 + n <= g, n <= {MAX_DIM} and k <= g, got "
                         f"{tuple(gram.shape)}, row0={row0}, n={n}, k={k}")
    _check("solve_wpe_gram", (gram,), (gram.shape,))
    x = torch.empty((gram.shape[0], n, k), dtype=torch.complex64,
                    device=gram.device)
    _build.launch("cholesky", "gram_solve_launch", gram.device,
                  gram.data_ptr(), x.data_ptr(), gram.shape[0], g, row0, n,
                  k, eps_rel, int(equilibrate))
    solve_wpe_gram.launches += 1
    return x


hermitian_solve_lanes.launches = 0
solve_wpe_gram.launches = 0
