"""Per-bin MVDR weight solve: CUDA kernel wrapper and its plain version.

Counterpart of ``setk_tpu/ops/pallas/mvdr.py: mvdr_power_pallas``
(kernel source: ``setk_tpu_torch/csrc/mvdr_power.cu``).  Both versions
compute, per bin: power-iteration steer vector of hermitianized Rs
(ramp start), mic-0 phase anchor, Jacobi-equilibrated loaded Cholesky
solve on hermitianized Rn and the Capon normalization, with the floors
of ``mvdr_weights_tiles`` (mvdr.py:208-255).  These floors differ
slightly from ``enhance.beamformer._capon``'s; the plain version copies
the kernel's.
"""

import torch

from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.ops.linalg import hermitianize
from setk_tpu_torch.utils.common import EPSILON

__all__ = ["mvdr_power", "mvdr_power_plain"]

MAX_MICS = 8


def mvdr_power_plain(rs: torch.Tensor, rn: torch.Tensor,
                     power_iters: int = 15,
                     eps_rel: float = 1e-6) -> torch.Tensor:
    """(..., N, N) complex64 Rs, Rn -> (..., N) complex64 MVDR weights."""
    n = rs.shape[-1]
    s = hermitianize(rs)
    ramp = torch.arange(1, n + 1, dtype=torch.float32, device=rs.device) / n
    v = ramp.to(rs.dtype).expand(rs.shape[:-1])
    for _ in range(power_iters):
        u = (s * v[..., None, :]).sum(-1)
        nrm2 = (u.real**2 + u.imag**2).sum(-1, keepdim=True)
        v = u * torch.rsqrt(torch.clamp(nrm2, min=EPSILON * EPSILON))
    ref = v[..., :1]
    phase = ref.conj() / torch.clamp(ref.abs(), min=EPSILON)
    d = v * phase

    a = hermitianize(rn)
    dii = torch.diagonal(a, dim1=-2, dim2=-1).real
    dsc = torch.where(dii > 0, torch.rsqrt(torch.clamp(dii, min=1e-30)),
                      torch.ones_like(dii))
    load = max(eps_rel, 4.0 * n * EPSILON)
    e = a * dsc[..., :, None] * dsc[..., None, :]
    e = e + load * torch.eye(n, dtype=e.dtype, device=e.device)
    # unrolled Cholesky with pivots rsqrt(max(d, EPS)); low[i][j], i > j
    low = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for j in range(n):
        dj = e[..., j, j].real
        for q in range(j):
            dj = dj - (low[j][q].real**2 + low[j][q].imag**2)
        inv_diag[j] = torch.rsqrt(torch.clamp(dj, min=EPSILON))
        for i in range(j + 1, n):
            acc = e[..., i, j]
            for q in range(j):
                acc = acc - low[i][q] * low[j][q].conj()
            low[i][j] = acc * inv_diag[j]
    b = d * dsc
    y = [None] * n
    for i in range(n):
        acc = b[..., i]
        for q in range(i):
            acc = acc - low[i][q] * y[q]
        y[i] = acc * inv_diag[i]
    x = [None] * n
    for i in reversed(range(n)):
        acc = y[i]
        for q in range(i + 1, n):
            acc = acc - low[q][i].conj() * x[q]
        x[i] = acc * inv_diag[i]
    x = torch.stack(x, dim=-1) * dsc
    den = (d.conj() * x).sum(-1, keepdim=True)
    inv_den = 1.0 / torch.clamp(den.real**2 + den.imag**2,
                                min=EPSILON * EPSILON)
    return x * den.conj() * inv_den


def mvdr_power(rs: torch.Tensor, rn: torch.Tensor,
               power_iters: int = 15,
               eps_rel: float = 1e-6) -> torch.Tensor:
    """MVDR weights from (..., N, N) complex64 covariances, N <= 8.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``mvdr_power.launches`` counts those launches).
    """
    if rs.device.type == "cpu":
        return mvdr_power_plain(rs, rn, power_iters, eps_rel)
    n = rs.shape[-1]
    if rs.device.type != "cuda":
        raise ValueError(f"mvdr_power: unsupported device {rs.device}")
    for name, t in (("rs", rs), ("rn", rn)):
        if t.device != rs.device or t.dtype != torch.complex64 or \
                t.shape != rs.shape or not t.is_contiguous():
            raise ValueError(f"mvdr_power: {name} must be a contiguous "
                             f"complex64 {tuple(rs.shape)} tensor on "
                             f"{rs.device}")
    if rs.ndim < 2 or rs.shape[-2] != n or not 1 <= n <= MAX_MICS:
        raise ValueError(f"mvdr_power: needs (..., N, N) with N <= "
                         f"{MAX_MICS}, got {tuple(rs.shape)}")
    nbins = rs.numel() // (n * n)
    w = torch.empty((*rs.shape[:-1],), dtype=torch.complex64,
                    device=rs.device)
    lib = _build.library("mvdr_power")
    with torch.cuda.device(rs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mvdr_power_launch(rs.data_ptr(), rn.data_ptr(),
                                    w.data_ptr(), nbins, n, power_iters,
                                    eps_rel, stream)
    _build.check(err, "mvdr_power_launch")
    mvdr_power.launches += 1
    return w


mvdr_power.launches = 0
