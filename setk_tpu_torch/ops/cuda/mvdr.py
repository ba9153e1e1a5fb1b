"""Per-bin weight solves: CUDA kernel wrappers and their plain versions.

Counterpart of ``setk_tpu/ops/pallas/mvdr.py`` (kernel source:
``setk_tpu_torch/csrc/mvdr_power.cu``), one function per Pallas kernel:

  mvdr_power  (mvdr_power_pallas :458, body _mvdr_kernel :258)
              power-iteration steer vector of hermitianized Rs (ramp
              start), mic-0 phase anchor, Capon solve against Rn;
  gevd_power  (gevd_power_pallas :474, body _gevd_kernel :271)
              power iteration on Rn^{-1} Rs, v^H Rn v = 1, mic-0 anchor;
  pmwf_solve  (pmwf_solve_pallas :493, body _pmwf_kernel :335)
              W = Rn^{-1} Rs / (beta + tr), optionally the per-channel
              powers ps_c = Re(w_c^H Rs w_c), pn_c = Re(w_c^H Rn w_c)
              with the raw (unloaded) hermitianized Rn;
  capon       (capon_pallas :523, body _capon_kernel :307)
              w = R^{-1} d / (d^H R^{-1} d) for a given steer d.

Every solve goes through the Jacobi-equilibrated, loaded Cholesky of
``_equilibrated_cholesky`` (mvdr.py:101-140): unit diagonal (scale 1
where the diagonal is <= 0), loading max(eps_rel, 4 N EPS), pivots
rsqrt(max(d, EPS)).  These floors differ slightly from
``enhance.beamformer._capon``'s; the plain versions copy the kernels'.
"""

import torch

from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.ops.linalg import hermitianize
from setk_tpu_torch.utils.common import EPSILON

__all__ = ["mvdr_power", "mvdr_power_plain", "gevd_power",
           "gevd_power_plain", "pmwf_solve", "pmwf_solve_plain", "capon",
           "capon_plain"]

MAX_MICS = 8


# ---------------------------------------------------------------------------
# plain versions: the kernels' arithmetic, unrolled over N in Python
# ---------------------------------------------------------------------------

def _equilibrated_cholesky(a: torch.Tensor, eps_rel: float):
    """Factor of D A D + load I for hermitianized (..., N, N) ``a``:
    (low, inv_diag, dsc), low[i][j] for i > j, as in the kernels."""
    n = a.shape[-1]
    dii = torch.diagonal(a, dim1=-2, dim2=-1).real
    dsc = torch.where(dii > 0, torch.rsqrt(torch.clamp(dii, min=1e-30)),
                      torch.ones_like(dii))
    load = max(eps_rel, 4.0 * n * EPSILON)
    e = a * dsc[..., :, None] * dsc[..., None, :]
    e = e + load * torch.eye(n, dtype=e.dtype, device=e.device)
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
    return low, inv_diag, dsc


def _equilibrated_solve(factor, b: torch.Tensor) -> torch.Tensor:
    """x = D solve(D A D, D b) for (..., N) ``b``, through the factor."""
    low, inv_diag, dsc = factor
    n = len(inv_diag)
    b = b * dsc
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
    return torch.stack(x, dim=-1) * dsc


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m * v[..., None, :]).sum(-1)


def _anchor_phase(v: torch.Tensor) -> torch.Tensor:
    """Rotate so channel 0 is real-positive (floor EPS)."""
    ref = v[..., :1]
    return v * (ref.conj() / torch.clamp(ref.abs(), min=EPSILON))


def _ramp(like: torch.Tensor) -> torch.Tensor:
    n = like.shape[-1]
    ramp = torch.arange(1, n + 1, dtype=torch.float32, device=like.device)
    return (ramp / n).to(like.dtype).expand(like.shape[:-1])


def _capon_normalize(d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """w = x / (d^H x) as x conj(den) / max(|den|^2, EPS^2)."""
    den = (d.conj() * x).sum(-1, keepdim=True)
    inv_den = 1.0 / torch.clamp(den.real**2 + den.imag**2,
                                min=EPSILON * EPSILON)
    return x * den.conj() * inv_den


def _unit(u: torch.Tensor) -> torch.Tensor:
    nrm2 = (u.real**2 + u.imag**2).sum(-1, keepdim=True)
    return u * torch.rsqrt(torch.clamp(nrm2, min=EPSILON * EPSILON))


def mvdr_power_plain(rs: torch.Tensor, rn: torch.Tensor,
                     power_iters: int = 15,
                     eps_rel: float = 1e-6) -> torch.Tensor:
    """(..., N, N) complex64 Rs, Rn -> (..., N) complex64 MVDR weights."""
    s = hermitianize(rs)
    v = _ramp(s)
    for _ in range(power_iters):
        v = _unit(_matvec(s, v))
    d = _anchor_phase(v)
    factor = _equilibrated_cholesky(hermitianize(rn), eps_rel)
    return _capon_normalize(d, _equilibrated_solve(factor, d))


def gevd_power_plain(rs: torch.Tensor, rn: torch.Tensor,
                     power_iters: int = 15,
                     eps_rel: float = 1e-6) -> torch.Tensor:
    """(..., N, N) Rs, Rn -> (..., N) principal generalized eigenvector
    by power iteration on Rn^{-1} Rs, v^H Rn v = 1, mic 0 real-positive."""
    s = hermitianize(rs)
    a = hermitianize(rn)
    factor = _equilibrated_cholesky(a, eps_rel)
    v = _ramp(s)
    for _ in range(power_iters):
        v = _unit(_equilibrated_solve(factor, _matvec(s, v)))
    av = _matvec(a, v)
    q = (v.real * av.real + v.imag * av.imag).sum(-1, keepdim=True)
    return _anchor_phase(v * torch.rsqrt(torch.clamp(q, min=EPSILON)))


def _powers(w: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Re(w_c^H M w_c) for every column c of (..., N, N) ``w``."""
    u = (m[..., :, :, None] * w[..., None, :, :]).sum(-2)    # M w
    return (w.real * u.real + w.imag * u.imag).sum(-2)


def pmwf_solve_plain(rs: torch.Tensor, rn: torch.Tensor,
                     beta: float = 0.0, eps_rel: float = 1e-6,
                     return_powers: bool = False):
    """(..., N, N) Rs, Rn -> W (..., N, N) complex64, and with
    ``return_powers`` also ps, pn (..., N) float32."""
    s = hermitianize(rs)
    a = hermitianize(rn)
    factor = _equilibrated_cholesky(a, eps_rel)
    n = s.shape[-1]
    x = torch.stack([_equilibrated_solve(factor, s[..., :, j])
                     for j in range(n)], dim=-1)
    tr = torch.diagonal(x, dim1=-2, dim2=-1).sum(-1) + beta
    inv_den = 1.0 / torch.clamp(tr.real**2 + tr.imag**2,
                                min=EPSILON * EPSILON)
    w = x * tr.conj()[..., None, None] * inv_den[..., None, None]
    if not return_powers:
        return w
    return w, _powers(w, s), _powers(w, a)


def capon_plain(steer: torch.Tensor, r: torch.Tensor,
                eps_rel: float = 1e-6) -> torch.Tensor:
    """(..., N) steer, (..., N, N) R -> (..., N) Capon weights."""
    factor = _equilibrated_cholesky(hermitianize(r), eps_rel)
    return _capon_normalize(steer, _equilibrated_solve(factor, steer))


# ---------------------------------------------------------------------------
# kernel wrappers: CPU tensors run the plain version, CUDA tensors launch
# ---------------------------------------------------------------------------

def _check(what: str, mats, vecs=()):
    """Validate (..., N, N) ``mats`` and (..., N) ``vecs`` for a launch;
    returns (device, nbins, n)."""
    ref = mats[0]
    n = ref.shape[-1]
    if ref.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {ref.device}")
    if ref.ndim < 2 or ref.shape[-2] != n or not 1 <= n <= MAX_MICS:
        raise ValueError(f"{what}: needs (..., N, N) with N <= {MAX_MICS}, "
                         f"got {tuple(ref.shape)}")
    for t, shape in [(m, ref.shape) for m in mats] + \
            [(v, ref.shape[:-1]) for v in vecs]:
        if t.device != ref.device or t.dtype != torch.complex64 or \
                t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{what}: every operand must be a contiguous "
                             f"complex64 {tuple(shape)} tensor on "
                             f"{ref.device}")
    return ref.device, ref.numel() // (n * n), n


def _launch(fn, device, *args) -> None:
    _build.launch("mvdr_power", fn, device, *args)


def mvdr_power(rs: torch.Tensor, rn: torch.Tensor,
               power_iters: int = 15,
               eps_rel: float = 1e-6) -> torch.Tensor:
    """MVDR weights from (..., N, N) complex64 covariances, N <= 8.

    A CPU tensor runs the plain version; a CUDA tensor launches the
    kernel (``mvdr_power.launches`` counts those launches).
    """
    if rs.device.type == "cpu":
        return mvdr_power_plain(rs, rn, power_iters, eps_rel)
    dev, nbins, n = _check("mvdr_power", (rs, rn))
    w = torch.empty(rs.shape[:-1], dtype=torch.complex64, device=dev)
    _launch("mvdr_power_launch", dev, rs.data_ptr(), rn.data_ptr(),
            w.data_ptr(), nbins, n, power_iters, eps_rel)
    mvdr_power.launches += 1
    return w


def gevd_power(rs: torch.Tensor, rn: torch.Tensor,
               power_iters: int = 15,
               eps_rel: float = 1e-6) -> torch.Tensor:
    """Principal generalized eigenvectors of (..., N, N) complex64
    (Rs, Rn), N <= 8.  CPU: plain version; CUDA: the kernel (counted in
    ``gevd_power.launches``)."""
    if rs.device.type == "cpu":
        return gevd_power_plain(rs, rn, power_iters, eps_rel)
    dev, nbins, n = _check("gevd_power", (rs, rn))
    v = torch.empty(rs.shape[:-1], dtype=torch.complex64, device=dev)
    if nbins:
        _launch("gevd_power_launch", dev, rs.data_ptr(), rn.data_ptr(),
                v.data_ptr(), nbins, n, power_iters, eps_rel)
        gevd_power.launches += 1
    return v


def pmwf_solve(rs: torch.Tensor, rn: torch.Tensor,
               beta: float = 0.0, eps_rel: float = 1e-6,
               return_powers: bool = False):
    """PMWF weight matrices (and per-channel powers) from (..., N, N)
    complex64 (Rs, Rn), N <= 8.  CPU: plain version; CUDA: the kernel
    (counted in ``pmwf_solve.launches``)."""
    if rs.device.type == "cpu":
        return pmwf_solve_plain(rs, rn, beta, eps_rel, return_powers)
    dev, nbins, n = _check("pmwf_solve", (rs, rn))
    w = torch.empty(rs.shape, dtype=torch.complex64, device=dev)
    ps = pn = None
    if return_powers:
        ps = torch.empty(rs.shape[:-1], dtype=torch.float32, device=dev)
        pn = torch.empty_like(ps)
    if nbins:
        _launch("pmwf_solve_launch", dev, rs.data_ptr(), rn.data_ptr(),
                w.data_ptr(), ps.data_ptr() if return_powers else None,
                pn.data_ptr() if return_powers else None, nbins, n,
                float(beta), eps_rel)
        pmwf_solve.launches += 1
    return (w, ps, pn) if return_powers else w


def capon(steer: torch.Tensor, r: torch.Tensor,
          eps_rel: float = 1e-6) -> torch.Tensor:
    """Capon weights for (..., N) complex64 steer vectors against
    (..., N, N) complex64 R, N <= 8.  CPU: plain version; CUDA: the
    kernel (counted in ``capon.launches``)."""
    if r.device.type == "cpu":
        return capon_plain(steer, r, eps_rel)
    dev, nbins, n = _check("capon", (r,), (steer,))
    w = torch.empty(steer.shape, dtype=torch.complex64, device=dev)
    if nbins:
        _launch("capon_launch", dev, steer.data_ptr(), r.data_ptr(),
                w.data_ptr(), nbins, n, eps_rel)
        capon.launches += 1
    return w


for _fn in (mvdr_power, gevd_power, pmwf_solve, capon):
    _fn.launches = 0
