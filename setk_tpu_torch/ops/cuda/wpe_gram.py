"""Tap-free WPE: the weighted Gram and the filter application (kernels 18,
19).

Counterpart of ``setk_tpu/ops/pallas/wpe_gram.py``; kernel source
``setk_tpu_torch/csrc/wpe_gram.cu``:

  wpe_gram (kernel 18; ``wpe_gram_pallas`` :292): obs (bins, N, T)
      complex64 -> gram (bins, cols, cols) complex64, cols = (taps + 1) N,
      the Gram of the [current | delayed taps] rows weighted by 1 / lambda:
      lambda the context-smoothed power of d = y - G^H taps (``use_g``; of
      y on the first iteration) or the caller's ``lam`` (bins, T) (WPD);
      exactly Hermitian with a real diagonal;
  wpe_apply (kernel 19; ``wpe_apply_pallas`` :344): d = y - G^H taps,
      (bins, N, T) complex64.

G is (bins, N taps, N) complex64, tap row k N + m reading mic m at frame
t - delay - k (``enhance.wpe.compute_tap_mat``'s order).  The ``*_plain``
functions are the plain PyTorch versions (a tap stack and a matmul).
``wpe_fused_supported`` is the port's gate for the fused WPE loop: N <= 8
and N taps <= 128, the limits of kernels 17 and 18.
"""

import torch

from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.utils.common import EPSILON

__all__ = ["MAX_MICS", "MAX_TAP_ROWS", "wpe_fused_supported", "tap_rows",
           "wpe_gram", "wpe_gram_plain", "wpe_apply", "wpe_apply_plain"]

MAX_MICS = 8
MAX_TAP_ROWS = 128


def wpe_fused_supported(n_mics: int, taps: int) -> bool:
    return 1 <= n_mics <= MAX_MICS and 1 <= taps and \
        n_mics * taps <= MAX_TAP_ROWS


def tap_rows(obs: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """(..., N, T) -> (..., N taps, T): block k is obs delayed by
    delay + k frames, zero at the front."""
    t = obs.shape[-1]
    blocks = []
    for k in range(taps):
        d = k + delay
        if d < t:
            blocks.append(torch.nn.functional.pad(obs[..., :t - d], (d, 0)))
        else:
            blocks.append(torch.zeros_like(obs))
    return torch.cat(blocks, dim=-2)


def wpe_apply_plain(obs: torch.Tensor, g: torch.Tensor, taps: int,
                    delay: int) -> torch.Tensor:
    """Plain version of kernel 19: y - G^H taps."""
    return obs - g.conj().transpose(-1, -2) @ tap_rows(obs, taps, delay)


def _smoothed_power(d: torch.Tensor, context: int) -> torch.Tensor:
    """Mean power over mics, then the (2 context + 1)-frame average with
    compute_lambda's edge counts, summed as the kernel sums: (bins, T)."""
    n, t = d.shape[-2:]
    power = (d.real * d.real + d.imag * d.imag).sum(-2) * (1.0 / n)
    acc = power.clone()
    counts = torch.ones(t, device=d.device)
    frames = torch.arange(t, device=d.device)
    for c in range(1, context + 1):
        if c < t:
            acc[..., c:] += power[..., :t - c]
            acc[..., :t - c] += power[..., c:]
        counts += (frames >= c).float() + (frames < t - c).float()
    return acc / counts


def wpe_gram_plain(obs: torch.Tensor, g, taps: int, delay: int,
                   context: int, use_g: bool = True,
                   lam: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel 18."""
    rows = tap_rows(obs, taps, delay)
    if lam is None:
        d = obs - g.conj().transpose(-1, -2) @ rows if use_g else obs
        lam = _smoothed_power(d, context)
    sw = 1.0 / torch.sqrt(torch.clamp(lam, min=EPSILON))
    a = torch.cat([obs, rows], dim=-2) * sw[..., None, :]
    gram = a @ a.conj().transpose(-1, -2)
    upper = torch.triu(gram, diagonal=1)
    diag = torch.diagonal(gram, dim1=-2, dim2=-1).real
    return upper + upper.conj().transpose(-1, -2) + torch.diag_embed(
        diag).to(gram.dtype)


def _check(what, obs, g, taps, delay, need_g=True):
    if obs.dtype != torch.complex64 or obs.ndim != 3 or \
            not obs.is_contiguous() or 0 in obs.shape:
        raise ValueError(f"{what}: obs must be a contiguous non-empty "
                         f"complex64 (bins, N, T) tensor, got {obs.dtype} "
                         f"{tuple(obs.shape)}")
    bins, n, _ = obs.shape
    if not wpe_fused_supported(n, taps) or delay < 0:
        raise ValueError(f"{what}: needs N <= {MAX_MICS}, N taps <= "
                         f"{MAX_TAP_ROWS} and delay >= 0, got N = {n}, "
                         f"taps = {taps}, delay = {delay}")
    shape = (bins, n * taps, n)
    if need_g and (g is None or g.device != obs.device or
                   g.dtype != torch.complex64 or tuple(g.shape) != shape or
                   not g.is_contiguous()):
        raise ValueError(f"{what}: G must be a contiguous complex64 {shape} "
                         f"tensor on {obs.device}")


def wpe_gram(obs: torch.Tensor, g, taps: int, delay: int, context: int,
             use_g: bool = True,
             lam: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel 18: the (bins, cols, cols) complex64 weighted Gram.

    ``g`` is read only when ``use_g`` and no ``lam`` is given (it may be
    None otherwise).  A CPU tensor runs the plain version; a CUDA tensor
    launches the kernel (``wpe_gram.launches`` counts those launches).
    """
    if obs.device.type == "cpu":
        return wpe_gram_plain(obs, g, taps, delay, context, use_g, lam)
    _check("wpe_gram", obs, g, taps, delay,
           need_g=use_g and lam is None)
    bins, n, t = obs.shape
    if context < 0:
        raise ValueError(f"wpe_gram: context must be >= 0, got {context}")
    if lam is not None and (lam.device != obs.device or
                            lam.dtype != torch.float32 or
                            tuple(lam.shape) != (bins, t) or
                            not lam.is_contiguous()):
        raise ValueError(f"wpe_gram: lam must be a contiguous float32 "
                         f"{(bins, t)} tensor on {obs.device}")
    cols = (taps + 1) * n
    gram = torch.empty((bins, cols, cols), dtype=torch.complex64,
                       device=obs.device)
    _build.launch("wpe_gram", "wpe_gram_launch", obs.device, obs.data_ptr(),
                  None if g is None else g.data_ptr(),
                  None if lam is None else lam.data_ptr(), gram.data_ptr(),
                  bins, n, t, taps, delay, context, int(use_g))
    wpe_gram.launches += 1
    return gram


def wpe_apply(obs: torch.Tensor, g: torch.Tensor, taps: int,
              delay: int) -> torch.Tensor:
    """Kernel 19: d = y - G^H taps, (bins, N, T) complex64.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (``wpe_apply.launches`` counts those launches).
    """
    if obs.device.type == "cpu":
        return wpe_apply_plain(obs, g, taps, delay)
    _check("wpe_apply", obs, g, taps, delay)
    bins, n, t = obs.shape
    out = torch.empty_like(obs)
    _build.launch("wpe_gram", "wpe_apply_launch", obs.device, obs.data_ptr(),
                  g.data_ptr(), out.data_ptr(), bins, n, t, taps, delay)
    wpe_apply.launches += 1
    return out


wpe_gram.launches = 0
wpe_apply.launches = 0
