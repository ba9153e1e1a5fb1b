"""Spatial features: IPD, GCC-PHAT, SRP-PHAT, MSC and directional features.

Counterpart of ``setk_tpu/spatial/features.py`` (the reference toolkit's
scripts/sptk/libs/spatial.py).  Every feature is a plain function on
tensors that runs on the device its input lies on; the grids of TDoA
transforms are built in numpy (float64, cast to complex64) and moved
there.  The coherence-to-angle product ``coherence @ transform`` is one
(T, F) x (F, D) complex product, which the JAX package also computes
outside any Pallas kernel; callers on a CUDA device keep it in full
float32 with ``utils.device.full_f32_matmuls``.
"""

import numpy as np
import torch

from setk_tpu_torch.utils.common import EPSILON

__all__ = [
    "linear_tdoa_grid", "gcc_phat_linear", "gcc_phat_diag", "srp_phat_linear",
    "smooth_angular_spectrogram", "msc", "ipd", "directional_feats"
]


def smooth_angular_spectrogram(spectra: torch.Tensor,
                               context: int) -> torch.Tensor:
    """Temporal context averaging of an angular spectrogram (..., T, D).

    Each frame becomes the mean of frames [t - context, t + context]
    with edge-clamped indices (the reference's --smooth-context pass of
    its C++ SRP computer).
    """
    if context <= 0:
        return spectra
    t = spectra.shape[-2]
    acc = 0
    for c in range(-context, context + 1):
        idx = np.clip(np.arange(t) + c, 0, t - 1)
        acc = acc + spectra.index_select(
            -2, torch.as_tensor(idx, device=spectra.device))
    return acc / (2 * context + 1)


def linear_tdoa_grid(dist,
                     speed: float = 343,
                     num_bins: int = 513,
                     samp_doa: bool = True,
                     sample_frequency: int = 16000,
                     num_doa: int = 181,
                     max_doa: float = np.pi) -> np.ndarray:
    """Steering transform T_{ij} = e^{-j omega_i tau_j}: (F, D) complex64."""
    dist = abs(dist)
    if samp_doa:
        tau = np.cos(np.linspace(0, max_doa, num_doa)) * dist / speed
    else:
        max_tdoa = dist / speed
        tau = np.linspace(max_tdoa, -max_tdoa, num_doa)
    omega = np.linspace(0, sample_frequency / 2, num_bins) * 2 * np.pi
    return np.exp(-1j * np.outer(omega, tau)).astype(np.complex64)


def _phase_spectrum(si, sj, transform: np.ndarray, normalize, apply_floor):
    coherence = torch.exp(1j * (si.angle() - sj.angle()))
    spectrum = (coherence @ torch.as_tensor(transform,
                                            device=si.device)).real
    if normalize:
        spectrum = spectrum / torch.clamp(spectrum.abs(), min=EPSILON).max()
    if apply_floor:
        spectrum = torch.clamp(spectrum, min=0)
    return spectrum


def gcc_phat_linear(si: torch.Tensor,
                    sj: torch.Tensor,
                    dij: float,
                    normalize: bool = True,
                    apply_floor: bool = True,
                    **kwargs) -> torch.Tensor:
    """GCC-PHAT angular spectrum of one linear-array pair (T, F): (T, D)."""
    return _phase_spectrum(si, sj, linear_tdoa_grid(dij, **kwargs),
                           normalize, apply_floor)


def gcc_phat_diag(si: torch.Tensor,
                  sj: torch.Tensor,
                  angle_delta: float,
                  d: float,
                  speed: float = 343,
                  num_doas: int = 121,
                  sr: int = 16000,
                  normalize: bool = True,
                  num_bins: int = 513,
                  apply_floor: bool = True) -> torch.Tensor:
    """GCC-PHAT between diagonal mics of a circular array: (T, D)."""
    doa_samp = np.linspace(0, np.pi * 2, num_doas)
    tau = np.cos(angle_delta - doa_samp) * d / speed
    omega = np.linspace(0, sr / 2, num_bins) * 2 * np.pi
    trans = np.exp(-1j * np.outer(omega, tau)).astype(np.complex64)
    return _phase_spectrum(si, sj, trans, normalize, apply_floor)


def srp_phat_linear(spectra: torch.Tensor,
                    topo,
                    normalize: bool = True,
                    apply_floor: bool = True,
                    **kwargs) -> torch.Tensor:
    """SRP-PHAT for a linear array, the mean of the pairwise GCC: (T, D).

    spectra: (N, T, F); topo: list of mic positions.
    """
    if not isinstance(topo, (list, tuple)):
        raise ValueError("Linear topology must be a list/tuple")
    n = spectra.shape[0]
    if n != len(topo):
        raise ValueError(f"{len(topo)} mics but {n}-channel STFT")
    if n == 2:
        return gcc_phat_linear(spectra[0], spectra[1], topo[1] - topo[0],
                               normalize=normalize, apply_floor=apply_floor,
                               **kwargs)
    srp = 0
    for i in range(n):
        for j in range(i + 1, n):
            srp = srp + gcc_phat_linear(spectra[i], spectra[j],
                                        topo[j] - topo[i],
                                        normalize=normalize,
                                        apply_floor=apply_floor, **kwargs)
    return srp * 2 / (n * (n - 1))


def msc(spectrogram: torch.Tensor,
        context: int = 1,
        normalize: bool = True) -> torch.Tensor:
    """Magnitude-squared coherence feature: (N, T, F) -> (T, F).

    Context frames are stacked with edge-clamped indices.  The diagonal
    term is the JAX package's: the sum of every diagonal coherence (a
    scalar) added to each (T, F) cell of the summed matrix.
    """
    n, t, _ = spectrogram.shape
    ctx = context * 2 + 1
    idx = np.clip(
        np.arange(t)[None, :] + np.arange(-context, context + 1)[:, None], 0,
        t - 1)
    stacked = spectrogram[:, torch.as_tensor(idx,
                                             device=spectrogram.device)]
    # (N, C, T, F): sum over the context of y_a y_c^*
    numerator = torch.einsum("abtf,cbtf->actf", stacked,
                             stacked.conj()) / ctx
    diag = numerator.diagonal(dim1=0, dim2=1).abs().permute(2, 0, 1)
    denominator = torch.sqrt(diag[:, None] * diag[None, :])
    icc = (numerator / denominator).abs()
    coh = icc.diagonal(dim1=0, dim2=1).sum()
    coh = coh + icc.sum(0).sum(0)
    coh = coh / (n * (n - 1))
    if normalize:
        coh = coh / coh.abs().max()
    return coh


def ipd(si: torch.Tensor,
        sj: torch.Tensor,
        cos: bool = False,
        sin: bool = False) -> torch.Tensor:
    """IPD wrapped to [-pi, pi), cosIPD, or [cosIPD, sinIPD] over (T, F).

    The wrap is ``remainder(x + pi, 2 pi) - pi``: floor semantics, as
    ``jnp.mod`` (``torch.fmod`` truncates and differs for x < -pi).
    """
    ipd_mat = si.angle() - sj.angle()
    if not cos:
        return torch.remainder(ipd_mat + np.pi, 2 * np.pi) - np.pi
    cos_ipd = torch.cos(ipd_mat)
    if not sin:
        return cos_ipd
    return torch.cat([cos_ipd, torch.sin(ipd_mat)], dim=-1)


def directional_feats(spectrogram: torch.Tensor,
                      steer_vector: torch.Tensor,
                      df_pair=None) -> torch.Tensor:
    """Directional features cos(IPD_obs - IPD_steer) averaged over pairs.

    spectrogram (M, F, T), steer_vector (M, F) -> (T, F).  Only phase
    differences between mics enter, so a steer vector's common phase
    (an eigenvector's, say) does not change the features.
    """
    m = spectrogram.shape[0]
    if df_pair is None:
        df_pair = [(i, j) for i in range(m) for j in range(i + 1, m)]
    arg_s = spectrogram.angle()
    arg_t = steer_vector.angle()
    feats = []
    for i, j in df_pair:
        delta_s = arg_s[i] - arg_s[j]                  # F x T
        delta_t = (arg_t[i] - arg_t[j])[:, None]       # F x 1
        feats.append(torch.cos(delta_s - delta_t))
    return torch.stack(feats).mean(0).T
