"""Steer vectors and diffuse-field covariance models (numpy, float64).

The port's own copy of ``setk_tpu/spatial/steer.py`` (the reference
toolkit's scripts/sptk/libs/beamformer.py:133-212): plane, linear and
circular far-field steer vectors with omega = pi k sr / (F - 1) and the
e^{-j omega d / c} convention, and the sinc spherically-isotropic
covariance with diagonal loading.  Every grid is built in float64 and
cast to complex64 at the end, so a steering grid is bit-equal across the
two packages (a float32 omega d / c would move the phase at high bins).
All functions vectorize over a DoA axis (a whole A x F x N grid at once).
"""

import numpy as np

__all__ = [
    "plane_steer_vector", "linear_steer_vector", "circular_steer_vector",
    "diffuse_covar", "steer_vector_grid", "circular_distance_matrix",
    "linear_distance_matrix"
]


def _omega(num_bins, sr):
    # omega = 2 pi f_k with f_k = k sr / (2 (F - 1))
    return np.pi * np.arange(num_bins) * sr / (num_bins - 1)


def plane_steer_vector(distance, num_bins, c=340.0, sr=16000):
    """Far-field steer vector from projected distances.

    distance: (..., N) projected propagation distances (meters).
    Returns (..., F, N) complex64.
    """
    distance = np.asarray(distance, dtype=np.float64)
    omega = _omega(num_bins, sr)
    phase = omega[..., :, None] * (distance[..., None, :] / c)
    return np.exp(-1j * phase).astype(np.complex64)


def linear_steer_vector(topo, doa, num_bins, c=340.0, sr=16000):
    """Linear-array steer vector(s).

    topo: (N,) mic positions along the axis; doa: scalar or (A,) degrees
    (0..180).  Returns (F, N) or (A, F, N).
    """
    topo = np.asarray(topo, dtype=np.float64)
    doa = np.asarray(doa, dtype=np.float64)
    dist = np.cos(doa[..., None] * np.pi / 180.0) * topo
    return plane_steer_vector(dist, num_bins, c=c, sr=sr)


def circular_steer_vector(radius,
                          num_arounded,
                          doa,
                          num_bins,
                          c=340.0,
                          sr=16000,
                          center=False):
    """Circular-array steer vector(s); doa in degrees (0..360)."""
    doa = np.asarray(doa, dtype=np.float64)
    dirc = np.arange(num_arounded) * 2 * np.pi / num_arounded
    dist = np.cos(dirc - doa[..., None] * np.pi / 180.0) * radius
    if center:
        pad = np.zeros(dist.shape[:-1] + (1,))
        dist = np.concatenate([pad, dist], axis=-1)
    return plane_steer_vector(-dist, num_bins, c=c, sr=sr)


def steer_vector_grid(geometry: str,
                      num_doas: int,
                      num_bins: int,
                      linear_topo=None,
                      circular_radius=None,
                      circular_around=None,
                      circular_center=False,
                      c=340.0,
                      sr=16000):
    """(DoAs in degrees, the A x F x N grid) for SSL and beam patterns.

    Linear arrays sample 0..180 degrees, circular 0..360 (exclusive).
    """
    if geometry == "linear":
        doas = np.linspace(0, 180, num_doas)
        return doas, linear_steer_vector(linear_topo, doas, num_bins,
                                         c=c, sr=sr)
    if geometry == "circular":
        doas = np.arange(num_doas) * 360.0 / num_doas
        return doas, circular_steer_vector(circular_radius, circular_around,
                                           doas, num_bins, c=c, sr=sr,
                                           center=circular_center)
    raise ValueError(f"Unknown geometry: {geometry}")


def circular_distance_matrix(radius, num_arounded, center=False):
    """Pairwise chord distances for a (center+)circular array."""
    num_mics = num_arounded + 1 if center else num_arounded
    dist = np.zeros((num_mics, num_mics))
    base = 1 if center else 0
    if center:
        dist[0, 1:] = radius
    ang = np.pi / num_arounded
    for r in range(base, num_mics):
        for c_ in range(r + 1, num_mics):
            dist[r, c_] = abs(np.sin((c_ - r) * ang) * 2 * radius)
    return dist + dist.T


def linear_distance_matrix(topo):
    """Pairwise distances of mics on a line."""
    topo = np.asarray(topo, dtype=np.float64)
    return np.abs(topo[:, None] - topo[None, :])


def diffuse_covar(num_bins, dist_mat, sr=16000, c=340.0, diag_eps=0.1):
    """Spherically-isotropic noise covariance: sinc(omega d / c) + eps I,
    (F, N, N) complex64.

    np.sinc is the normalized sinc, sin(pi x) / (pi x), applied to
    omega d / c, as the reference toolkit does.
    """
    dist_mat = np.asarray(dist_mat, dtype=np.float64)
    n = dist_mat.shape[0]
    omega = _omega(num_bins, sr)
    covar = np.sinc(dist_mat[None, :, :] * omega[:, None, None] / c)
    return (covar + np.eye(n) * diag_eps).astype(np.complex64)
