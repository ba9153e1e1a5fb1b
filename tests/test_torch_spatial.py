"""The port's spatial layer against setk_tpu on the same numpy inputs.

- steer grids, distance matrices, ``diffuse_covar`` and the TDoA grids:
  bit-equal (both build them in float64 numpy and cast at the end);
- the features (GCC-PHAT linear and diagonal, SRP-PHAT, MSC, IPD,
  directional features, the angular smoothing): within 1e-5 of the
  JAX output's peak; IPD by the wrapped difference min(|d|, 2 pi - |d|),
  since the sign of a zero decides between +pi and -pi;
- ML, SRP and MUSIC scores within ``SCORE_TOL`` of their peak |score|,
  and the DoA index equal wherever the top two scores differ by more
  than that tolerance (two f32 implementations may flip a near-tie).
  ML with ``norm`` (unit-modulus observations, so ssh = M and the terms
  near the source cancel hardest) is held to 1e-4: on the line both
  packages lie 1.7e-5 (JAX) and 3.5e-5 (port) of the peak from a
  float64 run of the same function;
- ``beam_pattern`` and ``ds_weights`` within 1e-6 of the peak, and
  ``sd_weights`` per bin within max(kappa_f 1e-6, 1e-5) of the bin's
  peak, kappa_f the diffuse covariance's condition number (~6e5 at bins
  0-1 of the default 6-mic circle at diag_eps 1e-5).

Scenes (tests/spatial_scene.py): a far-field source in noise bursts at
DoA 67 degrees, the sensor noise at 0.05 of the source, on the default
4-mic line and 6-mic circle, 1 s at 16 kHz.
"""

import numpy as np
import pytest
import torch

from setk_tpu.enhance import beamformer as jbf
from setk_tpu.spatial import features as jft
from setk_tpu.spatial import ssl as jssl
from setk_tpu.spatial import steer as jst
from setk_tpu.utils.common import check_doa as jcheck_doa
from setk_tpu_torch.dsp.stft import StftConfig, forward_stft
from setk_tpu_torch.enhance import beamformer as tbf
from setk_tpu_torch.spatial import features as tft
from setk_tpu_torch.spatial import ssl as tssl
from setk_tpu_torch.spatial import steer as tst
from setk_tpu_torch.utils.common import EPSILON, check_doa

from spatial_scene import (CIRCLE_MICS, CIRCLE_RADIUS, LINEAR_TOPO,
                           burst_mask, scene)

FEAT_TOL = 1e-5
SCORE_TOL = {"ml": 2e-5, "ml-norm": 1e-4, "srp": 1e-5, "music": 1e-5}
NUM_DOAS = {"linear": 181, "circular": 360}
DOA = 67.0


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _grid(geometry, num_bins=257, center=False):
    return jst.steer_vector_grid(geometry, NUM_DOAS[geometry], num_bins,
                                 linear_topo=list(LINEAR_TOPO),
                                 circular_radius=CIRCLE_RADIUS,
                                 circular_around=CIRCLE_MICS,
                                 circular_center=center)


@pytest.fixture(scope="module", params=["linear", "circular"])
def obs(request):
    """(geometry, stft (M, T, F) complex64, mask (T, F), grid (A, M, F))."""
    geometry = request.param
    wav, _, gate = scene(np.random.default_rng(3), geometry, DOA, 16000)
    spec = forward_stft(torch.from_numpy(wav), StftConfig()).numpy()
    mask = burst_mask(gate, spec.shape[1], spec.shape[2])
    sv = np.ascontiguousarray(_grid(geometry)[1].transpose(0, 2, 1))
    return geometry, spec, mask, sv


# ---- steer.py: bit-equal ----

@pytest.mark.parametrize("geometry,center,num_bins", [
    ("linear", False, 257), ("circular", False, 257),
    ("circular", True, 513)])
def test_steer_grid_bit_equal(geometry, center, num_bins):
    doas, grid = _grid(geometry, num_bins, center)
    t_doas, t_grid = tst.steer_vector_grid(
        geometry, NUM_DOAS[geometry], num_bins,
        linear_topo=list(LINEAR_TOPO), circular_radius=CIRCLE_RADIUS,
        circular_around=CIRCLE_MICS, circular_center=center)
    assert t_grid.dtype == np.complex64
    assert np.array_equal(t_doas, doas) and np.array_equal(t_grid, grid)
    assert np.array_equal(
        tst.linear_steer_vector(LINEAR_TOPO, 33.0, num_bins, c=343.0),
        jst.linear_steer_vector(LINEAR_TOPO, 33.0, num_bins, c=343.0))
    assert np.array_equal(
        tst.plane_steer_vector([[0.01, -0.02]], num_bins, sr=8000),
        jst.plane_steer_vector([[0.01, -0.02]], num_bins, sr=8000))


@pytest.mark.parametrize("geometry,eps,center", [
    ("linear", 0.1, False), ("circular", 1e-5, False),
    ("circular", 1e-5, True)])
def test_diffuse_covar_bit_equal(geometry, eps, center):
    if geometry == "linear":
        dist, t_dist = (m.linear_distance_matrix(LINEAR_TOPO)
                        for m in (jst, tst))
    else:
        dist, t_dist = (m.circular_distance_matrix(
            CIRCLE_RADIUS, CIRCLE_MICS, center=center) for m in (jst, tst))
    assert np.array_equal(t_dist, dist)
    assert np.array_equal(tst.diffuse_covar(257, t_dist, diag_eps=eps),
                          jst.diffuse_covar(257, dist, diag_eps=eps))


@pytest.mark.parametrize("samp_doa", [True, False])
def test_linear_tdoa_grid_bit_equal(samp_doa):
    kw = dict(num_bins=257, samp_doa=samp_doa, num_doa=91)
    assert np.array_equal(tft.linear_tdoa_grid(-0.05, **kw),
                          jft.linear_tdoa_grid(-0.05, **kw))


@pytest.mark.parametrize("geometry,doa,online", [
    ("linear", 180.0, False), ("linear", 181.0, False),
    ("circular", 360.0, False), ("circular", -1.0, False),
    ("circular", [0.0, 359.0], True), ("linear", [10.0, 190.0], True)])
def test_check_doa(geometry, doa, online):
    assert check_doa(geometry, doa, online) == jcheck_doa(geometry, doa,
                                                          online)


# ---- features.py: within FEAT_TOL of the peak ----

def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("normalize,apply_floor", [(True, True),
                                                   (False, True),
                                                   (True, False)])
def test_gcc_phat_linear(obs, normalize, apply_floor):
    _, spec, _, _ = obs
    kw = dict(normalize=normalize, apply_floor=apply_floor, num_bins=257,
              num_doa=121)
    got = tft.gcc_phat_linear(_t(spec[0]), _t(spec[2]), 0.1, **kw)
    assert _rel(got, jft.gcc_phat_linear(spec[0], spec[2], 0.1,
                                         **kw)) <= FEAT_TOL


@pytest.mark.parametrize("pair", [(0, 3), (1, 3)])
def test_gcc_phat_diag(obs, pair):
    _, spec, _, _ = obs
    i, j = pair
    kw = dict(angle_delta=min(i, j) * np.pi * 2 / 6, d=0.1, num_bins=257)
    got = tft.gcc_phat_diag(_t(spec[i]), _t(spec[j]), **kw)
    assert _rel(got, jft.gcc_phat_diag(spec[i], spec[j], **kw)) <= FEAT_TOL


@pytest.mark.parametrize("mics", [2, 4])
def test_srp_phat_linear(obs, mics):
    _, spec, _, _ = obs
    topo = list(LINEAR_TOPO[:mics])
    kw = dict(num_bins=257, samp_doa=False, num_doa=181)
    got = tft.srp_phat_linear(_t(spec[:mics]), topo, **kw)
    assert _rel(got, jft.srp_phat_linear(spec[:mics], topo,
                                         **kw)) <= FEAT_TOL
    with pytest.raises(ValueError):
        tft.srp_phat_linear(_t(spec[:mics]), topo[:-1], **kw)


@pytest.mark.parametrize("context", [0, 1, 3])
def test_smooth_angular_spectrogram(context):
    x = np.random.default_rng(context).random((2, 40, 121)).astype(
        np.float32)
    got = tft.smooth_angular_spectrogram(_t(x), context)
    assert _rel(got, jft.smooth_angular_spectrogram(x, context)) <= 1e-6


@pytest.mark.parametrize("context,normalize", [(0, True), (1, True),
                                               (2, False)])
def test_msc(obs, context, normalize):
    _, spec, _, _ = obs
    got = tft.msc(_t(spec), context=context, normalize=normalize)
    assert _rel(got, jft.msc(spec, context=context,
                             normalize=normalize)) <= FEAT_TOL


@pytest.mark.parametrize("cos,sin", [(False, False), (True, False),
                                     (True, True)])
def test_ipd(obs, cos, sin):
    _, spec, _, _ = obs
    got = tft.ipd(_t(spec[0]), _t(spec[1]), cos=cos, sin=sin).numpy()
    ref = np.asarray(jft.ipd(spec[0], spec[1], cos=cos, sin=sin))
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    if not cos:
        assert got.min() >= -np.pi and got.max() <= np.pi
        d = np.minimum(d, 2 * np.pi - d)
    assert d.max() <= FEAT_TOL * np.abs(ref).max()


def test_ipd_wraps_with_floor_semantics():
    """remainder, not fmod: an IPD below -pi wraps up, as jnp.mod."""
    si = torch.tensor([np.exp(-3.0j)], dtype=torch.complex64)
    sj = torch.tensor([np.exp(3.0j)], dtype=torch.complex64)
    got = float(tft.ipd(si, sj)[0])
    assert abs(got - (2 * np.pi - 6.0)) < 1e-5
    assert abs(got - float(np.asarray(jft.ipd(si.numpy(),
                                              sj.numpy()))[0])) < 1e-5


@pytest.mark.parametrize("df_pair", [None, [(0, 1), (0, 2), (1, 3)]])
def test_directional_feats(obs, df_pair):
    _, spec, _, sv = obs
    stft = np.ascontiguousarray(spec.transpose(0, 2, 1))    # M x F x T
    got = tft.directional_feats(_t(stft), _t(sv[40]), df_pair=df_pair)
    ref = jft.directional_feats(stft, sv[40], df_pair=df_pair)
    assert _rel(got, ref) <= FEAT_TOL
    # a common phase on the steer vector does not move the features
    turned = tft.directional_feats(_t(stft), _t(sv[40] * np.exp(1.1j)),
                                   df_pair=df_pair)
    assert _rel(turned, ref) <= FEAT_TOL


# ---- ssl.py: scores within SCORE_TOL of the peak, index by margin ----

def _check_scores(backend, got, ref, bar):
    (g_idx, g_sc), (r_idx, r_sc) = got, ref
    g_sc, r_sc = g_sc.numpy(), np.asarray(r_sc)
    tol = SCORE_TOL[bar] * np.abs(r_sc).max()
    assert np.abs(g_sc - r_sc).max() <= tol, backend
    order = np.sort(r_sc if backend != "music" else -r_sc)
    if order[-1] - order[-2] > tol:
        assert int(g_idx) == int(r_idx), backend
    return int(r_idx)


SSL_CASES = [("ml", "mask"), ("ml", None), ("ml", "two"), ("ml", "pow"),
             ("ml", "norm"), ("srp", "mask"), ("srp", None),
             ("music", "mask"), ("music", None)]


@pytest.mark.parametrize("backend,variant", SSL_CASES,
                         ids=[f"{b}-{v}" for b, v in SSL_CASES])
def test_ssl_matches_setk_tpu(obs, backend, variant):
    geometry, spec, mask, sv = obs
    m = None if variant is None else mask
    if variant == "two":                                # (N, T, F) masks
        m = np.stack([mask, 1.0 - mask])
    kw = {}
    if backend == "ml":
        kw = dict(compression=0.5 if variant == "pow" else -1,
                  eps=EPSILON, norm=variant == "norm")
        fns = (tssl.ml_ssl, jssl.ml_ssl)
    elif backend == "srp":
        pairs = (([0, 1, 2], [3, 4, 5]) if geometry == "circular"
                 else ([0, 0, 1], [1, 3, 2]))
        fns = (lambda *a, **k: tssl.srp_ssl(a[0], a[1], pairs, **k),
               lambda *a, **k: jssl.srp_ssl(a[0], a[1], pairs, **k))
    else:
        fns = (tssl.music_ssl, jssl.music_ssl)
    got = fns[0](_t(spec), _t(sv), mask=None if m is None else _t(m),
                 return_scores=True, **kw)
    ref = fns[1](spec, sv, mask=m, return_scores=True, **kw)
    bar = "ml-norm" if variant == "norm" else backend
    if variant == "two":
        for k in range(2):
            _check_scores(backend, (got[0][k], got[1][k]),
                          (ref[0][k], ref[1][k]), bar)
        return
    idx = _check_scores(backend, got, ref, bar)
    if variant in ("mask", None):       # the scene's source is found
        doas = _grid(geometry)[0]
        assert abs(doas[idx] - DOA) <= 2 * (doas[1] - doas[0])


def test_music_needs_no_eigenvector_phase(obs):
    """MUSIC's noise projector is the same for any eigenvector phases."""
    _, spec, mask, sv = obs
    obs_f = _t(spec * mask).permute(2, 0, 1)
    covar = obs_f @ obs_f.conj().transpose(-1, -2) / spec.shape[1]
    _, v = torch.linalg.eigh(covar)
    turned = v * torch.exp(1j * torch.linspace(0, 3, v.shape[-1]))
    p0 = v[..., :-1] @ v[..., :-1].conj().transpose(-1, -2)
    p1 = turned[..., :-1] @ turned[..., :-1].conj().transpose(-1, -2)
    assert _rel(p1, p0) <= 1e-6


# ---- the classic beamformer's weights ----

def test_beam_pattern_and_ds_weights(obs):
    geometry, _, _, sv = obs
    grid = _grid(geometry)[1]                           # A x F x N
    steer = grid[30]
    n = steer.shape[-1]
    w, jw = tbf.ds_weights(_t(steer), n), jbf.ds_weights(steer, n)
    assert _rel(w, jw) <= 1e-6
    assert _rel(tbf.ds_weights(_t(steer)), jbf.ds_weights(steer)) <= 1e-6
    fdn = np.ascontiguousarray(grid.transpose(1, 0, 2))  # F x D x N
    got = tbf.beam_pattern(w, _t(fdn))
    assert _rel(got, jbf.beam_pattern(np.asarray(jw), fdn)) <= 1e-6
    # batched weights (B, F, N)
    wb = np.stack([np.asarray(jw), grid[90] / n])
    assert _rel(tbf.beam_pattern(_t(wb), _t(fdn)),
                jbf.beam_pattern(wb, fdn)) <= 1e-6


@pytest.mark.parametrize("geometry,eps,doa", [("linear", 0.1, 30.0),
                                              ("circular", 1e-5, 30.0),
                                              ("circular", 1e-5, 211.0)])
def test_sd_weights_kappa_bar(geometry, eps, doa):
    if geometry == "linear":
        dist = tst.linear_distance_matrix(LINEAR_TOPO)
        steer = tst.linear_steer_vector(LINEAR_TOPO, doa, 257)
    else:
        dist = tst.circular_distance_matrix(CIRCLE_RADIUS, CIRCLE_MICS)
        steer = tst.circular_steer_vector(CIRCLE_RADIUS, CIRCLE_MICS, doa,
                                          257)
    rn = tst.diffuse_covar(257, dist, diag_eps=eps)
    steer = steer / steer.shape[-1]
    got = tbf.sd_weights(_t(steer), _t(rn)).numpy()
    ref = np.asarray(jbf.sd_weights(steer, rn))
    kappa = np.linalg.cond(rn.astype(np.complex128))
    bar = np.maximum(kappa * 1e-6, 1e-5)
    err = np.abs(got - ref).max(-1) / np.abs(ref).max(-1)
    assert (err <= bar).all(), (err / bar).max()
    if geometry == "linear":
        assert kappa.max() <= 41
    else:
        assert kappa.max() > 5e5 and (kappa > 1e3).sum() >= 13
