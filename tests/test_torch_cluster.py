"""The port's CGMM/CACGMM clustering (kernels 13-15) against setk_tpu.

Small shapes (F <= 24, M <= 4, T <= 40, a few iterations), inputs from
numpy seeds fed to both packages:

- kernel 13's plain version against ``masked_covar_pallas`` in interpret
  mode and the JAX ``covar_stats``, one observation against K classes;
- kernel 14's plain version (the EVD's round-robin sweeps with the
  TPU kernel's floored inverse) and the cyclic plain Jacobi (the TPU
  kernel's statements, kernel 15's) against ``regularized_inverse_pallas``
  in interpret mode and the JAX eigh-based ``regularized_inverse``, and
  the port's eigh-based ``regularized_inverse`` against the JAX one,
  near-singular matrices included; a CGMM resume with ``ops.linalg``'s
  card branch taken on the CPU (kernel 14's plain version) against the
  JAX resume;
- kernel 15's plain version against ``cacgmm_em_pallas`` /
  ``cgmm_em_pallas`` in interpret mode: both entries, both models, a
  frame mask, K = 3;
- ``cgmm_em`` / ``cacgmm_em``: the scan against the JAX scan (fresh
  Higuchi, ``gamma_init``, state resume in both directions through
  ``convert.py``), the fused path's plain version against the JAX scan,
  the frame-mask padding invariance; ``permu_aligner`` at K = 3, F = 257;
- ``BatchClusterer`` on the CPU against the JAX one over mixed lengths;
- the CUDA dispatch with ``torch.cuda`` mocked: which entry each call
  takes, and the refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.enhance import beamformer as jbf
from setk_tpu.enhance import cluster as jc
from setk_tpu.ops.linalg import regularized_inverse as jax_reg_inverse
from setk_tpu.ops.pallas.cacgmm_em import cacgmm_em_pallas, cgmm_em_pallas
from setk_tpu.ops.pallas.covariance import masked_covar_pallas
from setk_tpu.ops.pallas.eigh_small import regularized_inverse_pallas
from setk_tpu.parallel import executor as jex
from setk_tpu_torch.convert import em_state_from_numpy, em_state_to_numpy
from setk_tpu_torch.enhance import beamformer as tbf
from setk_tpu_torch.enhance import cluster as tc
from setk_tpu_torch.ops import linalg as tla
from setk_tpu_torch.ops.cuda import cacgmm_em as ce
from setk_tpu_torch.ops.cuda import covariance as mc
from setk_tpu_torch.ops.cuda import eigh_small as es
from setk_tpu_torch.parallel import executor as tex


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _spatial_mix(rng, m=4, f=16, t=40):
    """Two sources with distinct steering in alternating halves, plus
    noise (tests/test_cluster.py's scene)."""
    a1, a2 = _cplx(rng, f, m, 1), _cplx(rng, f, m, 1)
    s1 = np.zeros((f, 1, t), np.complex64)
    s2 = np.zeros((f, 1, t), np.complex64)
    s1[..., :t // 2] = _cplx(rng, f, 1, t // 2)
    s2[..., t // 2:] = _cplx(rng, f, 1, t - t // 2)
    return (a1 * s1 + a2 * s2 + 0.05 * _cplx(rng, f, m, t)).astype(
        np.complex64)


def _scene(rng, *lead, f=12, m=3, t=40):
    """Random spectra with mic 0 leaking into the others (the scene of
    tests/test_pallas.py's EM tests): well-conditioned covariances, where
    two eigh implementations agree to rounding.  On _spatial_mix's
    near-rank-one classes the floored eigenvalues are rounding noise, and
    CACGMM runs of two packages part by ~0.1 within five iterations."""
    obs = _cplx(rng, *lead, f, m, t)
    obs[..., 1:, :] += 0.5 * obs[..., :1, :]
    return obs


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- kernel 13 ----

def test_masked_covar_plain_matches_pallas_and_covar_stats():
    """One observation (B=2, F=16, N=3, T=48) against K=2 classes: kernel
    13's plain version, the Pallas kernel in interpret mode and the JAX
    covar_stats (test_pallas.py:223-240), 1e-4."""
    rng = np.random.default_rng(0)
    obs = _cplx(rng, 2, 16, 3, 48)
    w = rng.random((2, 2, 16, 48)).astype(np.float32)
    got = mc.masked_covar_plain(torch.from_numpy(obs), torch.from_numpy(w))
    ref, _ = jbf.covar_stats(jnp.asarray(obs)[None], jnp.asarray(w),
                             use_pallas=False)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    flat = np.broadcast_to(obs[None], (2, 2, 16, 3, 48)).reshape(
        -1, 16, 3, 48)
    nre, nim, _ = masked_covar_pallas(np.real(flat).copy(),
                                      np.imag(flat).copy(),
                                      w.reshape(-1, 16, 48), f_tile=8,
                                      interpret=True)
    pallas = (np.asarray(nre) + 1j * np.asarray(nim)).reshape(
        2, 2, 16, 3, 3)
    np.testing.assert_allclose(_np(got), pallas, atol=1e-4, rtol=1e-4)
    num, den = tbf.covar_stats(torch.from_numpy(obs)[None],
                               torch.from_numpy(w))
    np.testing.assert_allclose(_np(num), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    assert tuple(den.shape) == (2, 2, 16)


# ---- kernel 14 ----

def _covars(rng, count, m, singular):
    a = _cplx(rng, count, m, m + 4).astype(np.complex128)
    mats = a @ np.conj(a.transpose(0, 2, 1))
    u = _cplx(rng, singular, m, 1).astype(np.complex128)
    mats[:singular] = u @ np.conj(u.transpose(0, 2, 1)) + 1e-5 * np.eye(m)
    return mats.astype(np.complex64)


def _peak_errs(got, ref):
    scale = np.abs(ref).max(axis=(-1, -2), keepdims=True)
    return (np.abs(got - ref) / scale).max(axis=(-1, -2))


def test_jacobi_plain_matches_pallas():
    """The same cyclic Jacobi: 1e-5 of each matrix's peak on full-rank
    matrices (measured 4.6e-6 at M = 6, 1e-6 at M = 4); on rank-one ones
    the eigenvalues under the floor are rounding, so only the structural
    bars of test_pallas.py:266-276 hold."""
    rng = np.random.default_rng(1)
    a = _covars(rng, 30, 4, singular=10)
    got_inv, got_ld = es.jacobi_regularized_inverse_plain(torch.from_numpy(a))
    ref_inv, ref_ld = regularized_inverse_pallas(
        jnp.asarray(a), return_logdet=True, interpret=True)
    err = _peak_errs(_np(got_inv), np.asarray(ref_inv))
    assert err[10:].max() < 1e-5
    np.testing.assert_allclose(_np(got_ld)[10:], np.asarray(ref_ld)[10:],
                               atol=1e-5)
    assert err[:10].max() < 0.3
    np.testing.assert_allclose(_np(got_ld)[:10], np.asarray(ref_ld)[:10],
                               atol=0.5)


def test_regularized_inverse_matches_setk_tpu():
    """The eigh-based plain path against the JAX one, with the bars of
    test_pallas.py:266-276, near-singular matrices included; the port's
    plain Jacobi against the same reference on the full-rank ones."""
    rng = np.random.default_rng(2)
    a = _covars(rng, 37, 6, singular=12)
    got_inv, got_ld = tla.regularized_inverse(torch.from_numpy(a),
                                              return_logdet=True)
    ref_inv, ref_ld = jax_reg_inverse(jnp.asarray(a), return_logdet=True,
                                      use_pallas=False)
    ref_inv, ref_ld = np.asarray(ref_inv), np.asarray(ref_ld)
    err = _peak_errs(_np(got_inv), ref_inv)
    assert err[:12].max() < 0.3 and err[12:].max() < 5e-3
    np.testing.assert_allclose(_np(got_ld)[12:], ref_ld[12:], rtol=1e-3,
                               atol=5e-3)
    np.testing.assert_allclose(_np(got_ld)[:12], ref_ld[:12], atol=0.5)
    assert _np(tla.regularized_inverse(torch.from_numpy(a))).shape == a.shape
    jac_inv, _ = es.jacobi_regularized_inverse_plain(torch.from_numpy(a))
    assert _peak_errs(_np(jac_inv), ref_inv)[12:].max() < 5e-3


@pytest.mark.parametrize("m", [2, 4, 6])
def test_inverse_plain_matches_pallas_and_setk_tpu(m):
    """Kernel 14's plain version (round-robin sweeps with the stop, at most
    6) against the Pallas Jacobi in interpret mode and the JAX eigh-based
    regularized_inverse, test_jacobi_plain_matches_pallas' bars: 1e-5 of
    each matrix's peak on full-rank matrices (logdet atol 1e-5), the
    structural bars of test_pallas.py:266-276 on rank-one ones."""
    rng = np.random.default_rng(20 + m)
    a = _covars(rng, 30, m, singular=10)
    got_inv, got_ld = es.regularized_inverse_plain(torch.from_numpy(a))
    pallas = regularized_inverse_pallas(jnp.asarray(a), return_logdet=True,
                                        interpret=True)
    xla = jax_reg_inverse(jnp.asarray(a), return_logdet=True,
                          use_pallas=False)
    for ref_inv, ref_ld in (pallas, xla):
        err = _peak_errs(_np(got_inv), np.asarray(ref_inv))
        assert err[10:].max() < 1e-5
        np.testing.assert_allclose(_np(got_ld)[10:],
                                   np.asarray(ref_ld)[10:], atol=1e-5)
        assert err[:10].max() < 0.3
        np.testing.assert_allclose(_np(got_ld)[:10],
                                   np.asarray(ref_ld)[:10], atol=0.5)


def test_cgmm_resume_through_the_card_branch_matches_setk_tpu(
        monkeypatch):
    """A CGMM resume (4 iterations from a JAX state, then 5 resumed) with
    ops.linalg's card branch taken on CPU tensors, so every regularized
    inverse of the scan and the predict is kernel 14's plain version,
    against the JAX resume on the same well-conditioned scene: masks
    within 2e-3 (chip_smoke.py C3's card-vs-CPU bar)."""
    rng = np.random.default_rng(12)
    obs = _scene(rng, 2, m=4)
    _, _, jstate = jc.cgmm_em(obs, 2, num_iters=4, return_state=True,
                              use_fused=False)
    jstate = {k: np.array(v) for k, v in jstate.items()}
    ref, _ = jc.cgmm_em(obs, 2, num_iters=5, state=jstate)
    calls = []
    plain = es.regularized_inverse

    def counted(covar, *args, **kwargs):
        calls.append(tuple(covar.shape))
        return plain(covar, *args, **kwargs)

    monkeypatch.setattr(tla, "_on_card", lambda x: True)
    monkeypatch.setattr(tla, "jacobi_inverse", counted)
    got, _ = tc.cgmm_em(obs, 2, num_iters=5, device="cpu",
                        state=em_state_from_numpy(jstate, "cpu"))
    assert len(calls) == 6 and calls[0] == (2, 2, 12, 4, 4)
    assert np.abs(_np(got) - np.asarray(ref)).max() <= 2e-3


# ---- kernel 15 ----

# (model, entry, K, frame mask): both models and entries, a padded tail
# masked off, K = 3
EM_CASES = [("cacg", "operand", 2, False), ("cg", "operand", 2, False),
            ("cg", "higuchi", 2, False), ("cacg", "higuchi", 2, True),
            ("cacg", "operand", 2, True), ("cacg", "operand", 3, False)]


@pytest.mark.parametrize("model,entry,k,masked", EM_CASES)
def test_em_plain_matches_pallas(model, entry, k, masked):
    """Kernel 15's plain version against the Pallas EM in interpret mode,
    4 iterations (B=2, F=24, M=3, T=16), the same algorithm: measured
    <= 4e-6 on gamma, alpha and the covariances, <= 4e-7 on Q, so the
    bars sit 10-50x under test_pallas.py:520-528's."""
    rng = np.random.default_rng(k * 10 + len(entry))
    b, f, m, t, iters = 2, 24, 3, 16, 4
    obs = _cplx(rng, b, f, m, t)
    obs[:, :, 1:] += 0.5 * obs[:, :, :1]
    fm = None
    if masked:
        obs[..., 12:] = 1e-6
        fm = np.zeros((b, 1, t), np.float32)
        fm[..., :12] = 1.0
    if model == "cacg":
        obs = np.asarray(jc.norm_observation(jnp.asarray(obs), axis=-2))
    g0 = rng.random((k, b, f, t)).astype(np.float32)
    g0 /= g0.sum(0)
    k0 = np.ones((k, b, f, t), np.float32)
    if model == "cg" and entry == "operand":
        k0 = (0.5 + rng.random((k, b, f, t))).astype(np.float32)
    ops = (None, None) if entry == "higuchi" else (g0, k0)
    init = "higuchi" if entry == "higuchi" else None
    pallas = cgmm_em_pallas if model == "cg" else cacgmm_em_pallas
    ref_g, ref_q, ref_st = pallas(
        jnp.asarray(obs), *(None if x is None else jnp.asarray(x)
                            for x in ops), iters,
        update_alpha=model == "cacg", init=init,
        frame_mask=None if fm is None else jnp.asarray(fm),
        return_state=True, interpret=True)
    got_g, got_q, got_st = ce.em_plain(
        torch.from_numpy(obs), *(None if x is None else torch.from_numpy(x)
                                 for x in ops), iters, model,
        model == "cacg", frame_mask=None if fm is None else
        torch.from_numpy(fm), return_state=True, init=init, num_classes=k)
    valid = slice(None, 12 if masked else t)
    np.testing.assert_allclose(_np(got_g)[..., valid],
                               np.asarray(ref_g)[..., valid], atol=1e-4)
    np.testing.assert_allclose(_np(got_q), np.asarray(ref_q), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(got_st["alpha"]),
                               np.asarray(ref_st["alpha"]), atol=1e-4)
    ref_c = np.asarray(ref_st["covar"])
    np.testing.assert_allclose(_np(got_st["covar"]), ref_c,
                               atol=1e-4 * np.abs(ref_c).max())
    if model == "cg":
        ref_phi = np.asarray(ref_st["phi"])[..., valid]
        np.testing.assert_allclose(_np(got_st["phi"])[..., valid], ref_phi,
                                   rtol=1e-4, atol=1e-4 * ref_phi.max())


def test_em_rejects_bad_calls():
    obs = torch.zeros((4, 2, 8), dtype=torch.complex64)
    g = torch.full((2, 4, 8), 0.5)
    with pytest.raises(ValueError, match="num_iters"):
        ce.em(obs, g, g, 0, "cacg", True)
    with pytest.raises(ValueError, match="Higuchi"):
        ce.em(obs, None, None, 2, "cg", False, init="higuchi", num_classes=3)
    with pytest.raises(ValueError, match="gamma0/kernel0"):
        ce.em(obs, g[:, :2], g, 2, "cacg", True)
    assert ce.em_fused_supported((4, 8, 8), 4, 1)
    assert not ce.em_fused_supported((4, 9, 8), 2, 1)
    assert not ce.em_fused_supported((4, 8, 8), 5, 1)
    assert not ce.em_fused_supported((4, 8, 8), 2, 0)


# ---- cgmm_em / cacgmm_em ----

@pytest.mark.parametrize("init", ["higuchi", "gamma_init", "frame_mask"])
def test_cgmm_em_scan_matches_setk_tpu(init):
    """The scan (use_fused=False) against the JAX scan, 5 iterations,
    with the state returned; both eigh-based on the CPU, apart in the
    rounding only (measured <= 8e-6 on gamma, 2e-7 on Q)."""
    rng = np.random.default_rng(3)
    obs = _scene(rng, 2)
    kw, tkw = {}, {}
    if init == "gamma_init":
        g = rng.random((2, 2, 12, 40)).astype(np.float32)
        kw["gamma_init"] = g / g.sum(0)
        tkw["gamma_init"] = kw["gamma_init"]
    if init == "frame_mask":
        fm = np.ones((2, 1, 40), np.float32)
        fm[1, 0, 30:] = 0.0
        kw["frame_mask"] = fm
        tkw["frame_mask"] = fm
    ref_g, ref_q, ref_st = jc.cgmm_em(obs, 2, num_iters=5,
                                      return_state=True, use_fused=False,
                                      **kw)
    got_g, got_q, got_st = tc.cgmm_em(obs, 2, num_iters=5, return_state=True,
                                      use_fused=False, device="cpu", **tkw)
    np.testing.assert_allclose(_np(got_g), np.asarray(ref_g), atol=1e-4)
    np.testing.assert_allclose(_np(got_q), np.asarray(ref_q), rtol=1e-5,
                               atol=1e-5)
    for key in ("phi", "covar", "alpha"):
        ref = np.asarray(ref_st[key])
        np.testing.assert_allclose(_np(got_st[key]), ref,
                                   atol=1e-4 * np.abs(ref).max(), rtol=1e-4)


@pytest.mark.parametrize("init", ["cgmm_init", "gamma_init", "frame_mask"])
def test_cacgmm_em_scan_matches_setk_tpu(init):
    rng = np.random.default_rng(4)
    obs = _scene(rng, 2)
    kw = {"cgmm_init": init != "gamma_init"}
    if init == "gamma_init":
        g = rng.random((2, 2, 12, 40)).astype(np.float32)
        kw["gamma_init"] = g / g.sum(0)
    if init == "frame_mask":
        fm = np.ones((2, 1, 40), np.float32)
        fm[0, 0, 25:] = 0.0
        kw["frame_mask"] = fm
    ref_g, ref_q, ref_st = jc.cacgmm_em(obs, 2, num_iters=5,
                                        return_state=True, use_fused=False,
                                        **kw)
    got_g, got_q, got_st = tc.cacgmm_em(obs, 2, num_iters=5,
                                        return_state=True, use_fused=False,
                                        device="cpu", **kw)
    np.testing.assert_allclose(_np(got_g), np.asarray(ref_g), atol=1e-4)
    np.testing.assert_allclose(_np(got_q), np.asarray(ref_q), rtol=1e-5,
                               atol=1e-5)
    for key in ("covar", "alpha"):
        ref = np.asarray(ref_st[key])
        np.testing.assert_allclose(_np(got_st[key]), ref,
                                   atol=1e-4 * np.abs(ref).max(), rtol=1e-4)


@pytest.mark.parametrize("algo", ["cgmm", "cacgmm"])
def test_state_resume_crosses_packages(algo):
    """A state from either package, carried by convert.py, resumes in the
    other as in its own (numpy complex64/float32 in between)."""
    rng = np.random.default_rng(5)
    obs = _scene(rng, 2)
    jem = jc.cgmm_em if algo == "cgmm" else jc.cacgmm_em
    tem = tc.cgmm_em if algo == "cgmm" else tc.cacgmm_em
    kw = {} if algo == "cgmm" else {"cgmm_init": True}
    _, _, jstate = jem(obs, 2, num_iters=4, return_state=True,
                       use_fused=False, **kw)
    _, _, tstate = tem(obs, 2, num_iters=4, return_state=True,
                       use_fused=False, device="cpu", **kw)
    jnp_state = {k: np.asarray(v) for k, v in jstate.items()}
    t_np = em_state_to_numpy(tstate)
    assert set(t_np) == set(jnp_state)
    for key, val in t_np.items():
        assert val.dtype == (np.complex64 if key == "covar" else np.float32)
        np.testing.assert_allclose(val, jnp_state[key],
                                   atol=1e-4 * np.abs(val).max(), rtol=1e-4)
    # JAX state -> port, port state -> JAX
    got, got_q = tem(obs, 2, num_iters=3, device="cpu",
                     state=em_state_from_numpy(jnp_state, "cpu"))
    ref, ref_q = jem(obs, 2, num_iters=3, state=jnp_state)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(_np(got_q), np.asarray(ref_q), rtol=1e-5,
                               atol=1e-5)
    ref2, _ = jem(obs, 2, num_iters=3, state=t_np)
    np.testing.assert_allclose(_np(got), np.asarray(ref2), atol=1e-4)


@pytest.mark.parametrize("algo", ["cgmm", "cacgmm"])
def test_fused_plain_matches_setk_tpu_scan(algo):
    """The fused dispatch on the CPU (kernel 15's plain version, its
    Jacobi and the Higuchi init inside) against the JAX scan (eigh):
    test_pallas.py's fused-vs-XLA bars, 4 iterations."""
    rng = np.random.default_rng(6)
    obs = _scene(rng, 2)
    kw = {} if algo == "cgmm" else {"cgmm_init": True}
    jem = jc.cgmm_em if algo == "cgmm" else jc.cacgmm_em
    tem = tc.cgmm_em if algo == "cgmm" else tc.cacgmm_em
    ref_g, ref_q = jem(obs, 2, num_iters=4, use_fused=False, **kw)
    got_g, got_q = tem(obs, 2, num_iters=4, use_fused=True, device="cpu",
                       **kw)
    np.testing.assert_allclose(_np(got_g), np.asarray(ref_g), atol=2e-3)
    np.testing.assert_allclose(_np(got_q), np.asarray(ref_q), rtol=2e-3,
                               atol=1e-3)


@pytest.mark.parametrize("use_fused", [False, True])
def test_frame_masked_em_ignores_padding(use_fused):
    """tests/test_cluster.py:93-111's construction: 24 junk frames masked
    off leave the EM on the real 40 frames as it was."""
    rng = np.random.default_rng(7)
    obs = _spatial_mix(rng, m=3, f=8, t=40)
    gamma, _ = tc.cgmm_em(obs, 2, num_iters=8, use_fused=use_fused,
                          device="cpu")
    junk = (rng.standard_normal((8, 3, 24)) * 10).astype(np.complex64)
    padded = np.concatenate([obs, junk], axis=-1)
    fmask = np.zeros((8, 64), np.float32)
    fmask[:, :40] = 1.0
    gamma_p, _ = tc.cgmm_em(padded, 2, num_iters=8, frame_mask=fmask,
                            use_fused=use_fused, device="cpu")
    np.testing.assert_allclose(_np(gamma_p)[..., :40], _np(gamma), atol=2e-2)
    g1, _ = tc.cacgmm_em(obs, 2, num_iters=8, cgmm_init=True,
                         use_fused=use_fused, device="cpu")
    g2, _ = tc.cacgmm_em(padded, 2, num_iters=8, cgmm_init=True,
                         frame_mask=fmask, use_fused=use_fused, device="cpu")
    assert np.mean(np.abs(_np(g2)[..., :40] - _np(g1)) > 5e-2) < 0.02


def test_permu_aligner_matches_setk_tpu():
    """K = 3, F = 257: random masks with per-bin class swaps; the port's
    copy gives the JAX package's alignment exactly."""
    rng = np.random.default_rng(8)
    base = rng.random((3, 50, 257)).astype(np.float32)
    masks = base.copy()
    for f in range(257):
        masks[:, :, f] = masks[rng.permutation(3), :, f]
    got = tc.permu_aligner(masks)
    np.testing.assert_array_equal(got, jc.permu_aligner(masks))
    np.testing.assert_array_equal(
        tc.permu_aligner(masks.transpose(0, 2, 1), transpose=True),
        jc.permu_aligner(masks.transpose(0, 2, 1), transpose=True))
    with pytest.raises(ValueError, match="num_bins"):
        tc.permu_aligner(masks[..., :100])


@pytest.mark.parametrize("algo,kw", [("cgmm", {}),
                                     ("cacgmm", {"cgmm_init": True})])
def test_batch_clusterer_matches_setk_tpu(algo, kw):
    """Mixed lengths (T = 40, 33, 20 in frame buckets of 64 and 32, two
    utterances a batch) through both BatchClusterers."""
    rng = np.random.default_rng(9)
    utts = {f"u{i}": _scene(rng, t=t) for i, t in enumerate((40, 33, 20))}
    port = tex.BatchClusterer(algo=algo, num_iters=5, batch_size=2,
                              frame_bucket=32, device="cpu", **kw)
    ref = jex.BatchClusterer(algo=algo, num_iters=5, batch_size=2,
                             frame_bucket=32, **kw)
    got, want = {}, {}
    for key, obs in utts.items():
        got.update(port.add(key, obs))
        want.update(ref.add(key, obs))
    got.update(port.flush())
    want.update(ref.flush())
    assert set(got) == set(want) == set(utts)
    for key, obs in utts.items():
        assert got[key].shape == (2, 12, obs.shape[-1])
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-4)


# ---- the CUDA dispatch, torch.cuda mocked ----

@pytest.fixture
def mocked_card(monkeypatch):
    """torch.cuda reports a card, tensors stay on the CPU, and every
    entry of cluster.py that the dispatch can take records its calls."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tc, "_as_tensor",
                        lambda x, dev, dtype: torch.as_tensor(x).to(dtype))
    calls = []

    def record(name, fn):
        def wrapped(*args, **kwargs):
            calls.append((name, kwargs.get("init")))
            return fn(*args, **kwargs)
        monkeypatch.setattr(tc, name, wrapped)

    for name in ("cgmm_em_fused", "cacgmm_em_fused", "covar_stats",
                 "regularized_inverse"):
        record(name, getattr(tc, name))
    return calls


def test_cuda_dispatch_takes_the_fused_kernel(mocked_card):
    """On a CUDA device a fresh K=2 run is the fused EM with the Higuchi
    init inside; a random or given init hands its gamma to it; resume,
    use_fused=False and K > 4 take the scan (kernels 13 and 14 once an
    iteration, 14 once more for the resumed predict)."""
    calls = mocked_card
    rng = np.random.default_rng(10)
    obs = _spatial_mix(rng, m=3, f=8, t=24)
    gen = torch.Generator().manual_seed(0)
    _, _, state = tc.cgmm_em(obs, 2, num_iters=3, return_state=True)
    assert calls == [("cgmm_em_fused", "higuchi")]
    calls.clear()
    tc.cacgmm_em(obs, 2, num_iters=3, cgmm_init=True)
    assert calls == [("cacgmm_em_fused", "higuchi")]
    calls.clear()
    tc.cacgmm_em(obs, 2, num_iters=3, generator=gen)
    assert calls == [("cacgmm_em_fused", None)]
    calls.clear()
    tc.cgmm_em(obs, 3, num_iters=3, generator=gen)
    assert calls == [("covar_stats", None), ("regularized_inverse", None),
                     ("cgmm_em_fused", None)]
    calls.clear()
    tc.cgmm_em(obs, 2, num_iters=3, state=state)
    assert [c for c, _ in calls] == ["regularized_inverse"] + [
        "covar_stats", "regularized_inverse"] * 3
    calls.clear()
    tc.cacgmm_em(obs, 2, num_iters=2, cgmm_init=True, use_fused=False)
    assert "cacgmm_em_fused" not in [c for c, _ in calls]
    calls.clear()
    tc.cacgmm_em(obs, 5, num_iters=2, generator=gen)
    assert [c for c, _ in calls] == ["covar_stats",
                                     "regularized_inverse"] * 2


def test_cuda_refusals_come_before_any_copy(monkeypatch):
    """M > 8 on the card names ROADMAP queue 1 item 15 and num_iters < 1
    is a ValueError, before anything is copied; the same for
    BatchClusterer, whose constructor refuses num_iters < 1."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_copy(x, dev, dtype):
        raise AssertionError("copied to the card before refusing")

    monkeypatch.setattr(tc, "_as_tensor", no_copy)
    obs9 = np.zeros((8, 9, 16), np.complex64)
    for em in (tc.cgmm_em, tc.cacgmm_em):
        with pytest.raises(NotImplementedError, match="queue 1 item 15"):
            em(obs9, 2)
        with pytest.raises(ValueError, match="num_iters"):
            em(obs9[:, :4], 2, num_iters=0)
    clusterer = tex.BatchClusterer(algo="cgmm", batch_size=1)
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        clusterer.add("m9", obs9)
    with pytest.raises(ValueError, match="num_iters"):
        tex.BatchClusterer(num_iters=0)
    with pytest.raises(ValueError, match="algo"):
        tex.BatchClusterer(algo="gmm")
    # the port's own kernels on a CPU tensor never count a launch
    for fn in (mc.masked_covar, es.regularized_inverse, ce.em):
        assert fn.launches == 0


def test_linalg_and_covar_stats_on_cuda_refuse_m_over_8():
    """On a CUDA tensor covar_stats and regularized_inverse raise for
    more than 8 mics, naming ROADMAP queue 1 item 15."""
    class OnCuda:
        class device:
            type = "cuda"

        def __init__(self, *shape):
            self.shape = shape

    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        tla.regularized_inverse(OnCuda(3, 9, 9))
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        tbf.covar_stats(OnCuda(2, 9, 4), torch.ones((2, 4)))
