"""The supervised beamformer family of setk_tpu_torch against setk_tpu.

gevd, pmwf-0/1, mpdr and mpdr-whiten (with and without BAN) on the CPU,
inputs made with numpy and handed to both packages:

- the generalized EVD: eigenvalues within 1e-4 of the peak, v^H B v = I
  within 1e-4 (f32 Cholesky whitening of a well-conditioned B);
- the weights and ``supervised_run`` against ``setk_tpu.enhance.
  beamformer`` within 1e-3 of the peak, the JAX package's CPU parity bar,
  on a structured scene (a steered source in bursts, masks that follow
  it): with random masks Rs and Rn are nearly proportional and the
  generalized eigenvectors are not unique;
- the three solve kernels' plain versions against the Pallas kernels in
  interpret mode within 1e-4 of the peak (the same f32 recurrences), and
  ``gevd_power_plain`` on random covariances to the JAX package's
  Rayleigh-quotient contract (tests/test_pallas.py:452-481).

The family end to end is in tests/test_torch_family_slice.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.enhance import beamformer as jbf
from setk_tpu.ops import linalg as jla
from setk_tpu.ops.pallas.mvdr import (capon_pallas, gevd_power_pallas,
                                      pmwf_solve_pallas)
from setk_tpu_torch.enhance import beamformer as tbf
from setk_tpu_torch.ops import linalg as tla
from setk_tpu_torch.ops.cuda import mvdr as mv

FAMILY = ("gevd", "pmwf-0", "pmwf-1", "mpdr", "mpdr-whiten")
WEIGHT_TOL = 1e-3
KERNEL_TOL = 1e-4


def _peak_err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _structured(seed, b=2, f=16, n=4, t=96):
    """STFT-domain scene: a source with a random steer per bin, on in
    bursts of 8 frames, plus noise; the mask follows the bursts."""
    rng = np.random.default_rng(seed)

    def cnormal(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    gate = (np.arange(t) // 8) % 2 == 0
    obs = (cnormal(b, f, n, 1) * (cnormal(b, f, 1, t) * gate) +
           0.1 * cnormal(b, f, n, t)).astype(np.complex64)
    mask = np.broadcast_to(np.where(gate, 0.95, 0.05),
                           (b, f, t)).astype(np.float32)
    return obs, mask


def _covars(seed, **kw):
    obs, mask = _structured(seed, **kw)
    rs, rn = jbf.compute_covar_pair(jnp.asarray(obs), jnp.asarray(mask),
                                    use_pallas=False)
    return np.array(rs), np.array(rn)


def _random_covars(seed, b=1, f=37, n=4, t=128):
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((b, f, n, t)) +
           1j * rng.standard_normal((b, f, n, t))).astype(np.complex64)
    mask = rng.random((b, f, t)).astype(np.float32)
    rs, rn = jbf.compute_covar_pair(jnp.asarray(obs), jnp.asarray(mask),
                                    use_pallas=False)
    return np.array(rs), np.array(rn)


# ---- linear algebra ----

def test_generalized_eigh_matches_jax():
    rs, rn = _covars(0)
    w, v = tla.generalized_eigh(torch.from_numpy(rs), torch.from_numpy(rn))
    wj, vj = jla.generalized_eigh(jnp.asarray(rs), jnp.asarray(rn))
    assert _peak_err(w, wj) <= KERNEL_TOL
    vhbv = np.einsum("...ai,...ab,...bj->...ij", v.numpy().conj(), rn,
                     v.numpy())
    eye = np.broadcast_to(np.eye(rn.shape[-1]), vhbv.shape)
    assert np.abs(vhbv - eye).max() <= KERNEL_TOL
    # the principal vector is unique up to phase: anchor both to mic 0
    pv = tla.solve_pevd(torch.from_numpy(rs), torch.from_numpy(rn))
    pj = jla.solve_pevd(jnp.asarray(rs), jnp.asarray(rn))
    assert _peak_err(tbf.fix_steer_phase(pv),
                     jbf.fix_steer_phase(pj)) <= WEIGHT_TOL


# ---- weights ----

def test_gevd_and_rank1_match_jax():
    rs, rn = _covars(1)
    ts, tn = torch.from_numpy(rs), torch.from_numpy(rn)
    js, jn = jnp.asarray(rs), jnp.asarray(rn)
    assert _peak_err(tbf.gevd_weights(ts, tn),
                     jbf.gevd_weights(js, jn)) <= WEIGHT_TOL
    assert _peak_err(tbf.rank1_constraint(ts),
                     jbf.rank1_constraint(js)) <= WEIGHT_TOL
    assert _peak_err(tbf.rank1_constraint(ts, tn),
                     jbf.rank1_constraint(js, jn)) <= WEIGHT_TOL


@pytest.mark.parametrize("beta", [0.0, 1.0])
@pytest.mark.parametrize("ref_channel", [-1, 0])
@pytest.mark.parametrize("rank1", ["", "eig", "gev"])
def test_pmwf_weights_match_jax(beta, ref_channel, rank1):
    rs, rn = _covars(2)
    got = tbf.pmwf_weights(torch.from_numpy(rs), torch.from_numpy(rn),
                           beta=beta, ref_channel=ref_channel,
                           rank1_appro=rank1)
    ref = jbf.pmwf_weights(jnp.asarray(rs), jnp.asarray(rn), beta=beta,
                           ref_channel=ref_channel, rank1_appro=rank1)
    assert _peak_err(got, ref) <= WEIGHT_TOL


@pytest.mark.parametrize("whiten", [False, True])
def test_mpdr_weights_match_jax(whiten):
    obs, mask = _structured(3)
    rs, rn = _covars(3)
    ry = np.array(jbf.compute_covar(jnp.asarray(obs),
                                    jnp.ones_like(jnp.asarray(mask))))
    got = tbf.mpdr_weights(torch.from_numpy(rs), torch.from_numpy(ry),
                           rn=torch.from_numpy(rn) if whiten else None)
    ref = jbf.mpdr_weights(jnp.asarray(rs), jnp.asarray(ry),
                           rn=jnp.asarray(rn) if whiten else None)
    assert _peak_err(got, ref) <= WEIGHT_TOL


def test_pmwf_select_powers_matches_select_ref():
    rs, rn = _covars(4)
    ts, tn = torch.from_numpy(rs), torch.from_numpy(rn)
    wm, ps, pn = mv.pmwf_solve_plain(ts, tn, return_powers=True)
    ref = jbf.pmwf_select_powers(jnp.asarray(wm.numpy()),
                                 jnp.asarray(ps.numpy()),
                                 jnp.asarray(pn.numpy()))
    got = tbf.pmwf_select_powers(wm, ps, pn)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the in-kernel powers pick the column the einsum selection picks
    np.testing.assert_array_equal(
        got.numpy(), tbf.pmwf_select_ref(wm, ts, tn).numpy())


@pytest.mark.parametrize("name", FAMILY)
@pytest.mark.parametrize("ban", [False, True])
def test_supervised_run_family_matches_jax(name, ban):
    obs, mask = _structured(5)
    got = tbf.supervised_run(name, torch.from_numpy(obs),
                             torch.from_numpy(mask), ban=ban)
    ref = jbf.supervised_run(name, jnp.asarray(obs), jnp.asarray(mask),
                             ban=ban)
    assert _peak_err(got, ref) <= WEIGHT_TOL


# ---- the solve kernels' plain versions against the Pallas kernels ----

@pytest.mark.parametrize("iters", [30, 50])
def test_gevd_power_plain_matches_pallas_kernel(iters):
    rs, rn = _covars(6, b=1, f=24, n=3)
    got = mv.gevd_power_plain(torch.from_numpy(rs), torch.from_numpy(rn),
                              power_iters=iters)
    ref = gevd_power_pallas(jnp.asarray(rs), jnp.asarray(rn),
                            power_iters=iters, interpret=True)
    assert _peak_err(got, ref) <= KERNEL_TOL


def test_gevd_power_plain_rayleigh_contract():
    """Random covariances at the kernel's cap N = 8: the generalized
    Rayleigh quotient against the exact principal vector."""
    rs, rn = _random_covars(7, b=1, f=32, n=8)
    ts, tn = torch.from_numpy(rs), torch.from_numpy(rn)
    got = mv.gevd_power_plain(ts, tn, power_iters=30).numpy()
    ref = tla.solve_pevd(ts, tn).numpy()
    q = np.einsum("...a,...ab,...b->...", got.conj(), rn, got)
    np.testing.assert_allclose(q.real, 1.0, atol=2e-3)

    def rayleigh(v):
        num = np.einsum("...a,...ab,...b->...", v.conj(), rs, v).real
        den = np.einsum("...a,...ab,...b->...", v.conj(), rn, v).real
        return num / np.maximum(den, 1e-12)

    ratio = rayleigh(got) / np.maximum(rayleigh(ref), 1e-12)
    assert np.median(ratio) > 0.999 and ratio.min() > 0.95


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_pmwf_solve_plain_matches_pallas_kernel(beta):
    rs, rn = _random_covars(8)
    got = mv.pmwf_solve_plain(torch.from_numpy(rs), torch.from_numpy(rn),
                              beta=beta, return_powers=True)
    ref = pmwf_solve_pallas(jnp.asarray(rs), jnp.asarray(rn), beta=beta,
                            return_powers=True, interpret=True)
    for g, r in zip(got, ref):
        assert _peak_err(g, r) <= KERNEL_TOL
    # a CPU tensor takes the plain version and launches nothing
    before = mv.pmwf_solve.launches
    w = mv.pmwf_solve(torch.from_numpy(rs), torch.from_numpy(rn), beta=beta)
    np.testing.assert_array_equal(w.numpy(), got[0].numpy())
    assert mv.pmwf_solve.launches == before


def test_capon_plain_matches_pallas_kernel():
    rs, rn = _random_covars(9)
    rng = np.random.default_rng(10)
    d = (rng.standard_normal(rn.shape[:-1]) +
         1j * rng.standard_normal(rn.shape[:-1])).astype(np.complex64)
    got = mv.capon_plain(torch.from_numpy(d), torch.from_numpy(rn))
    ref = capon_pallas(jnp.asarray(d), jnp.asarray(rn), interpret=True)
    assert _peak_err(got, ref) <= KERNEL_TOL
    # distortionless towards d
    resp = (got.conj() * torch.from_numpy(d)).sum(-1)
    np.testing.assert_allclose(resp.numpy(), 1.0, atol=1e-4)
