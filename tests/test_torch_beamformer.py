"""setk_tpu_torch linear algebra, PSDs and MVDR weights against setk_tpu.

Covariances, weights and BAN at 1e-4 relative to the largest entry
(float32 sums in another order); the per-bin MVDR solve against the
Pallas kernel in interpret mode at the JAX package's own bar for that
kernel (rtol 2e-3, atol 1e-4, tests/test_pallas.py:47-54).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.enhance import beamformer as jbf
from setk_tpu.ops import linalg as jla
from setk_tpu.ops.pallas.mvdr import mvdr_power_pallas
from setk_tpu_torch.enhance import beamformer as tbf
from setk_tpu_torch.ops import linalg as tla
from setk_tpu_torch.ops.cuda import mvdr as tmv

REL = 1e-4


def _obs(seed, b=2, f=24, n=4, t=96):
    rng = np.random.default_rng(seed)
    obs = (rng.standard_normal((b, f, n, t)) +
           1j * rng.standard_normal((b, f, n, t))).astype(np.complex64)
    mask = rng.random((b, f, t)).astype(np.float32)
    return obs, mask


def _covars(seed, **kw):
    obs, mask = _obs(seed, **kw)
    rs, rn = jbf.compute_covar_pair(jnp.asarray(obs), jnp.asarray(mask),
                                    use_pallas=False)
    return obs, mask, np.array(rs), np.array(rn)


def _close(got, ref, rel=REL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, f"relative error {err} > {rel}"


def test_covar_pair_matches():
    obs, mask = _obs(0)
    rs_j, rn_j = jbf.compute_covar_pair(jnp.asarray(obs), jnp.asarray(mask),
                                        use_pallas=False)
    rs, rn = tbf.compute_covar_pair(torch.from_numpy(obs),
                                    torch.from_numpy(mask))
    _close(rs, rs_j)
    _close(rn, rn_j)
    mask_n = np.random.default_rng(9).random(mask.shape).astype(np.float32)
    _, rn_j = jbf.compute_covar_pair(jnp.asarray(obs), jnp.asarray(mask),
                                     jnp.asarray(mask_n), use_pallas=False)
    _, rn = tbf.compute_covar_pair(torch.from_numpy(obs),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(mask_n))
    _close(rn, rn_j)
    num, den = tbf.covar_stats(torch.from_numpy(obs), torch.from_numpy(mask))
    num_j, den_j = jbf.covar_stats(jnp.asarray(obs), jnp.asarray(mask),
                                   use_pallas=False)
    _close(num, num_j)
    _close(den, den_j)


def test_linalg_matches():
    _, _, rs, rn = _covars(1)
    rhs = (np.random.default_rng(2).standard_normal(rs.shape[:-1]) *
           (1 + 1j)).astype(np.complex64)
    ts, tn, tb = (torch.from_numpy(x) for x in (rs, rn, rhs))
    _close(tla.hermitianize(ts), jla.hermitianize(jnp.asarray(rs)))
    _close(tla.hermitian_solve(tn, tb),
           jla.hermitian_solve(jnp.asarray(rn), jnp.asarray(rhs),
                               use_pallas=False))
    _close(tla.equilibrated_hermitian_solve(tn, tb),
           jla.equilibrated_hermitian_solve(jnp.asarray(rn),
                                            jnp.asarray(rhs)))
    _close(tla.power_iteration(tla.hermitianize(ts), num_iters=15),
           jla.power_iteration(jla.hermitianize(jnp.asarray(rs)),
                               num_iters=15))
    # the principal eigenvector is defined up to phase: compare projectors
    v = tla.solve_pevd(ts).numpy()
    vj = np.asarray(jla.solve_pevd(jnp.asarray(rs)))
    _close(np.einsum("...a,...b->...ab", v, v.conj()),
           np.einsum("...a,...b->...ab", vj, vj.conj()))


@pytest.mark.parametrize("steer", ["power", "eigh"])
def test_mvdr_weights_match(steer):
    _, _, rs, rn = _covars(3)
    got = tbf.mvdr_weights(torch.from_numpy(rs), torch.from_numpy(rn),
                           steer=steer)
    ref = jbf.mvdr_weights(jnp.asarray(rs), jnp.asarray(rn), steer=steer,
                           use_pallas=False)
    _close(got, ref)
    _close(tbf.fix_steer_phase(got), jbf.fix_steer_phase(ref))


def test_ban_and_beamform_match():
    obs, mask, rs, rn = _covars(4)
    w = np.array(jbf.mvdr_weights(jnp.asarray(rs), jnp.asarray(rn),
                                  steer="power", use_pallas=False))
    _close(tbf.do_ban(torch.from_numpy(w), torch.from_numpy(rn)),
           jbf.do_ban(jnp.asarray(w), jnp.asarray(rn)))
    _close(tbf.beamform(torch.from_numpy(w), torch.from_numpy(obs)),
           jbf.beamform(jnp.asarray(w), jnp.asarray(obs)))


@pytest.mark.parametrize("steer,ban", [("power", False), ("eigh", True)])
def test_supervised_run_matches(steer, ban):
    obs, mask = _obs(5)
    got = tbf.supervised_run("mvdr", torch.from_numpy(obs),
                             torch.from_numpy(mask), ban=ban, steer=steer)
    ref = jbf.supervised_run("mvdr", jnp.asarray(obs), jnp.asarray(mask),
                             ban=ban, steer=steer, use_pallas=False)
    _close(got, ref)


def test_other_beamformers_raise():
    obs, mask = _obs(6, b=1, f=4, n=2, t=16)
    for name in ("gevd", "pmwf-0", "mpdr"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tbf.supervised_run(name, torch.from_numpy(obs),
                               torch.from_numpy(mask))


def test_mvdr_power_plain_matches_pallas_kernel():
    """The kernel's plain version against the Pallas kernel (interpret)."""
    _, _, rs, rn = _covars(7, b=2, f=37, n=6, t=128)
    got = tmv.mvdr_power_plain(torch.from_numpy(rs), torch.from_numpy(rn))
    ref = np.asarray(mvdr_power_pallas(jnp.asarray(rs), jnp.asarray(rn),
                                       interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-3, atol=1e-4)
    # a CPU tensor takes the plain version and launches nothing
    before = tmv.mvdr_power.launches
    np.testing.assert_array_equal(
        tmv.mvdr_power(torch.from_numpy(rs), torch.from_numpy(rn)).numpy(),
        got.numpy())
    assert tmv.mvdr_power.launches == before


def test_mvdr_power_plain_distortionless_and_degenerate():
    _, _, rs, rn = _covars(8)
    ts = torch.from_numpy(rs)
    w = tmv.mvdr_power_plain(ts, torch.from_numpy(rn))
    d = tbf.fix_steer_phase(tla.power_iteration(tla.hermitianize(ts),
                                                num_iters=15))
    resp = (w.conj() * d).sum(-1)
    np.testing.assert_allclose(resp.numpy(), np.ones(resp.shape),
                               rtol=1e-3, atol=1e-3)
    # rank-deficient noise and all-zero bins stay finite
    rn0 = np.zeros_like(rn)
    rn0[..., 0, 0] = 1.0
    w0 = tmv.mvdr_power_plain(ts, torch.from_numpy(rn0))
    assert torch.isfinite(torch.view_as_real(w0)).all()
    wz = tmv.mvdr_power_plain(torch.zeros_like(ts), torch.zeros_like(ts))
    assert torch.isfinite(torch.view_as_real(wz)).all()
