"""The plain versions of kernels 16-19 against setk_tpu's Pallas kernels.

Small shapes (N <= 4, taps <= 4, T <= 64, bins <= 12), inputs from numpy
seeds, the Pallas kernels in interpret mode (planar re/im outputs joined
into complex here):

- kernel 16 (``hermitian_solve_lanes_plain``) against
  ``hermitian_solve_lanes_pallas`` and the JAX ``hermitian_solve``
  (``use_pallas=False``) at n = 16 and 24, K = 1 and 4, hermitianized and
  exact-Gram (``assume_hermitian``) inputs: rtol 1e-3, atol 1e-4, the bar
  of tests/test_pallas.py's lane-Cholesky test;
- kernel 17 (``solve_wpe_gram_plain``) against ``solve_wpe_gram_pallas``
  over NK = 9, 10, 11, 12 and 30 (every residue of the TPU's unrolled
  substitution loops), a Gram wider than row0 + NK: plain rtol 1e-3, atol
  1e-4; equilibrated on a badly row-scaled Gram 5e-3 of the peak
  (tests/test_pallas.py's planar-solve bars);
- kernel 18 (``wpe_gram_plain``) against ``wpe_gram_pallas`` with
  ``use_g`` off and on, contexts 0-2 and an external lambda: 1e-5 of the
  planes' peak (f32 sums in another order; the TPU's three-term bf16
  split is f32-grade), and exactly Hermitian with a real diagonal;
- kernel 19 (``wpe_apply_plain``) against ``wpe_apply_pallas``: 1e-5 of
  the peak.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.ops.linalg import hermitian_solve as jax_hermitian_solve
from setk_tpu.ops.pallas.cholesky import (hermitian_solve_lanes_pallas,
                                          solve_wpe_gram_pallas)
from setk_tpu.ops.pallas.wpe_gram import wpe_apply_pallas, wpe_gram_pallas
from setk_tpu_torch.ops.cuda import cholesky as ch
from setk_tpu_torch.ops.cuda import wpe_gram as wg

GRAM_TOL = 1e-5


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _planes(x):
    return jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy())


def _joined(re_im):
    return np.asarray(re_im[0]) + 1j * np.asarray(re_im[1])


def _gram(rng, bins, cols, rank=6, load=0.5):
    a = _cplx(rng, bins, cols, rank)
    return (a @ a.conj().transpose(0, 2, 1) +
            load * np.eye(cols, dtype=np.complex64)).astype(np.complex64)


# ---- kernel 16 ----

@functools.lru_cache(maxsize=None)
def _lanes_case(n):
    """Three systems, one set nudged off Hermitian (the hermitianize on
    load), four right-hand sides, and the Pallas solutions of both the
    nudged and the exact Gram (``assume_hermitian``).  K = 1 is column 0:
    the solve treats the columns independently, so one interpret-mode
    compile serves K = 1 and K = 4."""
    rng = np.random.default_rng(n)
    a = _gram(rng, 3, n, rank=8, load=2.0)
    b = _cplx(rng, 3, n, 4)
    a_off = (a + 1e-3 * _cplx(rng, 3, n, n)).astype(np.complex64)
    refs = {assume: np.asarray(hermitian_solve_lanes_pallas(
        jnp.asarray(mat), jnp.asarray(b), assume_hermitian=assume,
        interpret=True)) for mat, assume in ((a_off, False), (a, True))}
    return a, a_off, b, refs


@pytest.mark.parametrize("n,k", [(16, 1), (16, 4), (24, 1), (24, 4)])
def test_hermitian_solve_lanes_plain_matches_pallas(n, k):
    a, a_off, b, refs = _lanes_case(n)
    b = np.ascontiguousarray(b[..., :k])
    for mat, assume in ((a_off, False), (a, True)):
        got = ch.hermitian_solve_lanes_plain(
            torch.from_numpy(mat), torch.from_numpy(b),
            assume_hermitian=assume).numpy()
        np.testing.assert_allclose(got, refs[assume][..., :k], rtol=1e-3,
                                   atol=1e-4)
    ref_xla = np.asarray(jax_hermitian_solve(jnp.asarray(a_off),
                                             jnp.asarray(b),
                                             use_pallas=False))
    got = ch.hermitian_solve_lanes_plain(torch.from_numpy(a_off),
                                         torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref_xla, rtol=1e-3, atol=1e-4)


# ---- kernel 17 ----

@pytest.mark.parametrize("nk", [9, 10, 11, 12, 30])
def test_solve_wpe_gram_plain_matches_pallas(nk):
    rng = np.random.default_rng(nk)
    bins, n0 = 5, 3
    cols = n0 + nk
    g = cols + 2                        # a Gram wider than the system
    gram = np.zeros((bins, g, g), np.complex64)
    gram[:, :cols, :cols] = _gram(rng, bins, cols)
    got = ch.solve_wpe_gram_plain(torch.from_numpy(gram), n0, nk, n0).numpy()
    ref = _joined(solve_wpe_gram_pallas(*_planes(gram), row0=n0, n=nk, k=n0,
                                        interpret=True))
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    # the WPD regime: rows scaled over ~5 decades, equilibrated
    scale = np.exp(rng.uniform(-6, 6, size=(bins, g))).astype(np.float32)
    gram_s = (gram * scale[:, :, None] * scale[:, None, :]).astype(
        np.complex64)
    got = ch.solve_wpe_gram_plain(torch.from_numpy(gram_s), n0, nk, n0,
                                  eps_rel=1e-5, equilibrate=True).numpy()
    ref = _joined(solve_wpe_gram_pallas(*_planes(gram_s), row0=n0, n=nk,
                                        k=n0, eps_rel=1e-5,
                                        equilibrate=True, interpret=True))
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 5e-3


def test_solve_plains_agree_with_torch_linalg():
    """The two plain solves are one column loop: against the loaded
    torch.linalg solve, with each one's loading, and an empty Gram row
    (scale 1 under equilibration) solving to exactly 0."""
    rng = np.random.default_rng(3)
    n, k = 20, 3
    gram = torch.from_numpy(_gram(rng, 4, k + n))
    corr, cross = gram[:, k:, k:], gram[:, k:, :k]
    tr = torch.diagonal(corr, dim1=-2, dim2=-1).real.sum(-1)
    eye = torch.eye(n, dtype=gram.dtype)
    ref = torch.linalg.solve(
        corr + ((1e-6 / n) * tr + 1.1920929e-07)[:, None, None] * eye, cross)
    for got in (ch.hermitian_solve_lanes_plain(corr, cross),
                ch.solve_wpe_gram_plain(gram, k, n, k)):
        assert float((got - ref).abs().max() / ref.abs().max()) < 1e-4
    gram[:, k + 2, :] = 0
    gram[:, :, k + 2] = 0
    x_eq = ch.solve_wpe_gram_plain(gram, k, n, k, eps_rel=1e-4,
                                   equilibrate=True)
    assert torch.isfinite(x_eq).all()
    assert float(x_eq[:, 2].abs().max()) == 0.0


# ---- kernels 18 and 19 ----

def _wpe_inputs(seed, bins=6, n=3, t=40, taps=4):
    rng = np.random.default_rng(seed)
    obs = _cplx(rng, bins, n, t)
    obs[..., 5:] += 0.4 * obs[..., :-5]
    g = 0.1 * _cplx(rng, bins, n * taps, n)
    lam = (rng.random((bins, t)) + 0.1).astype(np.float32)
    return obs, g, lam


@pytest.mark.parametrize("use_g,external,context", [
    (False, False, 1), (True, False, 1), (True, False, 0),
    (True, False, 2), (False, True, 0)])
def test_wpe_gram_plain_matches_pallas(use_g, external, context):
    taps, delay = 4, 2
    obs, g, lam = _wpe_inputs(context + 10 * use_g, taps=taps)
    n = obs.shape[1]
    got = wg.wpe_gram_plain(torch.from_numpy(obs), torch.from_numpy(g), taps,
                            delay, context, use_g,
                            torch.from_numpy(lam) if external else None)
    ref = _joined(wpe_gram_pallas(
        *_planes(obs), *_planes(g), n=n, taps=taps, delay=delay,
        context=context, use_g=use_g,
        lam=jnp.asarray(lam) if external else None, interpret=True))
    got = got.numpy()
    assert got.shape == ref.shape == (6, (taps + 1) * n, (taps + 1) * n)
    assert np.abs(got - ref).max() <= GRAM_TOL * np.abs(ref).max()
    np.testing.assert_array_equal(got, got.conj().transpose(0, 2, 1))
    assert (np.diagonal(got, axis1=1, axis2=2).imag == 0).all()


def test_wpe_apply_plain_matches_pallas():
    taps, delay = 3, 1
    obs, g, _ = _wpe_inputs(7, bins=5, n=4, t=33, taps=taps)
    got = wg.wpe_apply_plain(torch.from_numpy(obs), torch.from_numpy(g),
                             taps, delay).numpy()
    ref = _joined(wpe_apply_pallas(*_planes(obs), *_planes(g), n=4,
                                   taps=taps, delay=delay, interpret=True))
    assert np.abs(got - ref).max() <= GRAM_TOL * np.abs(ref).max()


def test_fused_gate_and_tap_rows():
    """The port's own gate (not the TPU's 72-row padding) and the tap
    order of compute_tap_mat, zero before the first frame and for taps
    past the end."""
    assert wg.wpe_fused_supported(6, 10) and wg.wpe_fused_supported(8, 16)
    assert not wg.wpe_fused_supported(9, 2)
    assert not wg.wpe_fused_supported(8, 17)
    obs = torch.arange(2 * 5, dtype=torch.float32).reshape(2, 5).to(
        torch.complex64)
    rows = wg.tap_rows(obs, taps=3, delay=2)
    assert rows.shape == (6, 5)
    np.testing.assert_array_equal(rows[0].real.numpy(), [0, 0, 0, 1, 2])
    np.testing.assert_array_equal(rows[3].real.numpy(), [0, 0, 0, 5, 6])
    np.testing.assert_array_equal(rows[5].real.numpy(), [0, 0, 0, 0, 5])
    assert wg.tap_rows(obs, taps=2, delay=5).abs().max() == 0
