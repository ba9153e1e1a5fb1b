"""The batched Hermitian EVD's plain version against the JAX package.

``hermitian_eigh_plain`` (the EVD kernel's plain version: cyclic Jacobi
on f32 planes, and in the generalized form the loaded Cholesky, the
whitening and the back substitution) against ``jnp.linalg.eigh`` and
``setk_tpu.ops.jacobi.jacobi_eigh``, and against
``setk_tpu.ops.linalg.generalized_eigh``, at M = 1-8 on well conditioned,
rank-one plus noise and all-zero matrices and with Rn = 0; then the
port's ``ops.linalg`` on a card (``_on_card`` patched, tensors on the
CPU): ``eigh``, ``generalized_eigh`` and ``solve_pevd`` go through the
kernel's wrapper and agree with setk_tpu's.  Bars: eigenvalues within
1e-5 of the peak; principal vectors within 1e-5 in direction
(|v^H v_ref| over the norms, an eigenvector's phase being arbitrary),
or equal after ``fix_steer_phase``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.enhance.beamformer import fix_steer_phase as jfix
from setk_tpu.ops import linalg as jla
from setk_tpu.ops.jacobi import jacobi_eigh
from setk_tpu_torch.enhance.beamformer import fix_steer_phase
from setk_tpu_torch.ops import linalg as tla
from setk_tpu_torch.ops.cuda import eigh_small as es

TOL = 1e-5


def _hermitian(rng, count, m, rank):
    x = (rng.standard_normal((count, m, rank)) +
         1j * rng.standard_normal((count, m, rank))).astype(np.complex64)
    return x @ x.conj().transpose(0, 2, 1)


def _cases(m, seed):
    """12 matrices: 8 well conditioned, 3 rank one plus noise at 1e-3,
    one all zero."""
    rng = np.random.default_rng(seed)
    a = _hermitian(rng, 12, m, m + 2)
    a[8:11] = _hermitian(rng, 3, m, 1) + 1e-3 * _hermitian(rng, 3, m, m)
    a[11] = 0
    return a, rng


def _peak_err(w, w_ref):
    peak = np.abs(w_ref).max(-1).clip(min=1e-30)
    return float((np.abs(w - w_ref).max(-1) / peak).max())


def _direction(v, v_ref):
    """1 - |cos| between principal vectors, per matrix."""
    v, v_ref = v[..., -1], v_ref[..., -1]
    cos = np.abs((v.conj() * v_ref).sum(-1)) / (
        np.linalg.norm(v, axis=-1) * np.linalg.norm(v_ref, axis=-1))
    return 1.0 - cos


@pytest.mark.parametrize("m", range(1, 9))
def test_plain_eigh_matches_jax(m):
    a, _ = _cases(m, m)
    w, v = (x.numpy() for x in es.hermitian_eigh_plain(torch.from_numpy(a)))
    for w_ref, v_ref in (jnp.linalg.eigh(a), jacobi_eigh(a)):
        w_ref, v_ref = np.asarray(w_ref), np.asarray(v_ref)
        assert _peak_err(w, w_ref) < TOL
        # the zero matrix has no principal direction: checked below
        assert float(_direction(v[:11], v_ref[:11]).max()) < TOL
    # the zero matrix: w = 0 and V = I, principal vector e_(M-1), as
    # LAPACK gives it
    assert np.array_equal(v[11], np.eye(m, dtype=np.complex64))
    assert np.array_equal(np.asarray(jnp.linalg.eigh(a[11])[1])[:, -1],
                          v[11][:, -1])
    assert np.array_equal(w[11], np.zeros(m, np.float32))


@pytest.mark.parametrize("m", range(1, 9))
def test_plain_generalized_eigh_matches_jax(m):
    a, rng = _cases(m, 10 + m)
    b = _hermitian(rng, 12, m, m + 3)
    b[0] = 0                                # Rn = 0: the loading alone
    w, v = (x.numpy() for x in es.hermitian_eigh_plain(
        torch.from_numpy(a), torch.from_numpy(b)))
    w_ref, v_ref = (np.asarray(x) for x in jla.generalized_eigh(a, b))
    assert _peak_err(w, w_ref) < TOL
    assert float(_direction(v[:11], v_ref[:11]).max()) < TOL
    # v^H B v = 1 on both sides: equal after the phase anchor
    got = np.asarray(fix_steer_phase(torch.from_numpy(v[..., -1])))
    ref = np.asarray(jfix(v_ref[..., -1]))
    scale = np.abs(ref[:11]).max(-1)
    assert float((np.abs(got[:11] - ref[:11]).max(-1) / scale).max()) < \
        TOL
    # the zero Rs: C = 0, U = I, v = L^{-H} e_(M-1) on both sides
    assert np.allclose(got[11], ref[11], rtol=TOL, atol=0)


@pytest.fixture
def card(monkeypatch):
    """ops.linalg as on a card, tensors on the CPU: every EVD goes through
    the kernel's wrapper (counted, around its plain version)."""
    calls = []

    def wrapped(a, b=None, sweeps=es.EIGH_SWEEPS, eps_rel=1e-6):
        calls.append("generalized" if b is not None else "eigh")
        return es.hermitian_eigh_plain(a, b, sweeps, eps_rel)

    monkeypatch.setattr(tla, "_on_card", lambda x: True)
    monkeypatch.setattr(tla, "hermitian_eigh", wrapped)
    return calls


@pytest.mark.parametrize("m", [1, 4, 6, 8])
def test_linalg_on_a_card_runs_the_kernel(card, m):
    a, rng = _cases(m, 30 + m)
    b = _hermitian(rng, 12, m, m + 3)
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    w, _ = tla.eigh(at)
    assert _peak_err(w.numpy(), np.asarray(jnp.linalg.eigh(a)[0])) < TOL
    w, _ = tla.generalized_eigh(at, bt)
    assert _peak_err(w.numpy(), np.asarray(jla.generalized_eigh(a, b)[0])) \
        < TOL
    for rn in (None, b):
        got = fix_steer_phase(tla.solve_pevd(
            at, None if rn is None else bt)).numpy()
        ref = np.asarray(jfix(jla.solve_pevd(a, rn)))
        scale = np.abs(ref[:11]).max(-1)
        assert float((np.abs(got[:11] - ref[:11]).max(-1) / scale).max()) \
            < TOL
    assert card == ["eigh", "generalized", "eigh", "generalized"]


def test_linalg_on_a_card_refuses_m_past_8(card):
    a = torch.zeros((2, 9, 9), dtype=torch.complex64)
    for call in (lambda: tla.eigh(a), lambda: tla.generalized_eigh(a, a),
                 lambda: tla.solve_pevd(a)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 15"):
            call()
    assert card == []
