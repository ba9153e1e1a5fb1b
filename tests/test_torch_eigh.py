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


@pytest.mark.parametrize("m", range(1, 9))
def test_schedule_rounds_are_disjoint_and_cover_every_pair(m):
    """eigh_schedule: M - 1 rounds (M for odd M), each of disjoint pairs,
    every pair of 0..M-1 exactly once a sweep."""
    rounds = es.eigh_schedule(m)
    assert len(rounds) == max(m + (m & 1) - 1, 1)
    seen = []
    for pairs in rounds:
        members = [i for pair in pairs for i in pair]
        assert len(members) == len(set(members))
        assert all(0 <= i < m and x != y for x, y in pairs for i in (x, y))
        seen += [frozenset(pair) for pair in pairs]
    assert sorted(seen, key=sorted) == sorted(
        (frozenset((p, q)) for p in range(m) for q in range(p + 1, m)),
        key=sorted)


@pytest.mark.parametrize("m", range(1, 9))
def test_converged_matrices_take_no_sweep(m):
    """A zero, a scaled identity, a diagonal with distinct entries and one
    with ties take 0 sweeps: V = I up to the ascending order, ties in
    index order; beside them full-rank matrices stop before the cap and
    give the same bits with a higher one."""
    rng = np.random.default_rng(40 + m)
    a = _hermitian(rng, 8, m, m + 2)
    a[0] = 0
    a[1] = 0.7 * np.eye(m)
    a[2] = np.diag(np.arange(m, 0, -1) * 0.3)
    a[3] = np.diag(np.array([0.5, 2.0] * m)[:m])
    at = torch.from_numpy(a)
    taken = es.eigh_sweeps_needed(at).numpy()
    assert (taken[:4] == 0).all()
    assert (taken[4:] < es.EIGH_SWEEPS).all()
    assert (taken[4:] > 0).all() if m > 1 else (taken[4:] == 0).all()
    w, v = (x.numpy() for x in es.hermitian_eigh_plain(at))
    eye = np.eye(m, dtype=np.complex64)
    for k in range(4):
        order = np.argsort(np.diag(a[k]).real, kind="stable")
        assert np.array_equal(v[k], eye[:, order])
        assert np.array_equal(w[k], np.diag(a[k]).real[order])
    for got, ref in zip(es.hermitian_eigh_plain(at),
                        es.hermitian_eigh_plain(at, sweeps=20)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("gen", [False, True])
def test_zero_sweeps_give_the_sorted_diagonal(gen):
    """sweeps = 0: no rotation, w the sorted diagonal of herm(a) (of the
    whitened a with b) and V = I in that order (L^{-H} in that order with
    b); every matrix counts 0 sweeps."""
    a, rng = _cases(6, 70 + gen)
    at = torch.from_numpy(a)
    bt = torch.from_numpy(_hermitian(rng, 12, 6, 9)) if gen else None
    w, v = es.hermitian_eigh_plain(at, bt, sweeps=0)
    assert int(es.eigh_sweeps_needed(at, bt, sweeps=0).max()) == 0
    if gen:
        # V = L^{-H} in the order of C's diagonal: v^H B v = I (up to the
        # loading) and the diagonal of v^H A v is w, ascending
        vh = v.conj().transpose(-1, -2)
        eye = torch.eye(6, dtype=torch.complex64)
        assert float((vh @ bt @ v - eye).abs().max()) < 1e-4
        got = (vh @ at @ v).diagonal(0, -2, -1).real
        assert float(((got - w).abs().amax(-1) /
                      w.abs().amax(-1).clamp(min=1e-30)).max()) < TOL
        assert bool((w[:, 1:] >= w[:, :-1]).all())
        return
    diag = np.diagonal(a, 0, -2, -1).real
    order = np.argsort(diag, axis=-1, kind="stable")
    assert np.array_equal(w.numpy(), np.take_along_axis(diag, order, -1))
    eye = np.eye(6, dtype=np.complex64)
    assert all(np.array_equal(v.numpy()[k], eye[:, order[k]])
               for k in range(12))


def test_hermitian_eigh_refuses_an_unknown_form():
    a = torch.zeros((2, 3, 3), dtype=torch.complex64)
    with pytest.raises(ValueError, match="form"):
        es.hermitian_eigh(a, form="warp")
    assert es.hermitian_eigh(a, form="lanes")[0].shape == (2, 3)


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
