"""The port's WPE dereverberation and factored WPD against setk_tpu.

Small shapes (N <= 4, taps <= 4, T <= 64, F <= 12), inputs from numpy
seeds fed to both packages, each bar stated beside its test:

- ``compute_tap_mat``, ``compute_lambda`` (contexts 0-2) and ``wpe_step``
  (plain and equilibrated) against setk_tpu.enhance.wpe's;
- ``wpe``: the port's fused order on the CPU (the plain versions of
  kernels 18 -> 17 per iteration, 19 at the end) against the JAX
  ``_wpe_fused`` in interpret mode, and the port's scan against the JAX
  scan, 2e-3 of the peak (tests/test_pallas.py's fused-vs-XLA bar); the
  chirp torture input stays finite on both port paths;
- ``wpd`` on a well-conditioned reverberant scene: the port's scan
  against the JAX scan (2e-3 of the peak; masks correlated > 0.9999), and
  the port's fused order on the CPU against the JAX fused path in
  interpret mode (cosine and mask correlation > 0.99, mean |mask
  difference| < 0.02, tests/test_wpe.py's bars);
- ``BatchWpe`` against the JAX one on three keyed utterances, 1e-4 of the
  peak (tests/test_executor.py's bar) for the two that fill their bucket;
  the zero-padded one to 2e-2 (padded frames' lambda = EPSILON) and to
  1e-4 against the port's own per-utterance ``wpe``;
- the CUDA dispatch with ``torch.cuda`` mocked (tensors stay on the CPU,
  the kernels' wrappers counted around their plain versions): the fused
  gate launches kernels 18 / 17 / 19 3 / 3 / 1 times at 3 iterations,
  the scan exactly kernel 16, ``hermitian_solve`` at n = 8 and 200
  nothing, and WPD outside the gate refuses before any copy.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.dsp.stft import StftConfig as JaxStftConfig
from setk_tpu.dsp.stft import forward_stft as jax_forward_stft
from setk_tpu.enhance import wpe as jw
from setk_tpu.parallel import executor as jex
from setk_tpu_torch.dsp.stft import StftConfig, forward_stft, inverse_stft
from setk_tpu_torch.enhance import wpe as tw
from setk_tpu_torch.ops import linalg as tla
from setk_tpu_torch.ops.cuda import cholesky as ch
from setk_tpu_torch.ops.cuda import wpe_gram as wg
from setk_tpu_torch.parallel import executor as tex

FUSED_TOL = 2e-3   # tests/test_pallas.py test_fused_wpe_matches_xla


def _cplx(rng, *shape):
    return (rng.standard_normal(shape) +
            1j * rng.standard_normal(shape)).astype(np.complex64)


def _reverb(rng, *lead, f=12, n=3, t=64):
    """Random spectra with a delayed copy (the filter has work):
    tests/test_pallas.py's fused-WPE input."""
    obs = _cplx(rng, *lead, f, n, t)
    obs[..., 5:] += 0.4 * obs[..., :-5]
    return obs


def _room(rng, f=12, n=3, t=64):
    """A source seen through per-bin steering, decaying echoes 3-9 frames
    late and noise at 0.1: full-rank, well-conditioned covariances, where
    two EVD and CGMM implementations agree to rounding."""
    dry = _cplx(rng, f, 1, t)
    x = _cplx(rng, f, n, 1) * dry
    rev = x.copy()
    for d in range(3, 10):
        rev[..., d:] += 0.6 * (0.7**(d - 3)) * x[..., :t - d]
    return (rev + 0.1 * _cplx(rng, f, n, t)).astype(np.complex64)


def _peak_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


# ---- the building blocks ----

@pytest.mark.parametrize("context", [0, 1, 2])
def test_tap_mat_and_lambda_match_setk_tpu(context):
    rng = np.random.default_rng(context)
    obs = _reverb(rng, f=5, n=3, t=30)
    np.testing.assert_array_equal(
        tw.compute_tap_mat(torch.from_numpy(obs), 4, context + 1).numpy(),
        np.asarray(jw.compute_tap_mat(jnp.asarray(obs), 4, context + 1)))
    # taps past the end: all zero, as the JAX stack
    np.testing.assert_array_equal(
        tw.compute_tap_mat(torch.from_numpy(obs[..., :4]), 3, 5).numpy(),
        np.asarray(jw.compute_tap_mat(jnp.asarray(obs[..., :4]), 3, 5)))
    got = tw.compute_lambda(torch.from_numpy(obs), context=context).numpy()
    ref = np.asarray(jw.compute_lambda(jnp.asarray(obs), context=context))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("equilibrate", [False, True])
def test_wpe_step_matches_setk_tpu(equilibrate):
    """Both solve the same loaded normal equations in f32 on the CPU:
    1e-4 of the peak (two Cholesky implementations)."""
    rng = np.random.default_rng(4 + equilibrate)
    obs = _reverb(rng, f=6, n=3, t=48)
    taps_mat = np.asarray(jw.compute_tap_mat(jnp.asarray(obs), 4, 2))
    lam = np.asarray(jw.compute_lambda(jnp.asarray(obs), context=1))
    got = tw.wpe_step(torch.from_numpy(obs), torch.from_numpy(taps_mat),
                      torch.from_numpy(lam), equilibrate=equilibrate)
    ref = jw.wpe_step(jnp.asarray(obs), jnp.asarray(taps_mat),
                      jnp.asarray(lam), equilibrate=equilibrate)
    assert _peak_err(got, ref) < 1e-4


# ---- wpe ----

def test_fused_order_matches_jax_fused_interpret():
    """The port's fused order on the CPU (plain versions of 18 -> 17 x3,
    19) against the JAX tap-free fused WPE in interpret mode."""
    rng = np.random.default_rng(5)
    obs = _reverb(rng, 2, f=12, n=3, t=64)
    got = tw.wpe(obs, taps=4, delay=2, context=1, num_iters=3,
                 use_fused=True, device="cpu")
    ref = jw._wpe_fused(jnp.asarray(obs), taps=4, delay=2, context=1,
                        num_iters=3, interpret=True)
    assert got.shape == (2, 12, 3, 64) and got.dtype == torch.complex64
    assert _peak_err(got, ref) < FUSED_TOL


def test_scan_matches_jax_scan():
    rng = np.random.default_rng(6)
    obs = _reverb(rng, 2, f=12, n=3, t=64)
    got = tw.wpe(obs, taps=4, delay=2, context=1, num_iters=3,
                 use_fused=False, device="cpu")
    ref = jw.wpe(jnp.asarray(obs), taps=4, delay=2, context=1, num_iters=3,
                 use_fused=False)
    assert _peak_err(got, ref) < FUSED_TOL


@pytest.mark.parametrize("use_fused", [True, False])
def test_chirp_torture_stays_finite(use_fused):
    """The pure-chirp near-singular input (tests/test_pallas.py
    test_fused_wpe_chirp_torture) on both port paths."""
    sr = 16000
    tt = np.arange(2 * sr) / sr
    chirp = np.sin(2 * np.pi * (100 + 400 * tt) * tt).astype(np.float32)
    wav = np.stack([chirp, np.roll(chirp, 7)])
    spec = np.asarray(jax_forward_stft(jnp.asarray(wav), JaxStftConfig()))
    obs = spec.transpose(2, 0, 1).astype(np.complex64)[:48]  # (F, N, T)
    got = tw.wpe(obs, taps=4, delay=2, context=1, num_iters=3,
                 use_fused=use_fused, device="cpu")
    assert torch.isfinite(got).all()


# ---- wpd ----

def _cosine(a, b):
    a, b = np.asarray(a).ravel(), np.asarray(b).ravel()
    return float(np.abs(np.vdot(a, b)) / (np.linalg.norm(a) *
                                          np.linalg.norm(b)))


def test_wpd_scan_matches_setk_tpu():
    """Scan against scan on the room scene: the enhanced spectrum within
    2e-3 of its peak (the fused-vs-XLA bar); the masks, which chained EM
    and two EVD implementations part by ~1e-2 in a few bins, correlate
    > 0.9999 with mean |difference| < 1e-3 (tighter than
    tests/test_wpe.py's fused-vs-XLA 0.99 and 0.02)."""
    obs = _room(np.random.default_rng(7))
    got_m, got_e = tw.wpd(obs, cgmm_iters=3, wpd_iters=2, taps=4, delay=2,
                          use_fused=False, device="cpu")
    ref_m, ref_e = jw.wpd(jnp.asarray(obs), cgmm_iters=3, wpd_iters=2,
                          taps=4, delay=2, use_fused=False)
    assert got_m.shape == (12, 64) and got_e.shape == (12, 64)
    assert _peak_err(got_e, ref_e) < FUSED_TOL
    gm, rm = got_m.numpy().ravel(), np.asarray(ref_m).ravel()
    assert np.corrcoef(gm, rm)[0, 1] > 0.9999
    assert np.abs(gm - rm).mean() < 1e-3


def test_wpd_fused_order_matches_jax_fused_interpret():
    """The port's fused order on the CPU against JAX wpd(use_fused=True,
    interpret=True): cosine > 0.99, mask correlation > 0.99, mean |mask
    difference| < 0.02."""
    obs = _room(np.random.default_rng(8))
    got_m, got_e = tw.wpd(obs, cgmm_iters=3, wpd_iters=2, taps=4, delay=2,
                          use_fused=True, device="cpu")
    ref_m, ref_e = jw.wpd(jnp.asarray(obs), cgmm_iters=3, wpd_iters=2,
                          taps=4, delay=2, use_fused=True, interpret=True)
    assert torch.isfinite(got_e).all()
    assert _cosine(got_e, ref_e) > 0.99
    gm, rm = got_m.numpy().ravel(), np.asarray(ref_m).ravel()
    assert np.corrcoef(gm, rm)[0, 1] > 0.99
    assert np.abs(gm - rm).mean() < 0.02


# ---- BatchWpe ----

def test_batch_wpe_matches_setk_tpu():
    """Three keyed utterances, batch size 2 (bucket 16384: two full, one
    zero-padded).  Against the JAX BatchWpe 1e-4 of the peak for the two
    that fill their bucket.  The padded one's frames get lambda = EPSILON
    (the JAX semantics, kept): ~1e7 of dynamic range in its tap Gram, where
    each f32 package lies ~1e-2 of the peak from a float64 run of the same
    math, so against the JAX one it is held to 2e-2, and against the
    port's own per-utterance wpe on the padded spectrum to 1e-4
    (tests/test_executor.py's batched-vs-single bar)."""
    rng = np.random.default_rng(9)
    n, s = 3, 16384
    wavs = {"a": rng.standard_normal((n, s)).astype(np.float32) * 0.2,
            "b": rng.standard_normal((n, s)).astype(np.float32) * 0.2,
            "c": rng.standard_normal((n, s - 3000)).astype(np.float32) * 0.2}
    port = tex.BatchWpe(StftConfig(), taps=4, delay=2, num_iters=2,
                        batch_size=2, device="cpu")
    ref = jex.BatchWpe(JaxStftConfig(), taps=4, delay=2, num_iters=2,
                       batch_size=2)
    got, want = {}, {}
    for key, wav in wavs.items():
        got.update(port.add(key, wav))
        want.update(ref.add(key, wav))
    got.update(port.flush())
    want.update(ref.flush())
    assert set(got) == set(want) == set(wavs)
    for key, wav in wavs.items():
        assert got[key].shape == wav.shape
        assert _peak_err(got[key], want[key]) < (1e-4 if key != "c" else
                                                 2e-2)
    padded = np.zeros((n, s), np.float32)
    padded[:, :s - 3000] = wavs["c"]
    spec = forward_stft(torch.from_numpy(padded), StftConfig())
    der = tw.wpe(spec.permute(2, 0, 1), taps=4, delay=2, num_iters=2)
    single = inverse_stft(der.permute(1, 2, 0), StftConfig(), nsamps=s - 3000)
    assert _peak_err(got["c"], single) < 1e-4
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        tex.BatchWpe(StftConfig(), mesh=object(), device="cpu")


# ---- the CUDA dispatch, torch.cuda mocked ----

@pytest.fixture
def mocked_card(monkeypatch):
    """torch.cuda reports a card, tensors stay on the CPU but
    ``hermitian_solve`` takes them for card tensors, and kernels 16-19
    count their calls around their plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tw, "_as_tensor",
                        lambda x, dev, dtype: torch.as_tensor(x).to(dtype))
    monkeypatch.setattr(tw, "full_f32_matmuls", lambda dev: None)
    counts = {}

    def count(module, name, fn):
        def wrapped(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    count(tw, "wpe_gram", wg.wpe_gram_plain)
    count(tw, "solve_wpe_gram", ch.solve_wpe_gram_plain)
    count(tw, "wpe_apply", wg.wpe_apply_plain)
    count(tla, "hermitian_solve_lanes", ch.hermitian_solve_lanes_plain)
    monkeypatch.setattr(tla, "_on_card", lambda a: True)
    return counts


def test_cuda_dispatch_launch_counts(mocked_card):
    counts = mocked_card
    rng = np.random.default_rng(10)
    obs = _reverb(rng, f=4, n=3, t=32)
    tw.wpe(obs, taps=6, delay=2, num_iters=3)
    assert counts == {"wpe_gram": 3, "solve_wpe_gram": 3, "wpe_apply": 1}
    counts.clear()
    tw.wpe(obs, taps=6, delay=2, num_iters=3, use_fused=False)
    assert counts == {"hermitian_solve_lanes": 3}   # N taps = 18
    counts.clear()
    tw.wpe(_reverb(rng, f=2, n=9, t=24), taps=2, delay=1, num_iters=2)
    assert counts == {"hermitian_solve_lanes": 2}   # N = 9: outside the gate
    counts.clear()
    tw.wpe(obs, taps=4, delay=2, num_iters=2, use_fused=False)
    assert counts == {}                             # N taps = 12: torch.linalg
    for n in (8, 200):
        a = torch.from_numpy(_cplx(rng, 2, n, n + 4))
        a = a @ a.conj().transpose(-1, -2)
        x = tla.hermitian_solve(a, a[..., :2])
        assert torch.isfinite(x).all()
    assert counts == {}


def test_cuda_wpd_launches_and_refusals(mocked_card, monkeypatch):
    """WPD in the gate runs the fused WPE step once an outer iteration
    and the inner CGMM with 3 sweeps; outside it (N = 9) it refuses
    naming ROADMAP queue 1 item 13 before anything is copied."""
    counts = mocked_card
    sweeps = []
    cgmm = tw.cgmm_em

    def record(*args, **kwargs):
        sweeps.append(kwargs.get("sweeps"))
        return cgmm(*args, **kwargs)

    monkeypatch.setattr(tw, "cgmm_em", record)
    obs = _room(np.random.default_rng(11), f=4, n=3, t=32)
    mask, enh = tw.wpd(obs, cgmm_iters=2, wpd_iters=3, taps=4, delay=2)
    assert counts == {"wpe_gram": 3, "solve_wpe_gram": 3, "wpe_apply": 3}
    assert sweeps == [3, 3, 3]
    assert torch.isfinite(enh).all() and mask.shape == (4, 32)

    def no_copy(x, dev, dtype):
        raise AssertionError("copied to the card before refusing")

    monkeypatch.setattr(tw, "_as_tensor", no_copy)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        tw.wpd(np.zeros((4, 9, 32), np.complex64), taps=2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        tw.wpd(obs, taps=4, use_fused=False)
    # the kernels' wrappers on CPU tensors never count a launch
    for fn in (wg.wpe_gram, wg.wpe_apply, ch.solve_wpe_gram,
               ch.hermitian_solve_lanes):
        assert fn.launches == 0
