"""The port's AuxIVA against setk_tpu's, on the CPU, and its dispatch.

The same (N, T, F) STFT of a convolutive mixture (N Laplacian sources
with a uniform random phase, mixed in every bin by a complex Gaussian
N x N matrix), made from a seed with numpy, goes through
setk_tpu.enhance.auxiva and setk_tpu_torch.enhance.auxiva (whose weighted
covariances on the CPU are kernel 13's plain version,
ops/cuda/covariance.masked_covar_plain; the per-bin solves
torch.linalg.solve against jnp.linalg.solve).  Bar: 1e-4 of the output's
peak (measured 5.2e-6 to 7.7e-5: the IP updates carry the two solvers'
roundings from epoch to epoch).

On a CUDA device as far as the module can tell (``torch.cuda`` mocked,
tensors kept on the CPU): one kernel-13 call an epoch for all N sources,
ceil(N / 4) launches, with kernel 13's layouts; N > 8 refused naming
ROADMAP queue 1 item 15 before any copy.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.enhance.auxiva import auxiva as jax_auxiva
from setk_tpu_torch.enhance import auxiva as ax
from setk_tpu_torch.ops.cuda import covariance as mc

TOL = 1e-4


def mixture(n, t, f, seed):
    """(N, T, F) complex64: Laplacian sources mixed per bin."""
    rng = np.random.default_rng(seed)
    src = rng.laplace(size=(n, t, f)) * np.exp(
        1j * rng.uniform(0, 2 * np.pi, (n, t, f)))
    mix = rng.standard_normal((f, n, n)) + 1j * rng.standard_normal(
        (f, n, n))
    return np.einsum("fmn,ntf->mtf", mix, src).astype(np.complex64)


@pytest.mark.parametrize("n,epochs", [(2, 5), (2, 20), (3, 5), (3, 20)])
def test_auxiva_matches_jax(n, epochs):
    x = mixture(n, 120, 65, seed=n)
    want = np.asarray(jax_auxiva(jnp.asarray(x), epochs=epochs))
    got = ax.auxiva(torch.from_numpy(x), epochs=epochs, device="cpu")
    assert got.shape == x.shape and got.dtype == torch.complex64
    assert float(np.abs(got.numpy() - want).max()) <= TOL * float(
        np.abs(want).max())


def test_auxiva_keeps_the_tensors_device():
    """A CPU tensor stays on the CPU (kernel 13's plain version, no
    launch), at any N."""
    x = torch.from_numpy(mixture(2, 40, 17, seed=7))
    assert ax.auxiva(x, epochs=2).device.type == "cpu"
    out = ax.auxiva(torch.from_numpy(mixture(9, 30, 3, seed=1)), epochs=1)
    assert out.shape == (9, 30, 3) and torch.isfinite(out).all()
    assert mc.masked_covar.launches == 0


@pytest.fixture
def mocked_card(monkeypatch):
    """torch.cuda reports a card, tensors stay on the CPU, and kernel 13
    is counted as its wrapper launches it (a launch for every four
    classes) around its plain version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ax, "_as_tensor", lambda x, dev: torch.as_tensor(
        x).to(torch.complex64))
    calls = []

    def counted(obs, weight):
        assert obs.is_contiguous() and weight.is_contiguous()
        assert weight.dtype == torch.float32
        k, lead, f, t = weight.shape
        assert obs.shape == (lead, f, obs.shape[2], t) and lead == 1
        calls.append(math.ceil(k / mc._CLASSES_PER_LAUNCH))
        return mc.masked_covar_plain(obs, weight)

    monkeypatch.setattr(ax, "masked_covar", counted)
    return calls


@pytest.mark.parametrize("n", [2, 4, 5, 8])
def test_cuda_dispatch_launches_kernel_13_once_an_epoch(mocked_card, n):
    x = mixture(n, 24, 9, seed=n)
    got = ax.auxiva(x, epochs=3, device="cuda")
    assert mocked_card == [math.ceil(n / 4)] * 3
    want = ax.auxiva(torch.from_numpy(x), epochs=3, device="cpu")
    torch.testing.assert_close(got, want)


def test_cuda_refuses_more_than_8_sources(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_copy(x, dev):
        raise AssertionError("copied to the card before refusing")

    monkeypatch.setattr(ax, "_as_tensor", no_copy)
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        ax.auxiva(np.zeros((9, 10, 5), np.complex64), device="cuda")
