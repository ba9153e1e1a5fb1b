"""The port's OM-LSA noise suppression against setk_tpu's, on the CPU.

The same (T, F) STFT, made from a seed with numpy, goes through
setk_tpu.enhance.ns and setk_tpu_torch.enhance.ns (whose CPU path is the
OM-LSA kernel's plain version, ops/cuda/omlsa.omlsa_plain).  The scene
is a noise floor with speech-like bursts (a band of 30x the floor's
amplitude in every third run of 12 frames), so the speech-presence
branches are taken: MCRA's rising frames and its L-frame restart, iMCRA's
indicator, its band and its V-frame boundaries with a full ring.  At
T = 160, F = 129 the run crosses MCRA's restart at t = 134 ((t + 1) % 125
== 10) and iMCRA's boundaries every 15 frames with all U = 8 slots valid
from t = 7 on.

Bars, of max(1, |gain|) (iMCRA's gains lie in [gmin, 1], so its bar is
absolute; MCRA's reach ~22 on a burst, gh1 > 1):

- TOL = 1e-5 where the JAX function's statements round as the port's
  do: iMCRA as the package runs it (measured 3.6e-7 to 9.5e-7 over six
  seeds), and MCRA jitted with XLA's FMA contraction off
  (ns_scene.jax_mcra_gain_without_fma, a process of its own under
  ``--xla_cpu_max_isa=AVX``) at every configuration and size here, the
  default's 31-tap global window, M = 128 frame mean and L = 125
  restart included (measured 1.1e-6 to 4.5e-6 over five seeds of each
  MCRA configuration at T = 160, F = 129), and with
  ``jax.disable_jit()``, which runs the scan's body one operation at a
  time (measured 1.3e-6 to 4.5e-6 at T = 160, F = 129 over three seeds
  of each; held here on a small scene, the full size costing 6-30 s a
  run).
- MCRA_JIT_TOL = 5e-4 for MCRA as the package runs it, jitted with
  contraction on.  XLA's CPU compiler contracts a * b + c into one FMA
  inside the jitted scan (test_xla_contracts_products_into_fmas) where
  the port rounds twice, and MCRA's recursion carries those roundings
  from frame to frame: the same scene in float64 lies 7.5e-4 of the
  gain from either f32 run, and the two f32 runs lie 2.2e-6 to 2.0e-4
  apart over ten seeds of this scene.  iMCRA's decisions never see a
  rounded transcendental, MCRA's do (through gh1, xi and zeta).
"""

import contextlib
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.enhance import ns as jns
from setk_tpu_torch.enhance import ns as tns
from setk_tpu_torch.ops.cuda import omlsa as om

from ns_scene import jax_mcra_gain_without_fma, scene

TOL = 1e-5
MCRA_JIT_TOL = 5e-4
T, F = 160, 129


def _gap(got, ref):
    """max |got - ref| / max(1, |ref|)."""
    got, ref = np.asarray(got), np.asarray(ref)
    return float((np.abs(got - ref) / np.maximum(1.0, np.abs(ref))).max())


CONFIGS = [("mcra", {}), ("imcra", {}),
           ("mcra", {"L": 40, "w_global": 7}),
           ("imcra", {"U": 4, "V": 10}),
           ("mcra", {"M": 32, "h_global": "hamming", "delta": 3.0}),
           ("imcra", {"w_mcra": 2, "gamma1": 2.5, "V": 6, "U": 9})]


MCRA_CASES = [(scene(T, F, seed=len(conf)), conf)
              for estimator, conf in CONFIGS if estimator == "mcra"] + [
                  (scene(48, 65, seed=5), {"L": 20})]


@pytest.fixture(scope="module")
def mcra_without_fma(tmp_path_factory):
    """setk_tpu's MCRA gains of MCRA_CASES with FMA contraction off, by
    the case's configuration."""
    gains = jax_mcra_gain_without_fma(MCRA_CASES,
                                      tmp_path_factory.mktemp("mcra"))
    return {repr(sorted(conf.items())): g
            for (_, conf), g in zip(MCRA_CASES, gains)}


@pytest.mark.parametrize("estimator,conf", CONFIGS,
                         ids=["mcra", "imcra", "mcra-L40-wg7",
                              "imcra-U4-V10", "mcra-M32-hamming",
                              "imcra-wm2-V6-U9"])
def test_gain_matches_jax(estimator, conf, mcra_without_fma):
    x = scene(T, F, seed=len(conf))
    if estimator == "mcra":
        want = jns.mcra_gain(jnp.asarray(x), jns.MCRAConfig(**conf))
        got = tns.mcra_gain(torch.from_numpy(x), tns.MCRAConfig(**conf))
    else:
        want = jns.imcra_gain(jnp.asarray(x), jns.IMCRAConfig(**conf))
        got = tns.imcra_gain(torch.from_numpy(x), tns.IMCRAConfig(**conf))
    want = np.asarray(want)
    assert got.shape == (T, F) and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    assert _gap(got, want) <= (MCRA_JIT_TOL if estimator == "mcra" else TOL)
    if estimator == "mcra":
        assert _gap(got, mcra_without_fma[repr(sorted(conf.items()))]) <= TOL
    # the presence branches were taken: gains span the floor to above it
    gmin = 10**(-10 / 10)
    assert want.min() < 1.5 * gmin and want.max() > 0.9


def test_mcra_matches_jax_op_by_op():
    """MCRA against the JAX function run one operation at a time, each
    rounded as the port rounds it, at a size that crosses two restarts
    ((t + 1) % 12 == 10 at t = 9 and 21)."""
    x = scene(30, 65, seed=1)
    cfg = {"L": 12, "w_global": 2}
    with jax.disable_jit():
        want = jns.mcra_gain(jnp.asarray(x), jns.MCRAConfig(**cfg))
    got = tns.mcra_gain(torch.from_numpy(x), tns.MCRAConfig(**cfg))
    assert _gap(got, want) <= TOL


def test_xla_contracts_products_into_fmas():
    """The reason for MCRA_JIT_TOL: jitted, XLA on the CPU rounds
    a * b + c once (an FMA) where the port, and JAX op by op, round
    twice."""
    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(4096).astype(np.float32)
               for _ in range(3))
    fused = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    once = (a.astype(np.float64) * b + c).astype(np.float32)
    twice = (torch.from_numpy(a) * torch.from_numpy(b) +
             torch.from_numpy(c)).numpy()
    assert np.array_equal(fused, once) and not np.array_equal(fused, twice)


@pytest.mark.parametrize("estimator", ["mcra", "imcra"])
def test_omlsa_entry_matches_jax(estimator, mcra_without_fma):
    x = scene(48, 65, seed=5)
    got = tns.omlsa(torch.from_numpy(x), estimator, V=12, U=3) \
        if estimator == "imcra" else tns.omlsa(torch.from_numpy(x),
                                               estimator, L=20)
    want = jns.omlsa(jnp.asarray(x), estimator, V=12, U=3) \
        if estimator == "imcra" else jns.omlsa(jnp.asarray(x), estimator,
                                               L=20)
    assert _gap(got, want) <= (MCRA_JIT_TOL if estimator == "mcra" else TOL)
    if estimator == "mcra":
        assert _gap(got, mcra_without_fma[repr([("L", 20)])]) <= TOL
    with pytest.raises(ValueError, match="Unknown noise estimator"):
        tns.omlsa(torch.from_numpy(x), "mmse")


def test_exp1_matches_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 1, 500), rng.uniform(1, 60, 500),
                        [0.0, 1e-14, 1.0, 1e-6, 88.0]]).astype(np.float32)
    got = tns.exp1(torch.from_numpy(x)).numpy()
    want = np.asarray(jns.exp1(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,width", [("hann", 3), ("hann", 31),
                                        ("hamming", 5), ("blackman", 9)])
def test_conv_same_matches_jax(name, width):
    x = np.random.default_rng(width).random((3, 40)).astype(np.float32)
    w = jns._win(name, width)
    got = om._conv_same(torch.from_numpy(x), torch.from_numpy(w))
    want = np.asarray(jns._conv_same(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def test_configs_match_jax():
    """Same fields, defaults and order: a YAML file means the same in both
    packages."""
    for ours, theirs in ((tns.MCRAConfig, jns.MCRAConfig),
                         (tns.IMCRAConfig, jns.IMCRAConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [
            (f.name, f.default) for f in dataclasses.fields(theirs)]


def test_rows_run_independently():
    """The plain version (and so the kernel's contract) takes L rows at
    once: each row's gains are its own single-row run's (to rounding: a
    vectorized CPU kernel rounds a transcendental of the row's elements
    differently where they fall in its scalar tail)."""
    pw = torch.from_numpy(np.stack([np.abs(scene(40, 33, s))**2
                                    for s in range(3)]).astype(np.float32))
    for estimator, cfg in (("mcra", tns.MCRAConfig(L=15)),
                           ("imcra", tns.IMCRAConfig(V=7))):
        rows = om.omlsa_plain(pw, estimator, cfg)
        for i in range(3):
            assert _gap(rows[i], om.omlsa_plain(pw[i:i + 1], estimator,
                                                cfg)[0]) <= TOL


def test_frame_mean_is_the_mean():
    """The kernel-order frame mean of MCRA is the mean to rounding, at
    counts below, at and past a warp's 32 lanes."""
    z = torch.from_numpy(np.random.default_rng(0).random(
        (2, 200)).astype(np.float32))
    for n in (1, 9, 32, 65, 200):
        got = om._frame_mean(z[:, :n])
        np.testing.assert_allclose(got.numpy(),
                                   z[:, :n].double().mean(-1).numpy(),
                                   rtol=2e-7)


def test_card_refusals_before_any_build():
    """On a tensor off the CPU the wrapper checks before it builds or
    launches: type, shape, the estimator."""
    cfg = tns.IMCRAConfig()
    meta = torch.empty((1, 10, 257), device="meta")
    with pytest.raises(ValueError, match="float32"):
        om.omlsa(meta.to(torch.float16), "imcra", cfg)
    with pytest.raises(ValueError, match="float32"):
        om.omlsa(torch.empty((10, 257), device="meta"), "imcra", cfg)
    with pytest.raises(ValueError, match="Unknown noise estimator"):
        om.omlsa(meta, "mmse", cfg)
    assert om.omlsa.launches == 0


@pytest.mark.parametrize("estimator", ["mcra", "imcra"])
def test_card_takes_any_bin_count(monkeypatch, estimator):
    """Meta tensors stand for card tensors: F = 17,409 bins (past the
    bins one block took before the kernels became a thread a bin) goes to
    the one launch, with a scratch of rows x (T x floats a frame + floats
    a row) from the layout, which the wrapper asks for once a
    configuration."""
    cfg = tns.MCRAConfig() if estimator == "mcra" else tns.IMCRAConfig()
    asked, launched, sizes, make = [], [], [], torch.empty
    power = torch.empty((2, 4, 17409), device="meta")
    layout = {"threads": 32, "blocks_a_row": 545, "floats_a_frame": 7,
              "floats_a_row": 3, "ring_shared": 1, "launches": 5}

    def library(name):
        assert name == "omlsa"

        class Lib:
            @staticmethod
            def omlsa_layout(imcra, f, u, ntaps, out):
                asked.append((imcra, f, u, ntaps))
                values = (ctypes.c_int * 6).from_address(out)
                values[:] = list(layout.values())
                return 0
        return Lib

    def launch(name, fn, dev, *args):
        launched.append(fn)

    def empty(*size, **kwargs):
        sizes.append(size)
        return make(*size, **kwargs)

    monkeypatch.setattr(om._build, "library", library)
    monkeypatch.setattr(om._build, "launch", launch)
    monkeypatch.setattr(om, "_LAYOUTS", {})
    monkeypatch.setattr(om.torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(om.omlsa, "launches", 0)
    monkeypatch.setattr(om.torch, "empty", empty)
    for _ in range(2):
        gain = om.omlsa(power, estimator, cfg)
        assert gain.shape == (2, 4, 17409) and gain.device.type == "meta"
    assert om.omlsa.launches == 2
    assert launched == ["omlsa_launch"] * 2
    assert sizes == [(2 * (4 * 7 + 3),)] * 2
    u = cfg.U if estimator == "imcra" else 0
    ntaps = 3 if estimator == "imcra" else 3 + 31 + 3
    assert asked == [(int(estimator == "imcra"), 17409, u, ntaps)]
    assert om.omlsa_layout(estimator, 17409, u, ntaps, "meta") == layout
