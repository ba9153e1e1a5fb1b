"""setk_tpu_torch DSP core against setk_tpu on the CPU.

Windows are host numpy and must match bit for bit; STFT/iSTFT spectra
and waveforms at 1e-5 absolute for audio-scale input (std 0.1, peak
well under 1), the float32 FFT round-off between pocketfft builds.
"""

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.dsp import stft as jstft
from setk_tpu.dsp import window as jwin
from setk_tpu_torch.convert import stft_config_from_fields
from setk_tpu_torch.dsp import stft as tstft
from setk_tpu_torch.dsp import window as twin

REPO = Path(__file__).resolve().parents[1]
WINDOWS = ["hann", "sqrthann", "hamming", "blackman", "rect"]
ATOL = 1e-5


def _signal(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) *
            0.1).astype(np.float32)


@pytest.mark.parametrize("name", WINDOWS)
def test_windows_match_bitwise(name):
    for n in (400, 512):
        w = twin.make_window(name, n)
        np.testing.assert_array_equal(w, jwin.make_window(name, n))
        np.testing.assert_array_equal(twin.pad_center(w, 512),
                                      jwin.pad_center(w, 512))
    w = twin.pad_center(twin.make_window(name, 400), 512)
    np.testing.assert_array_equal(twin.window_sumsquare(w, 9, 128, 512),
                                  jwin.window_sumsquare(w, 9, 128, 512))
    np.testing.assert_array_equal(
        twin.wss_inverse_blocks(w, 9, 256, 512, 2048),
        jwin.wss_inverse_blocks(w, 9, 256, 512, 2048))


@pytest.mark.parametrize("fields", [
    {}, {"frame_len": 400, "frame_hop": 160, "window": "hamming"},
    {"frame_len": 256, "frame_hop": 64, "window": "sqrthann",
     "center": False}, {"frame_len": 300, "round_power_of_two": False}])
def test_stft_config_converts_bitwise(fields):
    jcfg = jstft.StftConfig(**fields)
    cfg = stft_config_from_fields(**dataclasses.asdict(jcfg))
    assert (cfg.n_fft, cfg.num_bins, cfg.frame_hop, cfg.center) == \
        (jcfg.n_fft, jcfg.num_bins, jcfg.frame_hop, jcfg.center)
    assert cfg.padded_window.dtype == jcfg.padded_window.dtype
    np.testing.assert_array_equal(cfg.padded_window, jcfg.padded_window)
    for s in (1000, 4096, 16000):
        assert cfg.num_frames(s) == jcfg.num_frames(s)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
def test_forward_stft_matches(window, center):
    jcfg = jstft.StftConfig(frame_len=400, frame_hop=160, window=window,
                            center=center)
    cfg = stft_config_from_fields(**dataclasses.asdict(jcfg))
    x = _signal(0, (2, 3, 8000))
    ref = np.asarray(jstft.forward_stft(jnp.asarray(x), jcfg))
    got = tstft.forward_stft(torch.from_numpy(x), cfg).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(
        tstft.frame_signal(torch.from_numpy(x), cfg).numpy(),
        np.asarray(jstft.frame_signal(jnp.asarray(x), jcfg)))


def test_forward_stft_post_ops_match():
    jcfg = jstft.StftConfig()
    cfg = stft_config_from_fields(**dataclasses.asdict(jcfg))
    x = _signal(1, (2, 4096))
    for kw in ({"apply_abs": True}, {"apply_log": True},
               {"apply_abs": True, "apply_pow": True}):
        ref = np.asarray(jstft.forward_stft(jnp.asarray(x), jcfg, **kw))
        got = tstft.forward_stft(torch.from_numpy(x), cfg, **kw).numpy()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL * scale)


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
def test_inverse_stft_matches(window, center):
    jcfg = jstft.StftConfig(frame_len=512, frame_hop=128, window=window,
                            center=center)
    cfg = stft_config_from_fields(**dataclasses.asdict(jcfg))
    x = _signal(2, (2, 6000))
    spec = np.array(jstft.forward_stft(jnp.asarray(x), jcfg))
    # without centering the first and last samples sit where the window
    # envelope falls to ~1e-9 (1e-34 for blackman) and the guarded divide
    # amplifies float32 round-off in both packages alike: compare where
    # the envelope is well conditioned
    env = twin.window_sumsquare(cfg.padded_window, spec.shape[-2], 128, 512)
    if center:
        env = env[256:-256]
    for nsamps in (None, 5000, 7000):
        ref = np.asarray(jstft.inverse_stft(jnp.asarray(spec), jcfg,
                                            nsamps=nsamps))
        got = tstft.inverse_stft(torch.from_numpy(spec), cfg,
                                 nsamps=nsamps).numpy()
        assert got.shape == ref.shape
        n = min(got.shape[-1], env.shape[-1])
        ok = env[:n] >= 1e-3 * env.max()
        assert ok.mean() > 0.95
        np.testing.assert_allclose(got[..., :n][..., ok],
                                   ref[..., :n][..., ok], rtol=0, atol=ATOL)
        np.testing.assert_array_equal(got[..., n:], ref[..., n:])


def test_inverse_stft_norm_power_and_general_hop():
    # a hop that does not divide the frame takes the index_add overlap-add
    jcfg = jstft.StftConfig(frame_len=400, frame_hop=150, window="hann")
    cfg = stft_config_from_fields(**dataclasses.asdict(jcfg))
    x = _signal(3, (3, 5000))
    spec = np.array(jstft.forward_stft(jnp.asarray(x), jcfg))
    for kw in ({}, {"norm": 0.5}, {"power": 0.01}):
        ref = np.asarray(jstft.inverse_stft(jnp.asarray(spec), jcfg,
                                            nsamps=5000, **kw))
        got = tstft.inverse_stft(torch.from_numpy(spec), cfg, nsamps=5000,
                                 **kw).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    frames = _signal(4, (2, 7, 400))
    np.testing.assert_allclose(
        tstft.overlap_add(torch.from_numpy(frames), 150).numpy(),
        np.asarray(jstft.overlap_add(jnp.asarray(frames), 150)),
        rtol=0, atol=1e-6)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_setk_tpu():
    files = sorted((REPO / "setk_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax",
                               "setk_tpu"), f"{path}: imports {mod}"
