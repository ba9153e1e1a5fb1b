"""The port's WPE and WPD CLIs against setk_tpu's, on the CPU.

A tiny numpy-made corpus (3 utterances, 3 channels, 1-1.3 s of a source
with decaying echoes plus noise) through ``apply_wpe`` (``--batch-size``
1 and 4) and ``apply_wpd --mask-dir`` of both packages, the port's with
``--device cpu``; ``--taps 4`` keeps the JAX side quick.

Bars: the JAX package gives frames that are only zero padding (the
per-utterance path pads T to a multiple of 64, ``BatchWpe`` pads to
sample buckets) lambda = EPSILON, which puts ~1e7 of dynamic range into
the tap Gram; there two f32 implementations part by up to ~1e-2 of the
peak (each lies as far from a float64 run of the same math).  So an
utterance with no padded frame on a path is held to 2 int16 steps, as
tests/test_torch_cli.py holds the beamformer CLI, and one with padded
frames to 1e-2 of its peak (~6e-3 seen) and a correlation >= 0.9999.
WPD (the scan on both sides, chained CGMM): the wav within 1e-3 of its
peak, the masks within 1e-3 mean |difference| and a correlation >=
0.9999.
"""

import importlib

import numpy as np
import pytest

from setk_tpu.io import wave as jwave
from setk_tpu_torch.dsp.stft import StftConfig

SR = 16000
# 16128 samples are 64 frames (no padding on the per-utterance path);
# 16384 fill a sample bucket (no padding on the batched path)
LENGTHS = {"utt0": 16128, "utt1": 16384, "utt2": 20000}
LSB_TOL = 2


def _run(package, command, argv):
    mod = importlib.import_module(f"{package}.cli.{command}")
    mod.run(mod.make_parser().parse_args(argv))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wpe_corpus")
    rng = np.random.default_rng(17)
    lines = []
    for key, s in LENGTHS.items():
        dry = rng.standard_normal(s).astype(np.float32) * 0.1
        x = np.zeros((3, s), np.float32)
        for c in range(3):
            x[c] = np.roll(dry, c)
            for d in range(1, 8):
                x[c, d * 300:] += 0.5**d * dry[:s - d * 300]
        x += rng.standard_normal((3, s)).astype(np.float32) * 0.01
        jwave.write_wav(root / f"{key}.wav", x, sr=SR)
        lines.append(f"{key} {root}/{key}.wav")
    (root / "wav.scp").write_text("\n".join(lines) + "\n")
    return root


def _read(path):
    return jwave.read_wav(path, normalize=False)


def _padded(key, batch_size):
    s = LENGTHS[key]
    if batch_size > 1:
        return s % 16384 != 0
    return StftConfig().num_frames(s) % 64 != 0


@pytest.mark.parametrize("batch_size", [1, 4])
def test_apply_wpe_matches_setk_tpu_cli(corpus, tmp_path, batch_size):
    common = [str(corpus / "wav.scp"), "--taps", "4", "--batch-size",
              str(batch_size)]
    _run("setk_tpu", "apply_wpe", [common[0], str(tmp_path / "jax"),
                                   *common[1:]])
    _run("setk_tpu_torch", "apply_wpe", [common[0], str(tmp_path / "port"),
                                         *common[1:], "--device", "cpu"])
    for key, s in LENGTHS.items():
        ref = _read(tmp_path / "jax" / f"{key}.wav")
        got = _read(tmp_path / "port" / f"{key}.wav")
        assert got.shape == ref.shape == (3, s)
        assert np.abs(ref).max() > 1000   # a real signal, not silence
        diff = np.abs(got.astype(np.int64) - ref).max()
        if _padded(key, batch_size):
            assert diff <= 1e-2 * np.abs(ref).max()
            assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] >= 0.9999
        else:
            assert diff <= LSB_TOL


def test_apply_wpd_matches_setk_tpu_cli(corpus, tmp_path):
    common = [str(corpus / "wav.scp"), "--taps", "4", "--cgmm-iters", "3",
              "--wpd-iters", "2"]
    _run("setk_tpu", "apply_wpd", [common[0], str(tmp_path / "jax"),
                                   *common[1:], "--mask-dir",
                                   str(tmp_path / "jax_masks")])
    _run("setk_tpu_torch", "apply_wpd", [common[0], str(tmp_path / "port"),
                                         *common[1:], "--mask-dir",
                                         str(tmp_path / "port_masks"),
                                         "--device", "cpu"])
    cfg = StftConfig()
    for key, s in LENGTHS.items():
        ref = _read(tmp_path / "jax" / f"{key}.wav")
        got = _read(tmp_path / "port" / f"{key}.wav")
        assert got.shape == ref.shape == (s,)
        assert np.abs(got.astype(np.int64) - ref).max() <= \
            1e-3 * np.abs(ref).max()
        m_ref = np.load(tmp_path / "jax_masks" / f"{key}.npy")
        m_got = np.load(tmp_path / "port_masks" / f"{key}.npy")
        assert m_got.shape == m_ref.shape == (cfg.num_frames(s),
                                              cfg.num_bins)
        assert np.abs(m_got - m_ref).mean() < 1e-3
        assert np.corrcoef(m_got.ravel(), m_ref.ravel())[0, 1] >= 0.9999


def test_cli_refusals(monkeypatch, tmp_path):
    """No card and no --device cpu: a RuntimeError before any file is
    read; --data-parallel over several cards names ROADMAP queue 1 item
    12."""
    import torch
    missing = [str(tmp_path / "none.scp"), str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run("setk_tpu_torch", "apply_wpe", missing)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run("setk_tpu_torch", "apply_wpd", missing)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        _run("setk_tpu_torch", "apply_wpe", missing + ["--batch-size", "2",
                                                       "--data-parallel"])
    assert not (tmp_path / "out").exists()
