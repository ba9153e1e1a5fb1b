"""The port's mask-estimator CLIs against setk_tpu's, on the CPU.

tests/test_models.py:64-95's tiny corpus (3 utterances of 0.5 s: a tone
in noise, 16 kHz, 256/128 STFT) through the recipe's chain
(recipes/train_mask.sh:22-27), the port's commands with ``--device cpu``:

- ``compute_mask`` of both packages (irm and psm, kaldi archives): the
  targets as they weigh the mixture, |diff| |Y|, within 1e-6 of the peak
  of |Y| (elementwise, but each package reads its own STFT, and the two
  STFTs part by f32 rounding, ~1e-7 of the peak: a mask divides one
  small magnitude by another in quiet bins, where |diff| alone reaches
  ~2e-4);
- ``train_mask_estimator --arch blstm`` of one package, then
  ``estimate_nn_masks`` of both packages on that checkpoint: the JAX
  package's checkpoint read by the port and the port's by the JAX
  package (``load_checkpoint``), the masks within 5e-5 (the recurrent
  product rounds h to bf16 in both; an h on either side of a rounding
  boundary moves a mask by ~1e-5);
- what the CLIs refuse before reading anything, and the ``-m`` entry.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from setk_tpu.io import wave as jwave
from setk_tpu.models.trainer import load_checkpoint as jax_load
from setk_tpu_torch.io import ScriptReader, SpectrogramReader
from setk_tpu_torch.models.trainer import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
SR = 16000
STFT = ["--frame-len", "256", "--frame-hop", "128"]


def _run(package, command, argv):
    mod = importlib.import_module(f"{package}.cli.{command}")
    mod.run(mod.make_parser().parse_args(argv))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mask_corpus")
    rng = np.random.default_rng(1234)
    noisy, clean = [], []
    for u in range(3):
        t = np.arange(SR // 2) / SR
        c = (np.sin(2 * np.pi * (300 + 50 * u) * t) * 0.3).astype(np.float32)
        n = (rng.standard_normal(SR // 2) * 0.1).astype(np.float32)
        jwave.write_wav(root / f"u{u}.wav", c + n, sr=SR)
        jwave.write_wav(root / f"c{u}.wav", c, sr=SR)
        noisy.append(f"u{u} {root}/u{u}.wav")
        clean.append(f"u{u} {root}/c{u}.wav")
    (root / "noisy.scp").write_text("\n".join(noisy) + "\n")
    (root / "clean.scp").write_text("\n".join(clean) + "\n")
    return root


def _targets(corpus, out, package, mask):
    ark = out / f"{package}.ark"
    scp = out / f"{package}.scp"
    extra = ["--device", "cpu"] if package == "setk_tpu_torch" else []
    _run(package, "compute_mask", [str(corpus / "clean.scp"),
                                   str(corpus / "noisy.scp"), str(ark),
                                   "--scp", str(scp), "--mask", mask,
                                   *STFT, *extra])
    return scp


@pytest.mark.parametrize("mask", ["irm", "psm"])
def test_compute_mask_cli_matches_setk_tpu(corpus, tmp_path, mask):
    ref = ScriptReader(str(_targets(corpus, tmp_path, "setk_tpu", mask)))
    got = ScriptReader(str(_targets(corpus, tmp_path, "setk_tpu_torch",
                                    mask)))
    mix = SpectrogramReader(str(corpus / "noisy.scp"), frame_len=256,
                            frame_hop=128, apply_abs=True)
    assert sorted(got.keys()) == ["u0", "u1", "u2"]
    for key in got.keys():
        assert got[key].shape == ref[key].shape == (63, 129)
        weighed = np.abs(got[key] - ref[key]) * mix[key]
        assert weighed.max() <= 1e-6 * mix[key].max()


@pytest.mark.parametrize("trainer", ["setk_tpu", "setk_tpu_torch"])
def test_checkpoint_and_masks_across_packages(corpus, tmp_path, trainer):
    """One package trains (irm targets of the port's compute_mask), both
    read its checkpoint and estimate the same masks."""
    scp = _targets(corpus, tmp_path, "setk_tpu_torch", "irm")
    ckpt = tmp_path / "final.msgpack"
    extra = ["--device", "cpu"] if trainer == "setk_tpu_torch" else []
    _run(trainer, "train_mask_estimator", [
        str(corpus / "noisy.scp"), str(scp), str(ckpt), "--arch", "blstm",
        "--hidden", "16", "--num-layers", "1", "--epochs", "2",
        "--batch-size", "2", "--frames-per-utt", "48", *STFT, *extra])
    masks = {}
    for package in ("setk_tpu", "setk_tpu_torch"):
        out = tmp_path / package
        _run(package, "estimate_nn_masks", [
            str(corpus / "noisy.scp"), str(ckpt), str(out),
            *(["--device", "cpu"] if package == "setk_tpu_torch" else [])])
        masks[package] = {k: np.load(out / f"{k}.npy")
                          for k in ("u0", "u1", "u2")}
    for key, ref in masks["setk_tpu"].items():
        got = masks["setk_tpu_torch"][key]
        assert got.shape == ref.shape == (63, 129)
        assert ((got >= 0) & (got <= 1)).all()
        np.testing.assert_allclose(got, ref, atol=5e-5)
    # the checkpoint's weights, as each package's loader reads them
    model, meta = load_checkpoint(ckpt, device="cpu")
    jmodel, jparams, jmeta = jax_load(ckpt)
    assert meta == jmeta and meta["arch"] == "blstm"
    x = np.random.default_rng(0).standard_normal((2, 40, 129)).astype(
        np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(
        {"params": jparams}, x)), atol=5e-5)


def test_refusals_before_reading(corpus, tmp_path, monkeypatch):
    """--data-parallel over several cards names ROADMAP queue 1 item 12
    and the default cuda device with no card raises, before any file is
    read or written."""
    train = ["train_mask_estimator", [str(tmp_path / "missing.scp"),
                                      str(tmp_path / "missing.scp"),
                                      str(tmp_path / "m.msgpack")]]
    with pytest.raises(RuntimeError, match="CUDA device"):
        _run("setk_tpu_torch", *train)
    for command, argv in (
            ("compute_mask", [str(corpus / "clean.scp")] * 2 +
             [str(tmp_path / "t.ark")]),
            ("estimate_nn_masks", [str(corpus / "noisy.scp"),
                                   str(tmp_path / "m.msgpack"),
                                   str(tmp_path / "out")])):
        with pytest.raises(RuntimeError, match="CUDA device"):
            _run("setk_tpu_torch", command, argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 12"):
        _run("setk_tpu_torch", train[0], train[1] + ["--data-parallel"])
    assert list(tmp_path.iterdir()) == []


def test_wide_blstm_refuses_on_the_card_before_reading(corpus, tmp_path,
                                                       monkeypatch):
    """--hidden above kernels 20/21's 1024 with --arch blstm on the card,
    or a checkpoint of one, names ROADMAP queue 1 item 16 before any data
    or weights are read and before anything is written; with no card
    ``load_checkpoint``'s default device raises."""
    ckpt = tmp_path / "ckpt" / "m.msgpack"
    ckpt.parent.mkdir()
    ckpt.with_name("m.msgpack.json").write_text(json.dumps({
        "arch": "blstm", "num_bins": 129, "hidden": 2048, "num_layers": 1}))
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_checkpoint(ckpt)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "out"
    for command, argv in (
            ("train_mask_estimator", [
                str(corpus / "noisy.scp"), str(tmp_path / "missing.scp"),
                str(out / "m.msgpack"), "--arch", "blstm", "--hidden",
                "1025", "--num-layers", "1"]),
            ("estimate_nn_masks", [str(corpus / "noisy.scp"), str(ckpt),
                                   str(out)])):
        with pytest.raises(NotImplementedError, match="queue 1 item 16"):
            _run("setk_tpu_torch", command, argv)
    with pytest.raises(NotImplementedError, match="queue 1 item 16"):
        load_checkpoint(ckpt)             # the msgpack is never opened
    assert not out.exists()


def test_module_entry_lists_the_commands():
    out = subprocess.run(
        [sys.executable, "-m", "setk_tpu_torch.cli", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for command in ("compute_mask", "train_mask_estimator",
                    "estimate_nn_masks"):
        assert command in out.stdout.split()
