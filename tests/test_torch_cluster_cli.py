"""The port's clustering CLIs against setk_tpu's, on the CPU.

``estimate_cgmm_masks`` and ``estimate_cacgmm_masks`` of setk_tpu_torch
(``--device cpu``) against setk_tpu's on one tiny numpy-made corpus (3
utterances, 4 channels, about 1 s, a source with a per-mic gain under
noise loud enough to keep every covariance well-conditioned): the batched
path (``--batch-size 2``) and the per-utterance path (``--batch-size 1``,
``--dump-model``, ``--resume-model``, the CACGMM ``--init-mask``), masks
within 2e-3.  The CACGMM runs use ``--cgmm-init true`` or an init mask:
its default random init draws other numbers in the two packages.  Each
package's ``--dump-model`` files resume in the other.
"""

import importlib

import numpy as np
import pytest

from setk_tpu_torch.io.wave import write_wav

N_CH, SR = 4, 16000
LENGTHS = {"utt0": 16000, "utt1": 15000, "utt2": 16000}
TOL = 2e-3


def _run(package, command, argv):
    mod = importlib.import_module(f"{package}.cli.{command}")
    mod.run(mod.make_parser().parse_args(argv))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cluster_corpus")
    rng = np.random.default_rng(0)
    gains = rng.uniform(0.5, 1.5, (N_CH, 1))
    wav_lines, mask_lines = [], []
    for key, s in LENGTHS.items():
        clean = rng.standard_normal(s) * 0.2
        x = (gains * clean + rng.standard_normal((N_CH, s)) * 0.1).astype(
            np.float32)
        write_wav(root / f"{key}.wav", x, sr=SR)
        t = 1 + s // 256
        np.save(root / f"{key}.npy",
                rng.uniform(0.1, 0.9, (t, 257)).astype(np.float32))
        wav_lines.append(f"{key} {root}/{key}.wav")
        mask_lines.append(f"{key} {root}/{key}.npy")
    (root / "wav.scp").write_text("\n".join(wav_lines) + "\n")
    (root / "mask.scp").write_text("\n".join(mask_lines) + "\n")
    return root


def _masks(out_dir):
    return {key: np.load(out_dir / f"{key}.npy") for key in LENGTHS}


def _both(corpus, tmp_path, command, args, tag):
    """Run the command of both packages on the corpus; return their masks
    (port, setk_tpu) and output directories."""
    outs = {}
    for package in ("setk_tpu_torch", "setk_tpu"):
        out = tmp_path / f"{tag}-{package}"
        argv = [str(corpus / "wav.scp"), str(out)] + [
            a.format(pkg=package, tmp=tmp_path) for a in args]
        if package == "setk_tpu_torch":
            argv += ["--device", "cpu"]
        _run(package, command, argv)
        outs[package] = _masks(out)
    return outs["setk_tpu_torch"], outs["setk_tpu"]


def _close(got, ref, tol=TOL):
    for key in LENGTHS:
        assert got[key].shape == ref[key].shape
        assert np.isfinite(got[key]).all()
        np.testing.assert_allclose(got[key], ref[key], atol=tol)


@pytest.mark.parametrize("batch", [2, 1])
def test_cgmm_cli_matches_setk_tpu(corpus, tmp_path, batch):
    got, ref = _both(corpus, tmp_path, "estimate_cgmm_masks",
                     ["--batch-size", str(batch), "--num-iters", "8"],
                     "cgmm")
    _close(got, ref)
    assert got["utt1"].shape == (1 + LENGTHS["utt1"] // 256, 257)


@pytest.mark.parametrize("args", [["--batch-size", "2"],
                                  ["--batch-size", "1"],
                                  ["--init-mask", "mask.scp"]])
def test_cacgmm_cli_matches_setk_tpu(corpus, tmp_path, args):
    if "--init-mask" in args:
        args = ["--init-mask", str(corpus / "mask.scp")]
    else:
        args = args + ["--cgmm-init", "true"]
    got, ref = _both(corpus, tmp_path, "estimate_cacgmm_masks",
                     args + ["--num-iters", "8"], "cacgmm")
    _close(got, ref)
    assert got["utt0"].shape == (2, 1 + LENGTHS["utt0"] // 256, 257)


@pytest.mark.parametrize("command,extra", [
    ("estimate_cgmm_masks", []),
    ("estimate_cacgmm_masks", ["--cgmm-init", "true"])])
def test_dumped_models_resume_across_packages(corpus, tmp_path, command,
                                              extra):
    """--dump-model of each package; the .npz files hold the same keys
    and dtypes; each package's dump resumes in the other as in itself."""
    got, ref = _both(corpus, tmp_path, command,
                     ["--num-iters", "6", "--dump-model", "{tmp}/mdl-{pkg}"]
                     + extra, "dump")
    _close(got, ref)
    dumps = {}
    for package in ("setk_tpu_torch", "setk_tpu"):
        with np.load(tmp_path / f"mdl-{package}" / "utt1.npz") as f:
            dumps[package] = {k: f[k] for k in f.files}
    assert set(dumps["setk_tpu_torch"]) == set(dumps["setk_tpu"]) == (
        {"phi", "covar", "alpha"} if command == "estimate_cgmm_masks"
        else {"covar", "alpha"})
    for key, val in dumps["setk_tpu_torch"].items():
        assert val.dtype == dumps["setk_tpu"][key].dtype
        np.testing.assert_allclose(val, dumps["setk_tpu"][key],
                                   atol=1e-3 * np.abs(val).max())
    for src in ("setk_tpu_torch", "setk_tpu"):
        resumed = _both(corpus, tmp_path, command,
                        ["--num-iters", "3", "--resume-model",
                         str(tmp_path / f"mdl-{src}")],
                        f"resume-{src}")
        _close(*resumed)


def test_module_entry_lists_the_clustering_commands():
    from setk_tpu_torch.cli.__main__ import available_commands
    assert {"estimate_cgmm_masks", "estimate_cacgmm_masks",
            "apply_adaptive_beamformer"} <= set(available_commands())
