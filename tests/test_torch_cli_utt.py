"""The port's per-utterance beamformer CLI and its VAD against setk_tpu.

- ``apply_adaptive_beamformer`` of setk_tpu_torch with ``--device cpu``
  and no ``--batch-size`` (the per-utterance path) against setk_tpu's
  ``_run`` on the same scp, for the option sets ``chip_smoke.py`` drives
  on the card (mvdr's eigh steer, gevd with BAN, mpdr, mpdr-whiten,
  pmwf-0 with the GEV rank-1 approximation and a fixed reference,
  pmwf-1 with interference masks, mvdr with VAD filtering and the
  post-mask, online gevd and mvdr): at most 2 int16 steps per sample
  after both CLIs' peak renormalization, on a gated scene (a source in
  bursts, a mask that follows them) where GEVD and PMWF are well posed;
- ``vad_masks`` and ``apply_vad_filter`` against setk_tpu's;
- ``online_supervised_run`` at chunk 16 (every chunk's covariances in one
  pass, the EMA, one weight solve) against setk_tpu's scan;
- on a CUDA device as far as the CLI can tell (``torch.cuda`` mocked,
  tensors kept on the CPU): the exact set of kernel wrappers one
  utterance goes through for each option set.
"""

import importlib

import numpy as np
import pytest
import torch

from setk_tpu.enhance import beamformer as jbf
from setk_tpu.enhance import vad as jvad
from setk_tpu.io import wave as jwave
from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance import vad as tvad
from setk_tpu_torch.ops import linalg as tla
from setk_tpu_torch.ops.cuda import covariance as mc
from setk_tpu_torch.ops.cuda import covariance_pair as cp
from setk_tpu_torch.ops.cuda import eigh_small as es

LSB_TOL = 2
N_CH, SR = 4, 16000
LENGTHS = {"g0": 16000, "g1": 15000}
# (label, extra argv, the kernel wrappers one utterance goes through on a
# card and how often)
OPTIONS = [
    ("mvdr", [], {"pair_covar": 1, "hermitian_eigh": 1}),
    ("gevd+ban", ["--beamformer", "gevd", "--ban", "true"],
     {"pair_covar": 1, "hermitian_eigh": 1}),
    ("mpdr", ["--beamformer", "mpdr"],
     {"pair_covar": 1, "masked_covar": 1, "hermitian_eigh": 1}),
    ("mpdr-whiten", ["--beamformer", "mpdr-whiten"],
     {"pair_covar": 1, "masked_covar": 1, "hermitian_eigh": 1}),
    ("pmwf-0+gev", ["--beamformer", "pmwf-0", "--rank1-appro", "gev",
                    "--pmwf-ref", "0"],
     {"pair_covar": 1, "hermitian_eigh": 1}),
    ("pmwf-1+itf", ["--beamformer", "pmwf-1", "--itf-mask", "ITF"],
     {"pair_covar": 1}),
    ("mvdr+vad+mask", ["--vad-proportion", "0.9", "--mask", "true"],
     {"pair_covar": 1, "hermitian_eigh": 1}),
    ("online-gevd", ["--beamformer", "gevd", "--chunk-size", "16"],
     {"masked_covar": 1, "hermitian_eigh": 1}),
    ("online-mvdr", ["--chunk-size", "16"],
     {"masked_covar": 1, "hermitian_eigh": 1}),
]


def _gated(rng, s, cfg):
    """(wav (N, S), speech mask (T, F), interference mask (T, F)): a
    source at 0.2 in bursts of 2048 samples, delayed a sample and
    attenuated 1/(1 + k/4) at mic k, noise at 0.05; masks 0.95/0.05
    following the bursts with a little jitter."""
    gate = (np.arange(s) // 2048) % 2 == 0
    src = rng.standard_normal(s).astype(np.float32) * 0.2 * gate
    x = rng.standard_normal((N_CH, s)).astype(np.float32) * 0.05
    for k in range(N_CH):
        x[k] += np.roll(src, k) / (1 + k / 4)
    t = cfg.num_frames(s)
    gate_f = gate[np.minimum(np.arange(t) * cfg.frame_hop, s - 1)]
    base = np.where(gate_f, 0.95, 0.05)[:, None]
    jitter = rng.random((t, cfg.num_bins)).astype(np.float32) * 0.04
    return (x, (base - jitter).astype(np.float32),
            (1.0 - base + jitter).astype(np.float32))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("utt_corpus")
    rng = np.random.default_rng(19)
    cfg = StftConfig()
    lines = {"wav": [], "mask": [], "itf": []}
    for key, s in LENGTHS.items():
        x, m, itf = _gated(rng, s, cfg)
        jwave.write_wav(root / f"{key}.wav", x, sr=SR)
        np.save(root / f"{key}.npy", m)
        np.save(root / f"{key}.itf.npy", itf)
        lines["wav"].append(f"{key} {root}/{key}.wav")
        lines["mask"].append(f"{key} {root}/{key}.npy")
        lines["itf"].append(f"{key} {root}/{key}.itf.npy")
    for name, rows in lines.items():
        (root / f"{name}.scp").write_text("\n".join(rows) + "\n")
    return root


def _run(package, argv):
    mod = importlib.import_module(
        f"{package}.cli.apply_adaptive_beamformer")
    mod.run(mod.make_parser().parse_args(argv))


def _argv(corpus, out, extra):
    extra = [str(corpus / "itf.scp") if a == "ITF" else a for a in extra]
    return [str(corpus / "wav.scp"), str(corpus / "mask.scp"),
            str(out)] + extra


@pytest.mark.parametrize("label,extra,_", OPTIONS,
                         ids=[o[0] for o in OPTIONS])
def test_per_utterance_cli_matches_setk_tpu(corpus, tmp_path, label, extra,
                                            _):
    _run("setk_tpu", _argv(corpus, tmp_path / "jax", extra))
    _run("setk_tpu_torch", _argv(corpus, tmp_path / "port", extra) +
         ["--device", "cpu"])
    for key, s in LENGTHS.items():
        ref = jwave.read_wav(tmp_path / "jax" / f"{key}.wav",
                             normalize=False)
        got = jwave.read_wav(tmp_path / "port" / f"{key}.wav",
                             normalize=False)
        assert got.shape == ref.shape == (s,)
        assert np.abs(got - ref).max() <= LSB_TOL, label
        assert np.abs(ref).max() > 1000  # a real signal, not silence


@pytest.fixture
def card(monkeypatch):
    """A CUDA device as far as the CLI and ops.linalg can tell, tensors
    kept on the CPU: the kernel wrappers the path reaches are counted
    around their plain versions."""
    from setk_tpu_torch.cli import apply_adaptive_beamformer as cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(tla, "_on_card", lambda a: True)
    counts = {}

    def count(module, name, fn):
        def wrapped(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    count(tla, "hermitian_eigh", es.hermitian_eigh_plain)
    count(cp, "pair_covar", cp.pair_covar_plain)
    count(bf, "masked_covar", mc.masked_covar_plain)
    # covar_stats takes kernel 13's branch on the CPU tensors
    monkeypatch.setattr(bf, "_on_card", lambda x: True)
    return counts


@pytest.mark.parametrize("label,extra,want", OPTIONS,
                         ids=[o[0] for o in OPTIONS])
def test_per_utterance_launch_sets(card, corpus, tmp_path, label, extra,
                                   want):
    _run("setk_tpu_torch", _argv(corpus, tmp_path / "out", extra))
    assert card == {k: v * len(LENGTHS) for k, v in want.items()}, label
    for key in LENGTHS:
        assert (tmp_path / "out" / f"{key}.wav").exists()


@pytest.mark.parametrize("proportion", [0.6, 0.9, 0.99])
def test_vad_masks_match_setk_tpu(proportion):
    rng = np.random.default_rng(int(proportion * 100))
    spec = (rng.standard_normal((257, 70)) + 1j * rng.standard_normal(
        (257, 70))).astype(np.complex64) * rng.random((257, 1)).astype(
            np.float32)
    sil, count = tvad.vad_masks(spec, proportion)
    jsil, jcount = jvad.vad_masks(spec, proportion)
    assert int(count) == int(jcount)
    assert np.array_equal(sil.numpy(), np.asarray(jsil))
    mask = rng.random((70, 257)).astype(np.float32)
    got = tvad.apply_vad_filter(mask, sil).numpy()
    assert np.array_equal(got, np.asarray(jvad.apply_vad_filter(mask,
                                                                 jsil)))
    assert got.dtype == np.float32 and (got[sil.numpy()] == 1e-4).all()


@pytest.mark.parametrize("name,ban,mask_n", [("gevd", False, False),
                                             ("gevd", True, True),
                                             ("mvdr", True, False),
                                             ("pmwf-1", False, True)])
def test_online_run_matches_setk_tpu(name, ban, mask_n):
    """Every chunk's covariances in one pass, the EMA in chunk order and
    one weight solve over chunks x bins give the JAX scan's output."""
    rng = np.random.default_rng(5)
    f, n, t = 9, 4, 64
    gate = (np.arange(t) // 8) % 2 == 0
    steer = (rng.standard_normal((f, n, 1)) +
             1j * rng.standard_normal((f, n, 1)))
    src = (rng.standard_normal((f, 1, t)) +
           1j * rng.standard_normal((f, 1, t))) * gate
    obs = (steer * src + 0.1 * (rng.standard_normal((f, n, t)) + 1j *
                                rng.standard_normal((f, n, t)))).astype(
        np.complex64)
    m = np.broadcast_to(np.where(gate, 0.95, 0.05), (f, t)).astype(
        np.float32)
    mn = (1.0 - m) * 0.8 if mask_n else None
    got = bf.online_supervised_run(
        name, torch.from_numpy(obs), torch.from_numpy(m),
        mask_n=None if mn is None else torch.from_numpy(mn), chunk_size=16,
        ban=ban).numpy()
    ref = np.asarray(jbf.online_supervised_run(name, obs, m, mask_n=mn,
                                               chunk_size=16, ban=ban))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
