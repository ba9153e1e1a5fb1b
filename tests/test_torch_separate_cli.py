"""The port's separation and fixed-beamformer CLIs against setk_tpu's.

Each command runs with ``--device cpu`` and setk_tpu's runs on the same
scp (tests/spatial_scene.py: a far-field source in noise bursts, the
sensor noise at 0.05 of the source, 2 utterances of 1 and 1.5 s on the
default 4-mic line and 6-mic circle, and a second source in the first's
gaps): every wav written by both and within 2 int16 steps.

- wav_separate: T x F and F x T masks, ``--phase-ref``, without the
  mixture's norm and length;
- oracle_separate: irm, ibm, iam and psm masks (psm with ``--cutoff``);
- apply_ds_beamformer, apply_sd_beamformer, apply_classic_beamformer:
  both arrays, a fixed DoA, ``--utt2doa``, online DoA tracks
  (``--chunk-len``, a track a key or one list for all).  Superdirective
  weights on the circle solve a diffuse covariance loaded with 1e-5 I,
  whose condition number kappa_f is ~6e5 at bins 0-2 and above 1e3 at
  bins 0-12 (below 406 Hz): two f32 solves part there by up to kappa_f
  eps (tests/test_torch_spatial.py holds the weights to kappa_f 1e-6 of
  each bin's peak).  So sd on the circle is held to 64 int16 steps (2e-3
  of full scale; 9 measured against JAX on the CPU, 23 between an NVIDIA
  H100 80GB HBM3 at 700 W and its host's CPU), and everything else to 2
  steps.  The ds and sd outputs with the scene's DoA correlate with the source as the steering origin hears it (mic 0
  of the line, the circle's center) better than mic 0's mixture does
  with the source as mic 0 hears it; for sd on the circle both signals
  are first high-passed at 406 Hz, because its white noise gain there
  amplifies the sensor noise;
- apply_fixed_beamformer: 2-D weights, 3-D weights with ``--beam`` and
  with ``--utt2beam`` (a key with a beam past the weights is skipped by
  both).
"""

import math

import numpy as np
import pytest

from setk_tpu_torch.io.wave import read_wav
from setk_tpu_torch.spatial.steer import linear_steer_vector

from spatial_scene import run_both, write_corpus

LSB_TOL = 2
SD_CIRCLE_TOL = 64
LOW_HZ = 406.25           # bins 0-12 at 512 / 16 kHz: kappa_f > 1e3
DOAS = {"linear": (67.0, 121.0), "circular": (67.0, 250.0)}
SECONDS = (1.0, 1.5)
CHUNK = 20


@pytest.fixture(scope="module", params=["linear", "circular"])
def corpus(request, tmp_path_factory):
    geometry = request.param
    root = tmp_path_factory.mktemp(f"separate_{geometry}")
    info = write_corpus(root, geometry, DOAS[geometry], SECONDS,
                        seed=31 if geometry == "linear" else 32)
    return geometry, root, info


def _wavs(ref_dir, got_dir, keys, ill_conditioned=False):
    """{key: (setk_tpu's samples, the port's)} with every key written by
    both and within LSB_TOL int16 steps (SD_CIRCLE_TOL where
    ``ill_conditioned``)."""
    out = {}
    for key in keys:
        ref = read_wav(ref_dir / f"{key}.wav", normalize=False)
        got = read_wav(got_dir / f"{key}.wav", normalize=False)
        assert got.shape == ref.shape, key
        assert np.abs(got - ref).max() <= (
            SD_CIRCLE_TOL if ill_conditioned else LSB_TOL), key
        assert np.abs(ref).max() > 100, key      # a signal, not silence
        out[key] = (ref, got)
    assert sorted(p.stem for p in got_dir.glob("*.wav")) == sorted(keys)
    return out


def _high_pass(x):
    spec = np.fft.rfft(x)
    spec[np.fft.rfftfreq(x.size, 1 / 16000) < LOW_HZ] = 0
    return np.fft.irfft(spec, n=x.size)


SEPARATE_CASES = [("mask", []), ("mask_ft", []),
                  ("mask", ["--phase-ref", "MIX"]),
                  ("mask_ft", ["--mixed-norm", "false", "--keep-length",
                               "false"])]


@pytest.mark.parametrize("masks,extra", SEPARATE_CASES,
                         ids=["tf", "ft", "phase-ref", "raw-length"])
def test_wav_separate(corpus, tmp_path, masks, extra):
    _, root, info = corpus
    extra = [str(root / "mix.scp") if a == "MIX" else a for a in extra]
    ref_dir, got_dir = run_both("wav_separate", lambda out: [
        str(root / "wav.scp"), str(root / f"{masks}.scp"), str(out),
        "--fmt", "numpy"] + extra, tmp_path)
    _wavs(ref_dir, got_dir, list(info))


@pytest.mark.parametrize("mask,extra", [("irm", []), ("ibm", []),
                                        ("iam", []), ("psm", []),
                                        ("psm", ["--cutoff", "0.8"])],
                         ids=["irm", "ibm", "iam", "psm", "psm-cutoff"])
def test_oracle_separate(corpus, tmp_path, mask, extra):
    _, root, info = corpus
    ref_dir, got_dir = run_both("oracle_separate", lambda out: [
        str(root / "mix.scp"), f"{root / 'src.scp'},{root / 'other.scp'}",
        str(out), "--mask", mask] + extra, tmp_path)
    _wavs(ref_dir, got_dir, [f"{k}.spk{s}" for k in info for s in (1, 2)])


def _corr(a, b):
    a, b = a - a.mean(), b - b.mean()
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


BEAM_CASES = [("apply_ds_beamformer", "utt2doa"),
              ("apply_sd_beamformer", "utt2doa"),
              ("apply_ds_beamformer", "track"),
              ("apply_sd_beamformer", "track"),
              ("apply_classic_beamformer", "fixed")]


@pytest.mark.parametrize("command,doa", BEAM_CASES,
                         ids=[f"{c.split('_')[1]}-{d}" for c, d in
                              BEAM_CASES])
def test_classic_beamformers(corpus, tmp_path, command, doa):
    geometry, root, info = corpus
    extra = ["--geometry", geometry]
    if doa == "utt2doa":
        (tmp_path / "utt2doa").write_text("".join(
            f"{k} {d}\n" for k, (d, _, _) in info.items()))
        extra += ["--utt2doa", str(tmp_path / "utt2doa")]
    elif doa == "track":
        # a track a key: the scene's DoA, then off by 10 degrees
        (tmp_path / "utt2doa").write_text("".join(
            f"{k} " + " ".join(str(d + 10 * (c % 2)) for c in range(
                math.ceil(t / CHUNK))) + "\n"
            for k, (d, t, _) in info.items()))
        extra += ["--utt2doa", str(tmp_path / "utt2doa"), "--chunk-len",
                  str(CHUNK)]
    else:
        extra += ["--beamformer", "sd", "--doa", "67"]
    sd_circle = geometry == "circular" and (
        "_sd_" in command or doa == "fixed")
    ref_dir, got_dir = run_both(command, lambda out: [
        str(root / "wav.scp"), str(out)] + extra, tmp_path)
    wavs = _wavs(ref_dir, got_dir, list(info), ill_conditioned=sd_circle)
    if doa == "utt2doa":
        for key, (_, got) in wavs.items():
            origin = info[key][2]
            mic0 = read_wav(root / f"{key}.wav")[0]
            src0 = read_wav(root / f"{key}.src.wav")
            n = min(origin.size, got.size)
            pairs = [(got[:n], origin[:n]), (mic0[:n], src0[:n])]
            if sd_circle:
                pairs = [(_high_pass(a), _high_pass(b)) for a, b in pairs]
            assert _corr(*pairs[0]) > _corr(*pairs[1]), key


def test_classic_beamformer_online_doa_list(corpus, tmp_path):
    """One --doa list for all keys: a key whose chunk count differs from
    the list's length is skipped by both."""
    geometry, root, info = corpus
    chunks = math.ceil(next(iter(info.values()))[1] / CHUNK)
    track = ",".join("70" if c % 2 else "60" for c in range(chunks))
    ref_dir, got_dir = run_both("apply_classic_beamformer", lambda out: [
        str(root / "wav.scp"), str(out), "--geometry", geometry,
        "--chunk-len", str(CHUNK), "--doa", track], tmp_path)
    _wavs(ref_dir, got_dir, [next(iter(info))])


@pytest.mark.parametrize("weights,how", [(2, ""), (3, "beam"),
                                         (3, "utt2beam")])
def test_apply_fixed_beamformer(corpus, tmp_path, weights, how):
    geometry, root, info = corpus
    mics = 4 if geometry == "linear" else 6
    topo = [0.05 * k for k in range(mics)]
    grid = linear_steer_vector(topo, [30.0, 67.0, 121.0, 250.0], 257) / mics
    w = grid[1] if weights == 2 else grid
    np.save(tmp_path / "w.npy", w)
    extra, keys = [], list(info)
    if how == "beam":
        extra = ["--beam", "2"]
    elif how == "utt2beam":
        (tmp_path / "utt2beam").write_text(f"{keys[0]} 1\n{keys[1]} 9\n")
        extra = ["--utt2beam", str(tmp_path / "utt2beam")]
        keys = keys[:1]               # beam 9 is past the weights: skipped
    ref_dir, got_dir = run_both("apply_fixed_beamformer", lambda out: [
        str(root / "wav.scp"), str(tmp_path / "w.npy"), str(out)] + extra,
        tmp_path)
    _wavs(ref_dir, got_dir, keys)
