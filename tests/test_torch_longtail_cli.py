"""The long tail's functions and commands against setk_tpu's, on the CPU.

Functions, on the same numpy inputs:

- mel: ``hz_to_mel``, ``mel_to_hz`` and ``mel_filterbank`` bit-equal
  (float64 numpy in both); ``mel_fbank`` within 1e-6 of the peak;
- Griffin-Lim: ``_griffin_lim_from`` fed the phase that
  ``jax.random.uniform(PRNGKey(0), ...)`` draws, within 1e-4 of the
  peak at 5 epochs (the two packages' FFTs differ by ~1e-7 of the peak
  an iteration); the port's own draw starts from a seeded CPU generator,
  the same on any device;
- metrics: ``si_snr`` and ``permute_si_snr`` within 1e-4 dB,
  ``bss_eval_sdr`` / ``bss_eval_sources`` within 1e-6 dB (float64 in
  both), ``edit_distance`` and ``permute_ed`` equal.

Commands, each with ``--device cpu`` against the JAX command's ``run``
on wavs and archives written with the port's ``io`` (2 utterances of 1
and 0.8 s: single-channel speech-like bursts in noise; two-channel
mixtures of two such sources through short random filters):

- apply_ns, both estimators, wave and gain output, and a YAML ``--conf``
  each: waves within 2 int16 steps, each package reading the wav
  through its own STFT.  The gain archives come from one STFT, the
  port's (patched into the JAX command's reader: the two packages' STFTs
  lie 1.1e-7 to 1.7e-7 of the peak apart, 2e-6 of a bin at 1.7 % of the
  peak, which the early frames carry on, lambda starting at |X_0|^2;
  compute_spectrogram holds the STFTs to each other): iMCRA within 1e-5
  of max(1, |gain|) (measured 8.3e-7); MCRA within 1e-5 of setk_tpu's
  MCRA jitted with FMA contraction off (ns_scene.jax_mcra_gain_without_
  fma) and within 5e-4 of the JAX command as it runs, jitted with
  contraction on (tests/test_torch_ns.py's MCRA_JIT_TOL: XLA contracts
  products into FMAs, and MCRA's recursion carries the roundings);
- apply_auxiva: every source's wave within 2 int16 steps;
- compute_fbank and compute_spectrogram (kaldi and exraw; log, linear,
  power): archives within 1e-5 of their peak;
- wav_estimate: ``--phase-ref`` within 2 int16 steps; Griffin-Lim with
  the port's initial phase replaced by the JAX draw, within 2 steps;
- compute_si_snr (one and two sources, ``--align``, ``--details``,
  ``--utt2class``), compute_sdr, compute_wer (``--per-utt``,
  ``--utt2class``, two speakers): the printed lines equal.  compute_sdr
  and compute_wer compute on the host and take no ``--device``.

JAX's wav readers decode in Python here (its native loader's first
build is not raced: ROADMAP queue 3).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.dsp.griffin_lim import griffin_lim as jax_griffin_lim
from setk_tpu.dsp import mel as jmel
from setk_tpu.dsp.stft import StftConfig as JStftConfig
from setk_tpu.metrics import bss as jbss
from setk_tpu.metrics import sisnr as jsisnr
from setk_tpu.metrics import wer as jwer
from setk_tpu_torch.dsp import griffin_lim as tgl
from setk_tpu_torch.dsp import mel as tmel
from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.io import (ExrawScriptReader, ScriptReader,
                               SpectrogramReader)
from setk_tpu_torch.io.wave import read_wav, write_wav
from setk_tpu_torch.metrics import bss as tbss
from setk_tpu_torch.metrics import sisnr as tsisnr
from setk_tpu_torch.metrics import wer as twer

from ns_scene import jax_mcra_gain_without_fma

LSB_TOL = 2
ARK_TOL = 1e-5
GAIN_TOL = 1e-5
MCRA_JIT_TOL = 5e-4
SR = 16000
# the commands that compute on the host, with no --device
HOST_COMMANDS = ("compute_sdr", "compute_wer")


# ---- functions ----

@pytest.mark.parametrize("kwargs", [
    dict(sr=16000, n_fft=512), dict(sr=16000, n_fft=512, num_mels=40,
                                    fmin=20.0, fmax=7600.0),
    dict(sr=8000, n_fft=256, num_mels=23, htk=False),
    dict(sr=16000, n_fft=1024, num_mels=64, norm=None)])
def test_mel_filterbank_is_bit_equal(kwargs):
    assert np.array_equal(tmel.mel_filterbank(**kwargs),
                          jmel.mel_filterbank(**kwargs))
    freqs = np.linspace(0, 8000, 101)
    for htk in (True, False):
        assert np.array_equal(tmel.hz_to_mel(freqs, htk),
                              jmel.hz_to_mel(freqs, htk))
        assert np.array_equal(tmel.mel_to_hz(freqs / 4, htk),
                              jmel.mel_to_hz(freqs / 4, htk))


@pytest.mark.parametrize("apply_log", [False, True])
def test_mel_fbank_matches_jax(apply_log):
    mag = np.abs(np.random.default_rng(0).standard_normal(
        (2, 50, 257))).astype(np.float32)
    w = jmel.mel_filterbank(16000, 512)
    got = tmel.mel_fbank(torch.from_numpy(mag), w, apply_log=apply_log)
    want = np.asarray(jmel.mel_fbank(jnp.asarray(mag), w,
                                     apply_log=apply_log))
    assert got.shape == want.shape == (2, 50, 80)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * float(
        np.abs(want).max())


@pytest.mark.parametrize("shape,norm", [((40, 257), None),
                                        ((2, 30, 257), 0.5)])
def test_griffin_lim_from_jax_phase_matches_jax(shape, norm):
    mag = np.abs(np.random.default_rng(1).standard_normal(shape)).astype(
        np.float32)
    key = jax.random.PRNGKey(0)
    phase0 = np.asarray(jax.random.uniform(key, mag.shape,
                                           dtype=jnp.float32))
    want = np.asarray(jax_griffin_lim(mag, JStftConfig(), key=key, epochs=5,
                                     norm=norm))
    got = tgl._griffin_lim_from(torch.from_numpy(mag),
                                torch.from_numpy(phase0), StftConfig(), 5,
                                norm).numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-4 * float(
        np.abs(want).max())


def test_griffin_lim_draws_from_a_seeded_cpu_generator():
    mag = torch.rand((20, 129), generator=torch.Generator().manual_seed(2))
    cfg = StftConfig(frame_len=256, frame_hop=128)
    a = tgl.griffin_lim(mag, cfg, epochs=2)
    b = tgl.griffin_lim(mag, cfg, key=0, epochs=2)
    c = tgl.griffin_lim(mag, cfg, key=torch.Generator().manual_seed(0),
                        epochs=2)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert not torch.equal(a, tgl.griffin_lim(mag, cfg, key=1, epochs=2))


def test_si_snr_matches_jax():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((3, 4000)).astype(np.float32)
    x = (s + 0.3 * rng.standard_normal(s.shape)).astype(np.float32)
    for dc in (True, False):
        got = tsisnr.si_snr(torch.from_numpy(x), torch.from_numpy(s),
                            remove_dc=dc)
        want = np.asarray(jsisnr.si_snr(x, s, remove_dc=dc))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    est = [x[1], x[0], x[2]]
    for align in (False, True):
        got = tsisnr.permute_si_snr([torch.from_numpy(e) for e in est],
                                    [torch.from_numpy(r) for r in s],
                                    align=align)
        want = jsisnr.permute_si_snr(est, list(s), align=align)
        if align:
            assert got[1] == want[1] == (1, 0, 2)
            got, want = got[0], want[0]
        assert abs(got - want) <= 1e-4
    with pytest.raises(RuntimeError, match="mismatch"):
        tsisnr.permute_si_snr(est, list(s[:2]))


def test_bss_eval_matches_jax():
    rng = np.random.default_rng(3)
    ref = rng.standard_normal((2, 3000))
    est = np.stack([ref[1] + 0.2 * np.roll(ref[0], 3),
                    0.8 * ref[0] + 0.1 * rng.standard_normal(3000)])
    for got, want in zip(tbss.bss_eval_sources(est, ref),
                         jbss.bss_eval_sources(est, ref)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    got, perm = tbss.bss_eval_sdr(est[:1], ref[:1], flen=128)
    want, jperm = jbss.bss_eval_sdr(est[:1], ref[:1], flen=128)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.array_equal(perm, jperm)


def test_edit_distance_matches_jax():
    rng = np.random.default_rng(4)
    words = list("abcdefg")
    for _ in range(20):
        h = list(rng.choice(words, rng.integers(0, 9)))
        r = list(rng.choice(words, rng.integers(0, 9)))
        assert twer.edit_distance(h, r) == jwer.edit_distance(h, r)
    hl = [["a", "b"], ["c", "d", "e"], ["f"]]
    rl = [["c", "e"], ["f", "g"], ["a", "b", "b"]]
    assert twer.permute_ed(hl, rl) == jwer.permute_ed(hl, rl)
    with pytest.raises(RuntimeError, match="Size mismatch"):
        twer.permute_ed(hl, rl[:2])


# ---- the commands ----

def _bursts(rng, s, period, phase):
    """Band-limited noise in bursts of ``period`` samples, every other
    period from ``phase``."""
    spec = np.fft.rfft(rng.standard_normal(s))
    freqs = np.fft.rfftfreq(s, 1 / SR)
    spec *= (freqs > 200) & (freqs < 4000)
    sig = np.fft.irfft(spec, n=s)
    gate = ((np.arange(s) + phase) // period) % 2 == 0
    return sig / sig.std() * 0.2 * gate


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("longtail")
    rng = np.random.default_rng(23)
    lines = {}
    for i, s in enumerate((SR, 12800)):
        key = f"u{i}"
        clean = _bursts(rng, s, 2400, 0)
        noisy = clean + 0.02 * rng.standard_normal(s)
        srcs = [_bursts(rng, s, 3000, 0), _bursts(rng, s, 2000, 1000)]
        taps = rng.standard_normal((2, 2, 6)) * np.array(
            [1.0, 0.5, 0.25, 0.12, 0.06, 0.03])
        taps[0, 0, 0] = taps[1, 1, 0] = 1.5
        mix = np.stack([sum(np.convolve(srcs[j], taps[m, j])[:s]
                            for j in range(2)) for m in range(2)])
        for name, data in (("noisy", noisy), ("clean", clean),
                           ("mix", mix), ("src1", srcs[0]),
                           ("src2", srcs[1])):
            path = root / f"{key}.{name}.wav"
            write_wav(path, data.astype(np.float32), sr=SR)
            lines.setdefault(name, []).append(f"{key} {path}")
    for name, rows in lines.items():
        (root / f"{name}.scp").write_text("\n".join(rows) + "\n")
    (root / "utt2class").write_text("u0 a\nu1 b\nu2 b\n")
    (root / "hyp1.txt").write_text("u0 a b c d\nu1 e f g\nu2 x\n")
    (root / "hyp2.txt").write_text("u0 h i\nu1 j k l m\nu2 y\n")
    (root / "ref1.txt").write_text("u0 h i j\nu1 e f\nu2 x\n")
    (root / "ref2.txt").write_text("u0 a b d\nu1 j k m m\nu2 z\n")
    (root / "mcra.yaml").write_text("L: 30\nw_global: 5\nalpha: 0.9\n")
    (root / "imcra.yaml").write_text("U: 5\nV: 9\ngamma1: 2.8\n")
    return root


@pytest.fixture(autouse=True)
def python_wav_decoder(monkeypatch):
    """setk_tpu's readers decode in Python: its native loader's first
    build races between test processes (ROADMAP queue 3)."""
    from setk_tpu.utils import native as jnative
    monkeypatch.setattr(jnative, "native_available", lambda: False)


def _run(package, command, argv):
    mod = importlib.import_module(f"{package}.cli.{command}")
    if package == "setk_tpu_torch" and command not in HOST_COMMANDS:
        argv = list(argv) + ["--device", "cpu"]
    mod.run(mod.make_parser().parse_args(argv))


def _both(command, argv_of, tmp_path, capsys=None):
    """Both packages' command; returns {package: (out_dir, stdout)}."""
    outs = {}
    for package in ("setk_tpu", "setk_tpu_torch"):
        out = tmp_path / package
        out.mkdir(parents=True)
        _run(package, command, argv_of(out))
        outs[package] = (out, capsys.readouterr().out if capsys else "")
    return outs


def _wav_gaps(outs, names):
    ref_dir, got_dir = outs["setk_tpu"][0], outs["setk_tpu_torch"][0]
    assert sorted(p.name for p in got_dir.glob("*.wav")) == sorted(
        f"{n}.wav" for n in names)
    gaps = []
    for name in names:
        ref = read_wav(ref_dir / f"{name}.wav", normalize=False)
        got = read_wav(got_dir / f"{name}.wav", normalize=False)
        assert got.shape == ref.shape, name
        assert np.abs(ref).max() > 100, name     # a signal, not silence
        gaps.append(float(np.abs(got - ref).max()))
    return max(gaps)


@pytest.mark.parametrize("estimator", ["mcra", "imcra"])
@pytest.mark.parametrize("conf", [False, True])
def test_apply_ns_matches_jax(corpus, tmp_path, estimator, conf,
                              monkeypatch):
    extra = ["--estimator", estimator]
    if conf:
        extra += ["--conf", str(corpus / f"{estimator}.yaml")]
    wave = _both("apply_ns", lambda out: [
        str(corpus / "noisy.scp"), str(out)] + extra, tmp_path / "wave")
    assert _wav_gaps(wave, ["u0", "u1"]) <= LSB_TOL
    # the gains from one STFT: the port's, in the JAX command too
    from setk_tpu.cli import apply_ns as japply_ns
    spectra = {}

    def port_stft(scp, cfg):
        spectra.update(SpectrogramReader(scp, cfg=StftConfig(
            **dataclasses.asdict(cfg))))
        return list(spectra.items())

    monkeypatch.setattr(japply_ns, "SpectrogramReader", port_stft)
    gain = _both("apply_ns", lambda out: [
        str(corpus / "noisy.scp"), str(out), "--output", "gain"] + extra,
        tmp_path / "gain")
    if estimator == "mcra":
        import yaml
        cfg = yaml.safe_load((corpus / "mcra.yaml").read_text()) \
            if conf else {}
        unfused = dict(zip(spectra, jax_mcra_gain_without_fma(
            [(x, cfg) for x in spectra.values()], tmp_path)))
    tol = MCRA_JIT_TOL if estimator == "mcra" else GAIN_TOL
    for key, frames in (("u0", 63), ("u1", 51)):
        want = np.load(gain["setk_tpu"][0] / f"{key}.npy")
        got = np.load(gain["setk_tpu_torch"][0] / f"{key}.npy")
        assert got.shape == want.shape == (frames, 257)
        assert got.dtype == np.float32
        assert float((np.abs(got - want) /
                      np.maximum(1.0, np.abs(want))).max()) <= tol
        if estimator == "mcra":
            assert float((np.abs(got - unfused[key]) / np.maximum(
                1.0, np.abs(unfused[key]))).max()) <= GAIN_TOL


def test_apply_auxiva_matches_jax(corpus, tmp_path):
    outs = _both("apply_auxiva", lambda out: [
        str(corpus / "mix.scp"), str(out), "--epochs", "10"], tmp_path)
    assert _wav_gaps(outs, [f"u{i}.src{s}" for i in range(2)
                            for s in (1, 2)]) <= LSB_TOL


def _archives(outs, reader=ScriptReader, log=False):
    """The largest gap of an archive from setk_tpu's, of its peak; log
    features compare as the magnitudes they are the log of (each package
    reads the wav through its own STFT, ~1e-7 of the peak apart, which a
    log turns into a large error in a quiet bin)."""
    ref = dict(reader(str(outs["setk_tpu"][0] / "feats.scp")))
    got = dict(reader(str(outs["setk_tpu_torch"][0] / "feats.scp")))
    assert list(got) == list(ref) == ["u0", "u1"]
    worst = 0.0
    for key, r in ref.items():
        g = np.asarray(got[key])
        assert g.shape == r.shape and g.dtype == np.float32
        if log:
            g, r = np.exp(g.astype(np.float64)), np.exp(r.astype(np.float64))
        worst = max(worst, float(np.abs(g - r).max() / np.abs(r).max()))
    return worst


@pytest.mark.parametrize("command,extra,log", [
    ("compute_fbank", [], True),
    ("compute_fbank", ["--log", "false", "--num-bins", "40"], False),
    ("compute_fbank", ["--format", "exraw", "--frame-len", "400",
                       "--frame-hop", "160", "--max-freq", "7000"], True),
    ("compute_spectrogram", [], True),
    ("compute_spectrogram", ["--apply-log", "false", "--apply-pow", "true"],
     False),
    ("compute_spectrogram", ["--format", "exraw", "--apply-log", "false",
                             "--window", "hamming"], False)])
def test_feature_commands_match_jax(corpus, tmp_path, command, extra, log):
    exraw = "exraw" in extra
    outs = _both(command, lambda out: [
        str(corpus / "noisy.scp"), str(out / f"feats.{'bin' if exraw else 'ark'}"),
        "--scp", str(out / "feats.scp")] + extra, tmp_path)
    reader = ExrawScriptReader if exraw else ScriptReader
    assert _archives(outs, reader, log) <= ARK_TOL


@pytest.fixture
def magnitudes(corpus, tmp_path):
    """Log magnitudes of the noisy wavs as a kaldi archive."""
    out = tmp_path / "mag"
    out.mkdir()
    _run("setk_tpu_torch", "compute_spectrogram", [
        str(corpus / "noisy.scp"), str(out / "feats.ark"), "--scp",
        str(out / "feats.scp")])
    return out / "feats.scp"


def test_wav_estimate_phase_ref_matches_jax(corpus, magnitudes, tmp_path):
    outs = _both("wav_estimate", lambda out: [
        str(magnitudes), str(out), "--apply-log", "true", "--phase-ref",
        str(corpus / "noisy.scp")], tmp_path)
    assert _wav_gaps(outs, ["u0", "u1"]) <= LSB_TOL


def test_wav_estimate_griffin_lim_matches_jax(corpus, magnitudes, tmp_path,
                                              monkeypatch):
    """Griffin-Lim from the phase the JAX command draws, through the
    port's command."""
    from setk_tpu_torch.cli import wav_estimate

    def jax_phase(mag, cfg, key=None, epochs=30, norm=None):
        phase0 = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(0), tuple(mag.shape), dtype=jnp.float32))
        return tgl._griffin_lim_from(mag, torch.from_numpy(phase0), cfg,
                                     epochs, norm)

    monkeypatch.setattr(wav_estimate, "griffin_lim", jax_phase)
    outs = _both("wav_estimate", lambda out: [
        str(magnitudes), str(out), "--apply-log", "true", "--gl-epochs",
        "5"], tmp_path)
    assert _wav_gaps(outs, ["u0", "u1"]) <= LSB_TOL


def test_compute_si_snr_matches_jax(corpus, tmp_path, capsys):
    runs = [[str(corpus / "noisy.scp"), str(corpus / "clean.scp"),
             "--details"],
            [str(corpus / "noisy.scp"), str(corpus / "clean.scp"),
             "--utt2class", str(corpus / "utt2class")],
            [f"{corpus / 'src2.scp'},{corpus / 'noisy.scp'}",
             f"{corpus / 'clean.scp'},{corpus / 'src1.scp'}", "--align",
             "--details"]]
    for i, argv in enumerate(runs):
        outs = _both("compute_si_snr", lambda out: argv, tmp_path / str(i),
                     capsys)
        assert outs["setk_tpu_torch"][1] == outs["setk_tpu"][1]
        assert "Si-SNR:" in outs["setk_tpu"][1]


def test_compute_sdr_matches_jax(corpus, tmp_path, capsys):
    outs = _both("compute_sdr", lambda out: [
        f"{corpus / 'src2.scp'},{corpus / 'noisy.scp'}",
        f"{corpus / 'clean.scp'},{corpus / 'src1.scp'}", "--details",
        "--utt2class", str(corpus / "utt2class")], tmp_path, capsys)
    assert outs["setk_tpu_torch"][1] == outs["setk_tpu"][1]
    assert outs["setk_tpu"][1].count("\n") == 3


def test_compute_wer_matches_jax(corpus, tmp_path, capsys):
    per_utt = {}
    for package in ("setk_tpu", "setk_tpu_torch"):
        per_utt[package] = tmp_path / f"{package}.per_utt"
    printed = {}
    for package in ("setk_tpu", "setk_tpu_torch"):
        _run(package, "compute_wer", [
            f"{corpus / 'hyp1.txt'},{corpus / 'hyp2.txt'}",
            f"{corpus / 'ref1.txt'},{corpus / 'ref2.txt'}", "--per-utt",
            str(per_utt[package])])
        printed[package] = capsys.readouterr().out
    assert printed["setk_tpu_torch"] == printed["setk_tpu"]
    assert per_utt["setk_tpu_torch"].read_text() == \
        per_utt["setk_tpu"].read_text()
    for package in ("setk_tpu", "setk_tpu_torch"):
        _run(package, "compute_wer", [
            str(corpus / "hyp1.txt"), str(corpus / "ref1.txt"),
            "--utt2class", str(corpus / "utt2class")])
        printed[package] = capsys.readouterr().out
    assert printed["setk_tpu_torch"] == printed["setk_tpu"]
    assert "  a:" in printed["setk_tpu"]


@pytest.mark.parametrize("command", [
    "apply_ns", "apply_auxiva", "compute_fbank", "compute_spectrogram",
    "wav_estimate", "compute_si_snr"])
def test_commands_refuse_cuda_without_a_card(command, monkeypatch):
    """The default --device cuda refuses on a machine without a card,
    before reading anything; every command is listed."""
    from setk_tpu_torch.cli.__main__ import available_commands
    assert command in available_commands()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"setk_tpu_torch.cli.{command}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.run(mod.make_parser().parse_args(["missing.scp", "x"]))


@pytest.mark.parametrize("command", HOST_COMMANDS)
def test_host_commands_run_without_a_card(command, corpus, monkeypatch,
                                          capsys):
    """compute_sdr and compute_wer take no --device and run on a machine
    without a card, as the JAX commands do; both are listed."""
    from setk_tpu_torch.cli.__main__ import available_commands
    assert command in available_commands()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"setk_tpu_torch.cli.{command}")
    with pytest.raises(SystemExit):
        mod.make_parser().parse_args(["a", "b", "--device", "cpu"])
    pairs = {"compute_sdr": ("noisy", "clean"), "compute_wer": ("hyp1.txt",
                                                                "ref1.txt")}
    argv = [str(corpus / (name if "." in name else f"{name}.scp"))
            for name in pairs[command]]
    mod.run(mod.make_parser().parse_args(argv))
    assert capsys.readouterr().out.startswith(
        "SDR:" if command == "compute_sdr" else "Total WER:")
