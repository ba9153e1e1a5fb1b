"""The port's CLI, I/O layer, native decode and profiling against setk_tpu.

- ``apply_adaptive_beamformer`` of setk_tpu_torch (``--device cpu
  --batch-size 2``, offline and ``--chunk-size 16``, masks as numpy and
  as a kaldi archive) against setk_tpu's on the same scp, on a tiny
  numpy-made corpus (3 utterances, 4 channels, about 1 s): at most 2
  int16 steps per sample, after both CLIs' peak renormalization;
- what the CLI refuses (the per-utterance path, data parallelism over
  several cards, online options the card does not run) before it reads
  anything;
- the wav, kaldi and exraw writers of each package read back by the
  other's readers, and the port's SpectrogramReader against setk_tpu's;
- the port's prefetching loader (native decoder built from
  native/wav_io.cc, the Python decoder for pipes) against setk_tpu's
  Python WaveReader;
- ``python -m setk_tpu_torch.cli --help`` lists the command, a fresh
  interpreter that imports every module of setk_tpu_torch and
  chip_smoke.py holds neither jax nor setk_tpu (nor flax, optax or
  msgpack, which the card's machine lacks), and no ``import`` or ``from``
  of any of them stands anywhere in those files' or tools/*.py's syntax
  trees (inside functions too).
"""

import ast
import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import setk_tpu.io as jio
from setk_tpu.dsp.stft import StftConfig as JaxStftConfig
from setk_tpu.io import wave as jwave
import setk_tpu_torch.io as tio
from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.io import wave as twave
from setk_tpu_torch.io.prefetch import PrefetchWaveLoader
from setk_tpu_torch.utils import native
from setk_tpu_torch.utils.profiling import ThroughputMeter, annotate, trace

ROOT = Path(__file__).resolve().parents[1]
LSB_TOL = 2
N_CH, SR = 4, 16000
LENGTHS = {"utt0": 16000, "utt1": 15000, "utt2": 16000}


def _cli(package):
    return importlib.import_module(f"{package}.cli.apply_adaptive_beamformer")


def _run(package, argv):
    mod = _cli(package)
    mod.run(mod.make_parser().parse_args(argv))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A source seen by every mic plus noise, per utterance; utt0 as one
    file per channel (a glob entry), the rest as multi-channel files;
    masks as .npy (scp) and as a kaldi archive."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(7)
    cfg = StftConfig()
    wav_lines, npy_lines, masks = [], [], {}
    for key, s in LENGTHS.items():
        clean = rng.standard_normal(s).astype(np.float32) * 0.2
        x = clean + rng.standard_normal((N_CH, s)).astype(np.float32) * 0.05
        if key == "utt0":
            for c in range(N_CH):
                jwave.write_wav(root / f"{key}.CH{c}.wav", x[c], sr=SR)
            wav_lines.append(f"{key} {root}/{key}.CH*.wav")
        else:
            jwave.write_wav(root / f"{key}.wav", x, sr=SR)
            wav_lines.append(f"{key} {root}/{key}.wav")
        m = rng.random((cfg.num_frames(s), cfg.num_bins)).astype(np.float32)
        np.save(root / f"{key}.npy", m)
        npy_lines.append(f"{key} {root}/{key}.npy")
        masks[key] = m
    (root / "wav.scp").write_text("\n".join(wav_lines) + "\n")
    (root / "mask.scp").write_text("\n".join(npy_lines) + "\n")
    with jio.ArchiveWriter(str(root / "mask.ark"),
                           str(root / "mask_ark.scp")) as writer:
        for key, m in masks.items():
            writer.write(key, m)
    return root


@pytest.mark.parametrize("fmt", ["numpy", "kaldi"])
@pytest.mark.parametrize("chunk", [-1, 16])
def test_cli_matches_setk_tpu_cli(corpus, tmp_path, fmt, chunk):
    mask = corpus / ("mask.scp" if fmt == "numpy" else "mask_ark.scp")
    common = [str(corpus / "wav.scp"), str(mask), "--fmt", fmt,
              "--batch-size", "2", "--chunk-size", str(chunk)]
    _run("setk_tpu", common[:2] + [str(tmp_path / "jax")] + common[2:])
    _run("setk_tpu_torch", common[:2] + [str(tmp_path / "port")] +
         common[2:] + ["--device", "cpu"])
    for key, s in LENGTHS.items():
        ref = jwave.read_wav(tmp_path / "jax" / f"{key}.wav",
                             normalize=False)
        got = jwave.read_wav(tmp_path / "port" / f"{key}.wav",
                             normalize=False)
        assert got.shape == ref.shape == (s,)
        assert np.abs(got - ref).max() <= LSB_TOL
        assert np.abs(ref).max() > 1000  # a real signal, not silence


def test_cli_refuses_before_reading(monkeypatch, tmp_path):
    missing = [str(tmp_path / "none.scp"), str(tmp_path / "none_mask.scp"),
               str(tmp_path / "out")]
    for extra in ([], ["--batch-size", "1"],
                  ["--batch-size", "2", "--itf-mask", "itf.scp"],
                  ["--batch-size", "2", "--mask", "true"],
                  ["--batch-size", "2", "--vad-proportion", "0.7"],
                  ["--batch-size", "2", "--pmwf-ref", "1"],
                  ["--batch-size", "2", "--rank1-appro", "eig"]):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 14"):
            _run("setk_tpu_torch", missing + extra + ["--device", "cpu"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _run("setk_tpu_torch", missing + ["--batch-size", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        _run("setk_tpu_torch", missing + ["--batch-size", "2",
                                          "--data-parallel"])
    for extra in (["--beamformer", "gevd"], ["--ban", "true"]):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 1 item 13"):
            _run("setk_tpu_torch", missing + ["--batch-size", "2",
                                              "--chunk-size", "32"] + extra)
    assert not (tmp_path / "out").exists()


def test_profile_dir_writes_a_trace(corpus, tmp_path):
    _run("setk_tpu_torch", [str(corpus / "wav.scp"), str(corpus / "mask.scp"),
                            str(tmp_path / "out"), "--batch-size", "2",
                            "--device", "cpu", "--jax-profile-dir",
                            str(tmp_path / "prof")])
    trace_json = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace_json["traceEvents"]
    assert sorted(p.stem for p in (tmp_path / "out").glob("*.wav")) == \
        sorted(LENGTHS)


def test_meter_and_annotated_trace(tmp_path):
    meter = ThroughputMeter("test")
    meter.update(4.0)
    meter.update(6.0)
    assert meter.audio_seconds == 10.0 and meter.num_updates == 2
    assert meter.rate() > 0 and meter.rtf() > 0
    meter.reset()
    assert meter.audio_seconds == 0.0 and meter.num_updates == 0
    with trace(""):
        pass
    with trace(tmp_path / "prof"):
        with annotate("port-matmul"):
            float((torch.ones(8, 8) @ torch.ones(8, 8)).sum())
    assert "port-matmul" in (tmp_path / "prof" / "trace.json").read_text()


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_wave_round_trip(tmp_path, writer_pkg):
    rng = np.random.default_rng(1)
    samps = (rng.random((3, 1000)) * 1.8 - 0.9).astype(np.float32)
    w, r = (twave, jwave) if writer_pkg == "port" else (jwave, twave)
    w.write_wav(tmp_path / "a.wav", samps, sr=SR)
    jwave.write_wav(tmp_path / "ref.wav", samps, sr=SR)
    assert (tmp_path / "a.wav").read_bytes() == \
        (tmp_path / "ref.wav").read_bytes()
    got = r.read_wav(tmp_path / "a.wav", sr=SR)
    np.testing.assert_allclose(got, samps, atol=1.0 / 32768)
    assert r.wav_info(tmp_path / "a.wav") == (3, SR, 1000)


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_kaldi_and_exraw_round_trip(tmp_path, writer_pkg):
    rng = np.random.default_rng(2)
    objs = {"fm": rng.standard_normal((5, 7)).astype(np.float32),
            "fv": rng.standard_normal(9).astype(np.float32),
            "cm": (rng.standard_normal((4, 3)) + 1j *
                   rng.standard_normal((4, 3))).astype(np.complex64)}
    w, r = (tio, jio) if writer_pkg == "port" else (jio, tio)
    with w.ArchiveWriter(str(tmp_path / "a.ark"),
                         str(tmp_path / "a.scp")) as writer:
        for key, obj in objs.items():
            writer.write(key, obj)
    reader = r.ScriptReader(str(tmp_path / "a.scp"))
    for key, obj in objs.items():
        np.testing.assert_array_equal(reader[key], obj)
    assert [k for k, _ in r.ArchiveReader(str(tmp_path / "a.ark"))] == \
        list(objs)
    with w.ExrawWriter(str(tmp_path / "a.exraw"),
                       str(tmp_path / "exraw.scp")) as writer:
        for key in ("fm", "fv"):
            writer.write(key, objs[key])
    reader = r.ExrawScriptReader(str(tmp_path / "exraw.scp"))
    for key in ("fm", "fv"):
        np.testing.assert_array_equal(reader[key], objs[key])


def test_spectrogram_reader_matches_setk_tpu(corpus):
    cfg = StftConfig()
    port = tio.SpectrogramReader(str(corpus / "wav.scp"), cfg=cfg,
                                 transpose=False)
    ref = jio.SpectrogramReader(str(corpus / "wav.scp"), cfg=JaxStftConfig(),
                                transpose=False)
    for key in LENGTHS:
        got, want = port[key], np.asarray(ref[key])
        assert got.shape == want.shape == (N_CH, cfg.num_bins,
                                           cfg.num_frames(LENGTHS[key]))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_prefetch_loader_matches_python_reader(corpus, tmp_path):
    scp = tmp_path / "wav.scp"
    lines = (corpus / "wav.scp").read_text().splitlines()
    # a pipe entry: the native path cannot serve it, the Python decoder does
    lines.append(f"piped cat {corpus}/utt1.wav |")
    scp.write_text("\n".join(lines) + "\n")
    ref = dict(jio.WaveReader(str(scp), native=False))
    got = {k: v for k, v in PrefetchWaveLoader(str(scp), window=2)}
    assert list(got) == list(ref) == [*LENGTHS, "piped"]
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key])
    # the native library builds from native/wav_io.cc into the port's own
    # build directory wherever a host C++ compiler is present
    if native.native_available():
        assert native.BUILD_DIR == ROOT / "setk_tpu_torch" / "_build"
        assert list(native.BUILD_DIR.glob("libwav_io-*.so"))


@pytest.mark.parametrize("n,bucket", [(63, 16), (64, 16), (5, 64)])
def test_cli_common_matches_setk_tpu(n, bucket):
    from setk_tpu.cli import common as jcommon
    from setk_tpu_torch.cli import common as tcommon
    arr = np.arange(3 * n, dtype=np.float32).reshape(3, n)
    got, got_n = tcommon.pad_to_bucket(arr, axis=-1, bucket=bucket)
    ref, ref_n = jcommon.pad_to_bucket(arr, axis=-1, bucket=bucket)
    np.testing.assert_array_equal(got, ref)
    assert got_n == ref_n == n
    for value in ("yes", "0", "True", "off"):
        assert tcommon.strtobool(value) == jcommon.strtobool(value)
    args = tcommon.StftParser.parser.parse_args(["--frame-hop", "128"])
    assert tcommon.stft_config_from_args(args) == StftConfig(frame_hop=128)


def test_module_entry_lists_the_command():
    out = subprocess.run(
        [sys.executable, "-m", "setk_tpu_torch.cli", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "apply_adaptive_beamformer" in out.stdout.split()


FORBIDDEN = ("jax", "setk_tpu", "flax", "optax", "msgpack")


def test_port_imports_neither_jax_nor_setk_tpu():
    code = f"""
import importlib, importlib.util, pkgutil, sys
import setk_tpu_torch
names = [m.name for m in pkgutil.walk_packages(setk_tpu_torch.__path__,
                                               "setk_tpu_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r})
print(len(names), bad)
assert not bad, bad
assert "setk_tpu_torch.cli.apply_adaptive_beamformer" in names
assert "setk_tpu_torch.io.prefetch" in names
assert "setk_tpu_torch.models.trainer" in names
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    # imports made only when a function runs count too: scan the syntax
    # trees of every module, of chip_smoke.py and of the port's tools at
    # any depth
    files = sorted((ROOT / "setk_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {name}"
                    for name in names
                    if name.split(".")[0] in FORBIDDEN]
    assert len(files) > 40 and not bad, bad
