"""The port's localization CLIs against setk_tpu's, and the slice's
commands on a card as far as they can tell.

Each command runs with ``--device cpu`` and setk_tpu's runs on the same
scp (tests/spatial_scene.py: a far-field source in noise bursts, the
sensor noise at 0.05 of the source, 2 utterances of 1 s on the default
4-mic line and 6-mic circle, grids of 61 and 72 DoAs):

- compute_steer_vector: the .npy bit-equal;
- do_ssl (ml, srp, music; offline, online with look-back, masked, two
  masks with winner-take-all): each DoA equal, or else the JAX scores of
  that chunk have their top two within the score tolerance of
  tests/test_torch_spatial.py (a near-tie two f32 paths may flip);
  offline DoAs within 2 grid steps of the scene's;
- on a CUDA device as far as the commands can tell (``torch.cuda``
  mocked, tensors kept on the CPU): compute_df_on_mask launches exactly
  masked_covar and hermitian_eigh once an utterance, music do_ssl
  exactly hermitian_eigh once an utterance (once a chunk online), ml
  do_ssl and the feature commands no kernel;
- without a card every command of this slice refuses the default
  ``--device cuda``.
"""

import importlib
import math

import numpy as np
import pytest
import torch

from setk_tpu.spatial import ssl as jssl
from setk_tpu_torch.cli.do_ssl import add_wta
from setk_tpu_torch.dsp.stft import StftConfig, forward_stft
from setk_tpu_torch.io.wave import read_wav
from setk_tpu_torch.ops import linalg as tla
from setk_tpu_torch.ops.cuda import covariance as mc
from setk_tpu_torch.ops.cuda import eigh_small as es
from setk_tpu_torch.utils.common import EPSILON

from spatial_scene import run_both, run_cli, write_corpus

SCORE_TOL = {"ml": 2e-5, "srp": 1e-5, "music": 1e-5}
DOAS = {"linear": (67.0, 121.0), "circular": (67.0, 250.0)}
SECONDS = (1.0, 1.0)
NUM_DOAS = {"linear": 61, "circular": 72}
DOA_RANGE = {"linear": "0,180", "circular": "0,360"}
SRP_PAIR = {"linear": "0,1;0,3;1,2", "circular": "0,3;1,4;2,5"}
CHUNK, LOOK_BACK = 24, 30


@pytest.fixture(scope="module", params=["linear", "circular"])
def corpus(request, tmp_path_factory):
    geometry = request.param
    root = tmp_path_factory.mktemp(f"spatial_{geometry}")
    info = write_corpus(root, geometry, DOAS[geometry], SECONDS,
                        seed=11 if geometry == "linear" else 12)
    for key in info:
        np.save(root / f"{key}.c.npy", 1.0 - np.load(root / f"{key}.npy"))
    (root / "mask_c.scp").write_text("".join(
        f"{key} {root}/{key}.c.npy\n" for key in info))
    sv = root / "sv.npy"
    run_cli("setk_tpu", "compute_steer_vector",
            [str(sv), "--geometry", geometry, "--num-doas",
             str(NUM_DOAS[geometry])])
    return geometry, root, info, sv


@pytest.mark.parametrize("geometry,center", [("linear", "false"),
                                             ("circular", "false"),
                                             ("circular", "true")])
def test_compute_steer_vector_bit_equal(tmp_path, geometry, center):
    argv = ["--geometry", geometry, "--num-bins", "129",
            "--circular-center", center]
    run_cli("setk_tpu", "compute_steer_vector",
            [str(tmp_path / "j.npy")] + argv)
    run_cli("setk_tpu_torch", "compute_steer_vector",
            [str(tmp_path / "t.npy")] + argv)
    ref, got = np.load(tmp_path / "j.npy"), np.load(tmp_path / "t.npy")
    assert got.dtype == np.complex64 and np.array_equal(got, ref)


def _read_doas(path):
    rows = {}
    for line in path.read_text().splitlines():
        key, vals = line.split("\t")
        rows[key] = [float(v) for v in vals.split()]
    return rows


def _index_error(geometry, num_doas, output, doa):
    """Grid steps between the CLI's DoA and the scene's.  The CLI maps
    index i to linspace(min, max, A + 1)[i] (the reference's mapping);
    the grid's i-th DoA is linspace(0, 180, A)[i] on a line and
    i 360 / A on a circle."""
    lo, hi = map(float, DOA_RANGE[geometry].split(","))
    idx = int(np.argmin(np.abs(np.linspace(lo, hi, num_doas + 1) - output)))
    if geometry == "linear":
        return abs(idx - int(np.argmin(np.abs(
            np.linspace(0, 180, num_doas) - doa))))
    d = abs(idx - round(doa * num_doas / 360)) % num_doas
    return min(d, num_doas - d)


def _chunk_scores(backend, stft, sv, mask, srp_pair):
    if backend == "srp":
        pairs = [tuple(map(int, p.split(","))) for p in srp_pair.split(";")]
        return np.asarray(jssl.srp_ssl(
            stft, sv, ([p[0] for p in pairs], [p[1] for p in pairs]),
            mask=mask, return_scores=True)[1])
    if backend == "ml":
        return np.asarray(jssl.ml_ssl(stft, sv, mask=mask, compression=-1,
                                      eps=EPSILON, return_scores=True)[1])
    return -np.asarray(jssl.music_ssl(stft, sv, mask=mask,
                                      return_scores=True)[1])


SSL_CASES = [("ml", False, ""), ("ml", True, "mask"), ("srp", False, "mask"),
             ("srp", True, ""), ("music", False, ""),
             ("music", True, "mask"), ("ml", False, "wta")]


@pytest.mark.parametrize("backend,online,masks", SSL_CASES,
                         ids=[f"{b}-{'online' if o else 'offline'}-{m}"
                              for b, o, m in SSL_CASES])
def test_do_ssl_matches_setk_tpu(corpus, tmp_path, backend, online, masks):
    geometry, root, info, sv = corpus
    extra = ["--backend", backend, "--doa-range", DOA_RANGE[geometry]]
    if backend == "srp":
        extra += ["--srp-pair", SRP_PAIR[geometry]]
    if online:
        extra += ["--chunk-len", str(CHUNK), "--look-back", str(LOOK_BACK)]
    if masks == "mask":
        extra += ["--mask-scp", str(root / "mask_ft.scp")]
    elif masks == "wta":
        # the complement wins where it is larger: winner-take-all
        extra += ["--mask-scp", f"{root / 'mask.scp'},"
                  f"{root / 'mask_c.scp'}", "--mask-eps", "0.01"]
    ref_dir, got_dir = run_both(
        "do_ssl", lambda out: [str(root / "wav.scp"), str(sv),
                               str(out / "doa")] + extra, tmp_path)
    ref, got = _read_doas(ref_dir / "doa"), _read_doas(got_dir / "doa")
    assert list(got) == list(ref) == list(info)
    grid = np.load(sv)
    cfg = StftConfig()
    for key, (doa, frames, _) in info.items():
        assert len(got[key]) == (math.ceil(frames / CHUNK) if online else 1)
        if not online and masks != "wta":
            assert _index_error(geometry, grid.shape[0], got[key][0],
                                doa) <= 2, (key, got[key])
        for c, (g, r) in enumerate(zip(got[key], ref[key])):
            if g == r:
                continue
            # a flip: allowed only at a near-tie of the JAX scores
            wav = read_wav(root / f"{key}.wav")
            stft = forward_stft(torch.from_numpy(wav), cfg).numpy()
            mask = np.load(root / f"{key}.npy") if masks else None
            if masks == "wta":
                mask = add_wta([mask, 1.0 - mask], eps=0.01)[0]
            if online:
                s = max(c * CHUNK - LOOK_BACK, 0)
                stft = stft[:, s:(c + 1) * CHUNK]
                mask = None if mask is None else mask[s:(c + 1) * CHUNK]
            sc = np.sort(_chunk_scores(backend, stft, grid, mask,
                                       SRP_PAIR[geometry]))
            assert sc[-1] - sc[-2] <= SCORE_TOL[backend] * np.abs(sc).max()


@pytest.fixture
def card(monkeypatch):
    """A CUDA device as far as the commands and ops.linalg can tell,
    tensors kept on the CPU: the kernel wrappers a command reaches are
    counted around their plain versions."""
    from setk_tpu_torch.enhance import beamformer as bf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for command in COMMANDS:
        mod = importlib.import_module(f"setk_tpu_torch.cli.{command}")
        if hasattr(mod, "resolve_device"):
            monkeypatch.setattr(mod, "resolve_device",
                                lambda device=None: torch.device("cpu"))
    monkeypatch.setattr(tla, "_on_card", lambda a: True)
    monkeypatch.setattr(bf, "_on_card", lambda x: True)
    counts = {}

    def count(module, name, fn):
        def wrapped(*args, **kwargs):
            counts[name] = counts.get(name, 0) + 1
            return fn(*args, **kwargs)
        monkeypatch.setattr(module, name, wrapped)

    count(tla, "hermitian_eigh", es.hermitian_eigh_plain)
    count(bf, "masked_covar", mc.masked_covar_plain)
    return counts


LAUNCH_CASES = [
    ("compute_df_on_mask", lambda r, sv, out: [
        str(r / "wav.scp"), str(r / "mask.scp"), str(out / "f.ark"),
        "--fmt", "numpy"], {"masked_covar": 1, "hermitian_eigh": 1}),
    ("do_ssl", lambda r, sv, out: [
        str(r / "wav.scp"), str(sv), str(out / "doa"), "--backend",
        "music"], {"hermitian_eigh": 1}),
    ("do_ssl", lambda r, sv, out: [
        str(r / "wav.scp"), str(sv), str(out / "doa"), "--backend",
        "music", "--chunk-len", str(CHUNK)], {"hermitian_eigh": "chunks"}),
    ("do_ssl", lambda r, sv, out: [
        str(r / "wav.scp"), str(sv), str(out / "doa"), "--backend", "ml",
        "--mask-scp", str(r / "mask.scp")], {}),
    ("compute_df_on_geometry", lambda r, sv, out: [
        str(r / "wav.scp"), str(sv), str(out / "f.ark")], {}),
    ("compute_ipd_and_linear_srp", lambda r, sv, out: [
        str(r / "wav.scp"), str(out / "f.ark"), "--type", "msc"], {}),
]


@pytest.mark.parametrize("command,argv,want", LAUNCH_CASES,
                         ids=["df_on_mask", "music", "music-online", "ml",
                              "df_on_geometry", "msc"])
def test_launch_sets(card, corpus, tmp_path, command, argv, want):
    _, root, info, sv = corpus
    run_cli("setk_tpu_torch", command, argv(root, sv, tmp_path), device=None)
    chunks = sum(math.ceil(frames / CHUNK) for _, frames, _ in
                 info.values())
    assert card == {k: chunks if v == "chunks" else v * len(info)
                    for k, v in want.items()}, command


COMMANDS = ["wav_separate", "oracle_separate", "compute_steer_vector",
            "do_ssl", "apply_classic_beamformer", "apply_ds_beamformer",
            "apply_sd_beamformer", "apply_fixed_beamformer",
            "compute_circular_srp", "compute_ipd_and_linear_srp",
            "compute_df_on_geometry", "compute_df_on_mask"]


@pytest.mark.parametrize("command", COMMANDS)
def test_refuses_cuda_without_a_card(tmp_path, command):
    """--device defaults to cuda; with no card the command raises before
    reading anything, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = importlib.import_module(f"setk_tpu_torch.cli.{command}")
    missing = str(tmp_path / "missing")
    positionals = [a.dest for a in mod.make_parser()._actions
                   if not a.option_strings]
    args = mod.make_parser().parse_args([missing] * len(positionals))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.run(args)
