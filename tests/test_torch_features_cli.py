"""The port's spatial-feature CLIs against setk_tpu's.

Each command runs with ``--device cpu`` and setk_tpu's runs on the same
scp (tests/spatial_scene.py: a far-field source in noise bursts, the
sensor noise at 0.05 of the source, 2 utterances of 0.6 and 1 s on the
default 4-mic line and 6-mic circle): compute_circular_srp,
compute_ipd_and_linear_srp (srp, ipd, msc), compute_df_on_geometry and
compute_df_on_mask.

Every archive is within 1e-5 of its peak (IPD by the wrapped difference
min(|d|, 2 pi - |d|)), plus, for the features made of phases, the error
the readers' STFTs carry into them.  Each package reads the wav through
its own STFT; the two differ by a gap d of ~1e-7 of the peak, which moves
a bin's phase by at most min(pi, pi d / |X|): a bin near zero magnitude
takes an arbitrary phase, and PHAT weighs every bin alike.  Frame 0's
spectrum is real under the center reflect padding (its frame is
symmetric), so there the phases are 0 or pi up to rounding.  So each
element's bar adds that phase bound carried through the feature (a
pair's sum for IPD, the mean over pairs for DF, the sum over bins over
the pair's peak, twice, for GCC/SRP), and outside frame 0 at most 0.1 %
of the elements may exceed 1e-5 of the peak at all.  On identical
spectra tests/test_torch_spatial.py holds the functions to 1e-5 flat.
"""

import numpy as np
import pytest
import torch

from setk_tpu.dsp.stft import StftConfig as JaxStftConfig
from setk_tpu.io import SpectrogramReader as JaxSpectrogramReader
from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.io import ScriptReader, SpectrogramReader
from setk_tpu_torch.spatial import features as tft
from setk_tpu_torch.utils.common import EPSILON

from spatial_scene import run_both, run_cli, write_corpus

FEAT_TOL = 1e-5
OUTLIERS = 1e-3
DOAS = {"linear": (67.0, 121.0), "circular": (67.0, 250.0)}
SECONDS = (0.6, 1.0)
NUM_DOAS = {"linear": 61, "circular": 72}


@pytest.fixture(scope="module", params=["linear", "circular"])
def corpus(request, tmp_path_factory):
    """(geometry, root, steering grid, {key: (N, T, F) phase bound, the
    port's STFT})."""
    geometry = request.param
    root = tmp_path_factory.mktemp(f"features_{geometry}")
    write_corpus(root, geometry, DOAS[geometry], SECONDS,
                 seed=21 if geometry == "linear" else 22)
    sv = root / "sv.npy"
    run_cli("setk_tpu", "compute_steer_vector",
            [str(sv), "--geometry", geometry, "--num-doas",
             str(NUM_DOAS[geometry])])
    jax_reader = JaxSpectrogramReader(str(root / "wav.scp"),
                                      cfg=JaxStftConfig())
    phase = {}
    for key, x in SpectrogramReader(str(root / "wav.scp"),
                                    cfg=StftConfig()):
        gap = np.abs(x - jax_reader[key]).max()
        phase[key] = (np.minimum(np.pi, np.pi * gap / np.maximum(
            np.abs(x), 1e-30)), x)
    return geometry, root, sv, phase


def _gcc_bound(phase, x, pairs, transform_of, smooth=0):
    """Row bound (T, 1) of pair-averaged normalized GCC: a pair's
    unnormalized row moves by at most the sum of its bins' phase bounds,
    and the normalization by the pair's peak m at most doubles that."""
    rows = []
    for i, j in pairs:
        e = (phase[i] + phase[j]).sum(-1)              # T
        raw = tft._phase_spectrum(torch.from_numpy(x[i]),
                                  torch.from_numpy(x[j]), transform_of(i, j),
                                  normalize=False, apply_floor=False)
        m = max(float(raw.abs().max()), EPSILON)
        rows.append((e + e.max()) / m)
    rows = torch.from_numpy(np.mean(rows, axis=0)[:, None])
    return tft.smooth_angular_spectrogram(rows, smooth).numpy()


def _archives(ref_dir, got_dir, bound, wrapped=False):
    """Every archive within FEAT_TOL of its peak plus ``bound[key]``
    (broadcast to the feature); outside frame 0 all but OUTLIERS of its
    elements within FEAT_TOL of the peak alone."""
    ref = dict(ScriptReader(str(ref_dir / "feats.scp")))
    got = dict(ScriptReader(str(got_dir / "feats.scp")))
    assert list(got) == list(ref) and ref
    for key, r in ref.items():
        g = got[key]
        assert g.shape == r.shape and np.isfinite(g).all(), key
        d = np.abs(g - r)
        if wrapped:
            d = np.minimum(d, 2 * np.pi - d)
        tol = FEAT_TOL * np.abs(r).max()
        extra = np.broadcast_to(bound(key), d.shape)
        assert (d <= tol + extra).all(), (key, ((d - extra) / tol).max())
        assert np.mean(d[1:] > tol) <= OUTLIERS, (key, np.mean(d[1:] > tol))
    return ref


def _pairs(text):
    return [tuple(map(int, p.split(","))) for p in text.split(";")]


def _feats_argv(root, out, *extra):
    return [str(root / "wav.scp"), str(out / "feats.ark"), "--scp",
            str(out / "feats.scp")] + list(extra)


@pytest.mark.parametrize("smooth", [0, 2])
def test_compute_circular_srp(corpus, tmp_path, smooth):
    _, root, _, phase = corpus
    pairs = [(0, 2), (1, 3)]
    ref_dir, got_dir = run_both(
        "compute_circular_srp", lambda out: _feats_argv(
            root, out, "--diag-pair", "0,2;1,3", "--n", "4",
            "--smooth-context", str(smooth)), tmp_path)

    def transform(i, j):
        tau = np.cos(min(i, j) * np.pi * 2 / 4 - np.linspace(
            0, 2 * np.pi, 121)) * 0.1 / 343
        omega = np.linspace(0, 8000, 257) * 2 * np.pi
        return np.exp(-1j * np.outer(omega, tau)).astype(np.complex64)

    _archives(ref_dir, got_dir, lambda key: _gcc_bound(
        *phase[key], pairs, transform, smooth))


IPD_CASES = [("srp", []), ("srp", ["--srp.samp-tdoa", "true",
                                   "--srp.smooth-context", "1"]),
             ("ipd", ["--ipd.pair", "0,1;1,3"]),
             ("ipd", ["--ipd.pair", "0,2", "--ipd.cos", "true"]),
             ("ipd", ["--ipd.pair", "0,3", "--ipd.cos", "true",
                      "--ipd.sin", "true"]),
             ("msc", ["--msc.ctx", "2"])]


@pytest.mark.parametrize("kind,extra", IPD_CASES,
                         ids=["srp", "srp-tdoa-smooth", "ipd", "cos-ipd",
                              "cos-sin-ipd", "msc"])
def test_compute_ipd_and_linear_srp(corpus, tmp_path, kind, extra):
    geometry, root, _, phase = corpus
    pos = [0.05 * k for k in range(4 if geometry == "linear" else 6)]
    topo = ",".join(f"{p:g}" for p in pos)
    ref_dir, got_dir = run_both(
        "compute_ipd_and_linear_srp", lambda out: _feats_argv(
            root, out, "--type", kind, "--linear-topo", topo, *extra),
        tmp_path)
    if kind == "srp":
        tdoa = "--srp.samp-tdoa" in extra
        pairs = [(i, j) for i in range(len(pos))
                 for j in range(i + 1, len(pos))]

        def bound(key):
            return _gcc_bound(*phase[key], pairs, lambda i, j: (
                tft.linear_tdoa_grid(pos[j] - pos[i], num_bins=257,
                                     samp_doa=not tdoa)), 1 if tdoa else 0)
    elif kind == "ipd":
        copies = 2 if "--ipd.sin" in extra else 1

        def bound(key):
            p = phase[key][0]
            return np.concatenate([p[i] + p[j] for i, j in _pairs(extra[1])
                                   for _ in range(copies)], axis=-1)
    else:
        def bound(key):
            return 0
    _archives(ref_dir, got_dir, bound,
              wrapped=kind == "ipd" and "--ipd.cos" not in extra)


def _df_bound(phase, pairs, copies=1):
    return np.tile(np.mean([phase[i] + phase[j] for i, j in pairs], 0),
                   (1, copies))


@pytest.mark.parametrize("how", ["one", "several", "utt2idx"])
def test_compute_df_on_geometry(corpus, tmp_path, how):
    _, root, sv, phase = corpus
    pairs = "0,1;0,2;1,3"
    extra = ["--df-pair", pairs]
    if how == "one":
        extra += ["--doa-idx", "22"]
    elif how == "several":
        extra += ["--doa-idx", "5,22,50"]
    else:
        first = next(iter(phase))
        (tmp_path / "utt2idx").write_text(f"{first} 22\n")
        extra += ["--utt2idx", str(tmp_path / "utt2idx")]  # one key only
    ref_dir, got_dir = run_both(
        "compute_df_on_geometry", lambda out: [
            str(root / "wav.scp"), str(sv), str(out / "feats.ark"),
            "--scp", str(out / "feats.scp")] + extra, tmp_path)
    ref = _archives(ref_dir, got_dir, lambda key: _df_bound(
        phase[key][0], _pairs(pairs), 3 if how == "several" else 1))
    assert len(ref) == (1 if how == "utt2idx" else 2)


@pytest.mark.parametrize("layout", ["mask", "mask_ft"])
def test_compute_df_on_mask(corpus, tmp_path, layout):
    _, root, _, phase = corpus
    pairs = "0,1;0,2;1,3"
    ref_dir, got_dir = run_both(
        "compute_df_on_mask", lambda out: [
            str(root / "wav.scp"), str(root / f"{layout}.scp"),
            str(out / "feats.ark"), "--scp", str(out / "feats.scp"),
            "--fmt", "numpy", "--df-pair", pairs], tmp_path)
    _archives(ref_dir, got_dir, lambda key: _df_bound(phase[key][0],
                                                      _pairs(pairs)))
