"""The planar and spectrum-domain paths of setk_tpu_torch against setk_tpu
on the CPU, and the CUDA entry's dispatch over STFT geometries.

Inputs are made with numpy and handed to both packages; the Pallas
kernels run in interpret mode, as tests/test_pallas.py runs them:
- kernel 9's plain version (``stft_planar_plain``) against
  ``forward_stft_pallas_planar`` on the valid frames, n_fft 512 and 1024,
  hop-aligned and unaligned S, center on and off: 1e-4 of the spectrum's
  peak (tests/test_pallas.py:102-147's bar);
- kernel 10's (``istft_planar_plain``) against
  ``inverse_stft_pallas_planar`` where the JAX kernel applies
  (nsamps == (T-1) hop) and against the JAX ``inverse_stft`` for other
  lengths: 1e-4 of the peak;
- kernels 11 and 12's (``pair_covar_complement_plain``,
  ``pair_covar_plain``) against the Pallas pair kernels, and the port's
  ``compute_covar_pair`` against ``compute_covar_pair_pallas``: 1e-4;
  near-one masks keep Rn positive semi-definite (test_pallas.py:91-99);
- ``mvdr_enhance_planar`` (plain versions on CPU tensors) against the JAX
  ``mvdr_enhance_planar`` and ``enhance_batch`` at 512/128 against the
  JAX ``enhance_batch`` (power steer): 1e-3 of the peak, the JAX
  package's bar for its planar pipeline (test_pallas.py:150-193);
- the CUDA entry with ``torch.cuda`` mocked (tensors kept on the CPU, so
  the wrappers run their plain versions): which branch and which
  wrappers run for each geometry, and that every refusal comes before
  anything is copied to the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from setk_tpu.dsp.stft import StftConfig as JaxStftConfig
from setk_tpu.dsp.stft import inverse_stft as jax_inverse_stft
from setk_tpu.enhance.pipeline import mvdr_enhance_planar as jax_planar
from setk_tpu.ops.pallas.covariance_pair import (compute_covar_pair_pallas,
                                                 pair_covar_complement_pallas,
                                                 pair_covar_pallas)
from setk_tpu.ops.pallas.stft import (forward_stft_pallas_planar,
                                      inverse_stft_pallas_planar)
from setk_tpu.parallel.enhance_step import enhance_batch as jax_enhance
from setk_tpu_torch.convert import stft_config_from_fields
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance import pipeline
from setk_tpu_torch.ops.cuda import covariance_pair as cp
from setk_tpu_torch.ops.cuda import planar as pl
from setk_tpu_torch.parallel import enhance_step
from setk_tpu_torch.parallel import executor as tex
from setk_tpu_torch.parallel.enhance_step import enhance_batch

KERNEL_TOL = 1e-4   # the JAX package's bar for its planar kernels
SLICE_TOL = 1e-3    # and for its planar pipeline


def _cfgs(**fields):
    jcfg = JaxStftConfig(**fields)
    return jcfg, stft_config_from_fields(**dataclasses.asdict(jcfg))


def _peak_err(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _scene(seed, b, n, s, cfg, int16=False):
    """A source seen by every mic plus independent noise, and a mask."""
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((b, 1, s)).astype(np.float32) * 0.2
    wav = clean + rng.standard_normal((b, n, s)).astype(np.float32) * 0.05
    if int16:
        wav = np.clip(wav * 32768, -32768, 32767).astype(np.int16)
    mask = rng.random((b, cfg.num_frames(s), cfg.num_bins)).astype(
        np.float32)
    return wav, mask


@pytest.mark.parametrize("n_fft,s,center", [
    (512, 16384, True), (512, 12000, True), (512, 10000, False),
    (1024, 16384, True), (1024, 9000, False)])
def test_stft_planar_plain_matches_pallas(n_fft, s, center):
    jcfg, cfg = _cfgs(frame_len=n_fft, frame_hop=n_fft // 2, center=center)
    x = np.random.default_rng(s).standard_normal((2, 2, s)).astype(
        np.float32)
    t = cfg.num_frames(s)
    want = [np.asarray(p)[..., :t, :] if p.ndim == 4 else
            np.asarray(p)[..., :t] for p in forward_stft_pallas_planar(
                jnp.asarray(x), jcfg, interpret=True)]
    got = pl.stft_planar_plain(torch.from_numpy(x),
                               torch.as_tensor(cfg.padded_window), center)
    peak = np.abs(want[0] + 1j * want[1]).max()
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() / peak < KERNEL_TOL


@pytest.mark.parametrize("n_fft,t,extra", [
    (512, 40, 0), (1024, 21, 0), (512, 40, -300), (512, 33, 777),
    (1024, 21, -5)])
def test_istft_planar_plain_matches_jax(n_fft, t, extra):
    """extra == 0: nsamps == (T-1) hop, the JAX kernel's case; otherwise
    the JAX inverse_stft, which zero-pads after the center trim."""
    jcfg, cfg = _cfgs(frame_len=n_fft, frame_hop=n_fft // 2)
    fh = n_fft // 2
    rng = np.random.default_rng(n_fft + t)
    er, ei = rng.standard_normal((2, 2, t, fh)).astype(np.float32)
    ny = rng.standard_normal((2, t)).astype(np.float32)
    nsamps = (t - 1) * fh + extra
    if extra == 0:
        want = np.asarray(inverse_stft_pallas_planar(
            jnp.asarray(er), jnp.asarray(ei), jnp.asarray(ny), jcfg,
            n_frames=t, nsamps=nsamps, interpret=True))
    else:
        spec = (np.concatenate([er, ny[..., None]], -1) + 1j *
                np.concatenate([np.zeros_like(ny)[..., None], ei[..., 1:],
                                np.zeros_like(ny)[..., None]], -1))
        want = np.asarray(jax_inverse_stft(jnp.asarray(spec), jcfg,
                                           nsamps=nsamps))
    wss = torch.from_numpy(pl.istft_wss_inverse(cfg.padded_window, t,
                                                nsamps))
    got = pl.istft_planar_plain(torch.from_numpy(er), torch.from_numpy(ei),
                                torch.from_numpy(ny),
                                torch.as_tensor(cfg.padded_window), wss,
                                nsamps)
    assert _peak_err(got, want) < KERNEL_TOL
    if extra > 0:
        assert not got[:, (t - 1) * fh:].any()


def _planes(rng, b, n, t, f):
    re, im = rng.standard_normal((2, b, n, t, f)).astype(np.float32)
    return re, im, rng.random((b, t, f)).astype(np.float32)


def _numerators(planes):
    rs_re, rs_im, rn_re, rn_im = (np.asarray(p) for p in planes)
    return rs_re + 1j * rs_im, rn_re + 1j * rn_im


@pytest.mark.parametrize("n", [1, 4])
def test_pair_covar_plains_match_pallas(n):
    rng = np.random.default_rng(n)
    re, im, ms = _planes(rng, 2, n, 24, 128)
    want = _numerators(pair_covar_complement_pallas(
        jnp.asarray(re), jnp.asarray(im), jnp.asarray(ms), n_valid_t=19,
        interpret=True))
    got = _numerators(cp.pair_covar_complement_plain(
        torch.from_numpy(re), torch.from_numpy(im), torch.from_numpy(ms),
        n_valid_t=19))
    for g, w in zip(got, want):
        assert _peak_err(g, w) < KERNEL_TOL
    mn = rng.random(ms.shape).astype(np.float32)
    want = _numerators(pair_covar_pallas(jnp.asarray(re), jnp.asarray(im),
                                         jnp.asarray(ms), jnp.asarray(mn),
                                         interpret=True))
    got = _numerators(cp.pair_covar_plain(
        torch.complex(torch.from_numpy(re), torch.from_numpy(im)),
        torch.from_numpy(ms), torch.from_numpy(mn)))
    for g, w in zip(got, want):
        assert _peak_err(g, w) < KERNEL_TOL


@pytest.mark.parametrize("explicit", [False, True])
def test_compute_covar_pair_matches_pallas(explicit):
    """The spectrum-domain covariance pair (kernel 12's plain version on
    CPU tensors) against compute_covar_pair_pallas, F = 37 (the JAX
    wrapper pads it to 128 lanes), with and without an explicit
    interference mask."""
    rng = np.random.default_rng(11)
    obs = (rng.standard_normal((2, 37, 4, 60)) +
           1j * rng.standard_normal((2, 37, 4, 60))).astype(np.complex64)
    ms = rng.random((2, 37, 60)).astype(np.float32)
    mn = rng.random((2, 37, 60)).astype(np.float32) if explicit else None
    want = compute_covar_pair_pallas(
        jnp.asarray(obs), jnp.asarray(ms),
        None if mn is None else jnp.asarray(mn), interpret=True)
    got = bf.compute_covar_pair(torch.from_numpy(obs), torch.from_numpy(ms),
                                None if mn is None else torch.from_numpy(mn))
    for g, w in zip(got, want):
        assert g.dtype == torch.complex64
        assert _peak_err(g, w) < KERNEL_TOL


def test_pair_covar_oracle_mask_stays_psd():
    """Near-one masks: Rn from the literal (1 - m) sum stays PSD."""
    rng = np.random.default_rng(12)
    re, im, _ = _planes(rng, 1, 4, 64, 8)
    mask = (1.0 - 1e-6 * rng.random((1, 64, 8))).astype(np.float32)
    for planes in (
            cp.pair_covar_complement_plain(torch.from_numpy(re),
                                           torch.from_numpy(im),
                                           torch.from_numpy(mask), 64),
            cp.pair_covar_plain(torch.complex(torch.from_numpy(re),
                                              torch.from_numpy(im)),
                                torch.from_numpy(mask),
                                torch.clamp(1 - torch.from_numpy(mask),
                                            min=0))):
        rn = np.moveaxis(_numerators(planes)[1], -1, 1)   # (B, F, N, N)
        assert np.linalg.eigvalsh(rn).min() > -1e-5


@pytest.mark.parametrize("n_fft,s,center,int16", [
    (512, 8000, True, False), (512, 8192, True, True),
    (1024, 8192, True, False), (512, 8192, False, False)])
def test_mvdr_enhance_planar_matches_jax(n_fft, s, center, int16):
    jcfg, cfg = _cfgs(frame_len=n_fft, frame_hop=n_fft // 2, center=center)
    wav, mask = _scene(n_fft + s, 2, 3, s, cfg, int16)
    wav_f = wav.astype(np.float32) / 32768.0 if int16 else wav
    want = np.asarray(jax_planar(jnp.asarray(wav_f), jnp.asarray(mask), jcfg,
                                 interpret=True))
    wt, mt = torch.from_numpy(wav), torch.from_numpy(mask)
    got = pipeline.mvdr_enhance_planar(wt, mt, cfg)
    # on the CPU the wrappers run their plain versions
    torch.testing.assert_close(
        got, pipeline.mvdr_enhance_planar_plain(wt, mt, cfg), rtol=0,
        atol=0)
    if not center:
        # the reference's guarded divide amplifies round-off where the
        # envelope vanishes at the two ends (ROADMAP queue 3)
        got, want = got[:, cfg.n_fft:-cfg.n_fft], want[:, cfg.n_fft:-cfg.n_fft]
    assert _peak_err(got, want) < SLICE_TOL


@pytest.mark.parametrize("name,ban", [("mvdr", False), ("mvdr", True),
                                      ("pmwf-0", False)])
def test_enhance_batch_spectrum_geometry_matches_jax(name, ban):
    jcfg, cfg = _cfgs(frame_len=512, frame_hop=128)
    wav, mask = _scene(21, 2, 3, 8000, cfg, int16=True)
    kw = {"steer": "power"} if name == "mvdr" else {}
    want = jax_enhance(jnp.asarray(wav), jnp.asarray(mask), jcfg,
                       beamformer=name, ban=ban, **kw)
    got = enhance_batch(wav, mask, cfg, beamformer=name, ban=ban,
                        device="cpu", **kw)
    assert _peak_err(got, want) < SLICE_TOL


@pytest.fixture
def mocked_card(monkeypatch):
    """A CUDA device as far as the entry can tell, tensors kept on the
    CPU; records each branch entry and each kernel wrapper called."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(enhance_step, "_as_tensor",
                        lambda x, dev: torch.as_tensor(x))
    calls = []

    def record(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    for name in ("enhance_fused", "mvdr_enhance_planar",
                 "mvdr_enhance_fused_online"):
        monkeypatch.setattr(enhance_step, name,
                            record(name, getattr(enhance_step, name)))
    monkeypatch.setattr(bf, "supervised_run",
                        record("supervised_run", bf.supervised_run))
    monkeypatch.setattr(cp, "pair_covar", record("pair_covar",
                                                 cp.pair_covar))
    monkeypatch.setattr(pipeline, "_KERNELS", pipeline._KERNELS._replace(**{
        name: record(name, getattr(pipeline._KERNELS, name))
        for name in ("stft_planar", "pair_covar_complement", "mvdr_power",
                     "istft_planar", "stft_covar", "beamform_istft")}))
    return calls


PLANAR = ["mvdr_enhance_planar", "stft_planar", "pair_covar_complement",
          "mvdr_power", "istft_planar"]
SPECTRUM = ["supervised_run", "pair_covar"]


@pytest.mark.parametrize("fields,s,nsamps,name,ban,want", [
    ({}, 4096, None, "mvdr", False,
     ["enhance_fused", "stft_covar", "mvdr_power", "beamform_istft"]),
    ({"frame_len": 1024, "frame_hop": 512}, 8192, None, "mvdr", False,
     PLANAR),
    ({}, 4000, None, "mvdr", False, PLANAR),
    ({}, 4096, 4000, "mvdr", False, PLANAR),
    ({"frame_len": 256, "frame_hop": 128}, 4096, None, "mvdr", False,
     PLANAR),
    ({"center": False}, 4096, None, "mvdr", False, PLANAR[:-1]),
    ({"frame_len": 512, "frame_hop": 128}, 4096, None, "mvdr", False,
     SPECTRUM),
    ({"frame_len": 512, "frame_hop": 128}, 4096, None, "mvdr", True,
     SPECTRUM),
    ({"frame_len": 1024, "frame_hop": 512}, 8192, None, "mvdr", True,
     SPECTRUM),
    ({"frame_len": 512, "frame_hop": 128}, 4096, None, "pmwf-0", False,
     SPECTRUM),
    ({}, 4000, None, "pmwf-1", True, SPECTRUM),
    # n_fft 768: inside the JAX planar gate (n_fft % 256 == 0), outside
    # the port's (a power of two): the spectrum-domain run, kernel 12
    ({"frame_len": 768, "frame_hop": 384, "round_power_of_two": False},
     6000, None, "mvdr", False, SPECTRUM)])
def test_cuda_dispatch_by_geometry(mocked_card, fields, s, nsamps, name, ban,
                                   want):
    _, cfg = _cfgs(**fields)
    wav, mask = _scene(31, 1, 3, s, cfg, int16=True)
    out = enhance_batch(wav, mask, cfg, beamformer=name, ban=ban,
                        nsamps=nsamps, device="cuda")
    assert out.shape == (1, nsamps or s) and torch.isfinite(out).all()
    assert mocked_card == want


def test_cuda_dispatch_matches_cpu_run(mocked_card):
    """The planar branch computes what the CPU's spectrum-domain run
    computes with the power steer (the same MVDR, another route)."""
    _, cfg = _cfgs(frame_len=1024, frame_hop=512)
    wav, mask = _scene(32, 2, 3, 12288, cfg)
    got = enhance_batch(wav, mask, cfg, device="cuda")
    ref = enhance_batch(wav, mask, cfg, steer="power", device="cpu")
    assert mocked_card[0] == "mvdr_enhance_planar"
    assert _peak_err(got, ref) < SLICE_TOL


def test_cuda_refusals_come_before_the_copy(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_copy(x, dev):
        raise AssertionError("copied to the card before refusing")

    monkeypatch.setattr(enhance_step, "_as_tensor", no_copy)
    _, spec_cfg = _cfgs(frame_len=512, frame_hop=128)
    _, wide_cfg = _cfgs(frame_len=1024, frame_hop=512)
    _, cfg = _cfgs()
    cases = [(spec_cfg, 3, 4096, {"beamformer": "gevd"}, "queue 1 item 13"),
             (spec_cfg, 3, 4096, {"beamformer": "mpdr"}, "queue 1 item 13"),
             (wide_cfg, 3, 8192, {"beamformer": "mpdr-whiten"},
              "queue 1 item 13"),
             (cfg, 3, 4000, {"beamformer": "gevd", "ban": True},
              "queue 1 item 13"),
             (spec_cfg, 3, 4096, {"steer": "eigh"}, "queue 1 item 13"),
             (spec_cfg, 9, 4096, {}, "queue 1 item 15"),
             (cfg, 9, 4096, {"beamformer": "pmwf-0"}, "queue 1 item 15"),
             (spec_cfg, 3, 4096, {"chunk_size": 32}, "queue 1 item 13"),
             (cfg, 3, 4000, {"chunk_size": 32}, "queue 1 item 13")]
    for c, n, s, kw, item in cases:
        wav, mask = _scene(40, 1, n, s, c)
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            enhance_batch(wav, mask, c, device="cuda", **kw)
    # the batch's geometry decides: BatchEnhancer takes gevd at
    # construction and refuses its 512/128 batch before the copy
    enhancer = tex.BatchEnhancer(spec_cfg, beamformer="gevd", device="cuda")
    wav, mask = _scene(41, 1, 3, 4096, spec_cfg)
    enhancer.add("u0", wav[0], mask[0])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        enhancer.flush()
    assert enhance_step.check_cuda_options("mvdr", False, "power", -1) is None
    assert pipeline.planar_supported(wide_cfg, 8, 1024)
    assert not pipeline.planar_supported(wide_cfg, 8, 1000)
    assert not pipeline.planar_supported(spec_cfg, 2)
    assert not pipeline.planar_supported(_cfgs(frame_len=4096,
                                                frame_hop=2048)[1], 2)
