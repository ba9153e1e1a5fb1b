"""CUDA kernels of setk_tpu_torch against their plain versions, on the card.

Marked ``gpu``; each test skips when no CUDA device is present (decided
inside the test, never at collection).  This file imports neither jax
nor setk_tpu, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.dsp.window import wss_inverse_blocks
from setk_tpu_torch.enhance import beamformer as bf
from setk_tpu_torch.enhance.pipeline import (enhance_plain,
                                             enhance_plain_online,
                                             mvdr_enhance_planar_plain)
from setk_tpu_torch.ops.cuda import covariance_pair as cp
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.ops.cuda import planar as pl
from setk_tpu_torch.parallel.enhance_step import enhance_batch

pytestmark = pytest.mark.gpu

TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _inputs(b, n, s, int16, seed=0):
    cfg = StftConfig()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, s)).astype(np.float32) * 0.3
    wav = (np.clip(x * 32768, -32768, 32767).astype(np.int16) if int16
           else x)
    mask = rng.random((b, cfg.num_frames(s), cfg.num_bins)).astype(
        np.float32)
    return cfg, wav, mask


@pytest.mark.parametrize("n,s,int16", [(1, 512, False), (3, 4096, True),
                                       (6, 131072, True), (8, 8192, False)])
def test_fused_kernels_match_plain(n, s, int16):
    dev = _card()
    cfg, wav, mask = _inputs(2, n, s, int16)
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    rs_k, rn_k = fm.stft_covar(wav_d, mask_d, window)
    rs_p, rn_p = fm.stft_covar_plain(wav_d, mask_d, window)
    assert _rel(rs_k, rs_p) < TOL and _rel(rn_k, rn_p) < TOL
    t = cfg.num_frames(s)
    den = mask_d.sum(1)
    rs = (rs_p / den[..., None, None]).contiguous()
    rn = (rn_p / (t - den)[..., None, None]).contiguous()
    w_k = mv.mvdr_power(rs, rn)
    assert _rel(w_k, mv.mvdr_power_plain(rs, rn)) < TOL
    wss = torch.as_tensor(wss_inverse_blocks(cfg.padded_window, t, 256, 512,
                                             s), device=dev)
    out_k = fm.beamform_istft(wav_d, w_k, wss, window)
    out_p = fm.beamform_istft_plain(wav_d, w_k, wss, window)
    assert _rel(out_k, out_p) < TOL


def test_enhance_batch_runs_kernels_only():
    dev = _card()
    cfg, wav, mask = _inputs(2, 4, 16384, True, seed=1)
    counted = (fm.stft_covar, mv.mvdr_power, fm.beamform_istft)
    for fn in counted:
        fn.launches = 0
    out = enhance_batch(torch.from_numpy(wav).to(dev),
                        torch.from_numpy(mask).to(dev), cfg)
    assert [fn.launches for fn in counted] == [1, 1, 1]
    ref = enhance_plain(torch.from_numpy(wav).to(dev),
                        torch.from_numpy(mask).to(dev), cfg)
    assert torch.isfinite(out).all() and _rel(out, ref) < TOL


@pytest.mark.parametrize("name,ban,solves", [
    ("gevd", False, ("gevd_power",)), ("gevd", True, ("gevd_power",)),
    ("pmwf-0", False, ("pmwf_solve",)), ("pmwf-1", True, ("pmwf_solve",)),
    ("mpdr", False, ("mvdr_power",)),
    ("mpdr-whiten", False, ("gevd_power", "capon"))])
def test_family_runs_kernels_only(name, ban, solves):
    dev = _card()
    cfg, wav, mask = _inputs(2, 4, 16384, True, seed=2)
    counted = (fm.stft_covar, mv.mvdr_power, mv.gevd_power, mv.pmwf_solve,
               mv.capon, fm.beamform_istft)
    for fn in counted:
        fn.launches = 0
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    out = enhance_batch(wav_d, mask_d, cfg, beamformer=name, ban=ban)
    want = {fn.__name__: int(fn.__name__ in solves + ("stft_covar",
                                                      "beamform_istft"))
            for fn in counted}
    assert {fn.__name__: fn.launches for fn in counted} == want
    ref = enhance_plain(wav_d, mask_d, cfg, beamformer=name, ban=ban)
    assert torch.isfinite(out).all() and _rel(out, ref) < TOL


@pytest.mark.parametrize("n", [1, 6, 8])
def test_family_kernels_match_plain(n):
    dev = _card()
    rng = np.random.default_rng(n)
    bins, t = 300, 64
    y = torch.from_numpy((rng.standard_normal((bins, n, t)) + 1j *
                          rng.standard_normal((bins, n, t))).astype(
                              np.complex64)).to(dev)
    m = torch.from_numpy(rng.random((bins, 1, t)).astype(np.float32)).to(dev)
    rs = ((y * m) @ y.conj().transpose(-1, -2) / t).contiguous()
    rn = ((y * (1 - m)) @ y.conj().transpose(-1, -2) / t).contiguous()
    d = y[..., 0].contiguous()
    for got, ref in zip(mv.pmwf_solve(rs, rn, 1.0, return_powers=True),
                        mv.pmwf_solve_plain(rs, rn, 1.0, return_powers=True)):
        assert _rel(got, ref) < TOL
    assert _rel(mv.capon(d, rn), mv.capon_plain(d, rn)) < TOL
    assert torch.isfinite(torch.view_as_real(mv.gevd_power(rs, rn, 30))).all()


@pytest.mark.parametrize("chunk,s", [(32, 131072), (24, 12288), (5, 8192),
                                     (1, 1024)])
def test_online_kernels_match_plain(chunk, s):
    dev = _card()
    cfg, wav, mask = _inputs(2, 6, s, True, seed=chunk)
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    part_k = fm.stft_covar_chunks(wav_d, mask_d, window, chunk)
    part_p = fm.stft_covar_chunks_plain(wav_d, mask_d, window, chunk)
    assert _rel(part_k, part_p) < TOL
    es_k, en_k = fm.covar_ema(part_p, mask_d, chunk, 0.8)
    es_p, en_p = fm.covar_ema_plain(part_p, mask_d, chunk, 0.8)
    assert _rel(es_k, es_p) < TOL and _rel(en_k, en_p) < TOL
    w = mv.mvdr_power(es_p, en_p)
    t = cfg.num_frames(s)
    wss = torch.as_tensor(wss_inverse_blocks(cfg.padded_window, t, 256, 512,
                                             s), device=dev)
    out_k = fm.beamform_istft_online(wav_d, w, wss, window, chunk)
    out_p = fm.beamform_istft_online_plain(wav_d, w, wss, window, chunk)
    assert _rel(out_k, out_p) < TOL


@pytest.mark.parametrize("b,s,chunk", [(2, 16384, 32), (2, 16384, 24),
                                       (1, 64000, 32)])
def test_online_enhance_batch_runs_kernels_only(b, s, chunk):
    """Online mvdr (and B = 1 streaming of 4 s) through the online
    kernels only, against the plain online path on the card."""
    dev = _card()
    cfg, wav, mask = _inputs(b, 4, s, True, seed=4)
    counted = (fm.stft_covar, fm.covar_ema, mv.mvdr_power,
               fm.beamform_istft_online, fm.beamform_istft)
    for fn in counted:
        fn.launches = 0
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    out = enhance_batch(wav_d, mask_d, cfg, chunk_size=chunk, alpha=0.8)
    assert [fn.launches for fn in counted] == [1, 1, 1, 1, 0]
    ref = enhance_plain_online(wav_d, mask_d, cfg, chunk_size=chunk,
                               alpha=0.8)
    assert torch.isfinite(out).all() and _rel(out, ref) < TOL


def test_uncovered_cases_raise_on_the_card():
    dev = _card()
    cfg, wav, mask = _inputs(1, 2, 4096, False)
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    for kw in ({"chunk_size": 32, "beamformer": "gevd"},
               {"chunk_size": 32, "ban": True}, {"steer": "eigh"},
               {"nsamps": 4000, "beamformer": "gevd"},
               {"nsamps": 4000, "chunk_size": 32}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            enhance_batch(wav_d, mask_d, cfg, **kw)
    with pytest.raises(ValueError):
        enhance_batch(wav_d, mask_d, cfg, beamformer="ds")


def _cplx_rel(planes, ref):
    """Peak error of the Rs and Rn numerators from four planes each."""
    return max(_rel(torch.complex(planes[k], planes[k + 1]),
                    torch.complex(ref[k], ref[k + 1])) for k in (0, 2))


@pytest.mark.parametrize("n_fft,s,center,int16", [
    (256, 4000, True, False), (512, 128100, True, True),
    (1024, 131072, True, True), (1024, 9000, False, False),
    (2048, 20000, True, False)])
def test_planar_kernels_match_plain(n_fft, s, center, int16):
    """Kernels 9, 11 and 10 against their plain versions; the planar
    spectrum of a signal resynthesizes to the signal."""
    dev = _card()
    cfg = StftConfig(frame_len=n_fft, frame_hop=n_fft // 2, center=center)
    _, wav, _ = _inputs(2, 3, s, int16, seed=n_fft)
    wav_d = torch.from_numpy(wav).to(dev)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    got = pl.stft_planar(wav_d, window, center)
    ref = pl.stft_planar_plain(wav_d, window, center)
    peak = torch.complex(ref[0], ref[1]).abs().max()
    for g, r in zip(got, ref):
        assert float((g - r).abs().max() / peak) < TOL
    t = cfg.num_frames(s)
    mask = torch.rand((2, t, cfg.num_bins), device=dev)
    fh = n_fft // 2
    assert _cplx_rel(
        cp.pair_covar_complement(ref[0], ref[1], mask[..., :fh], t - 3),
        cp.pair_covar_complement_plain(ref[0], ref[1], mask[..., :fh],
                                       t - 3)) < TOL
    if not center:
        return
    for nsamps in (s, s - 777, (t - 1) * fh):
        wss = torch.as_tensor(pl.istft_wss_inverse(cfg.padded_window, t,
                                                   nsamps), device=dev)
        er, ei, ny = (x[:, 0].contiguous() for x in ref)
        out = pl.istft_planar(er, ei, ny, window, wss, nsamps)
        assert _rel(out, pl.istft_planar_plain(er, ei, ny, window, wss,
                                               nsamps)) < TOL
        n_sig = pl.valid_samples(t, fh, nsamps)
        x0 = wav_d[:, 0, :n_sig].float() / (32768.0 if int16 else 1.0)
        assert _rel(out[:, :n_sig], x0) < TOL
        assert not out[:, n_sig:].any()


@pytest.mark.parametrize("n", [1, 6, 8])
def test_pair_covar_matches_plain(n):
    """Kernel 12 on a permuted view of a spectrum, as compute_covar_pair
    hands it over, with the complement and with a random mask_n."""
    dev = _card()
    rng = np.random.default_rng(n)
    b, t, f = 3, 301, 257
    spec = torch.from_numpy((rng.standard_normal((b, n, t, f)) + 1j *
                             rng.standard_normal((b, n, t, f))).astype(
                                 np.complex64)).to(dev)
    ms = torch.rand((b, t, f), device=dev)
    for mn in (torch.clamp(1 - ms, min=0), torch.rand((b, t, f), device=dev)):
        assert _cplx_rel(cp.pair_covar(spec, ms, mn),
                         cp.pair_covar_plain(spec, ms, mn)) < TOL
    obs = spec.permute(0, 3, 1, 2)                    # (B, F, N, T) view
    cp.pair_covar.launches = 0
    rs, rn = bf.compute_covar_pair(obs, ms.transpose(1, 2))
    assert cp.pair_covar.launches == 1
    rs_p, rn_p = bf.compute_covar_pair(obs.cpu(), ms.transpose(1, 2).cpu())
    assert _rel(rs.cpu(), rs_p) < TOL and _rel(rn.cpu(), rn_p) < TOL
    with pytest.raises(NotImplementedError, match="queue 2 item 13"):
        bf.compute_covar(obs, ms.transpose(1, 2))


PLANAR_LAUNCHES = ("stft_planar", "pair_covar_complement", "mvdr_power",
                   "istft_planar")


def _counted():
    return (fm.stft_covar, fm.beamform_istft, mv.mvdr_power, mv.pmwf_solve,
            pl.stft_planar, cp.pair_covar_complement, pl.istft_planar,
            cp.pair_covar)


@pytest.mark.parametrize("fields,s,nsamps", [
    ({"frame_len": 1024, "frame_hop": 512}, 32768, None),
    ({}, 16100, None), ({}, 16384, 16000), ({"center": False}, 16384, None)])
def test_planar_branch_runs_kernels_only(fields, s, nsamps):
    dev = _card()
    cfg = StftConfig(**fields)
    rng = np.random.default_rng(s)
    wav = np.clip(rng.standard_normal((2, 4, s)) * 0.3 * 32768, -32768,
                  32767).astype(np.int16)
    mask = rng.random((2, cfg.num_frames(s), cfg.num_bins)).astype(
        np.float32)
    for fn in _counted():
        fn.launches = 0
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    out = enhance_batch(wav_d, mask_d, cfg, nsamps=nsamps)
    want = set(PLANAR_LAUNCHES) - (set() if cfg.center else {"istft_planar"})
    assert {fn.__name__ for fn in _counted() if fn.launches} == want
    ref = mvdr_enhance_planar_plain(wav_d, mask_d, cfg, nsamps=nsamps)
    assert torch.isfinite(out).all() and _rel(out, ref) < TOL


@pytest.mark.parametrize("name,ban,want", [
    ("mvdr", False, {"pair_covar", "mvdr_power"}),
    ("mvdr", True, {"pair_covar", "mvdr_power"}),
    ("pmwf-0", False, {"pair_covar"}), ("pmwf-1", False, {"pair_covar"})])
def test_spectrum_branch_runs_kernels_only(name, ban, want):
    """512/128 takes the spectrum-domain run: kernel 12 and, for mvdr,
    mvdr_power; it matches the same run on the CPU copies."""
    dev = _card()
    cfg = StftConfig(frame_len=512, frame_hop=128)
    _, wav, _ = _inputs(2, 4, 16384, True, seed=5)
    mask = np.random.default_rng(6).random(
        (2, cfg.num_frames(16384), cfg.num_bins)).astype(np.float32)
    for fn in _counted():
        fn.launches = 0
    out = enhance_batch(torch.from_numpy(wav).to(dev),
                        torch.from_numpy(mask).to(dev), cfg, beamformer=name,
                        ban=ban)
    assert {fn.__name__ for fn in _counted() if fn.launches} == want
    ref = enhance_batch(wav, mask, cfg, beamformer=name, ban=ban,
                        steer="power", device="cpu")
    assert torch.isfinite(out).all() and _rel(out.cpu(), ref) < TOL
