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
from setk_tpu_torch.ops.cuda import cacgmm_em as ce
from setk_tpu_torch.ops.cuda import cholesky as chl
from setk_tpu_torch.ops.cuda import covariance as mc
from setk_tpu_torch.ops.cuda import covariance_pair as cp
from setk_tpu_torch.ops.cuda import eigh_small as es
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import lstm_seq as ls
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.ops.cuda import omlsa as om
from setk_tpu_torch.ops.cuda import planar as pl
from setk_tpu_torch.ops.cuda import wpe_gram as wgr
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


def _gevd_agrees(v_k, v_p, rs, rn):
    """gevd_power against its plain version: within TOL, or the JAX
    package's Rayleigh contract (v^H Rn v = 1, and the generalized Rayleigh
    quotient of the plain version's vector), as chip_smoke.py's step 5."""
    if _rel(v_k, v_p) < TOL:
        return True
    hrs = 0.5 * (rs + rs.conj().transpose(-1, -2))
    hrn = 0.5 * (rn + rn.conj().transpose(-1, -2))

    def form(v, m):
        return torch.einsum("...a,...ab,...b->...", v.conj(), m, v).real

    q = form(v_k, hrn)
    ratio = (form(v_k, hrs) / torch.clamp(q, min=1e-12)) / torch.clamp(
        form(v_p, hrs) / torch.clamp(form(v_p, hrn), min=1e-12), min=1e-12)
    return bool((q - 1).abs().max() <= 2e-3 and ratio.median() > 0.999
                and ratio.min() > 0.95)


@pytest.mark.parametrize("n", [1, 6, 7, 8])
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
    for iters in (30, 50):
        v_k = mv.gevd_power(rs, rn, iters)
        assert torch.isfinite(torch.view_as_real(v_k)).all()
        assert _gevd_agrees(v_k, mv.gevd_power_plain(rs, rn, iters), rs, rn)


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


@pytest.mark.parametrize("n,s,int16,chunk,offset", [
    (5, 8192, True, None, 0), (7, 4096, False, 5, 1), (2, 512, True, 1, 0),
    (4, 20480, False, 3, 1), (8, 2560, True, 64, 1)])
def test_kernel_a_shapes_match_plain(n, s, int16, chunk, offset):
    """Kernel A at odd N, T = 3, chunks that end inside a tile, a chunk
    larger than T and a waveform and mask off 16-byte alignment."""
    dev = _card()
    cfg, wav, mask = _inputs(3, n, s, int16, seed=n)

    def on_card(x):
        flat = np.concatenate([np.zeros(offset, x.dtype), x.ravel()])
        return torch.from_numpy(flat).to(dev)[offset:].view(x.shape)
    wav_d, mask_d = on_card(wav), on_card(mask)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    if chunk is None:
        got = torch.cat(fm.stft_covar(wav_d, mask_d, window), -1)
        ref = torch.cat(fm.stft_covar_plain(wav_d, mask_d, window), -1)
    else:
        got = fm.stft_covar_chunks(wav_d, mask_d, window, chunk)
        ref = fm.stft_covar_chunks_plain(wav_d, mask_d, window, chunk)
    assert _rel(got, ref) < TOL


def test_kernel_a_layout_on_the_card():
    """At the recipes' 6 mics kernel A is one block of 768 threads an SM,
    so a batch of 128 utterances runs one run of frames each."""
    dev = _card()
    lay = fm.kernel_a_layout(6, True, dev)
    assert lay["threads"] == 768 and lay["frames_a_tile"] == 8
    assert lay["blocks_per_sm"] >= 1
    slots = lay["blocks_per_sm"] * lay["sms"]
    assert fm.frame_runs(128, 501, slots, 8) == (1 if slots >= 128 else 2)


@pytest.mark.parametrize("b,n,s,int16,chunk,offset", [
    (3, 1, 4096, True, None, 0), (1, 2, 512, False, None, 1),
    (3, 5, 20480, True, None, 0), (3, 8, 8192, False, None, 1),
    (1, 6, 131072, True, None, 0), (3, 6, 12288, True, 1, 0),
    (3, 7, 8192, False, 3, 1), (3, 8, 20480, True, 5, 0),
    (2, 6, 131072, True, 32, 0)])
def test_kernel_b_shapes_match_plain(b, n, s, int16, chunk, offset):
    """Kernel B offline and online at N = 1, 2, 5, 6, 7 and 8, T = 3,
    many runs an utterance (B = 1 and 2), chunks 1, 3 and 5 (chunks that
    do not divide its tile of 8 frames) and 32, and a waveform off 16-byte
    alignment."""
    dev = _card()
    cfg, wav, _ = _inputs(b, n, s, int16, seed=n + s)
    flat = np.concatenate([np.zeros(offset, wav.dtype), wav.ravel()])
    wav_d = torch.from_numpy(flat).to(dev)[offset:].view(wav.shape)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    t = cfg.num_frames(s)
    wss = torch.as_tensor(wss_inverse_blocks(cfg.padded_window, t, 256, 512,
                                             s), device=dev)
    rng = np.random.default_rng(s)
    shape = (b, 257, n) if chunk is None else (b, fm.num_chunks(t, chunk),
                                               257, n)
    w = torch.from_numpy((rng.standard_normal(shape) + 1j *
                          rng.standard_normal(shape)).astype(
                              np.complex64)).to(dev)
    if chunk is None:
        got = fm.beamform_istft(wav_d, w, wss, window)
        ref = fm.beamform_istft_plain(wav_d, w, wss, window)
    else:
        got = fm.beamform_istft_online(wav_d, w, wss, window, chunk)
        ref = fm.beamform_istft_online_plain(wav_d, w, wss, window, chunk)
    assert _rel(got, ref) < TOL


def test_kernel_b_layout_on_the_card():
    """Kernel B is blocks of 4 warps, a tile of 8 frames, several blocks
    an SM at 6 mics, and splits each utterance of a batch of 128 into the
    runs frame_runs' rule picks for its slots."""
    dev = _card()
    lay = fm.kernel_b_layout(6, True, False, 128, 128000, dev)
    assert lay["threads"] == 128 and lay["frames_a_tile"] == 8
    assert lay["blocks_per_sm"] >= 2
    slots = lay["blocks_per_sm"] * lay["sms"]
    assert lay["runs"] == fm.frame_runs(128, 500, slots, 8)


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
    """What the EVD kernel brings runs on the card (each option's launch
    set, finite output); N = 9 and an unknown name still raise."""
    dev = _card()
    cfg, wav, mask = _inputs(1, 2, 4096, False)
    wav_d = torch.from_numpy(wav).to(dev)
    mask_d = torch.from_numpy(mask).to(dev)
    counted = _counted() + (mc.masked_covar, es.hermitian_eigh)
    for kw, want in (
            ({"chunk_size": 32, "beamformer": "gevd"},
             {"masked_covar", "hermitian_eigh"}),
            ({"chunk_size": 32, "ban": True},
             {"masked_covar", "hermitian_eigh"}),
            ({"steer": "eigh"},
             {"stft_covar", "hermitian_eigh", "beamform_istft"}),
            ({"nsamps": 4000, "beamformer": "gevd"},
             {"pair_covar", "hermitian_eigh"}),
            ({"nsamps": 4000, "chunk_size": 32},
             {"masked_covar", "hermitian_eigh"})):
        for fn in counted:
            fn.launches = 0
        out = enhance_batch(wav_d, mask_d, cfg, **kw)
        assert {fn.__name__ for fn in counted if fn.launches} == want, kw
        assert torch.isfinite(out).all()
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 15"):
        enhance_batch(np.zeros((1, 9, 4096), np.float32), mask, cfg,
                      device="cuda")
    with pytest.raises(ValueError):
        enhance_batch(wav_d, mask_d, cfg, beamformer="ds")


def _eigh_inputs(n, m, seed, dev):
    """n Hermitian matrices: full rank, a quarter rank one plus noise,
    one all zero; and a full-rank b."""
    rng = np.random.default_rng(seed)

    def herm(count, rank):
        x = (rng.standard_normal((count, m, rank)) +
             1j * rng.standard_normal((count, m, rank))).astype(np.complex64)
        return x @ x.conj().transpose(0, 2, 1)

    a = herm(n, m + 2)
    a[:n // 4] = herm(n // 4, 1) + 1e-3 * herm(n // 4, m)
    a[-1] = 0
    b = herm(n, m + 3)
    return torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)


@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("m", [1, 2, 6, 7, 8])
def test_hermitian_eigh_matches_plain(m, gen):
    """The EVD kernel against its plain version on the card at 300
    matrices: eigenvalues within TOL of each matrix's peak, principal
    vectors within 1e-5 in direction where the top eigenvalue stands 1e-2
    of the peak from the next; the zero matrix's V = I."""
    dev = _card()
    a, b = _eigh_inputs(300, m, m + 10 * gen, dev)
    b = b if gen else None
    es.hermitian_eigh.launches = 0
    w, v = es.hermitian_eigh(a, b)
    assert es.hermitian_eigh.launches == 1
    w_p, v_p = es.hermitian_eigh_plain(a, b)
    peak = w_p.abs().amax(-1).clamp(min=1e-30)
    assert float(((w - w_p).abs().amax(-1) / peak).max()) < TOL
    top = v[..., -1]
    top_p = v_p[..., -1]
    cos = (top.conj() * top_p).sum(-1).abs() / (
        torch.linalg.vector_norm(top, dim=-1) *
        torch.linalg.vector_norm(top_p, dim=-1))
    apart = (w_p[:, -1] - w_p[:, -2] > 1e-2 * peak) if m > 1 else \
        torch.ones_like(peak, dtype=torch.bool)
    apart[-1] = False
    assert float((1 - cos[apart]).max()) < 1e-5
    if not gen:
        assert torch.equal(v[-1].cpu(), torch.eye(m, dtype=torch.complex64))


@pytest.mark.parametrize("form", ["thread", "lanes"])
@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("m", [1, 3, 6, 8])
def test_hermitian_eigh_forms_match_plain(m, gen, form):
    """Each form of the EVD kernel forced, at 301 matrices (a partial
    last block and lane group), against the plain version: eigenvalues
    within TOL of each matrix's peak, principal vectors within 1e-5 in
    direction where the top eigenvalue stands 1e-2 of the peak from the
    next; sweeps = 0 gives V = I and the sorted diagonal.  A form not
    built at M (a thread at M = 8, lanes at M = 1) is refused."""
    dev = _card()
    a, b = _eigh_inputs(301, m, 2 * m + gen, dev)
    b = b if gen else None
    if form not in es.eigh_forms(m):
        with pytest.raises(ValueError):
            es.hermitian_eigh(a, b, form=form)
        return
    w, v = es.hermitian_eigh(a, b, form=form)
    w_p, v_p = es.hermitian_eigh_plain(a, b)
    peak = w_p.abs().amax(-1).clamp(min=1e-30)
    assert float(((w - w_p).abs().amax(-1) / peak).max()) < TOL
    cos = (v[..., -1].conj() * v_p[..., -1]).sum(-1).abs() / (
        torch.linalg.vector_norm(v[..., -1], dim=-1) *
        torch.linalg.vector_norm(v_p[..., -1], dim=-1))
    apart = (w_p[:, -1] - w_p[:, -2] > 1e-2 * peak) if m > 1 else \
        torch.ones_like(peak, dtype=torch.bool)
    apart[-1] = False
    assert float((1 - cos[apart]).max()) < 1e-5
    if not gen:
        w0, v0 = es.hermitian_eigh(a, sweeps=0, form=form)
        diag, order = torch.sort(a.diagonal(0, -2, -1).real, stable=True)
        eye = torch.eye(m, dtype=torch.complex64, device=dev).expand_as(a)
        assert torch.equal(w0, diag)
        assert torch.equal(v0, eye.gather(
            -1, order[:, None, :].expand(-1, m, -1)))


def test_hermitian_eigh_takes_a_batch_in_one_launch():
    """32,896 matrices (128 utterances x 257 bins) in one launch."""
    dev = _card()
    a, b = _eigh_inputs(32896, 6, 3, dev)
    es.hermitian_eigh.launches = 0
    w, v = es.hermitian_eigh(a.reshape(128, 257, 6, 6),
                             b.reshape(128, 257, 6, 6))
    torch.cuda.synchronize()
    assert es.hermitian_eigh.launches == 1 and w.shape == (128, 257, 6)
    w_p, _ = es.hermitian_eigh_plain(a, b)
    peak = w_p.abs().amax(-1).clamp(min=1e-30)
    assert float(((w.reshape(-1, 6) - w_p).abs().amax(-1) / peak).max()) \
        < TOL


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


@pytest.mark.parametrize("n_fft,n,t,extra", [
    (256, 3, 129, 0), (256, 8, 127, -77), (256, 1, 2, 300),
    (512, 3, 255, 111), (512, 8, 128, -256), (512, 6, 501, 100),
    (1024, 3, 20, 0), (1024, 6, 251, 0), (2048, 8, 10, -1),
    (2048, 3, 3, 0)])
def test_beamform_istft_planar_matches_plain(n_fft, n, t, extra):
    """Kernel 10 with the beamform on random mic planes and weights
    against its plain version: runs and their ends, N = 1, 3, 6 and 8,
    nsamps below, at and past (T - 1) hop (P1's and P2's T among them)."""
    dev = _card()
    cfg = StftConfig(frame_len=n_fft, frame_hop=n_fft // 2)
    hop = n_fft // 2
    rng = np.random.default_rng(n_fft + 10 * n + t)
    re, im = (torch.from_numpy(x).to(dev) for x in rng.standard_normal(
        (2, 3, n, t, hop)).astype(np.float32))
    nyq = torch.from_numpy(rng.standard_normal((3, n, t)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((3, hop + 1, n)) + 1j *
                          rng.standard_normal((3, hop + 1, n))).astype(
                              np.complex64)).to(dev)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    nsamps = (t - 1) * hop + extra
    wss = torch.as_tensor(pl.istft_wss_inverse(cfg.padded_window, t,
                                               nsamps), device=dev)
    pl.beamform_istft_planar.launches = 0
    out = pl.beamform_istft_planar(re, im, nyq, w, window, wss, nsamps)
    assert pl.beamform_istft_planar.launches == 1
    ref = pl.beamform_istft_planar_plain(re, im, nyq, w, window, wss, nsamps)
    assert _rel(out, ref) < TOL
    assert not out[:, pl.valid_samples(t, hop, nsamps):].any()


@pytest.mark.parametrize("n_fft,s", [(512, 24001), (1024, 24001),
                                     (512, 19501), (1024, 71901)])
def test_stft_planar_unaligned_rows_match_plain(n_fft, s):
    """Kernel 9 on f32 rows off 16-byte alignment: S odd puts every
    other row off it and a one-sample offset into the buffer the rest, so
    the rows are staged sample by sample.  At S = 19501 and 71901 (T =
    77 and 141) a row's last run of 64 frames holds 13, an odd last tile
    whose last pair has no frame b."""
    dev = _card()
    cfg = StftConfig(frame_len=n_fft, frame_hop=n_fft // 2)
    x = np.random.default_rng(n_fft).standard_normal(6 * s + 1).astype(
        np.float32) * 0.3
    wav_d = torch.from_numpy(x).to(dev)[1:].reshape(2, 3, s)
    window = torch.as_tensor(cfg.padded_window, dtype=torch.float32,
                             device=dev)
    got = pl.stft_planar(wav_d, window, True)
    ref = pl.stft_planar_plain(wav_d, window, True)
    peak = torch.complex(ref[0], ref[1]).abs().max()
    for g, r in zip(got, ref):
        assert float((g - r).abs().max() / peak) < TOL


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
    # the single masked covariance runs kernel 13 on the card
    mc.masked_covar.launches = 0
    ry = bf.compute_covar(obs, ms.transpose(1, 2))
    assert mc.masked_covar.launches == 1
    assert _rel(ry.cpu(), bf.compute_covar(obs.cpu(),
                                           ms.transpose(1, 2).cpu())) < TOL


PLANAR_LAUNCHES = ("stft_planar", "pair_covar_complement", "mvdr_power",
                   "beamform_istft_planar")


def _counted():
    return (fm.stft_covar, fm.beamform_istft, mv.mvdr_power, mv.pmwf_solve,
            pl.stft_planar, cp.pair_covar_complement, pl.istft_planar,
            pl.beamform_istft_planar, cp.pair_covar)


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
    want = set(PLANAR_LAUNCHES) - (set() if cfg.center else
                                   {"beamform_istft_planar"})
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


def _cplx(rng, *shape, dev):
    return torch.from_numpy((rng.standard_normal(shape) + 1j *
                             rng.standard_normal(shape)).astype(
                                 np.complex64)).to(dev)


@pytest.mark.parametrize("n,k", [(1, 1), (6, 2), (8, 3), (6, 5)])
def test_masked_covar_matches_plain(n, k):
    """Kernel 13 (K = 5 takes two launches), and covar_stats' broadcast of
    one observation against K classes."""
    dev = _card()
    rng = np.random.default_rng(n * k)
    obs = _cplx(rng, 3, 257, n, 173, dev=dev)
    w = torch.rand((k, 3, 257, 173), device=dev)
    mc.masked_covar.launches = 0
    num = mc.masked_covar(obs, w)
    assert mc.masked_covar.launches == -(-k // 4)
    assert _rel(num, mc.masked_covar_plain(obs, w)) < TOL
    got, den = bf.covar_stats(obs[None], w)
    ref, _ = bf.covar_stats(obs[None].cpu(), w.cpu())
    assert _rel(got.cpu(), ref) < TOL and den.shape == (k, 3, 257)


@pytest.mark.parametrize("m", [1, 6, 8])
def test_regularized_inverse_matches_plain(m):
    """Kernel 14 against its plain version (1e-4 of each matrix's peak),
    and ops.linalg.regularized_inverse on the card against the eigh-based
    CPU path on well-conditioned matrices."""
    from setk_tpu_torch.ops.linalg import regularized_inverse
    dev = _card()
    rng = np.random.default_rng(m)
    a = _cplx(rng, 2000, m, 3 * m, dev=dev)
    a = (a @ a.conj().transpose(-1, -2)).contiguous()
    es.regularized_inverse.launches = 0
    inv, logdet = es.regularized_inverse(a)
    assert es.regularized_inverse.launches == 1
    ref_inv, ref_ld = es.regularized_inverse_plain(a)
    peak = ref_inv.abs().amax(dim=(-1, -2))
    assert float(((inv - ref_inv).abs().amax(dim=(-1, -2)) / peak).max()) \
        < TOL
    assert float((logdet - ref_ld).abs().max()) < TOL * m
    inv2, ld2 = regularized_inverse(a, return_logdet=True)
    cpu_inv, cpu_ld = regularized_inverse(a.cpu(), return_logdet=True)
    assert float(((inv2.cpu() - cpu_inv).abs().amax(dim=(-1, -2)) /
                  peak.cpu()).max()) < 1e-3
    assert float((ld2.cpu() - cpu_ld).abs().max()) < 1e-3 * m


@pytest.mark.parametrize("form", [None, "thread", "lanes"])
@pytest.mark.parametrize("count", [514, 65792])
def test_regularized_inverse_launch_shapes_match_plain(count, form):
    """Kernel 14 at the CGMM CLI resume's launch (514 = 2 x 257 matrices
    of 6 x 6) and at the bench shape (65,792), in the launcher's form and
    each form forced: one launch each, within 1e-4 of each matrix's peak
    of its plain version, logdet within 1e-4 * M, on sample covariances of
    16 frames (full rank, as the EM's are)."""
    dev = _card()
    rng = np.random.default_rng(count)
    z = _cplx(rng, count, 6, 16, dev=dev)
    a = (z @ z.conj().transpose(-1, -2) / 16).contiguous()
    es.regularized_inverse.launches = 0
    inv, logdet = es.regularized_inverse(a, form=form)
    assert es.regularized_inverse.launches == 1
    ref_inv, ref_ld = es.regularized_inverse_plain(a)
    peak = ref_inv.abs().amax(dim=(-1, -2))
    assert float(((inv - ref_inv).abs().amax(dim=(-1, -2)) / peak).max()) \
        < TOL
    assert float((logdet - ref_ld).abs().max()) < TOL * 6


@pytest.mark.parametrize("model,init,k,masked,m,t", [
    ("cg", "higuchi", 2, False, 6, 301), ("cacg", None, 2, True, 6, 301),
    ("cacg", "higuchi", 2, True, 6, 301), ("cacg", None, 3, False, 6, 301),
    ("cg", None, 4, True, 8, 1001)])
def test_em_kernel_matches_plain(model, init, k, masked, m, t):
    """Kernel 15 against its plain version on the card, 4 iterations, at
    257 bins (6 mics and T = 301; 8 mics, K = 4 and T = 1001, where the
    kernel spills): gamma within 2e-3, Q within 2e-3 relative, covariances
    within 2e-2 of their peak."""
    dev = _card()
    rng = np.random.default_rng(k)
    b, f, iters = 3, 257, 4
    obs = _cplx(rng, b, f, m, t, dev=dev)
    obs[:, :, 1:] += 0.5 * obs[:, :, :1]
    if model == "cacg":
        obs = obs / torch.linalg.vector_norm(obs, dim=-2, keepdim=True)
    g0 = torch.rand((k, b, f, t), device=dev)
    g0 = g0 / g0.sum(0)
    k0 = torch.ones_like(g0)
    fm = None
    if masked:
        fm = torch.ones((b, 1, t), device=dev)
        fm[1, 0, 200:] = 0.0
    args = (None, None) if init else (g0, k0)
    ce.em.launches = 0
    got = ce.em(obs, *args, iters, model, True, frame_mask=fm,
                return_state=True, init=init, num_classes=k)
    assert ce.em.launches == 1
    ref = ce.em_plain(obs, *args, iters, model, True, frame_mask=fm,
                      return_state=True, init=init, num_classes=k)
    assert float((got[0] - ref[0]).abs().max()) < 2e-3
    assert float(((got[1] - ref[1]).abs() / ref[1].abs()).max()) < 2e-3
    assert _rel(got[2]["covar"], ref[2]["covar"]) < 2e-2
    assert float((got[2]["alpha"] - ref[2]["alpha"]).abs().max()) < 2e-3


@pytest.mark.parametrize("model,k", [("cg", 2), ("cacg", 3)])
def test_em_kernel_is_deterministic(model, k):
    """Kernel 15 at the bench's M = 6 and T = 512 over 2 x 257 bins (8 or
    5 bins a warp, a last warp with fewer): within the bars of
    test_em_kernel_matches_plain, and two launches equal to the bit (the
    sums over lanes meet in a fixed order, no atomics)."""
    dev = _card()
    rng = np.random.default_rng(5)
    obs = _cplx(rng, 2, 257, 6, 512, dev=dev)
    obs[:, :, 1:] += 0.5 * obs[:, :, :1]
    g0 = torch.rand((k, 2, 257, 512), device=dev)
    g0 = g0 / g0.sum(0)
    args = (obs, g0, torch.ones_like(g0), 4, model, True)
    kw = dict(return_state=True, num_classes=k)
    got = ce.em(*args, **kw)
    again = ce.em(*args, **kw)
    ref = ce.em_plain(*args, **kw)
    assert float((got[0] - ref[0]).abs().max()) < 2e-3
    assert float(((got[1] - ref[1]).abs() / ref[1].abs()).max()) < 2e-3
    assert _rel(got[2]["covar"], ref[2]["covar"]) < 2e-2
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.fixture(scope="module")
def thread_jacobi(tmp_path_factory):
    """tests/cuda_emu/jacobi_thread.cu built with nvcc as the port's
    sources are: jacobi.cuh's one-thread cyclic statements (the TPU
    kernel's, which kernel 14 ran before it took the round-robin sweeps)
    behind jacobi_thread_launch."""
    import ctypes
    import subprocess
    from pathlib import Path
    from setk_tpu_torch.ops.cuda import _build
    _card()
    src = Path(__file__).resolve().parent / "cuda_emu" / "jacobi_thread.cu"
    out = tmp_path_factory.mktemp("jacobi_thread") / "libjacobi_thread.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS,
                           f"-I{_build.SOURCE_DIR}", "-o", str(out),
                           str(src)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.jacobi_thread_launch.argtypes = [p, p, p, i, i, i, p]
    lib.jacobi_thread_launch.restype = i
    return lib


@pytest.mark.parametrize("m", [1, 6, 8])
def test_warp_jacobi_matches_thread_jacobi(thread_jacobi, m):
    """Kernel 15's lane-group Jacobi (its test entry) against jacobi.cuh's
    one-thread statements of the TPU kernel's cyclic Jacobi on the card,
    on the same matrices: within a few ulps of each matrix's peak where
    the compiler contracts alike, 1e-5 at most."""
    from setk_tpu_torch.ops.cuda import _build
    dev = _card()
    rng = np.random.default_rng(m)
    a = _cplx(rng, 1000, m, m + 2, dev=dev)
    a = (a @ a.conj().transpose(-1, -2)).contiguous()
    got, got_ld = torch.empty_like(a), torch.empty(1000, device=dev)
    _build.launch("cacgmm_em", "warp_jacobi_launch", dev, a.data_ptr(),
                  got.data_ptr(), got_ld.data_ptr(), 1000, m, es.SWEEPS)
    ref, ref_ld = torch.empty_like(a), torch.empty(1000, device=dev)
    _build.check(thread_jacobi.jacobi_thread_launch(
        a.data_ptr(), ref.data_ptr(), ref_ld.data_ptr(), 1000, m, es.SWEEPS,
        torch.cuda.current_stream().cuda_stream), "jacobi_thread_launch")
    peak = ref.abs().amax(dim=(-1, -2))
    assert float(((got - ref).abs().amax(dim=(-1, -2)) / peak).max()) < 1e-5
    assert float((got_ld - ref_ld).abs().max()) < 1e-5 * m


def test_clustering_runs_kernels_only():
    """A fresh cgmm_em / cacgmm_em(cgmm_init) launches kernel 15 alone; a
    resume launches kernels 13 and 14 once an iteration (and 14 once more
    for its first predict); M = 9 and num_iters = 0 raise with no device
    memory allocated."""
    from setk_tpu_torch.enhance.cluster import cacgmm_em, cgmm_em
    dev = _card()
    rng = np.random.default_rng(7)
    obs = _cplx(rng, 2, 257, 4, 120, dev=dev)
    counted = (mc.masked_covar, es.regularized_inverse, ce.em)
    for fn in counted:
        fn.launches = 0
    _, _, state = cgmm_em(obs, 2, num_iters=5, return_state=True)
    gamma, _ = cacgmm_em(obs, 2, num_iters=5, cgmm_init=True)
    assert [fn.launches for fn in counted] == [0, 0, 2]
    assert torch.isfinite(gamma).all()
    for fn in counted:
        fn.launches = 0
    gamma, q = cgmm_em(obs, 2, num_iters=3, state=state)
    assert [fn.launches for fn in counted] == [3, 4, 0]
    assert torch.isfinite(gamma).all() and torch.isfinite(q).all()
    before = torch.cuda.memory_allocated()
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        cgmm_em(np.zeros((257, 9, 20), np.complex64), 2, device="cuda")
    with pytest.raises(ValueError, match="num_iters"):
        cacgmm_em(np.zeros((257, 4, 20), np.complex64), 2, num_iters=0,
                  device="cuda")
    assert torch.cuda.memory_allocated() == before


# ---- WPE and WPD (kernels 16-19) ----

def _gram_on(dev, rng, bins, cols, load=0.5):
    a = _cplx(rng, bins, cols, 8, dev=dev)
    return (a @ a.conj().transpose(-1, -2) + load * torch.eye(
        cols, dtype=torch.complex64, device=dev)).contiguous()


@pytest.mark.parametrize("n,k", [(16, 1), (60, 6), (128, 8)])
def test_hermitian_solve_lanes_matches_plain(n, k):
    """One launch a call; 301 systems leave the last block partial; n =
    128 takes the dynamic shared memory opt-in above 48 KB."""
    dev = _card()
    rng = np.random.default_rng(n)
    a = _gram_on(dev, rng, 301, n, load=2.0)
    a = (a + 1e-3 * _cplx(rng, 301, n, n, dev=dev)).contiguous()
    b = _cplx(rng, 301, n, k, dev=dev)
    for assume in (False, True):
        before = chl.hermitian_solve_lanes.launches
        got = chl.hermitian_solve_lanes(a, b, assume_hermitian=assume)
        assert chl.hermitian_solve_lanes.launches == before + 1
        ref = chl.hermitian_solve_lanes_plain(a, b, assume_hermitian=assume)
        assert _rel(got, ref) < TOL


@pytest.mark.parametrize("n,taps,bins,delay", [
    (1, 10, 8224, 3), (6, 10, 8224, 3), (8, 16, 1028, 3), (6, 10, 3, 3),
    (2, 3, 64, 300)])
def test_wpe_apply_matches_plain(n, taps, bins, delay):
    """Kernel 19 at the WPE scene's T = 501: many items a block at 8,224
    and 1,028 bins, one at 3, y read from device memory at delay 300; one
    launch a call."""
    dev = _card()
    rng = np.random.default_rng(n * taps + bins)
    obs = _cplx(rng, bins, n, 501, dev=dev)
    g = (0.05 * _cplx(rng, bins, n * taps, n, dev=dev)).contiguous()
    before = wgr.wpe_apply.launches
    got = wgr.wpe_apply(obs, g, taps, delay)
    assert wgr.wpe_apply.launches == before + 1
    assert _rel(got, wgr.wpe_apply_plain(obs, g, taps, delay)) < TOL


def test_wpe_apply_unaligned_views_match_plain():
    """Kernel 19 on contiguous views one complex word into their buffers
    (8 bytes past a 16-byte boundary), and `wpe` on `spec[1]` of a (2,
    257, 3, 501) batch, whose N T is odd, against the same spectra copied
    to an aligned tensor; one launch a call of the kernel."""
    from setk_tpu_torch.enhance import wpe as twpe
    dev = _card()
    rng = np.random.default_rng(5)
    n, taps, bins, t = 3, 10, 257, 501
    obs = _cplx(rng, bins * n * t + 1, dev=dev)[1:].view(bins, n, t)
    g = (0.05 * _cplx(rng, bins * n * taps * n + 1, dev=dev))[1:].view(
        bins, n * taps, n)
    assert obs.data_ptr() % 16 == 8 and g.data_ptr() % 16 == 8
    before = wgr.wpe_apply.launches
    got = wgr.wpe_apply(obs, g, taps, 3)
    assert wgr.wpe_apply.launches == before + 1
    assert _rel(got, wgr.wpe_apply_plain(obs, g, taps, 3)) < TOL
    spec = _cplx(rng, 2, bins, n, t, dev=dev)
    assert spec[1].data_ptr() % 16 == 8
    got = twpe.wpe(spec[1])
    assert _rel(got, twpe.wpe(spec[1].clone())) < TOL


@pytest.mark.parametrize("nk", [9, 30, 60])
def test_solve_wpe_gram_matches_plain(nk):
    dev = _card()
    rng = np.random.default_rng(nk)
    n0 = 6 if nk == 60 else 3
    gram = _gram_on(dev, rng, 300, n0 + nk)
    for eq in (False, True):
        got = chl.solve_wpe_gram(gram, n0, nk, n0, 1e-6 if not eq else
                                 4 * nk * 1.1920929e-07, equilibrate=eq)
        ref = chl.solve_wpe_gram_plain(gram, n0, nk, n0, 1e-6 if not eq
                                       else 4 * nk * 1.1920929e-07, eq)
        assert _rel(got, ref) < TOL


@pytest.mark.parametrize("n,taps,t", [(6, 10, 501), (3, 4, 1876),
                                      (8, 16, 70)])
def test_wpe_gram_and_apply_match_plain(n, taps, t):
    dev = _card()
    rng = np.random.default_rng(n * t)
    obs = _cplx(rng, 40, n, t, dev=dev)
    g = (0.05 * _cplx(rng, 40, n * taps, n, dev=dev)).contiguous()
    lam = torch.rand((40, t), device=dev) + 0.1
    for use_g, ext in ((False, None), (True, None), (False, lam)):
        got = wgr.wpe_gram(obs, g, taps, 3, 1 if ext is None else 0, use_g,
                           ext)
        ref = wgr.wpe_gram_plain(obs, g, taps, 3, 1 if ext is None else 0,
                                 use_g, ext)
        assert _rel(got, ref) < TOL
        assert torch.equal(got, got.conj().transpose(-1, -2))
    assert _rel(wgr.wpe_apply(obs, g, taps, 3),
                wgr.wpe_apply_plain(obs, g, taps, 3)) < TOL


def test_wpe_and_wpd_run_kernels_only():
    """wpe: the fused gate launches 18 x3, 17 x3, 19 x1; use_fused=False
    kernel 16 x3.  wpd: 18, 17, 19, 15, 12 and 2 once an outer iteration;
    N = 9 refuses with no device memory allocated."""
    from setk_tpu_torch.enhance.wpe import wpd, wpe
    dev = _card()
    rng = np.random.default_rng(12)
    obs = _cplx(rng, 2, 257, 6, 120, dev=dev)
    obs[..., 5:] += 0.4 * obs[..., :-5]
    counted = (wgr.wpe_gram, chl.solve_wpe_gram, wgr.wpe_apply,
               chl.hermitian_solve_lanes, ce.em, cp.pair_covar,
               mv.mvdr_power)
    for fn in counted:
        fn.launches = 0
    out = wpe(obs)
    assert [fn.launches for fn in counted] == [3, 3, 1, 0, 0, 0, 0]
    ref = wpe(obs, use_fused=False)
    assert [fn.launches for fn in counted] == [3, 3, 1, 3, 0, 0, 0]
    assert torch.isfinite(out).all() and _rel(out, ref) < 2e-3
    for fn in counted:
        fn.launches = 0
    mask, enh = wpd(obs[0], cgmm_iters=3, wpd_iters=2, taps=4)
    assert [fn.launches for fn in counted] == [2, 2, 2, 0, 2, 2, 2]
    assert torch.isfinite(enh).all() and mask.shape == (257, 120)
    before = torch.cuda.memory_allocated()
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        wpd(np.zeros((257, 9, 40), np.complex64), taps=2, device="cuda")
    assert torch.cuda.memory_allocated() == before


# kernels 20-21 (T, B, H, weight type): T = 1, ragged row tiles, the
# bench width; bars of the peak as tests/test_torch_cuda_emu.py's.  Both
# kernels through each variant's own entry point; on an H100 every shape
# here fits kernel 20's resident variant (B = 70 at H = 1024: three h
# tiles of 24 rows) and all but f32 at H = 891 kernel 21's, whose resident
# entry refuses it
LSTM_TOL = {"float32": TOL, "bfloat16": 2e-3}


@pytest.mark.parametrize("variant", ["resident", "stream"])
@pytest.mark.parametrize("t,b,h,dtype", [
    (1, 1, 32, "float32"), (9, 5, 100, "bfloat16"), (40, 7, 256, "float32"),
    (400, 64, 512, "bfloat16"), (16, 3, 1024, "bfloat16"),
    (16, 70, 1024, "bfloat16"), (20, 3, 891, "float32")])
def test_lstm_kernels_match_plain(t, b, h, dtype, variant):
    dev = _card()
    rng = np.random.default_rng(t + b)
    xg = [torch.from_numpy(rng.standard_normal((t, b, 4 * h)).astype(
        np.float32) * 0.5).to(dev) for _ in "fb"]
    wh = [torch.from_numpy((rng.standard_normal((h, 4 * h)) / np.sqrt(h))
                           .astype(np.float32)).to(dev, getattr(torch, dtype))
          for _ in "fb"]
    got = getattr(ls, f"lstm_seq_forward_{variant}")(*xg, *wh)
    ref = ls.lstm_seq_forward_plain(*xg, *wh)
    for g, r in zip(got, ref):
        assert _rel(g, r) < LSTM_TOL[dtype]
    dy = [torch.from_numpy(rng.standard_normal((t, b, h)).astype(
        np.float32)).to(dev) for _ in "fb"]
    args = (*dy, *xg, *ref[::2], *ref[1::2], *wh)
    backward = getattr(ls, f"lstm_seq_backward_{variant}")
    fits = ls.backward_variant(b, h, wh[0].dtype,
                               *ls.device_limits(dev)) == "resident"
    if variant == "resident" and not fits:
        with pytest.raises(RuntimeError, match="lstm_bwd_resident_launch"):
            backward(*args)
        return
    for g, r in zip(backward(*args), ls.lstm_seq_backward_plain(*args)):
        assert _rel(g, r) < LSTM_TOL[dtype]


_LSTM_WRAPPERS = ("lstm_seq_forward", "lstm_seq_forward_resident",
                  "lstm_seq_forward_stream", "lstm_seq_backward",
                  "lstm_seq_backward_resident", "lstm_seq_backward_stream")


def _lstm_launches():
    return [getattr(ls, name).launches for name in _LSTM_WRAPPERS]


def _zero_lstm_launches():
    for name in _LSTM_WRAPPERS:
        getattr(ls, name).launches = 0


def test_masknet_blstm_runs_kernels_only():
    """blstm forward and backward on the card: kernels 20 and 21, each
    through its resident variant, once a layer each; a trainer step the
    same; lstm launches neither."""
    from setk_tpu_torch.models.mask_net import make_model
    from setk_tpu_torch.models.trainer import MaskTrainer
    dev = _card()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 50, 65)).astype(
        np.float32)).to(dev)
    for arch, want in (("blstm", [3, 3, 0, 3, 3, 0]),
                       ("lstm", [0, 0, 0, 0, 0, 0])):
        model = make_model(arch, 65, 64, 3).to(dev)
        _zero_lstm_launches()
        model(x).sum().backward()
        torch.cuda.synchronize()
        assert _lstm_launches() == want, arch
    trainer = MaskTrainer(make_model("blstm", 65, 64, 2), device="cuda")
    _zero_lstm_launches()
    loss = trainer.train_batch(x, (x > 0).float(), torch.ones(3, 50))
    assert np.isfinite(loss)
    assert _lstm_launches() == [2, 2, 0, 2, 2, 0]


# ---- the spatial layer: card against CPU ----

def _spatial_obs(geometry, secs=2.0):
    """(stft (M, T, F), mask (T, F), grid (A, M, F)) of a far-field
    source at 67 degrees (tests/spatial_scene.py), numpy."""
    from spatial_scene import (CIRCLE_MICS, CIRCLE_RADIUS, LINEAR_TOPO,
                               burst_mask, scene)
    from setk_tpu_torch.dsp.stft import forward_stft
    from setk_tpu_torch.spatial.steer import steer_vector_grid
    wav, _, gate = scene(np.random.default_rng(4), geometry, 67.0,
                         int(secs * 16000))
    spec = forward_stft(torch.from_numpy(wav), StftConfig()).numpy()
    mask = burst_mask(gate, spec.shape[1], spec.shape[2])
    _, grid = steer_vector_grid(geometry, 181 if geometry == "linear"
                                else 360, 257,
                                linear_topo=list(LINEAR_TOPO),
                                circular_radius=CIRCLE_RADIUS,
                                circular_around=CIRCLE_MICS)
    return spec, mask, np.ascontiguousarray(grid.transpose(0, 2, 1))


@pytest.mark.parametrize("geometry", ["linear", "circular"])
def test_spatial_features_card_vs_cpu(geometry):
    from setk_tpu_torch.spatial import features as sf
    from setk_tpu_torch.utils.device import full_f32_matmuls
    dev = _card()
    full_f32_matmuls(dev)
    spec, _, grid = _spatial_obs(geometry)
    x_c = torch.from_numpy(spec)
    x_d = x_c.to(dev)
    topo = [0.05 * k for k in range(spec.shape[0])]
    for name, fn in (
            ("srp", lambda x: sf.srp_phat_linear(x, topo, num_bins=257)),
            ("gcc_diag", lambda x: sf.gcc_phat_diag(x[0], x[2], 0.0, 0.1,
                                                    num_bins=257)),
            ("msc", lambda x: sf.msc(x, context=1)),
            ("cos_ipd", lambda x: sf.ipd(x[0], x[1], cos=True, sin=True)),
            ("df", lambda x: sf.directional_feats(
                x.transpose(1, 2), torch.as_tensor(grid[40],
                                                   device=x.device)))):
        got, ref = fn(x_d).cpu(), fn(x_c)
        assert _rel(got, ref) <= 1e-5, name
    got = sf.ipd(x_d[0], x_d[1]).cpu()
    d = (got - sf.ipd(x_c[0], x_c[1])).abs()
    assert torch.minimum(d, 2 * np.pi - d).max() <= 1e-5 * np.pi


@pytest.mark.parametrize("geometry", ["linear", "circular"])
def test_ssl_card_vs_cpu(geometry):
    """Scores within 1e-5 of the peak (2e-5 for ML), the index equal where
    the top two differ by more; music launches the EVD kernel once."""
    from setk_tpu_torch.spatial import ssl
    dev = _card()
    spec, mask, grid = _spatial_obs(geometry)
    pairs = ([0, 1, 2], [3, 4, 5]) if geometry == "circular" else \
        ([0, 0, 1], [1, 3, 2])
    for name, fn, tol in (
            ("ml", lambda x, m, g: ssl.ml_ssl(x, g, compression=-1,
                                              eps=1.2e-7, mask=m,
                                              return_scores=True), 2e-5),
            ("srp", lambda x, m, g: ssl.srp_ssl(x, g, pairs, mask=m,
                                                return_scores=True), 1e-5),
            ("music", lambda x, m, g: ssl.music_ssl(x, g, mask=m,
                                                    return_scores=True),
             1e-5)):
        es.hermitian_eigh.launches = 0
        idx_d, sc_d = fn(*(torch.from_numpy(a).to(dev)
                           for a in (spec, mask, grid)))
        torch.cuda.synchronize()
        assert es.hermitian_eigh.launches == (name == "music"), name
        idx_c, sc_c = fn(*(torch.from_numpy(a) for a in (spec, mask, grid)))
        assert _rel(sc_d.cpu(), sc_c) <= tol, name
        top = torch.sort(sc_c if name != "music" else -sc_c).values
        if float(top[-1] - top[-2]) > tol * float(sc_c.abs().max()):
            assert int(idx_d) == int(idx_c), name


@pytest.mark.parametrize("geometry,eps", [("linear", 0.1),
                                          ("circular", 1e-5)])
def test_sd_weights_card_vs_cpu(geometry, eps):
    """Within max(kappa_f 1e-6, 1e-5) of each bin's peak."""
    from setk_tpu_torch.spatial import steer as st
    dev = _card()
    if geometry == "linear":
        topo = [0.0, 0.05, 0.1, 0.15]
        dist = st.linear_distance_matrix(topo)
        steer = st.linear_steer_vector(topo, 30.0, 257)
    else:
        dist = st.circular_distance_matrix(0.05, 6)
        steer = st.circular_steer_vector(0.05, 6, 30.0, 257)
    rn = st.diffuse_covar(257, dist, diag_eps=eps)
    steer = torch.from_numpy(steer / steer.shape[-1])
    rn_t = torch.from_numpy(rn)
    got = bf.sd_weights(steer.to(dev), rn_t.to(dev)).cpu()
    ref = bf.sd_weights(steer, rn_t)
    kappa = torch.from_numpy(np.linalg.cond(rn.astype(np.complex128)))
    err = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
    assert (err <= torch.clamp(kappa * 1e-6, min=1e-5)).all()


def test_df_on_mask_path_launches_covar_and_eigh_once():
    """compute_df_on_mask's steps on the card: kernel 13 and the EVD
    kernel once each, the features within 1e-5 of the CPU's."""
    from setk_tpu_torch.ops.linalg import solve_pevd
    from setk_tpu_torch.spatial.features import directional_feats
    dev = _card()
    spec, mask, _ = _spatial_obs("circular")
    obs = torch.from_numpy(np.ascontiguousarray(spec.transpose(0, 2, 1)))
    m = torch.from_numpy(np.ascontiguousarray(mask.T))

    def run(o, w):
        sv = solve_pevd(bf.compute_covar(o.transpose(0, 1), w))
        return directional_feats(o, sv.T)

    mc.masked_covar.launches = es.hermitian_eigh.launches = 0
    got = run(obs.to(dev), m.to(dev)).cpu()
    torch.cuda.synchronize()
    assert (mc.masked_covar.launches, es.hermitian_eigh.launches) == (1, 1)
    assert _rel(got, run(obs, m)) <= 1e-5


# ---- the OM-LSA frame recursion (csrc/omlsa.cu) ----

def _ns_config(estimator, conf):
    from setk_tpu_torch.enhance import ns
    return (ns.MCRAConfig if estimator == "mcra" else ns.IMCRAConfig)(**conf)


def _ns_power(t, f, rows, seed):
    from ns_scene import scene
    return torch.from_numpy(np.stack([
        np.abs(scene(t, f, seed + r))**2 for r in range(rows)]).astype(
            np.float32))


@pytest.mark.parametrize("estimator", ["mcra", "imcra"])
@pytest.mark.parametrize("f,conf", [(129, {}), (257, {}), (513, {}),
                                    (1025, {}), (67, {"L": 40, "V": 10,
                                                      "U": 4})])
def test_omlsa_kernel_matches_plain(estimator, f, conf):
    """One 8 s utterance's frames (T = 501) at every bin count of a
    power-of-two n_fft 256-2048 and an odd one, against the plain version
    on the card: 1e-4 absolute (the source builds without FMA
    contraction, so the two round alike)."""
    dev = _card()
    conf = {k: v for k, v in conf.items()
            if k in ({"L"} if estimator == "mcra" else {"U", "V"})}
    cfg = _ns_config(estimator, conf)
    pw = _ns_power(501, f, 1, seed=f).to(dev)
    om.omlsa.launches = 0
    got = om.omlsa(pw, estimator, cfg)
    torch.cuda.synchronize()
    assert om.omlsa.launches == 1
    ref = om.omlsa_plain(pw, estimator, cfg)
    assert float((got - ref).abs().max()) <= TOL


@pytest.mark.parametrize("estimator,conf", [("mcra", {"L": 30}),
                                            ("imcra", {"U": 300, "V": 40})])
def test_omlsa_rows_and_global_ring_match_plain(estimator, conf):
    """Three rows a launch; iMCRA's ring of U = 300 in the global
    scratch."""
    dev = _card()
    cfg = _ns_config(estimator, conf)
    pw = _ns_power(200, 257, 3, seed=5).to(dev)
    got = om.omlsa(pw, estimator, cfg)
    if estimator == "imcra":
        assert om.omlsa_layout("imcra", 257, 300, 3, dev)["ring_shared"] == 0
    assert float((got - om.omlsa_plain(pw, estimator, cfg)).abs().max()) \
        <= TOL


def _division_pairs(seed):
    """Pairs with |a|, |b| in [2^-60, 2^60]: every significand of a
    against eight divisors (3, 1 + 2^-23, 2 - 2^-23, 1.5, pi, e, 1.1,
    1.9 at random exponents), and 2^23 random pairs; random signs."""
    rng = np.random.default_rng(seed)
    sig = 1 + np.arange(2**23) / 2**23
    divisors = [3.0, 1 + 2**-23, 2 - 2**-23, 1.5, np.pi, np.e, 1.1, 1.9]
    a = [sig * 2.0**rng.integers(-59, 59, sig.size) for _ in divisors]
    b = [np.full(sig.size, d) * 2.0**rng.integers(-59, 59, sig.size)
         for d in divisors]
    n = 2**23
    a.append(rng.uniform(1, 2, n) * 2.0**rng.integers(-59, 59, n))
    b.append(rng.uniform(1, 2, n) * 2.0**rng.integers(-59, 59, n))
    a, b = (np.concatenate(x).astype(np.float32) for x in (a, b))
    sign = rng.choice([-1.0, 1.0], (2, a.size)).astype(np.float32)
    return a * sign[0], b * sign[1]


def test_omlsa_fast_division_rounds_as_ieee():
    """The loops' branch-free division (rcp.approx, a Newton step, a
    corrected quotient) against the card's IEEE division on 9 x 2^23
    pairs in its range: every quotient equal, every pair in range."""
    from setk_tpu_torch.ops.cuda import _build
    dev = _card()
    a, b = (torch.from_numpy(x).to(dev) for x in _division_pairs(3))
    q = torch.empty_like(a)
    safe = torch.empty(a.shape, dtype=torch.int32, device=dev)
    _build.launch("omlsa", "omlsa_div_launch", dev, a.data_ptr(),
                  b.data_ptr(), q.data_ptr(), safe.data_ptr(), a.numel())
    torch.cuda.synchronize()
    assert bool(safe.bool().all())
    assert torch.equal(q, a / b)


@pytest.mark.parametrize("estimator", ["mcra", "imcra"])
def test_omlsa_any_bin_count_matches_plain(estimator):
    """F = 17,409 bins (past the 17,408 one block a row took before the
    chain became a thread a bin), two rows: one call, against the plain
    version on the card."""
    dev = _card()
    cfg = _ns_config(estimator, {})
    pw = _ns_power(40, 17409, 2, seed=9).to(dev)
    om.omlsa.launches = 0
    got = om.omlsa(pw, estimator, cfg)
    torch.cuda.synchronize()
    assert om.omlsa.launches == 1
    assert float((got - om.omlsa_plain(pw, estimator, cfg)).abs().max()) \
        <= TOL


@pytest.mark.parametrize("estimator", ["mcra", "imcra"])
def test_omlsa_frames_run_again_match_plain(estimator):
    """Bins whose |X|^2 leaves the loops' fast division's range (every
    fifth at 1e-30, every seventh at 1e30, every eleventh silent): their
    frames run again from the saved carries with IEEE division, against
    the plain version on the card at 1e-5 of max(1, |gain|), the
    emulator's bar for this scene: the gains of the bins at 1e-30 and 0
    reach ~300, where the card's powf and PyTorch's pow part by a few
    ulps (1.8e-4, every intermediate equal)."""
    from ns_scene import scene
    dev = _card()
    cfg = _ns_config(estimator, {})
    t, f = 60, 70
    pw = np.abs(scene(t, f, t + f))**2
    bins = np.arange(f)
    pw[:, bins % 5 == 0] = 1e-30
    pw[:, bins % 7 == 0] = 1e30
    pw[:, bins % 11 == 0] = 0.0
    pw = torch.from_numpy(pw[None].astype(np.float32)).to(dev)
    got = om.omlsa(pw, estimator, cfg)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    ref = om.omlsa_plain(pw, estimator, cfg)
    assert float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max()) \
        <= 1e-5


def test_auxiva_launches_kernel_13_once_an_epoch_per_four_sources():
    from setk_tpu_torch.enhance.auxiva import auxiva
    dev = _card()
    rng = np.random.default_rng(0)
    for n in (2, 5):
        x = (rng.laplace(size=(n, 100, 65)) + 1j * rng.laplace(
            size=(n, 100, 65))).astype(np.complex64)
        mc.masked_covar.launches = 0
        got = auxiva(torch.from_numpy(x).to(dev), epochs=4).cpu()
        torch.cuda.synchronize()
        assert mc.masked_covar.launches == 4 * ((n + 3) // 4)
        ref = auxiva(torch.from_numpy(x), epochs=4)
        assert _rel(got, ref) <= 1e-4
    with pytest.raises(NotImplementedError, match="queue 1 item 15"):
        auxiva(np.zeros((9, 10, 5), np.complex64), device="cuda")
