"""The CUDA kernel sources of setk_tpu_torch, run on the CPU.

The sources under setk_tpu_torch/csrc compile with the host C++ compiler
against tests/cuda_emu/cuda_runtime.h, a CPU stand-in for the CUDA
runtime (blocks in order, a block's threads as std::threads with a
barrier), and run through their C entry points on CPU tensors.  This
checks the kernels' index arithmetic, FFT, reductions, overlap-add,
the online pair's chunking and EMA, the per-bin solves, the planar
STFT/iSTFT (n_fft 256 and 1024, center on and off, any length) and the
pair covariance (N = 1, 6 and 8, complement mask or two masks) against
their plain PyTorch versions without a card; it says nothing of
speed, and the card's own compiler is checked by chip_smoke.py.  Skips
when no g++ with C++20 is present (decided inside the fixture).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from setk_tpu_torch.dsp.stft import StftConfig
from setk_tpu_torch.dsp.window import wss_inverse_blocks
from setk_tpu_torch.ops.cuda import _build
from setk_tpu_torch.ops.cuda import covariance_pair as cp
from setk_tpu_torch.ops.cuda import fused_mvdr as fm
from setk_tpu_torch.ops.cuda import mvdr as mv
from setk_tpu_torch.ops.cuda import planar as pl

EMU = Path(__file__).resolve().parent / "cuda_emu"
TOL = 1e-5   # f32 radix-2 FFT against pocketfft, f32 sums in another order
# the family's solves: 30 power iterations or N right-hand sides through an
# N = 8 Cholesky, each sum in another order than torch's; the bar the
# kernels are held to on the card
SOLVE_TOL = 1e-4
_LAUNCH = re.compile(r"(\w+<[^;]*?>)<<<(.*?)>>>\(", re.S)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the kernel sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    loaded = {}
    for name, src in _build.SOURCES.items():
        code = _LAUNCH.sub(r"emu_launch(\2, \1, ",
                           (_build.SOURCE_DIR / src).read_text())
        cpp = out / f"{name}.cpp"
        cpp.write_text(code)
        lib = out / f"lib{name}.so"
        proc = subprocess.run(
            [cxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
             f"-I{EMU}", "-o", str(lib), str(cpp)],
            capture_output=True, text=True)
        if proc.returncode != 0 and "c++20" in proc.stderr:
            pytest.skip("g++ without C++20 support")
        assert proc.returncode == 0, proc.stderr[-4000:]
        handle = ctypes.CDLL(str(lib))
        for fn, argtypes in _build._SIGNATURES[name].items():
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
        loaded[name] = handle
    return loaded


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _inputs(b, n, s, int16, seed):
    cfg = StftConfig()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, s)).astype(np.float32) * 0.3
    wav = torch.from_numpy(
        np.clip(x * 32768, -32768, 32767).astype(np.int16) if int16 else x)
    mask = torch.from_numpy(
        rng.random((b, cfg.num_frames(s), cfg.num_bins)).astype(np.float32))
    return cfg, wav, mask


SHAPES = [(1, 3, 4096, False, 1), (2, 6, 8192, True, 3),
          (1, 1, 512, False, 2), (1, 8, 4352, True, 1)]


@pytest.mark.parametrize("b,n,s,int16,runs", SHAPES)
def test_stft_covar_source_matches_plain(libs, b, n, s, int16, runs):
    cfg, wav, mask = _inputs(b, n, s, int16, seed=s + n)
    window = torch.as_tensor(cfg.padded_window)
    win = (window * fm.input_scale(wav)).contiguous()
    part = torch.empty((b, runs, 257, n * (n + 1)), dtype=torch.complex64)
    rs = torch.empty((b, 257, n, n), dtype=torch.complex64)
    rn = torch.empty_like(rs)
    err = libs["fused_mvdr"].stft_covar_launch(
        wav.data_ptr(), mask.data_ptr(), win.data_ptr(), part.data_ptr(),
        rs.data_ptr(), rn.data_ptr(), b, n, s, runs, int(int16), None)
    assert err == 0
    rs_p, rn_p = fm.stft_covar_plain(wav, mask, window)
    assert _rel(rs, rs_p) < TOL and _rel(rn, rn_p) < TOL


@pytest.mark.parametrize("b,n,s,int16,runs", SHAPES)
def test_beamform_istft_source_matches_plain(libs, b, n, s, int16, runs):
    cfg, wav, _ = _inputs(b, n, s, int16, seed=s - n)
    rng = np.random.default_rng(runs)
    w = torch.from_numpy((rng.standard_normal((b, 257, n)) + 1j *
                          rng.standard_normal((b, 257, n))).astype(
                              np.complex64))
    window = torch.as_tensor(cfg.padded_window)
    win = (window * fm.input_scale(wav)).contiguous()
    wss = torch.from_numpy(wss_inverse_blocks(
        cfg.padded_window, cfg.num_frames(s), 256, 512, s))
    out = torch.empty((b, s), dtype=torch.float32)
    err = libs["fused_mvdr"].beamform_istft_launch(
        wav.data_ptr(), w.data_ptr(), wss.data_ptr(), win.data_ptr(),
        window.data_ptr(), out.data_ptr(), b, n, s, int(int16), None)
    assert err == 0
    assert _rel(out, fm.beamform_istft_plain(wav, w, wss, window)) < TOL


# online pair: chunks that do and do not divide kernel B's 16 (8 at N > 6)
# hop blocks a block, so the extra frame a block computes for its
# overlap-add falls in the next chunk (16), mid-chunk (5) or both (24,
# T = 49: block 2's frames 32..47 in chunk 1, its extra frame 48 in
# chunk 2); chunk 1 is one frame a chunk (at T = 81, two of covar_ema's
# tiles of 64 chunks), 64 one chunk for every frame
ONLINE = [(1, 3, 8192, False, 16), (2, 6, 8192, True, 5),
          (1, 4, 12288, True, 24), (1, 8, 4352, False, 5),
          (1, 2, 20480, False, 1), (1, 2, 4096, True, 64)]


@pytest.mark.parametrize("b,n,s,int16,chunk", ONLINE)
def test_stft_covar_chunks_source_matches_plain(libs, b, n, s, int16, chunk):
    cfg, wav, mask = _inputs(b, n, s, int16, seed=s + chunk)
    window = torch.as_tensor(cfg.padded_window)
    win = (window * fm.input_scale(wav)).contiguous()
    t = cfg.num_frames(s)
    part = torch.empty((b, fm.num_chunks(t, chunk), 257, n * (n + 1)),
                       dtype=torch.complex64)
    err = libs["fused_mvdr"].stft_covar_chunks_launch(
        wav.data_ptr(), mask.data_ptr(), win.data_ptr(), part.data_ptr(), b,
        n, s, chunk, int(int16), None)
    assert err == 0
    ref = fm.stft_covar_chunks_plain(wav, mask, window, chunk)
    assert _rel(part, ref) < TOL


@pytest.mark.parametrize("b,n,s,int16,chunk", ONLINE)
def test_covar_ema_source_matches_plain(libs, b, n, s, int16, chunk):
    cfg, _, mask = _inputs(b, n, s, int16, seed=chunk)
    rng = np.random.default_rng(s + n)
    c = fm.num_chunks(cfg.num_frames(s), chunk)
    part = torch.from_numpy((rng.standard_normal((b, c, 257, n * (n + 1)))
                             + 1j * rng.standard_normal(
                                 (b, c, 257, n * (n + 1)))).astype(
                                     np.complex64))
    es = torch.empty((b, c, 257, n, n), dtype=torch.complex64)
    en = torch.empty_like(es)
    err = libs["fused_mvdr"].covar_ema_launch(
        part.data_ptr(), mask.data_ptr(), es.data_ptr(), en.data_ptr(), b, n,
        cfg.num_frames(s), chunk, 0.7, None)
    assert err == 0
    ref_s, ref_n = fm.covar_ema_plain(part, mask, chunk, 0.7)
    assert _rel(es, ref_s) < TOL and _rel(en, ref_n) < TOL


@pytest.mark.parametrize("b,n,s,int16,chunk", ONLINE)
def test_beamform_istft_online_source_matches_plain(libs, b, n, s, int16,
                                                    chunk):
    cfg, wav, _ = _inputs(b, n, s, int16, seed=s - chunk)
    rng = np.random.default_rng(chunk)
    c = fm.num_chunks(cfg.num_frames(s), chunk)
    w = torch.from_numpy((rng.standard_normal((b, c, 257, n)) + 1j *
                          rng.standard_normal((b, c, 257, n))).astype(
                              np.complex64))
    window = torch.as_tensor(cfg.padded_window)
    win = (window * fm.input_scale(wav)).contiguous()
    wss = torch.from_numpy(wss_inverse_blocks(
        cfg.padded_window, cfg.num_frames(s), 256, 512, s))
    out = torch.empty((b, s), dtype=torch.float32)
    err = libs["fused_mvdr"].beamform_istft_online_launch(
        wav.data_ptr(), w.data_ptr(), wss.data_ptr(), win.data_ptr(),
        window.data_ptr(), out.data_ptr(), b, n, s, chunk, int(int16), None)
    assert err == 0
    ref = fm.beamform_istft_online_plain(wav, w, wss, window, chunk)
    assert _rel(out, ref) < TOL


@pytest.mark.parametrize("n", [1, 2, 6, 8])
def test_mvdr_power_source_matches_plain(libs, n):
    rng = np.random.default_rng(n)
    bins = 130  # three blocks of 64, the last one partial
    y = torch.from_numpy((rng.standard_normal((bins, n, 40)) + 1j *
                          rng.standard_normal((bins, n, 40))).astype(
                              np.complex64))
    m = torch.from_numpy(rng.random((bins, 1, 40)).astype(np.float32))
    rs = ((y * m) @ y.conj().transpose(-1, -2) / 20).contiguous()
    rn = ((y * (1 - m)) @ y.conj().transpose(-1, -2) / 20).contiguous()
    w = torch.empty((bins, n), dtype=torch.complex64)
    err = libs["mvdr_power"].mvdr_power_launch(
        rs.data_ptr(), rn.data_ptr(), w.data_ptr(), bins, n, 15, 1e-6, None)
    assert err == 0
    assert _rel(w, mv.mvdr_power_plain(rs, rn)) < TOL


def _family_covars(n, bins=70, seed=0):
    """Masked covariances of a source with a per-bin steer plus noise;
    70 bins are three blocks of 32, the last one partial."""
    rng = np.random.default_rng(seed + n)
    t = 48
    d = rng.standard_normal((bins, n, 1)) + 1j * rng.standard_normal(
        (bins, n, 1))
    src = rng.standard_normal((bins, 1, t)) + 1j * rng.standard_normal(
        (bins, 1, t))
    y = d * src + 0.3 * (rng.standard_normal((bins, n, t)) + 1j *
                         rng.standard_normal((bins, n, t)))
    m = np.where(np.abs(src) > 1.0, 0.95, 0.05)
    rs = (y * m) @ y.conj().transpose(0, 2, 1) / t
    rn = (y * (1 - m)) @ y.conj().transpose(0, 2, 1) / t
    return (torch.from_numpy(rs.astype(np.complex64)),
            torch.from_numpy(rn.astype(np.complex64)),
            torch.from_numpy(d[..., 0].astype(np.complex64)))


@pytest.mark.parametrize("n", [1, 2, 6, 8])
def test_gevd_power_source_matches_plain(libs, n):
    rs, rn, _ = _family_covars(n)
    v = torch.empty((rs.shape[0], n), dtype=torch.complex64)
    err = libs["mvdr_power"].gevd_power_launch(
        rs.data_ptr(), rn.data_ptr(), v.data_ptr(), rs.shape[0], n, 30, 1e-6,
        None)
    assert err == 0
    assert _rel(v, mv.gevd_power_plain(rs, rn, 30)) < SOLVE_TOL


@pytest.mark.parametrize("n", [1, 2, 6, 8])
@pytest.mark.parametrize("beta,powers", [(0.0, True), (1.0, False)])
def test_pmwf_solve_source_matches_plain(libs, n, beta, powers):
    rs, rn, _ = _family_covars(n, seed=1)
    bins = rs.shape[0]
    w = torch.empty((bins, n, n), dtype=torch.complex64)
    ps, pn = torch.empty((bins, n)), torch.empty((bins, n))
    err = libs["mvdr_power"].pmwf_solve_launch(
        rs.data_ptr(), rn.data_ptr(), w.data_ptr(),
        ps.data_ptr() if powers else None, pn.data_ptr() if powers else None,
        bins, n, beta, 1e-6, None)
    assert err == 0
    ref = mv.pmwf_solve_plain(rs, rn, beta, return_powers=True)
    assert _rel(w, ref[0]) < SOLVE_TOL
    if powers:
        assert _rel(ps, ref[1]) < SOLVE_TOL and _rel(pn, ref[2]) < SOLVE_TOL


@pytest.mark.parametrize("n", [1, 2, 6, 8])
def test_capon_source_matches_plain(libs, n):
    _, rn, d = _family_covars(n, bins=130, seed=2)
    w = torch.empty_like(d)
    err = libs["mvdr_power"].capon_launch(
        d.data_ptr(), rn.data_ptr(), w.data_ptr(), d.shape[0], n, 1e-6, None)
    assert err == 0
    assert _rel(w, mv.capon_plain(d, rn)) < SOLVE_TOL


def test_entry_points_reject_bad_geometry(libs):
    z = torch.zeros(8)
    lib = libs["fused_mvdr"]
    for b, n, s, runs in ((1, 9, 4096, 1), (1, 2, 4000, 1), (1, 2, 256, 1),
                          (0, 2, 4096, 1), (1, 2, 4096, 0),
                          (1, 2, 4096, 18)):
        assert lib.stft_covar_launch(z.data_ptr(), z.data_ptr(), z.data_ptr(),
                                     z.data_ptr(), z.data_ptr(), z.data_ptr(),
                                     b, n, s, runs, 0, None) != 0
    assert lib.beamform_istft_launch(z.data_ptr(), z.data_ptr(), z.data_ptr(),
                                     z.data_ptr(), z.data_ptr(), z.data_ptr(),
                                     1, 9, 4096, 0, None) != 0
    p = z.data_ptr()
    for b, n, s, chunk in ((1, 9, 4096, 4), (1, 2, 4000, 4), (0, 2, 4096, 4),
                           (1, 2, 4096, 0)):
        assert lib.stft_covar_chunks_launch(p, p, p, p, b, n, s, chunk, 0,
                                            None) != 0
        assert lib.beamform_istft_online_launch(p, p, p, p, p, p, b, n, s,
                                                chunk, 0, None) != 0
    for b, n, t, chunk in ((1, 9, 17, 4), (0, 2, 17, 4), (1, 2, 0, 4),
                           (1, 2, 17, 0)):
        assert lib.covar_ema_launch(p, p, p, p, b, n, t, chunk, 0.8,
                                    None) != 0
    lib = libs["mvdr_power"]
    assert lib.mvdr_power_launch(
        z.data_ptr(), z.data_ptr(), z.data_ptr(), 4, 9, 15, 1e-6, None) != 0
    for nbins, n in ((4, 9), (0, 2), (-1, 2)):
        assert lib.gevd_power_launch(p, p, p, nbins, n, 30, 1e-6, None) != 0
        assert lib.pmwf_solve_launch(p, p, p, p, p, nbins, n, 0.0, 1e-6,
                                     None) != 0
        assert lib.capon_launch(p, p, p, nbins, n, 1e-6, None) != 0
    # powers come as a pair or not at all
    assert lib.pmwf_solve_launch(p, p, p, p, None, 1, 2, 0.0, 1e-6,
                                 None) != 0


# planar STFT: one and several blocks of 16 frames per row, reflect and
# plain framing, int16 and f32, lengths on and off the hop grid
PLANAR = [(256, 3000, True, False), (256, 2048, False, True),
          (1024, 8192, True, True), (1024, 5000, False, False)]


def _planar_inputs(n_fft, s, center, int16, seed):
    cfg = StftConfig(frame_len=n_fft, frame_hop=n_fft // 2, center=center)
    x = np.random.default_rng(seed).standard_normal((3, s)).astype(
        np.float32) * 0.3
    wav = torch.from_numpy(
        np.clip(x * 32768, -32768, 32767).astype(np.int16) if int16 else x)
    return cfg, wav, torch.as_tensor(cfg.padded_window)


@pytest.mark.parametrize("n_fft,s,center,int16", PLANAR)
def test_stft_planar_source_matches_plain(libs, n_fft, s, center, int16):
    cfg, wav, window = _planar_inputs(n_fft, s, center, int16, seed=s)
    win = (window * fm.input_scale(wav)).contiguous()
    t = cfg.num_frames(s)
    re = torch.empty((3, t, n_fft // 2))
    im = torch.empty_like(re)
    nyq = torch.empty((3, t))
    err = libs["planar_stft"].stft_planar_launch(
        wav.data_ptr(), win.data_ptr(), re.data_ptr(), im.data_ptr(),
        nyq.data_ptr(), 3, s, n_fft, int(center), int(int16), None)
    assert err == 0
    ref = pl.stft_planar_plain(wav, window, center)
    peak = torch.complex(ref[0], ref[1]).abs().max()
    for got, want in zip((re, im, nyq), ref):
        assert float((got - want).abs().max() / peak) < TOL


@pytest.mark.parametrize("n_fft,s", [(256, 3000), (1024, 8192)])
@pytest.mark.parametrize("extra", [0, -700, 333])
def test_istft_planar_source_matches_plain(libs, n_fft, s, extra):
    """nsamps at, short of and past the (T-1) hop samples that carry
    signal; the planar spectrum of a signal comes back as the signal."""
    cfg, wav, window = _planar_inputs(n_fft, s, True, False, seed=n_fft)
    t = cfg.num_frames(s)
    hop = n_fft // 2
    nsamps = (t - 1) * hop + extra
    er, ei, ny = pl.stft_planar_plain(wav, window)
    wss = torch.from_numpy(pl.istft_wss_inverse(cfg.padded_window, t,
                                                nsamps))
    out = torch.empty((3, nsamps))
    err = libs["planar_stft"].istft_planar_launch(
        er.data_ptr(), ei.data_ptr(), ny.data_ptr(), window.data_ptr(),
        wss.data_ptr(), out.data_ptr(), 3, t, n_fft,
        pl.valid_samples(t, hop, nsamps), nsamps, None)
    assert err == 0
    assert _rel(out, pl.istft_planar_plain(er, ei, ny, window, wss,
                                           nsamps)) < TOL
    n_sig = pl.valid_samples(t, hop, nsamps)
    assert _rel(out[:, :n_sig], wav[:, :n_sig]) < TOL
    assert not out[:, n_sig:].any()


@pytest.mark.parametrize("n", [1, 6, 8])
@pytest.mark.parametrize("complement", [True, False])
def test_pair_covar_source_matches_plain(libs, n, complement):
    """F = 129 (two blocks of 128 bins, the second partial); masks are
    the first F columns of a (B, T, F + 1) mask, as the planar path
    hands them over."""
    rng = np.random.default_rng(n)
    b, t, f = 2, 37, 129
    obs = torch.from_numpy((rng.standard_normal((b, n, t, f)) + 1j *
                            rng.standard_normal((b, n, t, f))).astype(
                                np.complex64))
    ms = torch.from_numpy(rng.random((b, t, f + 1)).astype(np.float32))
    mn = torch.from_numpy(rng.random((b, t, f + 1)).astype(np.float32))
    ms, mn = ms[..., :f], mn[..., :f]
    out = [torch.empty((b, n, n, f)) for _ in range(4)]
    ptrs = [o.data_ptr() for o in out]
    lib = libs["covariance_pair"]
    if complement:
        re, im = obs.real.contiguous(), obs.imag.contiguous()
        err = lib.pair_covar_launch(re.data_ptr(), im.data_ptr(), 1,
                                    ms.data_ptr(), None, t * (f + 1), f + 1,
                                    *ptrs, b, n, t, f, 30, 1, None)
        ref = cp.pair_covar_complement_plain(re, im, ms, 30)
    else:
        err = lib.pair_covar_launch(obs.data_ptr(), obs.data_ptr() + 4, 2,
                                    ms.data_ptr(), mn.data_ptr(),
                                    t * (f + 1), f + 1, *ptrs, b, n, t, f, t,
                                    0, None)
        ref = cp.pair_covar_plain(obs, ms, mn)
    assert err == 0
    for k in (0, 2):
        assert _rel(torch.complex(out[k], out[k + 1]),
                    torch.complex(ref[k], ref[k + 1])) < TOL


def test_planar_entry_points_reject_bad_arguments(libs):
    p = torch.zeros(8).data_ptr()
    lib = libs["planar_stft"]
    for rows, s, n_fft in ((0, 4096, 512), (1, 4096, 768), (1, 4096, 4096),
                           (1, 500, 512)):
        assert lib.stft_planar_launch(p, p, p, p, p, rows, s, n_fft, 1, 0,
                                      None) != 0
    for b, t, n_fft, n_valid, nsamps in ((0, 9, 512, 2048, 2048),
                                         (1, 9, 384, 1536, 1536),
                                         (1, 1, 512, 0, 256),
                                         (1, 9, 512, 2049, 4096),
                                         (1, 9, 512, 2048, 2000)):
        assert lib.istft_planar_launch(p, p, p, p, p, p, b, t, n_fft,
                                       n_valid, nsamps, None) != 0
    lib = libs["covariance_pair"]
    for es, b, n, t, f, mt, mb, mn in ((1, 1, 9, 4, 8, 8, 32, p),
                                       (3, 1, 2, 4, 8, 8, 32, p),
                                       (1, 0, 2, 4, 8, 8, 32, p),
                                       (1, 1, 2, 4, 8, 7, 32, p),
                                       (1, 1, 2, 4, 8, 8, 31, p),
                                       (1, 1, 2, 4, 8, 8, 32, None)):
        assert lib.pair_covar_launch(p, p, es, p, mn, mb, mt, p, p, p, p, b,
                                     n, t, f, t, 0, None) != 0
